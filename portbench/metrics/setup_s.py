"""Process start to the first timed call, seconds."""


def read(w):
    return w.setup_s
