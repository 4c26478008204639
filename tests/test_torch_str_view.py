"""PyTorch port, the ``str`` haystack's bytes: an ASCII string is scanned
from its own storage (``utils/buffers.py`` ``ascii_view``, through
``api._encode``), every other string is encoded as before.

The view: read-only uint8 bytes equal to the string's UTF-8, at the
string's own address, alive as long as the view; non-ASCII strings of
each width, ``str`` subclasses and other interpreters take the encode,
and no string gains a cached UTF-8 copy.  The public calls over both
kinds of haystack, on every tier of a CPU matcher (host, Teddy forced,
dense, sharded on a two-rank local mesh), equal the host tier's and the
JAX package's answers, with the counters of the path each took.
"""

from __future__ import annotations

import ctypes
import gc
import random
import sys

import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu_torch as port
import ahocorasick_rs_tpu_torch.api as api
from ahocorasick_rs_tpu_torch.parallel import sharded
from ahocorasick_rs_tpu_torch.utils import buffers, trace

#: ``PyUnicode_AsUTF8AndSize``, bound here on its own
_AS_UTF8 = ctypes.PYFUNCTYPE(
    ctypes.c_void_p, ctypes.py_object, ctypes.POINTER(ctypes.c_ssize_t)
)(("PyUnicode_AsUTF8AndSize", ctypes.pythonapi))
#: a compact ASCII string's header: its bytes start this far past id(s)
_ASCII_HEADER = sys.getsizeof("") - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fresh(text: str) -> str:
    """A new string object equal to ``text`` (not an interned or cached
    one), made as a caller's decode makes it."""
    return text.encode("utf-8").decode("utf-8")


def _utf8_address(s: str) -> int:
    n = ctypes.c_ssize_t()
    return _AS_UTF8(s, ctypes.byref(n))


class _Str(str):
    pass


# -- the view --------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 4096, 1 << 20])
def test_an_ascii_string_is_viewed_at_its_own_storage(n):
    s = _fresh(("winter of my discontent " * (n // 24 + 1))[:n])
    size = sys.getsizeof(s)
    v = buffers.ascii_view(s)
    assert v.dtype == np.uint8 and v.shape == (n,)
    assert not v.flags.writeable
    with pytest.raises(ValueError):
        v[0] = 1
    assert v.tobytes() == s.encode()
    assert v.ctypes.data == id(s) + _ASCII_HEADER == _utf8_address(s)
    # viewing allocates nothing, so a second view has the same address
    # and the string the same size
    assert buffers.ascii_view(s).ctypes.data == v.ctypes.data
    assert sys.getsizeof(s) == size


def test_the_view_keeps_the_string_alive():
    rng = random.Random(11)
    s = "".join(rng.choice("abcdefgh xyz") for _ in range(100_000))
    want = s.encode()
    refs = sys.getrefcount(s)
    v = buffers.ascii_view(s)
    assert sys.getrefcount(s) == refs + 1
    part = v[10:20]
    del s, v
    gc.collect()
    # strings of the same size, made and dropped, would reuse freed memory
    churn = ["".join(rng.choice("IJKLMN") for _ in range(100_000))
             for _ in range(4)]
    del churn
    gc.collect()
    assert part.tobytes() == want[10:20]
    base = part
    while isinstance(base, np.ndarray):
        base = base.base
    assert isinstance(base, buffers._StrStorage)
    assert base._s.encode() == want


@pytest.mark.parametrize("s", [
    "café au lait",       # Latin-1, one byte a character
    "é" * 300,
    "naïve Жук",  # UCS-2
    "日本語 " * 50,
    "grin \U0001F600 wide",    # UCS-4
    "\U0001F600" * 100 + "ascii tail",
])
def test_a_non_ascii_string_is_encoded_and_gains_no_utf8(s):
    s = _fresh(s)
    size = sys.getsizeof(s)
    assert buffers.ascii_view(s) is None
    trace.reset_counters()
    hay, data = api._encode(s)
    assert data == s.encode() and hay.tobytes() == data
    assert trace.counters() == {"scanned_bytes": len(data),
                                "encode_bytes": len(data)}
    assert sys.getsizeof(s) == size


def test_a_non_ascii_haystack_gains_no_utf8_through_the_api():
    pats = ["café", "日本", "lait"]
    s = _fresh("café au lait 日本語 \U0001F600 " * 400)
    size = sys.getsizeof(s)
    for backend in ("python", "numpy", "device"):
        ac = port.AhoCorasick(pats, store_patterns=False, backend=backend,
                              device="cpu")
        assert ac.find_matches_as_indexes(s)
        assert ac.find_matches_as_strings(s)
        assert sys.getsizeof(s) == size, backend


def test_the_empty_string():
    v = buffers.ascii_view(_fresh(""))
    assert v.shape == (0,) and v.dtype == np.uint8
    trace.reset_counters()
    hay, data = api._encode("")
    assert len(hay) == 0 and data is None
    assert trace.counters() == {"scanned_bytes": 0, "str_view_bytes": 0}
    ac = port.AhoCorasick(["a"], device="cpu")
    assert ac.find_matches_as_indexes("") == []
    assert ac.find_matches_as_strings("") == []


def test_a_str_subclass_is_encoded():
    s = _Str(_fresh("the winter of my discontent"))
    assert buffers.ascii_view(s) is None
    trace.reset_counters()
    hay, data = api._encode(s)
    assert data == str(s).encode() and hay.tobytes() == data
    assert "str_view_bytes" not in trace.counters()
    for store in (True, False):
        ac = port.AhoCorasick(["winter", "disco"], store_patterns=store,
                              device="cpu")
        rf = ref.AhoCorasick(["winter", "disco"], store_patterns=store)
        assert ac.find_matches_as_indexes(s) == rf.find_matches_as_indexes(s)
        got = ac.find_matches_as_strings(s)
        assert got == rf.find_matches_as_strings(s) == ["winter", "disco"]
        assert all(type(x) is str for x in got)


def test_another_interpreter_encodes(monkeypatch):
    monkeypatch.setattr(buffers, "_AS_UTF8", None)
    assert buffers.ascii_view(_fresh("plain ascii")) is None
    trace.reset_counters()
    hay, data = api._encode("plain ascii")
    assert data == b"plain ascii" and hay.tobytes() == data
    assert trace.counters()["encode_bytes"] == len(data)


@pytest.mark.parametrize("bad", [b"bytes", bytearray(b"x"), 5, None,
                                 ["a"]])
@pytest.mark.parametrize("method", ["find_matches_as_indexes",
                                    "find_matches_as_strings"])
def test_a_non_str_haystack_raises_the_reference_type_error(bad, method):
    ac = port.AhoCorasick(["a"], device="cpu")
    rf = ref.AhoCorasick(["a"])
    with pytest.raises(TypeError) as got:
        getattr(ac, method)(bad)
    with pytest.raises(TypeError) as want:
        getattr(rf, method)(bad)
    assert str(got.value) == str(want.value)
    assert str(got.value) == (
        f"argument 'haystack': '{type(bad).__name__}' object cannot be "
        "converted to 'PyString'")


# -- the public calls over every tier --------------------------------

PATTERNS = ["content", "disco", "disc", "discontent", "winter", "lo wo",
            "héllo", "wörld", "日本"]
_RNG = random.Random(24)
HAYSTACKS = {
    "ascii": "".join(_RNG.choice([
        "the winter of my discontent ", "hello world ", "disco disco ",
        "filler text with no hits ", "quartz sphinx "]) for _ in range(900)),
    "mixed": "".join(_RNG.choice([
        "the winter of my discontent ", "héllo wörld ",
        "disco 日本語 ", "filler \U0001F600 text ",
        "quartz sphinx "]) for _ in range(900)),
}
#: each tier: its backend, the Teddy state, whether it takes a mesh, and
#: the tier the call must report
TIERS = {
    "host": ("native", "auto", False, "native"),
    "teddy": ("device", "force", False, "teddy"),
    "dense": ("device", "off", False, "device"),
    "sharded": ("sharded", "off", True, "sharded"),
}
CALLS = ["find_matches_as_indexes", "find_matches_as_strings"]


def _truth(text: str, call: str) -> tuple:
    """The port's python host tier and the JAX package on ``text``."""
    host = port.AhoCorasick(PATTERNS, store_patterns=False, backend="python",
                            device="cpu")
    rf = ref.AhoCorasick(PATTERNS, store_patterns=False)
    return getattr(host, call)(text), getattr(rf, call)(text)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("kind", sorted(HAYSTACKS))
def test_every_tier_equals_the_host_tier_and_the_reference(kind, call, tier):
    backend, teddy, meshed, want_tier = TIERS[tier]
    text = _fresh(HAYSTACKS[kind])
    n = len(text.encode())
    host, jax_ref = _truth(text, call)
    assert host == jax_ref and host
    ac = port.AhoCorasick(
        PATTERNS, store_patterns=False,
        implementation=port.Implementation.DFA, backend=backend,
        device="cpu",
        mesh=sharded.make_mesh(devices=["cpu"] * 2) if meshed else None)
    ac._teddy_state = teddy
    size = sys.getsizeof(text)
    trace.reset_counters()
    got = getattr(ac, call)(text)
    assert ac.stats()["last_backend"] == want_tier
    assert got == host
    c = trace.counters()
    assert c["scanned_bytes"] == n
    if kind == "ascii":
        assert c["str_view_bytes"] == n and "encode_bytes" not in c
    else:
        assert c["encode_bytes"] == n and "str_view_bytes" not in c
        assert sys.getsizeof(text) == size
