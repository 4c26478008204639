"""Benchmark of ``ahocorasick_rs_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<name>.json``, its traffic mix in ``traffic/<name>.json`` (read
by the one generator in ``traffic/__init__.py``), each metric's reader in
``metrics/<name>.py``.  ``reference/`` holds the plain matcher that
decides ``correct``; it imports nothing of the port.
"""
