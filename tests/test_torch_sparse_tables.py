"""PyTorch port, K7's derived tables: ``_kernels.sparse_tables`` turns the
sparse automaton (sorted int64 keys ``state*257 + byte``, targets, fail
links) into per-state records, edge labels and targets, and the root's
next states; the plain K7 walks those tables.  Each case holds the records'
edge ranges against the keys' ``searchsorted`` ranges, and the plain scan's
compacted positions, states and total against the JAX package's
``_scan_compact_sparse`` on the same bytes, on the CPU.  Every comparison
is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes that share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_bytes(seed: int, n: int, alphabet: bytes) -> bytes:
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, dtype=np.uint8)
    return a[rng.integers(0, len(a), n)].tobytes()


def _wide() -> tuple[list[bytes], bytes]:
    # "q" has 20 children, "qa" 17 and "w" 60 (past the kernel's 48-edge
    # windows), reached inside fail chains that start past narrow states
    letters = b"abcdefghijklmnopqrst"
    pats = [b"q" + bytes([c]) for c in letters]
    pats += [b"qa" + bytes([c]) + b"z" for c in letters[:17]]
    pats += [b"w" + bytes([c]) + b"v" for c in range(40, 100)]
    pats += [b"xqa", b"yq", b"xw"]
    body = _random_bytes(1, 4000, b"qaxyzbcdefghijklmnopqrstw0123456789")
    return pats, body + b"xqab" + b"yqqaqz" * 10 + b"xw0v" * 5


def _root256() -> tuple[list[bytes], bytes]:
    # an edge on every byte at the root, NUL and 0xff included
    pats = [bytes([i]) + bytes([(i * 7 + 3) % 256]) for i in range(256)]
    pats += [b"\x00\xff\x00", b"\xff\xff"]
    return pats, _random_bytes(2, 5000, bytes(range(256))) + b"".join(pats)


def _chain() -> tuple[list[bytes], bytes]:
    # at "abcd" the byte "h" follows abcd -> bcd -> cd -> d before it finds
    # the edge of "dh": three fail links, then the root's when "q" misses
    pats = [b"abcde", b"bcdf", b"cdg", b"dh", b"q"]
    body = _random_bytes(3, 3000, b"abcdefghq")
    return pats, body + b"abcdh" * 20 + b"abcdq" * 5 + b"abcdefgh"


def _one_byte_mixed() -> tuple[list[bytes], bytes]:
    pats = [b"a", b"z", b"\x00", b"ab", b"zzz"]
    return pats, _random_bytes(4, 3000, b"abz\x00y")


def _halo0() -> tuple[list[bytes], bytes]:
    # only one-byte patterns: max_len 1, so no warm-up bytes at all
    pats = [b"a", b"k", b"\xff"]
    return pats, _random_bytes(5, 3000, b"akz\xff ")


CASES = {
    "wide": _wide,
    "root256": _root256,
    "chain": _chain,
    "one-byte": _one_byte_mixed,
    "halo0": _halo0,
}


def _port_automaton(am):
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


def _assert_tables_follow_keys(am, tabs: _kernels.SparseTables) -> None:
    keys = np.asarray(am.edge_keys, dtype=np.int64)
    S, E = len(am.fail), len(keys)
    rec = tabs.records.numpy()
    ids = np.arange(S, dtype=np.int64) * 257
    start = np.searchsorted(keys, ids)
    end = np.searchsorted(keys, ids + 257)
    np.testing.assert_array_equal(rec[:, 0], start)
    np.testing.assert_array_equal(rec[:, 1], end - start)
    np.testing.assert_array_equal(rec[:, 2], am.fail)
    np.testing.assert_array_equal(rec[:, 3], np.asarray(am.match_count) > 0)
    assert tabs.labels.numel() == E + 32
    np.testing.assert_array_equal(tabs.labels.numpy()[:E], keys % 257)
    assert not tabs.labels.numpy()[E:].any()
    np.testing.assert_array_equal(tabs.targets.numpy(), am.edge_targets)
    root = np.zeros(257, dtype=np.int32)
    root[keys[: end[0]] % 257] = np.asarray(am.edge_targets)[: end[0]]
    np.testing.assert_array_equal(tabs.root_next.numpy(), root)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_tables_scan_equals_reference(case: str) -> None:
    pats, hay = CASES[case]()
    ref_am = build_automaton(pats)
    am = _port_automaton(ref_am)
    pt = port_scan.DeviceTables(am, "sparse", "cpu")
    _assert_tables_follow_keys(am, pt.sparse)
    counts = pt.sparse.records[:, 1]
    if case == "wide":
        assert int((counts > 16).sum()) >= 3 and int(counts.max()) > 48
    if case == "root256":
        assert int(counts[0]) == 256
    if case == "chain":
        s = 0
        for c in b"abcd":
            s = am.delta[s, c]
        links = 0
        while am.fail[s] != 0:
            s, links = am.fail[s], links + 1
        assert links >= 3
    halo = ref_am.max_len - 1
    assert (halo == 0) == (case == "halo0")
    n = len(hay)
    L, T = port_scan.choose_layout(n, halo)
    buf = np.zeros(L * T, dtype=np.uint8)
    buf[:n] = np.frombuffer(hay, dtype=np.uint8)
    rt = ref_scan.DeviceTables(ref_am, "sparse")
    for cap in (64, 1 << 14):
        want = ref_scan._scan_compact_sparse(
            rt.keys, rt.targets, rt.fail, rt.match_count, jnp.asarray(buf),
            jnp.int32(n), L, T, halo, cap,
        )
        got = port_scan._scan_compact_sparse(
            pt.sparse, torch.from_numpy(buf), n, L, T, halo, cap,
        )
        assert int(got[2]) == int(want[2]) > 64
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sparse_tables_without_edges() -> None:
    """E = 0: one root record, no labels but the window's 32 zero bytes, a
    root row of zeros, and a scan with no matches.  The JAX package's
    sparse device scan cannot take E = 0 (it gathers ``targets[0]`` of an
    empty array), so the scan is held against its python tier."""
    am = _port_automaton(build_automaton([]))
    tabs = port_scan.DeviceTables(am, "sparse", "cpu").sparse
    _assert_tables_follow_keys(am, tabs)
    assert tabs.records.tolist() == [[0, 0, 0, 0]]
    hay = b"abc\x00\xff" * 200
    L, T = port_scan.choose_layout(len(hay), 0)
    buf = torch.zeros(L * T, dtype=torch.uint8)
    buf[: len(hay)] = torch.frombuffer(bytearray(hay), dtype=torch.uint8)
    pos, st, total = port_scan._scan_compact_sparse(
        tabs, buf, len(hay), L, T, 0, 64
    )
    assert int(total) == 0 and bool((pos == -1).all())
    assert ref.BytesAhoCorasick([], backend="python").find_matches_as_indexes(
        hay
    ) == []


def test_sparse_tables_refuse_pad_edges() -> None:
    """No edge may carry PAD (256): the kernel sends a PAD step to the
    root at once, so such an edge would be skipped."""
    keys = torch.tensor([256], dtype=torch.int64)
    with pytest.raises(ValueError, match="labelled PAD"):
        _kernels.sparse_tables(
            keys, torch.tensor([1], dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
        )


@pytest.mark.parametrize("kernel", ["sparse_scan", "_sparse_scan_at", "compact"])
def test_k7_k3_wrappers_refuse_cpu_tensors(kernel: str) -> None:
    """K7's and K3's wrappers launch only on CUDA tensors; a CPU tensor
    raises (the plain versions serve the CPU one layer up)."""
    am = _port_automaton(build_automaton([b"abc", b"bd"]))
    tabs = port_scan.DeviceTables(am, "sparse", "cpu").sparse
    hay = torch.zeros(1024, dtype=torch.uint8)
    scan = (tabs, hay, 1024, 4, 256, 2)
    calls = {
        "sparse_scan": lambda: _kernels.sparse_scan(*scan),
        "_sparse_scan_at": lambda: _kernels._sparse_scan_at(64, *scan),
        "compact": lambda: _kernels.compact(hay, 64),
    }
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        calls[kernel]()
