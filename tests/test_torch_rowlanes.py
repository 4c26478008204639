"""PyTorch port: what the redesigned K5 (batch scan) and K6 (stride-2 scan)
rest on, held on the CPU through their plain versions.

K5 cuts each document row of ``T`` bytes into sub-lanes of ``S`` bytes
(``_kernels.batch_sublanes``), each warmed from the root by the ``halo``
bytes before it inside the same row; bytes at or past ``lens[b]`` read
PAD.  That changes no output: the plain K5 walked as such in-row
sub-lanes (an emulation of the kernel's split written here) equals the
plain K5 at the caller's layout at the mask and at the states under it,
and the port's ``_scan_batch_compact`` equals the JAX package's.  K6 now
has K2's output contract (the mask, and the state at each matched byte,
the mid-pair state rebuilt at a matched first byte): its plain version
equals the plain K2 at the mask, and ``_scan_compact2`` over it equals
the JAX package's ``_scan_compact2``.  The build directory's hash covers
every file of ``csrc/``, headers included.  Inputs are made from a seed
with numpy; every comparison is exact (tolerance 0: all values are
integers).
"""

from __future__ import annotations

import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
from ahocorasick_rs_tpu.models.automaton import build_automaton
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan
from ahocorasick_rs_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _names(seed: int, count: int, lo: int = 2, hi: int = 7) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(lo, hi)))
        for _ in range(count)
    ]


def _port_automaton(am):
    """The reference's very automaton, carried across as arrays."""
    return convert.automaton_from_arrays(
        am.edge_keys, am.edge_targets, am.fail, am.depth,
        am.match_offsets, am.match_pids, am.pattern_lens,
    )


def _rows(seed: int, B: int, T: int, names: list[bytes]) -> tuple[
    np.ndarray, np.ndarray
]:
    """A ``[B, T]`` buffer full of bytes (the padding past ``lens`` is not
    zero and holds names too) and ``lens`` with 0, 1, odd and ``T``.  In
    row ``b`` the longest name ends at the ``b``-th multiple of 16 (cycling
    over the row): a match whose first byte is the last a sub-lane's
    warm-up reaches."""
    rng = np.random.default_rng(seed)
    buf = np.frombuffer(b"abcdefgh zyx", np.uint8)[
        rng.integers(0, 12, B * T)
    ].copy()
    for _ in range(B * T // 30 + 1):
        nm = names[int(rng.integers(len(names)))][:T]
        off = int(rng.integers(B * T - len(nm) + 1))
        buf[off : off + len(nm)] = np.frombuffer(nm, np.uint8)
    buf = buf.reshape(B, T)
    longest = np.frombuffer(max(names, key=len), np.uint8)
    for b in range(B):
        end = 16 * (b % (T // 16))  # the position of its last byte
        if end + 1 >= len(longest):
            buf[b, end + 1 - len(longest) : end + 1] = longest
    lens = rng.integers(0, T + 1, B).astype(np.int32)
    lens[4::2] = T
    lens[:4] = (0, 1, T, T - 1)
    return buf, lens


def _sublane_lengths(T: int, halo: int) -> list[int]:
    """Every sub-lane length K5's wrapper takes for rows of ``T`` bytes:
    a multiple of 16 dividing ``T`` and covering the in-row warm-up."""
    return [
        S for S in range(16, T + 1, 16)
        if T % S == 0 and S >= min(halo, T - S)
    ]


def _in_row_sublanes(tabs, hay2d: torch.Tensor, lens: torch.Tensor,
                     halo: int, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain K5 walked as the kernel splits it: sub-lane ``(b, t0)``
    is a document of row ``b``'s bytes from ``w0 = max(0, t0 - halo)`` to
    ``t0 + S`` (real up to ``lens[b]``), walked from the root; its states
    at ``t0 .. t0 + S - 1`` are the sub-lane's."""
    B, T = hay2d.shape
    halo = min(halo, T - S)
    per = T // S
    G = B * per
    width = halo + S
    b = torch.arange(G) // per
    t0 = (torch.arange(G) % per) * S
    w0 = (t0 - halo).clamp(min=0)
    col = w0[:, None] + torch.arange(width)[None, :]  # row offsets walked
    inside = col < T
    sub = hay2d[b[:, None], col.clamp(max=T - 1)]
    sub_lens = (torch.minimum(lens.long()[b], t0 + S) - w0).clamp(min=0)
    sub_lens = torch.minimum(sub_lens, inside.sum(dim=1))
    st, mask = port_scan._batch_scan_plain(
        tabs.table, tabs.classes, sub.contiguous(), sub_lens.to(torch.int32),
        tabs.match_count, tabs.use_classes,
    )
    # the sub-lane's own S positions sit at columns t0 - w0 .. + S - 1
    pick = (t0 - w0)[:, None] + torch.arange(S)[None, :]
    flat = (torch.arange(G)[:, None] * width + pick).reshape(-1)
    return st[flat], mask[flat]


#: (T, longest name): halo 0, halo T - 1, a halo past T, odd and even
ROW_CASES = [
    (16, 1), (16, 16), (64, 9), (64, 64), (64, 90), (128, 15), (256, 14),
]


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("T,longest", ROW_CASES, ids=str)
def test_in_row_sublanes_equal_caller_layout(
    engine: str, T: int, longest: int
) -> None:
    """The plain K5 at the caller's ``[B, T]`` equals its in-row sub-lane
    walk for every S the kernel's wrapper takes, at the mask and at the
    states under it, with lens 0, 1, odd and T and padding that is not
    zero."""
    names = _names(T + longest, 25, 1, min(longest, 7)) + [
        b"abcdefgh" * (longest // 8) + b"abcdefgh"[: longest % 8]
    ]
    am = _port_automaton(build_automaton(names))
    tabs = port_scan.DeviceTables(am, engine, "cpu")
    assert tabs.halo == longest - 1
    buf, lens = _rows(T * 7 + longest, 21, T, names)
    hay2d, lens_t = torch.from_numpy(buf), torch.from_numpy(lens)
    states, mask = port_scan._batch_scan_plain(
        tabs.table, tabs.classes, hay2d, lens_t, tabs.match_count,
        tabs.use_classes,
    )
    assert int(mask.sum()) > 0
    hit = mask.bool()
    lengths = _sublane_lengths(T, tabs.halo)
    assert _kernels.batch_sublanes(21, T, tabs.halo, 132) in lengths
    for S in lengths:
        st_s, mask_s = _in_row_sublanes(tabs, hay2d, lens_t, tabs.halo, S)
        assert torch.equal(mask_s, mask), S
        assert torch.equal(st_s[hit], states[hit]), S


# (B, T, halo, sm_count, the S wanted): LONG, SHORT, one rank of two,
# halo T - 1 and past T, small batches
BATCH_PLANS = [
    (32768, 1024, 10, 132, 128),
    (16384, 128, 14, 132, 16),
    (16384, 1024, 10, 132, 64),
    (64, 64, 63, 132, 64),
    (64, 64, 200, 132, 64),
    (8, 16, 0, 132, 16),
    (8, 1024, 3, 132, 16),
]


@pytest.mark.parametrize("B,T,halo,sms,want", BATCH_PLANS, ids=str)
def test_batch_sublanes(B: int, T: int, halo: int, sms: int,
                        want: int) -> None:
    S = _kernels.batch_sublanes(B, T, halo, sms)
    assert S == want
    assert S in _sublane_lengths(T, halo)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("T,longest", [(16, 3), (32, 40), (128, 9)], ids=str)
def test_scan_batch_compact_equals_reference_rows(
    engine: str, T: int, longest: int
) -> None:
    """The port's ``_scan_batch_compact`` equals the JAX package's on rows
    with lens 0, 1, odd and T and padding bytes that hold names."""
    names = _names(longest, 30, 1, min(longest, 7)) + [b"h" * longest]
    ref_am = build_automaton(names)
    pt = port_scan.DeviceTables(_port_automaton(ref_am), engine, "cpu")
    rt = ref_scan.DeviceTables(ref_am, engine)
    buf, lens = _rows(T + longest, 24, T, names)
    for cap in (16, 4096):
        want = ref_scan._scan_batch_compact(
            rt.table, rt.classes, jnp.asarray(buf), jnp.asarray(lens),
            rt.match_count, cap, rt.use_classes,
        )
        got = port_scan._scan_batch_compact(
            pt.table, pt.classes, torch.from_numpy(buf),
            torch.from_numpy(lens), pt.match_count, cap, pt.use_classes,
            pt.lane_table(), pt.halo,
        )
        assert int(got[2]) == int(want[2]) > 16
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("halo", [0, 2, 4, 6, 8, 10, 12])
def test_stride2_plain_contract_equals_k2_and_reference(
    engine: str, halo: int
) -> None:
    """The plain K6 (K2's contract) equals the plain K2 at the mask and the
    states under it, and ``_scan_compact2`` over it equals the JAX
    package's, at even halos 0-12 and odd ``n``."""
    names = _names(halo + 3, 30, 1, halo + 1) + [b"abcdefghabcdefgh"[
        : halo + 1]]
    ref_am = build_automaton(names)
    assert ref_am.max_len - 1 <= halo
    am = _port_automaton(ref_am)
    L, T = 8, 256
    n = L * T - 2 * halo - 3  # odd
    rng = np.random.default_rng(halo)
    buf = np.frombuffer(b"abcdefgh zy", np.uint8)[
        rng.integers(0, 11, L * T)
    ].copy()
    pt = port_scan.DeviceTables(am, engine, "cpu")
    assert pt.ensure_packed2()
    hay = torch.from_numpy(buf)
    states, mask = port_scan._stride2_scan_plain(
        pt.packed2, pt.table_classed, pt.classes2, hay, n, L, T, halo
    )
    k2_states, k2_mask = port_scan._lane_scan_plain(
        pt.table, pt.classes, hay, pt.match_count, n, L, T, halo,
        pt.use_classes,
    )
    assert torch.equal(mask, k2_mask) and int(mask.sum()) > 100
    hit = mask.bool()
    assert torch.equal(states[hit], k2_states[hit])
    assert bool((states[0::2][~hit[0::2]] == -1).all())  # no mid loads
    rt = ref_scan.DeviceTables(ref_am, engine)
    assert rt.ensure_packed2()
    for cap in (64, 1 << 13):
        want = ref_scan._scan_compact2(
            rt.packed2, rt.table_classed, rt.classes2, jnp.asarray(buf),
            jnp.int32(n), L, T, halo, cap,
        )
        got = port_scan._scan_compact2(
            pt.packed2, pt.table_classed, pt.classes2, hay, n, L, T, halo,
            cap,
        )
        assert int(got[2]) == int(want[2])
        if int(want[2]) <= cap:
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize(
    "kernel",
    ["batch_scan", "_batch_scan_at", "stride2_scan", "_stride2_scan_at"],
)
def test_k5_k6_wrappers_refuse_cpu_tensors(kernel: str) -> None:
    """K5's and K6's wrappers launch only on CUDA tensors; a CPU tensor
    raises (the plain versions serve the CPU one layer up), and the
    dispatchers on a card need the flagged table and the halo."""
    am = _port_automaton(build_automaton(_names(11, 20)))
    tabs = port_scan.DeviceTables(am, "classed", "cpu")
    assert tabs.ensure_packed2()
    hay2d = torch.zeros((8, 64), dtype=torch.uint8)
    lens = torch.full((8,), 64, dtype=torch.int32)
    batch = (tabs.lane_table(), tabs.classes, hay2d, lens, tabs.halo,
             tabs.use_classes)
    pair = (tabs.packed2, tabs.table_classed, tabs.classes2,
            hay2d.reshape(-1), 512, 8, 64, tabs.halo + (tabs.halo & 1))
    calls = {
        "batch_scan": lambda: _kernels.batch_scan(*batch),
        "_batch_scan_at": lambda: _kernels._batch_scan_at(64, *batch),
        "stride2_scan": lambda: _kernels.stride2_scan(*pair),
        "_stride2_scan_at": lambda: _kernels._stride2_scan_at(64, *pair),
    }
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        calls[kernel]()


def test_scan_batch_on_card_needs_flagged_and_halo() -> None:
    """On a card the batch dispatcher has no plain fallback: without the
    flagged table or the halo it raises before any launch."""
    am = _port_automaton(build_automaton(_names(12, 20)))
    tabs = port_scan.DeviceTables(am, "dfa", "cpu")
    meta = torch.empty((8, 64), dtype=torch.uint8, device="meta")
    lens = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="flagged table and the halo"):
        port_scan.scan_batch(tabs.table, tabs.classes, meta, lens,
                             tabs.match_count, tabs.use_classes)


def test_source_hash_covers_headers(tmp_path) -> None:
    """The build directory's hash changes when a header of ``csrc/``
    changes or a file is added, and not otherwise."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    assert "sublane.cuh" in os.listdir(csrc)
    base = _kernels.source_hash(str(csrc))
    assert base == _kernels.source_hash()
    assert _kernels.source_hash(str(csrc)) == base
    with open(csrc / "sublane.cuh", "a") as f:
        f.write("\n// edited\n")
    edited = _kernels.source_hash(str(csrc))
    assert edited != base
    (csrc / "extra.cuh").write_text("// new header\n")
    assert _kernels.source_hash(str(csrc)) not in (base, edited)


def test_pad_column_is_root() -> None:
    """K5 and K6 skip their loads at PAD (before a row's start, past
    lens or n): sound because PAD sends every state to the root with no
    flags, in every table they read."""
    am = _port_automaton(build_automaton(_names(13, 40)))
    for engine in ("dfa", "classed"):
        tabs = port_scan.DeviceTables(am, engine, "cpu")
        assert tabs.ensure_packed2()
        col = int(tabs.classes[PAD_BYTE]) if tabs.use_classes else PAD_BYTE
        assert not tabs.table[:, col].any()
        pad = int(tabs.classes2[PAD_BYTE])
        C = tabs.table_classed.shape[1]
        assert not tabs.table_classed[:, pad].any()
        assert not tabs.packed2[:, pad * C + pad].any()
