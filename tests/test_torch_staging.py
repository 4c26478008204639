"""Staging on the CPU.  One document (``scan_cuda.stage_padded``): the
staged layout equals the zero-padded numpy layout byte for byte, each
byte is counted once (``pin_bytes`` the haystack, ``pad_bytes`` the
tail, ``h2d_bytes`` the layout), and the Teddy, dense and shard sites
stage through it; the dense scan cuts its segments by their context.  A batch's rows (``scan_cuda.stage_rows``): the staged
rows equal the zero-padded ``[Bb, T]`` numpy layout, the lengths come
with them, every byte is counted (``pad_bytes`` the rows, ``pin_bytes``
the documents and 4 bytes a row, ``h2d_bytes`` the rows and the
lengths), and the one-device and sharded batch scans stage through it.
The card's pinned blocks are held in ``tests/test_torch_gpu.py``."""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from ahocorasick_rs_tpu_torch.models.automaton import build_automaton
from ahocorasick_rs_tpu_torch.models.prefilter import build_prefilter
from ahocorasick_rs_tpu_torch.ops import scan_cuda, scan_teddy
from ahocorasick_rs_tpu_torch.parallel import sharded
from ahocorasick_rs_tpu_torch.utils import trace

CPU = torch.device("cpu")
#: a length whose layout (the floor of 8 rows of 128) is over half tail
OVER_HALF = 300
#: haystack lengths: empty, around one 128-byte row, past 64 KiB, and
#: one past 1,024 rows, whose layout of 2,048 rows is just under half tail
SIZES = [0, 1, 127, 128, 129, OVER_HALF, (64 << 10) + 3, 128 * 1024 + 1]
#: a batch's documents by their lengths (``stage_rows``): with empty
#: documents, with ones of exactly ``T`` bytes, and past ``MIN_LANES`` rows
ROW_SETS = {
    "rows-with-empty": [0, 40, 3, 0, 17],
    "rows-of-exactly-T": [64, 10, 64, 63],
    "rows-past-min-lanes": [100, 1, 0, 128, 7, 99, 64, 2, 31, 5],
}


def _hay(n: int) -> np.ndarray:
    """``n`` bytes none of which is zero, so a tail left unzeroed shows."""
    return np.random.default_rng(n).integers(1, 256, n, dtype=np.uint8)


def _padded(hay: np.ndarray, total: int) -> np.ndarray:
    want = np.zeros(total, dtype=np.uint8)
    want[: len(hay)] = hay
    return want


def _rows(lens: list[int]):
    """Documents of ``lens`` bytes, none zero, their ``(Bb, T)`` layout,
    and that layout zero-padded and its lengths, as numpy builds them."""
    docs = [_hay(k) for k in lens]
    Bb, T = scan_cuda.batch_layout(lens, 1)
    want = np.zeros((Bb, T), dtype=np.uint8)
    for i, d in enumerate(docs):
        want[i, : len(d)] = d
    want_lens = np.zeros(Bb, dtype=np.int32)
    want_lens[: len(lens)] = lens
    return docs, (Bb, T), want, want_lens


def _teddy_rows(n: int) -> int:
    rows = -(-max(n, 1) // 128)
    R = min(scan_teddy.BLOCK_ROWS, scan_cuda._bucket(rows, lo=8))
    return max(R, scan_cuda._bucket(rows, lo=8))


def _scanner() -> scan_teddy.TeddyScanner:
    names = [b"hello", b"world", b"boundary"]
    am = build_automaton(names)
    return scan_teddy.TeddyScanner(
        am, build_prefilter(names), scan_cuda.DeviceTables(am, "dfa", CPU)
    )


@pytest.mark.parametrize(
    "n", SIZES + [pytest.param(k, id=k) for k in ROW_SETS]
)
def test_staged_layout_is_the_zero_padded_layout(n: int | str) -> None:
    if n in ROW_SETS:
        docs, (Bb, T), want, want_lens = _rows(ROW_SETS[n])
        trace.reset_counters()
        rows, lens = scan_cuda.stage_rows(docs, (Bb, T), CPU)
        assert rows.dtype == torch.uint8 and lens.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), want)
        np.testing.assert_array_equal(lens.numpy(), want_lens)
        assert trace.counters() == {
            "pad_bytes": Bb * T, "pin_bytes": sum(ROW_SETS[n]) + 4 * Bb,
            "h2d_bytes": Bb * T + 4 * Bb,
        }
        return
    hay = _hay(n)
    rows_p = _teddy_rows(n)
    got = scan_cuda.stage_padded(hay, (rows_p, 128), CPU)
    assert got.shape == (rows_p, 128) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().ravel(),
                                  _padded(hay, rows_p * 128))
    if n == OVER_HALF:
        assert rows_p * 128 - n > rows_p * 64


@pytest.mark.parametrize("n", SIZES)
def test_teddy_stage_counts_each_byte_once(n: int) -> None:
    hay = _hay(n)
    total = _teddy_rows(n) * 128
    trace.reset_counters()
    got = _scanner().stage(hay)
    np.testing.assert_array_equal(got.numpy().ravel(), _padded(hay, total))
    assert trace.counters() == {
        "pin_bytes": n, "pad_bytes": total - n, "h2d_bytes": total,
    }


def test_a_read_only_haystack_stages_without_a_warning() -> None:
    """A ``bytes`` haystack's view, as the API passes it, at an offset."""
    data = _hay(5000).tobytes()
    hay = np.frombuffer(data, dtype=np.uint8)[7:4007]
    assert not hay.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = scan_cuda.stage_padded(hay, (4096,), CPU)
    np.testing.assert_array_equal(got.numpy(), _padded(hay, 4096))
    assert data == _hay(5000).tobytes()  # nothing wrote through the view


def test_stage_segment_on_the_cpu_has_no_event() -> None:
    hay = _hay(1000)
    sc = _scanner()
    got, ready = sc._stage_segment(hay)
    assert ready is None and sc._copy_stream is None
    np.testing.assert_array_equal(got.numpy().ravel(),
                                  _padded(hay, _teddy_rows(1000) * 128))


def test_a_haystack_longer_than_its_layout_is_refused() -> None:
    with pytest.raises(ValueError, match="exceed"):
        scan_cuda.stage_padded(_hay(129), (128,), CPU)


@pytest.mark.parametrize("n", [1, 3000, 4096, 5000])
def test_every_shard_is_its_slice_of_the_padded_layout(n: int) -> None:
    hay, LT, ranks = _hay(n), 1024, 5
    want = _padded(hay, ranks * LT)
    trace.reset_counters()
    for r in range(ranks):
        got = sharded._shard_of(hay, r, LT, CPU)
        np.testing.assert_array_equal(got.numpy(), want[r * LT:(r + 1) * LT])
    assert trace.counters() == {
        "pin_bytes": n, "pad_bytes": ranks * LT - n, "h2d_bytes": ranks * LT,
    }


def test_dense_segments_stage_each_byte_once(monkeypatch) -> None:
    """``scan_device`` over three segments: each segment's context and
    bytes are pinned once and only its layout's tail is padded."""
    names = [b"hello", b"world"]
    am = build_automaton(names)
    tables = scan_cuda.DeviceTables(am, "dfa", CPU, packed2_max_bytes=0)
    hay = np.frombuffer(b"xhello worldy" * 700, dtype=np.uint8)
    staged: list[tuple[int, int]] = []
    orig = scan_cuda.stage_padded

    def spy(h, shape, device, stream=None):
        staged.append((len(h), int(np.prod(shape))))
        return orig(h, shape, device, stream)

    monkeypatch.setattr(scan_cuda, "stage_padded", spy)
    trace.reset_counters()
    pos, _st = scan_cuda.scan_device(am, hay, tables, segment_bytes=4096)
    assert [m for m, _ in staged] == [4096, 4096, 916] and len(pos) == 2 * 700
    assert trace.counters() == {
        "pin_bytes": sum(m for m, _ in staged),
        "pad_bytes": sum(t - m for m, t in staged),
        "h2d_bytes": sum(t for _, t in staged),
    }


#: the cut rule's power-of-two segment, and a haystack three full segments
#: and a short tail long: 4,096 + 3 × (4,096 − halo) new bytes and 50 more
CUT_SEGMENT = 4096
CUT_NAMES = [b"hello", b"world", b"abcdefghab", b"bore", b"dwarf"]


@pytest.mark.parametrize("packed2_max_bytes", [0, None], ids=["k2-odd-halo",
                                                             "stride2-even-halo"])
def test_dense_segments_are_cut_by_their_context(
    packed2_max_bytes, monkeypatch
) -> None:
    """``scan_device`` cuts every context (halo and new bytes) at the
    segment length: contexts overlap by exactly the halo, their new bytes
    cover the haystack once, a power-of-two segment pads at most one
    minimal layout, and the tuples equal the JAX package's
    ``scan_device``, which cuts segments by their start."""
    import ahocorasick_rs_tpu.ops.scan_jax as ref_scan
    from ahocorasick_rs_tpu.models.automaton import (
        build_automaton as ref_build,
    )
    from ahocorasick_rs_tpu_torch.utils import convert

    ref_am = ref_build(CUT_NAMES)
    am = convert.automaton_from_arrays(
        ref_am.edge_keys, ref_am.edge_targets, ref_am.fail, ref_am.depth,
        ref_am.match_offsets, ref_am.match_pids, ref_am.pattern_lens,
    )
    kw = {} if packed2_max_bytes is None else {"packed2_max_bytes": 0}
    tables = scan_cuda.DeviceTables(am, "dfa", CPU, **kw)
    stride2 = tables.ensure_packed2()
    assert stride2 == (packed2_max_bytes is None)
    halo = am.max_len - 1 + stride2  # 9, or 10 for pairs
    n = CUT_SEGMENT + 3 * (CUT_SEGMENT - halo) + 50
    text = bytearray(b"xhello worldy dwarf " * (n // 20 + 1))[:n]
    seams = [CUT_SEGMENT + k * (CUT_SEGMENT - halo) for k in range(4)]
    for seam in seams:  # a name across every seam of the plan
        text[seam - 5 : seam + 5] = b"abcdefghab"
    hay = np.frombuffer(bytes(text), dtype=np.uint8)
    staged: list[tuple[int, int]] = []
    orig = scan_cuda.stage_padded

    def spy(h, shape, device, stream=None):
        staged.append((h.ctypes.data - hay.ctypes.data, len(h)))
        return orig(h, shape, device, stream)

    monkeypatch.setattr(scan_cuda, "stage_padded", spy)
    trace.reset_counters()
    got = scan_cuda.scan_device(am, hay, tables, segment_bytes=CUT_SEGMENT)
    assert len(staged) == 5 and staged[-1][1] == 50 + halo  # a short tail
    assert all(m <= CUT_SEGMENT for _, m in staged)
    assert staged[0] == (0, CUT_SEGMENT)
    new = [(0, CUT_SEGMENT)]
    for (s0, m0), (s1, m1) in zip(staged, staged[1:]):
        assert s0 + m0 - s1 == halo  # overlap by exactly the halo
        new.append((s1 + halo, s1 + m1))
    assert [a for a, _ in new[1:]] == [b for _, b in new[:-1]]
    assert new[-1][1] == n  # the new bytes cover the haystack once
    assert trace.counters()["pad_bytes"] <= (
        scan_cuda.MIN_LANES * scan_cuda.TARGET_TIME)
    want = ref_scan.scan_device(
        ref_am, hay, ref_scan.DeviceTables(ref_am, "dfa", **kw),
        segment_bytes=CUT_SEGMENT,
    )
    assert len(want[0]) > 4 * 50
    assert {seam + 4 for seam in seams} <= set(got[0].tolist())
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ranks", [1, 3])
def test_batch_scans_stage_every_row_block_through_stage_rows(
    ranks: int, monkeypatch
) -> None:
    """``scan_device_batch`` (one rank) and every rank of
    ``scan_sharded_batch`` over ``["cpu"] * 3`` stage their own row block
    through ``stage_rows``, each row counted once over all ranks."""
    names = [b"hello", b"world"]
    am = build_automaton(names)
    tables = scan_cuda.DeviceTables(am, "dfa", CPU)
    lens = ROW_SETS["rows-past-min-lanes"]
    text = b"xhello worldy" * 10
    docs = [np.frombuffer(text[:k], np.uint8) for k in lens]
    Bb, T = scan_cuda.batch_layout(lens, ranks)
    Bl = Bb // ranks
    staged: list[tuple[tuple[int, ...], tuple[int, int]]] = []
    module = scan_cuda if ranks == 1 else sharded
    orig = module.stage_rows

    def spy(d, shape, device):
        staged.append((tuple(len(x) for x in d), shape))
        return orig(d, shape, device)

    monkeypatch.setattr(module, "stage_rows", spy)
    trace.reset_counters()
    if ranks == 1:
        pos, _st, got_T = scan_cuda.scan_device_batch(am, docs, tables)
    else:
        mesh = sharded.make_mesh(devices=["cpu"] * ranks)
        pos, _st, got_T = sharded.scan_sharded_batch(am, docs, tables, mesh)
    assert got_T == T
    assert sorted(staged) == sorted(
        (tuple(lens[r * Bl : (r + 1) * Bl]), (Bl, T)) for r in range(ranks)
    )
    assert len(pos) == sum(
        text[:k].count(b"hello") + text[:k].count(b"world") for k in lens
    )
    want = {
        "pad_bytes": Bb * T, "pin_bytes": sum(lens) + 4 * Bb,
        "h2d_bytes": Bb * T + 4 * Bb,
    }
    if ranks > 1:
        # every rank receives the others' positions, states and total,
        # int64 at the capacity the call started from
        want["gather_bytes"] = ranks * (ranks - 1) * (2 * tables.last_cap
                                                      + 1) * 8
    assert trace.counters() == want
