"""PyTorch port, K4 (the Teddy verify body): the fused kernel's design,
held on the CPU.

On a card, ``ops/scan_teddy.py`` ``_verify_body`` is one launch of
``csrc/verify.cu``: each window's ``W`` steps are cut into ``k`` pieces
(``_kernels.verify_split``), each walked from the root ``halo`` steps
before its first owned step, and the matched steps are compacted in flat
order inside the kernel, with the padding the reference leaves.  A CUDA
kernel cannot run here, so this file holds the design's arithmetic:

* a walk cut into pieces exactly as the kernel cuts them equals the plain
  walk (``_verify_walk_plain``) for any ``k``: halo 0, ``max_len`` above
  ``COARSE`` (W > 63), windows past ``n`` and windows with a negative fire
  position (window 0 among them), over the DFA and the classed tables;
* a model of the kernel's outputs (each piece's matched steps at its
  exclusive offset, the first ``cap2`` kept, the rest padded with ``(-1,
  0, the state after window 0's first step)``) equals the JAX package's
  ``_verify_body`` and the port's plain one, padding included, and its
  total is exact when it exceeds ``cap2``;
* the kernel wrappers refuse CPU tensors.

``tests/test_torch_gpu.py`` holds the kernel itself against the plain
``_verify_body`` on the card.  Every comparison is exact (integers).
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu.ops.scan_teddy as ref_teddy
from ahocorasick_rs_tpu_torch import _kernels
from ahocorasick_rs_tpu_torch.models.automaton import PAD_BYTE, build_automaton
from ahocorasick_rs_tpu_torch.ops import scan_cuda
from ahocorasick_rs_tpu_torch.ops import scan_teddy as port_teddy

MASK = (1 << _kernels.FLAG_SHIFT) - 1
COARSE = port_teddy.COARSE
#: matched steps a piece keeps in shared memory before it walks again
#: (``kSlots`` in ``csrc/verify.cu``)
SLOTS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes that share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _names(seed: int, count: int) -> list[bytes]:
    rng = random.Random(seed)
    return [
        bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(4, 9)))
        for _ in range(count)
    ]


#: pattern sets: the names (halo 8), one-byte patterns (halo 0) and the
#: names with a 40-byte pattern (max_len above COARSE: W = 71 > 63)
CASES = {
    "names": _names(41, 40),
    "halo0": [b"a", b"c", b"h"],
    "long": _names(42, 30) + [b"abcdefgh" * 5],
}


def _setup(case: str, engine: str, fp0: str = "real"):
    """Automaton tables (as the Teddy scanner reads them), a haystack of
    n = 5,003 bytes in a buffer of 5,120, and 96 windows: 60 fired groups
    (window 0 at position 0, where a name starts, or at -1), the group
    holding byte n - 1, one at n, and -1 padding."""
    names = CASES[case]
    am = build_automaton(names)
    tabs = scan_cuda.DeviceTables(am, engine, "cpu")
    rng = np.random.default_rng(len(names) * 7 + len(case))
    n = 5003
    hay = bytearray(
        np.frombuffer(b"zyxwvutsabcdefgh", np.uint8)[
            rng.integers(0, 16, n)
        ].tobytes()
    )
    for _ in range(80):
        nm = names[int(rng.integers(len(names)))]
        off = int(rng.integers(n - len(nm)))
        hay[off : off + len(nm)] = nm
    hay[: len(names[0])] = names[0]
    buf = np.zeros(5120, dtype=np.uint8)
    buf[:n] = np.frombuffer(bytes(hay), np.uint8)
    groups = np.sort(rng.choice(np.arange(1, n // COARSE), 60, replace=False))
    fire_pos = np.full(96, -1, dtype=np.int32)
    fire_pos[0] = 0 if fp0 == "real" else -1
    fire_pos[1:61] = groups * COARSE
    fire_pos[61] = (n // COARSE) * COARSE  # its window runs past n
    fire_pos[62] = n  # every byte past n
    W = am.max_len + COARSE - 1
    return am, tabs, torch.from_numpy(buf), torch.from_numpy(fire_pos), n, W


def _plain_args(tabs, hay, fire_pos, n, W):
    return (tabs.lane_table(), tabs.classes, hay, fire_pos, n, W)


def _piece_walk(
    vtable, classes, hay, fire_pos, n: int, W: int, use_classes: bool,
    halo: int, k: int,
) -> torch.Tensor:
    """The packed walk [M, W] as the kernel makes it: each piece of
    ``_kernels.verify_piece_bounds`` walked from the root at its first
    walked step, keeping only the steps it owns (each step owned once)."""
    fp = fire_pos.long()
    M = fp.numel()
    src = fp.clamp(min=0)[:, None] + torch.arange(W)[None, :]
    invalid = (src >= n) | (fp[:, None] < 0)
    ext = hay[src.clamp(max=hay.numel() - 1)].long()
    ext = torch.where(invalid, PAD_BYTE, ext)
    if use_classes:
        ext = classes.long()[ext]
    ncols = vtable.shape[1]
    flat = vtable.reshape(-1)
    out = torch.full((M, W), -1, dtype=torch.int32)
    owners = torch.zeros(W, dtype=torch.int64)
    for start, lo, hi in _kernels.verify_piece_bounds(W, halo, k):
        assert start == max(0, lo - halo) and lo <= hi
        owners[lo:hi] += 1
        s = torch.zeros(M, dtype=torch.long)
        for j in range(start, hi):
            v = flat[s * ncols + ext[:, j]]
            if j >= lo:
                out[:, j] = v
            s = (v & MASK).long()
    assert torch.equal(owners, torch.ones(W, dtype=torch.int64))
    return out


def _fused_model(
    vtable, classes, hay, fire_pos, n: int, W: int, cap2: int,
    use_classes: bool, halo: int, k: int,
) -> tuple[torch.Tensor, ...]:
    """The fused kernel's outputs, computed as it computes them: windows
    of PAD alone are skipped when the root's PAD transition is 0; each
    piece counts its matched steps, takes its exclusive offset in (window,
    piece) order and writes its steps below ``cap2`` (the first ``SLOTS``
    from shared memory, the rest from a second walk: the same steps); the
    rest of ``cap2`` holds (-1, 0, the state after window 0's first
    step)."""
    walk = _piece_walk(
        vtable, classes, hay, fire_pos, n, W, use_classes, halo, k
    )
    cls = classes.long() if use_classes else torch.arange(257)
    pad_idle = int(vtable[0, cls[PAD_BYTE]]) == 0
    bounds = _kernels.verify_piece_bounds(W, halo, k)
    win = torch.full((cap2,), -1, dtype=torch.int32)
    step = torch.zeros(cap2, dtype=torch.int32)
    fp0 = int(fire_pos[0])
    b0 = int(hay[fp0]) if 0 <= fp0 < n else PAD_BYTE
    st = torch.full((cap2,), int(vtable[0, cls[b0]]) & MASK,
                    dtype=torch.int32)
    offset = 0
    for i in range(fire_pos.numel()):
        fp = int(fire_pos[i])
        for _, lo, hi in bounds:
            if (fp < 0 or fp >= n) and pad_idle:
                continue
            js = [j for j in range(lo, hi) if int(walk[i, j]) >= 1 << 24]
            for r, j in enumerate(js):
                if offset + r < cap2:
                    win[offset + r] = i
                    step[offset + r] = j
                    st[offset + r] = int(walk[i, j]) & MASK
            offset += len(js)
    return win, step, st, torch.tensor([offset], dtype=torch.int32)


def _ref_verify_body(tabs, hay, fire_pos, n: int, W: int, cap2: int):
    """The JAX package's ``_verify_body`` as ``_fire_verify`` runs it,
    over ``hay`` with the reference's ``VCHUNK`` padding."""
    pad = -(-W // ref_teddy.VCHUNK) * ref_teddy.VCHUNK
    hay_pad = jnp.concatenate(
        [jnp.asarray(hay.numpy()), jnp.zeros((pad,), jnp.uint8)]
    )
    fn = jax.jit(ref_teddy._verify_body, static_argnums=(5, 6, 7))
    out = fn(
        jnp.asarray(tabs.lane_table().numpy()),
        jnp.asarray(tabs.classes.numpy()), hay_pad,
        jnp.asarray(fire_pos.numpy()), jnp.int32(n), W, cap2,
        tabs.use_classes,
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("k", [1, 2, 3, 4, "W"])
@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_piece_walk_equals_plain_walk(case: str, engine: str, k) -> None:
    """The split is exact: a walk cut into pieces, each warmed up from the
    root over the halo, reaches the plain walk's state at every step."""
    am, tabs, hay, fire_pos, n, W = _setup(case, engine, "negative")
    halo = am.max_len - 1
    assert halo == max(W - COARSE, 0)  # what _verify_body passes the kernel
    if case == "halo0":
        assert halo == 0
    if case == "long":
        assert W > 63
    k = W if k == "W" else k
    want = port_teddy._verify_walk_plain(
        *_plain_args(tabs, hay, fire_pos, n, W), tabs.use_classes
    )
    got = _piece_walk(
        *_plain_args(tabs, hay, fire_pos, n, W), tabs.use_classes, halo, k
    )
    assert torch.equal(got, want)
    # the windows that read PAD alone hold no match; the real ones do
    assert (want[62:] < (1 << 24)).all()
    assert (want[1:61] >= (1 << 24)).any()


@pytest.mark.parametrize("fp0", ["real", "negative"])
@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_model_padding_equals_reference(
    case: str, engine: str, fp0: str
) -> None:
    """At cap2 above the total, the model of the kernel's outputs equals
    the JAX package's ``_verify_body`` and the port's plain one in all
    cap2 entries: the padded ``st`` is the state after window 0's first
    step, which is not the root when window 0 starts with a name."""
    am, tabs, hay, fire_pos, n, W = _setup(case, engine, fp0)
    cap2 = 4096
    want = _ref_verify_body(tabs, hay, fire_pos, n, W, cap2)
    plain = port_teddy._verify_body(
        *_plain_args(tabs, hay, fire_pos, n, W), cap2, tabs.use_classes
    )
    total = int(want[3])
    assert 0 < total < cap2
    pad_st = int(want[2][-1])
    assert (pad_st != 0) == (fp0 == "real")
    halo = am.max_len - 1
    for k in (1, 3, _kernels.plan_pieces(fire_pos.numel(), W, halo, 132)):
        got = _fused_model(
            *_plain_args(tabs, hay, fire_pos, n, W), cap2,
            tabs.use_classes, halo, k,
        )
        for a, b, c in zip(got, want, plain):
            np.testing.assert_array_equal(a.numpy(), b)
            np.testing.assert_array_equal(c.numpy(), b)


@pytest.mark.parametrize("engine", ["dfa", "classed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_model_total_exact_over_cap(case: str, engine: str) -> None:
    """At cap2 below the total, the total stays exact and the cap2
    entries are the first matched steps, as in the plain body; one piece
    with more than SLOTS matched steps (the one-byte patterns on a run of
    them) takes the kernel's second walk."""
    am, tabs, hay, fire_pos, n, W = _setup(case, engine)
    if case == "halo0":
        hay[COARSE * 3 : COARSE * 4 + 8] = ord("a")  # a piece of 9+ matches
    args = _plain_args(tabs, hay, fire_pos, n, W)
    _, _, _, total = port_teddy._verify_body(*args, 4096, tabs.use_classes)
    total = int(total)
    halo = am.max_len - 1
    for cap2 in (1, total // 2, total - 1):
        plain = port_teddy._verify_body(*args, cap2, tabs.use_classes)
        assert int(plain[3]) == total > cap2
        assert (plain[0] >= 0).all()
        for k in (1, 2, 4):
            got = _fused_model(*args, cap2, tabs.use_classes, halo, k)
            for a, b in zip(got, plain):
                assert torch.equal(a, b)
    if case == "halo0":
        walk = port_teddy._verify_walk_plain(*args, tabs.use_classes)
        per_window = (walk >= 1 << 24).sum(dim=1)
        assert int(per_window.max()) > SLOTS


@pytest.mark.parametrize(
    "W,halo", [(42, 10), (32, 0), (71, 39), (632, 600), (40, 8), (1, 0)]
)
def test_piece_plan_partitions_the_window(W: int, halo: int) -> None:
    """Every cut the wrappers can take owns each step once and walks at
    most L steps a piece; the plan fills the card only while the pieces
    own steps and walk at most twice the window in all."""
    for k in range(1, min(W, 64) + 1):
        L, D = _kernels.verify_split(W, halo, k)
        if k > 1 and D < 1:
            continue
        bounds = _kernels.verify_piece_bounds(W, halo, k)
        assert bounds[0][:2] == (0, 0) and bounds[-1][2] == W
        for (s0, lo, hi), nxt in zip(bounds, bounds[1:] + [(0, W, W)]):
            assert hi == nxt[1] and hi - s0 <= L
    for M in (1, 100, 16384, 32768, 1 << 17):
        k = _kernels.plan_pieces(M, W, halo, 132)
        assert 1 <= k <= _kernels.VERIFY_MAX_PIECES
        L, D = _kernels.verify_split(W, halo, k)
        assert k == 1 or (D >= 1 and k * L <= 2 * W
                          and L + (k - 2) * D < W)
    # the names set's windows: 32,768 of them are cut, 2^18 fill the card
    if (W, halo) == (42, 10):
        assert _kernels.plan_pieces(32768, W, halo, 132) > 1
        assert _kernels.plan_pieces(1 << 18, W, halo, 132) == 1
    if halo >= W - 1:
        assert _kernels.plan_pieces(1, W, halo, 132) == 1


def test_verify_wrappers_refuse_cpu_tensors() -> None:
    am, tabs, hay, fire_pos, n, W = _setup("names", "dfa")
    args = _plain_args(tabs, hay, fire_pos, n, W)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.verify_body(*args, 4096, tabs.use_classes)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.verify(*args, tabs.use_classes)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.verify_body(*args, 4096, tabs.use_classes,
                             halo=am.max_len - 1, pieces=3)
