"""PyTorch port, public API: the port's result tuples equal the JAX
package's on the same random inputs, for every tier (python, numpy,
native, device, and device through the Teddy pipeline), every match kind
(with ``overlapping`` where it is allowed), both dense engines, and both
``str`` and ``bytes`` haystacks.  The reference goldens and exact error
texts hold too.

The port runs with ``device="cpu"``: its device tier then takes the
kernels' plain PyTorch versions.  The reference's Teddy tier runs its
Pallas kernel in interpret mode.  Every comparison is exact.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import ahocorasick_rs_tpu as ref
import ahocorasick_rs_tpu_torch as port
from ahocorasick_rs_tpu_torch.api import DEVICE_TIER_MIN
from ahocorasick_rs_tpu_torch.ops import scan_cuda as port_scan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test files run in parallel worker
    processes, and torch's default of one thread per core would
    oversubscribe the cores that the other files' tests share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

KINDS = ["Standard", "LeftmostFirst", "LeftmostLongest"]
ENGINES = ["DFA", "ContiguousNFA"]
TIERS = ["python", "numpy", "native", "device", "teddy"]


def _make(pkg, cls: str, patterns, kind: str, engine: str, tier: str,
          **kw):
    kwargs = dict(
        matchkind=pkg.MatchKind[kind],
        implementation=pkg.Implementation[engine],
        backend="device" if tier == "teddy" else tier,
        **kw,
    )
    if pkg is port:
        kwargs["device"] = "cpu"
    ac = getattr(pkg, cls)(patterns, **kwargs)
    if tier == "teddy":
        ac._teddy_state = "force"
    return ac


def _bytes_case(seed: int) -> tuple[list[bytes], bytes]:
    rng = random.Random(seed)
    alphabet = b"abcdefgh"
    pats = sorted({
        bytes(rng.choice(alphabet) for _ in range(rng.randint(1, 7)))
        for _ in range(20)
    })
    hay = bytearray(bytes(rng.choice(alphabet + b"xyz ") for _ in range(3000)))
    for _ in range(30):
        p = pats[rng.randrange(len(pats))]
        off = rng.randrange(len(hay) - len(p))
        hay[off : off + len(p)] = p
    return pats, bytes(hay)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
def test_bytes_tuples_equal_reference(kind: str, engine: str, tier: str):
    pats, hay = _bytes_case(KINDS.index(kind) * 10 + ENGINES.index(engine))
    want_ac = _make(ref, "BytesAhoCorasick", pats, kind, engine, tier)
    got_ac = _make(port, "BytesAhoCorasick", pats, kind, engine, tier)
    want = want_ac.find_matches_as_indexes(hay)
    assert len(want) > 20
    assert got_ac.find_matches_as_indexes(hay) == want
    assert got_ac.stats()["last_backend"] == want_ac.stats()["last_backend"]
    if kind == "Standard":
        want_o = want_ac.find_matches_as_indexes(hay, overlapping=True)
        assert got_ac.find_matches_as_indexes(hay, overlapping=True) == want_o


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", KINDS)
def test_str_tuples_equal_reference_unicode(kind: str, tier: str):
    rng = random.Random(KINDS.index(kind))
    chars = "ab☃é🤦"
    hay = "".join(rng.choice(chars) for _ in range(1500))
    pats = sorted({
        "".join(rng.choice(chars) for _ in range(rng.randint(1, 4)))
        for _ in range(12)
    })
    engine = ENGINES[KINDS.index(kind) % 2]
    want_ac = _make(ref, "AhoCorasick", pats, kind, engine, tier)
    got_ac = _make(port, "AhoCorasick", pats, kind, engine, tier)
    want = want_ac.find_matches_as_indexes(hay)
    assert want
    assert got_ac.find_matches_as_indexes(hay) == want
    assert got_ac.find_matches_as_strings(hay) == (
        want_ac.find_matches_as_strings(hay)
    )
    if kind == "Standard":
        assert got_ac.find_matches_as_indexes(hay, overlapping=True) == (
            want_ac.find_matches_as_indexes(hay, overlapping=True)
        )


def test_auto_tier_on_device_sized_haystack():
    """A device-sized auto call routes to the device tier (the router's
    exploration step), and a forced Teddy call equals it."""
    pats = ["needle", "pin", "haystack"]
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
    buf = letters[rng.integers(0, len(letters), DEVICE_TIER_MIN)]
    for off in range(1000, DEVICE_TIER_MIN - 16, 65_537):
        buf[off : off + 6] = np.frombuffer(b"needle", dtype=np.uint8)
    hay = buf.tobytes().decode()
    ac = port.AhoCorasick(pats, device="cpu")
    got = ac.find_matches_as_indexes(hay)
    assert ac.stats()["last_backend"] == "device"
    assert "device" in ac.stats()["tier_bytes_per_second"]
    want = port.AhoCorasick(
        pats, backend="native", device="cpu"
    ).find_matches_as_indexes(hay)
    assert got == want and len(got) >= 31
    ac._teddy_state = "force"
    assert ac.find_matches_as_indexes(hay) == want
    assert ac.stats()["last_backend"] == "teddy"


@pytest.mark.parametrize("kind", ["Standard", "LeftmostLongest"])
def test_device_tier_dense_bailout(monkeypatch, kind: str):
    """Mirrors test_resolve_stream.py::test_device_tier_dense_bailout."""
    monkeypatch.setattr(port_scan, "DENSE_BAILOUT_MIN", 64)
    pats = [b"a" * k for k in range(1, 9)]
    hay = b"a" * (1 << 16)
    ac = port.BytesAhoCorasick(
        pats, matchkind=port.MatchKind[kind], backend="device", device="cpu"
    )
    got = ac.find_matches_as_indexes(hay)
    assert ac.stats()["last_backend"] in ("native_resolve", "numpy")
    want = ref.BytesAhoCorasick(
        pats, matchkind=ref.MatchKind[kind], backend="python"
    ).find_matches_as_indexes(hay)
    assert got == want


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_streaming_find_equals_reference(monkeypatch, backend: str):
    pats = [b"a" * k for k in (1, 2, 3, 7, 20)] + [b"ba", b"ab" * 9]
    rng = np.random.default_rng(5)
    hay = b"".join(
        b"a" * int(rng.integers(0, 60)) + b"b" * int(rng.integers(1, 3))
        for _ in range(200)
    )
    for kind in KINDS:
        ac = port.BytesAhoCorasick(
            pats, matchkind=port.MatchKind[kind], backend=backend,
            device="cpu",
        )
        monkeypatch.setattr(type(ac), "_STREAM_MIN", 1 << 12)
        monkeypatch.setattr(type(ac), "_STREAM_SEG", 1 << 11)
        monkeypatch.setattr(type(ac), "_STREAM_OCC", 1 << 9)
        want = ref.BytesAhoCorasick(
            pats, matchkind=ref.MatchKind[kind], backend="python"
        ).find_matches_as_indexes(hay)
        assert ac.find_matches_as_indexes(hay) == want


def test_router_gate_and_note_scan():
    """The measured-throughput router behaves as the reference's
    (test_engines_tiers.py::test_auto_router_measured_throughput_gate)."""
    ac = port.AhoCorasick(["needle", "pin"], device="cpu")
    ac._device_amortized = lambda n: True
    assert ac._auto_device_ok(1 << 22)
    ac._tier_bps = {"device": 1e9}
    assert not ac._auto_device_ok(1 << 22)
    ac._tier_bps = {"device": 1e12}
    hay = np.frombuffer(b"x" * (1 << 20), dtype=np.uint8)
    assert ac._auto_device_ok(1 << 22, hay)
    assert "host" in ac._tier_bps
    ac._tier_bps = {"host": 1e9, "device": 1e8}
    ac._probe_ctr = 0
    decisions = []
    for _ in range(16):
        ac._probe_ctr += 1
        decisions.append(ac._auto_device_ok(1 << 22))
    assert decisions.count(True) == 2 and decisions[7] and decisions[15]
    ac2 = port.AhoCorasick(["needle"], device="cpu")
    ac2._last_backend = "native"
    ac2._note_scan(DEVICE_TIER_MIN, 1.0)
    ac2._last_backend = "teddy"
    ac2._note_scan(4 * DEVICE_TIER_MIN, 1.0)
    assert ac2._tier_bps == {
        "host": DEVICE_TIER_MIN, "device": 4 * DEVICE_TIER_MIN
    }
    s = ac2.stats()
    assert s["device"] == "cpu" and s["scan_calls"] == 2


WINTER = "This is the winter of my discontent"
WINTER_PATTERNS = ["content", "disco", "disc", "discontent", "winter"]


@pytest.mark.parametrize(
    "kind,expected",
    [
        ("Standard", ["winter", "disc"]),
        ("LeftmostFirst", ["winter", "disco"]),
        ("LeftmostLongest", ["winter", "discontent"]),
    ],
)
def test_goldens(kind: str, expected: list[str]):
    mk = port.MatchKind[kind]
    ac = port.AhoCorasick(WINTER_PATTERNS, matchkind=mk, device="cpu")
    assert ac.find_matches_as_strings(WINTER) == expected
    bac = port.BytesAhoCorasick(
        [p.encode() for p in WINTER_PATTERNS], matchkind=mk, device="cpu"
    )
    got = bac.find_matches_as_indexes(WINTER.encode())
    assert [WINTER.encode()[s:e].decode() for (_, s, e) in got] == expected
    if kind == "Standard":
        assert ac.find_matches_as_strings(WINTER, overlapping=True) == [
            "winter", "disc", "disco", "discontent", "content",
        ]
    else:
        msg = (
            "overlapping searches require a searcher with Standard "
            f"semantics, but this searcher has {kind} semantics"
        )
        with pytest.raises(ValueError, match=msg):
            ac.find_matches_as_indexes(WINTER, overlapping=True)
        with pytest.raises(ValueError, match=msg):
            bac.find_matches_as_indexes(WINTER.encode(), overlapping=True)


def test_quickstart_and_unicode_goldens():
    ac = port.AhoCorasick(["hello", "world", "fish"], device="cpu")
    assert ac.find_matches_as_indexes(
        "this is my first hello world. hello!"
    ) == [(0, 17, 22), (1, 23, 28), (0, 30, 35)]
    haystack = "hello, world ☃fishá l🤦l"
    patterns = ["d ☃f", "há", "l🤦l"]
    for store in (True, False):
        u = port.AhoCorasick(patterns, store_patterns=store, device="cpu")
        assert [
            haystack[s:e] for (_, s, e) in u.find_matches_as_indexes(haystack)
        ] == patterns
        assert u.find_matches_as_strings(haystack) == patterns
    assert port.BytesAhoCorasick(
        [b"hello", b"world"], device="cpu"
    ).find_matches_as_indexes(b"hello world") == [(0, 0, 5), (1, 6, 11)]
    assert port.AhoCorasick([], device="cpu").find_matches_as_indexes("x") == []
    assert port.MATCHKIND_LEFTMOST_LONGEST is port.MatchKind.LeftmostLongest


def test_error_texts():
    with pytest.raises(ValueError, match="You passed in an empty string as a pattern"):
        port.AhoCorasick(["xx", ""], device="cpu")
    with pytest.raises(ValueError, match="You passed in an empty pattern"):
        port.BytesAhoCorasick([b"xx", b""], device="cpu")
    with pytest.raises(
        TypeError, match="'int' object cannot be converted to 'PyString'"
    ):
        port.AhoCorasick(["x", 12], device="cpu")
    with pytest.raises(TypeError):
        port.BytesAhoCorasick([b"x", "y"], device="cpu")
    ac = port.AhoCorasick(["x"], device="cpu")
    with pytest.raises(
        TypeError,
        match="argument 'haystack': 'bytes' object cannot be converted "
        "to 'PyString'",
    ):
        ac.find_matches_as_indexes(b"xx")
    bac = port.BytesAhoCorasick([b"x"], device="cpu")
    with pytest.raises(TypeError) as e:
        bac.find_matches_as_indexes(np.zeros((2, 2), dtype=np.uint8))
    assert "Only one-dimensional sequences are supported" in str(e.value)
    with pytest.raises(TypeError) as e:
        bac.find_matches_as_indexes(np.zeros(16, dtype=np.uint8)[::2])
    assert "Must be a contiguous sequence of bytes" in str(e.value)
    assert not hasattr(bac, "find_matches_as_strings")
    for hay_type in (bytes, bytearray, memoryview):
        assert bac.find_matches_as_indexes(hay_type(b"axx")) == [
            (0, 1, 2), (0, 2, 3)
        ]


def test_device_must_be_asked_for_without_a_card(monkeypatch):
    """No silent CPU carry-on: without CUDA the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.AhoCorasick(["x"], **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.BytesAhoCorasick([b"x"], **kw)
    # the sharded scan with no process group: a world of one rank on the
    # CPU, with the device tier's tuples
    text = "x marks the spot, xx twice " * 40
    sharded = port.AhoCorasick(["x", "spot"], backend="sharded", device="cpu")
    device = port.AhoCorasick(["x", "spot"], backend="device", device="cpu")
    got = sharded.find_matches_as_indexes(text)
    assert got == device.find_matches_as_indexes(text) and len(got) == 160
    assert sharded.stats()["last_backend"] == "sharded"
    assert device.stats()["last_backend"] == "device"
    assert sharded._mesh.size == 1
    # the sparse engine scans on the device tier (K7) when asked for it
    sparse = port.BytesAhoCorasick(
        [b"x"], implementation=port.Implementation.NoncontiguousNFA,
        backend="device", device="cpu",
    )
    assert sparse.find_matches_as_indexes(b"xx") == [(0, 0, 1), (0, 1, 2)]
    assert sparse.stats()["last_backend"] == "device"
