"""Public API: ``AhoCorasick`` and ``BytesAhoCorasick``.

Drop-in equivalents of the reference's two matcher classes (upstream
src/lib.rs:29-33,360-363; typed surface upstream
pysrc/ahocorasick_rs/ahocorasick_rs.pyi:21-45), with the same constructor
signature, methods, defaults, error messages and observable match
semantics.  Device knobs are keyword-only extras: ``backend=`` and
``device=``.

Execution tiers (picked per call by haystack size, overridable with
``backend=``):

* ``python``  — sequential goto/fail walk; lowest latency for tiny inputs.
* ``numpy``   — vectorized halo'd lane scan on the host.
* ``native``  — the C++ lane scan on the host.
* ``device``  — lane scan with on-device match compaction on the
                matcher's torch device (``ops/scan_cuda.py``), or the
                prefiltered Teddy pipeline (``ops/scan_teddy.py``) when it
                pays; streams arbitrarily large haystacks.
* ``sharded`` — the same scans with the haystack split across ranks
                (``parallel/sharded.py``): the threads of a local mesh,
                one a device of this process, or the processes of a
                ``torch.distributed`` group; selected automatically when a
                ``mesh=`` is passed and the haystack reaches the device
                tier, or forced with ``backend="sharded"`` (without a
                mesh: ``make_mesh()``, the default process group or every
                local card; a matcher on the CPU takes the default process
                group, or a world of one rank).

The ``*_batch`` methods scan many documents in one device dispatch
(``device_batch`` through ``scan_cuda.scan_device_batch``, or
``teddy_batch`` through the Teddy pipeline over one staged buffer; with a
mesh ``sharded_batch`` and ``teddy_sharded_batch``), or in one native call
below the device tier (``native_batch``).

All tiers produce the identical complete occurrence set; match-kind
semantics are resolved from it by ``ops.resolve`` (one shared semantics
engine instead of the reference's per-kind automata).
"""

from __future__ import annotations

import sys
import time
from typing import TYPE_CHECKING, Iterable, Optional, Union

import numpy as np
import torch

if TYPE_CHECKING:
    from .models.native import DenseScanner
    from .ops.scan_cuda import DeviceTables
    from .ops.scan_teddy import TeddyScanner
    from .parallel.sharded import LocalMesh, MeshLike, ShardGroup

    if sys.version_info >= (3, 12):
        from collections.abc import Buffer
    else:
        from typing_extensions import Buffer

from .models.automaton import Automaton, build_automaton
from .models.engine import Implementation, MatchKind, select_engine
from .ops import resolve as _resolve
from .ops import scan_host
from .utils import trace
from .utils.buffers import as_byte_view, pattern_bytes
from .utils.codepoints import byte_to_codepoint_prefix

#: haystacks up to this many bytes use the sequential python walk.
PY_TIER_MAX = 2048
#: haystacks at least this many bytes go to the device tier.
DEVICE_TIER_MIN = 1 << 21

#: total pattern chars at or below which patterns are stored by default
#: (reference heuristic, upstream src/lib.rs:164-184).
STORE_PATTERNS_THRESHOLD = 4096

#: per-dispatch staged-byte budget for the device batch path.  The batch
#: kernels stage a zero-padded ``[B, T]`` buffer with ``T`` = longest
#: document (aligned); a length-skewed batch is split into groups so the
#: padding can never blow the staged buffer past this budget — and, a
#: fortiori, past the int32 position arithmetic of the compaction kernel.
BATCH_STAGE_BYTES = 128 << 20
#: grouping pads a document to at most this factor of its own length
#: (plus alignment) — bounds per-document staging waste under skew.
_BATCH_WASTE = 4
#: the waste rule only engages once a group stages at least this much:
#: below it, splitting to save padding costs more (an extra dispatch) than
#: the padding it saves.
_WASTE_MIN_BYTES = 1 << 20


def _plan_batch_groups(
    lens: list[int], n_dev: int = 1
) -> list[list[int]]:
    """Partition batch indexes into device-dispatch groups.

    Groups are built in descending length order, so each group's ``T`` is
    its first member's length: a group closes when adding a document would
    either exceed :data:`BATCH_STAGE_BYTES` of staged bytes, or — once the
    group already stages :data:`_WASTE_MIN_BYTES` — waste more than
    :data:`_BATCH_WASTE` x the document's own *achievable* staging (the
    power-of-two T it would get among its peers; a 3-byte document can
    never stage tighter than the 16-byte floor, so tiny documents group
    together instead of fragmenting, and sub-MB groups never split at
    all).  Both the row count and T are budget-accounted power-of-two
    aligned, matching what ``scan_device_batch`` actually stages; with
    ``n_dev`` > 1 the row count is also rounded up to a multiple of the
    rank count, as ``scan_sharded_batch`` pads it.  A uniform batch that
    fits the budget comes back as one group; singleton groups are the
    caller's signal to use the streaming single-document path.
    """
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    groups: list[list[int]] = []
    cur: list[int] = []
    curT = 16
    for i in order:
        ln = max(lens[i], 1)
        # the tightest (pow2, >=16) T this document could stage at
        tmin = 1 << (max(ln, 16) - 1).bit_length()
        # pow2 ceiling of the row count after adding this doc, floored
        # at scan_device_batch's MIN_LANES=8 row padding; sharded batches
        # further pad rows to a multiple of the rank count
        rows = 1 << max(len(cur), 7).bit_length()
        if n_dev > 1 and rows % n_dev:
            rows = -(-rows // n_dev) * n_dev
        staged = (len(cur) + 1) * curT
        if cur and (
            (tmin * _BATCH_WASTE < curT and staged >= _WASTE_MIN_BYTES)
            or rows * curT > BATCH_STAGE_BYTES
        ):
            groups.append(cur)
            cur = []
        if not cur:
            curT = tmin
        cur.append(i)
    if cur:
        groups.append(cur)
    return groups


def _overlapping_error(kind: MatchKind) -> str:
    """The reference's overlapping-with-leftmost ValueError text.

    The reference surfaces the aho-corasick crate's ``MatchError`` Display
    verbatim (upstream src/lib.rs:36-39,50-55): the v1.1.4
    ``UnsupportedOverlapping`` text, where ``{:?}`` of the two MatchKind
    values prints the bare variant names.
    """
    return (
        "overlapping searches require a searcher with Standard "
        f"semantics, but this searcher has {kind.name} semantics"
    )


def _resolve_device(
    device: Union[str, torch.device, None]
) -> torch.device:
    """The matcher's device: CUDA unless the caller names another.

    There is no silent CPU fallback: without a card the caller must ask
    for ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "device tier on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _MatcherBase:
    """Shared construction + scan/resolve pipeline for both matchers."""

    _automaton: Automaton
    _matchkind: MatchKind
    _implementation: Implementation
    _device: torch.device
    _backend: str
    _byte_patterns: list[bytes]
    _device_tables = None
    #: the ranks of the sharded scan (``parallel.sharded.as_group``)
    _mesh: Union["ShardGroup", "LocalMesh", None] = None
    _teddy = None
    _teddy_state = "auto"  # "auto" | "off" | "force"
    _counters = None  # scan observability, created on first scan
    _last_backend = None  # execution tier chosen by the latest scan
    _tier_bps: dict  # measured bytes/s EMA per tier group (host/device)
    _probe_ctr = 0  # device-eligible auto scans seen (for re-probing)

    #: bounded host-tier probe size for the router's first comparison
    #: sample — a few MB is enough for a stable bytes/s estimate and
    #: costs tens of ms even on the slowest host tier, instead of
    #: routing one entire device-eligible request (possibly multi-GB)
    #: to the host just to collect the comparison sample.
    _HOST_PROBE_BYTES = 4 << 20

    def _probe_host(self, hay: np.ndarray) -> None:
        """Fill the router's host-tier EMA from a bounded sample scan."""
        probe = hay[: self._HOST_PROBE_BYTES]
        backend = "native" if self._native_ok() else "numpy"
        t0 = time.perf_counter()
        self._host_scan(probe, backend)
        dt = time.perf_counter() - t0
        if dt > 0:
            self._tier_bps["host"] = len(probe) / dt

    def _auto_device_ok(
        self, n: int, probe: Optional[np.ndarray] = None
    ) -> bool:
        """Should an auto-routed scan of ``n`` bytes use the device tier?

        Two gates.  Amortization: the device-table upload must be paid
        for (:meth:`_device_amortized`).  Measured throughput: once both
        tier groups have measurements, route to the faster one — with a
        1.2x hysteresis band and a re-probe of the losing device tier
        every 8th eligible scan so a transient slow measurement (cold
        kernel build, busy card) cannot lock the router out of the
        device permanently.  A missing host sample is collected by a
        *bounded* probe scan over a slice of ``probe``
        (:meth:`_probe_host`) — never by routing the full request to the
        host tier.  The probe counter advances once per scan (in
        ``_find``), never here: the prefiltered gate and the dense gate of
        one scan must see the same decision.
        """
        if not self._device_amortized(n):
            return False
        host = self._tier_bps.get("host")
        dev = self._tier_bps.get("device")
        if dev is None:
            return True  # explore the device tier first
        if host is None:
            if probe is not None and len(probe):
                self._probe_host(probe)
                host = self._tier_bps.get("host")
            if host is None:
                return False  # no probe material: sample on this scan
        if dev * 1.2 < host and self._probe_ctr % 8 != 0:
            return False
        return True

    #: execution tiers grouped for the measured-throughput router
    _HOST_TIERS = frozenset(
        ("python", "numpy", "native", "native_batch", "native_resolve")
    )

    def _note_scan(self, nbytes: int, seconds: float) -> None:
        """Accumulate scan-throughput counters."""
        c = self._counters
        if c is None:
            c = self._counters = {
                "scan_calls": 0,
                "scan_bytes": 0,
                "scan_seconds": 0.0,
            }
        c["scan_calls"] += 1
        c["scan_bytes"] += nbytes
        c["scan_seconds"] += seconds
        # per-tier-group throughput EMA feeding the adaptive auto router;
        # only device-tier-sized scans are comparable signals
        if seconds > 0 and nbytes >= DEVICE_TIER_MIN:
            group = (
                "host" if self._last_backend in self._HOST_TIERS
                else "device"
            )
            bps = nbytes / seconds
            prev = self._tier_bps.get(group)
            self._tier_bps[group] = (
                bps if prev is None else 0.5 * prev + 0.5 * bps
            )

    def _build(
        self,
        byte_patterns: list[bytes],
        matchkind: MatchKind,
        implementation: Optional[Implementation],
        backend: str,
        device: Union[str, torch.device, None],
        mesh: "MeshLike",
        automaton: Optional[Automaton] = None,
    ) -> None:
        """Set the matcher up; ``automaton`` is one already compiled from
        ``byte_patterns`` (``load_matcher``), else it is built here."""
        if not isinstance(matchkind, MatchKind):
            raise TypeError(
                f"matchkind must be a MatchKind, not {matchkind!r}"
            )
        if implementation is not None and not isinstance(
            implementation, Implementation
        ):
            raise TypeError(
                "implementation must be an Implementation or None, "
                f"not {implementation!r}"
            )
        self._tier_bps = {}
        self._backend = backend
        self._device = _resolve_device(device)
        if mesh is not None:
            from .parallel import sharded as _sharded

            self._mesh = _sharded.as_group(mesh)
        self._matchkind = matchkind
        self._byte_patterns = byte_patterns
        self._automaton = (
            build_automaton(byte_patterns) if automaton is None else automaton
        )
        self._implementation = (
            implementation
            if implementation is not None
            else select_engine(self._automaton, self._device)
        )
        # Materialise the engine's tables eagerly, like the reference's
        # builder does, so construction cost lands in __init__.
        am = self._automaton
        if self._implementation is Implementation.DFA:
            am.delta
        elif self._implementation is Implementation.ContiguousNFA:
            am.delta_classed
        else:
            am.sparse

    # -- scanning ------------------------------------------------------
    def _scan(self, hay: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return matched (positions, states) for a uint8 haystack array."""
        n = len(hay)
        am = self._automaton
        backend = self._backend
        if backend == "auto":
            if n < DEVICE_TIER_MIN or not self._auto_device_ok(n, hay):
                backend = "native" if self._native_ok() else (
                    "python" if n <= PY_TIER_MAX else "numpy"
                )
            elif self._mesh is not None:
                backend = "sharded"
            else:
                backend = "device"
        if backend == "sharded":
            if self._implementation is Implementation.NoncontiguousNFA:
                # the sharded scan has no sparse body: the host tier
                backend = "numpy" if not self._native_ok() else "native"
            else:
                from .parallel import sharded as _sharded

                self._last_backend = "sharded"
                return _sharded.scan_sharded(
                    am, hay, self._get_device_tables(), self._shard_group()
                )
        if (
            backend == "device"
            and self._backend == "auto"
            and self._implementation is Implementation.NoncontiguousNFA
        ):
            # Auto-routed sparse scans stay on the host; only an explicit
            # backend="device" asks for the sparse engine on the device.
            backend = "numpy" if not self._native_ok() else "native"
        self._last_backend = backend
        if backend in ("native", "python", "numpy"):
            return self._host_scan(hay, backend)
        # device tier
        from .ops import scan_cuda

        return scan_cuda.scan_device(am, hay, self._get_device_tables())

    def _host_scan(
        self, hay: np.ndarray, backend: str
    ) -> tuple[np.ndarray, np.ndarray]:
        """Dispatch one host-tier scan (no routing, no tier bookkeeping)."""
        am = self._automaton
        if backend == "native":
            return self._get_native_scanner().scan(hay)
        if backend == "python":
            return scan_host.scan_python(am, hay.tobytes())
        impl = self._implementation
        if impl is Implementation.DFA:
            return scan_host.scan_numpy_lanes(am, hay)
        if impl is Implementation.ContiguousNFA:
            return scan_host.scan_numpy_lanes(
                am,
                hay,
                table=am.delta_classed,
                classes=am.byte_classes,
            )
        return scan_host.scan_numpy_sparse(am, hay)

    _native_ok_cache: Optional[bool] = None
    _native_scanner = None

    def _native_ok(self) -> bool:
        """Native host scan usable for this matcher's engine?

        Library availability is cached; the sparse engine's table
        condition is re-checked every time — a classed table materialized
        after the first scan must make the native walk eligible.
        """
        ok = self._native_ok_cache
        if ok is None:
            from .models import native as _native

            ok = self._native_ok_cache = _native.available()
        if not ok:
            return False
        if self._implementation is Implementation.NoncontiguousNFA:
            # honor the sparse engine's low-memory contract: only use the
            # native walk if a dense/classed table already exists
            return self._automaton._delta_classed is not None
        return True

    def _get_native_scanner(self) -> "DenseScanner":
        """Per-matcher native scanner (cached table pointers + buffers)."""
        if self._native_scanner is None:
            from .models import native as _native

            am = self._automaton
            if self._implementation is not Implementation.DFA and (
                self._implementation is Implementation.ContiguousNFA
                or am._delta_classed is not None
            ):
                self._native_scanner = _native.DenseScanner(
                    am.delta_classed, am.match_count,
                    classes=am.byte_classes,
                    halo=am.max_len - 1,
                )
            else:
                self._native_scanner = _native.DenseScanner(
                    am.delta, am.match_count, halo=am.max_len - 1
                )
        return self._native_scanner

    # -- prefiltered (Teddy) path --------------------------------------
    #: persisted/tuned prefilter config {m, words, passes}, or None
    _pf_config = None

    def _get_teddy(self) -> Optional[TeddyScanner]:
        """Build (once) and return the TeddyScanner, or None if unfit."""
        if self._implementation is Implementation.NoncontiguousNFA:
            return None
        if self._teddy is None:
            from .models.prefilter import (
                build_prefilter,
                build_prefilter_config,
            )
            from .ops.scan_teddy import TeddyScanner

            if self._pf_config is not None:
                pf = build_prefilter_config(
                    self._byte_patterns, **self._pf_config
                )
            else:
                pf = build_prefilter(self._byte_patterns)
            if pf is None or (
                self._teddy_state == "auto" and pf.est_fire_rate > 0.05
            ):
                self._teddy_state = "off"
                return None
            self._teddy = TeddyScanner(
                self._automaton, pf, self._get_device_tables()
            )
        return self._teddy

    #: prefiltered pipelines address positions as int32 and do not segment
    #: past SEG_BYTES windows of one staged layout (unlike scan_device);
    #: larger inputs use the dense/segmented tier
    _TEDDY_MAX_BYTES = (1 << 31) - (1 << 24)

    def _teddy_wanted(
        self, n: int, probe: Optional[np.ndarray] = None
    ) -> bool:
        """Should the prefiltered device pipeline serve ``n`` bytes?"""
        if self._teddy_state == "off" or n > self._TEDDY_MAX_BYTES:
            return False
        if self._teddy_state == "force":
            return True
        return (
            self._backend in ("auto", "device", "sharded")
            and n >= DEVICE_TIER_MIN
            and (
                self._backend != "auto"
                or self._auto_device_ok(n, probe)
            )
            and self._device.type == "cuda"
        )

    def _try_teddy(
        self, hay: np.ndarray
    ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Return the complete occurrence set via the prefiltered scan, or
        None when the prefilter is off/unprofitable for this matcher.
        Sets ``last_backend``; runs sharded when the matcher has a mesh."""
        if not self._teddy_wanted(len(hay), hay):
            return None
        if self._get_teddy() is None:
            return None
        if self._mesh is not None or self._backend == "sharded":
            from .parallel import sharded as _sharded

            occ = _sharded.scan_sharded_teddy(
                self._automaton, self._teddy, hay, self._shard_group()
            )
            self._last_backend = "teddy_sharded"
        else:
            occ = self._teddy.occurrences_streamed(hay)
            self._last_backend = "teddy"
        if occ is None:
            # observed fire rate too high on this corpus — stop trying
            self._teddy_state = "off"
        return occ

    def _device_amortized(self, n: int) -> bool:
        """Is the device-table upload already paid for, or worth paying?

        Huge automata cost far more to stage into device memory than a
        host scan of a modest haystack costs outright; auto routing
        therefore stays on the host tiers until this matcher's cumulative
        scanned bytes (the ``stats()`` counter) plus the current request
        reach the table size, at which point the upload amortizes.  Forced
        backends (``backend="device"``) bypass this entirely, and once the
        tables are resident the device tier is always preferred.
        """
        if self._device_tables is not None:
            return True
        am = self._automaton
        if self._implementation is Implementation.DFA:
            table_bytes = am.num_states * 257 * 4
        elif self._implementation is Implementation.ContiguousNFA:
            table_bytes = am.num_states * am.num_classes * 4
        else:
            table_bytes = am.edge_keys.nbytes + am.edge_targets.nbytes
        seen = (self._counters or {}).get("scan_bytes", 0)
        return seen + n >= table_bytes

    def _get_device_tables(self) -> "DeviceTables":
        from .ops import scan_cuda

        if self._device_tables is None:
            engine = {
                Implementation.DFA: "dfa",
                Implementation.ContiguousNFA: "classed",
                Implementation.NoncontiguousNFA: "sparse",
            }[self._implementation]
            self._device_tables = scan_cuda.DeviceTables(
                self._automaton, engine, self._device
            )
        return self._device_tables

    def _shard_group(self) -> Union["ShardGroup", "LocalMesh"]:
        """The matcher's ranks: its ``mesh=``, else (made once)
        ``make_mesh()``, as the JAX package's API falls back to its
        ``make_mesh()``: the default process group, or every local card.
        A matcher on the CPU keeps the default process group or a world of
        one rank."""
        if self._mesh is None:
            from .parallel import sharded as _sharded

            self._mesh = (
                _sharded.make_mesh() if self._device.type == "cuda"
                else _sharded.as_group(None)
            )
        return self._mesh

    # -- batched many-small-haystack path ------------------------------
    def _mesh_wanted(self) -> bool:
        """Route device-tier batches through the ranks?  As for one
        document: an explicit ``backend="sharded"`` always shards; ``auto``
        shards when the matcher was given a mesh; ``backend="device"``
        stays on one device."""
        return self._backend == "sharded" or (
            self._backend == "auto" and self._mesh is not None
        )

    def _batch_occurrences(
        self, docs: list[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Flat multi-document occurrence set from one device dispatch.

        The documents share a zero-padded ``[B, T]`` layout (one row per
        document).  ``T`` is tight (COARSE-aligned) on the prefiltered
        path and a power of two on the dense path.  Rows never share a
        COARSE group since ``T % COARSE == 0``, and matches are filtered
        to their owning document's byte range, so cross-document false
        matches (spanning padding into the next row) are impossible.
        Returns ``(pids, starts, ends, offsets)`` in the flat coordinate
        space ``resolve_batch`` consumes (document ``i`` at
        ``[i*T, i*T+len)``).
        """
        from .ops import scan_cuda
        from .ops.scan_teddy import COARSE

        am = self._automaton
        B = len(docs)
        longest = max((len(d) for d in docs), default=1)
        total = sum(len(d) for d in docs)
        occ = None
        T = 0
        # The fire kernel only needs COARSE alignment, so a tight T keeps
        # the staged buffer — and the host-to-device copy — near sum(len)
        # instead of a power-of-two blowup.  The size gate is on the
        # STAGED bytes B*T, not sum(len): under length skew the padded
        # buffer is what the kernels and the int32 positions see.
        T_teddy = -(-max(longest, 1) // COARSE) * COARSE
        if (
            B * T_teddy <= self._TEDDY_MAX_BYTES
            and self._teddy_wanted(total, max(docs, key=len, default=None))
            and self._get_teddy() is not None
        ):
            T = T_teddy
            with trace.span("pad"):
                buf = np.zeros(B * T, dtype=np.uint8)
                lens = np.zeros(max(B, 1), dtype=np.int64)
                for i, d in enumerate(docs):
                    buf[i * T : i * T + len(d)] = d
                    lens[i] = len(d)
            trace.count("pad_bytes", buf.nbytes + lens.nbytes)
            # the staged flat buffer IS a haystack: padding can only
            # over-fire, never match (matches are filtered below); with a
            # mesh it shards across the ranks like any other haystack
            if self._mesh_wanted():
                from .parallel import sharded as _sharded

                occ = _sharded.scan_sharded_teddy(
                    am, self._teddy, buf, self._shard_group()
                )
                batch_backend = "teddy_sharded_batch"
            else:
                occ = self._teddy.occurrences_streamed(buf)
                batch_backend = "teddy_batch"
            if occ is None:
                self._teddy_state = "off"
        if occ is not None:
            self._last_backend = batch_backend
            pids, starts, ends = occ
            lane = starts // T
            keep = (lane < B) & (ends <= lane * T + lens[lane])
            pids, starts, ends = pids[keep], starts[keep], ends[keep]
        else:
            # dense batch path (K5): T is a power of two there; with a
            # mesh the document rows shard across the ranks (no halo:
            # every document starts at the root)
            if self._mesh_wanted():
                from .parallel import sharded as _sharded

                pos, st, T = _sharded.scan_sharded_batch(
                    am, docs, self._get_device_tables(), self._shard_group()
                )
                self._last_backend = "sharded_batch"
            else:
                pos, st, T = scan_cuda.scan_device_batch(
                    am, docs, self._get_device_tables()
                )
                self._last_backend = "device_batch"
            self._check_batch_density(st)
            with trace.span("expand"):
                pids, starts, ends = _resolve.expand_occurrences(
                    am, pos, st
                )
        offsets = np.arange(B + 1, dtype=np.int64) * T
        return pids, starts, ends, offsets

    def _check_batch_density(self, st: np.ndarray) -> None:
        """Raise :class:`MatchDenseError` before a batch occurrence
        expansion that would dwarf the scan (same guard as the
        single-document path's ``occ_total`` check; ``_find_batch``
        re-routes each document through the guarded single-doc path)."""
        occ_total = int(
            self._automaton.match_count[st.astype(np.int64)]
            .astype(np.int64)
            .sum()
        )
        if occ_total > 4 * self._STREAM_OCC:
            raise _resolve.MatchDenseError(
                f"{occ_total} occurrences in a batch expansion"
            )

    def _native_batch_occurrences(
        self, docs: list[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Flat occurrence set from ONE native foreign call over the
        concatenated documents."""
        from .models import native as _native

        am = self._automaton
        offsets = np.zeros(len(docs) + 1, dtype=np.int64)
        np.cumsum([len(d) for d in docs], out=offsets[1:])
        buf = np.concatenate(docs) if docs else np.zeros(0, np.uint8)
        if self._implementation is not Implementation.DFA and (
            self._implementation is Implementation.ContiguousNFA
            or am._delta_classed is not None
        ):
            pos, st = _native.scan_dense_native_batch(
                am.delta_classed, am.match_count, buf, offsets,
                classes=am.byte_classes,
            )
        else:
            pos, st = _native.scan_dense_native_batch(
                am.delta, am.match_count, buf, offsets
            )
        self._last_backend = "native_batch"
        self._check_batch_density(st)
        with trace.span("expand"):
            pids, starts, ends = _resolve.expand_occurrences(am, pos, st)
        return pids, starts, ends, offsets

    def _find_batch(
        self, docs: list[np.ndarray], overlapping: bool
    ) -> list[list[tuple[int, int, int]]]:
        if overlapping and self._matchkind is not MatchKind.Standard:
            raise ValueError(_overlapping_error(self._matchkind))
        backend = self._backend
        total = sum(len(d) for d in docs)
        if backend == "auto" and total >= DEVICE_TIER_MIN:
            self._probe_ctr += 1  # one router tick per batch
        if backend == "auto":
            use_device = (
                total >= DEVICE_TIER_MIN
                and len(docs) > 1
                and self._auto_device_ok(
                    total, max(docs, key=len, default=None)
                )
            )
        else:
            use_device = backend in ("device", "sharded")
        use_device = use_device and (
            self._implementation is not Implementation.NoncontiguousNFA
        )
        use_native = (
            not use_device
            and backend in ("auto", "native")
            and len(docs) > 1
            and self._native_ok()
        )
        if not (use_device or use_native):
            return [self._find(d, overlapping) for d in docs]
        t0 = time.perf_counter()
        try:
            return self._find_batch_grouped(
                docs, overlapping, use_device, t0, total
            )
        except _resolve.MatchDenseError:
            # batch-level density bailout (device compaction overflow or
            # a would-be-huge occurrence expansion): each document
            # re-routes through the guarded single-document path, which
            # owns the match-dense regime (fused/streamed resolvers)
            return [self._find(d, overlapping) for d in docs]

    def _find_batch_grouped(
        self,
        docs: list[np.ndarray],
        overlapping: bool,
        use_device: bool,
        t0: float,
        total: int,
    ) -> list[list[tuple[int, int, int]]]:
        kind = self._matchkind.value
        if use_device:
            n_dev = self._shard_group().size if self._mesh_wanted() else 1
            groups = _plan_batch_groups([len(d) for d in docs], n_dev=n_dev)
            if len(groups) > 1 or (groups and len(groups[0]) == 1):
                # also taken for a single singleton group: ONE document
                # must stream (the batch kernel would stage MIN_LANES x
                # pow2(T) — for a 300MB doc that is a 4GB buffer and an
                # int32 overflow in compaction).  Length-skewed batch:
                # per-group dispatches keep the staged [B, T] buffer
                # within BATCH_STAGE_BYTES; per-document results scatter
                # back to the caller's order.
                out_sk: list[list[tuple[int, int, int]]] = [
                    [] for _ in docs
                ]
                counted = total
                excluded = 0.0
                batch_tier = None
                for idxs in groups:
                    if len(idxs) == 1:
                        # a lone document streams through the single-doc
                        # path, which counts its own bytes and seconds;
                        # both are left out of this batch's record
                        counted -= len(docs[idxs[0]])
                        t_f = time.perf_counter()
                        out_sk[idxs[0]] = self._find(
                            docs[idxs[0]], overlapping
                        )
                        excluded += time.perf_counter() - t_f
                        continue
                    sub = [docs[i] for i in idxs]
                    with trace.span("scan_batch"):
                        pids, starts, ends, offsets = (
                            self._batch_occurrences(sub)
                        )
                    with trace.span("resolve"):
                        res = _resolve.resolve_batch(
                            pids, starts, ends, offsets,
                            kind=kind, overlapping=overlapping,
                        )
                    for i, r in zip(idxs, res):
                        out_sk[i] = r
                    batch_tier = self._last_backend
                if batch_tier is not None:
                    # a trailing streamed singleton must not classify the
                    # batched bytes under its (host) tier in the router EMA
                    self._last_backend = batch_tier
                self._note_scan(
                    counted, time.perf_counter() - t0 - excluded
                )
                return out_sk
        with trace.span("scan_batch"):
            if use_device:
                pids, starts, ends, offsets = self._batch_occurrences(docs)
            else:
                pids, starts, ends, offsets = (
                    self._native_batch_occurrences(docs)
                )
        with trace.span("resolve"):
            out = _resolve.resolve_batch(
                pids, starts, ends, offsets,
                kind=kind, overlapping=overlapping,
            )
        self._note_scan(total, time.perf_counter() - t0)
        return out

    #: host-tier scans at or past this size stream segment-by-segment
    #: (bounded peak memory even on match-dense adversarial corpora)
    _STREAM_MIN = 64 << 20
    #: haystack bytes per streamed scan segment
    _STREAM_SEG = 16 << 20
    #: occurrence budget per expand+resolve chunk within a segment
    _STREAM_OCC = 8 << 20

    def _stream_backend(self, hay: np.ndarray) -> Optional[str]:
        """Host-tier backend name when this scan should stream, else None.

        Mirrors ``_scan``'s routing for the host-bound cases: explicit
        host backends, auto scans the throughput router keeps on the
        host, and the sparse engine's auto and sharded host fallbacks.
        The device and sharded tiers return None — they segment on the
        device and their compacted outputs are match-sized, not
        occurrence-sized.
        """
        if len(hay) < self._STREAM_MIN:
            return None
        b = self._backend
        host = "native" if self._native_ok() else "numpy"
        if b in ("python", "numpy", "native"):
            return b
        sparse = self._implementation is Implementation.NoncontiguousNFA
        if b == "auto":
            if not self._auto_device_ok(len(hay), hay):
                return host
            return host if sparse else None
        if b == "sharded" and sparse:
            return host  # _scan's sharded/sparse fallback
        return None

    def _find_streaming(
        self, hay: np.ndarray, backend: str, overlapping: bool
    ) -> list[tuple[int, int, int]]:
        """Segment-streamed host scan + resolve with bounded memory.

        An AC state depends on at most the last ``max_len - 1`` bytes,
        so each segment is scanned from the root with that halo of left
        context and only positions inside the segment are kept — the
        same exactness argument as the lane scans
        (``models/automaton.py``).  Occurrence expansion is chunked by
        occurrence COUNT (not positions), so nested pattern sets over
        repetitive corpora — ``["a","aa",...,"a"*64]`` over gigabytes of
        ``"a"`` — peak at O(kept + _STREAM_OCC) instead of
        O(n * nesting) (the reference's walk is O(n) there, upstream
        src/lib.rs:59).
        """
        am = self._automaton
        halo = am.max_len - 1
        res = _resolve.StreamResolver(
            self._matchkind.value, overlapping, am.max_len
        )
        n = len(hay)
        self._last_backend = backend
        if backend == "native" and not overlapping:
            # Cheap density probe on a 1MB slice: match-dense corpora
            # (>1/16 of positions matching) route to the fused native
            # resolver, which walks the haystack ONCE carrying the
            # greedy restart cursor — O(output + max_len) memory and
            # O(n) work, the reference's own complexity class.
            probe_n = min(n, 1 << 20)
            pos0, _ = self._host_scan(hay[:probe_n], backend)
            if len(pos0) * 16 > probe_n:
                return self._native_resolve_scan(hay)
        for s0 in range(0, n, self._STREAM_SEG):
            s1 = min(n, s0 + self._STREAM_SEG)
            lo = max(0, s0 - halo)
            pos, st = self._host_scan(hay[lo:s1], backend)
            if lo:
                k = int(np.searchsorted(pos, s0 - lo))
                pos, st = pos[k:] + lo, st[k:]
            if not len(pos):
                continue
            self._feed_occurrences(res, pos, st)
        return res.result()

    def _feed_occurrences(
        self,
        res: "_resolve.StreamResolver",
        pos: np.ndarray,
        st: np.ndarray,
    ) -> None:
        """Expand (positions, states) into ``res`` in occurrence-count-
        bounded chunks (peak memory O(_STREAM_OCC), not O(total))."""
        am = self._automaton
        cnt = am.match_count[st.astype(np.int64)].astype(np.int64)
        cs = np.cumsum(cnt)
        i0 = 0
        while i0 < len(pos):
            base = int(cs[i0 - 1]) if i0 else 0
            i1 = int(
                np.searchsorted(cs, base + self._STREAM_OCC, side="right")
            )
            i1 = max(i1, i0 + 1)
            pids, starts, ends = _resolve.expand_occurrences(
                am, pos[i0:i1], st[i0:i1]
            )
            res.feed(pids, starts, ends, int(pos[i1 - 1]) + 1)
            i0 = i1

    def _dense_host_fallback(
        self, hay: np.ndarray, overlapping: bool
    ) -> list[tuple[int, int, int]]:
        """Re-route after a device-tier :class:`MatchDenseError` bailout."""
        host = "native" if self._native_ok() else "numpy"
        if host == "native" and not overlapping:
            return self._native_resolve_scan(hay)
        return self._find_streaming(hay, host, overlapping)

    #: lazily-built leftmost pruned table (delta_lm, bestlen, bestpid);
    #: False when the automaton is too large for the extra layout
    _leftmost_tables = None
    #: extra-table budget for the leftmost pruned layout
    _LEFTMOST_TABLE_MAX = 256 << 20

    def _get_leftmost_tables(self) -> Optional[tuple]:
        """The leftmost-priority pruned automaton (built once).

        A dense ``[S+1, 257]`` table whose failure transitions are pruned
        so the walk DIES when the recorded leftmost candidate is final —
        making leftmost scans O(n + matches * max_len) instead of
        O(occurrences).  Construction re-runs the native trie build from
        the raw patterns, paid only when a leftmost matcher actually hits
        the match-dense path.
        """
        if self._leftmost_tables is None:
            from .models import native as _native

            am = self._automaton
            if (am.num_states + 1) * 257 * 4 > self._LEFTMOST_TABLE_MAX:
                self._leftmost_tables = False  # ring resolver instead
            else:
                delta_lm = _native.build_leftmost_table(
                    self._byte_patterns
                )
                bl, bp = _native.leftmost_best(am)
                self._leftmost_tables = (delta_lm, bl, bp)
        return self._leftmost_tables or None

    def _native_resolve_scan(
        self, hay: np.ndarray
    ) -> list[tuple[int, int, int]]:
        """Fused native scan+resolve over the whole haystack."""
        from .models import native as _native

        am = self._automaton
        kind = self._matchkind.value
        if kind in ("leftmost_first", "leftmost_longest"):
            lt = self._get_leftmost_tables()
            if lt is not None:
                delta_lm, bl, bp = lt
                p, s, e = _native.resolve_leftmost_native(
                    delta_lm, bl, bp, hay, kind
                )
                self._last_backend = "native_resolve"
                return list(zip(p.tolist(), s.tolist(), e.tolist()))
        if self._implementation is not Implementation.DFA and (
            self._implementation is Implementation.ContiguousNFA
            or am._delta_classed is not None
        ):
            p, s, e = _native.resolve_scan_native(
                am,
                hay,
                self._matchkind.value,
                classes=am.byte_classes,
                delta=am.delta_classed,
            )
        else:
            p, s, e = _native.resolve_scan_native(
                am, hay, self._matchkind.value
            )
        self._last_backend = "native_resolve"
        return list(zip(p.tolist(), s.tolist(), e.tolist()))

    def _find(
        self, hay: np.ndarray, overlapping: bool
    ) -> list[tuple[int, int, int]]:
        if overlapping and self._matchkind is not MatchKind.Standard:
            raise ValueError(_overlapping_error(self._matchkind))
        if self._backend == "auto" and len(hay) >= DEVICE_TIER_MIN:
            self._probe_ctr += 1  # one router tick per scan
        t0 = time.perf_counter()
        with trace.span("scan"):
            occ = self._try_teddy(hay)  # sets last_backend on success
            if occ is None:
                stream = self._stream_backend(hay)
                if stream is not None:
                    out = self._find_streaming(hay, stream, overlapping)
                    self._note_scan(len(hay), time.perf_counter() - t0)
                    return out
                try:
                    positions, states = self._scan(hay)
                except _resolve.MatchDenseError:
                    # device-tier density bailout: the host resolvers own
                    # this regime (O(n) fused walk / streamed resolve).
                    # Record a floor device throughput so the next auto
                    # scan of this matcher goes host-first instead of
                    # re-staging the corpus to the device (the EMA
                    # self-heals through the periodic re-probe).
                    if self._backend == "auto":
                        self._tier_bps["device"] = min(
                            self._tier_bps.get("device", 1.0), 1.0
                        )
                    out = self._dense_host_fallback(hay, overlapping)
                    self._note_scan(len(hay), time.perf_counter() - t0)
                    return out
                if len(positions) <= _resolve._SMALL_THRESHOLD:
                    # fused expand+resolve, no numpy dispatch overhead —
                    # the common per-document case (a handful of matches)
                    out = _resolve.resolve_from_scan_small(
                        self._automaton,
                        positions,
                        states,
                        self._matchkind.value,
                        overlapping,
                    )
                    self._note_scan(len(hay), time.perf_counter() - t0)
                    return out
                occ_total = int(
                    self._automaton.match_count[states.astype(np.int64)]
                    .astype(np.int64)
                    .sum()
                )
                if occ_total > 4 * self._STREAM_OCC:
                    # big occurrence set from a non-streamed scan: the
                    # fused native resolver re-walks the haystack in
                    # O(n) instead of expanding O(occ_total); without it
                    # (or for overlapping output) chunk the expansion
                    if not overlapping and self._native_ok():
                        out = self._native_resolve_scan(hay)
                    else:
                        res = _resolve.StreamResolver(
                            self._matchkind.value,
                            overlapping,
                            self._automaton.max_len,
                        )
                        self._feed_occurrences(res, positions, states)
                        out = res.result()
                    self._note_scan(len(hay), time.perf_counter() - t0)
                    return out
                with trace.span("expand"):
                    occ = _resolve.expand_occurrences(
                        self._automaton, positions, states
                    )
        pids, starts, ends = occ
        with trace.span("resolve"):
            out = _resolve.resolve(
                pids,
                starts,
                ends,
                kind=self._matchkind.value,
                overlapping=overlapping,
            )
        self._note_scan(len(hay), time.perf_counter() - t0)
        return out

    # -- measured-time prefilter tuning --------------------------------
    def tune(self, sample: "str | Buffer") -> dict:
        """Pick the fastest prefilter configuration by measured wall time.

        Device extra: times each candidate (plane-count / pass-count
        variants) end-to-end on ``sample`` — a representative haystack of
        the caller's real workload — and keeps the winner for subsequent
        scans.  Estimate models mispredict observed fire rates ~3x, so
        measurement is the only reliable objective.  Each candidate runs
        the fire kernel (K1) and the verify walk (K4) at its own prefilter
        shape.  Returns a report: per-candidate seconds and the chosen
        config.
        """
        from .models.prefilter import build_prefilter_candidates
        from .ops.scan_teddy import TeddyScanner

        if isinstance(sample, str):
            hay = np.frombuffer(sample.encode("utf-8"), dtype=np.uint8)
        else:
            hay = as_byte_view(sample)
        report: dict = {"candidates": [], "chosen": None}
        if self._implementation is Implementation.NoncontiguousNFA:
            report["chosen"] = "none (sparse engine has no prefilter)"
            return report
        candidates = build_prefilter_candidates(self._byte_patterns)
        tables = self._get_device_tables()
        best = None
        for pf in candidates:
            scanner = TeddyScanner(self._automaton, pf, tables)
            hay2d = scanner.stage(hay)
            if scanner.occurrences(hay, hay2d=hay2d) is None:
                seconds = float("inf")  # pathological fire rate
            else:
                # best-of-3, so that one slow outlier cannot pick a slow
                # config that then persists through save_matcher.  Each
                # call ends in the .cpu() fetch of its results, which waits
                # for the device, so the time includes the kernels.
                seconds = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    scanner.occurrences(hay, hay2d=hay2d)
                    seconds = min(seconds, time.perf_counter() - t0)
            entry = {
                "m": pf.m,
                "words": pf.words,
                "passes": pf.passes,
                "est_fire_rate": pf.est_fire_rate,
                "seconds": seconds,
            }
            report["candidates"].append(entry)
            if best is None or seconds < best[0]:
                best = (seconds, pf, scanner)
        if best is not None and best[0] != float("inf"):
            _, pf, scanner = best
            self._teddy = scanner
            self._teddy_state = (
                "force" if self._teddy_state == "force" else "auto"
            )
            report["chosen"] = {
                "m": pf.m,
                "words": pf.words,
                "passes": pf.passes,
            }
            # survives save_matcher/load_matcher (rebuilt deterministically)
            self._pf_config = dict(report["chosen"])
        else:
            report["chosen"] = "none (all candidates fell back)"
        return report

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        """Compile-time + runtime statistics.

        Compile-time: states, table bytes, engine chosen.  Runtime
        (cumulative over this matcher's scans): ``scan_calls``,
        ``scan_bytes``, ``scan_seconds``, derived ``scan_bytes_per_second``
        and the execution tier the latest scan used (``last_backend``).
        """
        s = self._automaton.stats()
        s["implementation"] = self._implementation.name
        s["matchkind"] = self._matchkind.name
        c = self._counters or {
            "scan_calls": 0,
            "scan_bytes": 0,
            "scan_seconds": 0.0,
        }
        s.update(c)
        s["scan_bytes_per_second"] = (
            c["scan_bytes"] / c["scan_seconds"]
            if c["scan_seconds"] > 0
            else 0.0
        )
        s["last_backend"] = self._last_backend
        s["tier_bytes_per_second"] = dict(self._tier_bps)
        s["device"] = str(self._device)
        return s


def _encode(haystack: str) -> tuple[bytes, np.ndarray]:
    """A ``str`` haystack's UTF-8 bytes and their uint8 view, counted as
    scanned and encoded bytes (the ``encode`` span)."""
    if not isinstance(haystack, str):
        # PyO3's argument-extraction TypeError for `haystack: &str`
        # (upstream src/lib.rs:230,254)
        raise TypeError(
            f"argument 'haystack': '{type(haystack).__name__}' object "
            "cannot be converted to 'PyString'"
        )
    with trace.span("encode"):
        data = haystack.encode("utf-8")
        hay = np.frombuffer(data, dtype=np.uint8)
    trace.count("scanned_bytes", len(data))
    trace.count("encode_bytes", len(data))
    return data, hay


def _encode_batch(
    haystacks: Iterable[str],
) -> tuple[list[bytes], list[np.ndarray], list[bool]]:
    """:func:`_encode` over a batch, one span and one count for all:
    each document's bytes, their views, and whether it is pure ASCII."""
    datas = []
    ascii_doc = []
    with trace.span("encode"):
        for h in haystacks:
            if not isinstance(h, str):
                raise TypeError(
                    f"argument 'haystack': '{type(h).__name__}' object "
                    "cannot be converted to 'PyString'"
                )
            d = h.encode("utf-8")
            datas.append(d)
            # byte length == str length iff pure ASCII — no second decode
            # of matched documents later
            ascii_doc.append(len(d) == len(h))
        hays = [np.frombuffer(d, dtype=np.uint8) for d in datas]
    total = sum(len(d) for d in datas)
    trace.count("scanned_bytes", total)
    trace.count("encode_bytes", total)
    return datas, hays, ascii_doc


class AhoCorasick(_MatcherBase):
    """Multi-pattern string matcher over ``str`` haystacks.

    Matches the reference class (upstream src/lib.rs:134-272): match
    indexes are in *code points*, not bytes (upstream src/lib.rs:74-75).

    Extras (keyword-only): ``backend=`` forces an execution tier;
    ``device=`` names the torch device of the device tier (default
    ``"cuda"``; without a card the caller must pass ``"cpu"``); ``mesh=``
    (``parallel.sharded.make_mesh()``'s local mesh, or a 1-D
    ``torch.distributed`` ``DeviceMesh`` or a ``ProcessGroup``) routes
    device-tier scans through the sharded scan across its ranks.
    """

    def __init__(
        self,
        patterns: Iterable[str],
        matchkind: MatchKind = MatchKind.Standard,
        store_patterns: Optional[bool] = None,
        implementation: Optional[Implementation] = None,
        *,
        backend: str = "auto",
        device: Union[str, torch.device, None] = None,
        mesh: "MeshLike" = None,
    ) -> None:
        byte_patterns: list[bytes] = []
        originals: list[str] = []
        total_chars = 0
        for p in patterns:
            if not isinstance(p, str):
                # PyO3's cast_into::<PyString> downcast error, surfaced
                # verbatim by the reference (upstream src/lib.rs:149)
                raise TypeError(
                    f"'{type(p).__name__}' object cannot be converted to "
                    "'PyString'"
                )
            if not p:
                raise ValueError(
                    "You passed in an empty string as a pattern"
                )
            originals.append(p)
            total_chars += len(p)
            byte_patterns.append(p.encode("utf-8"))
        if store_patterns is None:
            store_patterns = total_chars <= STORE_PATTERNS_THRESHOLD
        self._patterns: Optional[list[str]] = (
            originals if store_patterns else None
        )
        self._build(
            byte_patterns, matchkind, implementation, backend, device, mesh
        )

    def find_matches_as_indexes(
        self, haystack: str, overlapping: bool = False
    ) -> list[tuple[int, int, int]]:
        """All matches as ``(pattern_index, start, end)`` code-point tuples."""
        data, hay = _encode(haystack)
        matches = self._find(hay, overlapping)
        if not matches:
            return []
        if len(data) == len(haystack):  # pure ASCII: byte index == cp index
            return matches
        cp = byte_to_codepoint_prefix(hay)
        return [(p, int(cp[s]), int(cp[e])) for (p, s, e) in matches]

    def find_matches_as_indexes_batch(
        self, haystacks: Iterable[str], overlapping: bool = False
    ) -> list[list[tuple[int, int, int]]]:
        """Batched :meth:`find_matches_as_indexes` over many haystacks.

        Device extra (no upstream counterpart): scans every haystack in
        one device dispatch — the layout of the upstream benchmark's own
        workload, 10k-100k documents of ~70-600 chars.  Output is exactly
        ``[find_matches_as_indexes(h, overlapping) for h in haystacks]``.
        """
        _, hays, ascii_doc = _encode_batch(haystacks)
        batches = self._find_batch(hays, overlapping)
        out = []
        for is_ascii, hay, matches in zip(ascii_doc, hays, batches):
            if matches and not is_ascii:
                cp = byte_to_codepoint_prefix(hay)
                matches = [
                    (p, int(cp[s]), int(cp[e])) for (p, s, e) in matches
                ]
            out.append(matches)
        return out

    def find_matches_as_strings(
        self, haystack: str, overlapping: bool = False
    ) -> list[str]:
        """All matches as their pattern strings.

        Uses stored pattern objects when available, else slices the haystack
        (both arms produce equal values — reference upstream
        src/lib.rs:263-271).
        """
        data, hay = _encode(haystack)
        matches = self._find(hay, overlapping)
        if self._patterns is not None:
            return [self._patterns[p] for (p, _, _) in matches]
        return [data[s:e].decode("utf-8") for (_, s, e) in matches]

    def find_matches_as_strings_batch(
        self, haystacks: Iterable[str], overlapping: bool = False
    ) -> list[list[str]]:
        """Batched :meth:`find_matches_as_strings` (device extra)."""
        datas, hays, _ = _encode_batch(haystacks)
        batches = self._find_batch(hays, overlapping)
        if self._patterns is not None:
            return [
                [self._patterns[p] for (p, _, _) in matches]
                for matches in batches
            ]
        return [
            [d[s:e].decode("utf-8") for (_, s, e) in matches]
            for d, matches in zip(datas, batches)
        ]


class BytesAhoCorasick(_MatcherBase):
    """Multi-pattern matcher over bytes-like haystacks.

    Matches the reference class (upstream src/lib.rs:360-434): patterns
    and haystacks are buffer-protocol objects, returned indexes are raw
    byte offsets, and there is no ``find_matches_as_strings``.  The extras
    are :class:`AhoCorasick`'s.
    """

    def __init__(
        self,
        patterns: "Iterable[Buffer]",
        matchkind: MatchKind = MatchKind.Standard,
        implementation: Optional[Implementation] = None,
        *,
        backend: str = "auto",
        device: Union[str, torch.device, None] = None,
        mesh: "MeshLike" = None,
    ) -> None:
        byte_patterns: list[bytes] = []
        for p in patterns:
            bp = pattern_bytes(p)
            if not bp:
                raise ValueError("You passed in an empty pattern")
            byte_patterns.append(bp)
        self._build(
            byte_patterns, matchkind, implementation, backend, device, mesh
        )

    def find_matches_as_indexes(
        self, haystack: "Buffer", overlapping: bool = False
    ) -> list[tuple[int, int, int]]:
        """All matches as ``(pattern_index, start, end)`` byte tuples."""
        hay = as_byte_view(haystack)
        trace.count("scanned_bytes", len(hay))
        return self._find(hay, overlapping)

    def find_matches_as_indexes_batch(
        self, haystacks: "Iterable[Buffer]", overlapping: bool = False
    ) -> list[list[tuple[int, int, int]]]:
        """Batched :meth:`find_matches_as_indexes` (device extra).

        One device dispatch for many bytes-like haystacks; output equals
        the per-haystack loop exactly.
        """
        hays = [as_byte_view(h) for h in haystacks]
        trace.count("scanned_bytes", sum(len(h) for h in hays))
        return self._find_batch(hays, overlapping)
