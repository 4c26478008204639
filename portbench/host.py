"""The host side of a run: the CPU binding, and the host's own counters.

GPU deployments run a process on the CPUs local to its card (the CPU
affinity ``nvidia-smi topo -m`` prints).  :func:`bind` does that for the
run's own process, before torch is imported, so that every thread the
port starts inherits it.  It changes nothing of the machine: only the
affinity of this process.

The rest reads what explains a slow run: the transparent-huge-page mode
(:func:`thp_mode`), the window's page faults, context switches and CPU
seconds (:func:`usage`, ``resource.getrusage``), the process's and the
host's memory and load (:func:`memory`, :func:`loadavg`), the size of the
kernel build cache (:func:`tree_bytes`), and the SM clock, power draw and
power limit (:func:`gpu_sample`, ``nvidia-smi``).
This module imports neither torch nor the port.
"""

from __future__ import annotations

import os
import resource
import subprocess
from typing import Any, Optional

_THP = "/sys/kernel/mm/transparent_hugepage/enabled"


def _smi(query: str) -> list[list[str]]:
    """Rows of ``nvidia-smi --query-gpu=<query>``, or [] without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [[c.strip() for c in ln.split(",")] for ln in out.splitlines()
            if ln.strip()]


def parse_cpulist(text: str) -> set[int]:
    """``0-3,8,10-11`` as a set of CPU numbers."""
    cpus: set[int] = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def sysfs_bus_id(bus_id: str) -> str:
    """``00000000:18:00.0`` (nvidia-smi) as ``0000:18:00.0`` (sysfs)."""
    domain, rest = bus_id.strip().lower().split(":", 1)
    return f"{domain[-4:]}:{rest}"


def card_cpus(cards: int) -> tuple[Optional[set[int]], str]:
    """The union of the first ``cards`` cards' local CPUs, as their
    ``local_cpulist`` gives them, and where it came from (or why there is
    none)."""
    rows = _smi("pci.bus_id")
    if len(rows) < cards:
        return None, f"nvidia-smi lists {len(rows)} cards"
    buses = [r[0] for r in rows[:cards]]
    if not all(b.count(":") == 2 for b in buses):
        return None, f"bus id {buses[0]}: no local_cpulist to read"
    cpus: set[int] = set()
    for bus in buses:
        path = f"/sys/bus/pci/devices/{sysfs_bus_id(bus)}/local_cpulist"
        try:
            with open(path) as f:
                cpus |= parse_cpulist(f.read())
        except OSError as e:
            return None, f"{path}: {e.strerror}"
    return cpus, "local_cpulist of " + " ".join(buses)


def bind(cards: int) -> dict[str, Any]:
    """Bind this process to the CPUs local to its cards, where the host
    allows it; what was done, for the host record."""
    allowed = os.sched_getaffinity(0)
    cpus, how = card_cpus(cards)
    rec: dict[str, Any] = {"allowed_before": _cpulist(allowed)}
    if cpus is None:
        rec.update(bound=False, why=how)
        return rec
    target = cpus & allowed
    rec["card_cpus"] = _cpulist(cpus)
    if not target:
        rec.update(bound=False, why=f"{how}: none of them is allowed")
        return rec
    os.sched_setaffinity(0, target)
    rec.update(bound=True, cpus=_cpulist(os.sched_getaffinity(0)), why=how)
    return rec


def _cpulist(cpus: set[int]) -> str:
    """A set of CPUs as ``0-3,8``."""
    out = []
    run: list[int] = []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else f"{run[0]}")
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else f"{run[0]}")
    return ",".join(out)


def thp_mode() -> str:
    """The transparent-huge-page mode (the bracketed word)."""
    try:
        with open(_THP) as f:
            text = f.read()
    except OSError:
        return "unknown"
    start, end = text.find("["), text.find("]")
    return text[start + 1 : end] if 0 <= start < end else text.strip()


def usage() -> dict[str, float]:
    """This process's counters now (some virtualised kernels count no
    faults or switches: they then read 0)."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "minflt": r.ru_minflt, "majflt": r.ru_majflt,
        "nvcsw": r.ru_nvcsw, "nivcsw": r.ru_nivcsw,
        "user_s": r.ru_utime, "sys_s": r.ru_stime,
    }


def memory() -> dict[str, int]:
    """kB: this process's resident and peak resident memory
    (``/proc/self/status``, ``getrusage``), and the host's available
    memory and page cache (``/proc/meminfo``); what a host does not show
    reads 0."""
    out = {"rss_kb": 0, "hwm_kb": 0, "mem_available_kb": 0, "cached_kb": 0,
           "maxrss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}
    for path, keys in (("/proc/self/status", {"VmRSS:": "rss_kb",
                                              "VmHWM:": "hwm_kb"}),
                       ("/proc/meminfo", {"MemAvailable:": "mem_available_kb",
                                          "Cached:": "cached_kb"})):
        try:
            with open(path) as f:
                for ln in f:
                    key = ln.split(None, 1)[0] if ln.strip() else ""
                    if key in keys:
                        out[keys[key]] = int(ln.split()[1])
        except (OSError, ValueError, IndexError):
            continue
    return out


def loadavg() -> str:
    """The host's load averages (``/proc/loadavg``), or ""."""
    try:
        with open("/proc/loadavg") as f:
            return f.read().strip()
    except OSError:
        return ""


def port_build_dir() -> str:
    """The port's kernel build cache inside the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "ahocorasick_rs_tpu_torch", "_build")


def tree_bytes(path: str) -> int:
    """Bytes of the files under ``path`` (0 where there is none)."""
    total = 0
    for base, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(base, name))
            except OSError:
                pass
    return total


def usage_delta(before: dict, after: dict) -> dict[str, float]:
    return {k: after[k] - before[k] for k in before}


def gpu_sample(cards: int) -> list[dict[str, str]]:
    """SM clock (MHz), power draw and limit (W) of the first cards."""
    rows = _smi("index,name,clocks.sm,power.draw,power.limit")
    keys = ("index", "name", "sm_mhz", "power_w", "power_limit_w")
    return [dict(zip(keys, r)) for r in rows[:cards]]
