"""Device timing from ``jax.profiler`` traces.

``measure_device_time`` runs a callable a few times inside a
``jax.profiler.trace`` window (with one real device-to-host read at the
end so the executions provably complete inside the window), reads the
resulting ``*.xplane.pb`` with ``jax.profiler.ProfileData``, and returns
device durations.

Only device planes (named ``/device:...``) count.  A trace without one —
the CPU backend writes only host planes — raises: a host-clock number is
never reported as a device time.

Two device-plane layouts are read:

* an ``XLA Modules`` line with one event per module execution (and an
  ``XLA Ops`` line with one event per op);
* the GPU layout (H100): ``Stream #N(...)`` lines whose events are the
  kernels and copies, each kernel carrying ``hlo_module``, ``hlo_op`` and
  ``prefix`` (the ``jax.named_scope`` path) stats.  There a module's
  executions are not delimited, so its time is the sum of its kernels.
"""

from __future__ import annotations

import shutil
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

__all__ = [
    "DeviceTiming",
    "device_busy",
    "device_events",
    "device_planes",
    "measure_device_time",
    "module_device_times",
    "op_device_times",
    "scope_device_times",
]


def device_planes(trace_dir) -> Iterator:
    """Every device plane (``/device:...``) of every trace under a dir.

    Raises RuntimeError when the trace holds no device plane.
    """
    from jax.profiler import ProfileData

    found = False
    for pb in sorted(Path(trace_dir).rglob("*.xplane.pb")):
        for plane in ProfileData.from_file(str(pb)).planes:
            if plane.name.startswith("/device:"):
                found = True
                yield plane
    if not found:
        raise RuntimeError(f"no device plane in the trace under {trace_dir}")


def _stats(ev) -> Dict[str, str]:
    return {str(k): str(v) for k, v in ev.stats}


def device_events(trace_dir) -> Iterator[Tuple[str, object, Dict[str, str]]]:
    """``(line_name, event, stats)`` for every device-plane event."""
    for plane in device_planes(trace_dir):
        for line in plane.lines:
            for ev in line.events:
                yield line.name, ev, _stats(ev)


def _has_line(trace_dir, name: str) -> bool:
    return any(line.name == name for plane in device_planes(trace_dir)
               for line in plane.lines)


def module_device_times(trace_dir) -> Dict[str, List[float]]:
    """Device seconds of every XLA module in a trace.

    With an ``XLA Modules`` line: ``{module: [seconds per execution]}`` in
    execution order.  In the GPU layout: ``{module: [total kernel
    seconds]}`` (one entry; executions are not delimited there).  Module
    names look like ``jit_step``; a ``(fingerprint)`` suffix is stripped.
    """
    if _has_line(trace_dir, "XLA Modules"):
        out: Dict[str, List[tuple]] = defaultdict(list)
        for line, ev, _ in device_events(trace_dir):
            if line == "XLA Modules":
                out[ev.name.split("(")[0]].append(
                    (ev.start_ns, ev.duration_ns / 1e9))
        return {k: [d for _, d in sorted(v)] for k, v in out.items()}
    total: Dict[str, float] = defaultdict(float)
    for _, ev, st in device_events(trace_dir):
        if "hlo_module" in st:
            total[st["hlo_module"].split("(")[0]] += ev.duration_ns / 1e9
    return {k: [v] for k, v in total.items()}


def op_device_times(trace_dir) -> Dict[str, float]:
    """Total device seconds per XLA op (HLO instruction) across a trace."""
    use_ops_line = _has_line(trace_dir, "XLA Ops")
    out: Dict[str, float] = defaultdict(float)
    for line, ev, st in device_events(trace_dir):
        if use_ops_line:
            if line == "XLA Ops":
                out[ev.name] += ev.duration_ns / 1e9
        elif "hlo_op" in st:
            out[st["hlo_op"]] += ev.duration_ns / 1e9
    return dict(out)


def scope_device_times(trace_dir, scopes) -> Dict[str, float]:
    """Kernel seconds per ``jax.named_scope`` name (GPU layout).

    A kernel counts toward the first of ``scopes`` found in its ``prefix``
    stat, else toward ``"other"``; copies count toward ``"copies"``.
    """
    out: Dict[str, float] = defaultdict(float)
    for _, ev, st in device_events(trace_dir):
        if "hlo_op" not in st:
            out["copies"] += ev.duration_ns / 1e9
            continue
        prefix = st.get("prefix", "")
        out[next((s for s in scopes if s in prefix), "other")] += (
            ev.duration_ns / 1e9)
    return dict(out)


def device_busy(trace_dir) -> Tuple[float, float]:
    """``(busy_s, span_s)``: the union of all device-event intervals, and
    the time from the first event's start to the last one's end."""
    spans = sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                   for _, ev, _ in device_events(trace_dir))
    if not spans:
        return 0.0, 0.0
    busy, end = 0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e9, (max(b for _, b in spans) - spans[0][0]) / 1e9


class DeviceTiming(NamedTuple):
    """Result of measure_device_time."""

    runs: List[float]          # per-execution device seconds, in order
    module: str                # XLA module name the runs belong to
    all_modules: Dict[str, List[float]]  # every module seen in the window

    @property
    def median(self) -> float:
        s = sorted(self.runs)
        return s[len(s) // 2]

    @property
    def total(self) -> float:
        return sum(self.runs)


def measure_device_time(
    call: Callable[[int], object],
    n: int = 3,
    module: Optional[str] = None,
    trace_dir=None,
) -> DeviceTiming:
    """True device seconds per execution of ``call``.

    ``call(i)`` must dispatch the program under measurement and return a
    (small) jax array; after the n calls, one ``jax.device_get`` of the
    last return value forces every dispatched execution to complete inside
    the trace window (programs execute in dispatch order per device).
    Warm/compile ``call`` BEFORE invoking this, or the first run's duration
    will include autotuning noise (compile time itself happens host-side
    and never lands on the device plane).

    ``module`` selects which XLA module's durations to report when the
    callable dispatches more than one distinct program (substring match);
    by default the module with the largest total device time is chosen.

    Returns per-run durations for the chosen module; if the callable
    dispatches that module multiple times per call, every execution is a
    "run" (use ``total`` and divide by n for per-call device seconds).  In
    the GPU layout, where executions are not delimited, the n runs are the
    window's total divided evenly.
    """
    import jax

    own_dir = trace_dir is None
    d = Path(tempfile.mkdtemp(prefix="slam_devtime_")) if own_dir else Path(trace_dir)
    try:
        with jax.profiler.trace(str(d)):
            out = None
            for i in range(n):
                out = call(i)
            jax.device_get(out)
        mods = module_device_times(d)
    finally:
        if own_dir:
            shutil.rmtree(d, ignore_errors=True)
    if not mods:
        raise RuntimeError(
            f"no module events captured on the device plane in {n} runs; "
            "is the callable dispatching a jitted program?")
    if module is not None:
        matches = {k: v for k, v in mods.items() if module in k}
        if not matches:
            raise RuntimeError(f"no module matching {module!r}; "
                               f"saw {sorted(mods)}")
        name = max(matches, key=lambda k: sum(matches[k]))
    else:
        name = max(mods, key=lambda k: sum(mods[k]))
    runs = mods[name]
    if len(runs) == 1 and n > 1:
        runs = [runs[0] / n] * n
    return DeviceTiming(runs=runs, module=name, all_modules=dict(mods))
