"""The phases of a traced stretch as the program marks them: each ``phase:
<name>`` range that ``utils/profile.span`` opens in ``train_step`` and in
``Embedder`` (a program without them leaves none, and every reader here
returns None).

``split`` works out, once a run, for each phase:

* **launches**: the kernel records whose launch correlates, through the
  frozen ``trace._host_sweep``, to a launch inside that phase's range (a
  launch on the autograd engine's thread, outside every range, is the
  ``backward``'s);
* **device µs**: the durations of the device records (kernels, copies,
  sets) so launched;
* **idle µs**: of every gap of the busy union (the frozen ``trace._union``,
  no floor on a gap's length), the part that lies inside the phase's range
  on the trace's clock; where ranges nest, the innermost wins (where two
  threads' ranges overlap, the one opened last).

What lies in no range, or was launched from none, is ``outside``: the
phases and ``outside`` add up to the stretch's kernels, device records and
gaps.
"""

from __future__ import annotations

import collections
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import trace

OUTSIDE = "outside"
# the phases of an update of the parameters
UPDATE = ("grad_norm", "optimizer")


def _segments(spans: List[dict]) -> List[Tuple[float, float, str]]:
    """The ranges as disjoint (start, end, phase) pieces in time order: over
    each piece, of the ranges open, the one opened last (the innermost)."""
    order = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    times = sorted({t for e in spans for t in (e["ts"], e["ts"] + e["dur"])})
    out: List[Tuple[float, float, str]] = []
    opened: List[tuple] = []          # a heap of (−order, end, phase)
    k = 0
    for t0, t1 in zip(times, times[1:]):
        while k < len(order) and order[k]["ts"] <= t0:
            e = order[k]
            heapq.heappush(opened, (-k, e["ts"] + e["dur"],
                                    e["name"][len(trace.PHASE_MARK):]))
            k += 1
        while opened and opened[0][1] <= t0:
            heapq.heappop(opened)
        if opened:
            out.append((t0, t1, opened[0][2]))
    return out


def split(events: Sequence[dict]) -> Optional[Dict[str, Dict[str, float]]]:
    """→ ``{"launches", "device_us", "idle_us"}``, each a dict phase →
    total over the stretch, ``outside`` included; None where the stretch
    holds no ``phase:`` range."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(trace.PHASE_MARK)]
    if not spans:
        return None
    device = sorted((e for e in events if e.get("cat") in trace.DEVICE_CATS),
                    key=lambda e: e["ts"])
    _, launched = trace._host_sweep([e for e in events
                                     if e.get("cat") in trace.HOST_CATS])
    launches: Dict[str, float] = collections.Counter()
    device_us: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        phase = launched.get(e.get("args", {}).get("correlation"),
                             (None,))[0] or OUTSIDE
        device_us[phase] += e["dur"]
        if e["cat"] == "kernel":
            launches[phase] += 1
    idle_us: Dict[str, float] = collections.defaultdict(float)
    segments = _segments(spans)
    i = 0
    for start, end, _ in trace._union(device)[1]:
        while i < len(segments) and segments[i][1] <= start:
            i += 1
        covered = 0.0
        j = i
        while j < len(segments) and segments[j][0] < end:
            lo, hi = max(start, segments[j][0]), min(end, segments[j][1])
            if hi > lo:
                idle_us[segments[j][2]] += hi - lo
                covered += hi - lo
            j += 1
        idle_us[OUTSIDE] += (end - start) - covered
    return {"launches": dict(launches), "device_us": dict(device_us),
            "idle_us": dict(idle_us)}


def _per_step(run, key: str, phases: Sequence[str]) -> Optional[float]:
    """The stretch's ``key`` summed over ``phases`` ÷ its steps (None
    without ranges or steps); the split is worked out once a run."""
    s = run.stretch
    if "phases" not in s:
        s["phases"] = split(s["events"])
    if s["phases"] is None or not s["steps"]:
        return None
    return sum(s["phases"][key].get(p, 0.0) for p in phases) / s["steps"]


def idle_ms(run, phases: Sequence[str]) -> Optional[float]:
    """Device idle ms a step inside ``phases``' ranges."""
    us = _per_step(run, "idle_us", phases)
    return None if us is None else us / 1e3


def device_ms(run, phases: Sequence[str]) -> Optional[float]:
    """Device ms a step of the records launched in ``phases``."""
    us = _per_step(run, "device_us", phases)
    return None if us is None else us / 1e3


def launches(run, phases: Sequence[str]) -> Optional[float]:
    """Kernels a step launched in ``phases``."""
    return _per_step(run, "launches", phases)
