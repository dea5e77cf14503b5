"""Interval arithmetic of the traced run, and the record the per-layer
metrics read.

Every time in a record is in seconds on the host's perf_counter clock.
The profiler's device events are mapped onto it through the profiler's
own event around each run, whose start is the run's start on both
clocks.

record = {
  "runs": [{"start", "end", "wall_s",
            "bound_s": {kernel name: least time of the run's work in it},
            "spans": {"read": [(s, e)], "scan": ..., "upload": ...,
                      "kernel": ..., "gather": ...}}],   # runs ended in the window
  "device": [(name, start, end)],   # kernels and copies, the whole trace
  "cut": [...],   # as "runs": the run the window's end cut, if any
  "window": (start, end),
}
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as sorted disjoint ones."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length(intervals: Iterable[Interval]) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in merge(intervals))


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def mean_over_runs(record: dict, fn) -> Optional[float]:
    runs = record["runs"]
    return sum(fn(r) for r in runs) / len(runs) if runs else None


def span_seconds(record: dict, names: Tuple[str, ...]) -> Optional[float]:
    """Mean over the runs of the union of their spans of `names`; None
    where no run has one."""
    if not any(r["spans"].get(n) for r in record["runs"] for n in names):
        return None
    return mean_over_runs(
        record, lambda r: length(iv for n in names for iv in r["spans"].get(n, ())))


def device_busy_s(record: dict) -> float:
    """Seconds of the window in which a kernel or a copy ran."""
    lo, hi = record["window"]
    return length(clip(((s, e) for _, s, e in record["device"]), lo, hi))


def breakdown(record: dict, top: int = 10) -> dict:
    """{"device_ops": the device operations that took most time in the
    window, "idle_gaps": its longest idle gaps, each named by the run and
    the program's span (or "no span") the host was in at the gap's
    middle, or "between runs"}."""
    lo, hi = record["window"]
    by_name: dict = {}
    for name, s, e in record["device"]:
        for cs, ce in clip([(s, e)], lo, hi):
            by_name[name] = by_name.get(name, 0.0) + (ce - cs)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    labelled = []
    for s, e in gaps(((s, e) for _, s, e in record["device"]), lo, hi):
        mid = (s + e) / 2
        label = "between runs"
        runs = [(f"run {k}", r) for k, r in enumerate(record["runs"])]
        runs += [("cut run", r) for r in record.get("cut", [])]
        for name, r in runs:
            if r["start"] <= mid <= r["end"]:
                inside = [n for n, ivs in sorted(r["spans"].items())
                          if any(a <= mid <= b for a, b in ivs)]
                label = f"{name}: {'+'.join(inside) if inside else 'no span'}"
        labelled.append([label, e - s])
    labelled.sort(key=lambda x: -x[1])
    return {"device_ops": [[n[:120], t] for n, t in ops], "idle_gaps": labelled[:top]}
