"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one card.  The cell's files name the modules a run uses
(gpubench/cells.py): its input generator, its program and its check.
Set-up (timed as setup_s, from the start of this process): import the
program (the port, whose kernels load or build in its own build
directory inside the checkout), simulate the cell's input from the seed
on the card and write it under TMPDIR, and one warm-up run at the
cell's own shapes.  Then a closed loop of whole runs, one client, each
an in-process call of the entry users run (for ngsDist,
ngsdist_tpu_torch.cli.main: it reads the input, computes 1 + R matrices
and writes the phylip file), with a seed of its own drawn from --seed,
until --seconds have passed; the run under way then finishes, and the
outputs it had written by the window's end count.  After the window the
outputs of run 1, of three runs drawn from the seed and of the run the
window's end cut are judged against the plain reference by the cell's
check (gpubench/checks/<check>.py); the others are deleted as they end.

--trace 0 reports the end-to-end metrics: run_s (mean wall time of the
runs that ended in the window), updates_per_s (the work of every output
written in the window, over the window) and setup_s.  --trace 1 turns on
the program's spans and torch.profiler over the window and reports the
per-layer metrics, each read by gpubench/metrics/<name>.py from the
record of gpubench/trace.py.

The last line of standard output is the result's JSON; the last lines of
standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from gpubench import cells  # noqa: E402
from gpubench import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ngsdist_tpu")


def boot_seed(seed: int, k: int) -> int:
    """The bootstrap --seed of run k (0: the warm-up) of a process seeded
    with `seed`."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(1)[0])


def judged_runs(seed: int) -> set:
    """The runs whose outputs the check judges, besides the one the
    window's end cuts: run 1 and three of runs 2 to 8, drawn from the
    seed (every cell ends eight runs or more in its window)."""
    rng = np.random.default_rng([int(seed), 1])
    return {1, *(int(k) for k in rng.choice(np.arange(2, 9), 3, replace=False))}


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    index: int
    path: str
    boot_seed: int
    start: float = 0.0
    end: float = 0.0
    judged: bool = True       # kept for the check; else deleted once it ends in the window
    rc: Optional[int] = None
    stage: object = None      # the program's StageTimes in a traced run
    kept: bool = True

    @property
    def wall_s(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    start: float
    end: float = 0.0           # when the deadline's snapshot was taken
    runs: List[Run] = field(default_factory=list)
    cut: Optional[tuple] = None  # (run index, bytes of its file) at the deadline


def closed_loop(call, make_run, seconds: float, stage_for=None) -> Window:
    """Start runs back to back until `seconds` have passed; at the
    deadline note the size of the file of the run under way.  The output
    of a run the check does not judge is deleted as soon as the run ends
    before the deadline, so that its pages never reach the disk."""
    win = Window(start=time.perf_counter())
    deadline = win.start + seconds
    current: List[Optional[Run]] = [None]

    def at_deadline():
        run = current[0]
        if run is not None:
            try:
                win.cut = (run.index, os.path.getsize(run.path))
            except OSError:
                win.cut = (run.index, 0)
        win.end = time.perf_counter()

    timer = threading.Timer(max(0.0, deadline - time.perf_counter()), at_deadline)
    timer.start()
    try:
        while time.perf_counter() < deadline:
            run = make_run(len(win.runs) + 1)
            current[0] = run
            win.runs.append(run)
            run.stage = stage_for() if stage_for else None
            run.start = time.perf_counter()
            try:
                run.rc = call(run)
            except Exception:  # a run that raises is a failed run; the loop ends
                traceback.print_exc()
                run.rc = -1
            run.end = time.perf_counter()
            current[0] = None
            if run.rc != 0:
                break
            if not run.judged and run.end < deadline:
                os.remove(run.path)
                run.kept = False
    finally:
        timer.join()
    return win


def _profiler_events(prof, runs: List[Run]) -> list:
    """[(name, start, end)] of the profiler's device events (kernels and
    copies) on the perf_counter clock, through the profiler's event of
    run 1, which starts with it."""
    from torch.autograd import DeviceType

    events = prof.events()
    mark = f"gpubench.run.{runs[0].index}"
    starts = [e.time_range.start for e in events
              if e.name == mark and e.device_type == DeviceType.CPU]
    if not starts:
        raise RuntimeError(f"no profiler event {mark}")
    offset = starts[0] / 1e6 - runs[0].start
    # the runs' own marks also appear on the device's timeline; they are
    # no device work
    return [(e.name, e.time_range.start / 1e6 - offset, e.time_range.end / 1e6 - offset)
            for e in events
            if e.device_type == DeviceType.CUDA and not e.name.startswith("gpubench.")]


def _finite(v):
    """A number for the result's JSON: a non-finite one as its text."""
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float = T_PROCESS, entry=None, warm_up: bool = True) -> dict:
    """Set-up, window and check of one cell on `device`; returns the
    result line's dict.  `entry` takes the program's place (the control);
    without `warm_up` set-up makes no warm-up run (readings that time
    nothing)."""
    import torch

    program, checks_mod = cell.program, cell.check
    cfg, opts = cell.config, cell.options
    call_entry = entry or program.entry()
    per_output = checks_mod.work_per_output(cfg, opts)
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        t_import = time.perf_counter()
        inp = os.path.join(tmp, "input.bin")
        cell.gen.write(inp, cfg, seed, device)
        with open(inp, "rb") as fh:   # written back now, not in the window
            os.fsync(fh.fileno())
        t_input = time.perf_counter()
        to_judge = judged_runs(seed)

        def make_run(k: int) -> Run:
            return Run(k, os.path.join(tmp, f"run{k}.out"), boot_seed(seed, k),
                       judged=k in to_judge)

        def call(run: Run) -> int:
            args = program.command(cfg, cell.traffic, inp, run.path, run.boot_seed,
                                   device.type)
            program.activate(run.stage)
            try:
                if traced:
                    with torch.profiler.record_function(f"gpubench.run.{run.index}"):
                        return call_entry(args)
                return call_entry(args)
            finally:
                program.activate(None)

        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        warm = make_run(0)
        if warm_up:
            warm.start = time.perf_counter()
            if call(warm) != 0:
                raise RuntimeError("the warm-up run failed")
            warm.end = time.perf_counter()
            os.remove(warm.path)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_process
        print(f"setup: {t_import - t_process:.3f} s to the harness loaded, input "
              f"{t_input - t_import:.3f} s, warm-up run {warm.wall_s:.3f} s, "
              f"in all {setup_s:.3f} s", file=sys.stderr)

        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        stage_for = (lambda: program.spans(device)) if traced else None
        counted = program.counters()
        try:
            win = closed_loop(call, make_run, seconds, stage_for)
        finally:
            if prof is not None:
                prof.stop()
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        counted = {k: v - counted[k] for k, v in program.counters().items()}

        ended = [r for r in win.runs if r.rc == 0 and r.end <= win.end]
        failed = [r for r in win.runs if r.rc != 0]
        updates = sum(sum(per_output) for _ in ended)
        if win.cut is not None and not any(r.index == win.cut[0] for r in ended):
            cut_run = next(r for r in win.runs if r.index == win.cut[0])
            if cut_run.rc == 0:
                done = checks_mod.outputs_in_prefix(cut_run.path, win.cut[1], cfg)
                updates += sum(per_output[:done])
        window_s = win.end - win.start

        # the reference, once the window has closed and the peak is read
        if cuda:
            torch.cuda.empty_cache()
        state = checks_mod.reference_state(inp, cfg, seed, device)
        judged = checks_mod.judge([(r.path, r.boot_seed) for r in win.runs
                                   if r.rc == 0 and r.kept], state, opts, cfg)
        checks = {name: {"value": judged[name], "limit": lim["limit"]}
                  for name, lim in cell.limits.items() if name in judged}
        checks["failed_runs"] = {"value": len(failed), "limit": 0}
        correct = judged["runs_judged"] > 0 and all(
            c["value"] <= c["limit"] for c in checks.values())
        checks = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                  for k, c in checks.items()}

        result = {"correct": bool(correct), "attempted": len(win.runs), "failed": len(failed)}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(memory_peak)}
        if not traced:
            values = {"run_s": (sum(r.wall_s for r in ended) / len(ended)) if ended else None,
                      "updates_per_s": updates / window_s,
                      "setup_s": setup_s}
            result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                                 for m in cell.end_to_end if values.get(m["name"]) is not None}
        else:
            bound = checks_mod.bound_s(state, cfg, opts)
            record = {"window": (win.start, win.end),
                      "device": _profiler_events(prof, win.runs) if cuda else [],
                      "runs": [_run_record(r, bound) for r in ended],
                      "cut": [_run_record(r, bound) for r in win.runs
                              if r not in ended and r.rc == 0]}
            result["metrics"] = _per_layer(cell, record)
            dev["busy_s"] = tr.device_busy_s(record)
            dev["window_s"] = window_s
            result["breakdown"] = tr.breakdown(record)
        result["device"] = dev
        result["checks"] = checks
        print(f"runs: {len(win.runs)} started, {len(ended)} ended in the window of "
              f"{window_s:.3f} s, walls {[round(r.wall_s, 3) for r in win.runs]}, "
              f"counters {counted}, {judged['runs_judged']} judged", file=sys.stderr)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _per_layer(cell: cells.Cell, record: dict) -> dict:
    """The cell's per-layer metrics that find something to read in the
    record; each run's spans and the time of the kernels it has a bound
    for go to standard error."""
    for k, r in enumerate(record["runs"]):
        spans = {n: round(tr.length(iv), 4) for n, iv in r["spans"].items() if iv}
        took = {name: round(sum(e - s for n, s, e in record["device"]
                                if name in n and r["start"] <= s <= r["end"]), 4)
                for name in r["bound_s"]}
        print(f"run {k}: wall {r['wall_s']:.4f} s, spans {spans}, kernels {took} s",
              file=sys.stderr)
    out = {}
    for m in cell.per_layer:
        value = cells.module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _run_record(run: Run, bound_s: dict) -> dict:
    spans = {}
    if run.stage is not None:
        spans = {name: [(run.stage.t0 + s, run.stage.t0 + e) for s, e in ivs]
                 for name, ivs in run.stage.intervals().items()}
    return {"start": run.start, "end": run.end, "wall_s": run.wall_s,
            "bound_s": bound_s, "spans": spans}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = cells.load(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
