#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA card.

Run from the root of a checkout:

    python3 profile_torch.py [--out FILE]

Drives chip_smoke.py's main-path runs (chip_smoke.RUNS) through the
port's CLI entry point: (a) indep --pairwise_del at 1024 x 65,536 with
2 bootstrap replicates (weighted recompute), (b) the EM at 1024 x
16,384, (c) the EM with 8 replicates and (d) (a) with 4 replicates
(both on the partial-sum bootstrap route), each once to warm up and
once under cProfile and torch.profiler.  For each run it prints the
wall time (host clock), the functions that took the most time, and the
device's busy share: the union of the intervals in which any kernel or
copy ran on the card, over the run's wall time.  The full cProfile and
profiler tables go to FILE (default profiles/profile_torch.txt).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import shutil
import sys
import time

import chip_smoke


def device_intervals(events):
    """(start, end) in us of every device-side event: kernels and copies."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end)
                  for e in events if e.device_type == DeviceType.CUDA)


def union_length(intervals) -> float:
    """Length of the union of sorted (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_run(torch, cli, name, args, report):
    from torch.profiler import ProfilerActivity, profile

    cli.main(args)  # warm-up: builds, allocator, page cache
    torch.cuda.synchronize()
    prof_c = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_c.enable()
        rc = cli.main(args)
        torch.cuda.synchronize()
        prof_c.disable()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{name}: exit code {rc}")
    iv = device_intervals(prof.events())
    busy = union_length(iv) / 1e6
    summed = sum(e - s for s, e in iv) / 1e6
    buf = io.StringIO()
    pstats.Stats(prof_c, stream=buf).sort_stats("cumulative").print_stats(30)
    report.write(f"=== {name}: wall {wall:.3f} s\n{buf.getvalue()}\n")
    report.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))
    report.write("\n")
    print(f"{name}: wall {wall:.3f} s (host clock, profilers on); device busy "
          f"{busy:.3f} s = {busy / wall:.4f} of wall (union of {len(iv)} kernel "
          f"and copy intervals; their durations sum to {summed:.3f} s)", flush=True)
    rows = sorted(pstats.Stats(prof_c).stats.items(), key=lambda kv: kv[1][2],
                  reverse=True)[:8]
    for (fn_file, line, fn), (_, _, tottime, _, _) in rows:
        print(f"  {tottime:8.3f} s self  {os.path.basename(fn_file)}:{line}({fn})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(chip_smoke.ROOT, "profiles",
                                                  "profile_torch.txt"))
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    from ngsdist_tpu_torch import cli

    print(chip_smoke.card_line(), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    work = chip_smoke.WORK
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        _, genos = chip_smoke.write_inputs(work)
        with open(opts.out, "w") as report:
            report.write(chip_smoke.card_line() + "\n")
            for run, (kind, sites, *_) in chip_smoke.RUNS.items():
                args = chip_smoke.run_args(run, genos[sites], os.path.join(work, f"{run}.dist"))
                profile_run(torch, cli, f"{run}_{kind}", args + ["--platform", "cuda"], report)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
