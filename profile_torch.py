#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA card.

Run from the root of a checkout:

    python3 profile_torch.py [--out FILE]

    python3 profile_torch.py [--out FILE] [--runs a,b,gs] [--sweep] [--parts]
                             [--lookahead] [--compaction]

Drives chip_smoke.py's main-path runs (chip_smoke.RUNS) through the
port's CLI entry point: (a) indep --pairwise_del at 1024 x 65,536 with
2 bootstrap replicates (weighted recompute), (b) the EM at 1024 x
16,384, (c) the EM with 8 replicates and (d) (a) with 4 replicates
(both on the partial-sum bootstrap route), (e) (a)'s flags at 262,144
sites streamed from disk by the fused reader and (f) the EM at 65,536
sites streamed from the staged read, both under chip_smoke's forced
NGSDIST_DEVICE_BUDGET, and the runs of evolutionary models 3-6: (g) the
EM under TN93 at 16,384 sites and (h) indep --pairwise_del under F84 at
65,536 sites, both with 2 replicates and a POS file, and (gs), (g)
streamed in 4 chunks; each once to warm up and once under cProfile and
torch.profiler.  For each run it prints the wall time (host clock), the
functions that took the most time, and the device's busy share: the
union of the intervals in which any kernel or copy ran on the card,
over the run's wall time.  The full cProfile and profiler tables go to
FILE (default profiles/profile_torch.txt).

--sweep: run (e)'s wall time against the chunk length (SWEEP_CHUNKS,
each twice, in turns), and at the planner's own chunk length with the
round checkpoint's parts taken away: no file written (the sums are
still fetched after every chunk), and no fetch either (the sums stay on
the card until the matrix is due).  --parts: the pieces of an upload at
run (a)'s shape, each alone: the fused read of the whole file, the copy
of its packed slab from pinned memory, the expansion on the card, and
the staged route's cast and copy.  --lookahead: runs (g) and (h) with
the engine's lookahead for models 3-6 (core/distance.py
EXTENDED_LOOKAHEAD: replicate r+1 is launched before replicate r is
fetched) on and off, in turns.  --compaction: the same two runs with
each substitution class launched on its own sites only (the engine's
form on a card) and as three weighted launches on the whole tensor.
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


SWEEP_CHUNKS = (2048, 4096, 8192, 16384, 32768, 65536)  # sites per chunk, run (e)


def run_env(run):
    """The environment of main-path run `run`: a streamed run's forced
    budget and read route (chip_smoke.STREAMED), else neither."""
    if run not in chip_smoke.STREAMED:
        return {"NGSDIST_DEVICE_BUDGET": None, "NGSDIST_FUSED_READ": None}
    return {"NGSDIST_DEVICE_BUDGET": str(chip_smoke.forced_budget(run)),
            "NGSDIST_FUSED_READ": "auto" if chip_smoke.STREAMED[run][2] else "0"}


def timed_cli(torch, cli, args) -> float:
    """Wall seconds (host clock) of one CLI call, the card waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"exit code {rc}")
    return time.perf_counter() - t0


def sweep(torch, cli, geno, work):
    """Run (e)'s wall time against the chunk length, and the cost of the
    round checkpoint at the planner's own chunk length."""
    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.core import distance
    from ngsdist_tpu_torch.utils import checkpoint

    args = chip_smoke.run_args("e", geno, os.path.join(work, "e.dist")) + [
        "--platform", "cuda", "--verbose", "0"]
    _, sites, reps, _, _ = chip_smoke.RUNS["e"]
    n_ind = chip_smoke.N_IND
    planner = (distance.STREAM_MIN_CHUNKS, distance.STREAM_MIN_CHUNK_SITES)
    walls = {c: [] for c in SWEEP_CHUNKS}
    try:
        # the budget caps the chunk at c sites; nothing else bounds it
        distance.STREAM_MIN_CHUNKS, distance.STREAM_MIN_CHUNK_SITES = 1, 1
        for turn in (SWEEP_CHUNKS, SWEEP_CHUNKS[::-1]):
            for c in turn:
                with chip_smoke.environment({"NGSDIST_DEVICE_BUDGET": str(4 * c * n_ind * 12),
                                  "NGSDIST_FUSED_READ": None}):
                    assert distance.stream_plan(sites, n_ind, torch.device("cuda"),
                                                None, False) == (True, c)
                    walls[c].append(timed_cli(torch, cli, args))
    finally:
        distance.STREAM_MIN_CHUNKS, distance.STREAM_MIN_CHUNK_SITES = planner
    for c, w in walls.items():
        print(f"sweep: (e) {n_ind} x {sites} + {reps} replicates in chunks of {c} sites "
              f"({-(-sites // c)} chunks, {c * n_ind * 12} B each): wall "
              + " / ".join(f"{x:.3f}" for x in w) + " s", flush=True)

    with chip_smoke.environment(run_env("e")):
        full = [timed_cli(torch, cli, args)]
        save = checkpoint.save_rounds
        checkpoint.save_rounds = lambda *a, **k: None
        try:
            fetch_only = [timed_cli(torch, cli, args)]
        finally:
            checkpoint.save_rounds = save
        pars, _ = cli.parse_args(args)
        pars.validate()
        pars.finalize()

        def no_fetch():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with open(os.path.join(work, "e_nofetch.dist"), "w") as fh:
                runner.run(pars, torch.device("cuda"), out_fh=fh)  # not its file: no rounds
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        none = [no_fetch()]
        full.append(timed_cli(torch, cli, args))
        none.append(no_fetch())
    print("sweep: (e) at the planner's chunk length: rounds saved after every chunk "
          + " / ".join(f"{x:.3f}" for x in full) + " s; sums fetched but no file written "
          + " / ".join(f"{x:.3f}" for x in fetch_only) + " s; sums left on the card "
          + " / ".join(f"{x:.3f}" for x in none) + " s", flush=True)


def in_turns(torch, cli, genos, work, what, switch):
    """Wall time of runs (g) and (h) with switch(True) and switch(False)
    in force, in turns (on, off, off, on)."""
    for run in ("g", "h"):
        args = chip_smoke.run_args(run, genos[run], os.path.join(work, f"{run}.dist")) + [
            "--platform", "cuda", "--verbose", "0"]
        walls = {True: [], False: []}
        try:
            for on in (True, False, False, True):
                switch(on)
                walls[on].append(timed_cli(torch, cli, args))
        finally:
            switch(True)
        print(f"{what}: ({run}) on " + " / ".join(f"{x:.3f}" for x in walls[True])
              + " s, off " + " / ".join(f"{x:.3f}" for x in walls[False]) + " s", flush=True)


def lookahead(torch, cli, genos, work):
    """Runs (g) and (h) with replicate r+1 launched before replicate r is
    fetched, corrected and written, and without."""
    from ngsdist_tpu_torch.core import distance

    def switch(on):
        distance.EXTENDED_LOOKAHEAD = on

    in_turns(torch, cli, genos, work, "lookahead", switch)


def compaction(torch, cli, genos, work):
    """Runs (g) and (h) with each class's launch on its own sites only
    (the engine's form on a card) and as three weighted launches on the
    whole tensor."""
    from ngsdist_tpu_torch.core import distance

    on_a_card = distance.class_compaction

    def switch(on):
        distance.class_compaction = on_a_card if on else (lambda device: False)

    in_turns(torch, cli, genos, work, "compaction", switch)


def parts(torch, geno):
    """The pieces of run (a)'s upload, each alone (host clock around a
    synchronise; the copies and the expansion also by CUDA events)."""
    from ngsdist_tpu_torch.core import distance
    from ngsdist_tpu_torch.core.preprocess import preprocess
    from ngsdist_tpu_torch.io import readers

    n, s = chip_smoke.N_IND, chip_smoke.INDEP_SITES
    dev = torch.device("cuda")

    def host(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    pinned = torch.empty((s, n, 2), dtype=torch.float32, pin_memory=True)
    for label, out in (("a new array", None), ("pinned memory", pinned.numpy())):
        _, t = host(lambda: readers.read_geno_pack23(geno, False, n, s, out=out))
        print(f"parts: fused read of {n} x {s} into {label}: {t:.3f} s", flush=True)
    P2 = torch.empty((s, n, 2), dtype=torch.float32, device=dev)
    P3 = torch.empty((s, n, 3), dtype=torch.float32, device=dev)
    ms = chip_smoke.time_cuda(torch, lambda: P2.copy_(pinned, non_blocking=True), 5)
    print(f"parts: copy of the packed slab ({pinned.numel() * 4} B) from pinned memory: "
          f"{ms:.3f} ms", flush=True)
    ms = chip_smoke.time_cuda(torch, lambda: distance.expand23(P2, out=P3), 5)
    print(f"parts: expand23 of [{s}, {n}, 2] float32 on the card: {ms:.3f} ms", flush=True)
    geno_log, t_read = host(lambda: readers.read_geno(geno, True, True, False, n, s))
    P, t_exp = host(lambda: preprocess(geno_log, False, 0.0, 0.0))
    P32, t_cast = host(lambda: P.astype("float32"))
    host_t = torch.from_numpy(P32)
    ms = chip_smoke.time_cuda(torch, lambda: P3.copy_(host_t), 3)
    print(f"parts: staged route: read {t_read:.3f} s, exp {t_exp:.3f} s, float32 cast "
          f"{t_cast:.3f} s, copy of [{s}, {n}, 3] from pageable memory {ms:.3f} ms",
          flush=True)


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
    ap.add_argument("--runs", default=",".join(chip_smoke.RUNS),
                    help="the main-path runs to profile, separated by commas (default: all)")
    ap.add_argument("--sweep", action="store_true",
                    help="run (e) against the chunk length and the round checkpoint's parts")
    ap.add_argument("--parts", action="store_true",
                    help="the pieces of run (a)'s upload, each alone")
    ap.add_argument("--lookahead", action="store_true",
                    help="runs (g) and (h) with and without the lookahead of models 3-6")
    ap.add_argument("--compaction", action="store_true",
                    help="runs (g) and (h) with the class sums compacted and as three "
                         "weighted launches")
    opts = ap.parse_args()
    wanted = [r for r in opts.runs.split(",") if r]
    unknown = [r for r in wanted if r not in chip_smoke.RUNS]
    if unknown:
        ap.error(f"unknown runs {unknown}; known: {', '.join(chip_smoke.RUNS)}")
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
        chip_smoke.write_pos_files()
        with open(opts.out, "w") as report:
            report.write(chip_smoke.card_line() + "\n")
            for run, (kind, *_) in chip_smoke.RUNS.items():
                if run not in wanted:
                    continue
                args = chip_smoke.run_args(run, genos[run], os.path.join(work, f"{run}.dist"))
                with chip_smoke.environment(run_env(run)):
                    profile_run(torch, cli, f"{run}_{kind}", args + ["--platform", "cuda"],
                                report)
        if opts.lookahead:
            lookahead(torch, cli, genos, work)
        if opts.compaction:
            compaction(torch, cli, genos, work)
        if opts.parts:
            parts(torch, genos["a"])
        if opts.sweep:
            sweep(torch, cli, genos["e"], work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
