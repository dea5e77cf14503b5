"""Readings that a cell's output limit is set from (gpubench/limits/).

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 \
        [--also float16] [--out FILE]

For each seed, on the card at the cell's own size, short runs of the
harness itself (run.py run_cell: set-up, a window that the first run
outlasts, and the check that judges it as a run judges its cut run):
- program: the program as the benchmark runs it; the largest d_err over
  a dozen seeds or more is the lower reading;
- control: the control that the cell's limits file names, in the
  program's place, through the same check: the reference computed in
  the precision below the one the cell states (checks/<check>.py
  `control`), or the program with the flag that states the precision
  dropped.  Each must read `correct` false; the smallest d_err is the
  upper reading.
`--also` adds a run of the reference control in another precision, for
comparison.  One JSON line per seed on standard output and in FILE.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench import cells  # noqa: E402
from gpubench.run import run_cell  # noqa: E402

WINDOW_S = 0.5


def _reading(result: dict, seconds: float) -> dict:
    return {"correct": result["correct"], "attempted": result["attempted"],
            "d_err": result["checks"]["d_err"]["value"],
            "checks": result["checks"], "seconds": round(seconds, 3)}


def controls(cell: cells.Cell, seed: int, device, also=()) -> dict:
    """{name: (the cell as the control runs it, the entry in the
    program's place or None)} of the control the limits file names, and
    of the reference in each precision of `also`."""
    import torch

    spec = cell.limits["control"]
    out = {}
    if spec["kind"] == "program":
        drop = set(spec["drop_args"])
        out["control"] = (cell.with_traffic(args=[a for a in cell.traffic["args"]
                                                  if a not in drop]), None)
    dtypes = [spec["dtype"]] if spec["kind"] == "reference" else []
    for k, name in enumerate(dtypes + list(also)):
        entry = cell.check.control(cell.config, cell.options, seed, getattr(torch, name),
                                   device)
        out["control" if k == 0 and dtypes else f"reference_{name}"] = (cell, entry)
    return out


def readings(cell: cells.Cell, seed: int, device, also=(), warm_up=True) -> dict:
    t = time.perf_counter()
    line = {"cell": cell.name, "seed": seed,
            "program": _reading(run_cell(cell, seed, WINDOW_S, False, device, t,
                                         warm_up=warm_up), time.perf_counter() - t)}
    for name, (c, entry) in controls(cell, seed, device, also).items():
        t = time.perf_counter()
        res = run_cell(c, seed, WINDOW_S, False, device, t, entry=entry, warm_up=False)
        line[name] = _reading(res, time.perf_counter() - t)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--also", default="", help="more precisions of the reference control")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(a.workload)
    also = [x for x in a.also.split(",") if x]
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        line = json.dumps(readings(cell, seed, torch.device("cuda", 0), also, warm_up=k == 0))
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
