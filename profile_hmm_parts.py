#!/usr/bin/env python3
"""Where the time of the HMM's scans (ngsdist_tpu_torch/csrc/hmm.cu) goes,
on one NVIDIA card.

Run from the root of a checkout:

    python3 profile_hmm_parts.py [--segments 512,1024,2048] [--root DIR] [--out FILE]

Times forward, backward and viterbi through ops/hmm.py _chains_cuda at
the popgen path's shape in chip_smoke.py (N_IND = 1024 chains x
POPGEN_SITES = 262,144 sites x K = 2; log emissions and distances 1..199
seeded on the card, q = (0.9, 0.1) and alpha = 1e-4 for every chain), in
float64 and float32: the call by CUDA events over 3 calls after a
warm-up, and each of its launches (forward and backward: transfer
matrices, start vectors, messages; viterbi: transfer matrices, start
vectors, back pointers, stitch, traceback) by torch.profiler over one
call, every hmm_*_kernel the profiler names.  One line per type, scan
and segment length (the wrapper's own is ops/hmm.py SEGMENT).

--root DIR times the ngsdist_tpu_torch package of another checkout (for
example the parent commit unpacked by `git archive`) on the same inputs,
so that two versions are compared within one call, in turns.

Prints the card's name and power limit first; --out also writes the
lines to FILE.
"""

from __future__ import annotations

import argparse
import re
import sys

import chip_smoke

KINDS = ("forward", "backward", "viterbi")


def inputs(torch, dt):
    """The popgen path's shape, seeded on the card: (q, alpha, e, d)."""
    B, S, dev = chip_smoke.N_IND, chip_smoke.POPGEN_SITES, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    e = torch.log(torch.rand((B, S, 2), dtype=dt, device=dev, generator=g) + 1e-3)
    d = torch.randint(1, 200, (S,), device=dev, generator=g).to(dt)
    q = torch.tensor(chip_smoke.POPGEN_Q, dtype=dt, device=dev).expand(B, 2).contiguous()
    a = torch.full((B,), chip_smoke.POPGEN_ALPHA, dtype=dt, device=dev)
    return q, a, e, d


def parts(torch, hmm, say, segments) -> None:
    """Per call and per launch, for each segment length."""
    for dt in (torch.float64, torch.float32):
        q, a, e, d = inputs(torch, dt)
        for kind in KINDS:
            for seg in segments:
                def call():
                    return hmm._chains_cuda(kind, q, a, e, d, segment=seg)

                ms = chip_smoke.time_cuda(torch, call, 3)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                got = {}
                for ev in prof.key_averages():
                    name = re.search(r"hmm_\w+?_kernel", ev.key)
                    if name:
                        us = getattr(ev, "device_time_total", None)
                        got[name.group(0)] = got.get(name.group(0), 0.0) + (
                            ev.cuda_time_total if us is None else us) / 1e3
                say(f"{str(dt)[6:]} {kind}, {tuple(e.shape)}, segments of {seg}: {ms:.3f} ms a "
                    "call; launches " + ", ".join(f"{k} {v:.3f} ms" for k, v in got.items()))
        del e
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", default="1024", help="segment lengths, comma-separated")
    ap.add_argument("--root", default=chip_smoke.ROOT,
                    help="the checkout whose ngsdist_tpu_torch is timed (default: this one)")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_hmm_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from ngsdist_tpu_torch.ops import hmm

    lines = []

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    say(f"{chip_smoke.card_line()}; package {hmm.__file__}")
    parts(torch, hmm, say, [int(x) for x in args.segments.split(",")])
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
