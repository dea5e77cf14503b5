#!/usr/bin/env python3
"""Where the time of the EM kernel (ngsdist_tpu_torch/csrc/em.cu) goes,
on one NVIDIA card.

Run from the root of a checkout:

    python3 profile_em_parts.py

Builds the kernel's source as it stands and with each of its parts taken
out by the source's NGSD_EM_SKIP_* switches (the tables built at the
first step only; the search skipped; the contraction skipped), all
builds started together, and times each at chip_smoke.py's EM shape
(1024 individuals x 16,384 sites, seeded) with CUDA events, full mode
and block mode.  A variant with a part taken out computes wrong values:
only its time is read.  The whole kernel's result is held against the
library the port builds (byte-identical) before anything is timed.
Prints one line per variant and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

import chip_smoke

VARIANTS = {
    "whole": [],
    "no build": ["-DNGSD_EM_SKIP_BUILD=1"],
    "no search": ["-DNGSD_EM_SKIP_SEARCH=1"],
    "no contraction": ["-DNGSD_EM_SKIP_CONTRACT=1"],
    "search only": ["-DNGSD_EM_SKIP_BUILD=1", "-DNGSD_EM_SKIP_CONTRACT=1"],
    "build only": ["-DNGSD_EM_SKIP_SEARCH=1", "-DNGSD_EM_SKIP_CONTRACT=1"],
    "contraction only": ["-DNGSD_EM_SKIP_BUILD=1", "-DNGSD_EM_SKIP_SEARCH=1"],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_em_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.ROOT)
    from ngsdist_tpu_torch.ops import _build, em

    card = chip_smoke.card_line()
    print(card, flush=True)
    out_dir = os.path.join(_build.BUILD_DIR, "em_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "em.cu")
    builds = {}
    for name, defs in VARIANTS.items():
        path = os.path.join(out_dir, name.replace(" ", "_") + ".so")
        builds[name] = (path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *defs, "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    dev = torch.device("cuda")
    S, N = chip_smoke.EM_SITES, chip_smoke.N_IND
    nb, bs = S // chip_smoke.EM_BOOT_BLOCK, chip_smoke.EM_BOOT_BLOCK
    P32 = torch.from_numpy(chip_smoke.rand_probs(
        np.random.default_rng(chip_smoke.SEED), S, N).astype(np.float32)).to(dev)
    hi = float(np.exp(em.EM_TOLE))
    score = _build.score9(chip_smoke.SCORE9, P32)
    raw, cnt = torch.zeros((N, N), device=dev), torch.zeros((N, N), device=dev)
    B = torch.empty((nb, N * (N - 1) // 2), dtype=torch.float64, device=dev)
    C = torch.empty_like(B)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

    for name, (path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        lib = ctypes.CDLL(path)
        lib.ngsd_em_raw_cnt_f32.argtypes = [vp, vp, vp, vp, i64, vp, vp, i64, i32, vp,
                                            ctypes.c_double, i32, i32, vp, vp]
        lib.ngsd_em_block_partials_f32.argtypes = [vp, vp, vp, i32, i64, i64, vp,
                                                   ctypes.c_double, i32, vp]
        lib.ngsd_em_raw_cnt_f32.restype = lib.ngsd_em_block_partials_f32.restype = i32

        def full():
            _build.check_launch(
                lib.ngsd_em_raw_cnt_f32(_build.ptr(P32), None, None, None, 0, _build.ptr(raw),
                                        _build.ptr(cnt), S, N, score, hi, 0, 1, None,
                                        _build.stream(dev)), f"em ({name})")

        def blocks():
            _build.check_launch(
                lib.ngsd_em_block_partials_f32(_build.ptr(P32), _build.ptr(B), _build.ptr(C), N,
                                               nb, bs, score, hi, 0, _build.stream(dev)),
                f"em block partials ({name})")

        if name == "whole":
            full()
            want = em.em_raw_cnt(P32, chip_smoke.SCORE9, False)
            if not all(chip_smoke.same_bytes(torch, a, b) for a, b in zip((raw, cnt), want)):
                raise AssertionError("the whole variant differs from the port's library")
        ms_full = chip_smoke.time_cuda(torch, full, 3)
        ms_blocks = chip_smoke.time_cuda(torch, blocks, 3)
        print(f"em {N} x {S}, {name}: {ms_full:.3f} ms; block mode ({nb} blocks of {bs}): "
              f"{ms_blocks:.3f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
