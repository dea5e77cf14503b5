#!/usr/bin/env python3
"""Where the time of the float64 indep kernel (K1d, `indep_f64_kernel` in
ngsdist_tpu_torch/csrc/indep.cu) goes, on one NVIDIA card, and how fast
the card's FP64 tensor cores run each `mma.sync` shape.

Run from the root of a checkout:

    python3 profile_indep_parts.py

Builds indep.cu as it stands and with parts of K1d taken out by the
source's NGSD_INDEP_F64_SKIP_* switches (MMA: no tensor-core
instruction, the fragments still loaded; FOLD: the staged values stored
as they are, no mask, weight or score; LOAD: nothing copied from device
memory), all builds started together, and times each at chip_smoke.py's
indep shape (1024 individuals x 65,536 sites, --pairwise_del, seeded on
the card) with CUDA events, full mode and block mode (64 blocks of
1024 sites).  A variant with a part taken out computes wrong values:
only its time is read.  The whole kernel's results, both modes, are held
byte for byte against the library the port builds before anything is
timed.

Then the rate loop: every SM runs warps of independent float64 MMAs of
one shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16), operands in registers,
and the achieved TFLOP/s of each is printed beside the published 67.
And whether the FP64 units' own arithmetic (the fold's DFMAs) overlaps
the FP64 MMAs: independent DFMA chains alone, beside m16n8k4, k8 and k16
MMAs in every warp, and in warps of their own on the same SM
sub-partitions.

Prints ptxas's lines for K1d, the instructions of the main loop of its
instantiation that the timings run (unweighted, pairwise deletion,
16-byte copies) by opcode, one line per variant and shape, and the
card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys

import chip_smoke

VARIANTS = {
    "whole": [],
    "no mma": ["MMA"],
    "no fold": ["FOLD"],
    "no load": ["LOAD"],
    "mma only": ["FOLD", "LOAD"],
    "fold only": ["MMA", "LOAD"],
    "load only": ["MMA", "FOLD"],
}

# (name, M, N, K, D, A, B registers of float64 per thread)
SHAPES = (("m8n8k4", 8, 8, 4, 2, 1, 1), ("m16n8k4", 16, 8, 4, 4, 2, 1),
          ("m16n8k8", 16, 8, 8, 4, 4, 2), ("m16n8k16", 16, 8, 16, 4, 8, 4))
RATE_DFMA = 8       # with the overlap test: DFMA chains beside each accumulator
RATE_ACC = 8        # independent accumulators a warp keeps in flight
RATE_BLOCKS = 4     # blocks of 4 warps per SM
RATE_ITERS = 4096


def rate_source() -> str:
    """CUDA source of the rate loop: one kernel per shape, each warp
    issuing RATE_ACC independent MMAs RATE_ITERS times."""
    fns = []
    for i, (name, M, N, K, nd, na, nb) in enumerate(SHAPES):
        regs = [f"%{j}" for j in range(nd + na + nb)]
        d, a, b = regs[:nd], regs[nd:nd + na], regs[nd + na:]
        ops = ", ".join(f'"+d"(d[{j}])' for j in range(nd))
        ins = ", ".join([f'"d"(a[{j}])' for j in range(na)] + [f'"d"(b[{j}])' for j in range(nb)])
        fns.append(f"""
__device__ __forceinline__ void mma{i}(double* d, const double* a, const double* b) {{
  asm("mma.sync.aligned.{name}.row.col.f64.f64.f64.f64 {{{','.join(d)}}}, {{{','.join(a)}}}, "
      "{{{','.join(b)}}}, {{{','.join(d)}}};\\n" : {ops} : {ins});
}}""")
    # kernel n: m16n8k4 with DFMA chains beside it in every warp; n + 1: the
    # chains alone; n + 2: half the blocks, of 8 warps, the first 4 running
    # the m16n8k4 and the last 4 the chains (warp w runs on SM sub-partition
    # w % 4, so each sub-partition holds warps of both); n + 3, n + 4:
    # m16n8k8, m16n8k16 with the chains beside them in every warp
    n = len(SHAPES)
    cases = "\n".join(f"    case {i}: rate<{i}><<<blocks, 128, 0, st>>>(out, iters, seed); break;"
                      for i in (*range(n + 2), n + 3, n + 4))
    cases += (f"\n    case {n + 2}: rate<{n + 2}><<<blocks / 2, 256, 0, st>>>(out, iters, seed);"
              " break;")
    calls = "\n".join(f"      if (S == {i}) mma{i}(d[j], a, b);" for i in range(n))
    calls += f"""
      if (S == {n} || (S == {n + 2} && mma_block)) mma1(d[j], a, b);
      if (S == {n + 3}) mma2(d[j], a, b);
      if (S == {n + 4}) mma3(d[j], a, b);
      if (S == {n} || S == {n + 1} || (S == {n + 2} && !mma_block) || S > {n + 2})
        for (int q = 0; q < {RATE_DFMA}; ++q) e[j][q] = fma(e[j][q], a[q], b[q % 4]);"""
    return f"""#include <cuda_runtime.h>
{''.join(fns)}
template <int S>
__global__ void __launch_bounds__(256) rate(double* out, long long iters, double seed) {{
  double a[8], b[4], d[{RATE_ACC}][4], e[{RATE_ACC}][{RATE_DFMA}] = {{}};
  for (int i = 0; i < 8; ++i) a[i] = seed * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = seed * (blockIdx.x + i);
  for (int j = 0; j < {RATE_ACC}; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0;
  const bool mma_block = threadIdx.x < 128;
  for (long long it = 0; it < iters; ++it) {{
#pragma unroll
    for (int j = 0; j < {RATE_ACC}; ++j) {{
{calls}
    }}
  }}
  double s = 0.0;
  for (int j = 0; j < {RATE_ACC}; ++j) {{
    s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
    for (int q = 0; q < {RATE_DFMA}; ++q) s += e[j][q];
  }}
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}}

extern "C" int ngsd_dmma_rate(int shape, double* out, int blocks, long long iters, double seed,
                              void* stream) {{
  cudaStream_t st = (cudaStream_t)stream;
  switch (shape) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
  return (int)cudaGetLastError();
}}
"""


def ptxas_lines(log: str, kernel: str):
    """ptxas's register and spill lines of the kernels whose name holds
    `kernel`."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def loop_opcodes(nvcc: str, lib: str, kernels) -> collections.Counter:
    """Opcodes (without their suffixes) of the longest loop, the span
    from a backward branch's target to the branch, in the machine code of
    the kernel whose mangled name holds one of `kernels`."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "--dump-sass",
                           lib], capture_output=True, text=True, check=True).stdout
    ins, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            if ins:
                break
            inside = any(k in line for k in kernels)
        elif inside:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*)", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = [(int(t.group(1), 16), a) for a, op, rest in ins if op == "BRA"
             for t in [re.search(r"0x([0-9a-f]+)", rest)] if t and int(t.group(1), 16) < a]
    lo, hi = max(loops, key=lambda x: x[1] - x[0])
    return collections.Counter(op.split(".")[0] for a, op, _ in ins if lo <= a <= hi)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_indep_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.ROOT)
    from ngsdist_tpu_torch.ops import _build, indep

    card = chip_smoke.card_line()
    print(card, flush=True)
    out_dir = os.path.join(_build.BUILD_DIR, "indep_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "indep.cu")
    rate_src = os.path.join(out_dir, "dmma_rate.cu")
    with open(rate_src, "w") as fh:
        fh.write(rate_source())
    builds = {}
    for name, parts in {**VARIANTS, "rate": None}.items():
        path = os.path.join(out_dir, name.replace(" ", "_") + ".so")
        defs = [f"-DNGSD_INDEP_F64_SKIP_{p}=1" for p in parts or ()]
        builds[name] = (path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *defs, "-o", path,
             rate_src if parts is None else src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    dev = torch.device("cuda")
    S, N = chip_smoke.INDEP_SITES, chip_smoke.N_IND
    nb, bs = S // chip_smoke.INDEP_BOOT_BLOCK, chip_smoke.INDEP_BOOT_BLOCK
    P64 = chip_smoke.wide_probs(torch, S, N).double()
    score = _build.score9(chip_smoke.SCORE9, P64)
    chunks, chunk_sites = indep.split_plan(N, S)
    raw = torch.zeros((N, N), dtype=torch.float64, device=dev)
    cnt = torch.zeros_like(raw)
    shape = indep.scratch_shape(N, S)
    scratch = None if shape is None else torch.empty(shape, dtype=torch.float64, device=dev)
    part = torch.empty(indep.block_partials_shape(N, nb), dtype=torch.float64, device=dev)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    want_full = indep.indep_raw_cnt(P64, chip_smoke.SCORE9, True)
    want_blocks = indep.indep_block_partials(P64, chip_smoke.SCORE9, True, nb, bs)

    for name, (path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        if name == "rate":
            continue
        if name == "whole":
            for line in ptxas_lines(log, "indep_f64_kernel"):
                print("  ptxas: " + line, flush=True)
            # <kWeighted, kPairwiseDel, kVec16>; the m8n8k4 kernel had no kVec16
            ops = loop_opcodes(_build._nvcc(), path, ("indep_f64_kernelILb0ELb1ELb1E",
                                                      "indep_f64_kernelILb0ELb1EE"))
            print(f"K1d main loop, unweighted, pairwise deletion, 16-byte copies: "
                  f"{sum(ops.values())} instructions a step: "
                  + ", ".join(f"{op} {n}" for op, n in ops.most_common()), flush=True)
        lib = ctypes.CDLL(path)
        full_fn, block_fn = lib.ngsd_indep_raw_cnt_f64, lib.ngsd_indep_block_partials_f64
        full_fn.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i64, vp, i32, vp]
        block_fn.argtypes = [vp, vp, i32, i64, i64, vp, i32, vp]
        full_fn.restype = block_fn.restype = i32

        def full():
            _build.check_launch(full_fn(
                _build.ptr(P64), None, _build.ptr(raw), _build.ptr(cnt), _build.ptr(scratch),
                None, 0, S, N, chunks, chunk_sites, score, 1, _build.stream(dev)),
                f"indep f64 ({name})")

        def blocks():
            _build.check_launch(block_fn(_build.ptr(P64), _build.ptr(part), N, nb, bs, score, 1,
                                         _build.stream(dev)), f"indep f64 blocks ({name})")

        if name == "whole":
            full()
            blocks()
            I, J = torch.triu_indices(N, N, offset=1, device=dev)
            got_blocks = part[:2].reshape(2, nb, -1)[:, :, indep.tile_offsets(N, I, J)]
            same = all(chip_smoke.same_bytes(torch, a, b) for a, b in zip((raw, cnt), want_full))
            same &= all(chip_smoke.same_bytes(torch, got_blocks[k], want_blocks[k])
                        for k in range(2))
            if not same:
                raise AssertionError("the whole variant differs from the port's library")
        ms_full = chip_smoke.time_cuda(torch, full, 5)
        ms_blocks = chip_smoke.time_cuda(torch, blocks, 5)
        print(f"indep f64 {N} x {S} pairwise_del, {name}: {ms_full:.3f} ms; block mode "
              f"({nb} blocks of {bs}): {ms_blocks:.3f} ms [{card}]", flush=True)
    del P64, scratch, part
    torch.cuda.empty_cache()

    lib = ctypes.CDLL(builds["rate"][0])
    lib.ngsd_dmma_rate.argtypes = [i32, vp, i32, i64, ctypes.c_double, vp]
    lib.ngsd_dmma_rate.restype = i32
    grid = RATE_BLOCKS * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(grid * 128, dtype=torch.float64, device=dev)
    for i, (name, M, N_, K, *_rest) in enumerate(SHAPES):
        def go():
            _build.check_launch(lib.ngsd_dmma_rate(i, _build.ptr(out), grid, RATE_ITERS, 1e-3,
                                                   _build.stream(dev)), f"dmma rate {name}")
        ms = chip_smoke.time_cuda(torch, go, 5)
        flop = 2.0 * M * N_ * K * RATE_ACC * RATE_ITERS * grid * 4
        print(f"dmma rate {name}: {flop / ms / 1e9:.3f} TFLOP/s ({ms:.3f} ms for {flop:.4g} "
              f"flop; {grid} blocks of 4 warps, {RATE_ACC} independent accumulators a warp; "
              f"published FP64 tensor peak 67) [{card}]", flush=True)
    # do the FP64 units' DFMAs (the fold's arithmetic) overlap the FP64 MMAs?
    n = len(SHAPES)
    flop = 2.0 * RATE_DFMA * RATE_ACC * RATE_ITERS * grid * 128
    for i, what in ((n, "m16n8k4 and DFMA chains together in every warp"),
                    (n + 1, "the DFMA chains alone"),
                    (n + 2, "m16n8k4 and DFMA chains in warps of their own, half of each"),
                    (n + 3, "m16n8k8 and DFMA chains together in every warp"),
                    (n + 4, "m16n8k16 and DFMA chains together in every warp")):
        def go():
            _build.check_launch(lib.ngsd_dmma_rate(i, _build.ptr(out), grid, RATE_ITERS, 1e-3,
                                                   _build.stream(dev)), f"dmma rate {what}")
        ms = chip_smoke.time_cuda(torch, go, 5)
        print(f"dmma overlap, {what}: {ms:.3f} ms ({flop:.4g} DFMA flop, {flop / ms / 1e9:.3f} "
              f"TFLOP/s of them; each MMA loop alone is above) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
