#!/usr/bin/env python3
"""The float32 kernel entries of this checkout against those of another
source tree, on one NVIDIA card: machine code and time.

Run from the root of a checkout, naming the other tree's kernel sources
(for example an unpacked `git archive` of an earlier commit):

    python3 profile_f32_parity.py OTHER/ngsdist_tpu_torch/csrc

Builds both libraries with the port's nvcc flags (both builds started
together), dumps their machine code with cuobjdump and compares the
float32 kernels function by function (and names those that only one
tree has): each kernel's SASS instructions,
with addresses and encodings left out, under its demangled name with a
`float` template argument dropped (a kernel that became a template on
its input type keeps its float32 code under the new name).  Then times
the f32 entries of both at chip_smoke.py's shapes (indep 1024 x 65,536
--pairwise_del, the EM 1024 x 16,384) with CUDA events, in turns
(other, this, this, other), and checks that both give the same bytes.
Prints one line per kernel family and per timing, and the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import subprocess
import sys

import numpy as np

import chip_smoke


def build(nvcc: str, flags, csrc: str, out: str):
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", out, *sources],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernel_name(demangled: str) -> str:
    """A demangled kernel's name and template arguments, without its
    namespace, return type and parameter list."""
    name = demangled.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    name = name[len("void "):] if name.startswith("void ") else name
    depth = 0
    for i in range(len(name) - 1, -1, -1):  # the parentheses that close at the end
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(":
            return name[:i]
    return name


def sass_by_kernel(nvcc: str, lib: str) -> dict:
    """{demangled name without its parameters and a `float` template
    argument: [instructions]} of the float32 kernels (every kernel whose
    name and template arguments hold neither `double` nor `_f64`)."""
    bindir = os.path.dirname(nvcc)
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "--dump-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = kernel_name(subprocess.run([os.path.join(bindir, "cu++filt"), mangled],
                                              capture_output=True, text=True,
                                              check=True).stdout.strip())
            cur = None
            if "double" not in name and "_f64" not in name:
                name = re.sub(r"<float, ?", "<", name).replace("<float>", "")
                cur = out.setdefault(name, [])
            continue
        if cur is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if m:
                cur.append(m.group(1))
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print("usage: profile_f32_parity.py OTHER_CSRC_DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_f32_parity: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.ROOT)
    from ngsdist_tpu_torch.ops import _build, em, indep

    card = chip_smoke.card_line()
    print(card, flush=True)
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out_dir = os.path.join(chip_smoke.ROOT, "profiles")
    os.makedirs(out_dir, exist_ok=True)
    libs = {"other": os.path.join(out_dir, "f32_parity_other.so"),
            "this": os.path.join(out_dir, "f32_parity_this.so")}
    procs = {"other": build(nvcc, flags, sys.argv[1], libs["other"]),
             "this": build(nvcc, flags, _build.CSRC_DIR, libs["this"])}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log[-4000:]}")
    sass = {k: sass_by_kernel(nvcc, path) for k, path in libs.items()}
    for k, other in (("this", "other"), ("other", "this")):
        for name in sorted(set(sass[k]) - set(sass[other])):
            print(f"{name}: only in {k} ({len(sass[k][name])} instructions)", flush=True)
    for name in sorted(set(sass["this"]) & set(sass["other"])):
        a, b = sass["other"][name], sass["this"][name]
        print(f"{name}: {len(b)} instructions, "
              + ("SASS identical" if a == b else f"SASS DIFFERS ({len(a)} against {len(b)})"),
              flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    P = torch.from_numpy(chip_smoke.rand_probs(rng, chip_smoke.INDEP_SITES, chip_smoke.N_IND)
                         .astype(np.float32)).to(dev)
    score = _build.score9(chip_smoke.SCORE9, P)
    runs = {}
    for k, path in libs.items():
        lib = ctypes.CDLL(path)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ngsd_indep_raw_cnt_f32.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i64,
                                               vp, i32, vp]
        # a library with the occupancy query takes the site slices and
        # their scratch (one slice, none) before the stream
        sliced = hasattr(lib, "ngsd_em_blocks_per_sm_f32")
        lib.ngsd_em_raw_cnt_f32.argtypes = [vp, vp, vp, vp, i64, vp, vp, i64, i32, vp,
                                            ctypes.c_double, i32,
                                            *((i32, vp) if sliced else ()), vp]
        lib.ngsd_indep_raw_cnt_f32.restype = lib.ngsd_em_raw_cnt_f32.restype = i32

        def indep_call(lib=lib):
            S, N = P.shape[:2]
            chunks, chunk_sites = indep.split_plan(N, S)
            raw = torch.zeros((N, N), device=dev)
            cnt = torch.zeros_like(raw)
            scratch = torch.empty(indep.scratch_shape(N, S), dtype=torch.float64, device=dev)
            _build.check_launch(lib.ngsd_indep_raw_cnt_f32(
                _build.ptr(P), None, _build.ptr(raw), _build.ptr(cnt), _build.ptr(scratch), None,
                0, S, N, chunks, chunk_sites, score, 1, _build.stream(dev)), "indep")
            return raw, cnt

        Pe = P[:chip_smoke.EM_SITES].contiguous()

        def em_call(lib=lib, one_slice=(1, None) if sliced else ()):
            S, N = Pe.shape[:2]
            raw = torch.zeros((N, N), device=dev)
            cnt = torch.zeros_like(raw)
            _build.check_launch(lib.ngsd_em_raw_cnt_f32(
                _build.ptr(Pe), None, None, None, 0, _build.ptr(raw), _build.ptr(cnt), S, N,
                score, float(np.exp(em.EM_TOLE)), 0, *one_slice, _build.stream(dev)), "em")
            return raw, cnt

        runs[k] = {"indep": indep_call, "em": em_call}
    for kind in ("indep", "em"):
        same = all(chip_smoke.same_bytes(torch, a, b) for a, b in zip(
            runs["other"][kind](), runs["this"][kind]()))
        reps = 5 if kind == "indep" else 3
        ms = [(k, chip_smoke.time_cuda(torch, runs[k][kind], reps))
              for k in ("other", "this", "this", "other")]
        print(f"{kind} f32 entry: " + ", ".join(f"{k} {t:.3f} ms" for k, t in ms)
              + f"; outputs {'byte-identical' if same else 'DIFFER'} [{card}]", flush=True)
        if not same:
            raise AssertionError(f"{kind}: the two libraries' outputs differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
