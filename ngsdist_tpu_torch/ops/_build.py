"""Build and load the port's CUDA kernels.

Every `.cu` file in `ngsdist_tpu_torch/csrc/` is compiled by `nvcc`
for `sm_90a` (one nvcc process a file, all started together) and linked
into ONE shared library with a plain C interface, loaded with ctypes.
The build runs at first use, from the sources in the checkout, into
`ngsdist_tpu_torch/_build/` (utils/buildlib.py, which the native host
runtime shares): the library's name carries a hash of
the sources and flags, so a stale library is never loaded, and it is
compiled under a temporary name and renamed into place.  The compiler's
report (registers, shared memory, spills from `-Xptxas -v`) is kept
beside the library as `<name>.log`.

Nothing here runs at import time, and there is no fallback: a missing
`nvcc`, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import glob
import math
import os
import shutil
import threading

import torch

from ..utils import buildlib
from ..utils.buildlib import BUILD_DIR, CSRC_DIR  # noqa: F401  (callers read them here)

# No --use_fast_math: exp and log feed the EM's convergence test.  nvcc
# contracts a*b+c into FMA by default, which the stated tolerances cover.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Path of the library built from the current sources and flags."""
    return buildlib.hashed_path("libngsdist_kernels", NVCC_FLAGS, _sources())


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of ngsdist_tpu_torch are built from source at "
            "first use")
    return found


def _build(path: str) -> None:
    """One nvcc per `.cu` file, all started together, then one link."""
    buildlib.compile_into(path, [_nvcc(), *NVCC_FLAGS],
                          [s for s in _sources() if s.endswith(".cu")])


def _configure(lib: ctypes.CDLL) -> None:
    vp, i64, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    # each entry in float32 and float64: the same arguments, pointers to
    # the one type or the other
    for t in ("f32", "f64"):
        for name, args in (
                ("indep_raw_cnt", [vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i64, vp, i32, vp]),
                ("indep_block_partials", [vp, vp, i32, i64, i64, vp, i32, vp]),
                ("em_raw_cnt", [vp, vp, vp, vp, i64, vp, vp, i64, i32, vp, f64, i32, i32, vp, vp]),
                ("em_raw_cnt_rows", [vp, vp, i32, vp, vp, i64, i32, vp, f64, i32, i32, vp, vp]),
                ("em_blocks_per_sm", [ctypes.POINTER(i32)]),
                ("em_rows_blocks_per_sm", [ctypes.POINTER(i32)]),
                ("em_block_partials", [vp, vp, vp, i32, i64, i64, vp, f64, i32, vp])):
            fn = getattr(lib, f"ngsd_{name}_{t}")
            fn.argtypes, fn.restype = args, i32
        # csrc/hmm.cu: q, alpha, e, d and its chain stride, the outputs
        # (forward, backward: messages, logliks; Viterbi: back-pointer
        # scratch, path, best), the scratch, B, S, K, the segment length,
        # the stream
        scan = [vp, vp, vp, vp, i64, vp, vp, vp, i32, i64, i32, i64, vp]
        for name, args in (("hmm_forward", scan), ("hmm_backward", scan),
                           ("hmm_viterbi", [vp, vp, vp, vp, i64, vp, vp, vp, vp, i32, i64, i32,
                                            i64, vp])):
            fn = getattr(lib, f"ngsd_{name}_{t}")
            fn.argtypes, fn.restype = args, i32
    lib.ngsd_em_weight_rows.argtypes, lib.ngsd_em_weight_rows.restype = [], i32
    lib.ngsd_error_string.argtypes = [i32]
    lib.ngsd_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _configure(lib)
            _lib = lib
        return _lib


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().ngsd_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def check_probs(P: torch.Tensor) -> None:
    """The kernels take a contiguous float32 or float64 [S, N, 3] tensor
    on a card; each type has entries of its own (`entry`)."""
    if P.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {P.device}")
    if P.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected float32 or float64 probabilities, got {P.dtype}")
    if P.ndim != 3 or P.shape[2] != 3 or P.shape[1] < 1:
        raise ValueError(f"expected probabilities of shape [S, N, 3], got {tuple(P.shape)}")
    if not P.is_contiguous():
        raise ValueError("expected contiguous probabilities")


def check_blocks(P: torch.Tensor, n_blocks: int, block_size: int) -> None:
    """The sites of P are n_blocks bootstrap blocks of block_size."""
    if block_size < 1 or n_blocks < 0 or P.shape[0] != n_blocks * block_size:
        raise ValueError(f"{P.shape[0]} sites are not {n_blocks} blocks of {block_size}")


def check_tiles(tiles: torch.Tensor, P: torch.Tensor) -> None:
    """A tile list is a contiguous int32 vector on P's card."""
    if (tiles.device != P.device or tiles.dtype != torch.int32 or tiles.ndim != 1
            or not tiles.is_contiguous()):
        raise ValueError("tiles must be a contiguous int32 vector on P's device")


def upper_tile(k: int):
    """Upper tile k -> (ti, tj), ti <= tj: k = tj (tj + 1) / 2 + ti, the
    kernels' enumeration (csrc/common.cuh ngsd::upper_tile)."""
    tj = (math.isqrt(8 * k + 1) - 1) // 2
    return k - tj * (tj + 1) // 2, tj


def tile_mask(N: int, tiles, edge: int, strict: bool) -> torch.Tensor:
    """[N, N] bool: the entries a kernel writes for the listed upper tiles
    of edge x edge: those of the tiles that lie on the upper triangle
    (strict: off the diagonal)."""
    nt = -(-N // edge)
    hit = torch.zeros((nt, nt), dtype=torch.bool)
    for k in torch.as_tensor(tiles).reshape(-1).tolist():
        hit[upper_tile(int(k))] = True
    m = hit.repeat_interleave(edge, 0).repeat_interleave(edge, 1)[:N, :N]
    return m & torch.ones((N, N), dtype=torch.bool).triu(1 if strict else 0)


def entry(name: str, P: torch.Tensor):
    """The library's entry `name` for P's dtype: ngsd_<name>_f32 for
    float32, ngsd_<name>_f64 for float64 (check_probs has admitted no
    other).  A float64 tensor never reaches a float32 entry."""
    return getattr(library(), f"ngsd_{name}_{'f64' if P.dtype == torch.float64 else 'f32'}")


def weights_of(site_weights, P: torch.Tensor, n_sites=None):
    """[n_sites] (P's sites by default) weights in P's dtype on P's
    device, or None.  Bootstrap multiplicities and class masks are
    integers below 2^24, exact in either type."""
    if site_weights is None:
        return None
    n = P.shape[0] if n_sites is None else n_sites
    w = torch.as_tensor(site_weights, dtype=P.dtype, device=P.device).contiguous()
    if w.shape != (n,):
        raise ValueError(f"site_weights must have shape ({n},), got {tuple(w.shape)}")
    return w


def score9(score, P: torch.Tensor) -> ctypes.Array:
    """Host copy of the 3x3 score matrix in P's dtype: float32[9] for the
    f32 entries, float64[9] for the f64 ones."""
    vals = torch.as_tensor(score, dtype=torch.float64).reshape(-1).tolist()
    if len(vals) != 9:
        raise ValueError("score must have 9 entries")
    ctype = ctypes.c_double if P.dtype == torch.float64 else ctypes.c_float
    return (ctype * 9)(*vals)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
