"""ctypes loader for the port's native host runtime library.

The native library (csrc/host/ngsdist_native.c, taus.h) carries the
host-side runtime: exact gz/TSV/binary readers, glibc-backed elementwise
transforms, the bootstrap index stream, the phylip matrix formatter and
the per-site EM of the verbose >= 8 dump.  It is compiled with the host
C compiler the first time it is requested, into
`ngsdist_tpu_torch/_build/` beside the CUDA kernels' library
(utils/buildlib.py: a name keyed by a hash of the sources and flags,
compiled under a temporary name and renamed into place, so concurrent
processes on a fresh checkout never load a half-written file).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from . import buildlib

HOST_SRC_DIR = os.path.join(buildlib.CSRC_DIR, "host")
SOURCES = [os.path.join(HOST_SRC_DIR, "ngsdist_native.c"),
           os.path.join(HOST_SRC_DIR, "taus.h")]

# -ffp-contract=off: the bit-exact host transforms must not fuse a*b+c
# into FMA.
CFLAGS = ["-O2", "-Wall", "-Wextra", "-fPIC", "-ffp-contract=off",
          "-fvisibility=hidden"]
LDLIBS = ["-lz", "-lpthread", "-lm"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_c_dp = ctypes.POINTER(ctypes.c_double)
_c_fp = ctypes.POINTER(ctypes.c_float)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_u64p = ctypes.POINTER(ctypes.c_uint64)


def _cc() -> str:
    cc = os.environ.get("CC") or "gcc"
    found = shutil.which(cc) or shutil.which("cc")
    if not found:
        raise RuntimeError(
            f"no C compiler found ({cc!r}, cc): the native host runtime of "
            "ngsdist_tpu_torch is built from source at first use")
    return found


def library_path() -> str:
    """Path of the library built from the current sources and flags."""
    return buildlib.hashed_path("libngsdist_native", CFLAGS + LDLIBS, SOURCES)


def _configure(lib: ctypes.CDLL) -> None:
    lib.nd_boot_block_indices.argtypes = [ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64, _c_u64p]
    lib.nd_boot_block_indices.restype = None
    lib.nd_taus_uniforms.argtypes = [ctypes.c_uint32, ctypes.c_uint64, _c_dp]
    lib.nd_taus_uniforms.restype = None
    lib.nd_exp_array.argtypes = [_c_dp, ctypes.c_int64]
    lib.nd_exp_array.restype = None
    lib.nd_log_array.argtypes = [_c_dp, ctypes.c_int64]
    lib.nd_log_array.restype = None
    lib.nd_fill_array.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_double]
    lib.nd_fill_array.restype = None
    lib.nd_postprob3.argtypes = [_c_dp, ctypes.c_int64]
    lib.nd_postprob3.restype = None
    lib.nd_call_geno3.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double]
    lib.nd_call_geno3.restype = ctypes.c_int
    lib.nd_read_geno.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, _c_dp, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno.restype = ctypes.c_int
    lib.nd_spill_text_geno.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_spill_text_geno.restype = ctypes.c_int
    lib.nd_read_text_range.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _c_dp, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_text_range.restype = ctypes.c_int
    lib.nd_normalize_triples.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.nd_normalize_triples.restype = ctypes.c_int
    lib.nd_read_geno_pack23.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _c_fp, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno_pack23.restype = ctypes.c_int
    lib.nd_read_geno_pack16.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno_pack16.restype = ctypes.c_int
    lib.nd_read_geno_codes.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno_codes.restype = ctypes.c_int
    lib.nd_format_matrix10f.argtypes = [
        _c_dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, _c_i64p,
    ]
    lib.nd_format_matrix10f.restype = ctypes.c_int
    lib.nd_pair_dists.argtypes = [
        _c_dp, ctypes.c_int64, ctypes.c_int64, _c_i64p, ctypes.c_int64,
        _c_dp, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, _c_dp, _c_dp, _c_dp,
    ]
    lib.nd_pair_dists.restype = ctypes.c_int
    lib.nd_em2_site_run.argtypes = [_c_dp, _c_dp, _c_dp]
    lib.nd_em2_site_run.restype = None


def get_lib() -> ctypes.CDLL:
    """Return the loaded native library, building it if necessary."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                buildlib.compile_into(
                    path, [_cc(), *CFLAGS], [SOURCES[0]], LDLIBS)
            lib = ctypes.CDLL(path)
            _configure(lib)
            _lib = lib
    return _lib


def have_native() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


def as_double_ptr(a: np.ndarray):
    assert a.dtype == np.float64 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_dp)


def as_float_ptr(a: np.ndarray):
    assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_fp)


def as_uint8_ptr(a: np.ndarray):
    assert a.dtype == np.uint8 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def as_uint16_ptr(a: np.ndarray):
    assert a.dtype == np.uint16 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def as_i64_ptr(a: np.ndarray):
    assert a.dtype == np.int64 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_i64p)


def as_u64_ptr(a: np.ndarray):
    assert a.dtype == np.uint64 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_u64p)
