"""Distance-matrix output writer.

One phylip-style matrix per replicate appended to a single stream: a
leading blank line, the individual count, then one `label\\tv1\\t...\\tvn`
row per individual with values formatted exactly as C's printf %.10f
(including inf/nan spellings), matching reference ngsDist.cpp:282-287
and the join() formatter at shared/gen_func.cpp:479-496.
"""

from __future__ import annotations

import math
from typing import IO, List, Optional, Sequence

import numpy as np

from ..utils import native as _native


def fmt_c_double(v: float) -> str:
    """Format a double the way glibc printf("%.10f") does."""
    if math.isnan(v):
        return "-nan" if math.copysign(1.0, v) < 0 else "nan"
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    return f"{v:.10f}"


def _format_rows_native(matrix: np.ndarray) -> Optional[List[bytes]]:
    """Per-row b"\\tv1\\tv2..." byte runs via the threaded native glibc
    snprintf formatter (nd_format_matrix10f), much faster than the
    pure-Python path and byte-identical by construction (snprintf IS
    printf).  None
    when the native library is unavailable."""
    if not _native.have_native():
        return None
    import ctypes

    lib = _native.get_lib()
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    n, c = m.shape
    # %.10f of a double is at most ~320 chars (1e308); typical distances
    # fit in 13.  Start compact, retry wider on overflow.
    stride = 24 * c + 16
    while True:
        buf = np.empty((n * stride,), np.uint8)
        lens = np.zeros((n,), np.int64)
        ov = lib.nd_format_matrix10f(
            _native.as_double_ptr(m.reshape(-1)), n, c,
            buf.ctypes.data_as(ctypes.c_char_p), stride,
            _native.as_i64_ptr(lens),
        )
        if not ov:
            return [buf[i * stride: i * stride + int(lens[i])].tobytes()
                    for i in range(n)]
        stride *= 16


def write_dist_matrix(fh: IO[str], labels: Sequence[str], matrix: np.ndarray) -> None:
    n = len(labels)
    fh.write(f"\n{n}\n")
    rows = _format_rows_native(np.asarray(matrix)) if n else None
    if rows is not None:
        for i in range(n):
            fh.write(labels[i])
            fh.write(rows[i].decode("ascii"))
            fh.write("\n")
        return
    for i in range(n):
        row = "\t".join(fmt_c_double(float(v)) for v in matrix[i])
        fh.write(f"{labels[i]}\t{row}\n")


def format_dist_matrices(labels: Sequence[str], matrices: List[np.ndarray]) -> str:
    out: List[str] = []
    for m in matrices:
        n = len(labels)
        out.append(f"\n{n}\n")
        for i in range(n):
            row = "\t".join(fmt_c_double(float(v)) for v in m[i])
            out.append(f"{labels[i]}\t{row}\n")
    return "".join(out)
