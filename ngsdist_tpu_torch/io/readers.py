"""Input readers: genotype/GL/GP matrices, labels and positions.

The genotype reader follows the exact format semantics of the reference
(reference shared/read_data.cpp:13-116): three input styles
(binary site-major doubles; gzipped TSV probabilities; gzipped TSV hard
genotypes coded {-1,0,1,2}), single space/tab field splitting keeping
only numeric fields, last-N-columns selection (Beagle-style leading
columns ignored), header-line skipping, empty lines consuming a site as
missing, per-individual log-space normalization, and a strict EOF check.

The primary implementation is the native C reader (bit-exact glibc
log/exp); `read_geno(..., native=False)` selects a pure numpy fallback
whose results may differ from a C pipeline by 1 ulp in the last place.

Data model: site-major float64 array [n_sites, n_ind, 3] — the layout
the engine (core/distance.py) moves to the device.
"""

from __future__ import annotations

import gzip
import os
import re
import sys
from typing import List, Optional, Tuple

import numpy as np

from ..config import N_GENO, NgsDistError
from ..utils import native as _native

BIGNEG = 1.0e15  # log-space missing sentinel (reference INF, gen_func.hpp:15)
LINE_MAX = 500000

CODED_READS = 0  # read_geno_codes calls since the count was last set to 0
CODED_ROWS = 0   # the sites they read

# Numeric forms accepted by C strtod (and not Python-only forms such as
# digit underscores): decimal/exponent, hex floats, inf/nan.
_STRTOD_RE = re.compile(
    r"""^[+-]?(
        (\d+\.?\d*|\.\d+)([eE][+-]?\d+)? |
        0[xX]([0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)([pP][+-]?\d+)? |
        [iI][nN][fF]([iI][nN][iI][tT][yY])? |
        [nN][aA][nN]
    )$""",
    re.X,
)


def _open_text(path: str, func: str = "read_file"):
    if path == "-":
        return sys.stdin.buffer
    try:
        return (gzip.open(path, "rb") if path.endswith(".gz")
                else open(path, "rb"))
    except OSError as ex:
        # open_gzfile failure (gen_func.cpp:244-246): formatted fatal
        # error carrying errno for the CLI's perror("\t") suffix.
        raise NgsDistError(func, "cannot open file!", err=ex.errno or 0)


def _split_numeric(line: str) -> List[float]:
    out = []
    for tok in re.split(r"[ \t]", line):
        if tok and _STRTOD_RE.match(tok):
            out.append(float(tok))
    return out


def _chomp(s: str) -> str:
    """Strip exactly one trailing newline or carriage return."""
    if s and s[-1] in "\n\r":
        return s[:-1]
    return s


def read_geno(
    path: str,
    in_bin: bool,
    in_probs: bool,
    in_logscale: bool,
    n_ind: int,
    n_sites: int,
    native: bool = True,
    site_range: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Read a genotype/GL/GP file into [n_sites, n_ind, 3] log-space,
    per-individual normalized probabilities (always returns log scale,
    like the reference reader).

    site_range=(start, stop): read only that site interval (multi-host
    shard reading — each host loads its own range; binary inputs seek
    directly, text inputs stream past the skipped lines).  The strict
    EOF check only applies to a read that runs to the last site.  With
    the native reader a range holds the bits of the full read's rows
    (text: nd_read_text_range; binary: the bytes read here, normalized
    by nd_normalize_triples): the values a process reads do not depend
    on how the sites are split between processes.
    """
    if native and path == "-":
        # Stdin pipelines take the same threaded native parse as files
        # (nd_read_geno gzdopen's fd 0, mirroring the reference's
        # unified gz path, gen_func.cpp:208-223) — but only when
        # sys.stdin IS fd 0: tests and embedders that swap sys.stdin
        # for an in-memory stream fall back to the Python reader.
        try:
            native = sys.stdin.buffer.fileno() == 0 and not sys.stdin.closed
        except (AttributeError, OSError, ValueError):
            native = False
    if site_range is not None and (in_bin or not native):
        return _read_geno_py(
            path, in_bin, in_probs, in_logscale, n_ind, n_sites,
            site_range=site_range, native=native,
        )
    if native:
        import ctypes

        lib = _native.get_lib()
        start, stop = site_range if site_range is not None else (0, n_sites)
        out = np.empty((stop - start, n_ind, N_GENO), dtype=np.float64)
        errbuf = ctypes.create_string_buffer(256)
        # the reference's fatal reader errors carry strerror(errno) from
        # the perror suffix; the native reader aggregates the libm errno
        # (ERANGE underflow from one-hot/missing triples) its parse saw
        err = ctypes.c_int(0)
        if site_range is None:
            rc = lib.nd_read_geno(
                path.encode(), int(in_bin), int(in_probs), int(in_logscale),
                n_ind, n_sites, _native.as_double_ptr(out), errbuf, len(errbuf),
                ctypes.byref(err),
            )
        else:
            rc = lib.nd_read_text_range(
                path.encode(), int(in_probs), int(in_logscale), n_ind, n_sites,
                start, stop, _native.as_double_ptr(out), errbuf, len(errbuf),
                ctypes.byref(err),
            )
        if rc != 0:
            raise NgsDistError("read_geno", errbuf.value.decode(),
                               err=err.value)
        return out
    return _read_geno_py(path, in_bin, in_probs, in_logscale, n_ind, n_sites)


def read_geno_pack23(
    path: str,
    in_logscale: bool,
    n_ind: int,
    n_sites: int,
    site_range: Optional[Tuple[int, int]] = None,
    out: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Fused one-pass read of a RAW binary GP file: parse -> normalize
    -> exp -> float32 2-component pack, returning the upload-ready
    [rows, n_ind, 2] slab (p0, p1; the device restores p2 = 1 - p0 - p1,
    core/distance.py expand23; no sentinel rows — binary triples always
    normalize to sum 1).  The values are those of the staged
    read_geno -> preprocess pipeline cast to float32 (same libm calls in
    the same order, native nd_read_geno_pack23), in ONE pass over the
    data instead of three.  Returns None when the file is not raw
    seekable binary (gzip magic, stdin, pipe) — callers fall back to
    the staged path.  Reference arithmetic: read_data.cpp:29-47
    (read+normalize in one pass) + gen_func.cpp:123-130 (conv_space).

    out: a C-contiguous float32 [rows, n_ind, 2] array to fill instead
    of a new one (pinned memory, so that the native reader writes where
    the upload starts from)."""
    return _fused_pack_read("nd_read_geno_pack23", np.float32, _native.as_float_ptr,
                            path, in_logscale, n_ind, n_sites, site_range, out)


def read_geno_pack16(
    path: str,
    in_logscale: bool,
    n_ind: int,
    n_sites: int,
    site_range: Optional[Tuple[int, int]] = None,
    out: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Fused one-pass read of a RAW binary GP file into the uint16
    fixed-point slab [rows, n_ind, 2] of utils/hostmem.py pack16
    (q = rint(p · 65534), (65535, quantized mean) for a row the host
    finds missing): 4 bytes a triple against read_geno_pack23's 8, the
    bits of the staged read_geno -> preprocess -> pack16 route (the same
    libm calls; llrint rounds half to even as np.rint does; native
    nd_read_geno_pack16).  Returns None when the file is not raw seekable
    binary.  Reference arithmetic: read_data.cpp:29-47 +
    gen_func.cpp:123-130.  out: a C-contiguous uint16 [rows, n_ind, 2]
    array to fill instead of a new one (pinned memory)."""
    return _fused_pack_read("nd_read_geno_pack16", np.uint16, _native.as_uint16_ptr,
                            path, in_logscale, n_ind, n_sites, site_range, out)


def _fused_pack_read(entry: str, dtype, as_ptr, path: str, in_logscale: bool, n_ind: int,
                     n_sites: int, site_range: Optional[Tuple[int, int]],
                     out: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """One fused native read of sites site_range into a [rows, n_ind, 2]
    slab of `dtype` through the native `entry`; None for a source that is
    not raw seekable binary."""
    import ctypes

    if path == "-" or not _native.have_native():
        return None
    start, stop = site_range if site_range is not None else (0, n_sites)
    lib = _native.get_lib()
    if out is None:
        out = np.empty((stop - start, n_ind, 2), dtype=dtype)
    elif out.shape != (stop - start, n_ind, 2):
        raise ValueError(f"out has shape {out.shape}, the range needs "
                         f"{(stop - start, n_ind, 2)}")
    errbuf = ctypes.create_string_buffer(256)
    err = ctypes.c_int(0)
    rc = getattr(lib, entry)(
        path.encode(), int(in_logscale), n_ind, n_sites, start, stop,
        as_ptr(out), errbuf, len(errbuf), ctypes.byref(err),
    )
    if rc == 2:
        return None
    if rc != 0:
        raise NgsDistError("read_geno", errbuf.value.decode(),
                           err=err.value)
    return out


def read_geno_codes(
    path: str,
    in_logscale: bool,
    n_ind: int,
    n_sites: int,
    site_range: Optional[Tuple[int, int]] = None,
    out: Optional[np.ndarray] = None,
) -> Optional[Tuple[np.ndarray, bool]]:
    """Fused one-pass read of a RAW binary GP file under default-threshold
    --call_geno: parse -> normalize -> call -> one uint8 code per (site,
    individual), returning (codes [rows, n_ind], any_missing).  With
    N_thresh = call_thresh = 0 every triple calls to a one-hot at its
    log-space first argmax (codes 0-2) or, all three equal, to the
    uniform exp(log(1/3)) (code 3), so the tensor is the code plane and
    utils/hostmem.coded_call_lut(any_missing): the staged read ->
    call_geno -> exp -> derive_codes chain (four passes over a float64
    tensor of 24 bytes a triple) becomes one native pass that writes one
    byte a triple (native nd_read_geno_codes).  Returns None when the file
    is not raw seekable binary.  Reference arithmetic: read_data.cpp:29-47
    and gen_func.cpp:886-914.

    out: a C-contiguous uint8 [rows, n_ind] array to fill instead of a
    new one (pinned memory).  Each read adds one to CODED_READS and its
    sites to CODED_ROWS."""
    import ctypes

    global CODED_READS, CODED_ROWS
    if path == "-" or not _native.have_native():
        return None
    start, stop = site_range if site_range is not None else (0, n_sites)
    lib = _native.get_lib()
    if out is None:
        out = np.empty((stop - start, n_ind), dtype=np.uint8)
    elif out.shape != (stop - start, n_ind):
        raise ValueError(f"out has shape {out.shape}, the range needs "
                         f"{(stop - start, n_ind)}")
    errbuf = ctypes.create_string_buffer(256)
    err = ctypes.c_int(0)
    any_missing = ctypes.c_int(0)
    rc = lib.nd_read_geno_codes(
        path.encode(), int(in_logscale), n_ind, n_sites, start, stop,
        _native.as_uint8_ptr(out), ctypes.byref(any_missing), errbuf,
        len(errbuf), ctypes.byref(err),
    )
    if rc == 2:
        return None
    if rc != 0:
        raise NgsDistError("read_geno", errbuf.value.decode(),
                           err=err.value)
    CODED_READS += 1
    CODED_ROWS += stop - start
    return out, bool(any_missing.value)


def is_raw_seekable_binary(path: str) -> bool:
    """True when `path` is a regular, seekable, NON-gzip file — the
    precondition of the fused native reader (its own sniff returns
    None otherwise).  Checked by the fused-path gate so that a
    gz-magic file behind a non-.gz name routes to the staged pipeline
    instead of a mid-run fused-reader fatal; magic-based like the
    reference's gzopen (gen_func.cpp), so a raw file that happens to
    start with 1f 8b is treated as gzip CONSISTENTLY with it."""
    import stat

    if path == "-":
        return False
    try:
        st = os.stat(path)
        if not stat.S_ISREG(st.st_mode):
            return False
        with open(path, "rb") as fh:
            magic = fh.read(2)
    except OSError:
        return False
    return magic != b"\x1f\x8b"


class PackedBinInput:
    """Deferred fused-read handle for raw binary GP inputs on the
    float32 engine path (runner fast path).

    Instead of materializing the [S, N, 3] float64 tensor (read) and
    then converting it twice more (exp, float32 cast) — three full
    passes and a 3x-resident host footprint — the engine pulls
    upload-ready packed [chunk, N, 2] slabs straight from disk, uint16
    (read_geno_pack16, `u16`) or float32 (read_geno_pack23), and uploads
    each while the next chunk parses.

    Consequence of deferral: reader fatals that depend on file CONTENT
    (the NaN check) surface when the affected chunk is read — mid-run
    for multi-chunk streams — instead of before the first compute
    banner as in the eager reference read (read_data.cpp:29-47).  Size
    errors still fail up-front (Params.finalize stat check).  See
    docs/PARITY.md.
    """

    def __init__(self, pars, u16: bool = False) -> None:
        self.path = pars.in_geno
        self.in_logscale = bool(pars.in_logscale)
        self.n_ind = int(pars.n_ind)
        self.n_sites = int(pars.n_sites)
        self.shape = (self.n_sites, self.n_ind, 3)  # logical tensor shape
        # the lane, chosen by the caller for its device: uint16 fixed point
        # (read_geno_pack16, 4 bytes a triple) or float32 pairs (8 bytes)
        self.u16 = bool(u16)
        self.bytes_per_site = self.n_ind * (4 if self.u16 else 8)

    def read_packed(self, lo: int, hi: int,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """Upload-ready [hi-lo, n_ind, 2] slab (uint16 or float32 lane)
        for sites [lo, hi), written into `out` when given."""
        read = read_geno_pack16 if self.u16 else read_geno_pack23
        got = read(self.path, self.in_logscale, self.n_ind, self.n_sites,
                   site_range=(lo, hi), out=out)
        if got is None:  # not raw binary after all (TOCTOU): hard error
            raise NgsDistError("read_geno", "cannot read binary GENO file. "
                               "Check GENO file and number of sites!")
        return got


class CodedBinInput:
    """Deferred fused-read handle for raw binary GP inputs under
    default-threshold --call_geno (runner fast path): the engine pulls
    uint8 [chunk, N] code planes straight from disk (read_geno_codes),
    one byte a triple, and expands them on the device through `lut`
    (core/distance.py expand_codes).  No tensor and no plane is ever
    resident on the host.  The table is coded_call_lut(True) whatever the
    data: a row no code names is never gathered, so no scan for missing
    triples comes first.  Content errors surface when their chunk is
    read, as for PackedBinInput."""

    width = 1  # one code a triple

    def __init__(self, pars) -> None:
        from ..utils.hostmem import coded_call_lut

        self.path = pars.in_geno
        self.in_logscale = bool(pars.in_logscale)
        self.n_ind = int(pars.n_ind)
        self.n_sites = int(pars.n_sites)
        self.shape = (self.n_sites, self.n_ind, 3)  # logical tensor shape
        self.lut = coded_call_lut(True)

    def read_packed(self, lo: int, hi: int,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """The uint8 [hi-lo, n_ind] codes of sites [lo, hi), written into
        `out` when given."""
        got = read_geno_codes(self.path, self.in_logscale, self.n_ind,
                              self.n_sites, site_range=(lo, hi), out=out)
        if got is None:  # not raw binary after all (TOCTOU): hard error
            raise NgsDistError("read_geno", "cannot read binary GENO file. "
                               "Check GENO file and number of sites!")
        return got[0]


def _postprob_py(tri: np.ndarray) -> np.ndarray:
    """Log-normalize triples along the last axis (post_prob semantics)."""
    m = np.max(tri, axis=-1, keepdims=True)
    s = np.sum(np.exp(tri - m), axis=-1, keepdims=True)
    norm = np.where(np.isneginf(m), -np.inf, np.log(s) + m)
    return tri - norm


def _iter_text_sites(fh, in_probs: bool, in_logscale: bool, n_ind: int,
                     start: int, stop: int):
    """Yield (s, row|None) for sites start..stop-1 of a text genome
    stream: row is the [n_ind, 3] log-space normalized triple block,
    None for an empty line (site consumed as missing).  Reference
    control flow exactly (read_data.cpp:48-104): header skips with
    their stderr prints, empty lines, field-count fatals, premature
    EOF."""
    n_geno = N_GENO if in_probs else 1
    s = 0
    while s < stop:
        # gzgets(buf, BUFF_LEN) reads at most BUFF_LEN-1 chars
        # (read_data.cpp:49): an over-long line is consumed in 499999-
        # char chunks, each treated as its own "line" (site).
        raw = fh.readline(LINE_MAX - 1)
        if not raw:
            raise NgsDistError(
                "read_geno",
                "GENO file at premature EOF. Check GENO file and number of sites!",
            )
        line = _chomp(raw.decode("utf-8", errors="replace"))
        if line == "":
            if s >= start:
                yield s, None  # empty line consumes the site as missing
            s += 1
            continue
        vals = _split_numeric(line)
        n_fields = len(vals)
        if n_fields == 0 or (s == 0 and n_fields < n_ind * n_geno):
            print("> Header found! Skipping line...", file=sys.stderr)
            if s != 0:
                print(
                    "\n=======\nWARNING: [read_geno]  header found but "
                    "not on first line. Is this an error?\n=======\n",
                    file=sys.stderr,
                )
            continue
        if n_fields < n_ind * n_geno:
            raise NgsDistError(
                "read_geno", "wrong GENO file format. Less fields than expected!"
            )
        if s < start:  # before this host's shard: advance only
            s += 1
            continue
        tail = np.asarray(vals[n_fields - n_ind * n_geno:], dtype=np.float64)
        if in_probs:
            row = tail.reshape(n_ind, N_GENO).copy()
            if not in_logscale:
                with np.errstate(divide="ignore", invalid="ignore"):
                    row = np.log(row)
                row[np.isneginf(row)] = -BIGNEG
        else:
            g = tail.astype(np.int64)
            if (g > 2).any():
                raise NgsDistError(
                    "read_geno",
                    "wrong GENO file format. Genotypes must be coded as {-1,0,1,2} !",
                )
            row = np.full((n_ind, N_GENO), -BIGNEG, dtype=np.float64)
            miss = g < 0
            row[miss] = np.log(1.0 / N_GENO)
            idx = np.where(~miss)[0]
            row[idx, g[idx]] = 0.0
        yield s, _postprob_py(row)
        s += 1


def _normalize_native(rows: np.ndarray, in_logscale: bool) -> np.ndarray:
    """The native binary reader's log and per-triple normalization of
    rows [n, 3] in place; raises on a NaN, as that reader does."""
    import ctypes

    err = ctypes.c_int(0)
    if _native.get_lib().nd_normalize_triples(
            _native.as_double_ptr(rows), rows.shape[0], int(in_logscale),
            ctypes.byref(err)):
        raise NgsDistError("read_geno", "NaN found! Is the file format correct?",
                           err=err.value)
    return rows


def _read_geno_py(
    path: str, in_bin: bool, in_probs: bool, in_logscale: bool,
    n_ind: int, n_sites: int,
    site_range: Optional[Tuple[int, int]] = None,
    native: bool = False,
) -> np.ndarray:
    """The Python reader; native: binary rows are normalized by the
    native reader's calls (_normalize_native), not numpy's."""
    n_geno = N_GENO if in_probs else 1
    start, stop = site_range if site_range is not None else (0, n_sites)
    geno = np.full((stop - start, n_ind, N_GENO), -BIGNEG, dtype=np.float64)

    try:
        fh = _open_text(path) if not in_bin else (
            sys.stdin.buffer if path == "-" else
            (gzip.open(path, "rb") if path.endswith(".gz")
             else open(path, "rb"))
        )
    except (OSError, NgsDistError) as ex:
        # read_data.cpp:24-26 formats its own message for the GENO file
        err = getattr(ex, "err", None) or getattr(ex, "errno", 0) or 0
        raise NgsDistError("read_geno", "cannot open GENO file!", err=err)
    try:
        if in_bin:
            want = n_ind * N_GENO * 8
            if start and fh.seekable() and not path.endswith(".gz"):
                fh.seek(start * want)
            elif start:
                for _ in range(start):
                    fh.read(want)
            # Bulk read + vectorized normalize (a per-site Python loop
            # is slow on large shards; whole-shard numpy ops apply the
            # same per-element arithmetic).
            n_rows = stop - start
            buf = fh.read(n_rows * want)
            short = len(buf) != n_rows * want
            tb = N_GENO * 8  # one triple
            rows = np.frombuffer(
                buf[: len(buf) - len(buf) % tb], dtype=np.float64
            ).reshape(-1, N_GENO).copy()
            if native:
                rows = _normalize_native(rows, in_logscale)
            elif not in_logscale:
                with np.errstate(divide="ignore", invalid="ignore"):
                    rows = np.log(rows)
                rows[np.isneginf(rows)] = -BIGNEG
            if not native:
                rows = _postprob_py(rows)
            # the reference normalizes + NaN-checks each triple as it
            # reads, so a NaN among the completed triples outranks a
            # later premature EOF (read_data.cpp:29-47)
            if np.isnan(rows).any():
                raise NgsDistError("read_geno", "NaN found! Is the file format correct?")
            if short:
                raise NgsDistError(
                    "read_geno",
                    "GENO file at premature EOF. Check GENO file and number of sites!",
                )
            geno[:] = rows.reshape(n_rows, n_ind, N_GENO)
        else:
            for s, row in _iter_text_sites(fh, in_probs, in_logscale,
                                           n_ind, start, stop):
                if row is not None:
                    geno[s - start] = row
        # Strict EOF check (read_data.cpp:106-109); applies whenever the
        # read runs through the final site.
        if stop == n_sites:
            probe = fh.read(1)
            if probe:
                raise NgsDistError(
                    "read_geno", "GENO file not at EOF. Check GENO file and number of sites!"
                )
    finally:
        if fh is not sys.stdin.buffer:
            fh.close()
    return geno


def spill_text_geno(
    path: str, in_probs: bool, in_logscale: bool, n_ind: int, n_sites: int,
    cache_path: str, site_range: Optional[Tuple[int, int]] = None,
) -> None:
    """Stream-parse a TEXT genome (plain/gz/stdin) ONCE with the native
    reader, writing the log-normalized rows of `site_range` (default: all
    sites) to cache_path as raw f64 [rows, n_ind, 3] — the lazy disk-round
    cache for inputs larger than host RAM.  The cache rows are
    bit-identical to what the eager reader would have produced (shared
    parse), so per-round cache reads must NOT re-normalize.  The reference
    has no counterpart: its only storage is the full in-RAM tensor
    (read_data.cpp:21)."""
    import ctypes

    start, stop = site_range if site_range is not None else (0, n_sites)
    lib = _native.get_lib()
    errbuf = ctypes.create_string_buffer(256)
    err = ctypes.c_int(0)
    rc = lib.nd_spill_text_geno(
        path.encode(), int(in_probs), int(in_logscale), n_ind, n_sites,
        start, stop, cache_path.encode(), errbuf, len(errbuf), ctypes.byref(err),
    )
    if rc != 0:
        raise NgsDistError("read_geno", errbuf.value.decode(), err=err.value)


def read_spill_rows(cache_path: str, n_ind: int, lo: int, hi: int,
                    base: int = 0) -> np.ndarray:
    """Rows [lo, hi) (absolute site indices; the cache holds sites from
    `base`) of a spill cache written by spill_text_geno — already
    log-normalized, NO re-normalization (renormalizing would shift the
    values by the float residue of logsumexp(normalized) != 0 and break
    byte parity with the eager path)."""
    row_bytes = n_ind * N_GENO * 8
    with open(cache_path, "rb") as fh:
        fh.seek((lo - base) * row_bytes)
        buf = fh.read((hi - lo) * row_bytes)
    if len(buf) != (hi - lo) * row_bytes:
        raise NgsDistError("read_geno", "spill cache truncated!")
    return np.frombuffer(buf, dtype=np.float64).reshape(hi - lo, n_ind,
                                                        N_GENO).copy()


def read_file_lines(path: str, offset: int = 0) -> List[str]:
    """Read text lines, skipping blank lines and '#' comments, then
    dropping `offset` leading kept lines (read_file, gen_func.cpp:238-282).

    Two gzgets-level reference quirks are reproduced exactly:
    - lines are consumed in BUFF_LEN-1 = 499999-char chunks
      (gzgets(buf, BUFF_LEN), gen_func.cpp:251) — each chunk of an
      over-long line counts as its own line;
    - read_file checks gzeof BEFORE processing the line it just read
      (gen_func.cpp:253-255), so a final line with no terminating
      newline is silently DROPPED (A/B-verified: such a labels file
      makes the reference fail with "invalid LABELS file!")."""
    out: List[str] = []
    with _open_text(path) as fh:
        while True:
            raw = fh.readline(LINE_MAX - 1)
            if not raw:
                break
            if not raw.endswith(b"\n"):
                # mid-file chunk of an over-long line (kept, gzeof not
                # yet set) vs final unterminated line (dropped)
                try:
                    at_eof = not fh.peek(1)
                except (AttributeError, OSError):
                    at_eof = not fh.read(1)  # non-peekable: consume probe
                if at_eof:
                    break
            line = _chomp(raw.decode("utf-8", errors="replace"))
            if line == "" or line.startswith("#"):
                continue
            out.append(line)
    return out[offset:]


def read_labels(path: str, header: bool, n_ind: int) -> List[str]:
    """Individual labels, one per line, truncated at the first tab
    (ngsDist.cpp:103-116)."""
    lines = read_file_lines(path, 1 if header else 0)
    if len(lines) != n_ind:
        raise NgsDistError("main", "invalid LABELS file!")
    return [ln.split("\t", 1)[0] for ln in lines]


def default_labels(n_ind: int) -> List[str]:
    return [f"Ind_{i}" for i in range(n_ind)]


def read_pos_dist(rows: List[List[str]], n_sites: int) -> np.ndarray:
    """Distance of each site to the previous one, infinity at chromosome
    changes — the reference's read_dist (read_data.cpp:165-218, compiled
    but never called by ngsDist's main; provided for the evolutionary
    models that would consume inter-site distances).

    Reference order exactly: the file's kept lines are pre-validated to
    number EXACTLY n_sites with >= 2 constant columns BEFORE any row is
    scanned (read_split + the two checks at read_data.cpp:177-183),
    then each row's distance to the previous row is computed.  A row
    whose position column strtod-parses to 0 is a "header": the
    reference prints the skip banner and re-reads the SAME buffer slot
    (`s--; continue`, read_data.cpp:188-195) — an infinite loop on any
    reachable input — reproduced here as a clean fatal (the
    docs/PARITY.md intentional-divergences table).  A within-chromosome
    distance < 1 is an error.
    """
    if len(rows) != n_sites:
        raise NgsDistError("read_dist", "wrong number of lines in POS file!")
    if rows and len(rows[0]) < 2:
        raise NgsDistError("read_dist", "wrong POS file format!")
    pos_dist = np.full((n_sites,), np.inf, dtype=np.float64)
    prev_chr: Optional[str] = None
    prev_pos = 0
    for s in range(n_sites):
        row = rows[s]
        try:
            p = float(row[1])
        except ValueError:
            p = 0.0  # strtod of a non-numeric field
        if p == 0:
            print("> Header found! Skipping line...", file=sys.stderr)
            if s != 0:
                print(
                    "\n=====\nWARNING: [read_dist]  header found but not "
                    "on first line. Is this an error?\n=====\n",
                    file=sys.stderr,
                )
            # reference: `s--; continue` re-scans this slot forever
            raise NgsDistError(
                "read_dist",
                "header row in POS file (the reference never terminates here)!",
            )
        if prev_chr is None:
            prev_chr = row[0]
        if prev_chr == row[0]:
            pos_dist[s] = p - prev_pos
            if pos_dist[s] < 1:
                raise NgsDistError(
                    "read_dist", "invalid distance between adjacent sites!"
                )
        else:
            pos_dist[s] = np.inf
            prev_chr = row[0]
        prev_pos = int(p)
    return pos_dist


def read_pos(path: str, header: bool, n_sites: int) -> List[List[str]]:
    """Position file (chr, pos[, allele1, allele2]): split every kept line
    on single space/tab separators keeping empty fields, with a constant
    column-count check (read_split, read_data.cpp:129-152)."""
    lines = read_file_lines(path, 1 if header else 0)
    rows = [re.split(r"[ \t]", ln) for ln in lines]
    n_cols = 0
    for r in rows:
        if n_cols == 0:
            n_cols = len(r)
        if len(r) != n_cols:
            raise NgsDistError("read_split", "invalid number of fields in file!")
    if len(rows) != n_sites or n_cols < 2:
        raise NgsDistError("main", "invalid POS file!")
    return rows
