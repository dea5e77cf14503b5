"""The port's code-plane lane (utils/hostmem.py, readers.read_geno_codes
and CodedBinInput, core/distance.py expand_codes and the coded ChunkPipe,
the runner's routes, coded shards and rounds in parallel/multihost.py)
against the JAX package's, on the CPU.

Hard genotypes and default-threshold --call_geno give tensors of one-hot
and uniform triples: one uint8 code a triple and a table of at most 7 x 3
values.  The table's rows are the staged tensor's float64 triples, so
with NGSDIST_CODED_UPLOAD=1 the CPU's float64 path takes the lane and
computes on the very tensor of its uncoded twin: the goldens' md5 hold
through each coded route, and coded and uncoded runs that cut the same
chunks and rounds write the same bytes.  Against the JAX package the
host functions are equal bit for bit, the expansion exactly, and the
mesh and lazy runs within 1e-9 (float64 sums in other orders)."""

import gzip
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.core import bootstrap as jboot  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu.io import readers as jreaders  # noqa: E402
from ngsdist_tpu.parallel import mesh as jpm  # noqa: E402
from ngsdist_tpu.parallel.multihost import SiteStream as JStream  # noqa: E402
from ngsdist_tpu.utils import hostmem as jhm  # noqa: E402
from ngsdist_tpu_torch import cli, runner  # noqa: E402
from ngsdist_tpu_torch.config import NgsDistError, Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.core.preprocess import find_zero_rows, preprocess  # noqa: E402
from ngsdist_tpu_torch.io import readers  # noqa: E402
from ngsdist_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngsdist_tpu_torch.parallel import multihost as pmh  # noqa: E402
from ngsdist_tpu_torch.utils import hostmem, profiling  # noqa: E402

from conftest import DATA_DIR, FIXTURES, REPO_ROOT  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
UNIFORM = np.exp(np.log(1.0 / 3.0))   # the reader's missing triple


def _coded_tensor(S, N, seed=0, missing=0.15, uniforms=(UNIFORM,), zero_sites=()):
    """One-hot triples, a share `missing` of them uniform (values drawn from
    `uniforms`), and all-zero sites (empty text lines)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(S, N))
    P = np.zeros((S, N, 3))
    for k in range(3):
        P[..., k] = g == k
    miss = rng.random((S, N)) < missing
    P[miss] = np.asarray(uniforms)[rng.integers(0, len(uniforms), int(miss.sum()))][:, None]
    for s in zero_sites:
        P[s] = 0.0
    return P


def _gp_file(tmp_path, S, N, seed=21, log=False, name="gp.bin"):
    """Raw binary GP: Dirichlet triples, an all-equal triple and a tie of
    the largest two (the first wins), linear or log scale."""
    rng = np.random.default_rng(seed)
    g = rng.dirichlet(np.ones(3), size=(S, N))
    g[5 % S, 1 % N] = [0.25, 0.25, 0.25]
    g[9 % S, 0] = [0.4, 0.4, 0.2]
    g[rng.random((S, N)) < 0.05] = 1 / 3
    path = str(tmp_path / name)
    (np.log(g) if log else g).astype("<f8").tofile(path)
    return path


# ------------------------------------------------------------------ #
# Host functions                                                      #
# ------------------------------------------------------------------ #


def _derive_case(name):
    """(tensor, chunk_rows) of a derive_codes case."""
    if name == "onehot_uniform":
        return _coded_tensor(300, 9), 1 << 21
    if name == "uniform_and_empty_line":
        return _coded_tensor(60, 4, seed=2, zero_sites=(7,)), 1 << 21
    if name == "four_uniforms":
        return _coded_tensor(80, 5, seed=3, uniforms=(UNIFORM, 0.0, 0.25, 0.5)), 1 << 21
    if name == "five_uniforms":
        return _coded_tensor(80, 5, seed=4, uniforms=(UNIFORM, 0.0, 0.25, 0.5, 0.1)), 1 << 21
    if name == "soft":
        return np.random.default_rng(1).dirichlet(np.ones(3), size=(40, 4)), 1 << 21
    if name == "one_soft_triple":
        P = _coded_tensor(50, 4)
        P[10, 2] = [0.2, 0.5, 0.3]       # a thresholded call leaves it soft
        return P, 1 << 21
    # 800 triples in chunks of 64: the probes (from triple 400 on) run first
    P = _coded_tensor(200, 4, seed=5)
    if name == "probe_fails":
        P[125, 1] = [0.2, 0.5, 0.3]
    else:                                # "chunked": every chunk coded
        assert name == "chunked"
    return P, 64


@pytest.mark.parametrize("name", ["onehot_uniform", "uniform_and_empty_line", "four_uniforms",
                                  "five_uniforms", "soft", "one_soft_triple", "probe_fails",
                                  "chunked"])
def test_derive_codes_equals_jax(name):
    """The code plane and table of the JAX package's derive_codes, bit for
    bit, and its bail-outs (None): a soft triple, a fifth uniform value, a
    probe that finds a soft triple; the expansion is the tensor itself and
    the coded tensor's all-zero triples are the tensor's."""
    P, chunk_rows = _derive_case(name)
    got = hostmem.derive_codes(P, chunk_rows=chunk_rows)
    want = jhm.derive_codes(P, chunk_rows=chunk_rows)
    if want is None:
        assert got is None
        assert name in ("five_uniforms", "soft", "one_soft_triple", "probe_fails")
        return
    codes, lut = got
    assert codes.dtype == np.uint8 and lut.dtype == np.float64
    assert codes.tobytes() == want[0].tobytes() and lut.tobytes() == want[1].tobytes()
    np.testing.assert_array_equal(lut[codes], P)
    cp = hostmem.CodedProbs(None, codes, lut)
    zc, zp = find_zero_rows(cp), find_zero_rows(P)
    assert (zc is None) == (zp is None) == (name not in ("uniform_and_empty_line",
                                                         "four_uniforms"))
    if zp is not None:
        np.testing.assert_array_equal(zc.sites, zp.sites)
        np.testing.assert_array_equal(zc.rows, zp.rows)


@pytest.mark.parametrize("any_missing", [True, False])
def test_call_and_pad_tables_equal_jax(any_missing):
    """coded_call_lut and coded_pad_lut: the JAX package's tables bit for
    bit; a pad row is reused where the table has an all-zero row."""
    lut = hostmem.coded_call_lut(any_missing)
    assert lut.tobytes() == jhm.coded_call_lut(any_missing).tobytes()
    for table in (lut, hostmem.derive_codes(_coded_tensor(30, 4, zero_sites=(3,)))[1]):
        got, want = hostmem.coded_pad_lut(table), jhm.coded_pad_lut(table)
        assert got[1] == want[1] and got[0].tobytes() == want[0].tobytes()
        assert not got[0][got[1]].any()


def test_coded_probs_is_the_tensor():
    """A CodedProbs answers for its tensor as the JAX package's does: shape
    and length, a slice of sites stays coded, other indices and
    np.asarray rebuild the tensor, and a copy is not the cached one."""
    P = _coded_tensor(80, 5)
    codes, lut = hostmem.derive_codes(P)
    w = hostmem.CodedProbs(None, codes, lut)
    jw = jhm.CodedProbs(None, codes, lut)
    assert w.shape == jw.shape == P.shape and len(w) == len(jw) == 80
    sub = w[10:30]
    assert isinstance(sub, hostmem.CodedProbs) and sub.lut is lut
    np.testing.assert_array_equal(sub.codes, codes[10:30])
    np.testing.assert_array_equal(np.asarray(w), P)
    np.testing.assert_array_equal(w[3], jw[3])
    cp = np.array(w, copy=True)
    cp[:] = -1
    np.testing.assert_array_equal(w.P, P)


@pytest.mark.parametrize("site_range", [None, (50, 200), (0, 1), (236, 237)],
                         ids=["full", "mid", "first", "last"])
@pytest.mark.parametrize("log", [False, True], ids=["linear", "log"])
def test_read_geno_codes_equals_jax_and_the_staged_chain(tmp_path, log, site_range):
    """The fused codes reader: the JAX package's codes and missing flag,
    and the staged read -> preprocess(call_geno) -> derive_codes of the
    same rows (its codes, and the table coded_call_lut gives); into a
    caller's buffer too, and through the CodedBinInput handle."""
    S, N = 237, 11
    path = _gp_file(tmp_path, S, N, log=log)
    got = readers.read_geno_codes(path, log, N, S, site_range=site_range)
    want = jreaders.read_geno_codes(path, log, N, S, site_range=site_range)
    assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]
    codes, any_missing = got
    lo, hi = site_range or (0, S)
    assert codes.shape == (hi - lo, N) and codes.dtype == np.uint8
    staged = preprocess(readers.read_geno(path, True, True, log, N, S, site_range=site_range),
                        True, 0.0, 0.0)
    s_codes, s_lut = hostmem.derive_codes(staged)
    assert s_codes.tobytes() == codes.tobytes()
    assert s_lut.tobytes() == hostmem.coded_call_lut(any_missing).tobytes()
    assert any_missing == (site_range in (None, (0, 1)) or bool((codes == 3).any()))
    buf = np.full((hi - lo, N), 9, np.uint8)
    assert readers.read_geno_codes(path, log, N, S, site_range=site_range, out=buf)[0] is buf
    assert buf.tobytes() == codes.tobytes()
    with pytest.raises(ValueError, match="shape"):
        readers.read_geno_codes(path, log, N, S, site_range=(lo, hi), out=buf[:, :1])
    h = readers.CodedBinInput(Params(in_geno=path, in_bin=True, in_probs=True, in_logscale=log,
                                     n_ind=N, n_sites=S))
    assert h.shape == (S, N, 3) and h.width == 1
    assert h.lut.tobytes() == jreaders.CodedBinInput(JParams(
        in_geno=path, in_bin=True, in_probs=True, n_ind=N, n_sites=S)).lut.tobytes()
    assert h.read_packed(lo, hi).tobytes() == codes.tobytes()


def test_read_geno_codes_refuses_what_it_cannot_read(tmp_path):
    """None for a gz file and stdin (the caller's gate sends them staged);
    the reference's fatals for a short file; a handle whose file turned
    out not to be raw binary raises, never reads another way."""
    S, N = 20, 3
    path = _gp_file(tmp_path, S, N)
    gz = str(tmp_path / "gp.bin.gz")
    with open(path, "rb") as s, gzip.open(gz, "wb") as d:
        shutil.copyfileobj(s, d)
    assert readers.read_geno_codes(gz, False, N, S) is None
    assert readers.read_geno_codes("-", False, N, S) is None
    with pytest.raises(NgsDistError, match="premature EOF"):
        readers.read_geno_codes(path, False, N, S + 1)
    h = readers.CodedBinInput(Params(in_geno=gz, in_bin=True, in_probs=True, n_ind=N, n_sites=S))
    with pytest.raises(NgsDistError, match="cannot read binary GENO file"):
        h.read_packed(0, S)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_expand_codes_equals_jax_and_the_tensor(dtype):
    """expand_codes: the JAX package's expansion exactly (a NaN row
    included), into `out` too; of derive_codes' plane, the tensor."""
    rng = np.random.default_rng(9)
    lut = np.vstack([hostmem.coded_call_lut(True), np.full((1, 3), np.nan), np.zeros((1, 3))])
    lut = lut.astype(dtype)
    codes = rng.integers(0, lut.shape[0], size=(41, 13)).astype(np.uint8)
    got = tdist.expand_codes(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    want = np.asarray(jdist.expand_codes(jnp.asarray(codes), jnp.asarray(lut)))
    assert got.dtype == want.dtype == dtype and got.shape == (41, 13, 3)
    assert got.tobytes() == want.tobytes()
    out = torch.full((41, 13, 3), -1.0, dtype=torch.from_numpy(lut).dtype)
    assert tdist.expand_codes(torch.from_numpy(codes), torch.from_numpy(lut), out=out) is out
    assert out.numpy().tobytes() == want.tobytes()
    P = _coded_tensor(64, 7, uniforms=(UNIFORM, 0.0))
    codes, lut = hostmem.derive_codes(P)
    got = tdist.expand_codes(torch.from_numpy(codes), torch.from_numpy(lut.astype(dtype)))
    np.testing.assert_array_equal(got.numpy(), P.astype(dtype))


# ------------------------------------------------------------------ #
# The upload pipe                                                     #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["ring", "dest"])
def test_coded_pipe_yields_the_uncoded_tensors(tmp_path, monkeypatch, mode, dtype):
    """A ChunkPipe over a code plane, and over a CodedBinInput, yields the
    chunks the pipe over the staged array yields (the same dtype), and
    sends one byte a triple (profiling.StageTimes.upload_bytes) where the
    array sends the triple; upload_resident gives the same tensor.  The
    array's pipe sends all three components (NGSDIST_UPLOAD23=0): the
    table's rows are the cast of the staged triples, where the float32
    pair lane restores p2 = 1 - p0 - p1 within an ulp of it."""
    monkeypatch.setenv("NGSDIST_UPLOAD23", "0")
    S, N = 103, 6
    path = _gp_file(tmp_path, S, N, seed=4)
    staged = preprocess(readers.read_geno(path, True, True, False, N, S), True, 0.0, 0.0)
    codes, lut = hostmem.derive_codes(staged)
    ranges = [(0, 37), (37, 80), (80, 103)]
    itemsize = torch.finfo(dtype).bits // 8

    def chunks(src):
        profiling.ACTIVE = profiling.StageTimes(CPU)
        try:
            dest = torch.empty((S, N, 3), dtype=dtype) if mode == "dest" else None
            pipe = tdist.ChunkPipe(src, CPU, dtype, 40, dest=dest)
            out = [(Pc.clone(), lo, hi) for Pc, lo, hi in pipe.chunks(ranges)]
            return out, profiling.ACTIVE.upload_bytes
        finally:
            profiling.ACTIVE = None

    want, want_bytes = chunks(staged)
    assert want_bytes == S * N * 3 * itemsize     # the host array in the device's dtype
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N, n_sites=S)
    for src in (hostmem.CodedProbs(None, codes, lut), readers.CodedBinInput(pars)):
        got, nbytes = chunks(src)
        assert nbytes == S * N
        for (g, glo, ghi), (w, wlo, whi) in zip(got, want):
            assert (glo, ghi) == (wlo, whi) and g.dtype == dtype
            assert g.numpy().tobytes() == w.numpy().tobytes()
    for src in (hostmem.CodedProbs(None, codes, lut), readers.CodedBinInput(pars)):
        res = tdist.upload_resident(src, CPU, False)
        np.testing.assert_array_equal(res.numpy(), staged)


# ------------------------------------------------------------------ #
# The runner's routes                                                 #
# ------------------------------------------------------------------ #

CODED_GOLDENS = sorted(n for n in MANIFEST if n.startswith("T")) + ["GL_CG", "BIN_CG"]


def _spy_source(monkeypatch):
    """The type of the source the runner hands the engine, and the
    expansions of code planes."""
    seen = {"source": [], "expand": 0}
    it, ex = tdist.iter_replicates, tdist.expand_codes

    def spy_it(pars, P, *a, **k):
        seen["source"].append(type(P).__name__)
        return it(pars, P, *a, **k)

    def spy_ex(*a, **k):
        seen["expand"] += 1
        return ex(*a, **k)

    monkeypatch.setattr(tdist, "iter_replicates", spy_it)
    monkeypatch.setattr(tdist, "expand_codes", spy_ex)
    return seen


@pytest.mark.parametrize("name", CODED_GOLDENS)
def test_coded_route_keeps_the_golden_md5(name, tmp_path, monkeypatch):
    """NGSDIST_CODED_UPLOAD=1 on the CPU: every hard-genotype golden and
    both default-threshold --call_geno goldens go through the code plane
    (BIN_CG: the fused codes reader's handle; the text inputs: the staged
    read and derive_codes) and write the golden bytes."""
    assert len(CODED_GOLDENS) == 13
    monkeypatch.chdir(DATA_DIR)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    seen = _spy_source(monkeypatch)
    out = str(tmp_path / f"{name}.dist")
    args = [a.replace("{OUT}", out) for a in MANIFEST[name]["args"]]
    assert cli.main(args + ["--platform", "cpu", "--verbose", "0"]) == 0
    assert hashlib.md5(open(out, "rb").read()).hexdigest() == MANIFEST[name]["md5"]
    assert seen["source"] == ["CodedBinInput" if name == "BIN_CG" else "CodedProbs"]
    assert seen["expand"] >= 1


def _write_gt(path, S, N, seed=8):
    """A gz hard-genotype text (-1 = missing, about 5%), an empty line at
    site 3."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(S, N))
    g[rng.random((S, N)) < 0.05] = -1
    with gzip.open(path, "wt") as fh:
        for s in range(S):
            fh.write("" if s == 3 else "\t".join(map(str, g[s])))
            fh.write("\n")


def _run_file(tmp_path, monkeypatch, geno, flags, tag, env):
    """runner.run on the CPU of `geno` with flags under env; (bytes, source)."""
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET", "NGSDIST_CODED_UPLOAD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = _spy_source(monkeypatch)
    out = str(tmp_path / f"{tag}.dist")
    pars, _ = cli.parse_args(["--geno", geno, "--out", out, "--verbose", "0", "--seed", "5",
                              *flags])
    runner.run(pars, CPU)
    monkeypatch.undo()
    return open(out, "rb").read(), seen["source"][0]


# route -> (input, flags, whether the resident run takes the same route)
STREAMED = {
    "handle": ("bin", "--probs --call_geno --pairwise_del", "CodedBinInput"),
    "eager": ("bin", "--probs --call_geno --pairwise_del --n_boot_rep 2 --boot_block_size 10",
              "CodedProbs"),
    "staged": ("gt", "--pairwise_del --n_boot_rep 2 --boot_block_size 10", "CodedProbs"),
}


@pytest.mark.parametrize("route", sorted(STREAMED))
def test_streamed_coded_run_is_the_resident_one(tmp_path, monkeypatch, route):
    """Streamed in chunks under NGSDIST_DEVICE_BUDGET, a coded run writes
    the bytes of the resident coded run (one-hot sums and integer weights
    under --pairwise_del are exact in any order) and of the uncoded
    streamed run: the fused codes reader's handle without bootstrap, the
    eager code plane with it (no file read per replicate), the staged
    scan of hard genotypes."""
    S, N = 203, 6
    kind, flags, source = STREAMED[route]
    if kind == "bin":
        geno = _gp_file(tmp_path, S, N)
    else:
        geno = str(tmp_path / "gt.geno.gz")
        _write_gt(geno, S, N)
    flags = f"{flags} --n_ind {N} --n_sites {S}".split()
    budget = str(3 * 50 * N * 3 * 8)                  # chunks of 37 sites
    streamed, src = _run_file(tmp_path, monkeypatch, geno, flags, "s",
                              {"NGSDIST_CODED_UPLOAD": "1", "NGSDIST_DEVICE_BUDGET": budget})
    assert src == source
    assert tdist.stream_plan(S, N, CPU, None, False)[0] is False
    resident, rsrc = _run_file(tmp_path, monkeypatch, geno, flags, "r",
                               {"NGSDIST_CODED_UPLOAD": "1"})
    assert rsrc == ("CodedBinInput" if kind == "bin" else "CodedProbs")
    uncoded, usrc = _run_file(tmp_path, monkeypatch, geno, flags, "u",
                              {"NGSDIST_DEVICE_BUDGET": budget})
    assert usrc == "ndarray"
    assert streamed == resident == uncoded


def _gate_pars(path, **kw):
    base = dict(in_geno=path, in_bin=True, in_probs=True, n_ind=3, n_sites=16, call_geno=True,
                pairwise_del=True, verbose=0, out="o.dist")
    base.update(kw)
    return Params(**base)


@pytest.mark.parametrize("case,want", [
    ("one_device", "handle"),
    ("chunked", "handle"),
    ("chunked_bootstrap", "eager"),
    ("mesh", "eager"),
    ("mesh_over_host_budget", False),
    ("lazy_one_device", "handle"),
    ("thresholds", False),
    ("no_call_geno", False),
    ("models_3_6", False),
    ("verbose_8", False),
    ("staged_forced", False),
    ("float64_auto", False),
    ("gz", False),
])
def test_fused_coded_gate(tmp_path, monkeypatch, case, want):
    """runner._fused_coded_wanted takes the JAX runner's rules
    (ngsdist_tpu/runner.py:65-118): on one device the handle, at any size
    (over the host budget too), but a chunked bootstrap the eager plane; a
    mesh the eager plane where it fits the host budget; nothing outside
    the shared gate (default thresholds, models 0-2, verbose < 8, coded
    uploads on, NGSDIST_FUSED_READ) or for a gz file."""
    path = _gp_file(tmp_path, 16, 3)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0" if case == "float64_auto" else "1")
    if case == "float64_auto":
        monkeypatch.delenv("NGSDIST_CODED_UPLOAD")
    kw, mesh = {}, None
    if case in ("chunked", "chunked_bootstrap"):
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(3 * 4 * 3 * 3 * 8))
        if case == "chunked_bootstrap":
            kw = dict(n_boot_rep=2, boot_block_size=4)
    if case in ("mesh", "mesh_over_host_budget"):
        mesh = pm.make_mesh([CPU] * 2)
    if case in ("mesh_over_host_budget", "lazy_one_device"):
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", "50")
    if case == "thresholds":
        kw = dict(N_thresh=0.3, call_thresh=0.9)
    if case == "no_call_geno":
        kw = dict(call_geno=False)
    if case == "models_3_6":
        kw = dict(evol_model=4)
    if case == "verbose_8":
        kw = dict(verbose=8)
    if case == "staged_forced":
        monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    if case == "gz":
        gz = str(tmp_path / "z.bin")
        with open(path, "rb") as s, gzip.open(gz, "wb") as d:
            shutil.copyfileobj(s, d)
        path = gz
    pars = _gate_pars(path, **kw)
    assert runner._fused_coded_wanted(pars, CPU, mesh) == want
    if case == "lazy_one_device":
        assert runner._lazy_stream_wanted(pars, CPU)


@pytest.mark.parametrize("case", ["default", "no_call_geno", "thresholds", "text", "models_3_6",
                                  "verbose_8", "staged_forced", "coded_off", "gz_magic"])
def test_wants_coded_lazy_is_the_jax_gate(tmp_path, monkeypatch, case):
    """SiteStream.wants_coded_lazy answers as the JAX package's
    (tests/test_coded_upload.py test_gates), the dtype aside."""
    path = _gp_file(tmp_path, 16, 3)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0" if case == "coded_off" else "1")
    if case == "staged_forced":
        monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    kw = {"no_call_geno": dict(call_geno=False), "thresholds": dict(call_thresh=0.9),
          "text": dict(in_bin=False), "models_3_6": dict(evol_model=4),
          "verbose_8": dict(verbose=8)}.get(case, {})
    if case == "gz_magic":
        gz = str(tmp_path / "z.bin")
        with open(path, "rb") as s, gzip.open(gz, "wb") as d:
            shutil.copyfileobj(s, d)
        path = gz
    base = dict(in_geno=path, in_bin=True, in_probs=True, n_ind=3, n_sites=16, call_geno=True,
                pairwise_del=True, indep_geno=True, evol_model=1, verbose=0, out="y")
    base.update(kw)
    got = pmh.SiteStream.wants_coded_lazy(Params(**base), torch.float64)
    assert got == JStream.wants_coded_lazy(JParams(**base), np.float64)
    assert got == (case in ("default", "text"))


# ------------------------------------------------------------------ #
# Meshes and lazy rounds                                              #
# ------------------------------------------------------------------ #


def _mesh_pars(cls, **kw):
    base = dict(in_geno="x", n_ind=5, n_sites=141, out="y", seed=3, indep_geno=True,
                in_probs=False, n_boot_rep=2, boot_block_size=4, evol_model=1)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["8x1", "4x2"])
@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
def test_coded_mesh_matches_the_jax_coded_mesh(monkeypatch, pairwise_del, shape, streamed):
    """A code plane over a mesh of `cpu` entries (SiteStream.from_array of
    a CodedProbs: each shard uploads its codes and expands them), resident
    and in rounds: within 1e-9 of the JAX package's coded mesh
    (tests/test_coded_upload.py:176-255), and the bytes of the port's
    uncoded run on the same mesh."""
    P = _coded_tensor(141, 5, seed=7)
    codes, lut = hostmem.derive_codes(P)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    if streamed:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(4 * 5 * 3 * 8))
    pars, jpars = _mesh_pars(Params, pairwise_del=pairwise_del), _mesh_pars(
        JParams, pairwise_del=pairwise_del)
    n_trunc, maps = jboot.site_maps(3, 2, 141, 4)
    mesh = pm.make_mesh([CPU] * shape[0], pairs=shape[1])
    st = pmh.SiteStream.from_array(hostmem.CodedProbs(None, codes, lut), pars, mesh)
    assert st.coded and st.resident != streamed
    seen = _spy_source(monkeypatch)
    got = list(tdist.iter_replicates(pars, st, maps, n_trunc, CPU, mesh=mesh))
    assert seen["expand"] >= 1
    jmesh = jpm.make_mesh(n_devices=shape[0], pairs=shape[1])
    jst = JStream.from_array(jhm.CodedProbs(P, codes, lut), jpars, jmesh, np.float64)
    assert jst.coded and (st.s_loc, st.chunk) == (jst.s_loc, jst.chunk)
    want = list(jdist.iter_replicates(jpars, jst, maps, n_trunc, mesh=jmesh))
    plain = list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU, mesh=mesh))
    assert len(got) == len(want) == len(plain) == 3
    for g, w, u in zip(got, want, plain):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
        assert g.tobytes() == u.tobytes()


def _lazy_input(tmp_path, style, S, N):
    """A GP genome for lazy coded rounds: raw binary, gz binary, or gz
    text with two empty lines, a tie, an all-equal triple and a literal
    `nan`."""
    if style != "text":
        path = _gp_file(tmp_path, S, N)
        if style == "bin_gz":
            gz = str(tmp_path / "gp.bin.gz")
            with open(path, "rb") as s, gzip.open(gz, "wb") as d:
                shutil.copyfileobj(s, d)
            return gz, True
        return path, True
    rng = np.random.default_rng(33)
    g = rng.dirichlet(np.ones(3), size=(S, N))
    g[9, 0] = [0.4, 0.4, 0.2]
    g[11, 1] = [0.25, 0.25, 0.25]
    path = str(tmp_path / "gp.geno.gz")
    with gzip.open(path, "wt") as fh:
        for s in range(S):
            if s in (5, 40):
                fh.write("\n")
                continue
            fields = [f"{v:.17g}" for v in g[s].reshape(-1)]
            if s == 20:
                fields[2 * 3 + 1] = "nan"
            fh.write("\t".join(fields) + "\n")
    return path, False


@pytest.mark.parametrize("style", ["bin", "bin_gz", "text"])
def test_lazy_coded_rounds_match_jax_and_the_uncoded_rounds(tmp_path, monkeypatch, style):
    """from_reader over the host budget under default-threshold
    --call_geno reads codes round by round (DiskRows._read_codes): from
    the raw file, from a gz input's binary spill, and from the text
    spill's rows (a literal `nan` to the table's NaN row): the plan of the
    uncoded lazy stream (NGSDIST_FUSED_READ=0) and its bytes, within 1e-9
    of the JAX package's lazy coded run, and the caches deleted."""
    S, N = 96, 4
    path, in_bin = _lazy_input(tmp_path, style, S, N)
    kw = dict(in_geno=path, in_bin=in_bin, in_probs=True, n_ind=N, n_sites=S, out="y", seed=3,
              indep_geno=True, call_geno=True, pairwise_del=True, evol_model=1, n_boot_rep=2,
              boot_block_size=4, verbose=0)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    monkeypatch.setenv("NGSDIST_HOST_BUDGET", "2000")
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", "100000000")
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(spill))
    n_trunc, maps = jboot.site_maps(3, 2, S, 4)
    mesh = pm.make_mesh([CPU] * 8)

    def mats(pars):
        st = pmh.SiteStream.from_reader(pars, mesh)
        try:
            return st, list(tdist.iter_replicates(pars, st, maps, n_trunc, CPU, mesh=mesh))
        finally:
            st.close()

    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    staged, plain = mats(Params(**kw))
    assert staged.lazy and not staged.coded and staged.n_rounds > 1
    monkeypatch.setenv("NGSDIST_FUSED_READ", "auto")
    calls = []
    orig = pmh.DiskRows._read_codes
    monkeypatch.setattr(pmh.DiskRows, "_read_codes",
                        lambda self, *a, **k: calls.append(a) or orig(self, *a, **k))
    coded, got = mats(Params(**kw))
    assert coded.lazy and coded.coded and calls
    assert (coded.s_loc, coded.chunk) == (staged.s_loc, staged.chunk)
    jmesh = jpm.make_mesh(n_devices=8)
    jst = JStream.from_reader(JParams(**kw), jmesh, np.float64)
    assert jst.lazy and jst.coded
    want = list(jdist.iter_replicates(JParams(**kw), jst, maps, n_trunc, mesh=jmesh))
    jst.close()
    assert len(got) == len(want) == len(plain) == 3
    for g, w, u in zip(got, want, plain):
        assert g.tobytes() == u.tobytes()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=0, atol=1e-9)
    assert any(np.isnan(m).any() for m in got) == (style == "text")
    assert list(spill.iterdir()) == []


@pytest.mark.parametrize("style", ["bin", "text"])
def test_eager_coded_shards_from_the_reader(tmp_path, monkeypatch, style):
    """from_reader within the host budget reads the code plane of its
    range eagerly (the fused reader, or the read rows classified): a
    CodedProbs of the static table, and the bytes of the staged read."""
    S, N = 96, 4
    path, in_bin = _lazy_input(tmp_path, style, S, N)
    kw = dict(in_geno=path, in_bin=in_bin, in_probs=True, n_ind=N, n_sites=S, out="y", seed=3,
              indep_geno=True, call_geno=True, pairwise_del=True, evol_model=1, n_boot_rep=2,
              boot_block_size=4, verbose=0)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    n_trunc, maps = jboot.site_maps(3, 2, S, 4)
    mesh = pm.make_mesh([CPU] * 4, pairs=2)
    st = pmh.SiteStream.from_reader(Params(**kw), mesh)
    assert st.coded and not st.lazy and isinstance(st.src, hostmem.CodedProbs)
    assert st.src.lut.shape == (5, 3) and np.isnan(st.src.lut[4]).all()
    got = list(tdist.iter_replicates(Params(**kw), st, maps, n_trunc, CPU, mesh=mesh))
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    st = pmh.SiteStream.from_reader(Params(**kw), mesh)
    assert not st.coded
    want = list(tdist.iter_replicates(Params(**kw), st, maps, n_trunc, CPU, mesh=mesh))
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


def test_runner_on_a_mesh_takes_lazy_coded_rounds_over_the_host_budget(tmp_path, monkeypatch):
    """runner.run on a mesh: within the host budget the eager code plane,
    over it (the plane too large) lazy coded rounds; both write the bytes
    of the uncoded run."""
    S, N = 90, 5
    path = _gp_file(tmp_path, S, N, seed=4)
    # a fixed --seed: without one each run seeds its bootstrap from the
    # clock (the reference's time(NULL)), and runs a second apart differ
    flags = f"--probs --call_geno --pairwise_del --n_boot_rep 2 --boot_block_size 5 --n_ind {N} " \
            f"--n_sites {S} --seed 5".split()
    mesh = pm.make_mesh([CPU] * 8)
    calls = []
    orig = pmh.DiskRows._read_codes

    def run(tag, env):
        for k in ("NGSDIST_HOST_BUDGET", "NGSDIST_CODED_UPLOAD"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(pmh.DiskRows, "_read_codes",
                            lambda self, *a, **k: calls.append(a) or orig(self, *a, **k))
        seen = _spy_source(monkeypatch)
        out = str(tmp_path / f"{tag}.dist")
        pars, _ = cli.parse_args(["--geno", path, "--out", out, "--verbose", "0", *flags])
        runner.run(pars, mesh=mesh)
        monkeypatch.undo()
        return open(out, "rb").read(), seen["source"][0]

    eager, src = run("eager", {"NGSDIST_CODED_UPLOAD": "1"})
    assert src == "CodedProbs" and not calls
    lazy, src = run("lazy", {"NGSDIST_CODED_UPLOAD": "1", "NGSDIST_HOST_BUDGET": "400"})
    assert src == "SiteStream" and calls
    plain, src = run("plain", {})
    assert src == "ndarray"
    assert eager == lazy == plain


# ------------------------------------------------------------------ #
# Two processes                                                       #
# ------------------------------------------------------------------ #

_WORKER = r"""
import json, os, sys
rank, spec = int(sys.argv[1]), json.load(open(sys.argv[2]))
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from ngsdist_tpu_torch import cli
from ngsdist_tpu_torch.parallel import multihost as pmh

from_reader = pmh.SiteStream.from_reader.__func__
seen = {{}}

def spy(cls, pars, mesh, *a):
    st = from_reader(cls, pars, mesh, *a)
    seen.update(coded=st.coded, lazy=st.lazy, chunk=st.chunk)
    return st

pmh.SiteStream.from_reader = classmethod(spy)
for run in spec:
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET", "NGSDIST_SPILL_DIR"):
        os.environ.pop(k, None)
    os.environ.update(run["env"])
    rc = cli.main(run["argv"] + ["--coordinator", "127.0.0.1:%d" % run["port"],
                                 "--num_processes", "2", "--process_id", str(rank)])
    print("RUN " + json.dumps(dict(seen, name=run["name"], rc=rc)), flush=True)
    if rc:
        sys.exit(rc)
"""
WALL = 120  # seconds a worker may take for all the cases
PS, PN = 240, 6
# name -> (input, environment): rounds of 40 sites a shard in both layouts
# where lazy (the device budget binds, not the host's)
PROC_CASES = {
    "bin_eager": ("gp.bin", {}),
    "bin_lazy": ("gp.bin", {"NGSDIST_HOST_BUDGET": "1000",
                            "NGSDIST_DEVICE_BUDGET": str(3 * 40 * PN * 3 * 8)}),
    "text_lazy": ("gp.geno.gz", {"NGSDIST_HOST_BUDGET": "1000",
                                 "NGSDIST_DEVICE_BUDGET": str(3 * 40 * PN * 3 * 8)}),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _proc_argv(work, name):
    geno, _ = PROC_CASES[name]
    return ["--geno", str(work / geno), "--probs", "--call_geno", "--pairwise_del",
            "--n_boot_rep", "2", "--boot_block_size", "20", "--n_ind", str(PN), "--n_sites",
            str(PS), "--seed", "5", "--verbose", "0", "--platform", "cpu",
            "--out", str(work / f"{name}.dist")]


def _proc_env(work, name):
    env = dict(PROC_CASES[name][1], NGSDIST_CODED_UPLOAD="1")
    if "NGSDIST_HOST_BUDGET" in env:
        (work / "spill").mkdir(exist_ok=True)
        env["NGSDIST_SPILL_DIR"] = str(work / "spill")
    return env


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Every case in one launch of two gloo workers; (work dir, what each
    process's stream was, by case)."""
    work = tmp_path_factory.mktemp("coded_procs")
    _gp_file(work, PS, PN, seed=17)
    path, _ = _lazy_input(work, "text", PS, PN)
    assert os.path.basename(path) == "gp.geno.gz"
    (work / "worker.py").write_text(_WORKER.format(repo=REPO_ROOT))
    runs = [dict(name=n, argv=_proc_argv(work, n), env=_proc_env(work, n), port=_free_port())
            for n in PROC_CASES]
    (work / "spec.json").write_text(json.dumps(runs))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NGSDIST_") and k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"), str(rank),
                               str(work / "spec.json")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WALL)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    seen = [{r["name"]: r for r in (json.loads(ln[4:]) for ln in out.splitlines()
                                    if ln.startswith("RUN "))} for out in outs]
    return work, seen


@pytest.mark.parametrize("name", sorted(PROC_CASES))
def test_two_processes_write_the_bytes_of_one_with_two_entries(two_processes, tmp_path,
                                                               monkeypatch, name):
    """Two --coordinator processes under --call_geno, each reading its
    range as codes (eagerly, or lazily in rounds from the raw file or the
    text spill), write the bytes of one process with two `cpu` entries,
    which the runner routes through the code plane too; every process
    deletes its spill."""
    work, seen = two_processes
    for rank in (0, 1):
        got = seen[rank][name]
        assert got["coded"] and got["rc"] == 0
        assert got["lazy"] == name.endswith("_lazy")
    for k, v in _proc_env(work, name).items():
        monkeypatch.setenv(k, v)
    one = tmp_path / "one.dist"
    src = _spy_source(monkeypatch)
    argv = _proc_argv(work, name)
    argv[argv.index("--out") + 1] = str(one)
    assert cli.main(argv + ["--devices", "2"]) == 0
    assert src["expand"] >= 1
    assert open(work / f"{name}.dist", "rb").read() == open(one, "rb").read()
    if name.endswith("_lazy"):
        assert list((work / "spill").iterdir()) == []
