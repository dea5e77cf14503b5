"""The port's fused read (native nd_read_geno_pack23 through
readers.read_geno_pack23 / PackedBinInput), its device half expand23 and
the upload pipe, against the JAX package's on the same files and slabs:
bit-equal slabs, the same errors, the same gate; and fused against
staged runs through runner.run with the dtype forced to float32 on the
CPU, within the float32 policy's bounds (PERF.md section 2: indep 1e-5
relative, EM 1e-4 per valid site on the uncorrected distance)."""

import gzip
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu.io import readers as jreaders  # noqa: E402
from ngsdist_tpu.utils.hostmem import PAD23  # noqa: E402
from ngsdist_tpu_torch import runner  # noqa: E402
from ngsdist_tpu_torch.config import NgsDistError, Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.io import readers  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _write_gp(tmp_path, S, N, seed=3, name="gp.bin"):
    rng = np.random.default_rng(seed)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    g[5 % S, 3 % N] = [1, 0, 0]   # one-hot: exp underflow in normalize
    g[(S - 1), N - 1] = [0, 0, 1]
    path = os.path.join(str(tmp_path), name)
    g.astype(np.float64).tofile(path)
    return path, g


def _handle_pars(cls, path, S, N, logscale=False):
    return cls(in_geno=path, in_bin=True, in_probs=True, in_logscale=logscale,
               n_ind=N, n_sites=S, verbose=0, out="o.dist")


def test_bit_equal_full_range_logscale(tmp_path):
    S, N = 301, 17
    path, g = _write_gp(tmp_path, S, N)
    want = jreaders.read_geno_pack23(path, False, N, S)
    got = readers.read_geno_pack23(path, False, N, S)
    assert got.dtype == np.float32 and got.shape == (S, N, 2)
    assert got.tobytes() == want.tobytes()
    for rng_ in ((50, 200), (0, 1), (300, 301)):
        assert (readers.read_geno_pack23(path, False, N, S, site_range=rng_).tobytes()
                == jreaders.read_geno_pack23(path, False, N, S, site_range=rng_).tobytes())

    logp = os.path.join(str(tmp_path), "gl.bin")
    np.log(np.maximum(g, 1e-300)).tofile(logp)
    assert (readers.read_geno_pack23(logp, True, N, S).tobytes()
            == jreaders.read_geno_pack23(logp, True, N, S).tobytes())

    # the handles, and a caller's buffer in place of a new array
    th = readers.PackedBinInput(_handle_pars(Params, path, S, N))
    jh = jreaders.PackedBinInput(_handle_pars(JParams, path, S, N))
    assert th.shape == jh.shape == (S, N, 3)
    assert th.bytes_per_site == jh.bytes_per_site == 8 * N
    assert th.read_packed(40, 190).tobytes() == jh.read_packed(40, 190).tobytes()
    buf = np.full((150, N, 2), -1.0, dtype=np.float32)
    assert th.read_packed(40, 190, out=buf) is buf
    assert buf.tobytes() == want[40:190].tobytes()
    with pytest.raises(ValueError, match="shape"):
        th.read_packed(40, 190, out=buf[:100])
    lh = readers.PackedBinInput(_handle_pars(Params, logp, S, N, logscale=True))
    assert (lh.read_packed(0, S).tobytes()
            == jreaders.read_geno_pack23(logp, True, N, S).tobytes())


def test_error_surface(tmp_path):
    S, N = 64, 5
    path, g = _write_gp(tmp_path, S, N)
    buf = open(path, "rb").read()

    def write(name, blob):
        p = os.path.join(str(tmp_path), name)
        open(p, "wb").write(blob)
        return p

    def same_error(p, needle, **kw):
        with pytest.raises(NgsDistError, match=needle) as got:
            readers.read_geno_pack23(p, False, N, S, **kw)
        with pytest.raises(Exception, match=needle) as want:
            jreaders.read_geno_pack23(p, False, N, S, **kw)
        assert str(got.value) == str(want.value)

    same_error(write("trunc.bin", buf[:-40]), "premature EOF")
    over = write("over.bin", buf + b"\0" * 8)
    same_error(over, "not at EOF")
    # a ranged read that does not run to n_sites ignores trailing bytes
    assert readers.read_geno_pack23(over, False, N, S, site_range=(0, S - 1)) is not None
    # NaN outranks premature EOF (complete triples are normalized first)
    gn = g.copy()
    gn[10, 2] = np.nan
    nanp = write("nan.bin", gn.tobytes()[:-40])
    same_error(nanp, "NaN found")
    # through the handle the NaN surfaces when its chunk is read, not before
    th = readers.PackedBinInput(_handle_pars(Params, write("nan2.bin", gn.tobytes()), S, N))
    assert th.read_packed(0, 10) is not None
    with pytest.raises(NgsDistError, match="NaN found"):
        th.read_packed(10, 20)


@pytest.mark.parametrize("lane", ["pack23", "pack16", "codes"])
@pytest.mark.parametrize("last", ["ERANGE", "EDOM"])
def test_pieces_taken_in_turn(tmp_path, lane, last):
    """A range of six pieces (ND_PACK_PIECE_TRIPLES = 16,384 triples),
    which the native workers take from a shared counter: the slab's bytes
    equal the JAX package's reader, and so does a fatal's errno, the last
    one in triple order: a zero component (log: ERANGE) and a negative
    one (log: EDOM, and a NaN) in different pieces, either way round."""
    S, N = 2100, 40
    path, g = _write_gp(tmp_path, S, N)
    read = getattr(readers, f"read_geno_{lane}")
    jread = getattr(jreaders, f"read_geno_{lane}")

    def slab(got):
        return (got[0] if isinstance(got, tuple) else got).tobytes()

    assert slab(read(path, False, N, S)) == slab(jread(path, False, N, S))
    assert (slab(read(path, False, N, S, site_range=(3, 2011)))
            == slab(jread(path, False, N, S, site_range=(3, 2011))))
    early, late = 20, 1900   # sites in the first and the fifth piece
    bad = g.copy()
    bad[early if last == "ERANGE" else late, 7] = [0.5, -0.25, 0.75]
    bad[late if last == "ERANGE" else early, 9] = [0.0, 0.5, 0.5]
    bad[5, 3] = bad[S - 1, N - 1] = [0.2, 0.3, 0.5]   # no other zero
    p = os.path.join(str(tmp_path), "bad.bin")
    bad.tofile(p)
    with pytest.raises(NgsDistError, match="NaN found") as got:
        read(p, False, N, S)
    with pytest.raises(Exception, match="NaN found") as want:
        jread(p, False, N, S)
    assert got.value.err == want.value.err == getattr(__import__("errno"), last)


def test_gzip_falls_back_to_none(tmp_path):
    S, N = 32, 4
    path, _ = _write_gp(tmp_path, S, N)
    gz = os.path.join(str(tmp_path), "gp.gz.bin")  # gz magic, raw name
    with open(path, "rb") as s, gzip.open(gz, "wb") as d:
        shutil.copyfileobj(s, d)
    assert readers.read_geno_pack23(gz, False, N, S) is None
    assert readers.read_geno_pack23("-", False, N, S) is None
    for p in (path, gz, "-", str(tmp_path), os.path.join(str(tmp_path), "absent")):
        assert readers.is_raw_seekable_binary(p) == jreaders.is_raw_seekable_binary(p)
    assert readers.is_raw_seekable_binary(path) and not readers.is_raw_seekable_binary(gz)
    with pytest.raises(NgsDistError, match="cannot read binary GENO file"):
        readers.PackedBinInput(_handle_pars(Params, gz, S, N)).read_packed(0, 4)


@pytest.mark.parametrize("shape", [(7, 3, 2), (64, 5, 2), (1, 1, 2)])
def test_expand23_bit_equal_to_jax(shape):
    """A float32 packed slab with sentinel rows (p0 = PAD23: padding and
    all-zero triples) expands to the JAX function's bits, into a new
    tensor and into a caller's slice."""
    rng = np.random.default_rng(shape[0])
    P2 = rng.dirichlet(np.ones(3), size=shape[:2])[..., :2].astype(np.float32)
    P2[rng.random(shape[:2]) < 0.2] = (PAD23, 0.0)
    P2[0, 0] = (PAD23, 0.0)
    want = np.asarray(jdist.expand23(jnp.asarray(P2)))
    assert want.dtype == np.float32 and (want[0, 0] == 0).all()
    got = tdist.expand23(torch.from_numpy(P2))
    assert got.numpy().tobytes() == want.tobytes()
    big = torch.full((shape[0] + 2, shape[1], 3), 7.0, dtype=torch.float32)
    tdist.expand23(torch.from_numpy(P2), out=big[1:-1])
    assert big[1:-1].numpy().tobytes() == want.tobytes()
    assert (big[0] == 7).all() and (big[-1] == 7).all()


@pytest.fixture
def f32_engine(monkeypatch):
    """Force the card's dtype policy on the CPU: the fused read is
    float32 only."""
    monkeypatch.setattr(tdist, "default_dtype", lambda device, x64: torch.float32)
    return tdist


def test_runner_gating(tmp_path, monkeypatch):
    """_fused_packed_wanted: on for a raw binary file on a float32
    device, off for text, gzip and stdin, float64, calling, models 3-6,
    verbose >= 8 and NGSDIST_FUSED_READ=0 — the JAX gate's cases
    (tests/test_fused_read.py), the engine and mesh arguments aside."""
    S, N = 16, 3
    path, _ = _write_gp(tmp_path, S, N, seed=2)
    gz = os.path.join(str(tmp_path), "z.bin")
    with open(path, "rb") as s, gzip.open(gz, "wb") as d:
        shutil.copyfileobj(s, d)
    base = dict(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                n_sites=S, indep_geno=True, verbose=0)
    cuda = torch.device("cuda")  # the policy's float32 device; no card needed
    assert runner._fused_packed_wanted(Params(**base), cuda)
    assert not runner._fused_packed_wanted(Params(**base), CPU)
    for change in ({"in_geno": "-"}, {"in_geno": gz}, {"in_bin": False},
                   {"call_geno": True}, {"evol_model": 4}, {"verbose": 8}):
        assert not runner._fused_packed_wanted(Params(**{**base, **change}), cuda), change
    monkeypatch.setattr(tdist, "default_dtype", lambda device, x64: torch.float32)
    assert runner._fused_packed_wanted(Params(**base), CPU)
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    assert not runner._fused_packed_wanted(Params(**base), cuda)


def _run(tmp_path, monkeypatch, path, S, N, tag, fused_env, budget, **kw):
    monkeypatch.setenv("NGSDIST_FUSED_READ", fused_env)
    if budget is None:
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    else:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    handles = []
    orig = runner.load_inputs

    def spy(pars, **kw):
        got = orig(pars, **kw)
        handles.append(type(got[2]).__name__)
        return got

    monkeypatch.setattr(runner, "load_inputs", spy)
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N, n_sites=S,
                  evol_model=0, seed=5, n_boot_rep=2, boot_block_size=10, verbose=0,
                  out=os.path.join(str(tmp_path), f"{tag}.dist"), **kw)
    mats = runner.run(pars, CPU)
    monkeypatch.setattr(runner, "load_inputs", orig)
    return mats, handles[0]


@pytest.mark.parametrize("budget", [None, 40000], ids=["resident", "chunked"])
@pytest.mark.parametrize("indep", [True, False], ids=["indep", "em"])
def test_runner_fused_matches_staged(tmp_path, monkeypatch, f32_engine, budget, indep):
    """runner.run on a float32 device: the fused route (a handle, its
    slabs uploaded through the pipe and expanded there) against the
    staged one (the float64 tensor cast to float32), resident and in
    chunks, with 2 bootstrap replicates; and both against the float64
    run.  The two float32 tensors differ in p2 by one rounding, so the
    matrices agree within the policy's bounds, not bit for bit."""
    S, N = 600, 8
    path, _ = _write_gp(tmp_path, S, N, seed=11)
    kw = dict(indep_geno=indep, pairwise_del=indep)
    fused, h_fused = _run(tmp_path, monkeypatch, path, S, N, "fused", "auto", budget, **kw)
    staged, h_staged = _run(tmp_path, monkeypatch, path, S, N, "staged", "0", budget, **kw)
    assert (h_fused, h_staged) == ("PackedBinInput", "ndarray")
    monkeypatch.undo()
    exact, _ = _run(tmp_path, monkeypatch, path, S, N, "f64", "auto", None, **kw)
    assert len(fused) == len(staged) == len(exact) == 3
    for f, s, e in zip(fused, staged, exact):
        assert np.isfinite(f).all()
        if indep:
            np.testing.assert_allclose(f, s, rtol=1e-5, atol=0)
            np.testing.assert_allclose(f, e, rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(f, s, rtol=0, atol=1e-4)
            np.testing.assert_allclose(f, e, rtol=0, atol=1e-4)


def test_fused_chunked_equals_fused_resident(tmp_path, monkeypatch, f32_engine):
    """The chunks are slices of the same float32 tensor, whichever way it
    reached the device: a chunked fused run re-reads the file per
    replicate and differs from the resident one only by the order of
    its float32 sums."""
    S, N = 600, 8
    path, _ = _write_gp(tmp_path, S, N, seed=11)
    kw = dict(indep_geno=True, pairwise_del=True)
    reads = []
    orig = readers.PackedBinInput.read_packed

    def spy(self, lo, hi, out=None):
        reads.append((lo, hi))
        return orig(self, lo, hi, out=out)

    monkeypatch.setattr(readers.PackedBinInput, "read_packed", spy)
    resident, _ = _run(tmp_path, monkeypatch, path, S, N, "res", "auto", None, **kw)
    assert reads == [(0, 600)]  # one pass, one slab at this size
    reads.clear()
    chunked, _ = _run(tmp_path, monkeypatch, path, S, N, "chk", "auto", 40000, **kw)
    chunk = tdist.stream_plan(S, N, CPU, None, False)[1]
    ranges = [(lo, min(lo + chunk, S)) for lo in range(0, S, chunk)]
    assert len(ranges) > 3 and reads == ranges * 3  # full data and each replicate
    for c, r in zip(chunked, resident):
        np.testing.assert_allclose(c, r, rtol=1e-5, atol=0)


@pytest.mark.parametrize("source", ["array", "handle"])
@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
def test_pipe_yields_every_range_once_in_order(tmp_path, source, resident):
    """ChunkPipe.chunks: every range once, in order, each chunk the
    slice of the whole tensor, for a host array and for a fused-read
    handle, as a stream and into a resident tensor; ragged last range."""
    S, N = 103, 6
    path, g = _write_gp(tmp_path, S, N, seed=4)
    if source == "array":
        src, dtype = g / g.sum(-1, keepdims=True), torch.float64
        whole = torch.from_numpy(src)
    else:
        src, dtype = readers.PackedBinInput(_handle_pars(Params, path, S, N)), torch.float32
        whole = tdist.expand23(torch.from_numpy(src.read_packed(0, S)))
    ranges = [(lo, min(lo + 16, S)) for lo in range(0, S, 16)]
    dest = torch.zeros((S, N, 3), dtype=dtype) if resident else None
    pipe = tdist.ChunkPipe(src, CPU, dtype, 16, dest=dest)
    seen = []
    for Pc, lo, hi in pipe.chunks(ranges):
        seen.append((lo, hi))
        assert Pc.dtype == dtype and torch.equal(Pc, whole[lo:hi])
    assert seen == ranges and seen[-1] == (96, 103)
    if resident:
        assert torch.equal(dest, whole)
    assert list(pipe.chunks([])) == []
    # a second pass over the same pipe (a replicate) gives the same chunks
    assert [(lo, hi) for _, lo, hi in pipe.chunks(ranges[2:])] == ranges[2:]


def test_upload_resident_of_a_handle(tmp_path, monkeypatch, f32_engine):
    """The resident upload of a handle in several slabs
    (NGSDIST_PIPE_UPLOAD_BYTES; a value that is no integer is ignored)
    equals the expansion of one read."""
    S, N = 257, 5
    path, _ = _write_gp(tmp_path, S, N, seed=6)
    src = readers.PackedBinInput(_handle_pars(Params, path, S, N))
    whole = tdist.expand23(torch.from_numpy(src.read_packed(0, S)))
    monkeypatch.setenv("NGSDIST_PIPE_UPLOAD_BYTES", "many")
    assert tdist._pipe_upload_bytes() == tdist.PIPE_UPLOAD_BYTES
    monkeypatch.setenv("NGSDIST_PIPE_UPLOAD_BYTES", "5")
    assert tdist._pipe_upload_bytes() == 1 << 20
    monkeypatch.setattr(tdist, "_pipe_upload_bytes", lambda: 40 * N * 8)
    reads = []
    orig = src.read_packed
    src.read_packed = lambda lo, hi, out=None: reads.append((lo, hi)) or orig(lo, hi, out=out)
    P = tdist.upload_resident(src, CPU, False)
    assert reads == [(lo, min(lo + 40, S)) for lo in range(0, S, 40)]
    assert P.dtype == torch.float32 and torch.equal(P, whole)
