"""The port's host-packed upload lanes against the JAX package's
(ngsdist_tpu/utils/hostmem.py, tests/test_upload16.py), on the CPU.

Two components a triple (pack23; p2 = 1 - p0 - p1 restored on the
device by expand23) in the engine's dtype, or uint16 fixed point (pack16,
q = rint(p · 65534), 65535 the row sentinel):

(a) the grid argument: one step of 1/65534 exceeds EPSILON and 3 q =
    65534 has no integer solution, so no quantized data triple tests
    missing after the expansion; missingness is the host's decision;
(b) pack16, pack23 and the fused read_geno_pack16 are the JAX functions'
    bytes, pad tails, missing, one-hot, all-zero and NaN rows included;
(c) expand23's uint16 and float halves are the JAX function's bits;
(d) the lane rule as a function of the device, the dtype and
    NGSDIST_UPLOAD23 / NGSDIST_UPLOAD16, against the JAX rule with its
    backend set to the device's;
(e) every route takes the lane: the runner's handle, the staged upload
    of a host array, the streamed chunks, a mesh's shards and rounds, and
    a lazy stream's disk rows, each run against its pack23 twin with the
    dtype forced to float32 on the CPU (the card's policy) and the lane
    forced on (NGSDIST_UPLOAD16=1), cnt exact, raw within the
    quantization bound of PERF.md section 2.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu.io import readers as jreaders  # noqa: E402
from ngsdist_tpu.utils import hostmem as jhostmem  # noqa: E402
from ngsdist_tpu_torch import runner  # noqa: E402
from ngsdist_tpu_torch.config import Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.core.preprocess import preprocess  # noqa: E402
from ngsdist_tpu_torch.io import readers  # noqa: E402
from ngsdist_tpu_torch.ops.em import EM_MAX_ITER  # noqa: E402
from ngsdist_tpu_torch.ops.indep import valid_mask  # noqa: E402
from ngsdist_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngsdist_tpu_torch.parallel import multihost as pmh  # noqa: E402
from ngsdist_tpu_torch.utils import hostmem  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)   # a device object: the lane rule needs no card
LANE_ENV = ("NGSDIST_UPLOAD23", "NGSDIST_UPLOAD16", "NGSDIST_FUSED_READ",
            "NGSDIST_DEVICE_BUDGET", "NGSDIST_HOST_BUDGET", "NGSDIST_CODED_UPLOAD")
# Per triple, the summed |component| difference between the uint16 lane
# and the float32 pair lane (PERF.md section 2): p0 and p1 half a step
# each, p2 their sum, a missing row's components up to EPSILON from its
# mean besides, and six float32 roundings.  On d = raw / cnt (model 0)
# with the same valid sites: indep smax (2 DELTA + DELTA^2), smax = 1 the
# largest |score|, and the float32 plain versions' own error twice; the
# EM smax min(1, 24 EM_MAX_ITER DELTA) (a lane's contribution is a score
# expectation under p^k / sum p^k, which moves by at most 12 k DELTA in
# L1 per side while k stays, and by at most smax when k moves).
DELTA = 3 * (1e-5 + 0.5 / hostmem.U16_ONE) + 6 * 2.0 ** -24
INDEP_D_BOUND = 2 * DELTA + DELTA ** 2 + 4e-6
EM_D_BOUND = min(1.0, 24 * EM_MAX_ITER * DELTA)


def _probs(S, N, seed=0):
    """tests/test_upload16.py's triples: Dirichlet, exactly uniform
    (missing), one-hot, data-borne all-zero rows and sites."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[::17] = 1.0 / 3.0
    P[3::29, N // 2] = [0, 0, 1]
    P[7::31, N // 3] = [1, 0, 0]
    P[11::37, N // 4] = [0, 0, 0]
    P[5::41] = 0.0
    return P


@pytest.fixture
def lanes(monkeypatch):
    """A clean lane environment; returns a setter for the two switches."""
    for k in LANE_ENV:
        monkeypatch.delenv(k, raising=False)

    def set_lane(u23=None, u16=None):
        for name, v in (("NGSDIST_UPLOAD23", u23), ("NGSDIST_UPLOAD16", u16)):
            if v is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, v)
    return set_lane


@pytest.fixture
def f32_engine(monkeypatch):
    """The card's dtype policy on the CPU (float32), as
    tests/test_torch_fused.py forces it."""
    monkeypatch.setattr(tdist, "default_dtype", lambda device, x64: torch.float32)


# ------------------------------------------------------------------ #
# (a) the grid                                                        #
# ------------------------------------------------------------------ #


def test_no_quantized_data_triple_tests_missing():
    """Every grid pair (q0, q1) where the expanded triple could come
    within EPSILON of all-equal — q1 within a step of q0, or of
    (65534 - q0) / 2 — expands (uint16 half of expand23, float32) to a
    triple the device's missing test keeps valid."""
    q0 = np.arange(0, hostmem.U16_ONE + 1)
    cands = []
    for base in (q0, (hostmem.U16_ONE - q0) // 2):
        for d in (-1, 0, 1):
            cands.append(np.stack([q0, base + d], -1))
    Q = np.concatenate(cands)
    Q = Q[(Q[:, 1] >= 0) & (Q.sum(-1) <= hostmem.U16_ONE)].astype(np.uint16)
    P3 = tdist.expand23(torch.from_numpy(Q)[:, None, :])
    assert P3.dtype == torch.float32
    assert bool(valid_mask(P3, True).all())


def test_borderline_rows_classify_as_the_host(lanes):
    """Triples within a step of the EPSILON edge: missing on the device
    after the uint16 round trip exactly where the float64 host test says
    so (tests/test_upload16.py's case)."""
    base, deltas = 0.3333, np.linspace(-3e-5, 3e-5, 101)
    P = np.empty((101, 1, 3))
    for i, d in enumerate(deltas):
        P[i, 0] = [base + d, base, 1.0 - (base + d) - base]
    host = (np.abs(P[..., 0] - P[..., 1]) < 1e-5) & (np.abs(P[..., 1] - P[..., 2]) < 1e-5)
    dev = tdist.expand23(torch.from_numpy(hostmem.pack16(P)))
    np.testing.assert_array_equal(~valid_mask(dev, True).bool().numpy(), host)


# ------------------------------------------------------------------ #
# (b) the packers and the fused reader                                #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("n_rows", [None, 640], ids=["exact", "pad_tail"])
def test_pack16_and_pack23_are_the_jax_bytes(lanes, n_rows):
    """pack16, and pack23 on each lane (uint16 on a card, float32 pairs
    on the CPU or under NGSDIST_UPLOAD16=0, float64 pairs forced), are the
    JAX functions' bytes with NaN rows, pad tails and a caller's buffer."""
    P = _probs(600, 8)
    P[13, 2] = np.nan
    P[20, 3] = [np.nan, 0.5, 0.5]
    want16 = jhostmem.pack16(P, n_rows)
    got16 = hostmem.pack16(P, n_rows)
    assert got16.dtype == np.uint16 and got16.tobytes() == want16.tobytes()
    assert (got16[13, 2] == hostmem.PAD16).all()
    buf = np.full_like(want16, 7)
    assert hostmem.pack16(P, n_rows, out=buf) is buf and buf.tobytes() == want16.tobytes()
    # the JAX pack23 routes on its backend (the CPU: float32 pairs)
    want23 = jhostmem.pack23(P, np.float32, n_rows)
    got23 = hostmem.pack23(P, torch.float32, CPU, n_rows)
    assert got23.dtype == np.float32 and got23.tobytes() == want23.tobytes()
    # a card's pack23 is pack16
    assert hostmem.pack23(P, torch.float32, CUDA, n_rows).tobytes() == want16.tobytes()
    lanes(u16="0")
    assert hostmem.pack23(P, torch.float32, CUDA, n_rows).tobytes() == want23.tobytes()
    lanes(u23="1", u16="1")
    got64 = hostmem.pack23(P, torch.float64, CUDA, n_rows)
    assert got64.dtype == np.float64
    assert got64.tobytes() == jhostmem.pack23(P, np.float64, n_rows).tobytes()
    with pytest.raises(ValueError, match="slab"):
        hostmem.pack16(P, n_rows, out=buf[:10])


def test_parallel_astype_is_the_cast():
    a = _probs(50, 4)
    assert hostmem.parallel_astype(a, np.float64) is a
    got = hostmem.parallel_astype(a, np.float32, max_threads=4)
    assert got.tobytes() == jhostmem.parallel_astype(a, np.float32).tobytes()


def _gp_file(tmp_path, S, N, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    g[5 % S, 3 % N] = [1, 0, 0]
    g[S - 1, N - 1] = [0, 0, 1]
    g[7 % S] = 1.0 / 3.0
    path = os.path.join(str(tmp_path), "gp.bin")
    g.tofile(path)
    return path, g


def _handle_pars(cls, path, S, N, logscale=False):
    return cls(in_geno=path, in_bin=True, in_probs=True, in_logscale=logscale,
               n_ind=N, n_sites=S, verbose=0, out="o.dist")


def test_read_geno_pack16_is_the_jax_read(tmp_path, lanes):
    """The fused uint16 read over site ranges and of a log-scale file is
    the JAX function's bytes and the pack16 of the staged read; the
    port's handle in the uint16 lane reads them, into a caller's buffer
    too, at 4 bytes a triple."""
    S, N = 301, 17
    path, g = _gp_file(tmp_path, S, N)
    want = jreaders.read_geno_pack16(path, False, N, S)
    got = readers.read_geno_pack16(path, False, N, S)
    assert got.dtype == np.uint16 and got.shape == (S, N, 2)
    assert got.tobytes() == want.tobytes()
    staged = preprocess(readers.read_geno(path, True, True, False, N, S), False, 0.0, 0.0)
    assert hostmem.pack16(staged).tobytes() == want.tobytes()
    for rng_ in ((50, 200), (0, 1), (300, 301)):
        assert (readers.read_geno_pack16(path, False, N, S, site_range=rng_).tobytes()
                == jreaders.read_geno_pack16(path, False, N, S, site_range=rng_).tobytes())
    logp = os.path.join(str(tmp_path), "gl.bin")
    np.log(np.maximum(g, 1e-300)).tofile(logp)
    assert (readers.read_geno_pack16(logp, True, N, S).tobytes()
            == jreaders.read_geno_pack16(logp, True, N, S).tobytes())
    lanes(u16="1")   # the JAX handle takes its lane from the backend rule
    jh = jreaders.PackedBinInput(_handle_pars(JParams, path, S, N))
    th = readers.PackedBinInput(_handle_pars(Params, path, S, N), u16=True)
    assert jh.u16 and th.u16 and th.bytes_per_site == jh.bytes_per_site == 4 * N
    assert th.read_packed(40, 190).tobytes() == jh.read_packed(40, 190).tobytes()
    buf = np.zeros((150, N, 2), np.uint16)
    assert th.read_packed(40, 190, out=buf) is buf and buf.tobytes() == want[40:190].tobytes()
    with pytest.raises(ValueError, match="shape"):
        th.read_packed(40, 190, out=buf[:100])


# ------------------------------------------------------------------ #
# (c) expand23                                                        #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("half", ["uint16", "float32"])
def test_expand23_halves_are_the_jax_bits(half):
    """Both halves of expand23 on slabs with every sentinel (missing rows
    with their mean, all-zero rows, NaN rows, pad tails) are the JAX
    function's bits, into a new tensor and into a caller's slice."""
    P = _probs(300, 7, seed=3)
    P[21, 1] = np.nan
    slab = (hostmem.pack16(P, 320) if half == "uint16"
            else jhostmem.pack23(P, np.float32, 320))
    want = np.asarray(jdist.expand23(jnp.asarray(slab)))
    assert want.dtype == np.float32
    got = tdist.expand23(torch.from_numpy(slab))
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    big = torch.full((322, 7, 3), 7.0)
    tdist.expand23(torch.from_numpy(slab), out=big[1:-1])
    assert big[1:-1].numpy().tobytes() == want.tobytes()
    assert (big[0] == 7).all() and (big[-1] == 7).all()
    if half == "uint16":
        assert torch.isnan(got[21, 1]).all() and (got[300:] == 0).all()


# ------------------------------------------------------------------ #
# (d) the lane rule                                                   #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("u23", [None, "0", "1"], ids=["u23_auto", "u23_off", "u23_on"])
@pytest.mark.parametrize("u16", [None, "0", "1"], ids=["u16_auto", "u16_off", "u16_on"])
def test_lane_rule_is_the_jax_rule_on_the_device(lanes, monkeypatch, u23, u16):
    """upload23_enabled and upload16_enabled for every dtype and device
    equal the JAX functions with the backend set to the device's ("gpu"
    for a card); the uint16 lane is off for float64 whatever is forced,
    and NGSDIST_UPLOAD23=0 turns both lanes off."""
    lanes(u23, u16)
    for device, backend in ((CPU, "cpu"), (CUDA, "gpu")):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
            assert hostmem.upload23_enabled(dtype) is jhostmem.upload23_enabled(np_dtype)
            got = hostmem.upload16_enabled(dtype, device)
            assert got is jhostmem.upload16_enabled(np_dtype)
            if dtype == torch.float64 or u23 == "0":
                assert got is False
            width, slab = tdist.slab_layout(np.zeros((1, 1, 3)), dtype, device)
            assert (width, slab) == ((2, torch.uint16) if got else
                                     (2, dtype) if hostmem.upload23_enabled(dtype) else
                                     (3, dtype))


def test_runner_builds_the_handle_of_the_device_lane(tmp_path, lanes):
    """The fused read's gate and handle: uint16 pairs for a card by
    default, float32 pairs under NGSDIST_UPLOAD16=0, no fused read under
    NGSDIST_UPLOAD23=0 (the JAX gate) or --x64."""
    path, _ = _gp_file(tmp_path, 16, 3)
    pars = _handle_pars(Params, path, 16, 3)
    assert runner._fused_packed_wanted(pars, CUDA) is True
    assert runner.load_inputs(pars, fused=True, device=CUDA)[2].u16 is True
    assert runner._fused_packed_wanted(pars, CUDA, x64=True) is False
    lanes(u16="0")
    assert runner.load_inputs(pars, fused=True, device=CUDA)[2].u16 is False
    lanes(u23="0")
    assert runner._fused_packed_wanted(pars, CUDA) is False
    rows = pmh.DiskRows(pars, torch.float32, CUDA, 16)
    assert (rows.width, rows.fused) == (3, False)


# ------------------------------------------------------------------ #
# (e) the routes                                                      #
# ------------------------------------------------------------------ #


def _spy_slabs(monkeypatch):
    """The dtypes of the host slabs every upload sends."""
    seen = []
    orig = tdist._host_pack

    def spy(*a, **k):
        got = orig(*a, **k)
        seen.append(getattr(got, "dtype", None))
        return got

    monkeypatch.setattr(tdist, "_host_pack", spy)
    return seen


def _run(tmp_path, monkeypatch, path, tag, u16, env, mesh, indep, S, N):
    """runner.run on the CPU under NGSDIST_UPLOAD16=u16 and env: the
    matrices and the dtypes of the slabs sent."""
    for k, v in (("NGSDIST_UPLOAD16", u16), *env):
        monkeypatch.setenv(k, v)
    seen = _spy_slabs(monkeypatch)
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N, n_sites=S, seed=5,
                  n_boot_rep=2, boot_block_size=10, verbose=0, indep_geno=indep,
                  pairwise_del=True, evol_model=0,
                  out=os.path.join(str(tmp_path), f"{tag}.dist"))
    mats = runner.run(pars, CPU, mesh=mesh)
    return mats, {str(d).replace("torch.", "") for d in seen}


@pytest.mark.parametrize("route", ["resident", "streamed", "staged", "mesh", "lazy"])
@pytest.mark.parametrize("indep", [True, False], ids=["indep", "em"])
def test_every_route_takes_the_lane(tmp_path, monkeypatch, lanes, f32_engine, route, indep):
    """runner.run with the dtype forced to float32 and the uint16 lane
    forced on the CPU: the fused handle (resident and streamed), the
    staged host array, a 4 x 2 mesh's shards and a lazy stream's disk
    rows all send uint16 slabs, and the matrices agree with the float32
    pair lane's (NGSDIST_UPLOAD16=0): with --pairwise_del the valid sites
    are the same in both lanes, so d = raw / cnt (model 0) moves by the
    quantization of the values alone, within INDEP_D_BOUND (indep) or
    EM_D_BOUND (the EM)."""
    S, N = 600, 8
    path, _ = _gp_file(tmp_path, S, N, seed=11)
    env, mesh = (), None
    if route == "streamed":
        env = (("NGSDIST_DEVICE_BUDGET", str(3 * 64 * N * 3 * 4 * 4 // 3)),)
    if route == "staged":
        env = (("NGSDIST_FUSED_READ", "0"),)
    if route == "mesh":
        mesh = pm.make_mesh([CPU] * 8, pairs=2)
    if route == "lazy":
        env = (("NGSDIST_HOST_BUDGET", "20000"),)
    got16, slabs16 = _run(tmp_path, monkeypatch, path, "u16", "1", env, mesh, indep, S, N)
    got32, slabs32 = _run(tmp_path, monkeypatch, path, "f32", "0", env, mesh, indep, S, N)
    assert slabs16 == {"uint16"} and slabs32 == {"float32"}, (slabs16, slabs32)
    assert len(got16) == len(got32) == 3
    bound = INDEP_D_BOUND if indep else EM_D_BOUND
    for a, b in zip(got16, got32):
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert np.abs(a - b).max() <= bound


def test_stream_rounds_of_uint16_slabs_hold_the_full_upload(monkeypatch, lanes, f32_engine):
    """A SiteStream over a host array on the uint16 lane: every round of
    every shard of an 8 x 1 mesh, staged through the shards' pipes in
    uint16 slabs, is the slice of the resident sharded upload, bit for
    bit; the ragged last shard and round included."""
    lanes(u16="1")
    S, N = 100, 6
    P = _probs(S, N, seed=5)
    pars = Params(in_geno="x", n_ind=N, n_sites=S, in_probs=True, out="o", verbose=0)
    mesh = pm.make_mesh([CPU] * 8)
    seen = _spy_slabs(monkeypatch)
    full = pmh.SiteStream(P, pars, mesh, 13, 13).global_array()
    stream = pmh.SiteStream(P, pars, mesh, 13, 5)
    assert stream.n_rounds == 3 and not stream.resident
    for r, data in stream.rounds(range(stream.n_rounds)):
        for k, (lo, hi) in enumerate(data.ranges):
            if hi > lo:
                off = lo - full.ranges[k][0]
                assert torch.equal(data.parts[k], full.parts[k][off:off + hi - lo])
    assert seen and {str(d) for d in seen} == {"uint16"}
    assert all(p.dtype == torch.float32 for p in full.parts if p is not None)
