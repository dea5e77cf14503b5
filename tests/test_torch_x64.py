"""--x64 in the port: float64 on a card, the JAX package's md5 mode.

The CLI with --x64 on the CPU (whose path is float64 either way) writes
every golden's md5 and takes the x64 choice down to every planner; the
dtype policy on a `torch.device("cuda", 0)` object (no card needed,
nothing allocated) plans in float64 itemsize as the JAX package does
under x64 and declines the fused, coded and packed lanes as its `auto`
rules do; a resume refuses a checkpoint of the other precision; the
float64 kernels' arithmetic (ops/em.py em_raw_cnt_tables, ops/indep.py
indep_raw_cnt_f64_order) lies within its stated bounds of the JAX
package's XLA functions under x64 (tests/conftest.py enables it); and a
float64 tensor goes to the float64 entries of the kernel library or
raises, never to a float32 one.  The kernels themselves are held on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import contextlib
import ctypes
import hashlib
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.config import default_score_matrix  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu.core import em as jem  # noqa: E402
from ngsdist_tpu.parallel import mesh as jpm  # noqa: E402
from ngsdist_tpu.parallel.multihost import SiteStream as JStream  # noqa: E402
from ngsdist_tpu.utils import hostmem as jhostmem  # noqa: E402
from ngsdist_tpu_torch import cli, runner  # noqa: E402
from ngsdist_tpu_torch.config import Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.ops import _build, em, indep  # noqa: E402
from ngsdist_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngsdist_tpu_torch.parallel import multihost as pmh  # noqa: E402
from ngsdist_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from ngsdist_tpu_torch.utils import hostmem  # noqa: E402

from conftest import DATA_DIR, FIXTURES  # noqa: E402

torch.set_num_threads(2)

MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)   # a device object only: nothing is allocated on it


# ------------------------------------------------------------------ #
# The CLI on the CPU                                                  #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_x64_cli_golden_md5(name, tmp_path, monkeypatch):
    """--x64 --platform cpu is accepted and writes each golden's bytes."""
    monkeypatch.chdir(DATA_DIR)
    out = str(tmp_path / f"{name}.dist")
    args = [a.replace("{OUT}", out) for a in MANIFEST[name]["args"]]
    assert cli.main(args + ["--platform", "cpu", "--x64", "--verbose", "0"]) == 0
    assert hashlib.md5(open(out, "rb").read()).hexdigest() == MANIFEST[name]["md5"]


def test_x64_on_cuda_without_a_card_errors(tmp_path, monkeypatch, capsys):
    """--x64 --platform cuda without a card is the error it always was."""
    monkeypatch.chdir(DATA_DIR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--geno", "gp.bin", "--probs", "--n_ind", "20", "--n_sites", "1200",
            "--out", str(tmp_path / "x.dist"), "--verbose", "0", "--x64", "--platform", "cuda"]
    assert cli.main(args) == 255
    assert "no CUDA device is available" in capsys.readouterr().err


# Runs that reach every planner: resident with its bootstrap, streamed
# under a small device budget, a mesh with a pairs axis, that mesh
# streamed, models 3-6 streamed, a lazy (disk-read) run and models 3-6 on
# a mesh.  (flags, environment)
_STREAM = {"NGSDIST_DEVICE_BUDGET": str(3 * 40 * 20 * 3 * 8)}
X64_RUNS = {
    "resident": ("--geno gp.bin --probs --n_boot_rep 2 --boot_block_size 100", {}),
    "streamed": ("--geno gl.beagle.gz --probs --n_boot_rep 2 --boot_block_size 50", _STREAM),
    "mesh": ("--geno gp.geno.gz --probs --indep_geno --pairwise_del --n_boot_rep 2 "
             "--boot_block_size 40 --devices 4 --pairs 2", {}),
    "mesh_streamed": ("--geno gl.beagle.gz --probs --n_boot_rep 1 --boot_block_size 50 "
                      "--devices 2", _STREAM),
    "models_streamed": ("--geno gl.beagle.gz --probs --pos pos.txt --evol_model 6 "
                        "--n_boot_rep 1 --boot_block_size 50", _STREAM),
    "lazy": ("--geno gp.bin --probs --indep_geno --n_boot_rep 1 --boot_block_size 100",
             {"NGSDIST_HOST_BUDGET": "1000"}),
    "models_mesh": ("--geno gl.beagle.gz --probs --pos pos.txt --evol_model 5 --indep_geno "
                    "--devices 2", {}),
}


@pytest.mark.parametrize("run", sorted(X64_RUNS))
def test_x64_reaches_every_planner(run, tmp_path, monkeypatch):
    """Every call of the dtype policy in an --x64 run is asked with x64
    (a planner that missed it would ask for float32's itemsize on a
    card), and on the CPU the bytes are those of the run without it."""
    flags, env = X64_RUNS[run]
    monkeypatch.chdir(DATA_DIR)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    asked = []
    policy = tdist.default_dtype

    def spy(device, x64):
        asked.append(x64)
        return policy(device, x64)

    base = flags.split() + ["--n_ind", "20", "--n_sites", "1200", "--seed", "3",
                            "--verbose", "0", "--platform", "cpu"]
    plain = tmp_path / "plain.dist"
    assert cli.main(base + ["--out", str(plain)]) == 0
    monkeypatch.setattr(tdist, "default_dtype", spy)
    got = tmp_path / "x64.dist"
    assert cli.main(base + ["--out", str(got), "--x64"]) == 0
    assert asked and all(asked), asked
    assert got.read_bytes() == plain.read_bytes()


def test_x64_reaches_every_planner_of_a_process_run(tmp_path, monkeypatch):
    """The same through run_distributed, in one process on two `cpu`
    entries, streamed."""
    monkeypatch.chdir(DATA_DIR)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", _STREAM["NGSDIST_DEVICE_BUDGET"])
    asked = []
    policy = tdist.default_dtype
    monkeypatch.setattr(tdist, "default_dtype",
                        lambda device, x64: asked.append(x64) or policy(device, x64))
    kw = dict(in_geno="gl.beagle.gz", in_probs=True, n_ind=20, n_sites=1200, seed=3,
              n_boot_rep=1, boot_block_size=50, verbose=0)
    got = runner.run_distributed(Params(out=str(tmp_path / "x.dist"), **kw),
                                 mesh=pm.make_mesh([CPU] * 2), x64=True)
    assert asked and all(asked)
    want = runner.run_distributed(Params(out=str(tmp_path / "y.dist"), **kw),
                                  mesh=pm.make_mesh([CPU] * 2))
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want))


# ------------------------------------------------------------------ #
# The dtype policy on a card                                          #
# ------------------------------------------------------------------ #


def test_x64_dtype_and_engine_name():
    assert tdist.default_dtype(CUDA, True) == torch.float64
    assert tdist.default_dtype(CUDA, False) == torch.float32
    assert tdist.default_dtype(CPU, True) == tdist.default_dtype(CPU, False) == torch.float64
    assert tdist.engine_name(CUDA, True) == "torch-cuda-float64"
    assert tdist.engine_name(CUDA, False) == "torch-cuda-float32"
    assert tdist.engine_name(CPU, True) == tdist.engine_name(CPU, False) == "torch-cpu-float64"


def test_x64_partials_rule_is_the_jax_rule_in_float64():
    """use_partials under x64 is the JAX rule with itemsize 8.  chip_smoke's
    run (xd) sits exactly on the budget: 64 blocks x 1024^2 x 8 B x 2 =
    2^30 B = PARTIALS_BUDGET_BYTES, and <= takes the partials route."""
    n = 1024
    assert 64 * n * n * 8 * 2 == tdist.PARTIALS_BUDGET_BYTES == jdist.PARTIALS_BUDGET_BYTES
    for n_blocks, pdel in ((64, True), (65, True), (64, False), (128, False), (129, False),
                           (256, True), (1, True)):
        jax_rule = n_blocks * n * n * 8 * (2 if pdel else 1) <= jdist.PARTIALS_BUDGET_BYTES
        assert tdist.use_partials(n_blocks, n, pdel, CUDA, True) == jax_rule
    # the float32 card halves the itemsize: (xd)'s 64 blocks are far inside
    assert tdist.use_partials(128, n, True, CUDA, False)
    assert not tdist.use_partials(128, n, True, CUDA, True)


@pytest.mark.parametrize("S,N,budget", [(1200, 20, 3 * 40 * 20 * 3 * 8),
                                        (65536, 1024, 3 << 30), (262144, 1024, 6 << 30),
                                        (5_000_000, 2048, 12 << 30), (4096, 1024, 1 << 34)])
def test_x64_stream_plan_is_the_jax_plan(S, N, budget, monkeypatch):
    """Under NGSDIST_DEVICE_BUDGET a card under x64 streams where the JAX
    engine does, in the chunk edges of its _stream_chunk_sites(S, N, 8,
    budget / 3)."""
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    jbudget = jdist._device_budget_bytes()
    chunked = S * N * 3 * 8 > jbudget
    want = (chunked, jdist._stream_chunk_sites(S, N, 8, jbudget) if chunked else S)
    assert tdist.stream_plan(S, N, CUDA, None, True) == want
    assert tdist.stream_plan(S, N, CPU, None, True) == want


def test_x64_fits_in_float64_bytes(monkeypatch):
    """A card left to itself reckons the tensor and the working set in 8
    bytes a value under x64."""
    free = 80 << 30
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, free))
    S, N = 65536, 1024
    left = {x64: tdist.check_fits(S, N, CUDA, True, x64) for x64 in (False, True)}
    ws = {x64: tdist.working_set_bytes(S, N, CUDA, True, x64) for x64 in (False, True)}
    assert ws[True] - ws[False] == (4 * N * N + S) * 4
    assert left[False] - left[True] == S * N * 3 * 4 + ws[True] - ws[False]
    # (a)'s 1024 x 65,536 stays resident in float64: 1.6 GB of 80
    assert tdist.stream_plan(S, N, CUDA, left[True], True) == (False, S)


@pytest.mark.parametrize("indep_geno", [False, True])
@pytest.mark.parametrize("boot", [False, True])
def test_x64_site_stream_plan_is_the_jax_plan(indep_geno, boot, monkeypatch):
    """SiteStream's plan over a mesh of card entries under x64 is the JAX
    package's SiteStream._plan in float64, resident and in rounds."""
    for budget in (1 << 34, 3 * 512 * 64 * 3 * 8, 3 * 100 * 64 * 3 * 8):
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
        kw = dict(n_ind=64, n_sites=5000, indep_geno=indep_geno,
                  n_boot_rep=2 if boot else 0, boot_block_size=50 if boot else 1)
        got = pmh.SiteStream._plan(Params(**kw), pm.make_mesh([CUDA] * 4), True)
        want = JStream._plan(JParams(**kw), jpm.make_mesh(n_devices=4), np.float64)
        assert got == want, budget


def test_x64_route_rules_decline_the_float32_lanes(monkeypatch):
    """Under x64 a card reads staged and uploads float64, as the JAX
    package's auto rules do: no fused pack23 read (upload23_enabled), no
    code plane (coded_upload_enabled), no fused codes read, and a lazy
    stream's rows staged; the float32 card takes each of them."""
    monkeypatch.chdir(DATA_DIR)
    for k in ("NGSDIST_DEVICE_BUDGET", "NGSDIST_FUSED_READ", "NGSDIST_CODED_UPLOAD",
              "NGSDIST_UPLOAD23", "NGSDIST_HOST_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (80 << 30, 80 << 30))
    gp = Params(in_geno="gp.bin", in_bin=True, in_probs=True, n_ind=20, n_sites=1200)
    called = Params(in_geno="gp.bin", in_bin=True, in_probs=True, call_geno=True, n_ind=20,
                    n_sites=1200)
    for x64 in (False, True):
        f32 = not x64
        dtype = tdist.default_dtype(CUDA, x64)
        np_dtype = np.float64 if x64 else np.float32
        assert runner._fused_packed_wanted(gp, CUDA, None, x64) is f32
        assert jhostmem.upload23_enabled(np_dtype) is f32
        assert hostmem.coded_upload_enabled(dtype) is jhostmem.coded_upload_enabled(np_dtype)
        assert hostmem.coded_upload_enabled(dtype) is f32
        assert (runner._fused_coded_wanted(called, CUDA, None, x64) == "handle") is f32
        assert pmh.SiteStream.wants_coded_lazy(called, dtype) is f32
        rows = pmh.DiskRows(gp, dtype, CUDA, 1200)
        assert rows.fused is f32 and rows.u16 is f32
        assert rows.width == (2 if f32 else 3)


# ------------------------------------------------------------------ #
# Resume across precisions                                            #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("x64", [True, False], ids=["f32_file_x64_run", "x64_file_f32_run"])
def test_x64_resume_refuses_the_other_precision(x64, tmp_path):
    """A matrix checkpoint and a round checkpoint written by a card run of
    the other precision are refused: the replicate is recomputed from its
    first round; the writer's own precision resumes them."""
    out = str(tmp_path / "o.dist")
    open(out, "w").write("two matrices\n")
    pars = Params(in_geno=os.path.join(DATA_DIR, "gp.bin"), in_bin=True, in_probs=True,
                  n_ind=20, n_sites=1200, n_boot_rep=3, boot_block_size=100, out=out)
    written = tdist.engine_name(CUDA, not x64)
    ckpt.save(out, pars, 2, engine=written)
    assert ckpt.load(out, pars, engine=written) == 2
    assert ckpt.load(out, pars, engine=tdist.engine_name(CUDA, x64)) is None

    ckpt.save_rounds(out, pars, 1, 3, {"raw": np.full(3, 7.0)}, engine=written, chunk=64)
    assert ckpt.load_rounds(out, pars, 1, engine=written, chunk=64)[0] == 3
    skips = []

    def rounds(skip):
        skips.append(skip)
        yield from range(skip, 4)

    acc = tdist._round_sums(pars, 1, True, CUDA, x64, 64, rounds,
                            lambda r: {"raw": torch.full((3,), float(r), dtype=torch.float64)})
    assert skips == [0] and acc["raw"].tolist() == [6.0] * 3
    # the run's own file now carries the run's precision
    assert ckpt.load_rounds(out, pars, 1, engine=tdist.engine_name(CUDA, x64), chunk=64)[0] == 4


# ------------------------------------------------------------------ #
# The float64 kernels' arithmetic against the JAX package under x64    #
# ------------------------------------------------------------------ #


def _probs(seed, S, N, missing=0.15):
    """Dirichlet triples with missing (uniform) rows and one slow lane; no
    all-zero or NaN row (the JAX engine runs those as uniform lanes and
    the runner poisons them after)."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[rng.random((S, N)) < missing] = 1.0 / 3.0
    P[rng.integers(S), rng.integers(N)] = [1.0, 1.0 - 1e-9, 0.0]
    P /= P.sum(-1, keepdims=True)
    return rng, P


def _jax_em_steps(P, I, J, monkeypatch):
    """Each (site, pair) lane's stopping step under the JAX package's EM
    (ngsdist_tpu/core/em.py em_converged_weights), read from its own
    iterates: the weights after k steps are those of its run capped at k
    (EM_MAX_ITER = k), and a lane stops at the first k whose
    log-likelihood moved by less than EM_TOLE (the loop's own test), at
    EM_MAX_ITER when none does."""
    Pj = jnp.asarray(P)
    W = (Pj[:, I, :, None] * Pj[:, J, None, :]).reshape(P.shape[0], len(I), 9)

    def lik(sfs):
        return np.asarray(jnp.log(jnp.sum(sfs * W, axis=-1)))

    prev = lik(jnp.full(W.shape, 1.0 / 9.0))
    steps = np.full(W.shape[:2], jem.EM_MAX_ITER)
    running = np.ones(W.shape[:2], bool)
    for k in range(1, jem.EM_MAX_ITER + 1):
        monkeypatch.setattr(jem, "EM_MAX_ITER", k)
        cur = lik(jem.em_converged_weights(W))
        stop = running & (np.abs(cur - prev) < jem.EM_TOLE)
        steps[stop] = k
        running &= ~stop
        if not running.any():
            break
        prev = cur
    return steps


def test_x64_em_tables_stop_where_jax_stops(monkeypatch):
    """The float64 EM kernel's arithmetic (em_raw_cnt_tables' lanes) on
    float64 inputs, not rounded to float32: every lane stops at the JAX
    package's step."""
    _, P = _probs(31, 11, 9)
    N = P.shape[1]
    I, J = np.triu_indices(N, k=1)
    hi = torch.tensor(np.exp(em.EM_TOLE), dtype=torch.float64)
    score = torch.from_numpy(default_score_matrix())
    _, m, ksum = em._em_sites_tables(torch.from_numpy(P), score, torch.from_numpy(I),
                                     torch.from_numpy(J), False, hi)
    assert bool((m > 0).all())
    want = _jax_em_steps(P, I, J, monkeypatch)
    got = ksum.numpy() + 1
    assert got.max() > 20 and (got == want).all(), np.argwhere(got != want)


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_x64_em_tables_raw_match_jax(pairwise_del, weighted):
    """raw within em_table_bound(S) x max|score| x cnt of the JAX
    package's float64 em_suffstats, cnt exact."""
    rng, P = _probs(32, 37, 10)
    S, N = P.shape[:2]
    score9 = default_score_matrix().reshape(-1)
    w = rng.integers(0, 4, S).astype(np.float64) if weighted else None
    iu = np.triu_indices(N, k=1)
    raw, cnt = em.em_raw_cnt_tables(torch.from_numpy(P), score9, pairwise_del, w)
    raw, cnt = raw.numpy()[iu], cnt.numpy()[iu]
    raw_j, cnt_j, _, _ = jdist.em_suffstats(jnp.asarray(P), jnp.asarray(score9), pairwise_del,
                                            site_weights=w)
    np.testing.assert_array_equal(cnt, np.asarray(cnt_j))
    bound = em.em_table_bound(S) * np.abs(score9).max() * cnt
    assert (np.abs(raw - np.asarray(raw_j)) <= bound).all()


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("block_size", [1, 5, 7])
def test_x64_em_tables_blocks_match_jax(pairwise_del, block_size):
    """The block mode: C exact, B within em_table_bound(block_size) x
    max|score| x C of the JAX package's float64 want_blocks output."""
    n_blocks = 35 // block_size
    _, P = _probs(33, n_blocks * block_size, 9)
    score9 = default_score_matrix().reshape(-1)
    B, C = em.em_block_partials_tables(torch.from_numpy(P), score9, pairwise_del, n_blocks,
                                       block_size)
    _, _, B_j, C_j = jdist.em_suffstats(jnp.asarray(P), jnp.asarray(score9), pairwise_del,
                                        n_blocks=n_blocks, block_size=block_size)
    np.testing.assert_array_equal(C.numpy(), np.asarray(C_j))
    bound = em.em_table_bound(block_size) * np.abs(score9).max() * C.numpy()
    assert (np.abs(B.numpy() - np.asarray(B_j)) <= bound).all()


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_x64_indep_kernel_order_matches_jax(pairwise_del, weighted):
    """The float64 indep kernel sums in its own order (per chunk of
    split_plan, per 8-site step, genotype by genotype, then the chunks in
    order: indep_raw_cnt_f64_order).  Against the JAX package's float64
    indep_suffstats: cnt exact; raw within f64_sum_bound(S, chunks) x raw,
    the bound both orders' rounding takes at most (ops/indep.py: each
    folds the score in 3 products and adds 3 S products and the chunks;
    all terms >= 0 with the default scores, so sum|terms| = raw)."""
    rng, P = _probs(34, 5000, 130, missing=0.1)
    S, N = P.shape[:2]
    chunks, chunk_sites = indep.split_plan(N, S)
    assert chunks > 1 and S % chunk_sites      # several chunks, the last ragged
    score = default_score_matrix()
    assert (score >= 0).all()
    w = rng.integers(0, 4, S).astype(np.float64) if weighted else None
    raw, cnt = indep.indep_raw_cnt_f64_order(torch.from_numpy(P), score, pairwise_del, w)
    raw_j, cnt_j = jdist.indep_suffstats(jnp.asarray(P), jnp.asarray(score), pairwise_del,
                                         site_weights=None if w is None else jnp.asarray(w))
    iu = np.triu_indices(N)
    raw, raw_j = raw.numpy()[iu], np.asarray(raw_j)[iu]
    if pairwise_del:
        np.testing.assert_array_equal(cnt.numpy()[iu], np.asarray(cnt_j)[iu])
    bound = indep.f64_sum_bound(S, chunks) * raw
    assert (np.abs(raw - raw_j) <= bound).all()
    assert indep.f64_sum_bound(S, chunks) < 1e-11


def test_x64_indep_kernel_order_is_the_plain_sum():
    """The emulated order and the plain version compute the same sums:
    cnt equal, raw within the bound."""
    _, P = _probs(35, 777, 33)
    Pt = torch.from_numpy(P)
    score = default_score_matrix()
    chunks, _ = indep.split_plan(33, 777)
    raw_o, cnt_o = indep.indep_raw_cnt_f64_order(Pt, score, True)
    raw_p, cnt_p = indep.indep_raw_cnt_ref(Pt, score, True)
    assert torch.equal(cnt_o, cnt_p)
    assert bool(((raw_o - raw_p).abs() <= indep.f64_sum_bound(777, chunks) * raw_p).all())


@pytest.mark.parametrize("N,S", [(33, 777), (65, 2051), (130, 5003)])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_x64_indep_kernel_order_ragged_steps(N, S, pairwise_del):
    """S off the kernel's 8-site step, in one chunk and in several (the
    last chunk ends inside a step): the emulated order against the JAX
    package's float64 indep_suffstats and the plain version, cnt exact,
    raw within f64_sum_bound(S, chunks) x raw."""
    assert S % indep.STEP_F64
    rng, P = _probs(36, S, N, missing=0.1)
    w = rng.integers(0, 4, S).astype(np.float64)
    chunks, _ = indep.split_plan(N, S)
    score = default_score_matrix()
    raw, cnt = indep.indep_raw_cnt_f64_order(torch.from_numpy(P), score, pairwise_del, w)
    raw_j, cnt_j = jdist.indep_suffstats(jnp.asarray(P), jnp.asarray(score), pairwise_del,
                                         site_weights=jnp.asarray(w))
    raw_p, cnt_p = indep.indep_raw_cnt_ref(torch.from_numpy(P), score, pairwise_del, w)
    iu = np.triu_indices(N)
    bound = indep.f64_sum_bound(S, chunks) * raw.numpy()[iu]
    for other in (np.asarray(raw_j), raw_p.numpy()):
        assert (np.abs(raw.numpy()[iu] - other[iu]) <= bound).all()
    np.testing.assert_array_equal(cnt.numpy()[iu], cnt_p.numpy()[iu])
    if pairwise_del:
        np.testing.assert_array_equal(cnt.numpy()[iu], np.asarray(cnt_j)[iu])


@pytest.mark.parametrize("block_size", [1, 5, 37, 256])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_x64_indep_block_order_matches_jax(block_size, pairwise_del):
    """The block mode's order (each bootstrap block a chunk of its own,
    its steps counted from the block's first site, so that block edges
    fall inside the kernel's 8-site steps): against the JAX package's
    float64 indep_block_partials, C exact, B within
    f64_sum_bound(block_size) x B."""
    n_blocks = 777 // block_size
    _, P = _probs(37, n_blocks * block_size, 33)
    score = default_score_matrix()
    B, C = indep.indep_raw_cnt_f64_order(torch.from_numpy(P), score, pairwise_del,
                                         block_size=block_size)
    assert B.shape == C.shape == (n_blocks, 33, 33)
    B_j, C_j = jdist.indep_block_partials(jnp.asarray(P), jnp.asarray(score), pairwise_del,
                                          n_blocks, block_size)
    assert (np.abs(B.numpy() - np.asarray(B_j))
            <= indep.f64_sum_bound(block_size) * B.numpy()).all()
    if pairwise_del:
        np.testing.assert_array_equal(C.numpy(), np.asarray(C_j))


# ------------------------------------------------------------------ #
# No fallback                                                         #
# ------------------------------------------------------------------ #


class _Lib:
    """A stand-in for the kernel library that records the entries called
    and the pointers they were given, and holds only `entries`."""

    def __init__(self, entries):
        self.entries, self.calls = set(entries), []

    def __getattr__(self, name):
        if name not in self.entries:
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@contextlib.contextmanager
def _library(monkeypatch, entries):
    """The wrappers' CUDA path on CPU tensors, against a _Lib: the device
    check, the device context and the stream are the only parts taken
    out."""
    lib = _Lib(entries)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "check_probs", lambda P: None)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    yield lib


ALL_ENTRIES = [f"ngsd_{k}_{t}" for k in ("indep_raw_cnt", "indep_block_partials",
                                         "em_raw_cnt", "em_block_partials")
               for t in ("f32", "f64")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_x64_float64_goes_to_the_float64_entries(dtype, monkeypatch):
    """Each wrapper hands P's own storage to the entry of P's dtype, with
    outputs, weights and the score in that dtype, and counts the launch
    under that entry only."""
    _, P = _probs(36, 40, 70)
    P = torch.from_numpy(P).to(dtype)
    w = np.arange(40, dtype=np.float64) % 3
    t = "f64" if dtype == torch.float64 else "f32"
    score_type = ctypes.c_double if t == "f64" else ctypes.c_float
    counts = {m: {n: getattr(m, n) for n in ("LAUNCHES", "LAUNCHES_F64", "BLOCK_LAUNCHES",
                                             "BLOCK_LAUNCHES_F64")} for m in (indep, em)}
    with _library(monkeypatch, ALL_ENTRIES) as lib:
        raw, cnt = indep._indep_cuda(P, default_score_matrix(), True, w, None)
        B, _ = indep._indep_blocks_cuda(P, default_score_matrix(), True, 8, 5)
        raw_e, cnt_e = em._em_cuda(P, default_score_matrix().reshape(-1), True, w, None, None)
        em._em_blocks_cuda(P, default_score_matrix().reshape(-1), True, 8, 5)
    assert [name for name, _ in lib.calls] == [
        f"ngsd_{k}_{t}" for k in ("indep_raw_cnt", "indep_block_partials", "em_raw_cnt",
                                  "em_block_partials")]
    for name, args in lib.calls:
        assert args[0].value == P.data_ptr()           # P itself: never a cast copy
        assert any(isinstance(a, score_type * 9) for a in args)
    assert raw.dtype == cnt.dtype == raw_e.dtype == cnt_e.dtype == dtype
    assert B.dtype == torch.float64                    # block partials: float64 in both
    suffix = "_F64" if t == "f64" else ""
    for m in (indep, em):
        for n, before in counts[m].items():
            assert getattr(m, n) - before == (1 if n in (f"LAUNCHES{suffix}",
                                                         f"BLOCK_LAUNCHES{suffix}") else 0)


@pytest.mark.parametrize("wrapper", ["indep", "indep_blocks", "em", "em_blocks"])
def test_x64_missing_float64_entry_raises(wrapper, monkeypatch):
    """A library without the float64 entries raises for a float64 tensor:
    no float32 entry is called in its place and nothing is cast down."""
    _, P = _probs(37, 20, 40)
    P = torch.from_numpy(P)
    score = default_score_matrix()
    call = {"indep": lambda: indep._indep_cuda(P, score, False, None, None),
            "indep_blocks": lambda: indep._indep_blocks_cuda(P, score, False, 4, 5),
            "em": lambda: em._em_cuda(P, score.reshape(-1), False, None, None, None),
            "em_blocks": lambda: em._em_blocks_cuda(P, score.reshape(-1), False, 4, 5)}[wrapper]
    with _library(monkeypatch, [e for e in ALL_ENTRIES if e.endswith("_f32")]) as lib:
        with pytest.raises(AttributeError, match="_f64"):
            call()
    assert lib.calls == []


def test_x64_other_dtypes_are_refused():
    """check_probs admits float32 and float64 only (a stand-in that
    reports a card)."""
    for dtype, ok in ((torch.float32, True), (torch.float64, True), (torch.float16, False),
                      (torch.bfloat16, False)):
        P = types.SimpleNamespace(device=CUDA, dtype=dtype, ndim=3, shape=(4, 3, 3),
                                  is_contiguous=lambda: True)
        if ok:
            _build.check_probs(P)
        else:
            with pytest.raises(ValueError, match="float32 or float64"):
                _build.check_probs(P)
