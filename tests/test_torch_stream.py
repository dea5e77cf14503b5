"""The port's long-genome path on the CPU (float64) against the JAX
engine (x64): site chunks streamed under a forced NGSDIST_DEVICE_BUDGET,
which both engines read, so one setting gives both the same chunk edges;
the chunk planner against the JAX function; round checkpoints and the
resume of a killed replicate.

Tolerances: both engines add the same chunks' float64 sums in the same
order, so port against JAX is held to 1e-9 relative (the two EMs differ
in their last bits per lane), and chunked against resident within the
port to 1e-12 relative (the same lanes, summed in another order)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.core import bootstrap as jboot  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu_torch.config import Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _rand_probs(rng, S, N):
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < 0.15] = 1.0 / 3.0
    return P


def _budget_for(chunk_sites, N):
    """The NGSDIST_DEVICE_BUDGET that gives float64 chunks of chunk_sites:
    a third of it is the tensor's budget, KEEP/DEN of that a chunk's."""
    return (tdist._WORKING_SET_FACTOR * tdist.PREFETCH_KEEP_DEN * chunk_sites * N * 3 * 8
            // tdist.PREFETCH_KEEP_NUM)


def _pars(cls, tmp_path, S, N, **kw):
    kw.setdefault("seed", 3)
    return cls(in_geno="x", n_ind=N, n_sites=S, in_probs=True,
               out=str(tmp_path / "o.dist"), verbose=0, **kw)


def _assert_close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol, atol=0)


def test_planner_constants_match_jax():
    assert (tdist.PREFETCH_KEEP_NUM, tdist.PREFETCH_KEEP_DEN) == (
        jdist.PREFETCH_KEEP_NUM, jdist.PREFETCH_KEEP_DEN)
    assert tdist.STREAM_MIN_CHUNKS == jdist.STREAM_MIN_CHUNKS
    assert tdist.STREAM_MIN_CHUNK_SITES == jdist.STREAM_MIN_CHUNK_SITES
    assert tdist._WORKING_SET_FACTOR == jdist._WORKING_SET_FACTOR
    assert tdist._DEFAULT_BUDGET // tdist._WORKING_SET_FACTOR == jdist._device_budget_bytes()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", [1, 20, 1024, 5000])
def test_stream_chunk_sites_matches_jax(itemsize, N):
    for S in (1, 97, 16384, 65536, 262144, 5_000_000):
        for budget in (1, 1000, 40000, 1 << 20, 1 << 28, 4 << 30, 12 << 30):
            assert (tdist._stream_chunk_sites(S, N, itemsize, budget)
                    == jdist._stream_chunk_sites(S, N, itemsize, budget)), (S, N, budget)


@pytest.mark.parametrize("budget", [None, 1, 40000, 1 << 24])
def test_stream_plan_on_the_cpu_is_the_jax_rule(monkeypatch, budget):
    """The decision and the chunk length of ngsdist_tpu's iter_replicates
    (distance.py:757-760), NGSDIST_DEVICE_BUDGET forced or not."""
    if budget is None:
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    else:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    for S, N in ((97, 5), (1200, 20), (600, 40), (100000, 64)):
        jbudget = jdist._device_budget_bytes()
        chunked = S * N * 3 * 8 > jbudget
        chunk = jdist._stream_chunk_sites(S, N, 8, jbudget) if chunked else S
        assert tdist.stream_plan(S, N, CPU, None, False) == (chunked, chunk)


def test_stream_plan_of_a_card_left_to_itself(monkeypatch):
    """Without NGSDIST_DEVICE_BUDGET a card streams what its free memory
    does not hold beside the working set (`left` < 0, check_fits), in
    chunks whose ring of 2 + 2/3 chunks fits that memory, none above
    _CUDA_MAX_CHUNK_BYTES; with the variable set it follows the JAX rule
    like the CPU.  The plan reads no card, so it is held here."""
    cuda = torch.device("cuda")
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    assert tdist.check_fits(1000, 64, CPU, True, False) is None
    assert tdist.stream_plan(1000, 64, cuda, 0, False) == (False, 1000)
    S, N = 5_000_000, 2048
    tensor = S * N * 12                      # 122.9 GB in float32
    for free in (70 << 30, 8 << 30, 1 << 30):
        chunked, chunk = tdist.stream_plan(S, N, cuda, free - tensor, False)
        assert chunked and chunk >= 1
        assert chunk * N * 12 <= tdist._CUDA_MAX_CHUNK_BYTES
        assert (2 * 3 + 2) * chunk * N * 12 // 3 <= free
    assert tdist.stream_plan(S, N, cuda, (70 << 30) - tensor, False)[1] == (1 << 30) // (N * 12)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(12 << 20))
    want = jdist._stream_chunk_sites(S, N, 4, jdist._device_budget_bytes())
    assert tdist.stream_plan(S, N, cuda, None, False) == (True, want)
    # the kernels' working set: outputs, pair vectors, sums, weights, chunk partials
    assert tdist.working_set_bytes(4096, 1024, cuda, False, False) < tdist.working_set_bytes(
        4096, 1024, cuda, True, False)


def test_exact_count_parts():
    """Consecutive parts that cover the sites, each weighted count within
    the limit (a single site above it stands alone)."""
    rng = np.random.default_rng(0)
    assert tdist._exact_count_parts(10, None, 4) == [(0, 4), (4, 8), (8, 10)]
    assert tdist._exact_count_parts(10, None) == [(0, 10)]
    w = rng.integers(0, 5, 200).astype(np.float64)
    assert tdist._exact_count_parts(200, w) == [(0, 200)]
    parts = tdist._exact_count_parts(200, w, 17)
    assert parts[0][0] == 0 and parts[-1][1] == 200
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert all(w[a:b].sum() <= 17 for a, b in parts)
    # as few as a walk from the left gives: no part could take the next site
    assert all(w[a:b + 1].sum() > 17 for a, b in parts[:-1])
    w[50] = 40.0
    assert (50, 51) in tdist._exact_count_parts(200, w, 17)


@pytest.mark.parametrize("indep", [True, False], ids=["indep", "em"])
@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
def test_streamed_matches_jax_and_resident(tmp_path, monkeypatch, indep, pairwise_del):
    """97 sites in 16-site chunks (the last of 1 site), 2 bootstrap
    replicates of 8-site blocks: against the JAX engine under the same
    budget, and against the port's own resident run."""
    rng = np.random.default_rng(40 + indep + 2 * pairwise_del)
    S, N, bs = 97, 5, 8
    P = _rand_probs(rng, S, N)
    kw = dict(indep_geno=indep, pairwise_del=pairwise_del, n_boot_rep=2, boot_block_size=bs)
    n_trunc, maps = jboot.site_maps(3, 2, S, bs)
    assert n_trunc == 96

    resident = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps,
                                          n_trunc, CPU))
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(16, N)))
    assert tdist.stream_plan(S, N, CPU, None, False) == (True, 16)
    calls = []
    for name in ("indep_raw_cnt", "em_raw_cnt"):
        def spy(Psub, *a, _fn=getattr(tdist, name), **k):
            calls.append(Psub.shape[0])
            return _fn(Psub, *a, **k)
        monkeypatch.setattr(tdist, name, spy)
    streamed = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps,
                                          n_trunc, CPU))
    # the full data in 7 chunks, each replicate in 6: never the partials route
    assert calls == [16] * 6 + [1] + [16] * 12
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, **kw), P, maps, n_trunc))
    assert len(streamed) == 3
    _assert_close(streamed, want, 1e-9)
    _assert_close(streamed, resident, 1e-12)


@pytest.mark.parametrize("reps", [0, 2], ids=["full", "boot"])
def test_streamed_zero_row_poison_matches_jax(tmp_path, monkeypatch, reps):
    """A text input's all-zero triple: without pairwise deletion the EM
    poisons every pair of that individual, in the chunk that holds the
    site and so in the sum; a replicate only where it draws the site."""
    rng = np.random.default_rng(9)
    S, N, bs = 61, 5, 6
    P = _rand_probs(rng, S, N)
    P[17, 2] = 0.0
    kw = dict(n_boot_rep=reps, boot_block_size=bs)
    n_trunc, maps = jboot.site_maps(3, reps, S, bs)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(10, N)))
    assert tdist.stream_plan(S, N, CPU, None, False) == (True, 10)
    got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps, n_trunc,
                                     CPU))
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, **kw), P, maps, n_trunc))
    assert np.isnan(want[0][2, 0]) and not np.isnan(want[0][0, 1])
    _assert_close(got, want, 1e-9)


def _spy_kernel(monkeypatch, kill_at=None):
    """Count indep_raw_cnt calls; raise in call number kill_at."""
    calls = []
    orig = tdist.indep_raw_cnt

    def spy(*a, **k):
        calls.append(1)
        if len(calls) == kill_at:
            raise KeyboardInterrupt("simulated kill mid-replicate")
        return orig(*a, **k)

    monkeypatch.setattr(tdist, "indep_raw_cnt", spy)
    return calls


def test_round_resume_after_a_kill(tmp_path, monkeypatch):
    """Kill in the third of six chunks, resume: the two finished chunks
    are not recomputed and the matrix is byte-identical."""
    rng = np.random.default_rng(40)
    S, N = 96, 5
    P = _rand_probs(rng, S, N)
    pars = _pars(Params, tmp_path, S, N, indep_geno=True, pairwise_del=True)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(16, N)))
    eng = tdist.engine_name(CPU, False)

    expected = list(tdist.iter_replicates(pars, P, [], S, CPU))
    assert not os.path.exists(ckpt.rounds_path(pars.out))  # no file unless asked

    calls = _spy_kernel(monkeypatch, kill_at=3)
    with pytest.raises(KeyboardInterrupt):
        list(tdist.iter_replicates(pars, P, [], S, CPU, round_ckpt=True))
    assert len(calls) == 3
    got = ckpt.load_rounds(pars.out, pars, 0, engine=eng, chunk=16)
    assert got is not None and got[0] == 2 and set(got[1]) == {"raw", "cnt"}

    calls = _spy_kernel(monkeypatch)
    resumed = list(tdist.iter_replicates(pars, P, [], S, CPU, round_ckpt=True))
    assert len(calls) == 6 - 2, "finished chunks were recomputed"
    assert resumed[0].tobytes() == expected[0].tobytes()


def test_round_resume_of_a_bootstrap_replicate(tmp_path, monkeypatch):
    """The rounds file is keyed by replicate: a kill in replicate 1
    resumes there (start_rep=1), byte-identical, EM without a cnt."""
    rng = np.random.default_rng(42)
    S, N, bs = 60, 4, 3
    P = _rand_probs(rng, S, N)
    pars = _pars(Params, tmp_path, S, N, n_boot_rep=1, boot_block_size=bs)
    n_trunc, maps = jboot.site_maps(pars.seed, 1, S, bs)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(12, N)))
    expected = list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU))

    calls = []
    orig = tdist.em_raw_cnt

    def spy(*a, **k):
        calls.append(1)
        if spy.armed and len(calls) == 3:
            raise KeyboardInterrupt
        return orig(*a, **k)

    spy.armed = True
    monkeypatch.setattr(tdist, "em_raw_cnt", spy)
    with pytest.raises(KeyboardInterrupt):
        list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU, round_ckpt=True,
                                   start_rep=1))
    eng = tdist.engine_name(CPU, False)
    assert ckpt.load_rounds(pars.out, pars, 0, engine=eng, chunk=12) is None
    got = ckpt.load_rounds(pars.out, pars, 1, engine=eng, chunk=12)
    assert got is not None and got[0] == 2 and set(got[1]) == {"raw", "cnt"}
    spy.armed = False
    calls.clear()
    resumed = list(tdist.iter_replicates(pars, P, maps, n_trunc, CPU, round_ckpt=True,
                                         start_rep=1))
    assert len(calls) == 5 - 2
    assert resumed[0].tobytes() == expected[1].tobytes()


@pytest.mark.parametrize("what", ["seed", "engine", "chunk", "rep"])
def test_round_ckpt_ignored_on_mismatch(tmp_path, monkeypatch, what):
    """A rounds file of other parameters, of another numeric environment
    (a card's float32 sums), of another chunk length or of another
    replicate is not resumed."""
    rng = np.random.default_rng(41)
    S, N = 64, 4
    P = _rand_probs(rng, S, N)
    pars = _pars(Params, tmp_path, S, N, indep_geno=True)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget_for(16, N)))
    clean = list(tdist.iter_replicates(pars, P, [], S, CPU))

    eng = tdist.engine_name(CPU, False)
    stale = {"raw": np.full(N * (N - 1) // 2, 1e9)}
    if what == "seed":
        ckpt.save_rounds(pars.out, _pars(Params, tmp_path, S, N, indep_geno=True, seed=99),
                         0, 2, stale, engine=eng, chunk=16)
    elif what == "engine":
        ckpt.save_rounds(pars.out, pars, 0, 2, stale,
                         engine=tdist.engine_name(torch.device("cuda"), False), chunk=16)
    elif what == "chunk":
        ckpt.save_rounds(pars.out, pars, 0, 2, stale, engine=eng, chunk=8)
    else:
        ckpt.save_rounds(pars.out, pars, 1, 2, stale, engine=eng, chunk=16)
    calls = _spy_kernel(monkeypatch)
    out = list(tdist.iter_replicates(pars, P, [], S, CPU, round_ckpt=True))
    assert len(calls) == 4
    assert out[0].tobytes() == clean[0].tobytes()


def test_round_ckpt_single_file_atomic(tmp_path):
    """The rounds checkpoint commits in one os.replace (metadata inside
    the npz): a torn file reads as no checkpoint, and `clear` removes it."""
    pars = _pars(Params, tmp_path, 64, 4, indep_geno=True)
    eng = tdist.engine_name(CPU, False)
    ckpt.save_rounds(pars.out, pars, 0, 3, {"raw": np.ones(6)}, engine=eng, chunk=16)
    path = ckpt.rounds_path(pars.out)
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no second file to tear
    got = ckpt.load_rounds(pars.out, pars, 0, engine=eng, chunk=16)
    assert got is not None and got[0] == 3
    np.testing.assert_array_equal(got[1]["raw"], np.ones(6))

    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 2])
    assert ckpt.load_rounds(pars.out, pars, 0, engine=eng, chunk=16) is None
    ckpt.clear(pars.out)
    assert not os.path.exists(path)


def test_rounds_file_layout_matches_jax(tmp_path):
    """The port's copy writes the JAX module's layout (path, metadata key
    inside the npz) with the chunk length added to the metadata."""
    from ngsdist_tpu.utils import checkpoint as jckpt

    pars = _pars(Params, tmp_path, 64, 4, indep_geno=True)
    jpars = _pars(JParams, tmp_path, 64, 4, indep_geno=True)
    assert ckpt.rounds_path(pars.out) == jckpt.rounds_path(jpars.out)
    assert ckpt._META_KEY == jckpt._META_KEY
    ckpt.save_rounds(pars.out, pars, 1, 2, {"raw": np.arange(3.0)}, engine="e", chunk=None)
    # a file without a chunk length is one the JAX module reads too
    got = jckpt.load_rounds(jpars.out, jpars, 1, engine="e")
    assert got is not None and got[0] == 2
    np.testing.assert_array_equal(got[1]["raw"], np.arange(3.0))


def test_runner_streams_and_clears_rounds(tmp_path, monkeypatch):
    """Through runner.run: a streamed run writes the rounds file after
    every chunk while it runs (it owns the output) and removes it at the
    end; a resident run writes none; the two agree within 1e-12."""
    from ngsdist_tpu_torch import runner

    rng = np.random.default_rng(5)
    S, N = 200, 6
    P = _rand_probs(rng, S, N)
    path = tmp_path / "gp.bin"
    P.tofile(path)
    seen = []
    orig = ckpt.save_rounds

    def spy(out, pars, rep, next_round, arrays, **k):
        seen.append((rep, next_round, k["chunk"]))
        return orig(out, pars, rep, next_round, arrays, **k)

    monkeypatch.setattr(ckpt, "save_rounds", spy)

    def run(tag, budget):
        if budget is None:
            monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
        else:
            monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
        out = str(tmp_path / f"{tag}.dist")
        pars = Params(in_geno=str(path), in_bin=True, in_probs=True, n_ind=N, n_sites=S,
                      indep_geno=True, pairwise_del=True, n_boot_rep=1, boot_block_size=20,
                      seed=1, verbose=0, out=out)
        mats = runner.run(pars, CPU)
        assert not os.path.exists(ckpt.rounds_path(out))
        return mats

    resident = run("resident", None)
    assert seen == []
    streamed = run("streamed", _budget_for(64, N))
    assert seen == [(0, 1, 64), (0, 2, 64), (0, 3, 64), (0, 4, 64),
                    (1, 1, 64), (1, 2, 64), (1, 3, 64), (1, 4, 64)]
    _assert_close(streamed, resident, 1e-12)
