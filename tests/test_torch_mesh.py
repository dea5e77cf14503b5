"""The port's mesh engine on the CPU (float64) against the JAX package's on
its virtual 8-device CPU mesh (tests/conftest.py): the mesh and its tile
tables, the plain forms of the kernels' tile lists, sharded_suffstats,
the block partials and their resummation, the engine resident and
streamed in site rounds, the EM's zero-row poison, and the resume of a
streamed mesh run.

A port mesh of eight `cpu` entries stands for the JAX mesh of eight
virtual devices.  Tolerances: both engines take float64 sums over the
same shards, in another order within a shard, so raw is held to 1e-9
relative, the bound the streamed tests already use; counts are exact."""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ngsdist_tpu.config import Params as JParams  # noqa: E402
from ngsdist_tpu.config import default_score_matrix  # noqa: E402
from ngsdist_tpu.core import bootstrap as jboot  # noqa: E402
from ngsdist_tpu.core import distance as jdist  # noqa: E402
from ngsdist_tpu.parallel import mesh as jpm  # noqa: E402
from ngsdist_tpu.parallel.multihost import SiteStream as JStream  # noqa: E402
from ngsdist_tpu_torch.config import NgsDistError, Params  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.ops import _build  # noqa: E402
from ngsdist_tpu_torch.ops import em as tem  # noqa: E402
from ngsdist_tpu_torch.ops import indep as tind  # noqa: E402
from ngsdist_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngsdist_tpu_torch.parallel import multihost as pmh  # noqa: E402
from ngsdist_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
SCORE = default_score_matrix()
MESHES = [(8, 1), (4, 2), (2, 4)]


def _cpu_mesh(n, pairs=1):
    return pm.make_mesh([CPU] * n, pairs=pairs)


def _jax_mesh(n, pairs=1):
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"
    return jpm.make_mesh(n_devices=n, pairs=pairs)


def _rand_probs(rng, S, N, missing=0.15):
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < missing] = 1.0 / 3.0
    return P


def _pars(cls, tmp_path, S, N, **kw):
    kw.setdefault("seed", 3)
    return cls(in_geno="x", n_ind=N, n_sites=S, in_probs=True,
               out=str(tmp_path / "o.dist"), verbose=0, **kw)


def _close(got, want, rtol=1e-9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=1e-300)


def _budget(sites, N, itemsize=8):
    """NGSDIST_DEVICE_BUDGET under which a shard's tensor budget holds
    `sites` sites of N individuals (a third of it is that budget)."""
    return 3 * sites * N * 3 * itemsize


# ------------------------------------------------------------------ #
# The mesh and its tables                                             #
# ------------------------------------------------------------------ #


def test_make_mesh_shapes_and_errors():
    mesh = _cpu_mesh(8, pairs=2)
    assert mesh.shape == {"sites": 4, "pairs": 2}
    assert pm.sites_size(mesh) == 4 and pm.pairs_size(mesh) == 2
    assert mesh.first == CPU and len(mesh.devices) == 8
    if not torch.cuda.is_available():
        # no card: an error, never a quiet CPU mesh (a CPU mesh names its entries)
        with pytest.raises(NgsDistError, match="no CUDA device is available"):
            pm.make_mesh()
    with pytest.raises(ValueError) as want:
        jpm.make_mesh(n_devices=6, pairs=4)
    with pytest.raises(ValueError) as got:
        _cpu_mesh(6, pairs=4)
    assert str(got.value) == str(want.value)         # the JAX package's error
    with pytest.raises(ValueError, match="3 devices asked for, 2 available"):
        pm.make_mesh([CPU, CPU], n_devices=3)
    assert pmh.host_site_range(96, mesh) == (0, 96)  # one process: everything


@pytest.mark.parametrize("N", [1, 64, 65, 130, 700, 1024])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_panel_tables_partition_and_balance(N, p):
    """Every upper 64 x 64 tile in exactly one list; the shares differ by
    one tile at most, the larger first; no padding entry."""
    lists = pm.panel_tables(N, p)
    assert len(lists) == p
    T = tind.upper_tiles(N)
    flat = np.concatenate(lists)
    assert sorted(flat.tolist()) == list(range(T))
    sizes = [len(x) for x in lists]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    assert all(x.dtype == np.int32 for x in lists)


@pytest.mark.parametrize("N", [2, 5, 33, 65, 130, 200])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_pair_block_tables_cover_each_shards_pairs(N, p):
    """List d holds the 32 x 32 tile of every pair of slice d of the pair
    list padded with its last pair, and upper tiles only; the lists
    together hold every upper tile that holds a pair."""
    I, J = pm.padded_pairs(N, p)
    n_pairs = N * (N - 1) // 2
    assert I.size % p == 0 and I.size - n_pairs < p
    assert (I[n_pairs:] == I[n_pairs - 1]).all() and (J[n_pairs:] == J[n_pairs - 1]).all()
    lists = pm.pair_block_tables(N, p)
    per = I.size // p
    nt = -(-N // tem.EM_TILE)
    for d, tiles in enumerate(lists):
        have = {_build.upper_tile(int(k)) for k in tiles}
        assert all(ti <= tj < nt for ti, tj in have)
        need = {(int(a) // 32, int(b) // 32) for a, b in zip(I[d * per:(d + 1) * per],
                                                           J[d * per:(d + 1) * per])}
        assert need == have
    union = {_build.upper_tile(int(k)) for k in np.concatenate(lists)}
    assert union == {(a // 32, b // 32) for a, b in zip(*np.triu_indices(N, 1))}


def _unequal(what, got, want, full_again):
    """The failure message of an inexact tile sum: which entries differ and
    by how much, the thread counts and the load, and whether the full call
    itself gives the same bits again (full_again: a third call)."""
    diff = got != want
    idx = diff.nonzero()[:5].tolist()
    stable = [torch.equal(a, b) for a, b in zip(full_again(), full_again())]
    return (f"{what}: {int(diff.sum())} of {diff.numel()} entries differ, largest "
            f"|difference| {float((got - want).abs().max()):.3e}, first at {idx}; torch "
            f"threads {torch.get_num_threads()}, interop {torch.get_num_interop_threads()}, "
            f"load {os.getloadavg()}; the full call rerun twice equal: {stable}")


@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
def test_tile_plain_forms_sum_to_the_full_call(pairwise_del):
    """indep_raw_cnt_ref(tiles=) and em_raw_cnt_ref(tiles=) over the p
    lists of a split add up to the full call's valid triangle exactly,
    the EM with and without a site list; unlisted tiles are zero.  A
    failure says which tile list, which entries and whether the full call
    repeats its own bits (the failure seen once per ~10 full runs under
    xdist, ROADMAP Queue 3)."""
    rng = np.random.default_rng(5)
    S, N = 37, 140
    P = torch.from_numpy(_rand_probs(rng, S, N))
    P[3, 7] = 0.0
    w = torch.from_numpy(rng.integers(0, 3, S).astype(np.float64))
    index = torch.from_numpy(np.flatnonzero(w.numpy() > 0))

    def full_indep():
        return [m.triu() for m in tind.indep_raw_cnt_ref(P, SCORE, pairwise_del, w)]

    def full_em():
        return tem.em_raw_cnt_ref(P, SCORE.reshape(-1), pairwise_del, w[index],
                                  site_index=index)

    full_i, full_e = full_indep(), full_em()
    for p in (2, 3, 4):
        tot_i = [torch.zeros_like(full_i[0]) for _ in range(2)]
        for tiles in pm.panel_tables(N, p):
            got = tind.indep_raw_cnt_ref(P, SCORE, pairwise_del, w, tiles=torch.from_numpy(tiles))
            mask = _build.tile_mask(N, tiles, tind.TILE, strict=False)
            for a, g in zip(tot_i, got):
                assert (g[~mask] == 0).all()
                a += g
        for name, a, f in zip(("raw", "cnt"), tot_i, full_i):
            assert torch.equal(a, f), _unequal(f"indep {name}, {p} lists", a, f, full_indep)
        seen = torch.zeros((N, N), dtype=torch.bool)
        for tiles in pm.pair_block_tables(N, p):
            got = tem.em_raw_cnt_ref(P, SCORE.reshape(-1), pairwise_del, w[index],
                                     site_index=index, tiles=torch.from_numpy(tiles))
            mask = _build.tile_mask(N, tiles, tem.EM_TILE, strict=True)
            for name, g, f in zip(("raw", "cnt"), got, full_e):
                assert (g[~mask] == 0).all()
                assert torch.equal(g[mask], f[mask]), _unequal(
                    f"em {name}, {p} lists, tiles {tiles.tolist()}", g[mask], f[mask], full_em)
            seen |= mask
        assert torch.equal(seen, torch.ones((N, N), dtype=torch.bool).triu(1))


# ------------------------------------------------------------------ #
# sharded_suffstats, block partials, bootstrap_replicates             #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
@pytest.mark.parametrize("indep", [True, False], ids=["indep", "em"])
def test_sharded_suffstats_matches_jax(indep, pairwise_del, weighted, shape):
    """raw [n_pairs] within 1e-9 relative of the JAX function's (indep:
    its [N, N] at the pairs), cnt exact, on a sites x pairs split of 8
    devices; N = 70 gives the EM three tile rows and indep two, so the
    pairs-shards' lists differ."""
    n_sites_axis, p = shape
    rng = np.random.default_rng(10 + indep + 2 * pairwise_del + 4 * weighted)
    S, N = 150, 70
    P = _rand_probs(rng, S, N)
    w = rng.integers(0, 3, S).astype(np.float64) if weighted else None
    want = jpm.sharded_suffstats(P, SCORE, _jax_mesh(8, p), indep=indep,
                                 pairwise_del=pairwise_del, site_weights=w)
    got = pm.sharded_suffstats(P, SCORE, _cpu_mesh(8, p), indep=indep,
                               pairwise_del=pairwise_del, site_weights=w)
    I, J = np.triu_indices(N, 1)
    at = (lambda a: np.asarray(a)[I, J]) if indep else np.asarray
    _close(got[0].numpy(), at(want[0]))
    if pairwise_del or not indep:
        np.testing.assert_array_equal(got[1].numpy(), at(want[1]))
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
@pytest.mark.parametrize("indep", [True, False], ids=["indep", "em"])
def test_block_partials_and_bootstrap_replicates_match_jax(indep, pairwise_del):
    """Block partials per shard on 8 x 1 (the last shard's last block
    ragged: S is no multiple of the block), resummed per replicate:
    the JAX function's replicates within 1e-9, their counts exact."""
    rng = np.random.default_rng(20 + indep + 2 * pairwise_del)
    S, N, bs, R = 205, 9, 8, 4
    P = _rand_probs(rng, S, N)
    n_blocks = S // bs
    table = jboot.block_index_table(7, R, n_blocks)
    _, _, jB, jC = jpm.sharded_suffstats(P, SCORE, _jax_mesh(8), indep=indep,
                                         pairwise_del=pairwise_del, n_blocks=n_blocks,
                                         block_size=bs)
    want_raw, want_cnt = jpm.bootstrap_replicates(table, jB, jC, n_blocks, _jax_mesh(8))
    mesh = _cpu_mesh(8)
    _, _, B, _ = pm.sharded_suffstats(P, SCORE, mesh, indep=indep, pairwise_del=pairwise_del,
                                      n_blocks=n_blocks, block_size=bs)
    assert B.n_rows == -(-S // bs)
    raw, cnt = pm.bootstrap_replicates(table, B, n_blocks, mesh)
    I, J = np.triu_indices(N, 1)
    want_raw = np.asarray(want_raw)
    _close(raw.numpy(), want_raw[:, I, J] if indep else want_raw)
    if pairwise_del:
        want_cnt = np.asarray(want_cnt)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt[:, I, J] if indep else want_cnt)
    else:
        assert cnt is None


@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_pair_pi_matches_jax(shape, pairwise_del):
    """The per-pair base frequencies of models 4-6, pairs-shards taking
    row slices of the counts."""
    _, p = shape
    rng = np.random.default_rng(30)
    S, N = 90, 11
    P = _rand_probs(rng, S, N)
    a1 = rng.integers(0, 4, S).astype(np.int8)
    a2 = rng.integers(-1, 4, S).astype(np.int8)
    w = rng.integers(0, 3, S).astype(np.float64)
    want = jpm.sharded_pair_pi(P, a1, a2, w, _jax_mesh(8, p), pairwise_del=pairwise_del)
    got = pm.sharded_pair_pi(P, a1, a2, w, _cpu_mesh(8, p), pairwise_del=pairwise_del)
    _close(got, np.asarray(want))


# ------------------------------------------------------------------ #
# The engine: resident and streamed, against the JAX engine            #
# ------------------------------------------------------------------ #


def _both(tmp_path, P, shape, reps=2, bs=8, **kw):
    """(port, JAX) matrices of iter_replicates over the same mesh, shape
    (devices, pairs)."""
    S, N = P.shape[:2]
    n_trunc, maps = jboot.site_maps(3, reps, S, bs)
    kw = dict(kw, n_boot_rep=reps, boot_block_size=bs)
    got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps, n_trunc,
                                     CPU, mesh=_cpu_mesh(*shape)))
    want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, **kw), P, maps, n_trunc,
                                      mesh=_jax_mesh(*shape)))
    assert len(got) == len(want) == reps + 1
    return got, want


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("pairwise_del", [False, True], ids=["nopdel", "pdel"])
@pytest.mark.parametrize("indep", [True, False], ids=["indep", "em"])
def test_streamed_mesh_matches_jax(tmp_path, monkeypatch, indep, pairwise_del, shape):
    """Site rounds under a forced NGSDIST_DEVICE_BUDGET, which both
    engines plan from: the same shards and rounds, the matrices within
    1e-9.  indep on 4 x 1 takes the single pass of block partials, the
    others the weighted rounds."""
    rng = np.random.default_rng(50 + indep + 2 * pairwise_del)
    S, N = 203, 6
    P = _rand_probs(rng, S, N)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget(24, N)))
    kw = dict(indep_geno=indep, pairwise_del=pairwise_del, n_boot_rep=2, boot_block_size=8)
    pars = _pars(Params, tmp_path, S, N, **kw)
    st = pmh.SiteStream.from_array(P, pars, _cpu_mesh(*shape))
    jst = JStream.from_array(P, _pars(JParams, tmp_path, S, N, **kw), _jax_mesh(*shape),
                             np.float64)
    assert (st.s_loc, st.chunk, st.n_rounds) == (jst.s_loc, jst.chunk, jst.n_rounds)
    assert not st.resident and st.n_rounds >= 3
    blocks = []
    monkeypatch.setattr(pm.ShardStats, "blocks",
                        lambda self, *a, _f=pm.ShardStats.blocks, **k:
                        blocks.append(1) or _f(self, *a, **k))
    got, want = _both(tmp_path, P, shape, indep_geno=indep, pairwise_del=pairwise_del)
    assert len(blocks) == (st.n_rounds if indep and shape[1] == 1 else 0)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bs", [1, 2])
def test_streamed_single_pass_trial_507_shape(tmp_path, monkeypatch, bs):
    """The shape of the JAX engine's round-5 trial 507: 54 sites on 4
    shards of 14, rounds of 3 sites that do not divide them, so each
    shard's last round leaves padding rows inside its range.  The single
    pass resums through _stream_block_rows (the JAX function, copied):
    within 1e-9 of JAX and of the port's resident mesh run."""
    rng = np.random.default_rng(77)
    S, N = 54, 6
    P = rng.dirichlet(np.ones(3), size=(S, N))
    kw = dict(indep_geno=True, pairwise_del=False, n_boot_rep=3, boot_block_size=bs)
    resident, _ = _both(tmp_path, P, (4, 1), reps=3, bs=bs, indep_geno=True)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget(4, N)))
    st = pmh.SiteStream.from_array(P, _pars(Params, tmp_path, S, N, **kw), _cpu_mesh(4))
    assert (st.s_loc, st.chunk) == ((14, 3) if bs == 1 else (14, 2))
    got, want = _both(tmp_path, P, (4, 1), reps=3, bs=bs, indep_geno=True)
    for g, w, r in zip(got, want, resident):
        _close(g, w)
        _close(g, r, 1e-12)
    for _ in range(50):  # the copy is the JAX function, row for row
        bs_, n_dev = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        chunk, s_loc = bs_ * int(rng.integers(1, 5)), bs_ * int(rng.integers(1, 9))
        n_rounds = -(-s_loc // chunk)
        args = (n_dev * n_rounds * (chunk // bs_), n_rounds, chunk, s_loc, n_dev, bs_,
                int(rng.integers(0, n_dev * s_loc // bs_ + 2)))
        np.testing.assert_array_equal(tdist._stream_block_rows(*args),
                                      jdist._stream_block_rows(*args))


@pytest.mark.parametrize("shape", [(8, 1), (8, 4)], ids=["8x1", "2x4"])
@pytest.mark.parametrize("model,indep", [(3, False), (4, True), (5, True), (6, False)])
def test_extended_mesh_matches_jax(tmp_path, monkeypatch, model, indep, shape):
    """Models 3-6 over a mesh, resident and streamed in rounds: the class
    sums per shard and the base counts with row slices on a pairs axis."""
    rng = np.random.default_rng(60 + model)
    S, N = 120, 7
    P = _rand_probs(rng, S, N)
    a1 = rng.integers(0, 4, S).astype(np.int8)
    a2 = ((a1 + rng.integers(0, 4, S)) % 4).astype(np.int8)
    a2[::17] = -1
    kw = dict(evol_model=model, indep_geno=indep, pairwise_del=model % 2 == 0,
              n_boot_rep=2, boot_block_size=6)
    n_trunc, maps = jboot.site_maps(3, 2, S, 6)
    for budget in (None, _budget(6, N)):
        if budget is not None:
            monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
        got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps, n_trunc,
                                         CPU, alleles=(a1, a2), mesh=_cpu_mesh(*shape)))
        want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, **kw), P, maps,
                                          n_trunc, alleles=(a1, a2), mesh=_jax_mesh(*shape)))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("model,indep", [(5, True), (6, False)])
def test_extended_mesh_compacted_scans_once_per_upload(tmp_path, monkeypatch, model, indep,
                                                       streamed):
    """Models 3-6 over a 4 x 2 mesh in a card's form (class_compaction
    patched to True): within 1e-12 of the three weighted launches per
    shard, and each sites shard's non-finite sites are found once per
    upload (resident once, streamed once per round), not per replicate."""
    rng = np.random.default_rng(70 + model)
    S, N = 120, 7
    P = _rand_probs(rng, S, N)
    P[40, 2, 0] = np.nan
    a1 = rng.integers(0, 4, S).astype(np.int8)
    a2 = ((a1 + rng.integers(0, 4, S)) % 4).astype(np.int8)
    kw = dict(evol_model=model, indep_geno=indep, pairwise_del=model % 2 == 0,
              n_boot_rep=2, boot_block_size=6)
    n_trunc, maps = jboot.site_maps(3, 2, S, 6)
    if streamed:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget(6, N)))
    else:
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    mesh = _cpu_mesh(4, 2)

    def run():
        return list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps,
                                          n_trunc, CPU, alleles=(a1, a2), mesh=mesh))

    plain = run()
    monkeypatch.setattr(tdist, "class_compaction", lambda device: True)
    scans = []

    def spy(t, _fn=tdist.nonfinite_sites):
        scans.append(t.shape[0])
        return _fn(t)

    monkeypatch.setattr(tdist, "nonfinite_sites", spy)
    compacted = run()
    stream = pmh.SiteStream.from_array(P, _pars(Params, tmp_path, S, N, **kw), mesh)
    assert stream.resident != streamed
    uploads = [hi - lo for r in range(stream.n_rounds)
               for lo, hi in stream.round_ranges(r) if hi > lo]
    assert scans == uploads
    assert np.isnan(plain[0]).any()
    for g, w in zip(compacted, plain):
        _close(g, w, rtol=1e-12)


@pytest.mark.parametrize("case", ["partials", "weighted", "pairs", "streamed", "extended"])
def test_em_zero_row_poison_on_a_mesh_matches_jax(tmp_path, monkeypatch, case):
    """An all-zero triple (an empty text line) without pairwise deletion:
    every shard poisons the pairs of its individual at its sites of
    weight > 0, and the NaN rides the fixed-order sum; on the partial-sum
    route a replicate only where it draws the block.  Models 3-6 on a
    mesh poison too (the JAX mesh engine's EM does, where its one-device
    engine adds the mean score)."""
    rng = np.random.default_rng(90)
    S, N = 97, 5
    P = _rand_probs(rng, S, N)
    P[40, 2] = 0.0
    kw = {}
    shape = (4, 2) if case == "pairs" else (4, 1)
    if case == "weighted":
        monkeypatch.setattr(tdist, "PARTIALS_BUDGET_BYTES", 0)
        monkeypatch.setattr(jdist, "PARTIALS_BUDGET_BYTES", 0)
    if case == "streamed":
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget(8, N)))
    if case == "extended":
        a1 = rng.integers(0, 4, S).astype(np.int8)
        a2 = ((a1 + 1 + rng.integers(0, 3, S)) % 4).astype(np.int8)
        n_trunc, maps = jboot.site_maps(3, 2, S, 8)
        kw = dict(evol_model=6, n_boot_rep=2, boot_block_size=8)
        got = list(tdist.iter_replicates(_pars(Params, tmp_path, S, N, **kw), P, maps, n_trunc,
                                         CPU, alleles=(a1, a2), mesh=_cpu_mesh(4)))
        want = list(jdist.iter_replicates(_pars(JParams, tmp_path, S, N, **kw), P, maps,
                                          n_trunc, alleles=(a1, a2), mesh=_jax_mesh(4)))
    else:
        got, want = _both(tmp_path, P, shape)
    assert np.isnan(want[0][2, 0]) and not np.isnan(want[0][0, 1])
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------------ #
# Resume                                                              #
# ------------------------------------------------------------------ #


def test_streamed_mesh_resumes_to_identical_bytes(tmp_path, monkeypatch):
    """A streamed run on a 2 x 2 mesh killed in its third round resumes from its
    rounds file at that round, to the bytes of an uninterrupted run; the
    file records the round layout [s_loc, chunk, sites shards], and a
    run of another layout recomputes rather than resume it."""
    rng = np.random.default_rng(70)
    S, N = 150, 5
    P = _rand_probs(rng, S, N)
    pars = _pars(Params, tmp_path, S, N, pairwise_del=True)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(_budget(8, N)))
    mesh = _cpu_mesh(4, pairs=2)
    st = pmh.SiteStream.from_array(P, pars, mesh)
    assert st.n_rounds >= 4
    expected = list(tdist.iter_replicates(pars, P, [], S, CPU, mesh=mesh))

    # launches per round: one per entry whose shard has sites in it
    per_round = [2 * sum(hi > lo for lo, hi in st.round_ranges(r)) for r in range(st.n_rounds)]
    calls = []
    orig = tdist.em_raw_cnt

    def spy(*a, **k):
        calls.append(1)
        if spy.kill and len(calls) == sum(per_round[:2]) + 1:   # round 3's first launch
            raise KeyboardInterrupt
        return orig(*a, **k)

    spy.kill = True
    monkeypatch.setattr(tdist, "em_raw_cnt", spy)
    with pytest.raises(KeyboardInterrupt):
        list(tdist.iter_replicates(pars, P, [], S, CPU, round_ckpt=True, mesh=mesh))
    got = ckpt.load_rounds(pars.out, pars, 0, engine=tdist.engine_name(CPU, False),
                           chunk=st.layout())
    assert got is not None and got[0] == 2
    # another site split does not resume this file
    assert ckpt.load_rounds(pars.out, pars, 0, engine=tdist.engine_name(CPU, False),
                            chunk=pmh.SiteStream.from_array(P, pars, _cpu_mesh(4)).layout()) is None
    spy.kill = False
    calls.clear()
    resumed = list(tdist.iter_replicates(pars, P, [], S, CPU, round_ckpt=True, mesh=mesh))
    assert len(calls) == sum(per_round[2:])
    assert resumed[0].tobytes() == expected[0].tobytes()


def test_matrix_resume_across_mesh_shapes(tmp_path, monkeypatch):
    """The matrix-level sidecar holds across mesh shapes, as the JAX
    runner's does (its engine name is the device's, not the mesh's): a
    run stopped after two matrices on 4 x 1 continues on 2 x 2, and its
    output agrees with an uninterrupted run within 1e-9."""
    from ngsdist_tpu_torch import runner
    from ngsdist_tpu_torch.utils import signals

    rng = np.random.default_rng(71)
    S, N = 120, 6
    path = tmp_path / "gp.bin"
    _rand_probs(rng, S, N, missing=0.0).tofile(path)
    kw = dict(in_geno=str(path), in_bin=True, in_probs=True, n_ind=N, n_sites=S,
              indep_geno=True, pairwise_del=True, n_boot_rep=3, boot_block_size=10,
              seed=2, verbose=0)
    whole = runner.run(Params(out=str(tmp_path / "w.dist"), **kw), mesh=_cpu_mesh(4))
    out = str(tmp_path / "r.dist")
    stops = iter([False, True])
    monkeypatch.setattr(signals, "stop_requested", lambda: next(stops, False))
    first = runner.run(Params(out=out, **kw), mesh=_cpu_mesh(4))
    assert len(first) == 2 and ckpt.load(out, Params(out=out, **kw),
                                         engine=tdist.engine_name(CPU, False)) == 2
    rest = runner.run(Params(out=out, **kw), mesh=_cpu_mesh(4, pairs=2), resume=True)
    assert len(rest) == 2
    for g, w in zip(first + rest, whole):
        _close(g, w)
    assert not os.path.exists(ckpt.state_path(out))
