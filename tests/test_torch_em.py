"""The port's plain EM kernel (torch float64) against the JAX package:
the Pallas kernel in interpret mode and the batched EM engine."""

import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ngsdist_tpu.config import default_score_matrix  # noqa: E402
from ngsdist_tpu.core import distance as dist  # noqa: E402
from ngsdist_tpu.ops.pallas_em import em_raw_cnt_pallas  # noqa: E402
from ngsdist_tpu_torch.core import distance as tdist  # noqa: E402
from ngsdist_tpu_torch.ops import _build  # noqa: E402
from ngsdist_tpu_torch.ops import em as tem  # noqa: E402

torch.set_num_threads(2)


def _rand_probs(rng, S, N, missing_frac=0.15, zero_frac=0.0):
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < missing_frac] = 1.0 / 3.0
    P[rng.random((S, N)) < zero_frac] = 0.0
    return P


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weights", [None, "int", "float"])
@pytest.mark.parametrize("zero_frac", [0.0, 0.05])
def test_em_ref_matches_jax(pairwise_del, weights, zero_frac):
    rng = np.random.default_rng(11)
    S, N = 37, 10  # ragged against the Pallas tiles
    P = _rand_probs(rng, S, N, zero_frac=zero_frac)
    score9 = default_score_matrix().reshape(-1)
    w = {None: None,
         "int": rng.integers(0, 3, size=S).astype(np.float64),
         "float": rng.random(S)}[weights]
    iu = np.triu_indices(N, k=1)

    raw, cnt = tem.em_raw_cnt_ref(torch.from_numpy(P), score9, pairwise_del, w)
    raw, cnt = raw.numpy()[iu], cnt.numpy()[iu]

    raw_p, cnt_p = em_raw_cnt_pallas(
        jnp.asarray(P), score9, pairwise_del, site_weights=w,
        block=8, site_tile=8, interpret=True)
    np.testing.assert_allclose(raw, np.asarray(raw_p)[iu], rtol=1e-9, atol=1e-9)
    # counts are exact for integer multiplicities; float weights round
    cnt_rtol = 1e-12 if weights == "float" else 0
    np.testing.assert_allclose(cnt, np.asarray(cnt_p)[iu], rtol=cnt_rtol, atol=0)

    # the batched engine runs zero rows as uniform lanes (the runner
    # poisons them afterwards), so it is held to zero-free inputs only
    if zero_frac == 0.0:
        raw_e, cnt_e, _, _ = dist.em_suffstats(
            jnp.asarray(P), jnp.asarray(score9), pairwise_del, site_weights=w)
        np.testing.assert_allclose(raw, np.asarray(raw_e), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(cnt, np.asarray(cnt_e), rtol=cnt_rtol, atol=0)


def test_em_wider_cohort_matches_pallas():
    rng = np.random.default_rng(12)
    S, N = 60, 21
    P = _rand_probs(rng, S, N, zero_frac=0.02)
    score9 = default_score_matrix(True).reshape(-1)
    iu = np.triu_indices(N, k=1)
    raw, cnt = tem.em_raw_cnt_ref(torch.from_numpy(P), score9, True)
    raw_p, cnt_p = em_raw_cnt_pallas(jnp.asarray(P), score9, True,
                                     block=8, site_tile=8, interpret=True)
    np.testing.assert_allclose(raw.numpy()[iu], np.asarray(raw_p)[iu],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(cnt.numpy()[iu], np.asarray(cnt_p)[iu])


def test_em_chunked_sites_match_one_chunk(monkeypatch):
    """Site chunking of the plain version changes nothing but the order
    of the site sums."""
    rng = np.random.default_rng(13)
    P = torch.from_numpy(_rand_probs(rng, 50, 8))
    score9 = default_score_matrix().reshape(-1)
    raw1, cnt1 = tem.em_raw_cnt_ref(P, score9, False)
    monkeypatch.setattr(tem, "_lanes_per_chunk", lambda device: 28 * 7)
    raw7, cnt7 = tem.em_raw_cnt_ref(P, score9, False)
    np.testing.assert_allclose(raw7.numpy(), raw1.numpy(), rtol=1e-13, atol=0)
    np.testing.assert_array_equal(cnt7.numpy(), cnt1.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_em_zero_row_poison_matches_jax(weighted):
    rng = np.random.default_rng(14)
    S, N = 30, 7
    P = _rand_probs(rng, S, N)
    P[3, 1] = 0.0
    P[17, 5] = 0.0
    inc = None
    if weighted:
        w = np.ones(S)
        w[17] = 0.0  # an unsampled zero row does not poison
        inc = w > 0
    I, J = dist._pair_indices(N)
    vals = rng.random(len(I))
    z_j = dist._em_zero_rows(jnp.asarray(P),
                             None if inc is None else jnp.asarray(inc))
    want = np.asarray(dist._em_poison_pairs(jnp.asarray(vals), z_j,
                                            jnp.asarray(I), jnp.asarray(J)))
    # the port takes the flags from its record of the all-zero triples
    # (one pass per run) where the JAX engine scans the tensor per call
    z_t = torch.from_numpy(tdist.find_zero_rows(P).individuals(
        0, S, None if not weighted else w))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    got = tdist._em_poison_pairs(torch.from_numpy(vals), z_t,
                                 torch.from_numpy(I).long(),
                                 torch.from_numpy(J).long()).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got).any()


def test_em_nan_row_propagates():
    rng = np.random.default_rng(15)
    S, N = 25, 6
    P = _rand_probs(rng, S, N)
    Pn = P.copy()
    Pn[9, 4] = np.nan
    score9 = default_score_matrix().reshape(-1)
    raw, _ = tem.em_raw_cnt_ref(torch.from_numpy(P), score9, False)
    raw_n, _ = tem.em_raw_cnt_ref(torch.from_numpy(Pn), score9, False)
    iu = np.triu_indices(N, k=1)
    touched = (iu[0] == 4) | (iu[1] == 4)
    assert np.isnan(raw_n.numpy()[iu][touched]).all()
    np.testing.assert_array_equal(raw_n.numpy()[iu][~touched],
                                  raw.numpy()[iu][~touched])


def test_em_dispatch_cpu_uses_plain_version():
    rng = np.random.default_rng(16)
    P = torch.from_numpy(_rand_probs(rng, 20, 5))
    score9 = default_score_matrix().reshape(-1)
    before = tem.LAUNCHES
    got = tem.em_raw_cnt(P, score9, True)
    want = tem.em_raw_cnt_ref(P, score9, True)
    assert tem.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("block_size", [1, 5, 16, 37])
def test_em_block_partials_ref_matches_jax(pairwise_del, block_size):
    """B, C [n_blocks, n_pairs] against em_suffstats(n_blocks=...)'s:
    |ΔB| <= 1e-12·C, C exact.  All-zero rows only under pairwise
    deletion: without it the JAX scan counts a dead lane in C and the
    kernels do not, and neither value is used (the pair is poisoned and
    the denominator is the site count)."""
    rng = np.random.default_rng(200 + block_size)
    n_blocks = 74 // block_size
    P = _rand_probs(rng, n_blocks * block_size, 10,
                    zero_frac=0.05 if pairwise_del else 0.0)
    assert pairwise_del == bool((P == 0).all(-1).any())
    score9 = default_score_matrix().reshape(-1)
    B, C = tem.em_block_partials_ref(torch.from_numpy(P), score9, pairwise_del,
                                     n_blocks, block_size)
    _, _, B_j, C_j = dist.em_suffstats(jnp.asarray(P), jnp.asarray(score9), pairwise_del,
                                       n_blocks=n_blocks, block_size=block_size)
    B_j, C_j = np.asarray(B_j), np.asarray(C_j)
    assert B.shape == B_j.shape == (n_blocks, 45)
    np.testing.assert_array_equal(C.numpy(), C_j)
    assert (np.abs(B.numpy() - B_j) <= 1e-12 * C_j).all()


@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_block_partials_add_up_to_raw_cnt(pairwise_del, monkeypatch):
    """The blocks add up to the unweighted statistics over the same sites,
    also when the plain version's site chunks cut through blocks."""
    rng = np.random.default_rng(201)
    P = torch.from_numpy(_rand_probs(rng, 63, 9, zero_frac=0.03))
    P[5, 2] = float("nan")
    score9 = default_score_matrix().reshape(-1)
    monkeypatch.setattr(tem, "_lanes_per_chunk", lambda device: 36 * 10)
    B, C = tem.em_block_partials(P, score9, pairwise_del, 9, 7)
    raw, cnt = tem.em_raw_cnt_ref(P, score9, pairwise_del)
    I, J = np.triu_indices(9, k=1)
    np.testing.assert_allclose(B.sum(0).numpy(), raw.numpy()[I, J], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(C.sum(0).numpy(), cnt.numpy()[I, J])
    # the NaN row poisons its pairs in its own block only
    touched = (I == 2) | (J == 2)
    assert np.isnan(B.numpy()[0, touched]).all()
    assert not np.isnan(np.delete(B.numpy(), 0, axis=0)).any()


def test_em_block_partials_reject_ragged_sites():
    P = torch.zeros((10, 4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="not 2 blocks of 4"):
        tem.em_block_partials(P, default_score_matrix().reshape(-1), False, 2, 4)


# The kernel's arithmetic (per-individual tables of r_k and of sequential
# powers, csrc/em.cu) in plain PyTorch, against the plain versions.
# Shapes cross the kernel's 32-individual tiles and its 2-site step.
_TABLE_SHAPES = [(7, 5), (31, 9), (33, 13), (65, 6)]  # (N, S)


def _table_case(seed, S, N):
    rng = np.random.default_rng(seed)
    P = _rand_probs(rng, S, N, zero_frac=0.04)
    P[rng.integers(S), rng.integers(N)] = np.nan
    P[rng.integers(S), rng.integers(N)] = [1.0, 1.0 - 1e-9, 0.0]  # a slow lane
    return rng, torch.from_numpy(P)


def _k_star_by_hand(P, a, b):
    """k* of one lane by the definition, in Python floats."""
    hi = float(np.exp(tem.EM_TOLE))
    rows = []
    for row in (P[a], P[b]):
        p = [float(v) / float(max(row)) for v in row]
        t = [3.0] + [sum(v ** 1 for v in p)]
        pk = list(p)
        for _ in range(tem.EM_MAX_ITER - 1):
            pk = [x * y for x, y in zip(pk, p)]
            t.append(pk[0] + pk[1] + pk[2])
        rows.append([t[k + 1] * t[k - 1] / (t[k] * t[k]) for k in range(1, tem.EM_MAX_ITER)])
    for k, (ri, rj) in enumerate(zip(*rows), start=1):
        if not ri * rj >= hi:
            return k
    return tem.EM_MAX_ITER


@pytest.mark.parametrize("N,S", _TABLE_SHAPES)
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_tables_lanes_match_plain(N, S, pairwise_del):
    """Lane by lane: the same stopping step, the same mask, and a
    contribution within EM_TABLE_LANE_BOUND x max|score|."""
    _, P = _table_case(300 + N, S, N)
    score = torch.from_numpy(default_score_matrix())
    hi = torch.tensor(np.exp(tem.EM_TOLE), dtype=torch.float64)
    I, J = torch.triu_indices(N, N, offset=1)
    c_p, m_p, k_p = tem._em_sites(P, score, I, J, pairwise_del, hi)
    c_t, m_t, k_t = tem._em_sites_tables(P, score, I, J, pairwise_del, hi)
    assert torch.equal(k_t, k_p.long())
    assert int(k_t.max()) > 20 and int(k_t.min()) == 0
    assert torch.equal(m_t, m_p)
    assert torch.equal(torch.isnan(c_t), torch.isnan(c_p))
    ok = ~torch.isnan(c_p)
    err = (c_t - c_p).abs()[ok]
    assert float(err.max()) <= tem.EM_TABLE_LANE_BOUND * float(score.abs().max())
    # a few lanes by the definition itself
    live = torch.nonzero(m_p[0] > 0).reshape(-1)[:5]
    for lane in live.tolist():
        a, b = int(I[lane]), int(J[lane])
        if not (torch.isnan(P[0, a]).any() or torch.isnan(P[0, b]).any()):
            assert int(k_t[0, lane]) + 1 == _k_star_by_hand(P[0].numpy(), a, b)


@pytest.mark.parametrize("N,S", _TABLE_SHAPES)
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_em_tables_raw_cnt_match_plain(N, S, pairwise_del, weighted):
    rng, P = _table_case(400 + N, S, N)
    score9 = default_score_matrix().reshape(-1)
    w = rng.integers(0, 4, size=S).astype(np.float64) if weighted else None
    raw_p, cnt_p = tem.em_raw_cnt_ref(P, score9, pairwise_del, w)
    raw_t, cnt_t = tem.em_raw_cnt_tables(P, score9, pairwise_del, w)
    assert torch.equal(cnt_t, cnt_p)
    assert torch.equal(torch.isnan(raw_t), torch.isnan(raw_p))
    ok = ~torch.isnan(raw_p)
    bound = tem.em_table_bound(S) * np.abs(score9).max() * cnt_p
    assert bool(((raw_t - raw_p).abs()[ok] <= bound[ok]).all())


# The kernel's site slices (csrc/em.cu site_slice) and the rule that picks
# their number, G, on an H100: 132 SMs, two of the kernel's blocks each.
_H100 = (132, 2)


@pytest.mark.parametrize("n_tiles,n_sites,want,fill", [
    (528, 16384, 1, 1.0),        # N = 1024: two whole waves of 264
    (528, 262144, 1, 1.0),
    (21, 262144, 25, 0.99),      # N = 179: 525 blocks, 99.4% of two waves
    (630, 32768, 5, 0.99),       # N = 1,092: 3,150 blocks, 99.4% of 12 waves
    (21, 2 * 4096 - 1, 1, 0.0),  # fewer sites than two slices hold
    (3, 777, 1, 0.0),            # the tests' and the goldens' sizes
    (275, 16384, 4, 0.8),        # a tile list: a pairs shard's, two shards at N = 1024
    (8256, 262144, 1, 0.9),      # N = 4,096: 32 waves, past the sliced launch's 16
])
def test_em_site_slices_rule(n_tiles, n_sites, want, fill):
    """G from the tile count, the site count, the SMs and the blocks per
    SM: the fewest waves a slice, the smaller G on a tie, at least
    EM_SLICE_MIN_SITES sites a slice and EM_SLICE_MAX_WAVES waves; the
    same on every call; the slots filled, in the waves it takes, at least
    `fill`."""
    G = tem.em_site_slices(n_tiles, n_sites, *_H100)
    assert G == want
    assert [tem.em_site_slices(n_tiles, n_sites, *_H100) for _ in range(3)] == [G] * 3
    slots = _H100[0] * _H100[1]

    def per_slice(g):
        return -(-n_tiles * g // slots) / g

    if G > 1:
        assert n_sites // G >= tem.EM_SLICE_MIN_SITES
        assert n_tiles * G <= tem.EM_SLICE_MAX_WAVES * slots
    assert n_tiles * G / (-(-n_tiles * G // slots) * slots) >= fill
    g_max = max(1, min(n_sites // tem.EM_SLICE_MIN_SITES,
                       tem.EM_SLICE_MAX_WAVES * slots // n_tiles))
    assert all(per_slice(g) > per_slice(G) for g in range(1, G))
    assert all(per_slice(g) >= per_slice(G) for g in range(G, g_max + 1))


@pytest.mark.parametrize("n_sites", [0, 1, 2, 7, 8192, 32769, 262144])
@pytest.mark.parametrize("slices", [1, 2, 3, 5, 25])
def test_em_slice_bounds_cover_the_sites(n_sites, slices):
    """Slice bounds: [0, S) covered once, in order, every bound but S a
    multiple of the kernel's 2-site step, slices within a step of each
    other's length; one slice is [0, S)."""
    b = tem.em_slice_bounds(n_sites, slices)
    assert len(b) == slices + 1 and b[0] == 0 and b[-1] == n_sites
    assert all(x <= y for x, y in zip(b, b[1:]))
    assert all(x % tem.EM_STEP == 0 for x in b[:-1])
    lengths = [y - x for x, y in zip(b, b[1:])]
    assert max(lengths) - min(lengths) <= 2 * tem.EM_STEP
    if slices == 1:
        assert b == [0, n_sites]


@pytest.mark.parametrize("N,S", [(7, 41), (33, 27)])
@pytest.mark.parametrize("slices", [2, 3, 5])
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_em_tables_sliced_sum_order(N, S, slices, pairwise_del, weighted):
    """The kernel's sum at G site slices in plain PyTorch: cnt exact, the
    NaN pattern the plain version's, raw within em_table_bound(S) x cnt x
    max|score| of both the unsliced order and the plain version."""
    rng, P = _table_case(600 + N + slices, S, N)
    score9 = default_score_matrix().reshape(-1)
    w = rng.integers(0, 4, size=S).astype(np.float64) if weighted else None
    raw_s, cnt_s = tem.em_raw_cnt_tables(P, score9, pairwise_del, w, slices=slices)
    raw_p, cnt_p = tem.em_raw_cnt_ref(P, score9, pairwise_del, w)
    bound = tem.em_table_bound(S) * np.abs(score9).max() * cnt_p
    ok = ~torch.isnan(raw_p)
    for raw, cnt in (tem.em_raw_cnt_tables(P, score9, pairwise_del, w), (raw_p, cnt_p)):
        assert torch.equal(cnt_s, cnt)
        assert torch.equal(torch.isnan(raw_s), torch.isnan(raw))
        assert bool(((raw_s - raw).abs()[ok] <= bound[ok]).all())


def test_em_wrapper_launches_the_slices(monkeypatch):
    """The CUDA wrapper on CPU tensors against a stand-in library and an
    H100's slots: one entry, with the arguments `_build._configure`
    declares, G and a scratch for G > 1, G = 1 and no scratch for a small
    input (the card not asked) and for slices=1; the launch counters and
    SITE_SLICES count each."""
    calls, asked = [], []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    class Lib:
        def __getattr__(self, name):
            setattr(self, name, Entry(name))
            return getattr(self, name)

    lib = Lib()
    _build._configure(lib)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "check_probs", lambda P: None)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tem, "_card_slots", lambda P: asked.append(P.dtype) or _H100)
    score9 = default_score_matrix().reshape(-1)
    names = ("LAUNCHES", "TILE_LAUNCHES", "SLICED_LAUNCHES", "SITE_SLICES")
    for dtype, sfx in ((torch.float32, ""), (torch.float64, "_F64")):
        big, small = torch.zeros((16384, 33, 3), dtype=dtype), torch.zeros((101, 33, 3),
                                                                          dtype=dtype)
        tiles = torch.tensor([2, 0], dtype=torch.int32)
        for P, tl, slices, G in (
                (big, None, None, 4),   # 3 tiles x 16,384 sites
                (big, tiles, None, 4),
                (big, None, 3, 3),
                (big, None, 1, 1),
                (small, None, None, 1)):
            before = [getattr(tem, n + sfx) for n in names]
            calls.clear()
            asked.clear()
            tem._em_cuda(P, score9, False, None, None, tl, slices=slices)
            (name, args), = calls
            assert name == f"ngsd_em_raw_cnt_{'f64' if sfx else 'f32'}"
            assert len(args) == len(getattr(lib, name).argtypes)
            assert args[12] == G and (args[13].value is not None) == (G > 1)
            assert asked == ([dtype] if slices is None and P is big else [])
            moved = [getattr(tem, n + sfx) - b for n, b in zip(names, before)]
            assert moved == [int(tl is None), int(tl is not None), int(G > 1), G]


def _same_bytes(a, b):
    return a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _weight_rows(rng, S, R):
    """R bootstrap-like weight rows over S sites: integer multiplicities, a
    row of zeros, and weight 0 on site 0 for every row but the first."""
    W = rng.integers(0, 4, size=(R, S)).astype(np.float64)
    W[R // 2] = 0.0
    W[1:, 0] = 0.0
    return W


@pytest.mark.parametrize("N,S", [(7, 41), (33, 27)])
@pytest.mark.parametrize("fn,slices", [("ref", 1), ("tables", 1), ("tables", 3)])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_weight_rows_equal_one_row_calls(N, S, fn, slices, pairwise_del):
    """Weight rows [R', S] through the plain versions: row r holds the
    bytes of the one-row call with weights [r] (a row of zeros, rows of
    weight 0 at a NaN site included), at the kernel's slice order too."""
    rng, P = _table_case(600 + N, S, N)
    P[0, 1] = float("nan")
    score9 = default_score_matrix().reshape(-1)
    W = _weight_rows(rng, S, 5)

    def call(w):
        if fn == "ref":
            return tem.em_raw_cnt_ref(P, score9, pairwise_del, w)
        return tem.em_raw_cnt_tables(P, score9, pairwise_del, w, slices=slices)

    raw, cnt = call(W)
    assert raw.shape == cnt.shape == (5, N, N)
    for r in range(5):
        one = call(W[r])
        assert _same_bytes(raw[r], one[0]) and _same_bytes(cnt[r], one[1])


def test_em_weight_rows_dispatch_on_the_cpu():
    """em_raw_cnt with weight rows on a CPU tensor: the plain version's
    rows, cnt only under pairwise deletion; no site list or tile list."""
    rng, P = _table_case(700, 19, 9)
    score9 = default_score_matrix().reshape(-1)
    W = _weight_rows(rng, 19, 3)
    for pairwise_del in (False, True):
        raw, cnt = tem.em_raw_cnt(P, score9, pairwise_del, W)
        want = tem.em_raw_cnt_ref(P, score9, pairwise_del, W)
        assert _same_bytes(raw, want[0])
        assert cnt is None if not pairwise_del else _same_bytes(cnt, want[1])
    with pytest.raises(ValueError, match="every site and every tile"):
        tem.em_raw_cnt(P, score9, False, W, site_index=torch.arange(19))
    with pytest.raises(ValueError, match="every site and every tile"):
        tem.em_raw_cnt(P, score9, False, W, tiles=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("n_rows", [1, 3, 4, 5, 9])
def test_em_rows_wrapper_launches_groups(monkeypatch, pairwise_del, n_rows):
    """The weight-row wrapper on CPU tensors against a stand-in library and
    an H100's slots: groups of em_weight_rows rows to the rows entry (the
    arguments `_build._configure` declares, the one-row launch's G, a
    scratch of EM_WEIGHT_ROWS sums a lane when G > 1, cnt only under
    pairwise deletion), a group of one to the one-row entry; LAUNCHES,
    ROW_LAUNCHES, WEIGHT_ROWS and SITE_SLICES count each launch."""
    calls = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    class Lib:
        def __getattr__(self, name):
            setattr(self, name, Entry(name))
            return getattr(self, name)

    lib = Lib()
    _build._configure(lib)
    lib.ngsd_em_weight_rows = lambda: tem.EM_WEIGHT_ROWS
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "check_probs", lambda P: None)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tem, "_card_slots", lambda P: _H100)
    score9 = default_score_matrix().reshape(-1)
    step = tem.em_weight_rows(pairwise_del)
    names = ("LAUNCHES", "ROW_LAUNCHES", "WEIGHT_ROWS", "SITE_SLICES")
    for dtype, sfx in ((torch.float32, ""), (torch.float64, "_F64")):
        P = torch.zeros((16384, 33, 3), dtype=dtype)   # 3 tiles: G = 4 on an H100
        W = torch.ones((n_rows, 16384), dtype=dtype)
        before = [getattr(tem, n + sfx) for n in names]
        calls.clear()
        raw, cnt = tem._em_rows_cuda(P, score9, pairwise_del, W)
        assert raw.shape == (n_rows, 33, 33) and (cnt is not None) == pairwise_del
        groups = [min(step, n_rows - r0) for r0 in range(0, n_rows, step)]
        assert len(calls) == len(groups)
        for (name, args), rows in zip(calls, groups):
            if rows == 1:
                assert name == f"ngsd_em_raw_cnt_{'f64' if sfx else 'f32'}"
                assert args[12] == 4
                continue
            assert name == f"ngsd_em_raw_cnt_rows_{'f64' if sfx else 'f32'}"
            assert len(args) == len(getattr(lib, name).argtypes)
            assert args[2] == rows and args[10] == 4 and args[11].value is not None
            assert (args[4].value is not None) == pairwise_del
        moved = [getattr(tem, n + sfx) - b for n, b in zip(names, before)]
        assert moved == [len(groups), sum(g > 1 for g in groups), n_rows, 4 * len(groups)]


@pytest.mark.parametrize("N", [7, 33])
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("block_size", [1, 3, 5, 6])
def test_em_tables_block_partials_match_plain(N, pairwise_del, block_size):
    """Block ends inside and on the kernel's 2-site steps: C exact, B
    within em_table_bound(block_size) x C x max|score|."""
    n_blocks = 26 // block_size
    _, P = _table_case(500 + N, n_blocks * block_size, N)
    score9 = default_score_matrix().reshape(-1)
    B_p, C_p = tem.em_block_partials_ref(P, score9, pairwise_del, n_blocks, block_size)
    B_t, C_t = tem.em_block_partials_tables(P, score9, pairwise_del, n_blocks, block_size)
    assert B_t.shape == (n_blocks, N * (N - 1) // 2)
    assert torch.equal(C_t, C_p)
    assert torch.equal(torch.isnan(B_t), torch.isnan(B_p))
    ok = ~torch.isnan(B_p)
    bound = tem.em_table_bound(block_size) * np.abs(score9).max() * C_p
    assert bool(((B_t - B_p).abs()[ok] <= bound[ok]).all())


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weights", [None, "int"])
def test_em_tables_match_jax(pairwise_del, weights):
    """The kernel's arithmetic against the JAX package: the Pallas kernel
    in interpret mode (rtol = atol = 1e-9, the tolerance the plain
    version is held to) and, zero rows aside, the batched EM engine."""
    rng = np.random.default_rng(21)
    S, N = 37, 10
    P = _rand_probs(rng, S, N)
    score9 = default_score_matrix().reshape(-1)
    w = None if weights is None else rng.integers(0, 3, size=S).astype(np.float64)
    iu = np.triu_indices(N, k=1)
    raw, cnt = tem.em_raw_cnt_tables(torch.from_numpy(P), score9, pairwise_del, w)
    raw, cnt = raw.numpy()[iu], cnt.numpy()[iu]
    raw_p, cnt_p = em_raw_cnt_pallas(
        jnp.asarray(P), score9, pairwise_del, site_weights=w,
        block=8, site_tile=8, interpret=True)
    np.testing.assert_allclose(raw, np.asarray(raw_p)[iu], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(cnt, np.asarray(cnt_p)[iu])
    raw_e, cnt_e, _, _ = dist.em_suffstats(
        jnp.asarray(P), jnp.asarray(score9), pairwise_del, site_weights=w)
    np.testing.assert_allclose(raw, np.asarray(raw_e), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(cnt, np.asarray(cnt_e))


def test_em_table_bound_reckoning():
    """The lanes' bound is 2^-45; a sum over n sites adds 2 n u."""
    assert tem.EM_TABLE_LANE_BOUND == 2.0 ** -45
    assert tem.em_table_bound(256) == 2.0 ** -45 + 512 * 2.0 ** -53
    assert tem.em_table_bound(256) < 1e-13


def test_em_work_counts_lanes_and_tests():
    rng = np.random.default_rng(22)
    S, N = 9, 6
    P = _rand_probs(rng, S, N, zero_frac=0.1)
    work = tem.em_work(torch.from_numpy(P))
    dead = (P == 0).all(-1)
    assert work["live_rows"] == int((~dead).sum())
    I, J = np.triu_indices(N, k=1)
    live = ~(dead[:, I] | dead[:, J])
    assert work["live_lanes"] == int(live.sum())
    tests = sum(min(_k_star_by_hand(P[s], a, b), tem.EM_MAX_ITER - 1)
                for s in range(S) for a, b, ok in zip(I, J, live[s]) if ok)
    assert work["tests"] == tests
