"""The port's plain indep kernel (torch float64) against the JAX package:
the Pallas kernel in interpret mode and the einsum engine; and the CUDA
kernel's arithmetic (3xTF32 on the tensor cores, float32 windows,
float64 across windows and chunks), emulated in plain PyTorch, against
the float64 plain version within chip_smoke.py's bounds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ngsdist_tpu.config import default_score_matrix  # noqa: E402
from ngsdist_tpu.core import distance as dist  # noqa: E402
from ngsdist_tpu.ops.pallas_indep import indep_raw_cnt_pallas  # noqa: E402
import chip_smoke  # noqa: E402
from ngsdist_tpu_torch.ops import _build  # noqa: E402
from ngsdist_tpu_torch.ops import indep as tindep  # noqa: E402

torch.set_num_threads(2)


def _rand_probs(rng, S, N, missing_frac=0.2):
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < missing_frac] = 1.0 / 3.0
    P[rng.random((S, N)) < 0.02] = 0.0  # data-borne all-zero rows
    return P


CASES = [(53, 11, pd, avg, wt) for pd in (False, True) for avg in (False, True)
         for wt in (False, True)]
CASES += [(300, 40, pd, False, True) for pd in (False, True)]


@pytest.mark.parametrize("S,N,pairwise_del,avg_nuc,weighted", CASES)
def test_indep_ref_matches_jax(S, N, pairwise_del, avg_nuc, weighted):
    rng = np.random.default_rng(S + N)
    P = _rand_probs(rng, S, N)
    score = default_score_matrix(avg_nuc)
    w = rng.integers(0, 4, size=S).astype(np.float64) if weighted else None

    raw, cnt = tindep.indep_raw_cnt_ref(torch.from_numpy(P), score,
                                        pairwise_del, w)
    raw, cnt = raw.numpy(), cnt.numpy()
    iu = np.triu_indices(N)  # upper triangle with the diagonal

    raw_p, cnt_p = indep_raw_cnt_pallas(
        jnp.asarray(P), score, pairwise_del, site_weights=w,
        block=8, site_tile=8, interpret=True)
    np.testing.assert_allclose(raw[iu], np.asarray(raw_p)[iu],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(cnt[iu], np.asarray(cnt_p)[iu])

    raw_e, cnt_e = dist.indep_suffstats(
        jnp.asarray(P), jnp.asarray(score), pairwise_del,
        None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(raw[iu], np.asarray(raw_e)[iu],
                               rtol=1e-12, atol=1e-12)
    if pairwise_del:
        np.testing.assert_array_equal(cnt[iu], np.asarray(cnt_e)[iu])


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_indep_suffstats_matches_jax(pairwise_del, weighted):
    """The plain version over the whole [N, N], lower triangle included,
    against the JAX engine's einsum formulation."""
    rng = np.random.default_rng(5)
    S, N = 53, 11
    P = _rand_probs(rng, S, N)
    score = default_score_matrix()
    w = rng.integers(0, 4, size=S).astype(np.float64) if weighted else None
    raw, cnt = tindep.indep_raw_cnt_ref(torch.from_numpy(P), score,
                                        pairwise_del, w)
    raw_e, cnt_e = dist.indep_suffstats(
        jnp.asarray(P), jnp.asarray(score), pairwise_del,
        None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_e),
                               rtol=1e-12, atol=1e-12)
    if pairwise_del:
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_e))


def test_missing_mask_matches_jax():
    """Under pairwise deletion a row is valid when it is nonzero and not
    missing in the JAX engine's sense."""
    rng = np.random.default_rng(6)
    P = _rand_probs(rng, 40, 9)
    want = (~np.asarray(dist.missing_mask(jnp.asarray(P)))) & (P.sum(-1) > 0)
    np.testing.assert_array_equal(
        tindep.valid_mask(torch.from_numpy(P), True).numpy(), want.astype(np.float64))


def test_nan_row_propagates_into_raw():
    """A NaN row poisons raw for every pair it touches (masks multiply)
    and nothing else."""
    rng = np.random.default_rng(7)
    S, N = 30, 6
    P = _rand_probs(rng, S, N)
    Pn = P.copy()
    Pn[4, 2] = np.nan
    score = default_score_matrix()
    raw, _ = tindep.indep_raw_cnt_ref(torch.from_numpy(P), score, True)
    raw_n, _ = tindep.indep_raw_cnt_ref(torch.from_numpy(Pn), score, True)
    touched = np.zeros((N, N), bool)
    touched[2, :] = touched[:, 2] = True
    assert np.isnan(raw_n.numpy()[touched]).all()
    np.testing.assert_array_equal(raw_n.numpy()[~touched], raw.numpy()[~touched])


def test_dispatch_cpu_uses_plain_version():
    rng = np.random.default_rng(8)
    P = torch.from_numpy(_rand_probs(rng, 20, 5))
    score = default_score_matrix()
    before = tindep.LAUNCHES
    got = tindep.indep_raw_cnt(P, score, True)
    want = tindep.indep_raw_cnt_ref(P, score, True)
    assert tindep.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_input_checks():
    P = torch.zeros((4, 3, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_probs(P)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_path_keyed_by_sources():
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path()
    assert len(_build._sources()) >= 3  # indep.cu, em.cu, common.cuh


@pytest.mark.parametrize("broken", [False, True], ids=["builds", "compile_error"])
def test_each_source_compiled_by_its_own_process_then_linked(broken, monkeypatch, tmp_path):
    """utils/buildlib.compile_into, which builds both libraries (one
    compiler process a source, then one link), with the host C compiler
    on two small C files: the linked library holds both files' functions
    and the log every command; a compile error raises with the compiler's
    message and leaves neither library nor objects behind."""
    import ctypes

    from ngsdist_tpu_torch.utils import buildlib

    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path))
    srcs = []
    for name, body in (("a", "int ngsd_a(void) { return 1; }"),
                       ("b", "int ngsd_b(void) { return 2%s; }" % (" +" if broken else ""))):
        srcs.append(str(tmp_path / f"{name}.c"))
        with open(srcs[-1], "w") as fh:
            fh.write(body + "\n")
    lib = str(tmp_path / "libtwo_0.so")
    if broken:
        with pytest.raises(RuntimeError, match="failed"):
            buildlib.compile_into(lib, ["cc", "-fPIC", "-O2"], srcs, ["-lm"])
        assert sorted(f.name for f in tmp_path.iterdir()) == ["a.c", "b.c", "libtwo_0.log"]
        return
    buildlib.compile_into(lib, ["cc", "-fPIC", "-O2"], srcs, ["-lm"])
    so = ctypes.CDLL(lib)
    assert (so.ngsd_a(), so.ngsd_b()) == (1, 2)
    log = open(str(tmp_path / "libtwo_0.log")).read()
    assert log.count(" -c ") == 2 and "-shared" in log and log.rstrip().endswith("-lm")


# -- block mode: the partial-sum bootstrap's per-block sums -------------------


def _block_probs(rng, block_size, N=70, sites=74):
    """Probabilities of the blocks that fit in `sites`, with missing,
    all-zero and NaN rows; (P, n_blocks)."""
    n_blocks = sites // block_size
    P = _rand_probs(rng, n_blocks * block_size, N)
    P[rng.integers(len(P), size=2), rng.integers(N, size=2)] = np.nan
    return P, n_blocks


@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("block_size", [1, 5, 16, 37])
def test_indep_block_partials_ref_matches_jax(pairwise_del, block_size):
    """B (and C) against the JAX engine's indep_block_partials, NaN and
    all-zero rows included: B within 1e-12 relative, NaN for NaN.  C is
    held where B is a number: on a NaN row the JAX engine counts the row
    (missing_mask is false for NaN), the port does not, and such pairs'
    partials are NaN either way."""
    rng = np.random.default_rng(100 + block_size)
    P, n_blocks = _block_probs(rng, block_size)
    score = default_score_matrix()
    B, C = tindep.indep_block_partials_ref(torch.from_numpy(P), score, pairwise_del,
                                           n_blocks, block_size)
    B_j, C_j = dist.indep_block_partials(jnp.asarray(P), jnp.asarray(score), pairwise_del,
                                         n_blocks, block_size)
    B_j = np.asarray(B_j)
    assert B.shape == B_j.shape == (n_blocks, 70, 70)
    assert np.isnan(B_j).any()
    np.testing.assert_allclose(B.numpy(), B_j, rtol=1e-12, atol=0)
    if pairwise_del:
        ok = ~np.isnan(B_j)
        np.testing.assert_array_equal(C.numpy()[ok], np.asarray(C_j)[ok])
    else:
        assert C is None and C_j is None


@pytest.mark.parametrize("pairwise_del", [False, True])
def test_indep_block_partials_add_up_to_raw_cnt(pairwise_del):
    """The dispatcher's pair layout on the CPU: B[:, p] for the pairs
    a < b in triu order, and the blocks add up to the unweighted
    statistics over the same sites."""
    rng = np.random.default_rng(101)
    P, n_blocks = _block_probs(rng, 5, N=23, sites=80)
    Pt = torch.from_numpy(P)
    score = default_score_matrix()
    B, C = tindep.indep_block_partials(Pt, score, pairwise_del, n_blocks, 5)
    I, J = np.triu_indices(23, k=1)
    assert B.shape == (n_blocks, len(I))
    raw, cnt = tindep.indep_raw_cnt_ref(Pt, score, pairwise_del)
    np.testing.assert_allclose(B.sum(0).numpy(), raw.numpy()[I, J], rtol=1e-12, atol=0)
    if pairwise_del:
        np.testing.assert_array_equal(C.sum(0).numpy(), cnt.numpy()[I, J])
    else:
        assert C is None


def test_block_partials_reject_ragged_sites():
    P = torch.zeros((10, 4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="not 3 blocks of 3"):
        tindep.indep_block_partials(P, default_score_matrix(), False, 3, 3)


def _upper_tile(k):
    """csrc/common.cuh upper_tile: block index -> (ti, tj), ti <= tj."""
    r = int((np.sqrt(8.0 * k + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > k:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= k:
        r += 1
    return k - r * (r + 1) // 2, r


@pytest.mark.parametrize("N", [1, 2, 64, 65, 130, 300])
def test_tile_offsets_follow_the_kernels_layout(N):
    """tile_offsets finds each pair (a, b), a <= b, where the kernel's
    block for upper tile k (the enumeration of csrc/common.cuh) writes
    it: row a - 64 ti, column b - 64 tj of tile k."""
    tiles = tindep.upper_tiles(N)
    T = tindep.TILE
    labels = np.full((tiles, T, T), -1, dtype=np.int64)
    for k in range(tiles):
        ti, tj = _upper_tile(k)
        rows = np.arange(ti * T, ti * T + T)[:, None]
        cols = np.arange(tj * T, tj * T + T)[None, :]
        labels[k] = rows * N + cols
    I, J = torch.triu_indices(N, N)
    got = labels.reshape(-1)[tindep.tile_offsets(N, I, J).numpy()]
    np.testing.assert_array_equal(got, (I * N + J).numpy())


# -- the CUDA kernel's arithmetic, emulated -------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero (PTX
    cvt.rna.tf32.f32): add half of the 13 dropped mantissa bits to the
    magnitude, then clear them.  NaN and inf pass through."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _split_tf32(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 step per output: c + sum over 8 k of a[k, m] b[k, n],
    the TF32 products summed exactly and the result rounded toward zero
    to float32 (the tensor cores truncate; round-to-nearest would only
    be closer)."""
    exact = c.double() + a.double().T @ b.double()
    r = exact.float()
    too_far = r.double().abs() > exact.abs()
    return torch.where(too_far, torch.nextafter(r, torch.zeros_like(r)), r)


def _emulate_kernel(P32, score, pairwise_del, w, chunk_sites, blocks=False):
    """csrc/indep.cu's sums on [S, N, 3] float32 inputs: per chunk, steps
    of STEP sites (zero filled past the chunk end); raw over k =
    (genotype, site), one k-step of 8 per genotype, hi*hi into one float32
    accumulator and hi*lo, lo*hi into another, both added (in float32)
    into float64 at the end of every WINDOW sites; cnt in float32 over the
    whole chunk, the i side split when weighted.  Chunks add in index
    order in float64; in block mode (blocks=True) the chunks' float64
    partials [chunks, N, N] are returned instead."""
    S, N, _ = P32.shape
    step = tindep.STEP
    sc = torch.as_tensor(score, dtype=torch.float32).reshape(9)
    wt = None if w is None else torch.as_tensor(w, dtype=torch.float32)
    zero = torch.zeros(N, N, dtype=torch.float32)
    raw = torch.zeros(N, N, dtype=torch.float64)
    cnt = torch.zeros_like(raw)
    parts = []
    for c0 in range(0, max(S, 1), chunk_sites):
        c_end = min(S, c0 + chunk_sites)
        r64, hh, corr, cn = torch.zeros_like(raw), zero, zero, zero
        for s0 in range(c0, c_end, step):
            p = torch.zeros(step, N, 3, dtype=torch.float32)
            n_in = min(step, c_end - s0)
            p[:n_in] = P32[s0:s0 + n_in]
            v = tindep.valid_mask(p, pairwise_del)
            ws = torch.ones(step)
            if wt is not None:
                ws[:n_in] = wt[s0:s0 + n_in]
            vi = v * ws[:, None]
            q = p * v[..., None]
            for g in range(3):
                a = p[..., g] * vi
                b = sc[3 * g] * q[..., 0] + sc[3 * g + 1] * q[..., 1] + sc[3 * g + 2] * q[..., 2]
                (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
                hh = _mma(hh, ah, bh)
                corr = _mma(corr, ah, bl)
                corr = _mma(corr, al, bh)
            if wt is None:
                cn = _mma(cn, vi, v)
            else:
                vh, vl = _split_tf32(vi)
                cn = _mma(_mma(cn, vh, v), vl, v)
            if (s0 + step - c0) % tindep.WINDOW == 0 or s0 + step >= c_end:
                r64 = r64 + (hh + corr).double()
                hh, corr = zero, zero
        parts.append((r64, cn.double()))
    if blocks:
        return tuple(torch.stack(planes) for planes in zip(*parts))
    for r64, cn in parts:
        raw = raw + r64
        cnt = cnt + cn
    return raw.float(), cnt.float()


EMU_CASES = [(53, 11, 64), (300, 40, 112), (777, 24, 256)]


@pytest.mark.parametrize("S,N,chunk_sites", EMU_CASES)
@pytest.mark.parametrize("pairwise_del", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_emulated_kernel_within_bounds(S, N, chunk_sites, pairwise_del, weighted):
    """With NaN rows, zero rows and integer weights, over one or several
    site chunks (the last ragged): cnt exact, the NaN pattern of the
    plain version, raw within chip_smoke.INDEP_RTOL relative."""
    rng = np.random.default_rng(S * N + chunk_sites)
    P = _rand_probs(rng, S, N)
    P[rng.integers(S, size=2), rng.integers(N, size=2)] = np.nan
    P32 = torch.from_numpy(P).float()
    score = default_score_matrix()
    w = rng.integers(0, 4, size=S).astype(np.float64) if weighted else None
    got = _emulate_kernel(P32, score, pairwise_del, w, chunk_sites)
    want = tindep.indep_raw_cnt_ref(P32.double(), score, pairwise_del, w)
    rel, _ = chip_smoke.check_kernel("indep", torch, *got, *want)
    assert rel <= chip_smoke.INDEP_RTOL


@pytest.mark.parametrize("block_size", [1, 5, 37])
@pytest.mark.parametrize("pairwise_del", [False, True])
def test_emulated_block_mode_within_bounds(block_size, pairwise_del):
    """Block mode: one chunk per bootstrap block of any length, so a
    block's steps start off the 8-site grid and its last step and 16-site
    window are ragged (zero filled).  Each block's partials against the
    plain version's, with NaN and zero rows: C exact, B within
    chip_smoke.INDEP_RTOL relative, the NaN pattern equal."""
    rng = np.random.default_rng(300 + block_size)
    P, n_blocks = _block_probs(rng, block_size, N=24)
    P32 = torch.from_numpy(P).float()
    score = default_score_matrix()
    B, C = _emulate_kernel(P32, score, pairwise_del, None, block_size, blocks=True)
    assert B.shape == (n_blocks, 24, 24)
    B_p, C_p = tindep.indep_block_partials_ref(P32.double(), score, pairwise_del,
                                               n_blocks, block_size)
    I, J = torch.triu_indices(24, 24, offset=1)
    rel, _ = chip_smoke.check_values("indep", torch, B[:, I, J],
                                     C[:, I, J] if pairwise_del else None,
                                     *chip_smoke.block_pairs(torch, B_p, C_p))
    assert rel <= chip_smoke.INDEP_RTOL


def test_tf32_split_by_bits():
    """hi is a TF32 value within 2^-11 relative, rounded to nearest with
    ties away from zero; hi + lo is within 2^-22 relative; NaN stays NaN."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = _split_tf32(x)
    for h in (hi, lo):
        assert not bool((h.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert _tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    nan = torch.tensor([float("nan")])
    assert all(bool(torch.isnan(h).all()) for h in _split_tf32(nan))


@pytest.mark.parametrize("N", [1, 64, 65, 1024, 1025])
@pytest.mark.parametrize("S", [0, 15, 1000, 5000, 65536])
def test_split_plan_covers_every_site_once(N, S):
    """The split depends on (N, S) only and puts every site in exactly
    one chunk: chunk c holds [c*chunk_sites, min(S, (c+1)*chunk_sites)),
    no chunk is empty, and a genome shorter than one chunk is one chunk."""
    chunks, chunk_sites = tindep.split_plan(N, S)
    assert (chunks, chunk_sites) == tindep.split_plan(N, S)
    assert chunk_sites % tindep.WINDOW == 0 and chunk_sites >= tindep.WINDOW
    assert 1 <= chunks <= 65535 and chunk_sites <= tindep.MAX_CHUNK_SITES
    covered = np.zeros(S, dtype=int)
    for c in range(chunks):
        lo, hi = c * chunk_sites, min(S, (c + 1) * chunk_sites)
        assert hi > lo or S == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if S <= tindep.MIN_CHUNK_SITES:
        assert chunks == 1


def test_split_plan_fills_the_card_at_the_main_shape():
    """At 1024 x 65,536 the grid holds at least two full waves of an
    H100's 132 SMs, whatever the card: the plan never reads it."""
    chunks, chunk_sites = tindep.split_plan(1024, 65536)
    assert chunks > 1 and chunks * tindep.upper_tiles(1024) >= 2 * 132
    assert tindep.upper_tiles(1024) == 136 and tindep.upper_tiles(1025) == 153
