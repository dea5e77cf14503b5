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


def _emulate_kernel(P32, score, pairwise_del, w, chunk_sites):
    """csrc/indep.cu's sums on [S, N, 3] float32 inputs: per chunk, steps
    of STEP sites (zero filled past the chunk end); raw over k =
    (genotype, site), one k-step of 8 per genotype, hi*hi into one float32
    accumulator and hi*lo, lo*hi into another, both added (in float32)
    into float64 at the end of every WINDOW sites; cnt in float32 over the
    whole chunk, the i side split when weighted.  Chunks add in index
    order in float64."""
    S, N, _ = P32.shape
    step = tindep.STEP
    sc = torch.as_tensor(score, dtype=torch.float32).reshape(9)
    wt = None if w is None else torch.as_tensor(w, dtype=torch.float32)
    zero = torch.zeros(N, N, dtype=torch.float32)
    raw = torch.zeros(N, N, dtype=torch.float64)
    cnt = torch.zeros_like(raw)
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
        raw = raw + r64
        cnt = cnt + cn.double()
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
