"""The port's popgen toolkit and `read_pos_dist` against the JAX package's.

The same seeded numpy inputs go through `ngsdist_tpu.popgen` (float64:
tests/conftest.py enables x64 on the CPU) and `ngsdist_tpu_torch.popgen`
on CPU tensors, where the HMM's scans take their plain versions
(ops/hmm.py).  Tolerances, each stated at its test: the port keeps the
JAX package's expressions in its order, so what differs is the two
libraries' exp, log and pow (a few ulps) and the order of their
reductions; over the few dozen sites here that stays far below 1e-10.
Viterbi paths, the haplotype EM's iteration counts and used individuals,
and read_pos_dist's values and error texts are held equal.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsdist_tpu import popgen as J
from ngsdist_tpu.io import readers as jreaders
from ngsdist_tpu_torch import popgen as P
from ngsdist_tpu_torch.io import readers as treaders
from ngsdist_tpu_torch.ops import _build
from ngsdist_tpu_torch.ops import hmm as hops

# The JAX functions jitted once, so that cases of one shape share a
# compilation (the values are the same as unjitted: jit changes no step).
JIT = {name: jax.jit(getattr(J, name))
       for name in ("forward", "backward", "posterior_decode", "viterbi")}
VMAP = {(name, d_axis): jax.jit(jax.vmap(getattr(J, name), in_axes=(0, 0, 0, d_axis)))
        for name in JIT for d_axis in (None, 0)}

ATOL = 1e-10   # messages and logliks of the HMM over <= 64 sites, magnitudes < 1e3
ATOL_ELEM = 1e-13   # one closed-form expression (priors, emissions, transitions)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def close(got, want, atol):
    """Equal where non-finite (same inf, both NaN), within atol (a number
    or a per-element bound) elsewhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin], equal_nan=True)
    err = np.abs(got[fin] - want[fin])
    assert (err <= np.broadcast_to(atol, got.shape)[fin]).all(), f"largest error {err.max()}"


def test_exports_match():
    """Every name the JAX package's popgen exports, the port's exports."""
    want = {n for n in dir(J) if not n.startswith("_")}
    assert want <= {n for n in dir(P) if not n.startswith("_")}


# ------------------------------------------------------------------ #
# read_pos_dist                                                       #
# ------------------------------------------------------------------ #

POS_CASES = {
    "one_chr": ([["chr1", "3"], ["chr1", "10"], ["chr1", "11"]], 3),
    "chr_changes": ([["1", "5", "A", "C"], ["1", "9", "A", "G"], ["2", "2", "C", "T"],
                     ["2", "40", "G", "G"], ["3", "7", "T", "A"]], 5),
    "first_pos": ([["c", "1"]], 1),
    "wrong_count": ([["chr1", "3"], ["chr1", "10"]], 3),
    "one_column": ([["chr1"], ["chr1"]], 2),
    "header_first": ([["chr", "pos"], ["chr1", "10"]], 2),
    "header_later": ([["chr1", "10"], ["chr", "pos"]], 2),
    "distance_zero": ([["chr1", "10"], ["chr1", "10"]], 2),
    "distance_below": ([["chr1", "10"], ["chr1", "4"]], 2),
    "empty": ([], 0),
}


@pytest.mark.parametrize("case", sorted(POS_CASES))
def test_read_pos_dist_matches(case, capsys):
    """Values (inf at chromosome changes, the first site's position minus
    0), the error texts and the stderr banner and warning, all equal."""
    rows, n_sites = POS_CASES[case]
    got = []
    for mod in (jreaders, treaders):
        try:
            res = ("ok", mod.read_pos_dist([list(r) for r in rows], n_sites))
        except Exception as ex:  # noqa: BLE001 - the two packages' own error classes
            res = ("error", type(ex).__name__, str(ex), ex.args)
        got.append((res, capsys.readouterr()))
    (jres, jio), (tres, tio) = got
    assert jio == tio
    assert jres[0] == tres[0]
    if jres[0] == "ok":
        assert tres[1].dtype == jres[1].dtype == np.float64
        np.testing.assert_array_equal(tres[1], jres[1])
    else:
        assert tres[1:] == jres[1:]


# ------------------------------------------------------------------ #
# closed forms                                                        #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("F", [0.0, 0.3, 1.0, "per_site"])
def test_calc_hwe_matches(F):
    """Within ATOL_ELEM (one product or two a term); the F == 1 clamp."""
    rng = np.random.default_rng(10)
    maf = rng.random(7)
    Fv = rng.random(7) * (rng.random(7) < 0.7) if F == "per_site" else F
    if F == "per_site":
        Fv[2] = 1.0
    close(P.calc_hwe(t(maf), t(Fv)).numpy(), J.calc_hwe(jnp.asarray(maf), jnp.asarray(Fv)),
          ATOL_ELEM)


@pytest.mark.parametrize("F", [0.0, 1.0, 0.25])
def test_calc_emission_matches(F):
    rng = np.random.default_rng(11)
    gl = np.log(rng.dirichlet(np.ones(3), size=(4, 9)))
    gl[1, 2] = np.log(1 / 3)
    maf = rng.random(9) * 0.5
    close(P.calc_emission(t(gl), t(maf), t(F)).numpy(),
          J.calc_emission(jnp.asarray(gl), jnp.asarray(maf), jnp.asarray(F)), ATOL_ELEM)


def test_calc_emission_two_mafs_matches():
    rng = np.random.default_rng(12)
    gl = np.log(rng.dirichlet(np.ones(3), size=11))
    m1, m2 = rng.random(11), rng.random(11)
    m2[0] = 0.0
    close(P.calc_emission_two_mafs(t(gl), t(m1), t(m2)).numpy(),
          J.calc_emission_two_mafs(jnp.asarray(gl), jnp.asarray(m1), jnp.asarray(m2)),
          ATOL_ELEM)


@pytest.mark.parametrize("F", [0, 1])
def test_joint_geno_prob_and_ld_emission_match(F):
    """joint_geno_prob exactly; calc_emission_ld, batched over two dims,
    within ATOL_ELEM (the einsum's order)."""
    rng = np.random.default_rng(13)
    h = rng.dirichlet(np.ones(4), size=(2, 5))
    gp = np.log(rng.dirichlet(np.ones(3), size=(2, 5)))
    gc = np.log(rng.dirichlet(np.ones(3), size=(2, 5)))
    maf = rng.random((2, 5)) * 0.5
    np.testing.assert_array_equal(P.joint_geno_prob(t(h), F).numpy(),
                                  J.joint_geno_prob(jnp.asarray(h), F))
    close(P.calc_emission_ld(t(h), t(gp), t(gc), t(maf), F).numpy(),
          J.calc_emission_ld(jnp.asarray(h), jnp.asarray(gp), jnp.asarray(gc),
                             jnp.asarray(maf), F), ATOL_ELEM)


@pytest.mark.parametrize("alpha", [0.0, 0.01, 3.0])
def test_transition_matrices_match(alpha):
    """Within ATOL_ELEM; -inf where stay is 1 (alpha = 0), NaN where
    alpha = 0 meets d = inf (0 * inf), as in JAX."""
    q = np.array([0.2, 0.5, 0.3])
    d = np.array([1.0, 7.0, np.inf, 250.0, 0.5])
    close(P.transition_matrices(t(q), t(alpha), t(d)).numpy(),
          J.transition_matrices(jnp.asarray(q), jnp.asarray(alpha), jnp.asarray(d)), ATOL_ELEM)


# ------------------------------------------------------------------ #
# The HMM's scans                                                     #
# ------------------------------------------------------------------ #


def _chain(rng, S, K, case):
    """One chain's (q, alpha, e, d) for an edge case."""
    q = rng.dirichlet(np.ones(K))
    e = np.log(rng.dirichlet(np.ones(3), size=(S, K)).sum(-1) * rng.random((S, K)) + 1e-3)
    d = rng.integers(1, 50, size=S).astype(float)
    alpha = 0.01
    if case in ("breaks", "ties", "alpha0_break"):
        d[[0, S // 3, S // 2]] = np.inf      # chromosome changes, one at the first site
    if case in ("alpha0", "alpha0_break"):
        alpha = 0.0                          # stay = 1: every off-diagonal log T is -inf
    if case == "zero_q":
        q[-1] = 0.0                          # a state never drawn: log q = -inf
        q /= q.sum()
    if case == "ties":
        q = np.full(K, 1.0 / K)              # uniform q and equal emissions: exact ties
        e[:] = e[:, :1]
    return q, alpha, e, d


CASES = ["plain", "breaks", "alpha0", "alpha0_break", "zero_q", "ties"]


def _jax_chain(q, alpha, e, d):
    args = (jnp.asarray(q), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(d))
    return tuple(JIT[name](*args) for name in ("forward", "backward", "posterior_decode",
                                                "viterbi"))


def _port_chain(q, alpha, e, d):
    args = (t(q), t(alpha), t(e), t(d))
    return (P.forward(*args), P.backward(*args), P.posterior_decode(*args), P.viterbi(*args))


def _hold(port, jax_out):
    (fw, ll), (bw, llb), (post, llp), (path, score) = port
    (jfw, jll), (jbw, jllb), (jpost, jllp), (jpath, jscore) = jax_out
    for a, b in ((fw, jfw), (ll, jll), (bw, jbw), (llb, jllb), (post, jpost), (llp, jllp),
                 (score, jscore)):
        close(a.numpy(), b, ATOL)
    assert path.dtype == torch.int32
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))


@pytest.mark.parametrize("K,case", [(K, case) for K in (1, 2, 3) for case in CASES
                                    if not (K == 1 and case == "zero_q")])
def test_chain_matches(K, case):
    """forward, backward, posterior_decode and viterbi of one chain:
    messages and logliks within ATOL (non-finite equal), paths equal.
    (One state has no zero proportion to test.)"""
    rng = np.random.default_rng(20 + K)
    q, alpha, e, d = _chain(rng, 37, K, case)
    _hold(_port_chain(q, alpha, e, d), _jax_chain(q, alpha, e, d))


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("shared_d", [True, False], ids=["d_shared", "d_per_chain"])
def test_batched_chains_match_vmap(K, shared_d):
    """A batch of chains (per-chain q, alpha including 0, distances with
    breaks) against jax.vmap of the JAX functions: within ATOL, paths
    equal; and each chain alone through the port gives the batch's row."""
    rng = np.random.default_rng(30 + K)
    B, S = 5, 29
    q = rng.dirichlet(np.ones(K), size=B)
    q[3, 0] = 0.0
    q[3] /= q[3].sum()
    alpha = np.array([0.01, 0.0, 0.2, 1e-4, 0.05])
    e = np.log(rng.random((B, S, K)) + 1e-3)
    e[4] = e[4, :, :1]                                  # a chain of tied emissions
    d = rng.integers(1, 60, size=S if shared_d else (B, S)).astype(float)
    d[..., [4, 17]] = np.inf
    d_axis = None if shared_d else 0
    jargs = (jnp.asarray(q), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(d))
    want = tuple(VMAP[name, d_axis](*jargs)
                 for name in ("forward", "backward", "posterior_decode", "viterbi"))
    got = _port_chain(q, alpha, e, d)
    _hold(got, want)
    for b in range(B):
        one = _port_chain(q[b], alpha[b], e[b], d if shared_d else d[b])
        for (xb, yb), (x1, y1) in zip(got, one):
            np.testing.assert_array_equal(xb[b].numpy(), x1.numpy())
            np.testing.assert_array_equal(yb[b].numpy(), y1.numpy())


def test_viterbi_ties_take_the_first_state():
    """Uniform q, equal emissions and breaks: every score ties, and both
    packages take state 0 everywhere."""
    rng = np.random.default_rng(40)
    q, alpha, e, d = _chain(rng, 21, 3, "ties")
    path, _ = P.viterbi(t(q), t(alpha), t(e), t(d))
    jpath, _ = J.viterbi(jnp.asarray(q), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(d))
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    assert (path.numpy() == 0).all()


@pytest.mark.parametrize("kind", ["forward", "backward", "viterbi"])
@pytest.mark.parametrize("K", [1, 2, 5])
def test_plain_versions_within_their_bound_of_jax(kind, K):
    """ops/hmm.py hmm_bound, the bound the kernel is held to on the card,
    also holds the plain version against JAX on the CPU (both sides'
    exp and log within an ulp), over 64 sites and 4 chains."""
    rng = np.random.default_rng(50 + K)
    B, S = 4, 64
    q = rng.dirichlet(np.ones(K), size=B)
    alpha = np.array([0.01, 0.3, 1e-3, 0.0])
    e = np.log(rng.random((B, S, K)) + 1e-3)
    d = rng.integers(1, 60, size=S).astype(float)
    d[[9, 40]] = np.inf
    d[-1] = np.inf if kind == "backward" else d[-1]
    tq, ta, te, td = t(q), t(alpha), t(e), t(d)
    jargs = (jnp.asarray(q), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(d))
    if kind == "viterbi":
        path, best, X, _ = hops.hmm_viterbi_ref(tq, ta, te, td, full=True)
        jpath, jbest = VMAP["viterbi", None](*jargs)
        np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
        per, last = hops.hmm_bound(kind, tq, ta, te, td, X)
        close(best.numpy(), jbest, last.numpy())
        return
    fn = hops.hmm_forward_ref if kind == "forward" else hops.hmm_backward_ref
    X, ll = fn(tq, ta, te, td)
    jX, jll = VMAP[kind, None](*jargs)
    per, last = hops.hmm_bound(kind, tq, ta, te, td, X)
    close(X.numpy(), jX, per.numpy()[..., None])
    close(ll.numpy(), jll, last.numpy())


@pytest.mark.parametrize("kind", ["forward", "backward", "viterbi"])
@pytest.mark.parametrize("S,C", [(23, 5), (20, 5), (4, 5), (1, 5), (5, 5)],
                         ids=["rest", "whole", "short", "one_site", "one_segment"])
def test_segmented_plain_versions_are_the_eager_loop(kind, S, C):
    """ops/hmm.py segment_runner without its graph (the segments, buffers
    and copies; on the card each segment is a CUDA graph's replay):
    every output the eager loop's bits, with sites left over after the
    segments (forward) or before them (backward, traceback), none, all,
    one site alone, and NaN and -inf messages (alpha 0 past a break, a
    zero proportion)."""
    rng = np.random.default_rng(60 + S)
    B, K = 4, 3
    q = rng.dirichlet(np.ones(K), size=B)
    q[2, 1] = 0.0
    q[2] /= q[2].sum()
    alpha = np.array([0.01, 0.0, 0.2, 1e-3])
    e = np.log(rng.random((B, S, K)) + 1e-3)
    d = rng.integers(1, 60, size=S).astype(float)
    d[S // 2] = np.inf
    args = (t(q), t(alpha), t(e), t(d))
    run = hops.segment_runner(C, graph=False)
    if kind == "viterbi":
        want = hops.hmm_viterbi_ref(*args, full=True)
        got = hops.hmm_viterbi_ref(*args, full=True, run=run)
    else:
        fn = hops.hmm_forward_ref if kind == "forward" else hops.hmm_backward_ref
        want, got = fn(*args), fn(*args, run=run)
    if S > 1:
        assert np.isnan(want[2 if kind == "viterbi" else 0].numpy()).any()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------------ #
# The frequency EMs                                                   #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("use_indF", [False, True], ids=["no_indF", "indF"])
@pytest.mark.parametrize("ignore_miss", [True, False], ids=["skip_missing", "keep_missing"])
def test_est_maf_sites_matches(use_indF, ignore_miss):
    """Per-site MAFs within 1e-12 (the lanes stop at the same step: the
    sums over individuals differ in their last bits only)."""
    rng = np.random.default_rng(60)
    S, N = 13, 17
    GL = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    GL[rng.random((S, N)) < 0.15] = np.log(1 / 3)       # missing individuals
    GL[4] = np.log(1 / 3)                                # a site with no data
    indF = rng.random(N) * 0.6 if use_indF else None
    indF_t = None if indF is None else t(indF)
    got = P.est_maf_sites(t(GL), indF_t, ignore_miss)
    want = J.est_maf_sites(jnp.asarray(GL), None if indF is None else jnp.asarray(indF),
                           ignore_miss)
    close(got.numpy(), want, 1e-12)
    one = P.est_maf(t(GL[2]), indF_t, ignore_miss)
    close(one.numpy(), J.est_maf(jnp.asarray(GL[2]), None if indF is None
                                 else jnp.asarray(indF), ignore_miss), 1e-12)


def test_est_maf_iters_counts_the_loop():
    """_est_maf_iters: the MAFs of est_maf_sites and at most ITER_MAX + 1
    loop bodies."""
    rng = np.random.default_rng(61)
    GL = t(np.log(rng.dirichlet(np.ones(3), size=(6, 9))))
    freq, iters = P.freqs._est_maf_iters(GL)
    np.testing.assert_array_equal(freq.numpy(), P.est_maf_sites(GL).numpy())
    assert 1 <= iters <= P.freqs.ITER_MAX + 1


@pytest.mark.parametrize("batch", [(), (6,), (2, 3)], ids=["one", "b6", "b2x3"])
@pytest.mark.parametrize("ignore_miss", [True, False], ids=["skip_missing", "keep_missing"])
def test_haplo_freq_matches(batch, ignore_miss):
    """Haplotype frequencies within 1e-12; n_iter (with its final fix-up)
    and the used individuals x equal."""
    rng = np.random.default_rng(70 + len(batch))
    N = 19
    g1 = rng.dirichlet(np.ones(3), size=batch + (N,))
    g2 = rng.dirichlet(np.ones(3), size=batch + (N,))
    g1[..., 2, :] = 1 / 3
    g2[..., 5, :] = 1 / 3
    maf1 = rng.random(batch) * 0.5
    maf2 = 0.3
    f, n_iter, x = P.haplo_freq(t(g1), t(g2), t(maf1), maf2, ignore_miss)
    jf, jn, jx = J.haplo_freq(jnp.asarray(g1), jnp.asarray(g2), jnp.asarray(maf1), maf2,
                              ignore_miss)
    close(f.numpy(), jf, 1e-12)
    assert n_iter.dtype == torch.int32
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


# ------------------------------------------------------------------ #
# lbfgsb                                                              #
# ------------------------------------------------------------------ #


def _problems(xp):
    """Bounded problems of tests/test_popgen.py's oracle suite, written
    once for jax.numpy and torch: (fun, analytic gradient, x0, lo, hi)."""
    out = []
    rng = np.random.default_rng(1)
    n = 6
    Qm = rng.normal(size=(n, n))
    A = Qm @ Qm.T + 0.1 * np.eye(n)
    b = rng.normal(size=n)
    xstar = np.linalg.solve(A, b)
    lo, hi = xstar - 0.5, xstar + 0.5
    hi[:3] = xstar[:3] - 0.2
    lo = np.minimum(lo, hi - 0.1)
    Ax, bx = xp.asarray(A), xp.asarray(b)
    out.append((lambda x: 0.5 * x @ (Ax @ x) - bx @ x, lambda x: Ax @ x - bx,
                np.zeros(n), lo, hi))
    dd = np.logspace(0, 3, 5)
    dx = xp.asarray(dd)
    out.append((lambda x: 0.5 * (dx * x * x).sum() - x.sum(), lambda x: dx * x - 1.0,
                np.ones(5), np.full(5, -2.0), np.full(5, 0.5)))
    out.append((lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
                lambda x: xp.stack([-2 * (1 - x[0]) - 400 * x[0] * (x[1] - x[0] ** 2),
                                    200 * (x[1] - x[0] ** 2)]),
                np.array([-1.0, 1.0]), np.array([-2.0, -2.0]), np.array([0.5, 0.8])))
    w = xp.asarray(np.array([1.0, 2.0, 3.0]))
    out.append((lambda x: (xp.exp(x) - x * w).sum(), lambda x: xp.exp(x) - w,
                np.zeros(3), np.full(3, 0.2), np.full(3, 10.0)))
    out.append((lambda x: ((x - 2.0) ** 4).sum(), lambda x: 4 * (x - 2.0) ** 3,
                np.zeros(4), np.full(4, -1.0), np.full(4, 1.0)))
    return out


GRADS = ["autodiff", "numerical", "analytic"]


def _grad_arg(mode, g):
    return {"autodiff": "autodiff", "numerical": None, "analytic": g}[mode]


@pytest.mark.parametrize("grad", GRADS)
@pytest.mark.parametrize("k", range(5))
def test_lbfgsb_matches_jax(grad, k):
    """One bounded problem in each gradient mode.  The first four
    iterations step for step: x and the value within 1e-10 of the JAX
    package's (the same steps in the same order; autograd, pow and the
    dot products round differently, finite differences amplify that).
    Run to the end: near the optimum the last digits decide whether a line
    search still finds a decrease, so the two stop at other points of the
    same flat bottom: the value within 1e-9, x within 1e-4 (the JAX
    package's own oracle test holds x to scipy's within 2e-4)."""
    fj, gj, x0, lo, hi = _problems(jnp)[k]
    ft, gt, *_ = _problems(torch)[k]
    # one compilation for both runs: max_iter and tol are traced
    jrun = jax.jit(lambda x0, lo, hi, max_iter, tol: J.lbfgsb(
        fj, x0, lower=lo, upper=hi, grad=_grad_arg(grad, gj), max_iter=max_iter, tol=tol))
    for max_iter, tol, atol_x, atol_f in ((4, 0.0, 1e-10, 1e-10), (300, 1e-7, 1e-4, 1e-9)):
        res = P.lbfgsb(ft, t(x0), lower=t(lo), upper=t(hi), grad=_grad_arg(grad, gt),
                       max_iter=max_iter, tol=tol)
        jres = jrun(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi), max_iter, tol)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=atol_x)
        np.testing.assert_allclose(float(res.fun), float(jres.fun), rtol=0, atol=atol_f)


def _quartic(xp, c):
    """tests/test_popgen.py's vmapped problem: lane b minimizes
    |x - c_b|^2 + 0.1 |x|_4^4 in [-0.5, 0.5]^n."""
    return (lambda x: ((x - c) ** 2).sum(-1) + 0.1 * (x ** 4).sum(-1),
            lambda x: 2 * (x - c) + 0.4 * x ** 3)


@pytest.mark.parametrize("grad", GRADS)
def test_lbfgsb_batch_matches_vmap_and_single_lanes(grad):
    """x0 [B, n]: each lane within 1e-8 of jax.vmap(lbfgsb) and equal,
    to 1e-12, to the port's own run of that lane alone."""
    rng = np.random.default_rng(5)
    B, n = 16, 4
    centers = rng.normal(size=(B, n))
    centers[3] = 0.1                                    # an interior optimum
    kw = dict(lower=np.full(n, -0.5), upper=np.full(n, 0.5), max_iter=100, tol=1e-9)
    f, g = _quartic(torch, t(centers))
    res = P.lbfgsb(f, torch.zeros((B, n), dtype=torch.float64), grad=_grad_arg(grad, g),
                   **{k: (t(v) if k in ("lower", "upper") else v) for k, v in kw.items()})
    assert res.x.shape == (B, n) and res.n_iter.shape == (B,)

    def solve_one(c):
        fj, gj = _quartic(jnp, c)
        return J.lbfgsb(fj, jnp.zeros(n, jnp.float64), grad=_grad_arg(grad, gj),
                        **{k: (jnp.asarray(v) if k in ("lower", "upper") else v)
                           for k, v in kw.items()})

    jres = jax.vmap(solve_one)(jnp.asarray(centers))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(jres.fun), rtol=0, atol=1e-10)
    for b in (0, 3, 11):
        fb, gb = _quartic(torch, t(centers[b]))
        one = P.lbfgsb(fb, torch.zeros(n, dtype=torch.float64), grad=_grad_arg(grad, gb),
                       **{k: (t(v) if k in ("lower", "upper") else v) for k, v in kw.items()})
        np.testing.assert_allclose(res.x[b].numpy(), one.x.numpy(), rtol=0, atol=1e-12)
        assert int(res.n_iter[b]) == int(one.n_iter)


def test_lbfgsb_numerical_gradient_one_sided_at_bounds():
    """tests/test_popgen.py's objective undefined outside the box: the FD
    probes never cross a bound, and both packages reach the corner."""

    def make(xp):
        def f(x):
            safe = ((x >= 0.0) & (x <= 1.0)).all()
            v = (xp.sqrt(xp.clip(x, 0.0)) * xp.asarray(np.array([-1.0, -2.0]))).sum()
            return xp.where(safe, v, xp.asarray(np.nan))
        return f

    res = P.lbfgsb(make(torch), t([0.0, 1.0]), lower=t([0.0, 0.0]), upper=t([1.0, 1.0]),
                   max_iter=200, tol=1e-8, grad=None)
    jres = J.lbfgsb(make(jnp), jnp.asarray([0.0, 1.0]), lower=jnp.zeros(2),
                    upper=jnp.ones(2), max_iter=200, tol=1e-8, grad=None)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-6)


def test_lbfgsb_numerical_gradient_needs_a_vmappable_fun():
    """grad=None sends the probes through torch.func.vmap(fun): a fun it
    refuses (a data-dependent .item()) raises."""

    def f(x):
        return x.sum() * float((x ** 2).sum().item())

    with pytest.raises(RuntimeError):
        P.lbfgsb(f, t([0.3, 0.2]), lower=t([0.0, 0.0]), upper=t([1.0, 1.0]), grad=None)


def test_lbfgsb_autodiff_needs_a_differentiable_fun():
    with pytest.raises(RuntimeError):
        P.lbfgsb(lambda x: (x ** 2).sum().detach(), t([0.3, 0.2]))


# ------------------------------------------------------------------ #
# Devices and the kernel's wrapper                                    #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("call", ["calc_hwe", "forward", "est_maf_sites", "lbfgsb"])
def test_no_tensor_argument_goes_to_the_card(call, monkeypatch):
    """Arguments with no tensor among them go to the card, as JAX puts
    host arrays on its default device; without one that raises, and
    nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.zeros((4, 2))
    fn = {"calc_hwe": lambda: P.calc_hwe(np.array([0.2]), 0.5),
          "forward": lambda: P.forward(np.array([0.5, 0.5]), 0.1, e, np.ones(4)),
          "est_maf_sites": lambda: P.est_maf_sites(np.zeros((3, 2, 3))),
          "lbfgsb": lambda: P.lbfgsb(lambda x: (x ** 2).sum(), np.zeros(2))}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


class _Lib:
    """A stand-in for the kernel library that records the entries called
    and their arguments and returns `rc`."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if name == "ngsd_error_string":
            return lambda rc: b"stand-in failure"
        if not name.startswith("ngsd_hmm_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or self.rc


@contextlib.contextmanager
def _library(monkeypatch, rc=0):
    """The HMM wrapper's CUDA path on CPU tensors against a _Lib: the
    device check, the device context and the stream are the only parts
    taken out; the plain versions raise if anything calls them."""
    lib = _Lib(rc)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(hops, "check_card", lambda e: None)
    monkeypatch.setattr(_build, "stream", lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for name in ("hmm_forward_ref", "hmm_backward_ref", "hmm_viterbi_ref"):
        monkeypatch.setattr(hops, name, lambda *a, **k: pytest.fail("the plain version ran"))
    yield lib


def _args(B, S, K, dtype, shared_d=True):
    rng = np.random.default_rng(80)
    q = torch.from_numpy(rng.dirichlet(np.ones(K), size=B)).to(dtype)
    return (q, torch.full((B,), 0.01, dtype=dtype),
            torch.from_numpy(rng.random((B, S, K))).to(dtype),
            torch.ones(S if shared_d else (B, S), dtype=dtype))


@pytest.mark.parametrize("kind", ["forward", "backward", "viterbi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("shared_d", [True, False], ids=["d_shared", "d_per_chain"])
def test_wrapper_launches_the_kernel_entry(kind, dtype, K, shared_d, monkeypatch):
    """A CUDA-device call hands e's own (chain-major) storage and the
    distances' chain stride (0 when shared) to the entry of its dtype, with
    the arguments `_build._configure` declares for it (each a scratch and
    the segment length ops/hmm.py SEGMENT; Viterbi also its byte scratch),
    counts one launch of that entry, and never runs the plain version."""
    B, S = 3, 5
    q, a, e, d = _args(B, S, K, dtype, shared_d)
    suffix = "_F64" if dtype == torch.float64 else ""
    counter = f"{kind.upper()}_LAUNCHES{suffix}"
    before = getattr(hops, counter)
    with _library(monkeypatch) as lib:
        got = hops._chains_cuda(kind, q, a, e, d)
    assert getattr(hops, counter) == before + 1
    (name, args), = lib.calls
    assert name == f"ngsd_hmm_{kind}_{'f64' if dtype == torch.float64 else 'f32'}"
    assert len(args) == (14 if kind == "viterbi" else 13)
    assert args[2].value == e.data_ptr()
    assert args[4] == (0 if shared_d else S)
    assert args[-5:-2] == (B, S, K) and args[-2] == hops.SEGMENT
    if kind == "viterbi":
        path, best = got
        assert path.shape == (B, S) and path.dtype == torch.int32 and best.dtype == dtype
    else:
        msgs, ll = got
        assert msgs.shape == (B, S, K) and msgs.dtype == dtype and ll.shape == (B,)


@pytest.mark.parametrize("kind", ["forward", "backward"])
@pytest.mark.parametrize("segment,G", [(4, 3), (3, 3), (9, 1), (100, 1), (1, 9)])
def test_wrapper_passes_the_segment_and_its_scratch(kind, segment, G, monkeypatch):
    """forward and backward take the segment length and a scratch of B G
    K (K + 1) elements of e's dtype (the transfer matrices, then the start
    vectors), G = ceil(S / segment); a segment below one site raises
    before any launch."""
    B, S, K = 2, 9, 3
    q, a, e, d = _args(B, S, K, torch.float32)
    scratch, real_ptr = {}, _build.ptr

    def ptr(x):
        scratch.setdefault(x.numel(), x)
        return real_ptr(x)

    monkeypatch.setattr(_build, "ptr", ptr)
    with _library(monkeypatch) as lib:
        hops._chains_cuda(kind, q, a, e, d, segment=segment)
        with pytest.raises(ValueError, match="segments of 0 sites"):
            hops._chains_cuda(kind, q, a, e, d, segment=0)
    (name, args), = lib.calls
    assert args[-2] == segment
    assert args[7].value == scratch[B * G * K * (K + 1)].data_ptr()
    assert scratch[B * G * K * (K + 1)].dtype == torch.float32


@pytest.mark.parametrize("segment,K", [(4, 2), (3, 3), (9, 4), (100, 5), (1, 8), (2, 1)])
def test_wrapper_passes_viterbi_its_segment_and_scratches(segment, K, monkeypatch):
    """Viterbi takes the segment length, a scratch of B G K (K + 1)
    elements of e's dtype (the transfer matrices, then the start vectors)
    and a uint8 scratch of L' B G P + B G (K + 1) bytes (the back pointers
    [L'][B G], a nibble a state in words of P = 1, 2 or 4 bytes for K <= 2,
    4, 8; the maps; the end states), G = ceil(S / segment), L' =
    min(segment, S); a segment below one site raises before any launch."""
    B, S = 2, 9
    G, Lp = -(-S // segment), min(segment, S)
    P = 1 if K <= 2 else (2 if K <= 4 else 4)
    assert hops.pointer_bytes(K) == P
    q, a, e, d = _args(B, S, K, torch.float64)
    seen, real_ptr = {}, _build.ptr

    def ptr(x):
        seen.setdefault(x.data_ptr(), x)
        return real_ptr(x)

    monkeypatch.setattr(_build, "ptr", ptr)
    with _library(monkeypatch) as lib:
        hops._chains_cuda("viterbi", q, a, e, d, segment=segment)
        with pytest.raises(ValueError, match="segments of 0 sites"):
            hops._chains_cuda("viterbi", q, a, e, d, segment=0)
    (name, args), = lib.calls
    assert name == "ngsd_hmm_viterbi_f64" and args[-2] == segment
    backs, path, best, scratch = (seen[x.value] for x in args[5:9])
    assert backs.dtype == torch.uint8 and backs.numel() == Lp * B * G * P + B * G * (K + 1)
    assert scratch.dtype == torch.float64 and scratch.numel() == B * G * K * (K + 1)
    assert path.shape == (B, S) and path.dtype == torch.int32 and best.shape == (B,)


@pytest.mark.parametrize("kind", ["forward", "backward", "viterbi"])
@pytest.mark.parametrize("K", [9, 12])
def test_wrapper_refuses_more_than_eight_states(kind, K, monkeypatch):
    """K > 8 raises before any launch: no entry called, no count, no
    plain version."""
    q, a, e, d = _args(2, 4, K, torch.float64)
    with _library(monkeypatch) as lib:
        with pytest.raises(ValueError, match="1 to 8"):
            hops._chains_cuda(kind, q, a, e, d)
    assert lib.calls == []


@pytest.mark.parametrize("kind", ["forward", "backward", "viterbi"])
def test_wrapper_failed_launch_raises(kind, monkeypatch):
    q, a, e, d = _args(2, 4, 2, torch.float32)
    with _library(monkeypatch, rc=1):
        with pytest.raises(RuntimeError, match="stand-in failure"):
            hops._chains_cuda(kind, q, a, e, d)


@pytest.mark.parametrize("kind", ["forward", "backward", "viterbi"])
def test_non_cpu_tensor_never_takes_the_plain_version(kind, monkeypatch):
    """The dispatch sends every tensor not on the CPU to the kernel's
    wrapper, which raises for one that is not on a card (a meta tensor
    here): there is no fallback to the plain version."""
    for name in ("hmm_forward_ref", "hmm_backward_ref", "hmm_viterbi_ref"):
        monkeypatch.setattr(hops, name, lambda *a, **k: pytest.fail("the plain version ran"))
    q, a, e, d = (x.to("meta") for x in _args(2, 4, 2, torch.float64))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        getattr(hops, f"hmm_{kind}")(q, a, e, d)
