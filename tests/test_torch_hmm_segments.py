"""The HMM kernel's order on the CPU: segments of sites composed in the
log semiring (forward, backward: ops/hmm.py hmm_scan_segmented_ref) or in
max-plus (Viterbi: hmm_viterbi_segmented_ref), which the kernel equals bit
for bit on the card, against the sequential plain versions
(hmm_forward_ref, hmm_backward_ref, hmm_viterbi_ref) and the JAX
package's scans.

The tolerance is ops/hmm.py hmm_bound(..., L), derived in its docstring
(PERF.md section 2): the sequential bound of each message's own segment
plus the bound on its segment's start vector; Viterbi's scores and best
score within it, and every step where its path leaves the plain
version's a flip between candidates within twice the per-message bound
(chip_smoke.py viterbi_flips).  Non-finite values must be equal.  Up to
two segments the segmented order is the sequential one, so there the bits
are held equal.  The same seeded numpy inputs go through the JAX
functions (x64, tests/conftest.py) and the port.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ngsdist_tpu import popgen as J
from ngsdist_tpu_torch.ops import hmm as hops

KINDS = ("forward", "backward", "viterbi")
EDGES = ("alpha0", "zero_q", "breaks", "ties")
VMAP = {(kind, d_axis): jax.jit(jax.vmap(getattr(J, kind), in_axes=(0, 0, 0, d_axis)))
        for kind in KINDS for d_axis in (None, 0)}


def _inputs(rng, B, S, K, shared_d, dtype, edge=None):
    """Seeded chains: q Dirichlet per chain, alpha in [1e-3, 0.1] (one
    chain 1e-5: stay near 1), log emissions log(U + 1e-3), distances
    1..49 with chromosome breaks (inf) at S/3 and S/2; the edge cases of
    chip_smoke.py HMM_EDGES."""
    q = rng.dirichlet(np.ones(K), size=B)
    alpha = rng.uniform(1e-3, 0.1, B)
    alpha[0] = 1e-5
    e = np.log(rng.random((B, S, K)) + 1e-3)
    d = rng.integers(1, 50, size=S if shared_d else (B, S)).astype(np.float64)
    d[..., [S // 3, S // 2]] = np.inf
    if edge == "alpha0":
        alpha[:] = 0.0                     # -inf off the diagonal; NaN past an inf distance
    elif edge == "zero_q":
        q[:, -1] = 0.0                     # a state never drawn: log q = -inf
        q /= q.sum(-1, keepdims=True)
    elif edge == "breaks":
        d[..., ::7] = np.inf
    elif edge == "ties":
        q[:] = 1.0 / K
        e[:] = e[..., :1]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dtype) for x in (q, alpha, e, d))


def _plain(kind, args):
    """The sequential plain version: (messages, loglik), or Viterbi's
    (path, best, scores V, back pointers)."""
    if kind == "viterbi":
        return hops.hmm_viterbi_ref(*args, full=True)
    return (hops.hmm_forward_ref if kind == "forward" else hops.hmm_backward_ref)(*args)


def _segmented(kind, args, L):
    """The segmented order, its outputs as _plain's."""
    if kind == "viterbi":
        return hops.hmm_viterbi_segmented_ref(*args, L, full=True)
    return hops.hmm_scan_segmented_ref(kind, *args, L)


def _messages(kind, out):
    """The messages of _plain's or _segmented's outputs (Viterbi: V)."""
    return out[2] if kind == "viterbi" else out[0]


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return a.dtype == b.dtype and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _within(got, want, bound):
    """Non-finite values equal, the rest within bound; the largest ratio
    of error to bound."""
    fin = torch.isfinite(want)
    assert _same(got[~fin], want[~fin]), "a non-finite value differs"
    diff = torch.where(fin, (got.double() - want.double()).abs(), torch.zeros_like(want.double()))
    bound = bound.expand_as(diff)
    assert bool((diff <= bound).all()), f"largest error {float(diff.max()):.3e}"
    return float((diff / bound.clamp(min=1e-300)).max()) if diff.numel() else 0.0


def _hold(kind, args, L):
    """The segmented order against the sequential plain version within
    hmm_bound(..., L), a Viterbi path's flips at near ties only; bit for
    bit up to two segments."""
    got = _segmented(kind, args, L)
    want = _plain(kind, args)
    per, last = hops.hmm_bound(kind, *args, _messages(kind, want), L=L)
    _within(_messages(kind, got), _messages(kind, want), per[..., None])
    _within(got[1], want[1], last)
    if kind == "viterbi":
        chip_smoke.viterbi_flips(torch, hops, f"viterbi segments of {L}", args, got[0], want[0],
                                 want[2], want[3], per)
    if -(-args[2].shape[1] // L) <= 2:
        assert len(got) == len(want) and all(_same(a, b) for a, b in zip(got, want))
    return got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("K", [1, 2, 3, 8])
@pytest.mark.parametrize("L", [1, 5, 16, 24, 48], ids=lambda L: f"L{L}")
@pytest.mark.parametrize("shared_d", [True, False], ids=["d_shared", "d_per_chain"])
def test_segments_within_the_bound_of_the_plain_version(kind, dtype, K, L, shared_d):
    """48 sites in segments of 1 (every site its own segment), 5 (a short
    last one), 16, 24 and 48 (two segments, one: the plain version's
    bits), every edge crossed."""
    args = _inputs(np.random.default_rng(100 + K + L), 3, 48, K, shared_d, dtype)
    _hold(kind, args, L)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S,L", [(1, 1), (2, 1), (3, 1), (3, 2), (4, 3), (5, 2)])
def test_segments_of_a_few_sites(kind, S, L):
    """One to five sites in segments of one to three: a last segment of
    one site (backward: of no step), one segment, two, several."""
    args = _inputs(np.random.default_rng(600 + S), 3, S, 2, False, torch.float64)
    _hold(kind, args, L)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("K", [2, 3])
def test_segments_keep_the_edge_inputs_non_finite_pattern(kind, dtype, edge, K):
    """alpha = 0 (NaN from the first inf distance on, in every later
    segment, through the start vectors), a zero proportion (-inf kept),
    dense breaks and exact ties, in segments of 7 over 60 sites: the
    non-finite values the plain version's, the rest within the bound;
    Viterbi's ties path all the first state, as the plain version's."""
    args = _inputs(np.random.default_rng(7), 4, 60, K, K == 3, dtype, edge)
    got = _hold(kind, args, 7)
    X = _messages(kind, got)
    if edge == "alpha0":
        assert bool(torch.isnan(X).any()) and not bool(torch.isnan(X).all())
    if edge == "ties" and kind == "viterbi":
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", [1, 2, 5])
@pytest.mark.parametrize("L", [4, 11])
@pytest.mark.parametrize("shared_d", [True, False], ids=["d_shared", "d_per_chain"])
def test_segments_within_the_bound_of_jax(kind, K, L, shared_d):
    """The segmented order against jax.vmap of the JAX package's forward,
    backward and viterbi (x64), within hmm_bound(..., L) of the plain
    version's messages: the JAX scan is a sequential walk too.  Viterbi:
    the best score within the bound of JAX's, and the path's flips from
    JAX's path near ties under the plain version's scores."""
    args = _inputs(np.random.default_rng(200 + K), 4, 64, K, shared_d, torch.float64)
    got = _segmented(kind, args, L)
    plain = _plain(kind, args)
    want = VMAP[kind, None if shared_d else 0](*(jax.numpy.asarray(a.numpy()) for a in args))
    want = [torch.from_numpy(np.array(w)) for w in want]
    per, last = hops.hmm_bound(kind, *args, _messages(kind, plain), L=L)
    if kind == "viterbi":
        _within(got[1], want[1], last)
        chip_smoke.viterbi_flips(torch, hops, "viterbi against JAX", args, got[0], want[0],
                                 plain[2], plain[3], per)
        return
    _within(got[0], want[0], per[..., None])
    _within(got[1], want[1], last)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_segments_are_batch_invariant(kind, dtype):
    """A chain alone, or among other chains in another order, gives the
    batch's row bit for bit: the segments are a function of the sites
    alone."""
    args = _inputs(np.random.default_rng(300), 6, 50, 3, False, dtype)
    got = _segmented(kind, args, 6)
    perm = torch.tensor([4, 0, 5, 2, 1, 3])
    shuffled = _segmented(kind, [a[perm] for a in args], 6)
    for b in range(6):
        one = _segmented(kind, [a[b:b + 1] for a in args], 6)
        assert all(_same(x[0], y[b]) for x, y in zip(one, got))
    assert all(_same(x, y[perm]) for x, y in zip(shuffled, got))


@pytest.mark.parametrize("kind", KINDS)
def test_one_segment_bound_is_the_sequential_bound(kind):
    """hmm_bound with one segment (L >= S) is the sequential walk's bound."""
    args = _inputs(np.random.default_rng(400), 3, 40, 2, True, torch.float64)
    X = _messages(kind, _plain(kind, args))
    seq = hops.hmm_bound(kind, *args, X)
    for L in (40, 100):
        seg = hops.hmm_bound(kind, *args, X, L=L)
        for a, b in zip(seg, seq):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_segments_bound_grows_with_the_start_vectors(kind):
    """With more segments the bound adds the start vectors' terms: never
    below the sequential bound, and above it where a message's segment
    starts from a composed start vector (three segments or more)."""
    args = _inputs(np.random.default_rng(500), 2, 90, 2, True, torch.float32)
    X = _messages(kind, _plain(kind, args))
    seq, _ = hops.hmm_bound(kind, *args, X)
    seg, _ = hops.hmm_bound(kind, *args, X, L=10)
    assert bool((seg >= seq * (1 - 1e-12)).all())
    composed = slice(0, 70) if kind == "backward" else slice(20, None)
    assert bool((seg[:, composed] > seq[:, composed]).all())
