"""The inbreeding HMM's scans: plain PyTorch version and the CUDA kernel
(csrc/hmm.cu).

Port of the three `lax.scan`s of ngsdist_tpu/popgen/hmm.py (forward :73,
backward :92, viterbi :130), batched over chains as `jax.vmap` batches
them.  Every function here takes B chains written out:

    q [B, K]  alpha [B]  e [B, S, K] log emissions  d [S] or [B, S]

in one floating type (the wrappers in popgen/hmm.py convert).  The plain
versions walk the sites in a Python loop with every chain a row of each
tensor; they are the CPU path and the yardstick of the kernel on the
card.  The kernel runs one thread per chain (csrc/hmm.cu has the design
and what bounds it) for K = 1..8; a CUDA tensor with more states raises.
It reads e and writes the messages chain-major, the layout they come in,
with no copy (PERF.md section 6 has the one measurement of a site-major
layout against it).

Both keep the JAX package's arithmetic: the transition rows as
`transition_matrices` forms them, logsumexp as jax.scipy.special's
(`logsumexp`), argmax taking the first maximal index with NaN maximal.
On the card the kernel rounds each operation once in the plain version's
order and calls the same exp and log; `hmm_bound` is the derived bound the
two are held to (PERF.md section 2).
"""

from __future__ import annotations

import torch

from . import _build
from .indep import count_launch

MAX_STATES = 8   # csrc/hmm.cu kMaxStates: K is a template argument 1..8

FORWARD_LAUNCHES = 0  # kernel launches since the count was last set to 0
BACKWARD_LAUNCHES = 0
VITERBI_LAUNCHES = 0
FORWARD_LAUNCHES_F64 = 0  # the same three of the float64 entries
BACKWARD_LAUNCHES_F64 = 0
VITERBI_LAUNCHES_F64 = 0


def logsumexp(a: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """jax.scipy.special.logsumexp's arithmetic: the largest entry (NaN
    if any is NaN; 0 where it is not finite, so that all -inf gives
    -inf), the exponentials of the differences added in index order, the
    logarithm of the sum's magnitude plus the largest entry."""
    m = a.amax(dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(a - m)
    s = ex.narrow(dim, 0, 1)
    for k in range(1, a.shape[dim]):
        s = s + ex.narrow(dim, k, 1)
    out = torch.log(s.abs()) + m
    return out if keepdim else out.squeeze(dim)


def argmax_first(x: torch.Tensor, dim: int):
    """(max, argmax) along dim as jnp.max and jnp.argmax give them: the
    first maximal index, a NaN maximal (and the max then NaN)."""
    top = x.select(dim, 0)
    arg = torch.zeros(top.shape, dtype=torch.int64, device=x.device)
    for k in range(1, x.shape[dim]):
        xk = x.select(dim, k)
        take = (top == top) & ((xk > top) | (xk != xk))
        top = torch.where(take, xk, top)
        arg = torch.where(take, torch.full_like(arg, k), arg)
    return top, arg


def transition_matrices(q: torch.Tensor, alpha: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[..., S, K, K] log transition matrices: stay = exp(-alpha d) and
    log((1 - stay) q[l] + stay [k == l]), JAX's products in JAX's order.
    q [..., K], alpha [...], d [..., S] (broadcast against each other)."""
    K = q.shape[-1]
    stay = torch.exp(-alpha[..., None] * d)[..., None, None]
    T = (1.0 - stay) * q[..., None, None, :]
    T = T + stay * torch.eye(K, dtype=q.dtype, device=q.device)
    return torch.log(T)


def _forward_sites(f, ins, outs):
    """The forward steps over a run of sites from the messages f before
    them: ins (log T [B, n, K, K], e [B, n, K]), outs (Fw [B, n, K]).
    Returns the messages after the last site."""
    logT, e = ins
    (Fw,) = outs
    for s in range(e.shape[1]):
        f = logsumexp(f[:, :, None] + logT[:, s], 1) + e[:, s]
        Fw[:, s] = f
    return f


def _backward_sites(b, ins, outs):
    """The backward steps over a run of sites, last site first, from the
    messages b after them: ins (log T, e) of sites j, outs the rows they
    make (row j - 1 of Bw for site j, so the caller passes Bw shifted)."""
    logT, e = ins
    (Bw,) = outs
    for j in range(e.shape[1] - 1, -1, -1):
        b = logsumexp(logT[:, j] + (e[:, j] + b)[:, None, :], 2)
        Bw[:, j] = b
    return b


def _viterbi_sites(v, ins, outs):
    """The Viterbi steps over a run of sites from the scores v before them:
    ins (log T, e), outs (back pointers [B, n, K] int64, and the scores V
    [B, n, K] when kept)."""
    logT, e = ins
    backs, *V = outs
    for s in range(e.shape[1]):
        top, backs[:, s] = argmax_first(v[:, :, None] + logT[:, s], 1)
        v = top + e[:, s]
        if V:
            V[0][:, s] = v
    return v


def _traceback_sites(state, ins, outs):
    """The traceback over a run of sites, last site first, from the state
    after them: ins (back pointers of sites j), outs the path entries they
    give (entry j - 1 for site j, so the caller passes the path shifted)."""
    (backs,) = ins
    (path,) = outs
    for j in range(backs.shape[1] - 1, -1, -1):
        state = backs[:, j].gather(1, state[:, None])[:, 0]
        path[:, j] = state
    return state


def eager(steps, state, ins, outs, reverse):
    """How the plain versions walk the sites by default: one Python loop
    (reverse: the steps walk their run last site first)."""
    return steps(state, ins, outs)


def hmm_forward_ref(q, alpha, e, d, run=eager):
    """Plain version of the forward scan: (Fw [B, S, K], loglik [B]).
    run: how the site loop is driven (`eager`, or `segment_runner`)."""
    logT = transition_matrices(q, alpha, d)
    Fw = torch.empty_like(e)
    f = run(_forward_sites, torch.log(q), (logT, e), (Fw,), False)
    return Fw, logsumexp(f, -1)


def hmm_backward_ref(q, alpha, e, d, run=eager):
    """Plain version of the backward scan: (Bw [B, S, K], the loglik of
    the virtual start row [B]); run as hmm_forward_ref."""
    logT = transition_matrices(q, alpha, d)
    S = e.shape[1]
    Bw = torch.empty_like(e)
    b = torch.zeros_like(e[:, -1])
    Bw[:, S - 1] = b
    # site s makes row s - 1, for s = S-1 .. 1
    run(_backward_sites, b, (logT[:, 1:], e[:, 1:]), (Bw[:, :-1],), True)
    b_start = logsumexp(logT[:, 0] + (e[:, 0] + Bw[:, 0])[:, None, :], 2)
    return Bw, logsumexp(torch.log(q) + b_start, -1)


def hmm_viterbi_ref(q, alpha, e, d, full: bool = False, run=eager):
    """Plain version of the Viterbi scan and traceback: (path [B, S]
    int32, best score [B]); full: also the scores V [B, S, K] after each
    site and the back pointers [B, S, K]; run as hmm_forward_ref."""
    logT = transition_matrices(q, alpha, d)
    B, S, K = e.shape
    backs = torch.empty((B, S, K), dtype=torch.int64, device=e.device)
    V = torch.empty_like(e) if full else None
    v = run(_viterbi_sites, torch.log(q), (logT, e), (backs, V) if full else (backs,), False)
    best, state = argmax_first(v, -1)
    path = torch.empty((B, S), dtype=torch.int32, device=e.device)
    path[:, S - 1] = state
    # site s gives the state at s - 1, for s = S-1 .. 1
    run(_traceback_sites, state, (backs[:, 1:],), (path[:, :-1],), True)
    return (path, best, V, backs) if full else (path, best)


def segment_runner(C: int, graph: bool = True):
    """A `run` for the plain versions that walks the sites in segments of C
    through buffers of its own: each segment's inputs are copied in, one
    replay of a CUDA graph of the steps on C sites runs them, and the
    outputs are copied out; the sites left over run eagerly (after the
    segments, or before them where the steps walk last site first).  The
    graph holds the eager loop's own kernels in its order, so the results
    are the eager loop's bits, without its per-site launches from Python.
    graph=False runs the steps eagerly on the same buffers (the segmenting
    without the graph, for a CPU)."""

    def run(steps, state, ins, outs, reverse):
        n = ins[0].shape[1]
        whole = n // C
        if whole == 0:
            return steps(state, ins, outs)
        st = state.clone()
        sin = [x[:, :C].clone() for x in ins]
        sout = [o[:, :C].clone() for o in outs]

        def body():
            st.copy_(steps(st, sin, sout))

        replay = body
        if graph:
            side = torch.cuda.Stream(st.device)
            side.wait_stream(torch.cuda.current_stream(st.device))
            with torch.cuda.stream(side):
                body()                  # warm-up, as torch.cuda.graph asks
            torch.cuda.current_stream(st.device).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                body()
            replay = g.replay
        st.copy_(state)
        rest = n - whole * C
        starts = [rest + i * C for i in range(whole)][::-1] if reverse else \
            [i * C for i in range(whole)]
        for a in starts:
            for x, buf in zip(ins, sin):
                buf.copy_(x[:, a:a + C])
            replay()
            for o, buf in zip(outs, sout):
                o[:, a:a + C].copy_(buf)
        lo, hi = (0, rest) if reverse else (whole * C, n)
        return steps(st, [x[:, lo:hi] for x in ins], [o[:, lo:hi] for o in outs])

    return run


def check_card(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")


def _chains_cuda(kind: str, q, alpha, e, d):
    """One launch of csrc/hmm.cu's `kind` entry on e's card."""
    check_card(e)
    if e.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected float32 or float64 emissions, got {e.dtype}")
    if e.ndim != 3 or e.shape[0] < 1 or e.shape[1] < 1:
        raise ValueError(f"expected emissions of shape [B, S, K], got {tuple(e.shape)}")
    B, S, K = e.shape
    if not 1 <= K <= MAX_STATES:
        raise ValueError(f"{K} states: the HMM kernel takes 1 to {MAX_STATES} "
                         f"(csrc/hmm.cu kMaxStates)")
    e = e.contiguous()
    q, alpha, d = (t.to(device=e.device, dtype=e.dtype).contiguous() for t in (q, alpha, d))
    if q.shape != (B, K) or alpha.shape != (B,) or d.shape not in ((S,), (B, S)):
        raise ValueError(f"q {tuple(q.shape)}, alpha {tuple(alpha.shape)}, d "
                         f"{tuple(d.shape)} do not fit emissions {tuple(e.shape)}")
    d_sb = 0 if d.ndim == 1 else S
    fn = _build.entry(f"hmm_{kind}", e)
    ptr, dev = _build.ptr, e.device
    if kind == "viterbi":
        backs = torch.empty((S, B, K), dtype=torch.uint8, device=dev)
        path = torch.empty((B, S), dtype=torch.int32, device=dev)
        best = torch.empty((B,), dtype=e.dtype, device=dev)
        with torch.cuda.device(dev):
            rc = fn(ptr(q), ptr(alpha), ptr(e), ptr(d), d_sb, ptr(backs), ptr(path), ptr(best),
                    B, S, K, _build.stream(dev))
        out = (path, best)
    else:
        msgs = torch.empty_like(e)
        ll = torch.empty((B,), dtype=e.dtype, device=dev)
        with torch.cuda.device(dev):
            rc = fn(ptr(q), ptr(alpha), ptr(e), ptr(d), d_sb, ptr(msgs), ptr(ll), B, S, K,
                    _build.stream(dev))
        out = (msgs, ll)
    _build.check_launch(rc, f"hmm {kind}")
    count_launch(globals(), e, f"{kind.upper()}_")
    return out


def hmm_forward(q, alpha, e, d):
    """(Fw [B, S, K], loglik [B]): the plain version for CPU tensors, the
    kernel for CUDA ones (no fallback)."""
    if e.device.type == "cpu":
        return hmm_forward_ref(q, alpha, e, d)
    return _chains_cuda("forward", q, alpha, e, d)


def hmm_backward(q, alpha, e, d):
    """(Bw [B, S, K], loglik [B]), as hmm_forward."""
    if e.device.type == "cpu":
        return hmm_backward_ref(q, alpha, e, d)
    return _chains_cuda("backward", q, alpha, e, d)


def hmm_viterbi(q, alpha, e, d):
    """(path [B, S] int32, best score [B]), as hmm_forward."""
    if e.device.type == "cpu":
        return hmm_viterbi_ref(q, alpha, e, d)
    return _chains_cuda("viterbi", q, alpha, e, d)


def finite_abs(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return torch.where(torch.isfinite(x), x.abs(), torch.zeros_like(x))


def hmm_bound(kind: str, q, alpha, e, d, X):
    """Bound on |kernel − plain| for one entry on the same inputs, from the
    plain version's messages X [B, S, K] (Fw, Bw, or Viterbi's scores V):
    (per message [B, S], per loglik or best score [B]), in float64.

    Each step of either recursion maps the previous messages through a
    1-Lipschitz function (log-sum-exp, or max) of them plus the log
    transition, then adds the emission; so the two versions' difference
    after a step is the previous one plus what that step's roundings can
    add.  With u the unit roundoff of the type, each correctly rounded
    operation within u of its result on either side and exp and log within
    an ulp (2u relative), that is at most

        eps_s = 12 u (M_prev + M_s + E_s + L_s + R_s + K + 1)

    where M are the largest finite |message| before and after the step,
    E_s the largest |e_s|, L_s the largest finite |log T_s| and
    R_s = stay / (1 − stay) (0 where stay is 1 or not finite): 1 − stay
    loses that many digits of stay's error when alpha d is small.  The
    tally: log T 4R + 10 + 4L (in units of u), the message plus log T
    2 (M_prev + L), the shift by the max 4 (M_prev + L), exp, sum and log
    4 + 2 (K − 1) + 4 log K, adding the max back 2 (M_prev + L + K), the
    emission 2 M_s: at most 12 of each term.  The bound on a message is
    the sum of eps over the steps that made it: from the first site
    (forward, Viterbi) or from the last (backward); a loglik adds one
    more step.  Non-finite messages must be equal (checked apart)."""
    u = 2.0 ** -53 if e.dtype == torch.float64 else 2.0 ** -24
    K = e.shape[-1]
    M = finite_abs(X).amax(-1)                                   # [B, S]
    E = finite_abs(e).amax(-1)
    L = finite_abs(transition_matrices(q, alpha, d)).flatten(-2).amax(-1)
    stay = torch.exp(-alpha.double()[..., None] * d.double()).expand_as(E)
    R = torch.nan_to_num(stay / (1.0 - stay), nan=0.0, posinf=0.0)
    R = torch.where((stay > 0) & (stay < 1), R, torch.zeros_like(R))
    M0 = finite_abs(torch.log(q)).amax(-1)                        # the start row
    if kind == "backward":
        # site s makes row s - 1 from row s; row S-1 is exact
        eps = 12 * u * (M[:, 1:] + M[:, :-1] + E[:, 1:] + L[:, 1:] + R[:, 1:] + K + 1)
        per = torch.cat([eps.flip(1).cumsum(1).flip(1), torch.zeros_like(M[:, :1])], 1)
        # the start row through site 0, then log q plus it
        m_start = M[:, 0] + E[:, 0] + L[:, 0] + K
        last = per[:, 0] + 12 * u * (M[:, 0] + m_start + E[:, 0] + L[:, 0] + R[:, 0] + K + 1)
        return per, last + 12 * u * (M0 + m_start + K + 1)
    prev = torch.cat([M0[:, None], M[:, :-1]], 1)
    per = (12 * u * (prev + M + E + L + R + K + 1)).cumsum(1)
    return per, per[:, -1] + 12 * u * (M[:, -1] + K + 1)
