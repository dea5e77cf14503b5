"""The inbreeding HMM's scans: plain PyTorch versions and the CUDA kernel
(csrc/hmm.cu).

Port of the three `lax.scan`s of ngsdist_tpu/popgen/hmm.py (forward :73,
backward :92, viterbi :130), batched over chains as `jax.vmap` batches
them.  Every function here takes B chains written out:

    q [B, K]  alpha [B]  e [B, S, K] log emissions  d [S] or [B, S]

in one floating type (the wrappers in popgen/hmm.py convert).  The plain
versions `hmm_*_ref` walk the sites in a Python loop with every chain a
row of each tensor; they are the CPU path and the yardstick of the kernel
on the card.  The kernel (csrc/hmm.cu has the design and what bounds it)
takes K = 1..8; a CUDA tensor with more states raises.  It reads e and
writes the messages chain-major, the layout they come in, with no copy.

All three scans on the card are site-segmented: each chain's sites split
into segments of SEGMENT sites, whose K x K transfer matrices (the steps
from each unit log-vector) compose in the log semiring (Viterbi: in
max-plus) into each segment's start vector, from which the segment's
messages (Viterbi: back pointers) are walked; Viterbi's traceback then
runs over every segment at once from the segments' end states, stitched
through each segment's map from its end state to its start state.  That
reassociates the recursion; `hmm_scan_segmented_ref` and
`hmm_viterbi_segmented_ref` are the kernel's order in plain PyTorch (each
add, subtract and multiply a rounded tensor operation of its own, as in
the kernel), which the kernel equals bit for bit on the card, and
`hmm_bound(..., L)` holds them to the sequential plain version.  Up to 2
SEGMENT sites the two orders are the same.  Tensor cores do not apply:
the step is a log-sum-exp or a max of sums, not a sum of products.

Both keep the JAX package's arithmetic: the transition rows as
`transition_matrices` forms them, logsumexp as jax.scipy.special's
(`logsumexp`), argmax taking the first maximal index with NaN maximal.
On the card the kernel rounds each operation once and calls the same exp
and log as PyTorch; `hmm_bound` is the derived bound it is held to
(PERF.md section 2).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .indep import count_launch

MAX_STATES = 8   # csrc/hmm.cu kMaxStates: K is a template argument 1..8
# Sites a segment of the kernel's scans: a constant, never a function of
# the batch, so a chain's bits do not depend on the chains beside it (the
# wrapper's `segment` is for tests alone).
SEGMENT = 1024

# Entry calls since the count was last set to 0: a forward or backward call
# is three kernel launches (transfer matrices, start vectors, messages), a
# Viterbi call five (transfer matrices, start vectors, back pointers,
# stitch, traceback); fewer below three segments.
FORWARD_LAUNCHES = 0
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


def _traceback(v, backs, run=eager):
    """(path [B, S] int32, best score [B]) from the scores v [B, K] after
    the last site and the back pointers [B, S, K]."""
    best, state = argmax_first(v, -1)
    B, S, _ = backs.shape
    path = torch.empty((B, S), dtype=torch.int32, device=backs.device)
    path[:, S - 1] = state
    # site s gives the state at s - 1, for s = S-1 .. 1
    run(_traceback_sites, state, (backs[:, 1:],), (path[:, :-1],), True)
    return path, best


def hmm_viterbi_ref(q, alpha, e, d, full: bool = False, run=eager):
    """Plain version of the Viterbi scan and traceback: (path [B, S]
    int32, best score [B]); full: also the scores V [B, S, K] after each
    site and the back pointers [B, S, K]; run as hmm_forward_ref."""
    logT = transition_matrices(q, alpha, d)
    B, S, K = e.shape
    backs = torch.empty((B, S, K), dtype=torch.int64, device=e.device)
    V = torch.empty_like(e) if full else None
    v = run(_viterbi_sites, torch.log(q), (logT, e), (backs, V) if full else (backs,), False)
    path, best = _traceback(v, backs, run)
    return (path, best, V, backs) if full else (path, best)


def _segments(S: int, L: int, fwd: bool, device):
    """(G, site [G, L], step [G, L] bool): segment g's site at its step i
    (forward gL + i; backward its top site minus i, the top (g+1)L or, for
    the last, S-1) and whether step i is one of the segment's."""
    G = -(-S // L)
    g = torch.arange(G, device=device)[:, None]
    i = torch.arange(L, device=device)[None, :]
    if fwd:
        first = g * L
        n = (S - first).clamp(max=L)
        site = first + i
    else:
        first = torch.where(g == G - 1, torch.full_like(g, S - 1), (g + 1) * L)
        n = first - g * L
        site = first - i
    return G, site.clamp(0, S - 1), i < n


def _walk(step, v, segs, site, act, logT, e, keep=False):
    """v [B, n, K] (or [B, n, K runs, K]) stepped over segments segs [n]
    (sites site[segs], steps act[segs]: _segments); step(v, log T, e)
    returns the next v and what else a step gives.  keep: also each
    step's outputs, stacked [B, n, L, ...]."""
    runs = v.ndim == 4
    kept = []
    for i in range(site.shape[1]):
        s, a = site[segs, i], act[segs, i]
        lt, es = logT[:, s], e[:, s]
        if runs:
            lt, es = lt[:, :, None], es[:, :, None]
        out = step(v, lt, es)
        v = torch.where(a.view(1, -1, *[1] * (v.ndim - 2)), out[0], v)
        if keep:
            kept.append(out)
    return (v, [torch.stack(x, 2) for x in zip(*kept)]) if keep else v


def _starts(fwd: bool, step, compose, v0, logT, e, site, act):
    """Steps 1 and 2 of a segmented scan: each segment's start vector
    [B, G, K], the first (backward: the last) v0.
      1. the steps over each segment but the last (backward: the first)
         from each unit log-vector, the rows of its transfer matrix; the
         first (backward: the last) from v0 instead;
      2. the start vectors in segment order, each the previous one
         composed with a transfer matrix: compose(v [B, K runs, K], 1)."""
    B, _, K = e.shape
    G = site.shape[0]
    starts = torch.empty((B, G, K), dtype=e.dtype, device=e.device)
    starts[:, 0 if fwd else G - 1] = v0
    if G >= 2:
        segs = torch.arange(G - 1, device=e.device) + (0 if fwd else 1)
        unit = torch.full((K, K), -math.inf, dtype=e.dtype, device=e.device)
        unit.fill_diagonal_(0.0)
        v = unit.expand(B, G - 1, K, K).clone()
        vec = 0 if fwd else G - 2
        v[:, vec] = v0[:, None, :]
        mats = _walk(step, v, segs, site, act, logT, e)
        starts[:, 1 if fwd else G - 2] = mats[:, vec, 0]
        order = range(1, G - 1) if fwd else range(G - 2, 0, -1)
        for g in order:
            # v[j] := compose_i(v[i] + m[i][j]), m [B, K runs, K]
            m = mats[:, g] if fwd else mats[:, g - 1]
            starts[:, g + 1 if fwd else g - 1] = compose(starts[:, g, :, None] + m, 1)
    return starts


def hmm_scan_segmented_ref(kind: str, q, alpha, e, d, L: int):
    """The kernel's forward or backward scan (csrc/hmm.cu, steps 1-3) in
    plain PyTorch, vectorised over (chain, segment): (messages [B, S, K],
    loglik [B]), each add, subtract and multiply a rounded tensor
    operation in the kernel's order.  Segments of L sites:
      1. the steps over each segment from each unit log-vector, the rows of
         its transfer matrix (forward's first segment from log q,
         backward's last from 0: the first start vector);
      2. the start vectors in segment order, each the previous one
         composed with a transfer matrix;
      3. the steps over each segment from its start vector.
    With at most two segments it is hmm_forward_ref / hmm_backward_ref."""
    fwd = kind == "forward"
    S = e.shape[1]
    L = min(L, S)
    G, site, act = _segments(S, L, fwd, e.device)
    logT = transition_matrices(q, alpha, d)
    lq = torch.log(q)
    if fwd:
        def step(v, lt, es):
            return (logsumexp(v[..., :, None] + lt, -2) + es,)
    else:
        def step(v, lt, es):
            return (logsumexp(lt + (es + v)[..., None, :], -1),)

    starts = _starts(fwd, step, logsumexp, lq if fwd else torch.zeros_like(lq), logT, e, site,
                     act)
    # step 3
    _, (out,) = _walk(step, starts, torch.arange(G, device=e.device), site, act, logT, e,
                      keep=True)
    msgs = torch.empty_like(e)
    if fwd:
        msgs[:, site[act]] = out[:, act]
        return msgs, logsumexp(msgs[:, -1], -1)
    msgs[:, S - 1] = 0.0
    msgs[:, site[act] - 1] = out[:, act]
    b_start = logsumexp(logT[:, 0] + (e[:, 0] + msgs[:, 0])[:, None, :], 2)
    return msgs, logsumexp(lq + b_start, -1)


def hmm_viterbi_segmented_ref(q, alpha, e, d, L: int, full: bool = False):
    """The kernel's Viterbi (csrc/hmm.cu, steps 1-5) in plain PyTorch,
    vectorised over (chain, segment): (path [B, S] int32, best score [B]);
    full: also the scores V [B, S, K] after each site and the back
    pointers [B, S, K] (int64), as hmm_viterbi_ref gives them.  Segments of
    L sites, forward's:
      1. the max-plus steps over each segment but the last from each unit
         log-vector, the rows of its transfer matrix (the first segment
         from log q: the second's start vector);
      2. the start vectors in segment order, a_{g+1}[j] = max_i(a_g[i] +
         M_g[i][j]), the max as argmax_first takes it;
      3. the steps over each segment from its start vector, with their
         arg maxes, the back pointers; the best score and final state from
         the last segment's scores.
    The path is the sequential traceback over these back pointers, which
    is the kernel's stitched one (steps 4-5) from the same pointers.  With
    at most two segments it is hmm_viterbi_ref."""
    B, S, K = e.shape
    L = min(L, S)
    G, site, act = _segments(S, L, True, e.device)
    logT = transition_matrices(q, alpha, d)

    def step(v, lt, es):
        top, arg = argmax_first(v[..., :, None] + lt, -2)
        return top + es, arg

    starts = _starts(True, step, lambda a, dim: argmax_first(a, dim)[0], torch.log(q), logT, e,
                     site, act)
    # step 3
    _, (out, args) = _walk(step, starts, torch.arange(G, device=e.device), site, act, logT, e,
                           keep=True)
    V = torch.empty_like(e)
    V[:, site[act]] = out[:, act]
    backs = torch.empty((B, S, K), dtype=torch.int64, device=e.device)
    backs[:, site[act]] = args[:, act]
    path, best = _traceback(V[:, -1], backs)
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


def pointer_bytes(K: int) -> int:
    """Bytes of a site's K Viterbi back pointers in the kernel's scratch,
    a nibble each in a word of 1, 2 or 4 bytes (csrc/hmm.cu Ptrs)."""
    return 1 if K <= 2 else (2 if K <= 4 else 4)


def _chains_cuda(kind: str, q, alpha, e, d, segment: int = SEGMENT):
    """One call of csrc/hmm.cu's `kind` entry on e's card (segments of
    `segment` sites; forward and backward three launches, Viterbi five)."""
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
    if segment < 1:
        raise ValueError(f"segments of {segment} sites")
    d_sb = 0 if d.ndim == 1 else S
    fn = _build.entry(f"hmm_{kind}", e)
    ptr, dev = _build.ptr, e.device
    G = -(-S // segment)
    # the transfer matrices [B, G, K, K], then the start vectors [B, G, K]
    scratch = torch.empty((B * G * K * (K + 1),), dtype=e.dtype, device=dev)
    if kind == "viterbi":
        # the back pointers [min(segment, S)][B G], then the maps [B, G, K]
        # and the end states [B, G]
        backs = torch.empty((min(segment, S) * B * G * pointer_bytes(K) + B * G * (K + 1),),
                            dtype=torch.uint8, device=dev)
        path = torch.empty((B, S), dtype=torch.int32, device=dev)
        best = torch.empty((B,), dtype=e.dtype, device=dev)
        with torch.cuda.device(dev):
            rc = fn(ptr(q), ptr(alpha), ptr(e), ptr(d), d_sb, ptr(backs), ptr(path), ptr(best),
                    ptr(scratch), B, S, K, segment, _build.stream(dev))
        out = (path, best)
    else:
        msgs = torch.empty_like(e)
        ll = torch.empty((B,), dtype=e.dtype, device=dev)
        with torch.cuda.device(dev):
            rc = fn(ptr(q), ptr(alpha), ptr(e), ptr(d), d_sb, ptr(msgs), ptr(ll), ptr(scratch),
                    B, S, K, segment, _build.stream(dev))
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


def hmm_bound(kind: str, q, alpha, e, d, X, L=None):
    """Bound on |kernel − plain| for one entry on the same inputs, from the
    plain version's messages X [B, S, K] (Fw, Bw, or Viterbi's scores V):
    (per message [B, S], per loglik or best score [B]), in float64.  L:
    the kernel's segment length (SEGMENT), whose order
    hmm_scan_segmented_ref and hmm_viterbi_segmented_ref are; None: a
    kernel that walks the sites in the plain version's order.

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
    more step.

    Segments (L given).  The exact steps over a segment compose into its
    transfer matrix M_g, and the exact composition of a vector with M_g,
    c(a, M)[j] = lse_i(a[i] + M[i][j]), is 1-Lipschitz in a and in M.  The
    kernel walks segment g from its own start vector a_g, so a message of
    segment g lies within D_g + (the sum of eps over the segment's steps
    that made it) of the plain version's, where D_g bounds the start
    vector's difference from the plain message before the segment.  The
    first segment starts from log q (backward: the last, from 0), D = 0;
    the next start is the sequential walk over it, D_1 = the segment's eps
    sum; then a_{g+1} = c(a_g, M̂_g) rounded, so

        D_{g+1} = D_g + (segment g's eps sum: the plain walk against the
                  exact one) + (the largest eps sum of the K unit-vector
                  runs over segment g: M̂_g against M_g) + (one composing
                  step: 12 u (M_g + M_{g+1} + max |M̂_g| + K + 1)).

    A run's messages are bounded from its own start: each step adds at
    most L_s + E_s + log K to the largest finite magnitude (lse lies
    between its largest term and that plus log K), and those bounds are the
    runs' M in their eps.  Non-finite messages must be equal (checked
    apart); a -inf entry of M̂_g is -inf in M_g as well.

    Viterbi takes forward's branch, in max-plus.  Its step is max_k(v[k] +
    log T[k][l]) + e[l]: max is 1-Lipschitz in the largest-entry norm as
    log-sum-exp is, and its rounding is one add before the max and one
    after, fewer than the tally's exps, logs and shifts.  The steps over a
    segment compose exactly into its max-plus transfer matrix (max is
    associative and + distributes over it), and c(a, M)[j] = max_i(a[i] +
    M[i][j]) is 1-Lipschitz in a and in M; a run's magnitude grows by at
    most L_s + E_s a step, so the log K of the runs' bound only loosens
    it.  So every term above holds with max in place of lse: the scores'
    per-message bound and the best score's.  A path is held apart: where
    it leaves the plain version's, the two candidates' plain scores lie
    within twice the per-message bound (chip_smoke.py viterbi_flips)."""
    u = 2.0 ** -53 if e.dtype == torch.float64 else 2.0 ** -24
    K = e.shape[-1]
    M = finite_abs(X).amax(-1)                                   # [B, S]
    E = finite_abs(e).amax(-1)
    Lt = finite_abs(transition_matrices(q, alpha, d)).flatten(-2).amax(-1)
    stay = torch.exp(-alpha.double()[..., None] * d.double()).expand_as(E)
    R = torch.nan_to_num(stay / (1.0 - stay), nan=0.0, posinf=0.0)
    R = torch.where((stay > 0) & (stay < 1), R, torch.zeros_like(R))
    M0 = finite_abs(torch.log(q)).amax(-1)                        # the start row
    c = 12 * u
    if kind == "backward":
        # site s makes row s - 1 from row s; row S-1 is exact
        eps = c * (M[:, 1:] + M[:, :-1] + E[:, 1:] + Lt[:, 1:] + R[:, 1:] + K + 1)
        if L is None:
            per = torch.cat([eps.flip(1).cumsum(1).flip(1), torch.zeros_like(M[:, :1])], 1)
        else:
            per = _segmented_per(False, eps, M, E, Lt, R, K, c, L)
        # the start row through site 0, then log q plus it
        m_start = M[:, 0] + E[:, 0] + Lt[:, 0] + K
        last = per[:, 0] + c * (M[:, 0] + m_start + E[:, 0] + Lt[:, 0] + R[:, 0] + K + 1)
        return per, last + c * (M0 + m_start + K + 1)
    prev = torch.cat([M0[:, None], M[:, :-1]], 1)
    eps = c * (prev + M + E + Lt + R + K + 1)
    per = eps.cumsum(1) if L is None else _segmented_per(True, eps, M, E, Lt, R, K, c, L)
    return per, per[:, -1] + c * (M[:, -1] + K + 1)


def _segmented_per(fwd: bool, eps, M, E, Lt, R, K: int, c: float, L: int):
    """hmm_bound's per-message bound [B, S] for segments of L sites (its
    docstring).  Forward: eps [B, S] of the step making message s.
    Backward: eps [B, S-1] of site s making row s - 1, indexed by row;
    segment g holds rows [gL, (g+1)L), made by sites (g+1)L .. gL+1."""
    B, S = M.shape
    L = min(L, S)
    G = -(-S // L)

    def seg(x):                 # [B, n <= S] zero-padded -> [B, G, L]
        return torch.nn.functional.pad(x, (0, G * L - x.shape[1])).reshape(B, G, L)

    if fwd:
        has, at = torch.ones_like(M), slice(None)
    else:
        has, at = torch.ones_like(M[:, 1:]), slice(1, None)   # rows with a site: r < S-1
    # forward sums run from a segment's first step on, backward from its top
    run_on = (lambda x: x.cumsum(-1)) if fwd else (lambda x: x.flip(-1).cumsum(-1).flip(-1))
    within = run_on(seg(eps))
    plain = within[..., 0 if not fwd else -1]
    step = seg((Lt[:, at] + E[:, at] + math.log(K)) * has)
    mag = run_on(step)                                   # a run's bound after the step
    run_eps = c * (2 * mag - step + seg(E[:, at] + Lt[:, at] + R[:, at] + K + 1)) * seg(has)
    run = run_eps.sum(-1)
    mag_end = mag[..., -1] if fwd else mag[..., 0]
    # composing at the segments' edges, segments 1 .. G-2: the plain messages
    # before and after the segment
    g = torch.arange(1, max(G - 1, 1), device=M.device)
    edge_a, edge_b = (g * L - 1, (g + 1) * L - 1) if fwd else ((g + 1) * L, g * L)
    comb = c * (M[:, edge_a] + M[:, edge_b] + mag_end[:, g] + K + 1)
    inc = run[:, g] + plain[:, g] + comb                 # [B, G-2]
    D = torch.zeros((B, G), dtype=M.dtype, device=M.device)
    zero = torch.zeros((B, 1), dtype=M.dtype, device=M.device)
    if fwd and G >= 2:
        D[:, 1:] = plain[:, :1] + torch.cat([zero, inc.cumsum(1)], 1)
    elif G >= 2:
        D[:, :-1] = plain[:, -1:] + torch.cat([inc.flip(1).cumsum(1).flip(1), zero], 1)
    per = (within + D[..., None]).reshape(B, G * L)
    return per[:, :S] if fwd else torch.cat([per[:, :S - 1], torch.zeros_like(M[:, :1])], 1)
