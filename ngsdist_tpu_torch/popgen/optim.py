"""Box-constrained quasi-Newton optimization.

Port of ngsdist_tpu/popgen/optim.py.  The reference vendors a 6k-line
Fortran-to-C L-BFGS-B translation (shared/bfgs.cpp, unlinked in
ngsDist; used by sibling ngsTools for likelihood maximization under
bound constraints).  The JAX package's equivalent, kept here step for
step, is a projected L-BFGS (the PQN recipe: two-loop recursion on the
PROJECTED gradient, direction masked on the active set, Armijo
backtracking along the projection arc) with fixed-shape curvature
memory.

Batches: `x0` of shape [n] is one problem, `fun` mapping [n] to a
number; `x0` of shape [B, n] is B independent problems, the JAX
package's `jax.vmap(lbfgsb)` written out, with `fun` mapping [B, n] to
[B] (lane b's value depending on row b only).  The outer loop and the
line search run on the host while any lane is active (one `.item()` a
step); every lane's step is computed and a finished lane keeps its
state, as a vmapped `while_loop` selects, so each lane gives what it
gives alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .freqs import on_device


class LbfgsbResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor


def _fd_value_and_grad(fun: Callable, lo: torch.Tensor, hi: torch.Tensor,
                       batched: bool = False):
    """Numerical value-and-grad via the reference's recipe: Yang central
    differences with per-coordinate step eh = (1e-8*(|x_i|+1))^0.67 and
    a double-step one-sided shift when a probe would cross a bound
    (shared/bfgs.cpp:22-43 Yanggradient), then the active-set zeroing
    getgradient applies to what it hands L-BFGS-B (bfgs.cpp:57-63).  The
    2n probe points go through fun as ONE batched call,
    `torch.func.vmap(fun)` over the probes, so fun only needs to be a
    tensor function vmap accepts, not a differentiable one.  x [n]; with
    batched, x [B, n] and fun [B, n] -> [B]."""

    def vg(x):
        n = x.shape[-1]
        f0 = fun(x)
        eh = (1e-8 * (x.abs() + 1.0)) ** 0.67
        E = torch.eye(n, dtype=x.dtype, device=x.device) * eh[..., :, None]  # row i = eh_i e_i
        lo_hit = (x - eh) < lo  # backward probe would cross the bound
        hi_hit = (x + eh) > hi  # forward probe would cross the bound
        X = x[..., None, :].expand(E.shape)
        # g_i = (f(A_i) - f(B_i)) / (2 eh_i):
        #   interior: A = x+eh e_i, B = x-eh e_i
        #   at lower: A = x+2eh e_i, B = x      (bfgs.cpp:36)
        #   at upper: A = x,        B = x-2eh e_i (bfgs.cpp:38)
        lo_c, hi_c = lo_hit[..., :, None], hi_hit[..., :, None]
        A = torch.where(lo_c, X + 2 * E, torch.where(hi_c, X, X + E))
        B = torch.where(lo_c, X, torch.where(hi_c, X - 2 * E, X - E))
        probes = torch.cat([A, B], dim=-2)                      # [..., 2n, n]
        if batched:
            fp = torch.func.vmap(fun, in_dims=1, out_dims=1)(probes)
        else:
            fp = torch.func.vmap(fun)(probes)
        g = (fp[..., :n] - fp[..., n:]) / (2.0 * eh)
        # active-set projection of the returned gradient (bfgs.cpp:57-63)
        zero = torch.zeros_like(g)
        g = torch.where((x <= lo) & (g > 0), zero, g)
        g = torch.where((x >= hi) & (g < 0), zero, g)
        return f0, g

    return vg


def _autodiff_value_and_grad(fun: Callable):
    """fun's value and its gradient by torch.autograd (fun must be
    differentiable); with a batch of lanes the summed values' gradient is
    each lane's own."""

    def vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fun(xg)
            (g,) = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g

    return vg


def _dot(a, b):
    return (a * b).sum(-1)


def lbfgsb(
    fun: Callable,
    x0,
    lower=None,
    upper=None,
    max_iter: int = 100,
    tol: float = 1e-8,
    memory_size: int = 10,
    max_ls: int = 30,
    grad="autodiff",
) -> LbfgsbResult:
    """Minimize fun(x) subject to lower <= x <= upper.

    Stops when the projected-gradient infinity norm falls below tol or
    after max_iter iterations.

    grad selects the gradient source, mirroring the reference's
    findmax_bfgs dfun argument (shared/bfgs.h:37-38 — "send NULL to use
    numerical derivative"):
      "autodiff" (default): torch.autograd — fun must be differentiable;
      None: Yang central differences (_fd_value_and_grad) — fun only
          needs to be a function torch.func.vmap accepts (a fun it
          refuses raises);
      a callable g(x) -> dfdx: user-supplied analytic gradient.

    x0 [n] or, for B problems at once, [B, n] (module docstring); lower
    and upper broadcast to x0's shape.  The result's fields carry the
    leading B of a batch.
    """
    dev = on_device(x0, lower, upper)
    x0 = torch.as_tensor(x0, device=dev)
    batched = x0.ndim == 2
    dtype = x0.dtype
    n = x0.shape[-1]
    m = memory_size
    lo = (torch.full_like(x0, -torch.inf) if lower is None
          else torch.as_tensor(lower, dtype=dtype, device=dev).broadcast_to(x0.shape))
    hi = (torch.full_like(x0, torch.inf) if upper is None
          else torch.as_tensor(upper, dtype=dtype, device=dev).broadcast_to(x0.shape))
    X0 = x0 if batched else x0[None]
    LO, HI = (lo, hi) if batched else (lo[None], hi[None])
    nb = X0.shape[0]
    eps_active = 1e-12
    c1 = 1e-4

    # fb: the batch's values [nb] at X [nb, n]; vg: values and gradients
    fb = fun if batched else (lambda X: fun(X[0])[None])
    if grad == "autodiff":
        vg1 = _autodiff_value_and_grad(fun)
    elif grad is None:
        vg1 = _fd_value_and_grad(fun, lo, hi, batched)
    else:
        vg1 = lambda x: (fun(x), grad(x))  # noqa: E731
    vg = vg1 if batched else (lambda X: tuple(t[None] for t in vg1(X[0])))

    def project(x):
        return torch.minimum(torch.maximum(x, LO), HI)

    def proj_grad(x, g):
        """Gradient with components pushing OUT of an active bound
        zeroed — the first-order feasible-direction gradient."""
        zero = torch.zeros_like(g)
        pg = torch.where((x <= LO + eps_active) & (g > 0), zero, g)
        return torch.where((x >= HI - eps_active) & (g < 0), zero, pg)

    def pg_norm(x, g):
        return proj_grad(x, g).abs().amax(-1)

    def two_loop(pg, S, Y, rho, gamma):
        """L-BFGS two-loop recursion on the projected gradient."""
        q = pg
        alpha = torch.zeros((nb, m), dtype=dtype, device=dev)
        for i in range(m - 1, -1, -1):
            a = rho[:, i] * _dot(S[:, i], q)
            q = q - torch.where(rho[:, i] != 0.0, a, torch.zeros_like(a))[:, None] * Y[:, i]
            alpha[:, i] = a
        r = gamma[:, None] * q
        for i in range(m):
            b = rho[:, i] * _dot(Y[:, i], r)
            step = torch.where(rho[:, i] != 0.0, alpha[:, i] - b, torch.zeros_like(b))
            r = r + step[:, None] * S[:, i]
        return r

    def keep(mask, new, old):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)

    x = project(X0)
    f, g = vg(x)
    S = torch.zeros((nb, m, n), dtype=dtype, device=dev)   # circular curvature memory
    Y = torch.zeros_like(S)
    rho = torch.zeros((nb, m), dtype=dtype, device=dev)    # 1/(s'y); 0 marks an empty slot
    gamma = torch.ones((nb,), dtype=dtype, device=dev)
    slot = torch.zeros((nb,), dtype=torch.int64, device=dev)
    it = torch.zeros((nb,), dtype=torch.int32, device=dev)
    lanes = torch.arange(nb, device=dev)

    while True:
        active = (it < max_iter) & (pg_norm(x, g) > tol)
        if not bool(active.any()):
            break
        pg = proj_grad(x, g)
        d = -two_loop(pg, S, Y, rho, gamma)
        # keep the direction inside the feasible cone and a descent dir
        zero = torch.zeros_like(d)
        d = torch.where((x <= LO + eps_active) & (d < 0), zero, d)
        d = torch.where((x >= HI - eps_active) & (d > 0), zero, d)
        descent = _dot(d, g)
        bad = descent >= -1e-12 * torch.linalg.vector_norm(d, dim=-1) \
            * torch.linalg.vector_norm(g, dim=-1)
        d = keep(bad, -pg, d)

        # Armijo backtracking along the projection arc:
        #   x(t) = project(x + t d),  accept when
        #   f(x(t)) <= f + c1 * g'(x(t) - x)
        # (the value at the accepted point is recomputed with the
        # gradient below, so only the point is carried)
        k = torch.zeros((nb,), dtype=torch.int32, device=dev)
        t = torch.ones((nb,), dtype=dtype, device=dev)
        xn = project(x + d)
        ok = torch.zeros((nb,), dtype=torch.bool, device=dev)
        while True:
            ls = (k < max_ls) & ~ok & active
            if not bool(ls.any()):
                break
            xp = project(x + t[:, None] * d)
            fp = fb(xp)
            okp = fp <= f + c1 * _dot(g, xp - x)
            # a zero step (fully clipped) can never satisfy strict
            # decrease on flat regions; accept equality then
            okp = okp | (xp == x).all(-1)
            t = torch.where(ls & ~okp, t * 0.5, t)
            xn = keep(ls, xp, xn)
            ok = torch.where(ls, okp, ok)
            k = k + ls.to(torch.int32)
        fn, gn = vg(xn)

        s = xn - x
        y = gn - g
        sy = _dot(s, y)
        good = sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1) \
            * torch.linalg.vector_norm(y, dim=-1)
        put = good & active
        S_new, Y_new, rho_new = S.clone(), Y.clone(), rho.clone()
        S_new[lanes, slot] = s
        Y_new[lanes, slot] = y
        rho_new[lanes, slot] = 1.0 / torch.where(sy != 0, sy, torch.ones_like(sy))
        S, Y, rho = keep(put, S_new, S), keep(put, Y_new, Y), keep(put, rho_new, rho)
        gamma = torch.where(put, sy / _dot(y, y), gamma)
        slot = torch.where(put, (slot + 1) % m, slot)
        x, f, g = keep(active, xn, x), keep(active, fn, f), keep(active, gn, g)
        it = it + active.to(torch.int32)

    res = LbfgsbResult(x=x, fun=f, n_iter=it, converged=pg_norm(x, g) <= tol)
    return res if batched else LbfgsbResult(*(v[0] for v in res))
