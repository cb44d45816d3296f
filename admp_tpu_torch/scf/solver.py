"""Induced-dipole SCF: preconditioned conjugate gradient on the induced-dipole
linear system (admp_tpu/scf/solver.py).

The polarization energy is quadratic in the induced dipoles U, so
field(U) = dE/dU = A U - b defines an SPD system. PCG starts from the
caller's residual r0 = -field(u0) (warm start), applies A through a matvec
callback, and stops when the field residual max |A x - b| over polarizable
sites drops below ``field_tol``.

admp_tpu runs the loop in ``lax.while_loop`` on the device. PyTorch has no
device-side loop, so ``pcg`` is a Python loop that reads the residual norm on
the host once per iteration (one device sync per iteration, plus one for the
starting residual). ``pcg_fixed`` runs a fixed count with no sync.

``ImplicitSolve`` is the exact implicit-function adjoint
(admp_tpu/scf/solver.py:169-250): given the cotangent g of u*, it solves
A w = g and propagates w into r0 and -vjp_theta[A(theta)(u* - u0)](w) into
the parameters theta. Its backward differentiates the matvec once more, so it
needs a twice-differentiable matvec: the plain path, or the pair kernel with
its Hessian-vector backward (ops/cuda/pairs.PairBwdFn).

The backward itself is ``once_differentiable``: differentiating it again (a
force-matching loss on an exact-adjoint polarizable energy) raises. Its
adjoint solve is a host-checked loop whose iterates carry no graph back to
theta, so a third derivative through it would come out incomplete; admp_tpu
refuses it too (reverse mode through its ``lax.while_loop``).

``SCFConfig.method='jacobi'`` replaces PCG by the reference's damped Jacobi
iteration (admp_tpu/scf/solver.py:112-130), host-checked like ``pcg``; it
takes the right-hand side b = -field(0) from the caller. With
``adjoint_warmstart`` (exact adjoint only) the forward also pre-solves the
adjoint system A w = -r_final from a carried ``w_init`` (for an
energy+force call the cotangent of u* is the field at u*, which is the
forward solve's final residual negated), and the backward refines from that
w against the true cotangent to the cold solve's tolerance
(admp_tpu/scf/solver.py:191-245).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from admp_tpu_torch.settings import SCFConfig
from admp_tpu_torch.utils.constants import DIELECTRIC


def _dot(a, b):
    return torch.sum(a * b)


def _safe_ratio(num, den):
    return torch.where(den != 0.0, num / torch.where(den == 0.0,
                                                     torch.ones_like(den), den),
                       torch.zeros_like(den))


def _pcg_step(matvec, precond, x, r, p, rz):
    ap = matvec(p)
    alpha = _safe_ratio(rz, _dot(p, ap))
    x = x + alpha * p
    r = r - alpha * ap
    z = precond(r)
    rz_new = _dot(r, z)
    p = z + _safe_ratio(rz_new, rz) * p
    return x, r, p, rz_new


def pcg(matvec, r0, precond, x0, max_iter, tol_field, site_mask):
    """Preconditioned CG from the residual ``r0 = b - A x0``.

    Returns (x, converged: bool, n_iter: int, final residual)."""
    r = r0
    p = precond(r)
    rz = _dot(r, p)
    x = x0
    it = 0
    resid = float(torch.max(torch.abs(r * site_mask)))  # host sync
    while resid >= tol_field and it < max_iter:
        x, r, p, rz = _pcg_step(matvec, precond, x, r, p, rz)
        it += 1
        resid = float(torch.max(torch.abs(r * site_mask)))  # host sync
    return x, resid < tol_field, it, r


def pcg_fixed(matvec, r0, precond, x0, n_iters, tol_field, site_mask):
    """Exactly ``n_iters`` PCG iterations with no host sync inside the loop;
    convergence is reported from the final residual, not enforced."""
    r = r0
    p = precond(r)
    rz = _dot(r, p)
    x = x0
    for _ in range(n_iters):
        x, r, p, rz = _pcg_step(matvec, precond, x, r, p, rz)
    resid = float(torch.max(torch.abs(r * site_mask)))
    return x, resid < tol_field, n_iters, r


def jacobi(matvec, b, damping, x0, max_iter, tol_field, site_mask):
    """Damped Jacobi x <- x + damping (b - A x) from ``x0``, until the field
    residual over polarizable sites drops below ``tol_field`` or
    ``max_iter`` iterations. Returns (x, converged, n_iter, final
    residual); one host sync per iteration plus one, as ``pcg``."""
    x = x0
    r = b - matvec(x)
    it = 0
    resid = float(torch.max(torch.abs(r * site_mask)))  # host sync
    while resid >= tol_field and it < max_iter:
        x = x + damping * r
        r = b - matvec(x)
        it += 1
        resid = float(torch.max(torch.abs(r * site_mask)))  # host sync
    return x, resid < tol_field, it, r


def preconditioner(pol, config: SCFConfig):
    """(diag, site_mask): the Jacobi preconditioner A_diag^-1 =
    max(pol, 1e-8)/DIELECTRIC (the floor the polarization penalty applies,
    so zero-pol sites keep their true diagonal) and the mask of sites that
    count for convergence."""
    pol = pol.detach()
    site_mask = (pol > config.pol_eps).to(pol.dtype)[:, None]
    diag = (torch.clamp(pol, min=1e-8) / DIELECTRIC)[:, None]
    return diag, site_mask


def solve(matvec, r0, u0, pol, config: SCFConfig, rhs=None):
    """Forward solve A (u - u0) = r0 from the warm start u0; the Jacobi
    method iterates on A u = ``rhs`` (b = -field(0)) from u0 instead.

    Returns (u, converged, n_iter, final residual), all without graph."""
    diag, site_mask = preconditioner(pol, config)
    u0 = u0.detach()
    if config.method == "jacobi":
        return jacobi(matvec, rhs.detach(), diag, u0, config.max_iter,
                      config.field_tol, site_mask)
    precond = lambda r: r * diag  # noqa: E731
    r0 = r0.detach()
    if config.fixed_iters is not None:
        return pcg_fixed(matvec, r0, precond, u0, config.fixed_iters,
                         config.field_tol, site_mask)
    return pcg(matvec, r0, precond, u0, config.max_iter, config.field_tol,
               site_mask)


def adjoint_solve(matvec, diag, g, config: SCFConfig, x0=None):
    """A w = g at a relative tolerance floored at 40 eps of the working dtype
    (an unreachable target would burn the iteration cap on every call);
    from x0 = 0, so r0 = g, or from a warm start ``x0`` at the cost of one
    matvec for r0 = g - A x0. The residual mask is all ones."""
    precond = lambda r: r * diag  # noqa: E731
    eps = torch.finfo(g.dtype).eps
    adj_tol = max(config.adjoint_tol, 40.0 * eps)
    g_scale = max(float(torch.max(torch.abs(g))), 1e-30)
    ones = torch.ones_like(g[..., :1])
    if x0 is None:
        x0, r0 = torch.zeros_like(g), g
    else:
        x0 = x0.detach()
        r0 = g - matvec(x0)
    if config.adjoint_fixed_iters is not None:
        w, _, _, _ = pcg_fixed(matvec, r0, precond, x0,
                               config.adjoint_fixed_iters,
                               adj_tol * g_scale, ones)
    else:
        w, _, _, _ = pcg(matvec, r0, precond, x0, 4 * config.max_iter,
                         adj_tol * g_scale, ones)
    return w


class ImplicitSolve(torch.autograd.Function):
    """u* = u0 + A(theta)^-1 r0 with the exact implicit-function adjoint.

    apply(r0, u0, pol, matvec_fn, config, info, rhs, w_init, *theta) ->
    (u*, w). ``matvec_fn(v, theta, create_graph)`` returns A(theta) v;
    ``rhs`` is b = -field(0) for the Jacobi method (else None); the forward
    writes its diagnostics (converged, n_iter) into the dict ``info``. ``w``
    is the pre-solved adjoint warm start under ``config.adjoint_warmstart``
    (from ``w_init``), else zeros; it is not differentiable."""

    @staticmethod
    def forward(ctx, r0, u0, pol, matvec_fn, config, info, rhs, w_init,
                *theta):
        theta_d = [t.detach() for t in theta]

        def matvec(v):
            return matvec_fn(v, theta_d, False)

        u, conv, n_it, r_final = solve(matvec, r0, u0, pol, config, rhs)
        info.update(converged=conv, n_iter=n_it)
        if config.adjoint_warmstart:
            diag, _ = preconditioner(pol, config)
            w = adjoint_solve(matvec, diag, -r_final.detach(), config,
                              x0=w_init)
        else:
            w = torch.zeros_like(u)
        ctx.mark_non_differentiable(w)
        ctx.save_for_backward(u, u0.detach(), pol.detach(), w, *theta_d)
        ctx.matvec_fn, ctx.config = matvec_fn, config
        return u, w

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_w):
        u_star, u0, pol, w_pre, *theta = ctx.saved_tensors
        config = ctx.config
        diag, _ = preconditioner(pol, config)
        w = adjoint_solve(lambda v: ctx.matvec_fn(v, theta, False), diag,
                          g.detach(), config,
                          x0=w_pre if config.adjoint_warmstart else None)
        delta_u = (u_star - u0).detach()
        with torch.enable_grad():
            theta_r = [t.detach().requires_grad_(t.is_floating_point())
                       for t in theta]
            av = ctx.matvec_fn(delta_u, theta_r, True)
            wanted = [t for t, need in zip(theta_r, ctx.needs_input_grad[8:])
                      if need]
            grads = iter(torch.autograd.grad(av, wanted, grad_outputs=-w,
                                             allow_unused=True)
                         if wanted else ())
        theta_bar = [next(grads) if need else None
                     for need in ctx.needs_input_grad[8:]]
        return (w, None, None, None, None, None, None, None, *theta_bar)


def solve_implicit(r0, u0, pol, matvec_fn, config: SCFConfig, theta,
                   rhs=None, w_init=None):
    """Differentiable forward solve (exact adjoint); returns
    (u*, converged, n_iter, w), ``w`` the next adjoint warm start (zeros
    unless ``config.adjoint_warmstart``; ``w_init`` defaults to zeros)."""
    info = {}
    if w_init is None:
        w_init = torch.zeros_like(u0)
    u, w = ImplicitSolve.apply(r0, u0, pol, matvec_fn, config, info, rhs,
                               w_init.detach(), *theta)
    return u, info["converged"], info["n_iter"], w
