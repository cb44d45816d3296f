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
its Hessian-vector backward (ops/cuda/pairs.PairTableBwdFn).

Its backward is differentiable where admp_tpu's is, with admp_tpu's
semantics (its custom_vjp backward, admp_tpu/scf/solver.py:224-246,
364-388, differentiated by JAX). A force-matching loss on an exact-adjoint
polarizable energy takes that third derivative. It runs when the backward
runs under ``create_graph`` and ``SCFConfig.adjoint_fixed_iters`` is set:
the adjoint solve is ``pcg_fixed`` with its graph kept, w differentiable in
the cotangent g. Its matvec runs at detached theta, as admp_tpu's runs at
stop_gradient(inputs), through ``_FixedOperator``. That operator is the
symmetric A, so its VJP is one more matvec, and the matvec need not keep a
graph to v. theta_bar = -vjp_theta[A(theta)(u* - u0)](w) is built with
``create_graph``. u* - u0 is detached, as admp_tpu's external-r0 solve
stop-gradients it. The classic solve of ``make_induced_dipole_solver``
keeps u*'s graph there (admp_tpu: field_fn(u*, theta)). u* is a saved
output, so its own derivative takes ``ImplicitSolve`` again, as a custom_vjp
residual does, and the forward may stay the host-checked ``pcg``. The
adjoint warm start stays detached (admp_tpu: stop_gradient(x0)). In every
other case the backward builds no graph. A second derivative through the
host-checked adjoint (``adjoint_fixed_iters=None``) raises, as reverse mode
through admp_tpu's ``lax.while_loop`` does.

``SCFConfig.method='jacobi'`` replaces PCG by the reference's damped Jacobi
iteration (admp_tpu/scf/solver.py:112-130), host-checked like ``pcg``; it
takes the right-hand side b = -field(0) from the caller. With
``adjoint_warmstart`` (exact adjoint only) the forward also pre-solves the
adjoint system A w = -r_final from a carried ``w_init`` (for an
energy+force call the cotangent of u* is the field at u*, which is the
forward solve's final residual negated), and the backward refines from that
w against the true cotangent to the cold solve's tolerance
(admp_tpu/scf/solver.py:191-245).

``make_induced_dipole_solver`` is admp_tpu's exported factory over these:
a solver of (field_fn, inputs), its inputs a tensor or a tuple, list or
dict of them, flattened into ``ImplicitSolve``'s theta.
"""

from __future__ import annotations

import dataclasses

import torch

from admp_tpu_torch.settings import SCFConfig
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.constants import DIELECTRIC


def _dot(a, b):
    return torch.sum(a * b)


def _safe_ratio(num, den):
    return torch.where(den != 0.0, num / torch.where(den == 0.0,
                                                     torch.ones_like(den), den),
                       torch.zeros_like(den))


def _residual(r, site_mask):
    """max |r| over the sites that count, read on the host (a sync)."""
    return profiling.host_sync(
        "scf.residual", float, torch.max(torch.abs(r.detach() * site_mask)))


@profiling.traced("scf.iter", composite=True)
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
    resid = _residual(r, site_mask)
    while resid >= tol_field and it < max_iter:
        x, r, p, rz = _pcg_step(matvec, precond, x, r, p, rz)
        it += 1
        resid = _residual(r, site_mask)
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
    resid = _residual(r, site_mask)
    return x, resid < tol_field, n_iters, r


def jacobi(matvec, b, damping, x0, max_iter, tol_field, site_mask):
    """Damped Jacobi x <- x + damping (b - A x) from ``x0``, until the field
    residual over polarizable sites drops below ``tol_field`` or
    ``max_iter`` iterations. Returns (x, converged, n_iter, final
    residual); one host sync per iteration plus one, as ``pcg``."""
    x = x0
    r = b - matvec(x)
    it = 0
    resid = _residual(r, site_mask)
    while resid >= tol_field and it < max_iter:
        x = x + damping * r
        r = b - matvec(x)
        it += 1
        resid = _residual(r, site_mask)
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
    g_scale = max(profiling.host_sync(
        "scf.adjoint_scale", float, torch.max(torch.abs(g.detach()))), 1e-30)
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


class _FixedOperator(torch.autograd.Function):
    """A v at a fixed operator, differentiable in v without a graph through
    the matvec: A is symmetric (the u-Hessian of the energy), so the VJP of
    v -> A v is one more matvec of the cotangent. ``apply(v, matvec)``."""

    @staticmethod
    def forward(ctx, v, matvec):
        ctx.matvec = matvec
        return matvec(v)

    @staticmethod
    def backward(ctx, c):
        return _FixedOperator.apply(c, ctx.matvec), None


class _Refused(torch.autograd.Function):
    """``apply(n, *outputs, *anchors)``: the ``n`` outputs, as they are,
    differentiable through the anchors (the tensors they were computed
    from), and a backward that raises: the outputs of a backward that
    cannot be differentiated again. Taking the anchors as inputs puts this
    node on every path from the outputs to what the anchors depend on, so
    ``torch.autograd.grad`` meets it too, not only ``backward()``."""

    @staticmethod
    def forward(ctx, n, *xs):
        return tuple(x.view_as(x) for x in xs[:n])

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError(
            "a derivative through the exact adjoint's host-checked solve: "
            "set SCFConfig.adjoint_fixed_iters to differentiate its unrolled "
            "adjoint, as admp_tpu's while_loop refuses reverse mode too")


def _refuse_again(grads, anchors):
    """``grads`` with each tensor replaced by a _Refused alias that depends
    on ``anchors``: its derivative raises."""
    at = [k for k, x in enumerate(grads) if x is not None]
    out = _Refused.apply(len(at), *(grads[k] for k in at), *anchors)
    grads = list(grads)
    for k, x in zip(at, out):
        grads[k] = x
    return tuple(grads)


class ImplicitSolve(torch.autograd.Function):
    """u* = u0 + A(theta)^-1 r0 with the exact implicit-function adjoint.

    apply(r0, u0, pol, matvec_fn, config, info, rhs, w_init, du_graph,
    *theta) -> (u*, w). ``matvec_fn(v, theta, create_graph)`` returns
    A(theta) v; ``rhs`` is b = -field(0) for the Jacobi method (else None);
    the forward writes its diagnostics (converged, n_iter) into the dict
    ``info``. ``w`` is the pre-solved adjoint warm start under
    ``config.adjoint_warmstart`` (from ``w_init``), else zeros; it is not
    differentiable. ``du_graph``: a differentiated backward keeps the graph
    of u* - u0 in its theta path (the classic solve) instead of detaching
    it (the external-r0 solve)."""

    @staticmethod
    def forward(ctx, r0, u0, pol, matvec_fn, config, info, rhs, w_init,
                du_graph, *theta):
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
        # theta as given: a differentiated backward builds its theta path
        # on them
        ctx.save_for_backward(u, u0.detach(), pol.detach(), w, *theta)
        ctx.matvec_fn, ctx.config, ctx.du_graph = matvec_fn, config, du_graph
        return u, w

    @staticmethod
    def backward(ctx, g, _g_w):
        u_star, u0, pol, w_pre, *theta = ctx.saved_tensors
        delta_u = u_star - u0
        graph = torch.is_grad_enabled()
        if graph and ctx.config.adjoint_fixed_iters is not None:
            return ImplicitSolve._adjoint(
                ctx, g, delta_u if ctx.du_graph else delta_u.detach(), pol,
                w_pre, theta)
        with torch.no_grad():
            grads = ImplicitSolve._adjoint(ctx, g, delta_u.detach(), pol,
                                           w_pre, theta)
        return _refuse_again(grads, [g, *theta]) if graph else grads

    @staticmethod
    def _adjoint(ctx, g, delta_u, pol, w_pre, theta):
        """(w, None x 8, *theta_bar): w = A^-1 g from the adjoint solve at
        detached theta and theta_bar = -vjp_theta[A(theta) delta_u](w), both
        with the graph grad mode asks for."""
        config, matvec_fn = ctx.config, ctx.matvec_fn
        graph = torch.is_grad_enabled()
        theta_d = [t.detach() for t in theta]

        def matvec(v):
            return matvec_fn(v, theta_d, False)

        diag, _ = preconditioner(pol, config)
        w = adjoint_solve(
            (lambda v: _FixedOperator.apply(v, matvec)) if graph else matvec,
            diag, g, config, x0=w_pre if config.adjoint_warmstart else None)
        needs = ctx.needs_input_grad[9:]
        with torch.enable_grad():
            # an alias of each tensor of theta, so that each gets its own
            # partial derivative; without a graph, detached leaves
            theta_r = [t.view_as(t) if graph else
                       t.detach().requires_grad_(t.is_floating_point())
                       for t in theta]
            av = matvec_fn(delta_u, theta_r, True)
            wanted = [t for t, need in zip(theta_r, needs) if need]
            grads = iter(torch.autograd.grad(av, wanted, grad_outputs=-w,
                                             allow_unused=True,
                                             create_graph=graph)
                         if wanted else ())
        theta_bar = [next(grads) if need else None for need in needs]
        return (w, None, None, None, None, None, None, None, None, *theta_bar)


def solve_implicit(r0, u0, pol, matvec_fn, config: SCFConfig, theta,
                   rhs=None, w_init=None, du_graph=False):
    """Differentiable forward solve (exact adjoint); returns
    (u*, converged, n_iter, w), ``w`` the next adjoint warm start (zeros
    unless ``config.adjoint_warmstart``; ``w_init`` defaults to zeros).
    ``du_graph``: see ``ImplicitSolve``."""
    info = {}
    if w_init is None:
        w_init = torch.zeros_like(u0)
    u, w = ImplicitSolve.apply(r0, u0, pol, matvec_fn, config, info, rhs,
                               w_init.detach(), du_graph, *theta)
    return u, info["converged"], info["n_iter"], w


def _tree_flatten(tree):
    """(tensors, rebuild): the tensors of ``tree`` (a tensor, or a tuple,
    list or dict of them, nested), in order, and ``rebuild(tensors)``, which
    puts a list of that length back into the same structure. Other leaves
    stay as they are. The port's counterpart of a JAX pytree, flattened for
    an autograd Function, which takes flat tensors."""
    if torch.is_tensor(tree):
        return [tree], lambda ts: ts[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_tree_flatten(v) for v in tree]
    else:
        return [], lambda ts: tree
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(ts):
        out, at = [], 0
        for (_, part), n in zip(parts, sizes):
            out.append(part(ts[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):  # a namedtuple
            return type(tree)(*out)
        return type(tree)(out)

    return [t for leaves, _ in parts for t in leaves], rebuild


def make_induced_dipole_solver(field_fn, config: SCFConfig = SCFConfig(),
                               matvec_fn=None, external_r0=False):
    """Build a differentiable SCF solver (admp_tpu/scf/solver.py:251).

    Args:
      field_fn: (u, inputs) -> field, the gradient of the total energy with
        respect to the induced dipoles u (N, 3); linear in u. With grad mode
        on it must keep its graph to ``inputs`` (a field taken with
        ``torch.autograd.grad`` passes ``create_graph=True``).
      config: solver configuration.
      matvec_fn: optional (v, inputs) -> A v, the u-Hessian applied to v;
        by default ``field_fn(v) - field_fn(0)``, with ``field_fn(0)`` taken
        once per solve. Every PCG iteration of the forward solve and of the
        adjoint solve runs it.
      external_r0: the caller supplies the starting residual
        ``r0 = -field(u_init)``, with its graph, instead of the solver
        building it; requires ``matvec_fn``.

    Returns:
      solve(inputs, u_init, pol) -> (u_star, (converged, n_iter)), or with
      ``external_r0``: solve(inputs, u_init, pol, r0, w_init) ->
      (u_star, (converged, n_iter, w)), ``w`` the next adjoint warm start
      (zeros unless ``config.adjoint_warmstart`` with ``exact_adjoint``).
      ``inputs`` is a tensor, or a tuple, list or dict of tensors (nested).

    Gradients: with ``config.exact_adjoint`` u* carries the implicit adjoint
    of ``ImplicitSolve``: theta_bar = -(d field/d theta)^T w, w = A^-1 g.
    Without ``external_r0`` the solver builds r0 = -field(u0) with its graph
    to ``inputs`` itself, so that r0's cotangent w and the matvec's theta
    path together give admp_tpu's -vjp_theta[field(u*)](w) (field is affine
    in u). Under Feynman-Hellmann (``exact_adjoint=False``) u* comes back
    without a graph: the solve adds no gradient, where admp_tpu returns
    zeros. ``u_init``, ``w_init`` and ``pol`` get no gradient from the
    solve. Its gradient is differentiable again, with admp_tpu's semantics,
    where ``config.adjoint_fixed_iters`` is set; with the host-checked
    adjoint a derivative of it raises (``ImplicitSolve``). The matvec is
    taken to be symmetric there, as the u-Hessian of an energy is.
    """
    if external_r0 and matvec_fn is None:
        raise ValueError("external_r0 requires matvec_fn")

    def operator(rebuild):
        """matvec(v, theta, create_graph) over the caller's inputs rebuilt
        from theta, as ``ImplicitSolve`` calls it."""
        field_at_zero = []

        def matvec(v, theta, create_graph):
            inputs = rebuild(list(theta))
            if matvec_fn is not None:
                return matvec_fn(v, inputs)
            if create_graph:  # the backward's theta path: no cached value
                return field_fn(v, inputs) - field_fn(torch.zeros_like(v),
                                                      inputs)
            if not field_at_zero:
                field_at_zero.append(field_fn(torch.zeros_like(v), inputs))
            return field_fn(v, inputs) - field_at_zero[0]

        return matvec

    def run(inputs, u_init, pol, r0=None, w_init=None):
        theta, rebuild = _tree_flatten(inputs)
        theta_d = [t.detach() for t in theta]
        matvec = operator(rebuild)
        u0 = u_init.detach()
        rhs = None
        if config.method == "jacobi":
            with torch.no_grad():
                rhs = -field_fn(torch.zeros_like(u0), rebuild(theta_d))
        if not config.exact_adjoint:
            with torch.no_grad():
                if r0 is None:
                    r0 = -field_fn(u0, rebuild(theta_d))
                u, conv, n_it, _ = solve(
                    lambda v: matvec(v, theta_d, False), r0.detach(), u0,
                    pol, config, rhs)
            return u, conv, n_it, torch.zeros_like(u)
        cfg = config
        if r0 is None:
            r0 = -field_fn(u0, inputs)
            # admp_tpu's classic solve has no carried adjoint
            cfg = dataclasses.replace(config, adjoint_warmstart=False)
        return solve_implicit(r0, u0, pol, matvec, cfg, theta, rhs=rhs,
                              w_init=w_init, du_graph=not external_r0)

    if external_r0:
        def solve_external(inputs, u_init, pol, r0, w_init):
            u, conv, n_it, w = run(inputs, u_init, pol, r0, w_init)
            return u, (conv, n_it, w)

        return solve_external

    def solve_classic(inputs, u_init, pol):
        u, conv, n_it, _ = run(inputs, u_init, pol)
        return u, (conv, n_it)

    return solve_classic
