"""Force-field parameter optimization loops (admp_tpu/fitting.py, on
torch.optim).

Parameters are a dict of tensors. ``fit`` takes (loss, parameter) steps with
a ``torch.optim`` optimizer, records each step's loss and time, and saves and
resumes (params, optimizer state) through checkpoint.py. Force-matching
losses differentiate the potential's position gradient again
(``create_graph=True``): on the CUDA kernels that runs the pair kernel's
Hessian-vector kernel (ops/cuda/pairs.PairTableBwdFn). On a polarizable
potential with the exact adjoint that takes the solve's backward's
backward, which runs where ``SCFConfig.adjoint_fixed_iters`` is set, as in
admp_tpu (scf/solver.ImplicitSolve), and on the kernels the pair energies'
third derivative (K3b, ops/cuda/pairs.PairHvpFn).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from admp_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from admp_tpu_torch.utils import profiling


@dataclasses.dataclass
class FitResult:
    params: dict
    history: list
    steps: int


def _tensor(x):
    """A tensor as it is; anything else through numpy, so that a Python
    float stays float64 (torch.as_tensor would make it float32)."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def stack_batch(entries):
    """Stack same-shape (positions, box, pairs, target_energy, target_forces)
    entries into one tuple of tensors with a leading configuration axis, the
    form ``energy_force_loss`` takes."""
    return tuple(torch.stack([_tensor(e[i]) for e in entries])
                 for i in range(5))


def energy_force_loss(potential_fn, energy_weight=1.0, force_weight=0.1):
    """Energy+force matching loss for a differentiable potential.

    potential_fn(positions, box, pairs, params) -> scalar energy.

    ``batch`` is either a stacked tuple with a leading configuration axis —
    (positions (B,N,3), box (B,3,3), pairs (B,P,2), target_energy (B,),
    target_forces (B,N,3)), see ``stack_batch`` — or a list of
    per-configuration entry tuples. PyTorch runs eagerly, so both forms
    evaluate the potential once per configuration; the loss is the mean over
    configurations of energy_weight (E - E_ref)^2 + force_weight
    mean((F - F_ref)^2).
    """

    def one(params, positions, box, pairs, e_ref, f_ref):
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            energy = potential_fn(pos, box, pairs, params)
            (de_dpos,) = torch.autograd.grad(energy, pos, create_graph=True)
        e_term = (energy - e_ref) ** 2
        f_term = torch.mean((-de_dpos - f_ref) ** 2)
        return energy_weight * e_term + force_weight * f_term

    def loss(params, batch):
        if isinstance(batch, tuple) and hasattr(batch[0], "ndim"):
            if len(batch) != 5:
                raise ValueError(
                    "stacked batch must be (positions, box, pairs, "
                    f"target_energy, target_forces); got {len(batch)} "
                    "elements. For a single configuration, wrap the entry "
                    "in a list ([entry]) or use stack_batch([entry]).")
            lead = {int(a.shape[0]) for a in batch if a.ndim > 0}
            if len(lead) != 1 or batch[0].ndim != 3:
                raise ValueError(
                    "stacked batch arrays must share one leading "
                    "configuration axis (positions (B,N,3), box (B,3,3), "
                    "pairs (B,P,2), energies (B,), forces (B,N,3)); got "
                    f"shapes {[tuple(a.shape) for a in batch]}.")
            entries = [tuple(a[b] for a in batch) for b in range(lead.pop())]
        else:
            entries = batch
        return torch.mean(torch.stack([one(params, *e) for e in entries]))

    return loss


def adam(lr=1e-3):
    """The default optimizer factory: ``torch.optim.Adam`` over the
    parameter dict's tensors (optax.adam's update rule)."""
    return lambda params: torch.optim.Adam(list(params.values()), lr=lr)


def fit(
    loss_fn: Callable,
    params0: dict,
    batches,
    optimizer: Callable | None = None,
    n_epochs: int = 1,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    log_fn: Callable = print,
    log_every: int = 10,
) -> FitResult:
    """Run a fitting loop.

    Args:
      loss_fn: (params, batch) -> scalar tensor.
      params0: dict of initial parameter tensors; copied, not modified.
      batches: iterable (re-iterated per epoch) of batch objects.
      optimizer: factory (params dict) -> torch.optim.Optimizer over its
        tensors (default ``adam(1e-3)``).
      checkpoint_dir/checkpoint_every: checkpoints of (params, optimizer
        state_dict); resumes from the latest one if it exists, counting
        steps on from it.
    """
    params = {k: torch.as_tensor(v).detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = (optimizer or adam())(params)
    start_step = 0

    if checkpoint_dir:
        restored, step = restore_checkpoint(checkpoint_dir,
                                            {"params": params})
        if restored is not None:
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(restored["params"][k])
            opt.load_state_dict(restored["opt_state"])
            start_step = step
            log_fn(f"resumed from checkpoint at step {step}")

    def save(step):
        save_checkpoint(checkpoint_dir, {
            "params": {k: v.detach() for k, v in params.items()},
            "opt_state": opt.state_dict()}, step)

    history = []
    step = start_step
    for _ in range(n_epochs):
        for batch in batches:
            t0 = time.perf_counter()
            with profiling.span("fit.step", composite=True):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, batch)
                loss.backward()
                opt.step()
                # waits for the step: dt is its full time
                loss = profiling.host_sync("fit.loss", float, loss.detach())
            step += 1
            history.append({"step": step, "loss": loss,
                            "dt": time.perf_counter() - t0})
            if log_every and step % log_every == 0:
                log_fn(f"step {step}: loss {loss:.6e}")
            if checkpoint_dir and checkpoint_every and step % checkpoint_every == 0:
                save(step)
    if checkpoint_dir and checkpoint_every:
        save(step)
    return FitResult(
        params={k: v.detach() for k, v in params.items()}, history=history,
        steps=step)
