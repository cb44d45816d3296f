"""Hand admp_tpu's parameters and state to the port.

``convert_state`` turns arrays (numpy, or anything ``np.asarray`` reads, such
as JAX arrays) into the port's tensors on a device and dtype;
``force_from_jax`` builds a port ``ADMPPmeForce`` that copies an admp_tpu
force object's kappa, K1..K3 and configuration, so the two packages compute
the same thing. ``convert_params`` and ``adam_state_from_optax`` carry a fit
across: a parameter dict, and the moments and step count of optax's Adam
(``ScaleByAdamState``) as the state of ``torch.optim.Adam``. None of them
imports JAX or optax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from admp_tpu_torch.models.pme import ADMPPmeForce
from admp_tpu_torch.settings import EngineConfig, SCFConfig

FLOAT_FIELDS = ("positions", "box", "q_local", "pol", "tholes", "m_scales",
                "p_scales", "d_scales", "u_ind")
INDEX_FIELDS = ("axis_types", "axis_indices", "covalent_map", "pairs")
SCALAR_FIELDS = {"kappa": float, "K1": int, "K2": int, "K3": int}


def _copy(a, device, dtype):
    """A tensor that owns a copy of ``a``: torch.as_tensor would share the
    buffer of a float64 numpy or JAX array, and an in-place optimizer step
    would then write into the other package's arrays."""
    return torch.tensor(np.array(a, dtype=np.float64), device=device).to(dtype)


def convert_state(device="cpu", dtype=torch.float64, **arrays):
    """Convert admp_tpu arrays to port tensors.

    Float fields (positions, box, q_local harmonics, pol, tholes, m/p/d
    scales, u_ind) become ``dtype`` tensors; index fields (axis_types,
    axis_indices, covalent_map, pairs) become int64 tensors; kappa and
    K1..K3 become Python numbers. Returns a dict with the same keys.
    """
    out = {}
    for name, value in arrays.items():
        if name in SCALAR_FIELDS:
            out[name] = SCALAR_FIELDS[name](np.asarray(value))
        elif name in FLOAT_FIELDS:
            out[name] = _copy(value, device, dtype)
        elif name in INDEX_FIELDS:
            out[name] = torch.as_tensor(np.asarray(value).astype(np.int64),
                                        device=device)
        else:
            raise ValueError(
                f"unknown field {name!r}: expected one of "
                f"{FLOAT_FIELDS + INDEX_FIELDS + tuple(SCALAR_FIELDS)}")
    return out


def _copy_fields(cls, source, overrides):
    """An instance of the frozen dataclass ``cls`` with the fields that
    ``source`` (an admp_tpu config) shares by name, then ``overrides``."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in overrides:
            kw[f.name] = overrides[f.name]
        elif f.name != "scf" and hasattr(source, f.name):
            kw[f.name] = getattr(source, f.name)
    return kw


def force_from_jax(jax_force, box, device="cpu", dtype=torch.float64,
                   **overrides):
    """A port ADMPPmeForce equivalent to the admp_tpu force ``jax_force``:
    same axis data, covalent map, cutoff, lmax, lpol, kappa, K1..K3 and the
    configuration fields both packages have. ``pair_kernel`` and
    ``spread_method`` take admp_tpu-only values there ('xla', 'pallas', ...),
    so they stay at the port's ``'auto'`` unless given in ``overrides``;
    other overrides replace EngineConfig or SCFConfig fields by name."""
    src_cfg = jax_force.config
    scf_names = {f.name for f in dataclasses.fields(SCFConfig)}
    scf_over = {k: v for k, v in overrides.items() if k in scf_names}
    eng_over = {k: v for k, v in overrides.items() if k not in scf_names}
    eng_over.setdefault("pair_kernel", "auto")
    eng_over.setdefault("spread_method", "auto")
    scf = SCFConfig(**_copy_fields(SCFConfig, src_cfg.scf, scf_over))
    config = EngineConfig(scf=scf,
                          **_copy_fields(EngineConfig, src_cfg, eng_over))
    force = ADMPPmeForce(
        np.asarray(box), np.asarray(jax_force.axis_type),
        np.asarray(jax_force.axis_indices), np.asarray(jax_force.covalent_map),
        jax_force.rc, jax_force.ethresh, jax_force.lmax, jax_force.lpol,
        config=config, device=device, dtype=dtype)
    force.kappa = float(jax_force.kappa)
    force.K1, force.K2, force.K3 = (int(jax_force.K1), int(jax_force.K2),
                                    int(jax_force.K3))
    force.refresh_calculators()
    return force


def convert_params(params, device="cpu", dtype=torch.float64):
    """A parameter dict of arrays -> leaf tensors that require grad, the
    form fitting.fit and a torch.optim optimizer take."""
    return {k: _copy(v, device, dtype).requires_grad_(True)
            for k, v in params.items()}


def adam_state_from_optax(mu, nu, count, params):
    """The ``torch.optim.Adam`` state of the tensors in ``params`` (a dict)
    from optax's ``ScaleByAdamState``: ``mu`` and ``nu`` are dicts of arrays
    with the same keys, ``count`` the step count. Returns {tensor: state};
    ``optimizer.state.update(...)`` installs it. optax's update
    m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) is torch's for the same
    moments and step."""
    step = torch.tensor(float(np.asarray(count)),
                        dtype=torch.get_default_dtype())
    return {p: {"step": step.clone(),
                "exp_avg": _copy(mu[k], p.device, p.dtype),
                "exp_avg_sq": _copy(nu[k], p.device, p.dtype)}
            for k, p in params.items()}
