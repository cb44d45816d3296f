"""Hand admp_tpu's parameters and state to the port.

``convert_state`` turns arrays (numpy, or anything ``np.asarray`` reads, such
as JAX arrays) into the port's tensors on a device and dtype, and an
admp_tpu ``SparseExclusions`` into the port's;
``force_from_jax`` and ``disp_force_from_jax`` build a port ``ADMPPmeForce``
or ``ADMPDispPmeForce`` that copies an admp_tpu force object's kappa, K1..K3,
pmax and configuration, so the two packages compute the same thing.
``convert_params`` and ``adam_state_from_optax`` carry a fit across: a
parameter dict (an admp_tpu generator's ``params`` too), and the moments and
step count of optax's Adam (``ScaleByAdamState``) as the state of
``torch.optim.Adam``; ``md_state_from_jax`` carries a trajectory's
``MDState`` across. None of them
imports JAX or optax. Every array is copied, and everything lands on the card
unless the caller asks for the CPU (``device='cpu'``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from admp_tpu_torch.md import MDState
from admp_tpu_torch.models.dispersion import ADMPDispPmeForce
from admp_tpu_torch.models.pme import ADMPPmeForce
from admp_tpu_torch.ops.cuda import resolve_device
from admp_tpu_torch.ops.exclusions import SparseExclusions
from admp_tpu_torch.settings import EngineConfig, SCFConfig

FLOAT_FIELDS = ("positions", "box", "q_local", "pol", "tholes", "m_scales",
                "p_scales", "d_scales", "u_ind", "c_list", "tt_a", "tt_b",
                "tt_q")
INDEX_FIELDS = ("axis_types", "axis_indices", "covalent_map", "pairs")
SCALAR_FIELDS = {"kappa": float, "K1": int, "K2": int, "K3": int}


def _copy(a, device, dtype):
    """A tensor that owns a copy of ``a``: torch.as_tensor would share the
    buffer of a float64 numpy or JAX array, and an in-place optimizer step
    would then write into the other package's arrays."""
    return torch.tensor(np.array(a, dtype=np.float64), device=device).to(dtype)


def _is_sparse_map(covalent):
    return all(hasattr(covalent, k) for k in ("idx", "dist", "n_atoms"))


def covalent_map_from_jax(covalent):
    """admp_tpu's covalent map on the host: its SparseExclusions (the
    ``idx``, ``dist`` and ``n_atoms`` of the pytree) as the port's, or a
    dense map as a numpy array."""
    if _is_sparse_map(covalent):
        return SparseExclusions(np.asarray(covalent.idx),
                                np.asarray(covalent.dist), covalent.n_atoms)
    return np.asarray(covalent)


def convert_state(device="cuda", dtype=torch.float64, **arrays):
    """Convert admp_tpu arrays to port tensors.

    Float fields (positions, box, q_local harmonics, pol, tholes, m/p/d
    scales, u_ind, the dispersion coefficients c_list and the Tang-Toennies
    tt_a, tt_b, tt_q) become ``dtype`` tensors that own their memory; index
    fields (axis_types, axis_indices, covalent_map, pairs) become int64
    tensors, except a sparse covalent map, which becomes the port's
    SparseExclusions on ``device``; kappa and K1..K3 become Python numbers.
    Returns a dict with the same keys.
    """
    device = resolve_device(device)
    out = {}
    for name, value in arrays.items():
        if name == "covalent_map" and _is_sparse_map(value):
            out[name] = covalent_map_from_jax(value).to(device)
        elif name in SCALAR_FIELDS:
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


def _engine_config(src_cfg, overrides):
    """The port's EngineConfig (with its SCFConfig) holding the fields that
    admp_tpu's config ``src_cfg`` shares with it, then ``overrides`` by name.
    ``pair_kernel`` and ``spread_method`` take admp_tpu-only values there
    ('xla', 'pallas', ...), so they stay at the port's ``'auto'`` unless
    overridden."""
    scf_names = {f.name for f in dataclasses.fields(SCFConfig)}
    scf_over = {k: v for k, v in overrides.items() if k in scf_names}
    eng_over = {k: v for k, v in overrides.items() if k not in scf_names}
    eng_over.setdefault("pair_kernel", "auto")
    eng_over.setdefault("spread_method", "auto")
    scf = SCFConfig(**_copy_fields(SCFConfig, src_cfg.scf, scf_over))
    return EngineConfig(scf=scf, **_copy_fields(EngineConfig, src_cfg,
                                                eng_over))


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


def force_from_jax(jax_force, box, device="cuda", dtype=torch.float64,
                   **overrides):
    """A port ADMPPmeForce equivalent to the admp_tpu force ``jax_force``:
    same axis data, covalent map (dense or sparse), cutoff, lmax, lpol,
    kappa, K1..K3 (admp_tpu's power-of-two grid under recip_precision='ds'
    among them) and the configuration fields both packages have
    (``_engine_config``: the precision modes, realspace_near_radius and
    realspace_near_frac too); overrides replace EngineConfig or SCFConfig
    fields by name."""
    config = _engine_config(jax_force.config, overrides)
    force = ADMPPmeForce(
        np.asarray(box), np.asarray(jax_force.axis_type),
        np.asarray(jax_force.axis_indices),
        covalent_map_from_jax(jax_force.covalent_map),
        jax_force.rc, jax_force.ethresh, jax_force.lmax, jax_force.lpol,
        config=config, device=device, dtype=dtype)
    force.kappa = float(jax_force.kappa)
    force.K1, force.K2, force.K3 = (int(jax_force.K1), int(jax_force.K2),
                                    int(jax_force.K3))
    force.refresh_calculators()
    return force


def disp_force_from_jax(jax_force, box, device="cuda", dtype=torch.float64,
                        **overrides):
    """A port ADMPDispPmeForce equivalent to the admp_tpu dispersion force
    ``jax_force``: same covalent map (dense or sparse), cutoff, pmax,
    kappa, K1..K3 and the configuration fields both packages have
    (pmax_recip, disp_ethresh, disp_spread_order, cache_influence, ...);
    overrides replace EngineConfig fields by name."""
    force = ADMPDispPmeForce(
        np.asarray(box), covalent_map_from_jax(jax_force.covalent_map),
        jax_force.rc, jax_force.ethresh, jax_force.pmax,
        config=_engine_config(jax_force.config, overrides), device=device,
        dtype=dtype)
    force.kappa = float(jax_force.kappa)
    force.K1, force.K2, force.K3 = (int(jax_force.K1), int(jax_force.K2),
                                    int(jax_force.K3))
    force.refresh_calculators()
    return force


def convert_params(params, device="cuda", dtype=torch.float64):
    """A parameter dict of arrays (an admp_tpu generator's ``params`` as it
    is, or any dict of numpy/JAX arrays) -> leaf tensors that require grad,
    the form fitting.fit, a torch.optim optimizer and the port's generators
    take."""
    device = resolve_device(device)
    return {k: _copy(v, device, dtype).requires_grad_(True)
            for k, v in params.items()}


def md_state_from_jax(state, device="cuda", dtype=torch.float64):
    """An admp_tpu ``MDState`` (positions, velocities, forces, aux) as the
    port's ``md.MDState``: each array copied to ``device`` in ``dtype``; an
    ``aux`` of None stays None, a tuple, list or dict of arrays is copied
    leaf by leaf."""
    device = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return _copy(x, device, dtype)

    return MDState(*(conv(x) for x in (state.positions, state.velocities,
                                       state.forces)), conv(state.aux))


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
