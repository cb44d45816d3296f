"""Ewald self energy and the polarization penalty (admp_tpu/ops/selfenergy.py)."""

from __future__ import annotations

import numpy as np
import torch

from admp_tpu_torch.utils.accmath import compensated_sum
from admp_tpu_torch.utils.constants import DIELECTRIC
from admp_tpu_torch.utils.devconst import device_constant


def _self_factor(kappa, n_harm: int, dtype, device):
    """kappa/sqrt(pi) (2 kappa^2)^l / (2l+1)!! for the first ``n_harm``
    harmonics, kept on ``device`` (utils/devconst) for a number kappa; from
    a tensor kappa, built anew at each call."""

    def make():
        l_list = np.array([0] + [1] * 3 + [2] * 5)[:n_harm]
        l_fac2 = np.array([1] + [3] * 3 + [15] * 5)[:n_harm]
        return kappa / np.sqrt(np.pi) * (2.0 * kappa**2) ** l_list / l_fac2

    if torch.is_tensor(kappa):
        return torch.as_tensor(make(), dtype=dtype, device=device)
    key = ("self_factor", type(kappa), float(kappa), n_harm)
    return device_constant(key, make, dtype, device)


def pme_self_energy(q_harm, kappa, lmax: int = 2):
    """E_self = -kappa/sqrt(pi) sum_a sum_lm (2 kappa^2)^l / (2l+1)!! Q_lm^2
    DIELECTRIC, compensated in float32 (it cancels ~1e6-magnitude real-space
    exclusion corrections)."""
    n_harm = (lmax + 1) ** 2
    factor = _self_factor(kappa, n_harm, q_harm.dtype, q_harm.device)
    terms = factor[None, :] * q_harm[:, :n_harm] ** 2
    total = (compensated_sum(terms) if terms.dtype == torch.float32
             else terms.sum())
    return -total * DIELECTRIC


def polarization_penalty(u_ind, pol):
    """sum_a |U_a|^2 / (2 pol_a) DIELECTRIC, pol floored at 1e-8."""
    pol_safe = torch.clamp(pol, min=1e-8)
    return torch.sum(0.5 / pol_safe * torch.sum(u_ind * u_ind, dim=-1)) * DIELECTRIC


def dispersion_self_energy(c_list, kappa, pmax: int):
    """Dispersion Ewald self energy E_p = -kappa^p / const_p sum_a c_p^2,
    const = (12, 48, 240) for p = (6, 8, 10)."""
    energy = -(kappa**6) / 12.0 * torch.sum(c_list[:, 0] ** 2)
    if pmax >= 8:
        energy = energy - kappa**8 / 48.0 * torch.sum(c_list[:, 1] ** 2)
    if pmax >= 10:
        energy = energy - kappa**10 / 240.0 * torch.sum(c_list[:, 2] ** 2)
    return energy
