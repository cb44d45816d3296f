"""Dispersion PME, C6/C8/C10 (admp_tpu/models/dispersion.py).

Real space is plain PyTorch (admp_tpu computes it in XLA, not Pallas). The
reciprocal channels share one B-spline geometry: one three-channel spread on
the CUDA kernel K4 (its adjoint, the gather K6, in the backward), one batched
FFT, and the gamma point included (ops/reciprocal.make_disp_pme_recip).

``ADMPDispPmeForce`` keeps admp_tpu's public surface: the constructor,
``get_energy`` / ``get_forces`` / ``get_metrics``, ``update_env``,
``refresh_calculators``, writable ``kappa`` and ``K1..K3`` and the
``pmax_recip`` truncation. As for the port's ADMPPmeForce, pairs are
re-resolved on every call: nothing about them is cached.
"""

from __future__ import annotations

import numpy as np
import torch

from admp_tpu_torch.models.pme import ADMPPmeForce
from admp_tpu_torch.ops.cuda import resolve_device
from admp_tpu_torch.ops.dispersion import dispersion_pair_energy
from admp_tpu_torch.ops.ewald import (
    lane_align_k3,
    setup_ewald_parameters,
    setup_ewald_parameters_fft,
)
from admp_tpu_torch.ops.exclusions import (
    as_covalent_map,
    lookup_topology_distance,
    scale_for_distance,
)
from admp_tpu_torch.ops.influence import ck_6, ck_8, ck_10
from admp_tpu_torch.ops.reciprocal import make_disp_pme_recip
from admp_tpu_torch.ops.selfenergy import dispersion_self_energy
from admp_tpu_torch.ops.shortrange import pair_r2
from admp_tpu_torch.settings import EngineConfig


def disp_pme_real_energy(positions, box, pairs, c_list, m_scales,
                         covalent_map, kappa, pmax: int):
    """Real-space dispersion Ewald energy over a padded pair list (pairs
    with i >= j are padding)."""
    mask, i, j, r2 = pair_r2(positions, box, pairs)
    mscale = scale_for_distance(m_scales,
                                lookup_topology_distance(covalent_map, i, j))
    e = dispersion_pair_energy(r2, c_list.index_select(0, i),
                               c_list.index_select(0, j), mscale, kappa, pmax)
    return torch.where(mask, e, torch.zeros_like(e)).sum()


def energy_disp_pme(positions, box, pairs, c_list, m_scales, covalent_map,
                    kappa, pmax, recip_fn):
    """Total dispersion PME energy: real + reciprocal (``recip_fn``, all
    channels in one spread) + self. ``c_list`` (N, n_p) holds the square
    roots of C6, C8, C10 in the reference's working units."""
    energy = disp_pme_real_energy(positions, box, pairs, c_list, m_scales,
                                  covalent_map, kappa, pmax)
    energy = energy + recip_fn(positions, box, c_list)
    return energy + dispersion_self_energy(c_list, kappa, pmax)


class ADMPDispPmeForce:
    """Dispersion PME calculator with admp_tpu's public surface.

    ``device`` and ``dtype`` say where and in what type the force works;
    inputs are moved there. The default is the card: without one the
    constructor raises, and the CPU is taken only when asked for
    (``device='cpu'``). ``get_forces`` returns (energy, dE/dpositions).
    """

    def __init__(self, box, covalent_map, rc, ethresh, pmax,
                 cache_influence: bool = False,
                 fft_friendly_grid: bool | str = "auto",
                 config: EngineConfig | None = None, device="cuda",
                 dtype=torch.float32):
        if config is None:
            config = EngineConfig(cache_influence=cache_influence,
                                  fft_friendly_grid=fft_friendly_grid)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        box_np = np.asarray(box.detach().cpu() if torch.is_tensor(box) else box,
                            dtype=np.float64)
        # a dense (N, N) map or a SparseExclusions
        # (admp_tpu/models/dispersion.py:100-117)
        self.covalent_map = as_covalent_map(covalent_map, self.device)
        self.rc = rc
        self.ethresh = ethresh
        self.pmax = int(pmax)
        self._static_box = (self._float(box_np) if config.cache_influence
                            else None)
        # the dispersion kernels decay far faster in k-space than Coulomb's:
        # their grids may take a looser target of their own
        grid_ethresh = (config.disp_ethresh if config.disp_ethresh is not None
                        else ethresh)
        if config.resolve_fft_friendly():
            kappa, k1, k2, k3 = setup_ewald_parameters_fft(rc, grid_ethresh,
                                                           box_np)
        else:
            kappa, k1, k2, k3 = setup_ewald_parameters(rc, grid_ethresh,
                                                       box_np)
        if config.resolve_lane_align():
            k3 = lane_align_k3(k3)
        self.kappa = kappa
        self.K1, self.K2, self.K3 = k1, k2, k3
        self.refresh_calculators()

    # inputs are taken as ADMPPmeForce takes them
    _float = ADMPPmeForce._float
    _accept_pairs = ADMPPmeForce._accept_pairs

    def update_env(self, attr, val):
        """Set an attribute (kappa, K1..K3, ...) and rebuild the engines."""
        setattr(self, attr, val)
        self.refresh_calculators()

    def refresh_calculators(self):
        """(Re)build the reciprocal engine from kappa, K1..K3 and pmax. Only
        the reciprocal channels are truncated to ``pmax_recip``; real and
        self space keep the full pmax."""
        cfg = self.config
        pmax_recip = min(self.pmax, cfg.pmax_recip if cfg.pmax_recip
                         is not None else self.pmax)
        self._pmax_recip = pmax_recip
        cks = [ck_6] + [ck for p, ck in ((8, ck_8), (10, ck_10))
                        if pmax_recip >= p]
        self._kappa = self.kappa
        self.recip_fn = make_disp_pme_recip(
            cks, self.kappa, (self.K1, self.K2, self.K3),
            static_box=self._static_box, spread_order=cfg.disp_spread_order,
            spread_method=cfg.spread_method)

    def _args(self, positions, box, pairs, c_list, mScales):
        return (self._float(positions), self._float(box),
                self._accept_pairs(pairs),
                self._float(c_list), self._float(mScales))

    def get_energy(self, positions, box, pairs, c_list, mScales):
        positions, box, pairs, c_list, m_scales = self._args(
            positions, box, pairs, c_list, mScales)
        return energy_disp_pme(positions, box, pairs, c_list, m_scales,
                               self.covalent_map, self._kappa, self.pmax,
                               self.recip_fn)

    def get_forces(self, positions, box, pairs, c_list, mScales):
        pos = self._float(positions).detach().requires_grad_(True)
        with torch.enable_grad():
            energy = self.get_energy(pos, box, pairs, c_list, mScales)
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), grad

    def get_metrics(self, positions, box, pairs, c_list, mScales):
        """The real, reciprocal and self terms and their total."""
        positions, box, pairs, c_list, m_scales = self._args(
            positions, box, pairs, c_list, mScales)
        with torch.no_grad():
            e_real = disp_pme_real_energy(positions, box, pairs, c_list,
                                          m_scales, self.covalent_map,
                                          self._kappa, self.pmax)
            e_recip = self.recip_fn(positions, box, c_list)
            e_self = dispersion_self_energy(c_list, self._kappa, self.pmax)
        return {"e_disp_real": e_real, "e_disp_recip": e_recip,
                "e_disp_self": e_self,
                "e_disp_total": e_real + e_recip + e_self}
