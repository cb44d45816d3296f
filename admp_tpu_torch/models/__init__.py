"""Multipolar PME force models."""

from admp_tpu_torch.models.dispersion import ADMPDispPmeForce, energy_disp_pme
from admp_tpu_torch.models.pme import ADMPPmeForce, energy_pme, pme_real_energy

__all__ = [
    "ADMPDispPmeForce",
    "ADMPPmeForce",
    "energy_disp_pme",
    "energy_pme",
    "pme_real_energy",
]
