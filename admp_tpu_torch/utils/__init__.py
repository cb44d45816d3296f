"""Constants, 3x3 algebra, compensated sums, safe masked arithmetic and
profiling."""

from admp_tpu_torch.utils.constants import (
    ANGSTROM_TO_BOHR,
    DEFAULT_THOLE_WIDTH,
    DIELECTRIC,
    HARTREE_TO_KJMOL,
    SQRT_PI,
)
from admp_tpu_torch.utils.safety import masked_norm, safe_inv, safe_normalize

__all__ = [
    "ANGSTROM_TO_BOHR",
    "DEFAULT_THOLE_WIDTH",
    "DIELECTRIC",
    "HARTREE_TO_KJMOL",
    "SQRT_PI",
    "masked_norm",
    "safe_inv",
    "safe_normalize",
]
