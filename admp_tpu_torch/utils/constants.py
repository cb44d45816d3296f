"""Physical constants and unit conversions (admp_tpu/utils/constants.py).

Lengths in Angstrom, charges in e, energies in kJ/mol.
"""

# Coulomb constant in kJ/mol * A / e^2.
DIELECTRIC = 1389.35455846

# Default Thole damping width of a "real" (non-excluded) interaction.
DEFAULT_THOLE_WIDTH = 0.3

SQRT_PI = 1.7724538509055159
