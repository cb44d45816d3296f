"""Induced-dipole SCF solver."""

from admp_tpu_torch.scf.solver import make_induced_dipole_solver

__all__ = ["make_induced_dipole_solver"]
