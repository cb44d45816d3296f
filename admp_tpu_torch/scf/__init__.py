"""Induced-dipole SCF solver."""
