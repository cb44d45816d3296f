"""Geometry, multipole algebra, real and reciprocal space, neighbor lists."""
