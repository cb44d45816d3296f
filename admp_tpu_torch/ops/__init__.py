"""Geometry, multipole algebra, real and reciprocal space, neighbor lists."""

from admp_tpu_torch.ops import (
    bsplines,
    dispersion,
    ewald,
    frames,
    harmonics,
    influence,
    neighborlist,
    pbc,
    realspace,
    reciprocal,
    selfenergy,
    shortrange,
)

__all__ = [
    "bsplines",
    "dispersion",
    "ewald",
    "frames",
    "harmonics",
    "influence",
    "neighborlist",
    "pbc",
    "realspace",
    "reciprocal",
    "selfenergy",
    "shortrange",
]
