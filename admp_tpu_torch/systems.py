"""Synthetic example systems (numpy only, no data files): liquid-density MPID
water boxes, the same arrays as admp_tpu/systems.py builds for the same
arguments. A copy rather than an import, because admp_tpu imports JAX.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from admp_tpu_torch.ops.frames import BISECTOR, ZTHENX

# gas-phase-ish water geometry (Angstrom)
_OH = 0.9572
_ANG = np.deg2rad(104.52)

# MPID water multipoles (engine units: dipole x10, quadrupole x300 vs XML)
MPID_WATER = dict(
    c0_O=-1.0614, c0_H=0.5307,
    dZ_O=-0.023671684 * 10,
    qXX_O=0.000150963 * 300, qYY_O=0.00008707 * 300, qZZ_O=-0.000238034 * 300,
    pol_O=0.88, thole_O=8.0,
    # dispersion sqrt-coefficients (C6, C8, C10 columns)
    c_O=(37.19677405, 85.26810658, 134.44874488),
    c_H=(7.6111103, 11.90220148, 15.05074749),
    # Tang-Toennies params
    q_O=-0.741706, q_H=0.370853,
    b_O=2.00095977, b_H=1.999519942,
    a_O=458.3777, a_H=0.0317,
)


def build_covalent_map_from_bonds(bonds, n_atoms: int, max_depth: int = 6):
    """Dense (N, N) topological-distance matrix by BFS up to ``max_depth``;
    0 means more than max_depth bonds apart (or the same atom)."""
    adj = defaultdict(list)
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)
    cov = np.zeros((n_atoms, n_atoms), dtype=np.int32)
    for start in adj:
        seen = {start: 0}
        queue = deque([start])
        while queue:
            cur = queue.popleft()
            d = seen[cur]
            if d >= max_depth:
                continue
            for nxt in adj[cur]:
                if nxt not in seen:
                    seen[nxt] = d + 1
                    cov[start, nxt] = d + 1
                    queue.append(nxt)
    return cov


def _water_template():
    h1 = np.array([_OH * np.sin(_ANG / 2), 0.0, _OH * np.cos(_ANG / 2)])
    h2 = np.array([-_OH * np.sin(_ANG / 2), 0.0, _OH * np.cos(_ANG / 2)])
    return np.stack([np.zeros(3), h1, h2])


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=0):
    """(positions (N, 3), box (3, 3)) for n_side^3 waters on a jittered
    lattice; spacing ~3.1 A gives roughly liquid density."""
    rng = np.random.default_rng(seed)
    tmpl = _water_template()
    length = n_side * spacing
    positions = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = (np.array([ix, iy, iz]) + 0.5) * spacing
                center += rng.uniform(-jitter, jitter, 3)
                rot = _rotation(rng)
                positions.append(tmpl @ rot.T + center)
    return np.concatenate(positions), np.eye(3) * length


def water_system(n_side=2, spacing=3.1, jitter=0.1, seed=0):
    """Per-atom numpy arrays of the MPID water model on a synthetic lattice:
    positions, box, q_cart, axis_types, axis_indices, covalent_map, pol,
    tholes, c_list, tt_a, tt_b, tt_q."""
    p = MPID_WATER
    positions, box = water_lattice(n_side, spacing, jitter, seed)
    nmol = n_side**3
    n = 3 * nmol
    q_cart = np.zeros((n, 10))
    q_cart[0::3, 0] = p["c0_O"]
    q_cart[0::3, 3] = p["dZ_O"]
    q_cart[0::3, 4] = p["qXX_O"]
    q_cart[0::3, 5] = p["qYY_O"]
    q_cart[0::3, 6] = p["qZZ_O"]
    q_cart[1::3, 0] = p["c0_H"]
    q_cart[2::3, 0] = p["c0_H"]
    axis_types = np.tile([BISECTOR, ZTHENX, ZTHENX], nmol)
    axis_indices = np.zeros((n, 3), dtype=np.int32)
    bonds = []
    for m in range(nmol):
        o, h1, h2 = 3 * m, 3 * m + 1, 3 * m + 2
        axis_indices[o] = (h1, h2, -1)
        axis_indices[h1] = (o, h2, -1)
        axis_indices[h2] = (o, h1, -1)
        bonds += [(o, h1), (o, h2)]
    c_list = np.zeros((n, 3))
    c_list[0::3] = p["c_O"]
    c_list[1::3] = p["c_H"]
    c_list[2::3] = p["c_H"]
    return dict(
        positions=positions,
        box=box,
        q_cart=q_cart,
        axis_types=axis_types,
        axis_indices=axis_indices,
        covalent_map=build_covalent_map_from_bonds(bonds, n, 6),
        pol=np.tile([p["pol_O"], 0.0, 0.0], nmol),
        tholes=np.tile([p["thole_O"], 0.0, 0.0], nmol),
        c_list=c_list,
        tt_a=np.tile([p["a_O"], p["a_H"], p["a_H"]], nmol),
        tt_b=np.tile([p["b_O"], p["b_H"], p["b_H"]], nmol),
        tt_q=np.tile([p["q_O"], p["q_H"], p["q_H"]], nmol),
    )
