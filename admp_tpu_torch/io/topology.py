"""Topology assembly: template matching, axis-anchor resolution, covalent maps
(admp_tpu/io/topology.py, numpy only).

Covalent distances come from a breadth-first search, so they are the shortest
bond-graph distances also in cyclic molecules. ``build_covalent_map_from_bonds``
is the port's one copy of it (systems.py uses it too).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

import numpy as np

from admp_tpu_torch.ops import frames as frame_codes


@dataclasses.dataclass
class System:
    """Flat per-atom arrays ready for the energy calculators."""

    positions: np.ndarray        # (N, 3) Angstrom
    box: np.ndarray              # (3, 3) Angstrom, lattice vectors in rows
    q_cart: np.ndarray           # (N, 10) Cartesian multipoles, engine units
    axis_types: np.ndarray       # (N,)
    axis_indices: np.ndarray     # (N, 3), -1 when absent
    covalent_map: np.ndarray     # (N, N) topological distances (0 = distant)
    pol: np.ndarray              # (N,) isotropic polarizability, A^3
    tholes: np.ndarray           # (N,) Thole widths
    bonds: list                  # [(i, j)] global serial pairs
    charges: np.ndarray | None = None  # (N,) per-line PDB charge column
    # (carried through like the reference's pdbinfo['charges'],
    # admp/parser.py:168; the physics uses XML multipoles, not these)

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[0]


def build_covalent_map_from_bonds(bonds, n_atoms: int, max_depth: int = 6):
    """Dense (N, N) topological-distance matrix via BFS up to ``max_depth``.

    Entry 0 means "more than max_depth bonds apart (or same atom)". Matches the
    reference's OpenMM-path construction (admp/api.py:24-42).
    """
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


def _resolve_axis_indices(slots, atom_serials, atom_types, self_serial):
    """Resolve anchor type-name slots to atom serials within a residue.

    Each candidate atom can fill at most one slot, scanning slots in (z, x, y)
    order — exact parity with reference: admp/parser.py:417-431, which the MPID
    water convention depends on (two identical-type H anchors fill z then x).
    """
    resolved = [s if s else -1 for s in slots]
    for serial, atype in zip(atom_serials, atom_types):
        if serial == self_serial:
            continue
        for k in range(3):
            if isinstance(resolved[k], str) and resolved[k] == atype:
                resolved[k] = serial
                break
    return [r if isinstance(r, int) else -1 for r in resolved]


def assemble_system(pdb_data, atom_templates, residue_templates,
                    covalent_depth: int = 4) -> System:
    """Join PDB coordinates with force-field templates into flat arrays.

    Unit handling matches the reference example scripts
    (examples/water_1024/run_admp.py:49-51, 60-64 via admp/api.py:319-334):
    dipoles x10 (nm -> A), quadrupoles x300, polarizabilities x1000 isotropic
    mean.
    """
    n = len(pdb_data.names)
    res_by_name = {r.name: r for r in residue_templates}

    # group atom indices by residue instance
    residues = defaultdict(list)
    for idx in range(n):
        residues[pdb_data.res_seqs[idx]].append(idx)

    q_cart = np.zeros((n, 10))
    axis_types = np.full(n, frame_codes.NOAXISTYPE, dtype=np.int32)
    axis_indices = np.full((n, 3), -1, dtype=np.int32)
    pol = np.zeros(n)
    tholes = np.zeros(n)
    bonds = []

    for seq, members in residues.items():
        res_name = pdb_data.res_names[members[0]]
        template = res_by_name[res_name]
        tmpl_by_name = {a.name: a for a in template.atoms}

        serial_by_name = {}
        types = []
        for serial in members:
            name = pdb_data.names[serial]
            tmpl = tmpl_by_name[name]
            serial_by_name[name] = serial
            types.append(tmpl.type)
            mp = tmpl.multipole
            if mp:
                q_cart[serial] = [
                    mp["c0"],
                    mp["dX"] * 10.0, mp["dY"] * 10.0, mp["dZ"] * 10.0,
                    mp["qXX"] * 300.0, mp["qYY"] * 300.0, mp["qZZ"] * 300.0,
                    mp["qXY"] * 300.0, mp["qXZ"] * 300.0, mp["qYZ"] * 300.0,
                ]
            axis_types[serial] = tmpl.axis_type
            if tmpl.polarize:
                pz = tmpl.polarize
                pol[serial] = 1000.0 * (
                    pz["polarizabilityXX"]
                    + pz["polarizabilityYY"]
                    + pz["polarizabilityZZ"]
                ) / 3.0
                tholes[serial] = pz["thole"]

        for serial in members:
            tmpl = tmpl_by_name[pdb_data.names[serial]]
            axis_indices[serial] = _resolve_axis_indices(
                list(tmpl.axis_anchor_types), members, types, serial
            )

        for a_idx, b_idx in template.bonds:
            sa = serial_by_name[template.atoms[a_idx].name]
            sb = serial_by_name[template.atoms[b_idx].name]
            bonds.append((sa, sb))

    # CONECT records contribute connectivity templates can't express
    # (inter-residue links, ligand bonds) so their exclusions are honoured
    seen = {(min(a, b), max(a, b)) for a, b in bonds}
    conect_fn = getattr(pdb_data, "conect_bonds", None)
    if conect_fn is not None:
        for key in conect_fn():
            if key not in seen:
                seen.add(key)
                bonds.append(key)

    covalent_map = build_covalent_map_from_bonds(bonds, n, covalent_depth)

    return System(
        positions=np.asarray(pdb_data.positions, dtype=float),
        box=pdb_data.box_matrix(),
        q_cart=q_cart,
        axis_types=axis_types,
        axis_indices=axis_indices,
        covalent_map=covalent_map,
        pol=pol,
        tholes=tholes,
        bonds=bonds,
        charges=np.asarray(
            [float(c) if c else 0.0 for c in pdb_data.charges], dtype=float
        ),
    )


def load_mpid_system(pdb_path: str, xml_path: str, covalent_depth: int = 4) -> System:
    """One-call front-end: PDB + MPID XML -> flat System arrays."""
    from admp_tpu_torch.io.ffxml import read_ffxml
    from admp_tpu_torch.io.pdb import read_pdb

    pdb_data = read_pdb(pdb_path)
    atom_templates, residue_templates = read_ffxml(xml_path)
    return assemble_system(pdb_data, atom_templates, residue_templates, covalent_depth)
