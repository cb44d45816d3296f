"""Synthetic example systems (numpy only, no data files): liquid-density MPID
water boxes, the same arrays as admp_tpu/systems.py builds for the same
arguments. A copy rather than an import, because admp_tpu imports JAX.
Also the front end's inputs for such a box: a PDB and the MPID water
force-field XML.
"""

from __future__ import annotations

import pathlib

import numpy as np

from admp_tpu_torch.io.topology import build_covalent_map_from_bonds
from admp_tpu_torch.ops.exclusions import build_sparse_exclusions
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


def _exclusions(kind, bonds, n_atoms):
    if kind == "dense":
        return build_covalent_map_from_bonds(bonds, n_atoms, 6)
    if kind == "sparse":
        return build_sparse_exclusions(bonds, n_atoms, 6)
    if kind is None:
        return None
    raise ValueError(f"exclusions={kind!r}: 'dense', 'sparse' or None")


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


def water_system(n_side=2, spacing=3.1, jitter=0.1, seed=0,
                 exclusions="dense"):
    """Per-atom numpy arrays of the MPID water model on a synthetic lattice:
    positions, box, q_cart, axis_types, axis_indices, covalent_map, pol,
    tholes, c_list, tt_a, tt_b, tt_q.

    ``exclusions``: ``'dense'`` makes ``covalent_map`` the (N, N) map (as
    admp_tpu does), ``'sparse'`` a SparseExclusions of the same bonds and
    depth (bonds (3m, 3m+1), (3m, 3m+2), max_depth 6), None leaves it out."""
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
        covalent_map=_exclusions(exclusions, bonds, n),
        pol=np.tile([p["pol_O"], 0.0, 0.0], nmol),
        tholes=np.tile([p["thole_O"], 0.0, 0.0], nmol),
        c_list=c_list,
        tt_a=np.tile([p["a_O"], p["a_H"], p["a_H"]], nmol),
        tt_b=np.tile([p["b_O"], p["b_H"], p["b_H"]], nmol),
        tt_q=np.tile([p["q_O"], p["q_H"], p["q_H"]], nmol),
    )


def write_water_pdb(path, positions, box):
    """Write a synthetic water box as a minimal PDB (O/H1/H2 per residue,
    CRYST1 orthorhombic cell): the input format the front end reads, and
    the bytes admp_tpu/systems.py:121 writes. ``positions`` (N, 3) and
    ``box`` (3, 3) are numpy arrays or tensors, on any device."""
    positions, box = (np.asarray(x.detach().cpu() if hasattr(x, "detach")
                                 else x) for x in (positions, box))
    names = ["O", "H1", "H2"]
    with open(path, "w") as fh:
        fh.write("REMARK  synthetic water box\n")
        fh.write(
            "CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1\n"
            % (box[0, 0], box[1, 1], box[2, 2], 90, 90, 90)
        )
        for i, p in enumerate(positions):
            fh.write(
                "HETATM%5d %-4s HOH A%4d    %8.3f%8.3f%8.3f  1.00  0.00"
                "           %s\n"
                % (i + 1, names[i % 3], i // 3 + 1, p[0], p[1], p[2],
                   names[i % 3][0])
            )
        fh.write("END\n")


# MPID_WATER in the units of its force-field XML: multipoles nm-based (the
# front end scales dipoles by 10 and quadrupoles by 300), polarizabilities in
# nm^3 (x1000), Thole widths; Tang-Toennies A in kJ/mol (the front end divides
# by 2625.5), B in 1/nm (x0.0529177249), C6, C8, C10 as the squares of the
# engine's sqrt coefficients over 1e6, 1e8, 1e10. O is type 380 (bisector
# frame of its two H), H type 381 (z to O, x to the other H).
WATER_XML_MULTIPOLES = {
    "380": dict(c0=-1.0614, dZ=-0.023671684, qXX=0.000150963, qYY=0.00008707,
                qZZ=-0.000238034, kz="381", kx="-381"),
    "381": dict(c0=0.5307, kz="380", kx="381"),
}
WATER_XML_POL = {"380": dict(pol=0.00088, thole=8.0)}
WATER_XML_DISP = {  # (a Hartree, b 1/Bohr, q, sqrt C6, sqrt C8, sqrt C10)
    "380": (458.3777, 2.00095977, -0.741706, 37.19677405, 85.26810658,
            134.44874488),
    "381": (0.0317, 1.999519942, 0.370853, 7.6111103, 11.90220148,
            15.05074749),
}


def water_ff_xml():
    """The MPID water force field as an XML document (a str): residue HOH
    with its two O-H bonds, an <ADMPDispForce> and an <ADMPPmeForce>
    (lmax 2, polarizable), scale factors 0 0 0 1 1."""
    def scales(prefixes):
        return "".join(f' {p}Scale1{i}="{v}"' for p in prefixes
                       for i, v in zip(range(2, 7), (0, 0, 0, 1, 1)))

    disp = "".join(
        f'    <Atom type="{t}" A="{a * 2625.5!r}" B="{b / 0.0529177249!r}" '
        f'Q="{q!r}" C6="{c6 * c6 / 1e6!r}" C8="{c8 * c8 / 1e8!r}" '
        f'C10="{c10 * c10 / 1e10!r}"/>\n'
        for t, (a, b, q, c6, c8, c10) in WATER_XML_DISP.items())
    pme = ""
    for t, m in WATER_XML_MULTIPOLES.items():
        attrs = " ".join(f'{k}="{v}"' for k, v in m.items())
        pme += f'    <Atom type="{t}" {attrs}/>\n'
    for t, p in WATER_XML_POL.items():
        pme += (f'    <Polarize type="{t}" polarizabilityXX="{p["pol"]}" '
                f'polarizabilityYY="{p["pol"]}" polarizabilityZZ="{p["pol"]}" '
                f'thole="{p["thole"]}"/>\n')
    return (
        "<ForceField>\n"
        " <AtomTypes>\n"
        '  <Type name="380" class="OW" element="O" mass="15.999"/>\n'
        '  <Type name="381" class="HW" element="H" mass="1.008"/>\n'
        " </AtomTypes>\n"
        " <Residues>\n"
        '  <Residue name="HOH">\n'
        '   <Atom name="O" type="380"/>\n'
        '   <Atom name="H1" type="381"/>\n'
        '   <Atom name="H2" type="381"/>\n'
        '   <Bond from="0" to="1"/>\n'
        '   <Bond from="0" to="2"/>\n'
        "  </Residue>\n"
        " </Residues>\n"
        f" <ADMPDispForce{scales('m')}>\n{disp}"
        " </ADMPDispForce>\n"
        f' <ADMPPmeForce lmax="2" pmax="10"{scales("mpd")}>\n{pme}'
        " </ADMPPmeForce>\n"
        "</ForceField>\n")


def write_water_inputs(directory, positions, box):
    """Write the MPID water XML and a PDB of ``positions`` in ``box`` into
    ``directory``; returns (xml path, pdb path). A PDB numbers at most
    9,999 residues, so more waters raise ValueError."""
    if len(positions) > 3 * 9999:
        raise ValueError(f"{len(positions) // 3} waters: a PDB holds at "
                         "most 9,999 residues")
    directory = pathlib.Path(directory)
    xml, pdb = directory / "mpid_water.xml", directory / "water.pdb"
    xml.write_text(water_ff_xml())
    write_water_pdb(pdb, positions, box)
    return str(xml), str(pdb)
