"""MPID/ADMP force-field XML reader (admp_tpu/io/ffxml.py; ElementTree,
OpenMM-free).

Covers <Residue>/<Atom>/<Bond> templates, multipoles (charge, dipole,
quadrupole) in both schemas, <Multipole> tags and <Atom c0=...> children of
<ADMPPmeForce> (octupole attributes are accepted and reported as unused), and
<Polarize>. The MPID anchor-sign axis-type classification follows OpenMM's
rules; the axis-type codes are the port's (ops/frames.py), the same numbers
as admp_tpu's.
"""

from __future__ import annotations

import dataclasses
import warnings
import xml.etree.ElementTree as ET

from admp_tpu_torch.ops import frames as frame_codes

_MULTIPOLE_FLOATS = (
    "c0", "dX", "dY", "dZ",
    "qXX", "qXY", "qYY", "qXZ", "qYZ", "qZZ",
)
_OCTUPOLE_FLOATS = (
    "oXXX", "oXXY", "oXYY", "oYYY", "oXXZ",
    "oXYZ", "oYYZ", "oXZZ", "oYZZ", "oZZZ",
)


@dataclasses.dataclass
class AtomTemplate:
    name: str
    type: str
    multipole: dict = dataclasses.field(default_factory=dict)
    polarize: dict = dataclasses.field(default_factory=dict)
    anchors: dict = dataclasses.field(default_factory=dict)  # kz/kx/ky raw strings
    axis_type: int = frame_codes.NOAXISTYPE
    axis_anchor_types: tuple = ("", "", "")  # sign-stripped (kz, kx, ky) type names


@dataclasses.dataclass
class ResidueTemplate:
    name: str
    atoms: list
    bonds: list  # (from_idx, to_idx) within-template atom indices


def classify_axis(kz: str, kx: str, ky: str):
    """MPID anchor-sign rules -> (axis_type, stripped anchor type names).

    Sequential overwrite order matters and matches reference:
    admp/parser.py:228-243.
    """
    kz_neg = kz.startswith("-")
    kx_neg = kx.startswith("-")
    ky_neg = ky.startswith("-")
    kz_s, kx_s, ky_s = kz.lstrip("-"), kx.lstrip("-"), ky.lstrip("-")

    axis = frame_codes.ZTHENX
    if not kz_s:
        axis = frame_codes.NOAXISTYPE
    if kz_s and not kx_s:
        axis = frame_codes.ZONLY
    if (kz_s and kz_neg) or (kx_s and kx_neg):
        axis = frame_codes.BISECTOR
    if kx_s and kx_neg and ky_s and ky_neg:
        axis = frame_codes.ZBISECT
    if kz_s and kz_neg and kx_s and kx_neg and ky_s and ky_neg:
        axis = frame_codes.THREEFOLD
    return axis, (kz_s, kx_s, ky_s)


def read_ffxml(path: str):
    """Parse the force-field XML.

    Returns (atom_templates, residue_templates) where atom templates carry
    multipoles (Cartesian, in the XML's nm-based units), polarizabilities,
    Thole widths and resolved axis types.
    """
    root = ET.parse(path).getroot()

    residue_templates = []
    atom_templates = []
    by_type = {}

    for res in root.iter("Residue"):
        atoms = []
        for atom in res.findall("Atom"):
            tmpl = AtomTemplate(name=atom.get("name"), type=atom.get("type"))
            atoms.append(tmpl)
            atom_templates.append(tmpl)
            by_type.setdefault(tmpl.type, []).append(tmpl)
        bonds = [
            (int(b.get("from")), int(b.get("to"))) for b in res.findall("Bond")
        ]
        residue_templates.append(
            ResidueTemplate(name=res.get("name"), atoms=atoms, bonds=bonds)
        )

    # Multipoles appear as <Multipole> tags (MPIDForce schema,
    # examples/water_1024/mpidwater.xml:27) or as <Atom c0=...> children of
    # <ADMPPmeForce> (examples/openmm_api/forcefield.xml:24, parsed by the
    # reference at admp/api.py:295-302). Handle both.
    multipole_elems = list(root.iter("Multipole"))
    for force_elem in root.iter("ADMPPmeForce"):
        multipole_elems.extend(
            a for a in force_elem.findall("Atom") if a.get("c0") is not None
        )
    for mp in multipole_elems:
        ttype = mp.get("type")
        entry = {k: float(mp.get(k, "0")) for k in _MULTIPOLE_FLOATS}
        octs = {k: float(mp.get(k, "0")) for k in _OCTUPOLE_FLOATS}
        if any(v != 0.0 for v in octs.values()):
            warnings.warn(
                "Octupole components present in XML are not used (engine "
                "truncates at quadrupole, as the reference does silently: "
                "admp/parser.py:294-303)."
            )
        anchors = {k: mp.get(k, "") for k in ("kz", "kx", "ky")}
        axis_type, stripped = classify_axis(
            anchors["kz"], anchors["kx"], anchors["ky"]
        )
        for tmpl in by_type.get(ttype, []):
            tmpl.multipole = entry
            tmpl.anchors = anchors
            tmpl.axis_type = axis_type
            tmpl.axis_anchor_types = stripped

    for pol in root.iter("Polarize"):
        ttype = pol.get("type")
        entry = {
            "polarizabilityXX": float(pol.get("polarizabilityXX", "0")),
            "polarizabilityYY": float(pol.get("polarizabilityYY", "0")),
            "polarizabilityZZ": float(pol.get("polarizabilityZZ", "0")),
            "thole": float(pol.get("thole", "0")),
        }
        for tmpl in by_type.get(ttype, []):
            tmpl.polarize = entry

    return atom_templates, residue_templates
