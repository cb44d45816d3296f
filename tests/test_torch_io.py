"""The port's XML/PDB readers and topology assembly (admp_tpu_torch/io)
against admp_tpu's (admp_tpu/io) on the same files: every structure exactly
equal."""

import dataclasses
import itertools
import warnings

import numpy as np
import pytest

from admp_tpu.io import ffxml as j_ffxml
from admp_tpu.io import pdb as j_pdb
from admp_tpu.io import topology as j_topo
from admp_tpu_torch.io import ffxml as t_ffxml
from admp_tpu_torch.io import pdb as t_pdb
from admp_tpu_torch.io import topology as t_topo
from admp_tpu_torch.systems import (water_ff_xml, water_lattice,
                                    write_water_inputs, write_water_pdb)

# the MPIDForce schema: <Multipole> tags, one with an octupole
MPID_XML = """<ForceField>
 <Residues>
  <Residue name="HOH">
   <Atom name="O" type="380"/>
   <Atom name="H1" type="381"/>
   <Atom name="H2" type="381"/>
   <Bond from="0" to="1"/>
   <Bond from="0" to="2"/>
  </Residue>
 </Residues>
 <MPIDForce coulomb14scale="1.0">
  <Multipole type="380" kz="-381" kx="-381" c0="-1.0614" dX="0.0" dY="0.0"
   dZ="-0.023671684" qXX="0.000150963" qXY="0.0" qYY="0.00008707" qXZ="0.0"
   qYZ="0.0" qZZ="-0.000238034" oXXX="%s"/>
  <Multipole type="381" kz="380" kx="381" c0="0.5307" dX="-0.00204485"
   dY="0" dZ="-0.00474058" qXX="-3.42849e-05" qXY="0" qYY="-0.000100865"
   qXZ="-1.89854e-05" qYZ="0" qZZ="0.00013515"/>
  <Polarize type="380" polarizabilityXX="0.00088" polarizabilityYY="0.00088"
   polarizabilityZZ="0.00088" thole="8.0"/>
  <Polarize type="381" polarizabilityXX="0" polarizabilityYY="0"
   polarizabilityZZ="0" thole="0"/>
 </MPIDForce>
</ForceField>
"""


def _fields(obj):
    return dataclasses.asdict(obj)


def _same(a, b):
    """Exact equality of nested dataclass fields (arrays element by
    element)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _read_both_pdb(path):
    j, t = j_pdb.read_pdb(str(path)), t_pdb.read_pdb(str(path))
    _same(_fields(j), _fields(t))
    assert np.array_equal(j.box_matrix(), t.box_matrix())
    assert j.conect_bonds() == t.conect_bonds()
    return t


@pytest.mark.parametrize("angles", [(90.0, 90.0, 90.0), (80.0, 95.0, 100.0),
                                    (90.0, 90.0, 120.0)])
def test_read_pdb_cryst1_and_conect(tmp_path, angles):
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    path = tmp_path / "box.pdb"
    write_water_pdb(path, positions, box)
    text = path.read_text().splitlines()
    k = next(n for n, line in enumerate(text) if line.startswith("CRYST1"))
    text[k] = "CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1" % (
        6.2, 6.5, 7.0, *angles)
    text.insert(-1, "CONECT    1    4")
    text.insert(-1, "CONECT    2    1")
    path.write_text("\n".join(text) + "\n")
    t = _read_both_pdb(path)
    assert t.conect_bonds() == [(0, 1), (0, 3)]
    assert len(t.names) == 24
    m = t.box_matrix()
    assert np.allclose(np.linalg.norm(m, axis=1), [6.2, 6.5, 7.0])


def test_read_pdb_models_orig_and_serials(tmp_path):
    """MODEL/ENDMDL (the first model only; CONECT after it still counts),
    ORIGX transforms and serials that do not start at 1."""
    path = tmp_path / "multi.pdb"
    path.write_text(
        "CRYST1   10.000   10.000   10.000  90.00  90.00  90.00 P 1\n"
        "ORIGX1      1.000000  0.000000  0.000000        0.50000\n"
        "MODEL        1\n"
        "HETATM   11  O   HOH A   1       1.000   1.000   1.000  1.00  0.00"
        "           O\n"
        "HETATM   12  H1  HOH A   1       1.900   1.000   1.000  1.00  0.00"
        "           H\n"
        "ENDMDL\n"
        "MODEL        2\n"
        "HETATM   11  O   HOH A   1       5.000   5.000   5.000  1.00  0.00"
        "           O\n"
        "ENDMDL\n"
        "CONECT   11   12\n"
        "END\n")
    t = _read_both_pdb(path)
    assert len(t.names) == 2 and t.conect_bonds() == [(0, 1)]
    assert t.positions[0, 0] == 1.5


@pytest.mark.parametrize("octupole", ["0.0", "0.001"])
def test_read_ffxml_multipole_schema(tmp_path, octupole):
    path = tmp_path / "mpid.xml"
    path.write_text(MPID_XML % octupole)
    with warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter("always")
        j = j_ffxml.read_ffxml(str(path))
    with warnings.catch_warnings(record=True) as w_t:
        warnings.simplefilter("always")
        t = t_ffxml.read_ffxml(str(path))
    n_warn = int(octupole != "0.0")
    assert len([x for x in w_j if "Octupole" in str(x.message)]) == n_warn
    assert len([x for x in w_t if "Octupole" in str(x.message)]) == n_warn
    _same([_fields(a) for a in j[0]], [_fields(a) for a in t[0]])
    _same([_fields(r) for r in j[1]], [_fields(r) for r in t[1]])
    assert t[0][0].axis_type == t_ffxml.frame_codes.BISECTOR


def test_read_ffxml_admp_schema(tmp_path):
    """The <Atom c0=...> children of <ADMPPmeForce> (the Hamiltonian's
    file)."""
    path = tmp_path / "ff.xml"
    path.write_text(water_ff_xml())
    j, t = j_ffxml.read_ffxml(str(path)), t_ffxml.read_ffxml(str(path))
    _same([_fields(a) for a in j[0]], [_fields(a) for a in t[0]])
    _same([_fields(r) for r in j[1]], [_fields(r) for r in t[1]])
    assert [a.type for a in t[0]] == ["380", "381", "381"]


def test_classify_axis_every_combination():
    signs = ["", "A", "-A"]
    for kz, kx, ky in itertools.product(signs, repeat=3):
        assert j_ffxml.classify_axis(kz, kx, ky) == \
            t_ffxml.classify_axis(kz, kx, ky), (kz, kx, ky)


def test_assemble_system_with_conect(tmp_path):
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    xml, pdb = write_water_inputs(tmp_path, positions, box)
    lines = open(pdb).read().splitlines()
    lines.insert(-1, "CONECT    1    4")
    open(pdb, "w").write("\n".join(lines) + "\n")
    systems = []
    for io_pdb, io_ff, topo in ((j_pdb, j_ffxml, j_topo),
                                (t_pdb, t_ffxml, t_topo)):
        atoms, residues = io_ff.read_ffxml(xml)
        systems.append(topo.assemble_system(io_pdb.read_pdb(pdb), atoms,
                                            residues, covalent_depth=6))
    _same(_fields(systems[0]), _fields(systems[1]))
    cov = systems[1].covalent_map
    assert cov[0, 3] == 1 and cov[0, 4] == 2 and cov[1, 3] == 2


def test_write_water_inputs_refuses_more_than_9999_waters(tmp_path):
    """A PDB numbers residues in four columns."""
    with pytest.raises(ValueError, match="9,999"):
        write_water_inputs(tmp_path, np.zeros((3 * 10000, 3)), np.eye(3))
    assert not list(tmp_path.iterdir())


def test_load_mpid_system(tmp_path):
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=5)
    xml = tmp_path / "mpid.xml"
    xml.write_text(MPID_XML % "0.0")
    pdb = tmp_path / "w.pdb"
    write_water_pdb(pdb, positions, box)
    for depth in (4, 6):
        j = j_topo.load_mpid_system(str(pdb), str(xml), depth)
        t = t_topo.load_mpid_system(str(pdb), str(xml), depth)
        _same(_fields(j), _fields(t))


def test_covalent_map_on_a_ring():
    """A six-ring with a three-atom tail and a second ring fused on: BFS
    distances, cut at each depth."""
    bonds = [(k, (k + 1) % 6) for k in range(6)] + [(0, 6), (6, 7), (7, 8)]
    bonds += [(3, 9), (9, 10), (10, 4)]
    for depth in (1, 3, 6):
        j = j_topo.build_covalent_map_from_bonds(bonds, 12, depth)
        t = t_topo.build_covalent_map_from_bonds(bonds, 12, depth)
        _same(np.asarray(j), t)
    assert t[0, 3] == 3 and t[8, 4] == 5
