"""Optional OpenMM interop adapter (admp_tpu/contrib/openmm.py).

``Hamiltonian`` here subclasses ``openmm.app.ForceField`` so an
``openmm.app.Topology`` can feed the port's front end: the topology becomes
the engine's flat-array ``System`` and goes to the same generators as the
native path (admp_tpu_torch/api.py), so the potentials are the same
differentiable functions.

Import-guarded: importing this module without openmm raises ImportError;
nothing else in admp_tpu_torch depends on it.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import openmm  # noqa: F401
    from openmm import app as _app
except ImportError as _exc:  # only without openmm
    raise ImportError(
        "admp_tpu_torch.contrib.openmm requires the 'openmm' package; the "
        "core engine does not — use admp_tpu_torch.api.Hamiltonian for the "
        "OpenMM-free front end."
    ) from _exc

from admp_tpu_torch.api import Hamiltonian as _NativeHamiltonian
from admp_tpu_torch.io.pdb import PDBData
from admp_tpu_torch.io.topology import assemble_system

_NM_TO_ANGSTROM = 10.0


def _pdb_data_from_topology(topology) -> PDBData:
    """An openmm.app.Topology as the engine's PDBData view; its bonds become
    CONECT-style connectivity."""
    names, res_names, res_seqs = [], [], []
    index_of = {}
    for atom in topology.atoms():
        index_of[atom] = len(names)
        names.append(atom.name)
        res_names.append(atom.residue.name)
        res_seqs.append(atom.residue.index)
    connects = {}
    for a, b in topology.bonds():
        i, j = index_of[a], index_of[b]
        connects.setdefault(i, []).append(j)
        connects.setdefault(j, []).append(i)

    vecs = topology.getPeriodicBoxVectors()
    if vecs is None:
        raise ValueError("topology has no periodic box vectors")
    m = np.array([[v.x, v.y, v.z] for v in vecs], dtype=float) * _NM_TO_ANGSTROM
    # cell parameters (a, b, c, alpha, beta, gamma) from the row vectors
    la, lb, lc = (np.linalg.norm(m[i]) for i in range(3))

    def _ang(u, v):
        return float(np.degrees(np.arccos(
            np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)))))

    n = len(names)
    # ``connects`` is keyed by atom index, so the "file serials" that
    # PDBData.conect_bonds resolves are the indices themselves (admp_tpu's
    # adapter leaves them unset, and conect_bonds then fails)
    return PDBData(
        serials=list(range(n)), names=names, res_names=res_names,
        res_seqs=res_seqs, positions=np.zeros((n, 3)), charges=[0.0] * n,
        connects=connects,
        box=[la, lb, lc, _ang(m[1], m[2]), _ang(m[0], m[2]), _ang(m[0], m[1])],
        file_serials=list(range(n)))


class Hamiltonian(_app.forcefield.ForceField):
    """``openmm.app.ForceField`` subclass exposing the port's potentials::

        H = Hamiltonian('forcefield.xml', device='cuda')
        potentials = H.createPotential(pdb.topology, nonbondedCutoff=4.0)
        E = potentials[0](positions, box, pairs, H.getGenerators()[0].params)

    Distances are Angstrom on the engine side.
    """

    def __init__(self, *xml_files, device="cuda", dtype=torch.float32):
        # OpenMM parses the XML for its own bookkeeping; no-op parsers keep
        # it from rejecting the ADMP tags, which the native generators read
        for tag in ("ADMPDispForce", "ADMPPmeForce"):
            _app.forcefield.parsers.setdefault(tag, lambda *a, **k: None)
        super().__init__(*xml_files)
        self._native = _NativeHamiltonian(xml_files[0], device=device,
                                          dtype=dtype)

    def getGenerators(self):
        return self._native.getGenerators()

    def createPotential(self, topology, nonbondedCutoff=10.0):
        """Potentials for an OpenMM topology. ``nonbondedCutoff`` in
        Angstrom (float) or an openmm Quantity (converted from nm)."""
        from openmm import unit

        if unit.is_quantity(nonbondedCutoff):
            nonbondedCutoff = (nonbondedCutoff.value_in_unit(unit.nanometer)
                               * _NM_TO_ANGSTROM)
        native = self._native
        pdb_data = _pdb_data_from_topology(topology)
        self._system = assemble_system(pdb_data, native._atom_templates,
                                       native._residue_templates,
                                       covalent_depth=6)
        return native.createPotentialFromSystem(
            self._system, native.types_of(pdb_data), nonbondedCutoff)
