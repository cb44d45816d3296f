"""The XML/PDB front end: a force-field XML -> differentiable potential
functions (admp_tpu/api.py).

``Hamiltonian(xml_path)`` reads the generators of the file
(``<ADMPDispForce>``: Tang-Toennies short range minus dispersion PME;
``<ADMPPmeForce>``: multipolar, optionally polarizable, PME) and its residue
templates; ``createPotential(pdb)`` assembles the topology and returns one
``potential_fn(positions, box, pairs, params)`` per generator, in the order
of the file, with each generator's parameters in ``generator.params``.

The generators keep admp_tpu's choices: ethresh 1e-5, pmax 10, the default
``EngineConfig()`` (so the exact implicit adjoint for a polarizable force),
``U_init=params["U_ind"]`` (zeros, or the dipoles of a ``ref_dip`` file: the
SCF starts cold on every call unless the caller changes it), and the unit
transforms of the XML's nm-based attributes.

One deliberate difference: the Hamiltonian builds its forces on ``device``
(the card unless the caller asks for the CPU, ``device='cpu'``) in
``dtype``, and raises without a card, as every entry point of the port does.
``generator.params`` holds tensors there. A potential is differentiable in
the positions and in every params tensor that requires grad, e.g.
``params = {k: v.requires_grad_() for k, v in gen.params.items()}`` then
``torch.autograd.grad(pot(positions, box, pairs, params), ...)``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from admp_tpu_torch.io.ffxml import read_ffxml
from admp_tpu_torch.io.pdb import read_pdb
from admp_tpu_torch.io.topology import (
    assemble_system,
    build_covalent_map_from_bonds,
)
from admp_tpu_torch.models.dispersion import ADMPDispPmeForce
from admp_tpu_torch.models.pme import ADMPPmeForce
from admp_tpu_torch.ops.cuda import resolve_device
from admp_tpu_torch.ops.harmonics import convert_cart2harm
from admp_tpu_torch.ops.shortrange import (
    generate_pairwise_interaction,
    tt_damping_qq_c6_kernel,
)

# the XML's nm-based attributes -> the engine's units (admp_tpu/api.py:38-41)
_HARTREE_KJ = 2625.5
_BOHR_NM = 0.0529177249


class ADMPDispGenerator:
    """Tang-Toennies short range minus dispersion PME
    (admp_tpu/api.py:44-105)."""

    def __init__(self, element, device, dtype):
        self.device, self.dtype = device, dtype
        self.ethresh = 1.0e-5
        self.pmax = 10
        self.params = {"mScales": self._tensor(
            [float(element.get("mScale1%d" % i)) for i in range(2, 7)])}
        self.types = []
        per_atom = {k: [] for k in ("A", "B", "Q", "C6", "C8", "C10")}
        for atom in element.findall("Atom"):
            self.types.append(atom.get("type"))
            for k in per_atom:
                per_atom[k].append(float(atom.get(k)))
        for k, v in per_atom.items():
            self.params[k] = self._tensor(v)
        self.types = np.array(self.types)
        self._potential = None

    def _tensor(self, values):
        return torch.tensor(np.asarray(values, dtype=np.float64),
                            device=self.device).to(self.dtype)

    def create_force(self, system, type_map, rc):
        map_idx = torch.as_tensor(
            np.array([int(np.where(self.types == t)[0][0]) for t in type_map]),
            device=self.device)
        covalent_map = build_covalent_map_from_bonds(system.bonds,
                                                     system.n_atoms, 6)
        force_lr = ADMPDispPmeForce(system.box, covalent_map, rc,
                                    self.ethresh, self.pmax,
                                    device=self.device, dtype=self.dtype)
        self.disp_pme_force = force_lr
        pot_sr = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                               covalent_map,
                                               device=self.device)

        def potential_fn(positions, box, pairs, params):
            positions, box = force_lr._float(positions), force_lr._float(box)
            pairs = force_lr._accept_pairs(pairs)
            m_scales = params["mScales"]
            a_list = params["A"][map_idx] / _HARTREE_KJ  # kJ/mol -> Hartree
            b_list = params["B"][map_idx] * _BOHR_NM     # nm^-1 -> Bohr^-1
            q_list = params["Q"][map_idx]
            c_list = torch.stack([
                torch.sqrt(params["C6"][map_idx] * 1e6),
                torch.sqrt(params["C8"][map_idx] * 1e8),
                torch.sqrt(params["C10"][map_idx] * 1e10),
            ], dim=-1)
            e_sr = pot_sr(positions, box, pairs, m_scales, a_list, b_list,
                          q_list, c_list[:, 0])
            e_lr = force_lr.get_energy(positions, box, pairs, c_list,
                                       m_scales)
            return e_sr - e_lr

        self._potential = potential_fn
        return potential_fn


class ADMPPmeGenerator:
    """Multipolar, optionally polarizable, PME (admp_tpu/api.py:108-170)."""

    def __init__(self, element, device, dtype):
        self.device, self.dtype = device, dtype
        self.ethresh = 1.0e-5
        self.lmax = int(element.get("lmax"))
        self.pmax = int(element.get("pmax"))
        self.params = {}
        for name in ("mScales", "pScales", "dScales"):
            prefix = name[0]
            self.params[name] = self._tensor(
                [float(element.get(f"{prefix}Scale1{i}")) for i in range(2, 7)])
        self.lpol = len(element.findall("Polarize")) > 0
        self.ref_dip = ""
        self._potential = None

    _tensor = ADMPDispGenerator._tensor

    def create_force(self, system, type_map, rc):
        del type_map  # the multipoles come with the assembled system
        covalent_map = build_covalent_map_from_bonds(system.bonds,
                                                     system.n_atoms, 6)
        self.params["Q_local"] = convert_cart2harm(
            self._tensor(system.q_cart), self.lmax)
        self.params["pol"] = self._tensor(system.pol)
        self.params["tholes"] = self._tensor(system.tholes)
        pme_force = ADMPPmeForce(system.box, system.axis_types,
                                 system.axis_indices, covalent_map, rc,
                                 self.ethresh, self.lmax, self.lpol,
                                 device=self.device, dtype=self.dtype)
        self.pme_force = pme_force
        u_init = np.zeros((system.n_atoms, 3))
        if self.ref_dip:
            u_init = np.loadtxt(self.ref_dip)[: system.n_atoms] * 10.0  # nm -> A
        self.params["U_ind"] = self._tensor(u_init)
        lpol = self.lpol

        def potential_fn(positions, box, pairs, params):
            m_scales = params["mScales"]
            q_loc = params["Q_local"]
            if lpol:
                return pme_force.get_energy(
                    positions, box, pairs, q_loc, params["pol"],
                    params["tholes"], m_scales, params["pScales"],
                    params["dScales"], U_init=params["U_ind"])
            return pme_force.get_energy(positions, box, pairs, q_loc, m_scales)

        self._potential = potential_fn
        return potential_fn


_GENERATOR_PARSERS = {
    "ADMPDispForce": ADMPDispGenerator,
    "ADMPPmeForce": ADMPPmeGenerator,
}


class Hamiltonian:
    """XML force field -> list of differentiable potentials
    (admp_tpu/api.py:179-265), built on ``device`` in ``dtype``."""

    def __init__(self, xml_path: str, device="cuda", dtype=torch.float32):
        self.xml_path = xml_path
        self.device = resolve_device(device)
        self.dtype = dtype
        root = ET.parse(xml_path).getroot()
        self._generators = []
        for child in root:
            parser = _GENERATOR_PARSERS.get(child.tag)
            if parser is not None:
                self._generators.append(parser(child, self.device, dtype))
        # atom templates for topology assembly come from the same file
        self._atom_templates, self._residue_templates = read_ffxml(xml_path)
        # atom names are unique only within a residue template: the type is
        # looked up by (residue name, atom name) first
        self._type_by_res_atom = {}
        for res in self._residue_templates:
            for t in res.atoms:
                self._type_by_res_atom[(res.name, t.name)] = t.type
        self._type_by_name = {t.name: t.type for t in self._atom_templates}
        self._potentials = []

    def getGenerators(self):
        return self._generators

    get_generators = getGenerators

    def createPotential(self, topology, nonbondedCutoff: float = 10.0):
        """Potentials for a PDB topology, one per generator in the file's
        order. ``topology``: a PDB path or a parsed ``io.pdb.PDBData``;
        ``nonbondedCutoff`` in Angstrom."""
        pdb_data = (topology if hasattr(topology, "res_names")
                    else read_pdb(topology))
        system = assemble_system(pdb_data, self._atom_templates,
                                 self._residue_templates, covalent_depth=6)
        return self.createPotentialFromSystem(system, self.types_of(pdb_data),
                                              nonbondedCutoff)

    create_potential = createPotential

    def types_of(self, pdb_data):
        """The force-field type of each atom of a ``PDBData``: by (residue
        name, atom name), else by atom name alone."""
        out = []
        for res_name, name in zip(pdb_data.res_names, pdb_data.names):
            ttype = self._type_by_res_atom.get((res_name, name))
            if ttype is None:
                ttype = self._type_by_name.get(name)
            if ttype is None:
                raise KeyError(
                    f"atom {name!r} in residue {res_name!r} matches no "
                    f"template in {self.xml_path}")
            out.append(ttype)
        return out

    def createPotentialFromSystem(self, system, type_map,
                                  nonbondedCutoff: float = 10.0):
        """Potentials for an assembled ``io.topology.System`` and an explicit
        per-atom force-field ``type_map``; the system's ``bonds`` drive the
        covalent maps."""
        self._system = system
        self._potentials = [gen.create_force(system, list(type_map),
                                             nonbondedCutoff)
                            for gen in self._generators]
        return list(self._potentials)

    create_potential_from_system = createPotentialFromSystem
