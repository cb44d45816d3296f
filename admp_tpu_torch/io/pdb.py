"""Minimal PDB reader for force-field systems (admp_tpu/io/pdb.py, numpy
only).

Fixed-column ATOM/HETATM records, the CRYST1 cell (triclinic too), CONECT
bonds, ORIGX transforms, and MODEL/ENDMDL files (first model only). Returns
plain numpy arrays; serials are re-based to 0..N-1 in file order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PDBData:
    serials: list
    names: list
    res_names: list
    res_seqs: list
    positions: np.ndarray
    charges: list
    connects: dict
    box: list  # (a, b, c, alpha, beta, gamma)
    # original file serial column (CONECT records reference these; rebased
    # indices in ``serials`` are file order, which only coincides with the
    # serial column for 1..N-numbered files)
    file_serials: list = dataclasses.field(default_factory=list)

    def conect_bonds(self) -> list:
        """CONECT records as 0-based (i, j) index pairs, deduplicated.

        The reference parses CONECT lines but never feeds them to its
        covalent-map construction (admp/parser.py:111-113); here they become real
        bonds so non-template connectivity (ligands, cross-links) carries
        exclusion scaling.
        """
        idx_by_serial = {
            s: k for k, s in enumerate(self.file_serials) if s is not None
        }
        out = set()
        for s_a, partners in self.connects.items():
            ia = idx_by_serial.get(s_a)
            if ia is None:
                continue
            for s_b in partners:
                ib = idx_by_serial.get(s_b)
                if ib is None or ib == ia:
                    continue
                out.add((min(ia, ib), max(ia, ib)))
        return sorted(out)

    def box_matrix(self) -> np.ndarray:
        """Box matrix (lattice vectors in rows, Angstrom) from the CRYST1
        cell parameters, honouring the angles (general triclinic cells; the
        reference keeps only a, b, c and silently assumes orthorhombic,
        reference: admp/parser.py:104 + the example scripts' jnp.eye(3) * [lx,ly,lz]).

        Standard crystallographic convention: a along x, b in the xy plane.
        """
        a, b, c, alpha, beta, gamma = self.box
        if not all(abs(ang - 90.0) > 1e-9 for ang in (alpha, beta, gamma)):
            # any right angle handled by the general formula too; fast path
            # for the fully-orthorhombic (all-90) case keeps exact zeros
            if all(abs(ang - 90.0) < 1e-9 for ang in (alpha, beta, gamma)):
                return np.diag([a, b, c]).astype(float)
        ca = np.cos(np.radians(alpha))
        cb = np.cos(np.radians(beta))
        cg = np.cos(np.radians(gamma))
        sg = np.sin(np.radians(gamma))
        cx = c * cb
        cy = c * (ca - cb * cg) / sg
        cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
        return np.array(
            [[a, 0.0, 0.0], [b * cg, b * sg, 0.0], [cx, cy, cz]], dtype=float
        )


def read_pdb(path: str) -> PDBData:
    names, res_names, res_seqs, charges, positions = [], [], [], [], []
    file_serials = []
    connects = {}
    cellpar = [0.0] * 6
    orig = np.eye(3)
    trans = np.zeros(3)

    reading_atoms = True
    with open(path) as fh:
        for line in fh:
            rec = line[:6]
            if line.startswith("END"):
                # first model only (ENDMDL; bare END also accepted, matching
                # the reference's CP2K/VMD-style trajectory tolerance,
                # admp/parser.py:151-158) — CONECT records after it still count
                reading_atoms = False
                continue
            if rec == "CRYST1":
                cellpar = [
                    float(line[6:15]), float(line[15:24]), float(line[24:33]),
                    float(line[33:40]), float(line[40:47]), float(line[47:54]),
                ]
            elif rec.startswith("ORIGX"):
                row = int(rec[5]) - 1
                orig[row] = [float(line[10:20]), float(line[20:30]), float(line[30:40])]
                trans[row] = float(line[45:55])
            elif rec in ("ATOM  ", "HETATM") and reading_atoms:
                serial_field = line[6:11].strip()
                # non-numeric serials (hybrid-36, '*****' overflow past 99999)
                # become a None sentinel excluded from CONECT resolution — a
                # guessed fallback number could alias a genuine serial
                # elsewhere in the file and silently rebond the wrong atoms
                file_serials.append(
                    int(serial_field) if serial_field.isdigit() else None
                )
                names.append(line[12:16].strip())
                res_names.append(line[17:21].strip())
                res_seqs.append(int(line[22:26].split()[0]))
                xyz = np.array(
                    [float(line[30:38]), float(line[38:46]), float(line[46:54])]
                )
                positions.append(orig @ xyz + trans)
                charge_field = line[79:81].strip() if len(line) > 79 else ""
                charges.append(charge_field or 0)
            elif rec == "CONECT":
                fields = line.split()
                connects[int(fields[1])] = [int(f) for f in fields[2:]]

    return PDBData(
        serials=list(range(len(names))),
        names=names,
        res_names=res_names,
        res_seqs=res_seqs,
        positions=np.vstack(positions),
        charges=charges,
        connects=connects,
        box=cellpar,
        file_serials=file_serials,
    )
