"""The XML/PDB front end's readers (admp_tpu/io), numpy only."""

from admp_tpu_torch.io.ffxml import read_ffxml
from admp_tpu_torch.io.pdb import read_pdb
from admp_tpu_torch.io.topology import (
    System,
    assemble_system,
    build_covalent_map_from_bonds,
    load_mpid_system,
)

__all__ = [
    "System",
    "assemble_system",
    "build_covalent_map_from_bonds",
    "load_mpid_system",
    "read_ffxml",
    "read_pdb",
]
