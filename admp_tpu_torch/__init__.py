"""admp_tpu_torch: the PyTorch/CUDA port of admp_tpu for one NVIDIA H100.

It runs the multipolar PME energy+force step, fixed or with Thole-polarizable
induced dipoles (PCG or Jacobi SCF; Feynman-Hellmann or exact implicit-adjoint
gradients, the adjoint optionally warm-started), the full force field of
dispersion PME (C6/C8/C10) and Tang-Toennies short range beside it, dense and
cell neighbor lists, dense or sparse exclusion tables for large boxes, the
XML/PDB front end (``Hamiltonian``, io/), molecular dynamics with bonded
terms (md.py: NVE, Langevin, the MC barostat) and force-field fitting
(fitting.py, checkpoint.py) and admp_tpu's precision modes
(EngineConfig.high_accuracy(), ds_accuracy(): float64 exclusion, near-pair
and all-pair real-space passes, float64 spread weights, the f64 and f64-dft
reciprocal paths and the double-single reciprocal engine of ops/dsrecip.py),
and the sharded layer on torch.distributed (parallel/: halo-exchange
spreading, the pencil FFT, the sharded energy factories, utils/comm.py;
sharded_cell_pairs; entry.py's single-device step and multi-rank dry run),
with its pair, spread and gather stages on
hand-written CUDA kernels (ops/cuda, sources in csrc/) for float32 tensors on
the card, and on plain PyTorch elsewhere. The entry points work on the card
unless the caller asks for the CPU. admp_tpu (JAX) is the reference it is
held against; this package never imports JAX.
"""

from admp_tpu_torch.settings import EngineConfig, SCFConfig
from admp_tpu_torch.ops.ewald import setup_ewald_parameters
from admp_tpu_torch.ops.harmonics import (
    convert_cart2harm,
    convert_harm2cart,
    harm_dipole_to_cart,
    quad_harm_to_tensor,
    quad_tensor_to_harm,
    rot_dipole_global2local,
    rot_global2local,
    rot_local2global,
)
from admp_tpu_torch.ops.neighborlist import (
    NeighborList,
    neighbor_list_cell,
    neighbor_list_dense,
    refresh_neighbor_list,
    sharded_cell_pairs,
    update_neighbor_list,
)
from admp_tpu_torch.ops.shortrange import (
    distribute_dispcoeff,
    distribute_multipoles,
    distribute_scalar,
    distribute_v3,
    generate_pairwise_interaction,
    tt_damping_qq_c6_kernel,
)
from admp_tpu_torch.models.dispersion import ADMPDispPmeForce, energy_disp_pme
from admp_tpu_torch.models.pme import ADMPPmeForce, energy_pme
from admp_tpu_torch.md import (
    BAR_TO_KJMOL_A3,
    MDState,
    make_langevin_step,
    make_mc_barostat,
    make_nve_step,
    run_langevin,
    run_nve,
)
from admp_tpu_torch.api import Hamiltonian
from admp_tpu_torch.systems import water_system
from admp_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from admp_tpu_torch.fitting import FitResult, energy_force_loss, fit, stack_batch
from admp_tpu_torch.parallel import (
    fft3d_pencil,
    make_sharded_batch_energy,
    make_sharded_disp_energy,
    make_sharded_ff_energy,
    make_sharded_pairwise_energy,
    make_sharded_pme_energy,
    make_sharded_pol_energy,
    rfft3d_pencil,
)
from admp_tpu_torch.utils.constants import DIELECTRIC

# the reference's name (admp/pairwise.py:94)
TT_damping_qq_c6_kernel = tt_damping_qq_c6_kernel

__all__ = [
    "ADMPDispPmeForce",
    "ADMPPmeForce",
    "BAR_TO_KJMOL_A3",
    "DIELECTRIC",
    "EngineConfig",
    "FitResult",
    "Hamiltonian",
    "MDState",
    "NeighborList",
    "SCFConfig",
    "TT_damping_qq_c6_kernel",
    "convert_cart2harm",
    "convert_harm2cart",
    "distribute_dispcoeff",
    "distribute_multipoles",
    "distribute_scalar",
    "distribute_v3",
    "energy_disp_pme",
    "energy_force_loss",
    "energy_pme",
    "fft3d_pencil",
    "fit",
    "generate_pairwise_interaction",
    "harm_dipole_to_cart",
    "make_langevin_step",
    "make_mc_barostat",
    "make_nve_step",
    "make_sharded_batch_energy",
    "make_sharded_disp_energy",
    "make_sharded_ff_energy",
    "make_sharded_pairwise_energy",
    "make_sharded_pme_energy",
    "make_sharded_pol_energy",
    "neighbor_list_cell",
    "neighbor_list_dense",
    "quad_harm_to_tensor",
    "quad_tensor_to_harm",
    "refresh_neighbor_list",
    "restore_checkpoint",
    "rfft3d_pencil",
    "rot_dipole_global2local",
    "rot_global2local",
    "rot_local2global",
    "run_langevin",
    "run_nve",
    "save_checkpoint",
    "setup_ewald_parameters",
    "sharded_cell_pairs",
    "stack_batch",
    "tt_damping_qq_c6_kernel",
    "update_neighbor_list",
    "water_system",
]
