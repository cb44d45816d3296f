"""admp_tpu_torch: the PyTorch/CUDA port of admp_tpu for one NVIDIA H100.

It runs the multipolar PME energy+force step, fixed or with Thole-polarizable
induced dipoles (Feynman-Hellmann or exact implicit-adjoint gradients), and
force-field fitting (fitting.py, checkpoint.py), with its pair, spread and
gather stages on hand-written CUDA kernels (ops/cuda, sources in csrc/) for
float32 tensors on the card, and on plain PyTorch elsewhere. admp_tpu (JAX) is the reference it is held against;
this package never imports JAX.
"""

from admp_tpu_torch.settings import EngineConfig, SCFConfig
from admp_tpu_torch.ops.harmonics import convert_cart2harm
from admp_tpu_torch.ops.neighborlist import NeighborList, neighbor_list_dense
from admp_tpu_torch.models.pme import ADMPPmeForce
from admp_tpu_torch.systems import water_system
from admp_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from admp_tpu_torch.fitting import FitResult, energy_force_loss, fit, stack_batch

__all__ = [
    "ADMPPmeForce",
    "EngineConfig",
    "FitResult",
    "NeighborList",
    "SCFConfig",
    "convert_cart2harm",
    "energy_force_loss",
    "fit",
    "neighbor_list_dense",
    "restore_checkpoint",
    "save_checkpoint",
    "stack_batch",
    "water_system",
]
