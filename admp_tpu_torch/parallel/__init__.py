"""The sharded layer on torch.distributed (admp_tpu/parallel)."""

from admp_tpu_torch.parallel.fft import fft3d_pencil, rfft3d_pencil
from admp_tpu_torch.parallel.sharded import (
    make_sharded_batch_energy,
    make_sharded_disp_energy,
    make_sharded_ff_energy,
    make_sharded_pairwise_energy,
    make_sharded_pme_energy,
    make_sharded_pol_energy,
)

__all__ = [
    "fft3d_pencil",
    "rfft3d_pencil",
    "make_sharded_batch_energy",
    "make_sharded_disp_energy",
    "make_sharded_ff_energy",
    "make_sharded_pairwise_energy",
    "make_sharded_pme_energy",
    "make_sharded_pol_energy",
]
