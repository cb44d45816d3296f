"""Distributed 3D FFT: pencil decomposition with one all_to_all transpose
(admp_tpu/parallel/fft.py).

The mesh is sharded over its leading axis; the FFT runs as
    local FFT over (K2, K3) -> all_to_all (K1-shard -> K2-shard)
    -> local FFT over K1,
and returns the transposed pencil layout (K1, K2/P, ...), in which a
diagonal k-space multiply needs no transpose back. Differentiable: the
all_to_all's backward is the reverse all_to_all (utils/comm.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from admp_tpu_torch.utils.comm import all_to_all


def fft3d_pencil(local_slab, group=None):
    """Forward 3D FFT of a grid sharded over its leading axis: the local
    (K1/P, K2, K3) real or complex block -> this rank's (K1, K2/P, K3)
    block of the full FFT, sharded over the second axis."""
    cdtype = (torch.complex64 if local_slab.dtype in (torch.float32,
                                                      torch.complex64)
              else torch.complex128)
    x = torch.fft.fftn(local_slab.to(cdtype), dim=(1, 2))
    x = all_to_all(x, 1, 0, group)
    return torch.fft.fft(x, dim=0)


def rfft3d_pencil(local_slab, group=None):
    """Real-input :func:`fft3d_pencil`: the half spectrum of the last axis,
    (K1, K2/P, K3//2 + 1), for Parseval sums with Hermitian multiplicity
    weights (ops/reciprocal._hermitian_weights).

    admp_tpu packs even and odd samples into a half-length complex FFT
    (fft.py:47-81) because its rfft primitive mis-tracks under shard_map's
    varying-axes bookkeeping; torch has no such bookkeeping, so the port
    takes ``torch.fft.rfft``: the same half spectrum, and the same
    all_to_all payload."""
    x = torch.fft.rfft(local_slab, dim=2)
    x = torch.fft.fft(x, dim=1)
    x = all_to_all(x, 1, 0, group)
    return torch.fft.fft(x, dim=0)


def local_slab_index(group=None) -> int:
    """Index of this rank's slab along the sharded axis."""
    return dist.get_rank(group)
