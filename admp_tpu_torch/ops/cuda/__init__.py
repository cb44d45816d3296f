"""Hand-written CUDA kernels of the port (sources in admp_tpu_torch/csrc) and
their wrappers, each beside its plain PyTorch version."""

from __future__ import annotations

import torch

METHODS = ("auto", "cuda", "torch")


def use_kernel(method: str, x: torch.Tensor, what: str) -> bool:
    """Dispatch rule shared by every kernel wrapper.

    ``'auto'``: the kernel for a float32 CUDA tensor, the plain version
    otherwise (admp_tpu never takes Pallas in float64 either).
    ``'cuda'``: the kernel; raises for a tensor it cannot take.
    ``'torch'``: the plain version.
    """
    if method == "torch":
        return False
    if method == "cuda":
        if not x.is_cuda:
            raise ValueError(f"{what}='cuda' needs CUDA tensors, got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{what}='cuda' needs float32, got {x.dtype}")
        return True
    if method != "auto":
        raise ValueError(f"{what}={method!r}: expected one of {METHODS}")
    return x.is_cuda and x.dtype == torch.float32
