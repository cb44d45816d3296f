"""Hand-written CUDA kernels of the port (sources in admp_tpu_torch/csrc) and
their wrappers, each beside its plain PyTorch version."""

from __future__ import annotations

import torch

METHODS = ("auto", "cuda", "torch")
# the spread also takes 'cuda2d', the tiled pair (K5 spread, K7 gather), the
# port's name for admp_tpu's 'pallas2d'
SPREAD_METHODS = ("auto", "cuda", "cuda2d", "torch")


def resolve_device(device) -> torch.device:
    """The device an entry point works on. The entry points default to
    ``'cuda'``; without a CUDA device that raises here, and the caller must
    ask for the CPU by name: there is no silent fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return device


def use_kernel(method: str, x: torch.Tensor, what: str,
               methods=METHODS) -> bool:
    """Dispatch rule shared by every kernel wrapper.

    ``'auto'``: the kernel for a float32 CUDA tensor, the plain version
    otherwise (admp_tpu never takes Pallas in float64 either).
    ``'cuda'`` (and, for the spread, ``'cuda2d'``): a kernel; raises for a
    tensor it cannot take.
    ``'torch'``: the plain version.
    """
    if method not in methods:
        raise ValueError(f"{what}={method!r}: expected one of {methods}")
    if method == "torch":
        return False
    if method == "auto":
        return x.is_cuda and x.dtype == torch.float32
    if not x.is_cuda:
        raise ValueError(f"{what}={method!r} needs CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}={method!r} needs float32, got {x.dtype}")
    return True
