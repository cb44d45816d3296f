"""Constants of the force call kept on the device.

A tensor built on the host and copied to a CUDA device is a copy from the
host's pageable memory, and PyTorch makes the stream drain before it: the
host then waits for every kernel queued ahead of it. The force call's
constants (the grid sizes, the stencil's term index, the Hermitian weights,
the tile sizes, kappa, the self energy's factors, the DFT matrices) are the
same in every step, so each is built on the host once per key and kept on
the device. The key holds the values the constant is built from, its dtype
and its device; the constants are small and their keys few (a run's grids,
kappa, dtypes), so the store is not bounded.

A stored tensor is shared by every caller and is read only: nothing may
write it in place (an operation that saves it for the backward would then
also raise). It is built outside inference mode and without autograd, so a
first call under ``torch.inference_mode()`` does not make it an inference
tensor that a later differentiated call could not save.
"""

from __future__ import annotations

import torch

_STORE = {}  # (key, dtype, device) -> tensor


def device_constant(key, make, dtype, device):
    """The tensor of ``make()`` (a number, a nested sequence or an array,
    built on the host) as ``dtype`` on ``device``: built and copied at the
    first call with ``key`` (hashable, holding every value ``make`` reads),
    the same tensor at every later one."""
    device = torch.device(device)
    full = (key, dtype, device)
    out = _STORE.get(full)
    if out is None:
        with torch.inference_mode(False), torch.no_grad():
            out = torch.as_tensor(make(), dtype=dtype).to(device)
        out = _STORE.setdefault(full, out)
    return out


def device_values(values, dtype, device):
    """The numbers ``values`` (a sequence: grid or tile sizes, kappa) as a
    1-D ``dtype`` tensor on ``device``, keyed by the numbers; a tensor
    passes through ``torch.as_tensor``."""
    if torch.is_tensor(values):
        return torch.as_tensor(values, dtype=dtype, device=device)
    values = tuple(values)
    return device_constant(("values", values), lambda: values, dtype, device)
