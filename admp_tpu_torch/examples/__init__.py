"""The user's scripts of admp_tpu (examples/), ported: each runs as

    python -m admp_tpu_torch.examples.run_water --nmol 1000 --polarizable
    python -m admp_tpu_torch.examples.run_npt --nmol 1000
    python -m admp_tpu_torch.examples.fit_params
    python -m admp_tpu_torch.examples.fluctuating_multipoles --n-side 32

with admp_tpu's flags, on the card; ``--cpu`` asks for the CPU, and without
a card and without ``--cpu`` a script raises. Each module's ``run`` (for
fit_params: ``main`` and ``multi_config``) returns the numbers it prints as
a dict, with ``method`` ('auto': the kernels for float32 on the card;
'torch': the plain versions) and ``log`` keywords for callers that are not
the command line. Every time a script prints stands beside the device it
ran on: the card's name and power limit as nvidia-smi reads them.
"""

from __future__ import annotations

import subprocess

import torch

from admp_tpu_torch.ops.cuda import resolve_device


def script_device(cpu: bool) -> torch.device:
    """The card unless ``cpu``; raises without a card (no fallback)."""
    return resolve_device("cpu" if cpu else "cuda")


def device_label(device) -> str:
    """The card's name and power limit (nvidia-smi) for a CUDA device, the
    word 'cpu' for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def tensor(x, device, dtype):
    """A numpy array (or tensor) as a tensor of ``dtype`` on ``device``,
    copied, never sharing numpy's buffer."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, device=device, dtype=dtype)
