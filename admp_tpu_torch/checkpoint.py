"""Checkpoint/resume for fitting runs (admp_tpu/checkpoint.py, on torch.save).

A checkpoint is any nested structure of dicts, lists and tensors (parameters,
an optimizer's ``state_dict()``, induced dipoles, counters), written with
``torch.save`` to ``<directory>/step_%08d``. The file is written under a
temporary name and then renamed, so a reader never sees half a checkpoint;
saving a step again overwrites it, as admp_tpu's orbax save does with
``force=True``.
"""

from __future__ import annotations

import os
import pathlib
import re

import torch

_STEP = re.compile(r"step_(\d{8})")


def save_checkpoint(directory, state, step: int) -> str:
    """Save ``state`` as ``directory/step_<step>``; returns its path."""
    root = pathlib.Path(directory).absolute()
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"step_{step:08d}"
    tmp = root / f".{path.name}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return str(path)


def _like(value, template):
    """``value`` with each tensor moved to the device and dtype of the tensor
    at the same place in ``template``; places the template lacks keep what
    was saved."""
    if torch.is_tensor(value) and torch.is_tensor(template):
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(value, dict) and isinstance(template, dict):
        return {k: _like(v, template.get(k)) for k, v in value.items()}
    if (isinstance(value, (list, tuple)) and isinstance(template, (list, tuple))
            and len(value) == len(template)):
        return type(value)(_like(v, t) for v, t in zip(value, template))
    return value


def restore_checkpoint(directory, template=None, step: int | None = None):
    """Restore the latest (or the given) step. Returns (state, step), or
    (None, None) when there is none. With ``template``, each restored tensor
    takes the device and dtype of the template's tensor at its place."""
    root = pathlib.Path(directory).absolute()
    if not root.is_dir():
        return None, None
    steps = sorted(int(m.group(1)) for p in root.iterdir()
                   if (m := _STEP.fullmatch(p.name)))
    if not steps:
        return None, None
    chosen = steps[-1] if step is None else step
    state = torch.load(root / f"step_{chosen:08d}", map_location="cpu",
                       weights_only=True)
    return _like(state, template), chosen
