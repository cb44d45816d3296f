"""Operation counts on the host, frozen from chip_smoke.count_ops: for each
aten op of a plain PyTorch function that is not a data movement, the size of
its largest operand or result. An elementwise op counts one operation per
element, a transcendental one too, so the count is a lower bound of the
float32 operations the same arithmetic needs."""

from __future__ import annotations

import torch

# aten ops that only move, view or make data: they do no arithmetic
MOVES = frozenset("""
_to_copy _unsafe_view alias arange as_strided cat clone contiguous copy_
detach empty empty_like expand expand_as fill_ full full_like index
index_select lift_fresh lift_fresh_copy narrow new_empty new_full new_ones
new_zeros ones ones_like permute reshape scalar_tensor select
select_backward slice slice_backward split split_with_sizes squeeze stack t
transpose unbind unsqueeze view zero_ zeros zeros_like
""".split())


def count_ops(fn):
    """The arithmetic operations of ``fn()``, counted by dispatch."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in MOVES:
                leaves = tree_flatten((args, kwargs, out))[0]
                total[0] += max((t.numel() for t in leaves
                                 if isinstance(t, torch.Tensor)), default=0)
            return out

    with Count():
        fn()
    return total[0]
