"""The C entry points of the kernels' libraries, as the launchers call them.

The launchers sit on every step of the 3000-atom paths, where a kernel's
device work (K6: ~3 us on the H100) is shorter than one PyTorch op's host
work, so they keep their own host work lean: the C entry point from a dict
once its library is loaded (no lock), the raw current stream of the tensor's
device (no torch.cuda.Stream object), and the call. The entry points are
called through a PyDLL view of their library without argtypes: a launch
only enqueues work, so it keeps the GIL, and pointers go as c_void_p, sizes
as Python ints (typed arguments cost more).
"""

from __future__ import annotations

import ctypes

import torch

from admp_tpu_torch.ops.cuda import build

# C entry point -> its library (csrc/<library>.cu)
LIBRARIES = {
    "admp_pair_fwd": "pairs", "admp_pair_bwd": "pairs",
    "admp_pair_block_size": "pairs",
    "admp_pair_hvp": "pair_hvp", "admp_pair_hvp_block_size": "pair_hvp",
    "admp_pair_third": "pair_third",
    "admp_pair_third_block_size": "pair_third",
    "admp_spread": "spread", "admp_gather": "spread",
    "admp_spread_tiled": "spread_tiled", "admp_gather_tiled": "spread_tiled",
    "admp_frames_fwd": "frames", "admp_frames_bwd": "frames",
    "admp_frames_block_size": "frames",
}
_entries = {}  # C entry point -> its ctypes function
# device index -> its current CUDA stream as an int (None in a CPU-only
# torch, where every launcher raises before it would be called)
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def entry(name: str):
    """The C entry point ``name`` (returning an int). The first call builds
    and loads its library (build.load); later calls read it from
    ``_entries``."""
    fn = _entries.get(name)
    if fn is None:
        lib = build.load(LIBRARIES[name])
        fn = getattr(ctypes.PyDLL(lib._name, handle=lib._handle), name)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn
