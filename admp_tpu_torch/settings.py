"""Engine configuration of the PyTorch port (counterpart of admp_tpu/settings.py).

The dataclasses keep admp_tpu's field names so a configuration reads the same
in both packages. Only what this port implements is accepted: any other value
of a field raises ``NotImplementedError`` naming the ROADMAP.md item that
brings it.

TPU-keyed ``'auto'`` choices resolve the way admp_tpu resolves them off the
TPU: ``fft_friendly_grid`` and ``lane_align_grid`` are False, i.e. the
heuristic grids of ops/ewald.setup_ewald_parameters.
"""

from __future__ import annotations

import dataclasses

import torch

from admp_tpu_torch.ops.cuda import METHODS

# admp_tpu pins its f32 matmuls to full precision because the TPU's default
# bf16 passes destroy the Ewald cancellations (admp_tpu/settings.py:27-36:
# water_1024 electrostatic energy 1644 vs 148 kJ/mol). The card's analogue is
# TF32, which keeps about three decimal digits: keep it off for matmuls and
# for cuDNN, so every f32 contraction in the port runs in full f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Induced-dipole SCF defaults (admp_tpu/settings.py:58-59).
POL_CONV = 10.0
MAX_N_POL = 30


def _not_implemented(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not implemented in admp_tpu_torch yet (ROADMAP.md {item})"
    )


@dataclasses.dataclass(frozen=True)
class SCFConfig:
    """Induced-dipole solver configuration (admp_tpu/settings.py:71-166).

    The port implements warm-started PCG with the Jacobi preconditioner,
    ``fixed_iters``, the exact implicit-function adjoint
    (``exact_adjoint=True``, with ``adjoint_tol`` and
    ``adjoint_fixed_iters``), Feynman-Hellmann gradients
    (``exact_adjoint=False``) and the reduced-cost matvec mesh
    (``matvec_spread_order``, ``matvec_grid_div``), on the plain path and on
    the CUDA kernels alike.
    """

    method: str = "pcg"
    max_iter: int = MAX_N_POL
    field_tol: float = POL_CONV
    fixed_iters: int | None = None
    adjoint_fixed_iters: int | None = None
    pol_eps: float = 0.001
    adjoint_tol: float = 1e-8
    exact_adjoint: bool = True
    matvec_spread_order: int | None = None
    matvec_grid_div: int = 1
    adjoint_warmstart: bool = False

    def __post_init__(self):
        if self.method != "pcg":
            _not_implemented(f"SCFConfig.method={self.method!r}", "queue 1, S7")
        if self.adjoint_warmstart:
            _not_implemented("SCFConfig.adjoint_warmstart", "queue 1, S7")

    @staticmethod
    def md():
        """Production MD profile (admp_tpu/settings.py:150-166):
        Feynman-Hellmann gradients at field_tol 0.3 and a PCG matvec on an
        order-4, half-resolution dipole mesh."""
        return SCFConfig(exact_adjoint=False, field_tol=0.3,
                         matvec_spread_order=4, matvec_grid_div=2)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration (admp_tpu/settings.py:169-290), restricted to the
    port's slice.

    pair_kernel / spread_method: ``'auto'`` runs the hand-written CUDA
    kernels (ops/cuda) for float32 tensors on a CUDA device and the plain
    PyTorch path otherwise (admp_tpu likewise never takes Pallas in float64);
    ``'cuda'`` forces the kernels and raises on a CPU tensor; ``'torch'``
    forces the plain path. On the main path ``'auto'`` spreads the order-6
    energy mesh with the kernel and leaves the order-4 matvec mesh on
    ``index_add_``, as admp_tpu leaves it on the XLA scatter
    (admp_tpu/ops/reciprocal.py:449-464).

    pairs_i_sorted: accepted for compatibility and ignored. admp_tpu uses it
    to pick a sorted segment-sum backward for the i-side row gather; the
    port's ``index_select`` backward is right for any pair order.
    """

    fft_friendly_grid: bool | str = "auto"
    lane_align_grid: bool | str = "auto"
    pair_kernel: str = "auto"
    pairs_i_sorted: bool | str = "auto"
    spread_method: str = "auto"
    spread_order: int = 6
    spread_precision: str | None = None
    realspace_precision: str | None = None
    recip_precision: str | None = None
    compensated_sums: bool = True
    cache_influence: bool = False
    scf: SCFConfig = dataclasses.field(default_factory=SCFConfig)

    def __post_init__(self):
        for name in ("pair_kernel", "spread_method"):
            value = getattr(self, name)
            if value not in METHODS:
                raise ValueError(
                    f"EngineConfig.{name}={value!r}: expected one of "
                    f"{METHODS}"
                )
        for name in ("recip_precision", "realspace_precision",
                     "spread_precision"):
            if getattr(self, name) is not None:
                _not_implemented(f"EngineConfig.{name}", "queue 1, S4")
        if self.spread_order not in (4, 6):
            raise ValueError(f"spread_order={self.spread_order}: 4 or 6")

    def resolve_fft_friendly(self) -> bool:
        """'auto' -> False: the 5-smooth rounding is a TPU FFT rule."""
        if self.fft_friendly_grid == "auto":
            return False
        return bool(self.fft_friendly_grid)

    def resolve_lane_align(self) -> bool:
        """'auto' -> False: lane alignment buys a TPU row-gather path."""
        if self.lane_align_grid == "auto":
            return False
        return bool(self.lane_align_grid)
