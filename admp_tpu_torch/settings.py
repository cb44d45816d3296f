"""Engine configuration of the PyTorch port (counterpart of admp_tpu/settings.py).

The dataclasses keep admp_tpu's field names so a configuration reads the same
in both packages, and accept the values admp_tpu accepts; any other value of
a field raises ``ValueError`` naming the field.

TPU-keyed ``'auto'`` choices resolve the way admp_tpu resolves them off the
TPU: ``fft_friendly_grid`` and ``lane_align_grid`` are False, i.e. the
heuristic grids of ops/ewald.setup_ewald_parameters.
"""

from __future__ import annotations

import dataclasses

import torch

from admp_tpu_torch.ops.cuda import METHODS, SPREAD_METHODS

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


# The precision modes (admp_tpu/settings.py:220-254), each field's values
PRECISIONS = {
    "spread_precision": (None, "f64"),
    "realspace_precision": (None, "f64", "f64-near", "f64-all"),
    "recip_precision": (None, "ds", "f64", "f64-dft"),
}


@dataclasses.dataclass(frozen=True)
class SCFConfig:
    """Induced-dipole solver configuration (admp_tpu/settings.py:71-166).

    method: ``'pcg'`` (warm-started PCG with the Jacobi preconditioner) or
    ``'jacobi'`` (the reference's damped iteration, for cross-validation;
    it may diverge where PCG converges). Also ``fixed_iters``, the exact
    implicit-function adjoint (``exact_adjoint=True``, with ``adjoint_tol``
    and ``adjoint_fixed_iters``), Feynman-Hellmann gradients
    (``exact_adjoint=False``), the reduced-cost matvec mesh
    (``matvec_spread_order``, ``matvec_grid_div``) and the warm-started
    adjoint (``adjoint_warmstart``: the forward solve pre-solves the adjoint
    system from the carried ``ADMPPmeForce.W_adj`` and the backward refines
    from it), on the plain path and on the CUDA kernels alike.
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
        if self.method not in ("pcg", "jacobi"):
            raise ValueError(
                f"SCFConfig.method={self.method!r}: 'pcg' or 'jacobi'")

    @staticmethod
    def md():
        """Production MD profile (admp_tpu/settings.py:150-166):
        Feynman-Hellmann gradients at field_tol 0.3 and a PCG matvec on an
        order-4, half-resolution dipole mesh."""
        return SCFConfig(exact_adjoint=False, field_tol=0.3,
                         matvec_spread_order=4, matvec_grid_div=2)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration (admp_tpu/settings.py:169-348).

    pair_kernel / spread_method: ``'auto'`` runs the hand-written CUDA
    kernels (ops/cuda) for float32 tensors on a CUDA device and the plain
    PyTorch path otherwise (admp_tpu likewise never takes Pallas in float64);
    ``'cuda'`` forces the kernels and raises on a CPU tensor; ``'torch'``
    forces the plain path. On the main path ``'auto'`` spreads the order-6
    energy mesh with the kernel and leaves the order-4 matvec mesh on
    ``index_add_``, as admp_tpu leaves it on the XLA scatter
    (admp_tpu/ops/reciprocal.py:449-464). A float32 order-6 mesh larger than
    the card's L2 cache (the 98k-atom box at 256^3 and 320^3) takes the
    tiled pair, K5 spread and K7 gather, where admp_tpu's 'auto' takes its
    2-D blocked Pallas kernel; ``spread_method='cuda2d'`` forces that pair
    (admp_tpu's ``'pallas2d'``), ``'cuda'`` forces K4/K6.
    (ops/reciprocal.resolve_spread_method)

    pairs_i_sorted: accepted for compatibility and ignored. admp_tpu uses it
    to pick a sorted segment-sum backward for the i-side row gather; the
    port's ``index_select`` backward is right for any pair order.

    Precision (the north star: f32 force RMSE < 1e-6 against f64):
      spread_precision: None or 'f64' (the B-spline weight pipeline in
        float64, its stencil values rounded to the working dtype before the
        spread, which on the card still takes K4/K6).
      realspace_precision: None, 'f64' (the topological-exclusion pairs in
        float64 on a static exclusion-pair list, masked out of the working
        pass), 'f64-near' (pairs closer than ``realspace_near_radius``
        delta-corrected in float64, compacted at ``realspace_near_frac`` of
        the pair capacity; an overflow makes the energy and forces NaN) or
        'f64-all' (the whole pair pass in float64).
      recip_precision: None, 'ds' (the double-single engine of
        ops/dsrecip.py, power-of-two grids: the force constructor rounds K
        up), 'f64' (float64 mesh, native float64 FFT, influence and
        Parseval sum) or 'f64-dft' (the same with explicit-matmul DFTs).
      compensated_sums: sum the f32 pair energies and Parseval terms with
        an error far below f32 rounding (utils/accmath.py).

    Dispersion (models/dispersion.ADMPDispPmeForce):
      pmax_recip: reciprocal-space pmax (6 drops the C8/C10 k-space
        channels; real and self space keep the full pmax). None = pmax.
      disp_ethresh: the Ewald accuracy target of the dispersion grids.
        None = the electrostatic ethresh.
      disp_spread_order: the B-spline order of the dispersion spread (6 or
        4). Under ``spread_method='auto'`` the three-channel dispersion mesh
        takes the kernel at both orders, as admp_tpu's multi-channel 'auto'
        takes its Pallas slab kernel (reciprocal.py:552-557).

    halo_cap_factor: the per-(source, target) bin capacity of the sharded
      halo spread's fixed-capacity all_to_all (parallel/spread.py), as a
      multiple of the uniform share n_loc/P. The 3x default assumes each
      rank's atom block is spread out in x; atoms in lattice or trajectory
      order, cut into index blocks, crowd whole blocks into few slabs and
      overflow it (the slab goes NaN, loudly). Shuffle or spatially sort the
      atoms, or raise it toward P, where the bin reaches n_loc (always
      enough; the all_to_all grows with it).
    """

    fft_friendly_grid: bool | str = "auto"
    lane_align_grid: bool | str = "auto"
    pair_kernel: str = "auto"
    pairs_i_sorted: bool | str = "auto"
    spread_method: str = "auto"
    spread_order: int = 6
    spread_precision: str | None = None
    realspace_precision: str | None = None
    realspace_near_radius: float = 2.5
    realspace_near_frac: float = 0.5
    recip_precision: str | None = None
    compensated_sums: bool = True
    pmax_recip: int | None = None
    disp_ethresh: float | None = None
    disp_spread_order: int = 6
    cache_influence: bool = False
    halo_cap_factor: float = 3.0
    scf: SCFConfig = dataclasses.field(default_factory=SCFConfig)

    def __post_init__(self):
        for name, allowed in (("pair_kernel", METHODS),
                              ("spread_method", SPREAD_METHODS)):
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"EngineConfig.{name}={value!r}: expected one of "
                    f"{allowed}"
                )
        for name, allowed in PRECISIONS.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"EngineConfig.{name}={value!r}: expected one of "
                    f"{allowed}"
                )
        for name in ("spread_order", "disp_spread_order"):
            if getattr(self, name) not in (4, 6):
                raise ValueError(f"{name}={getattr(self, name)}: 4 or 6")

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

    @classmethod
    def high_accuracy(cls, **overrides):
        """Preset for < 1e-6 relative f32 force RMSE against float64:
        float64 exclusion pairs, spread weights and reciprocal path
        (admp_tpu/settings.py:317-330)."""
        base = dict(spread_precision="f64", realspace_precision="f64",
                    recip_precision="f64", compensated_sums=True)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def ds_accuracy(cls, **overrides):
        """Preset of the double-single reciprocal engine and the float64
        delta correction of close pairs (admp_tpu/settings.py:332-348)."""
        base = dict(recip_precision="ds", realspace_precision="f64-near",
                    compensated_sums=True)
        base.update(overrides)
        return cls(**base)
