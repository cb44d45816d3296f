"""The float32 reciprocal space stage by stage, the port against admp_tpu,
each against float64: where the two packages' float32 results part.

On the box of the sharded tests (water_arrays(n_side=4, seed=5), 192 atoms,
16^3, kappa 0.62; the dispersion at kappa 0.7, order 6, C6/C8/C10), inputs
rounded to float32, float32 spread weights: the stencil values (the
separable spline products), the mesh, the spectrum |S_k|^2 and the energy
sum, for PME (lmax 2) and for the dispersion. Each stage of the two
packages agrees far below its float32 error against float64: the stencils
carry the float32 floor (~9e-5 relative in both), and the mesh and the
spectrum inherit it. They part only at the energy's float32 reduction,
where each package's summation order rounds its own way (~3e-6 of the PME
energy, ~1e-6 of the dispersion's); summed compensated, the PME energies
agree. Neither package's stage is at fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import convert_cart2harm
from admp_tpu.ops import influence as JI
from admp_tpu.ops import reciprocal as JR
from admp_tpu_torch.ops import influence as TI
from admp_tpu_torch.ops import reciprocal as TR
from admp_tpu_torch.utils.constants import DIELECTRIC
from tests.torch_port_cases import rel_err
from tests.watergen import water_arrays

GRID = (16, 16, 16)
KAPPA, DISP_KAPPA = 0.62, 0.7
DISP_CK = ((JI.ck_6, JI.ck_8, JI.ck_10), (TI.ck_6, TI.ck_8, TI.ck_10))
# float32, port vs admp_tpu, relative: the stages before the sum (measured
# 7.5e-9-1.4e-7), far below their float32 error against float64 (1.9e-5-
# 1.3e-4); the plain sums (measured 3.0e-6 and 1.2e-6) within the float32
# error of the sum's inputs against float64 (1.2e-5, 1.4e-5); the
# compensated PME sums (5e-10)
TOL_STAGE, TOL_SUM, TOL_COMPENSATED = 1e-6, 1e-5, 1e-8


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def _stages(lib, f64):
    """{stage: value} of one package at float64 or float32."""
    s = water_arrays(n_side=4, spacing=3.1, jitter=0.12, seed=5)
    q = np.asarray(convert_cart2harm(jnp.asarray(s["q_cart"]), 2))
    pos, box, q, c6 = (_f32(x) for x in (s["positions"], s["box"], q,
                                         s["c_list"][:, :3]))
    if lib == "jax":
        d = jnp.float64 if f64 else jnp.float32
        pos, box, q, c6 = (jnp.asarray(x, d) for x in (pos, box, q, c6))
        _, u0, alpha = JR.atom_spread_alpha(pos, box, q, GRID, 2)
        mesh = JR.spread_to_mesh(pos, box, q, GRID, 2)
        meshes = JR.spread_to_mesh_multi(pos, box, c6, GRID, 6)
        out = dict(
            stencil=JR.spread_points_separable(u0, alpha, 2, 6),
            mesh=mesh, spectrum=JR.spectrum_sq(mesh),
            energy=JR.convolve_energy(mesh, box, KAPPA, JI.ck_1, False,
                                      DIELECTRIC),
            energy_compensated=JR.convolve_energy(
                mesh, box, KAPPA, JI.ck_1, False, DIELECTRIC,
                compensated=True),
            disp_mesh=meshes,
            disp_spectrum=jnp.abs(jnp.fft.rfftn(meshes, axes=(1, 2, 3))) ** 2,
            disp_energy=JR.convolve_energy_multi(meshes, box, DISP_KAPPA,
                                                 DISP_CK[0], True))
    else:
        d = torch.float64 if f64 else torch.float32
        pos, box, q, c6 = (torch.tensor(x, dtype=d) for x in (pos, box, q,
                                                               c6))
        _, u0, alpha = TR.atom_spread_alpha(pos, box, q, GRID, 2)
        mesh = TR.spread_to_mesh(pos, box, q, GRID, 2, method="torch")
        meshes = TR.spread_to_mesh_multi(pos, box, c6, GRID, 6,
                                         method="torch")
        weight = TR.influence_weights(box, GRID, KAPPA, TI.ck_1, 6)
        out = dict(
            stencil=TR.spread_points_separable(u0, alpha, 2, 6),
            mesh=mesh, spectrum=TR.spectrum_sq(mesh),
            energy=TR.convolve_energy(mesh, weight, DIELECTRIC),
            energy_compensated=TR.convolve_energy(mesh, weight, DIELECTRIC,
                                                  compensated=True),
            disp_mesh=meshes, disp_spectrum=TR.spectrum_sq(meshes),
            disp_energy=TR.convolve_energy_multi(meshes, box, DISP_KAPPA,
                                                 DISP_CK[1], True))
    return {k: np.asarray(v, np.float64).reshape(-1) for k, v in out.items()}


@pytest.fixture(scope="module")
def stages():
    # At one intra-op thread (tests/torch_port_cases.py) MKL's 3-D FFT takes
    # its sequential algorithm, whose float32 rounding moves the port's
    # compensated PME energy 3.1e-8 from admp_tpu's (3229.695211 against
    # 3229.6953125); any count above one takes the threaded algorithm these
    # tolerances were measured on
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {(lib, f64): _stages(lib, f64) for lib in ("jax", "torch")
                for f64 in (False, True)}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("stage", ["stencil", "mesh", "spectrum",
                                   "disp_mesh", "disp_spectrum"])
def test_stages_agree_before_the_sum(stages, stage):
    j32, t32 = stages["jax", False][stage], stages["torch", False][stage]
    j64, t64 = stages["jax", True][stage], stages["torch", True][stage]
    assert rel_err(t64, j64) < 1e-12
    # float32 rounds each stage far from float64, the same in both packages
    err_j, err_t = rel_err(j32, j64), rel_err(t32, t64)
    assert err_j > 1e-6 and err_t > 1e-6
    assert abs(err_t - err_j) <= 0.05 * err_j
    assert rel_err(t32, j32) < TOL_STAGE


@pytest.mark.parametrize("stage", ["energy", "disp_energy"])
def test_energies_part_at_the_float32_sum(stages, stage):
    (j32,), (t32,) = stages["jax", False][stage], stages["torch", False][stage]
    (e64,) = stages["jax", True][stage]
    assert abs(t32 - j32) <= TOL_SUM * abs(e64)
    assert abs(t32 - j32) > 0.0  # two summation orders
    for e in (j32, t32):
        assert abs(e - e64) <= 2e-5 * abs(e64)
    (jc,), (tc,) = (stages[lib, False]["energy_compensated"]
                    for lib in ("jax", "torch"))
    assert abs(tc - jc) <= TOL_COMPENSATED * abs(e64)
