"""The high_accuracy() preset on the polarizable MD step at float32, in both
packages against float64: whether admp_tpu's own float32 pass of the 'pol'
pairs leaves the error that the port's leaves.

On the card the presets high_accuracy() and ds_accuracy() sit at 3.8e-6
from float64 in the forces of the 3000-atom polarizable MD step, where
every pair in float64 gives 1.3e-7: their float32 'pol' pair pass sets it
(chip_smoke.py phase 3m). Here, on water_system(n_side=2) (24 atoms, 8^3,
kappa 0.7, dense pairs within 3 A, f32-representable inputs) under
SCFConfig.md() over a cold and a drift step: admp_tpu's float32 forces and
induced dipoles against its float64 ones, and the port's plain float32
route against its float64 route of the same configuration. The port's
error is within 2x admp_tpu's + 1e-7: the port adds no error of its own to
the preset, and admp_tpu's float32 pair pass has the same error.
"""

import jax.numpy as jnp
import numpy as np
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch.convert import force_from_jax
from torch_port_cases import dense_pairs, rel_err, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
KAPPA, K = 0.7, 8


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def _args(s, pos, lib, f64):
    arrays = [pos, s["box"]]
    rest = [s["q_local"], s["pol"], s["tholes"], SCALES, SCALES, SCALES]
    if lib == "jax":
        d = jnp.float64 if f64 else jnp.float32
        return ([jnp.asarray(a, d) for a in arrays] + [jnp.asarray(s["pairs"])]
                + [jnp.asarray(a, d) for a in rest])
    d = torch.float64 if f64 else torch.float32
    return ([torch.tensor(a, dtype=d) for a in arrays]
            + [torch.tensor(s["pairs"])] + [torch.tensor(a, dtype=d)
                                            for a in rest])


def preset_errors():
    """[(step, admp_tpu forces, port forces, admp_tpu dipoles, port
    dipoles)]: each float32 route's relative RMSE against its float64
    route, over a cold and a drift step."""
    s = water(n_side=2, seed=0)
    s["pairs"] = dense_pairs(s["positions"], s["box"], 3.0)
    for k in ("positions", "box", "q_local", "pol", "tholes"):
        s[k] = _f32(s[k])
    drift = 0.005 * np.random.default_rng(1).standard_normal(
        s["positions"].shape)
    forces = {}
    for f64 in (False, True):
        jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                    s["covalent_map"], 3.0, 1e-3, lmax=2, lpol=True,
                    config=JEngine.high_accuracy(scf=JSCF.md()))
        jf.kappa = KAPPA
        jf.K1 = jf.K2 = jf.K3 = K
        jf.refresh_calculators()
        forces[("jax", f64)] = jf
        forces[("torch", f64)] = force_from_jax(
            jf, s["box"], device="cpu",
            dtype=torch.float64 if f64 else torch.float32)
    out, pos = [], s["positions"]
    for step in range(2):
        got = {}
        for (lib, f64), f in forces.items():
            _, g = f.get_forces(*_args(s, pos, lib, f64))
            got[lib, f64] = (np.asarray(g, np.float64),
                             np.asarray(f.U_ind, np.float64))
        out.append((step,
                    rel_err(got["jax", False][0], got["jax", True][0]),
                    rel_err(got["torch", False][0], got["torch", True][0]),
                    rel_err(got["jax", False][1], got["jax", True][1]),
                    rel_err(got["torch", False][1], got["torch", True][1])))
        pos = pos + drift
    return out


def test_high_accuracy_polarizable_md_step_f32_error_as_admp_tpu():
    for step, ej, et, uj, ut in preset_errors():
        assert ej > 0.0 and et > 0.0, step  # float32 rounds somewhere
        assert et <= 2 * ej + 1e-7, (step, et, ej)
        assert ut <= 2 * uj + 1e-7, (step, ut, uj)
