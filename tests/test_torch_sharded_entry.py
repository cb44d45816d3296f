"""The port's entry points (admp_tpu_torch/entry.py, the counterparts of
__graft_entry__.py) on the CPU: ``entry`` gives a finite energy+force step
of the polarizable model, and ``dryrun_multichip(4)`` starts 4 gloo ranks
and runs admp_tpu's dry-run body (the 2 x 2 batch fit step with Adam, the
sharded polarizable step, the sharded full force field, the 3000-atom box
at K=32); its sharded polarizable energy equals the single-device port's
at the same settings (float64, rtol 1e-9)."""

import numpy as np
import torch

from admp_tpu_torch import ADMPPmeForce, SCFConfig
from admp_tpu_torch.entry import GRID, M_SCALES, _water_inputs
from admp_tpu_torch.entry import dryrun_multichip, entry

F64 = torch.float64


def test_entry_step_is_finite():
    step, (positions,) = entry(device="cpu", dtype=F64)
    energy, forces = step(positions)
    assert forces.shape == positions.shape
    assert np.isfinite(float(energy)) and bool(torch.isfinite(forces).all())


def test_dryrun_multichip_on_four_ranks():
    out = dryrun_multichip(4, device="cpu", dtype=F64)
    assert out["pol_converged"]
    assert out["n_atoms_3000"] == 3000 and out["n_pairs_3000"] % 128 == 0
    for key in ("fit_loss", "e_pol", "e_ff", "e_ff_3000"):
        assert np.isfinite(out[key]), key

    sysd, pairs, q_local = _water_inputs(2, "cpu", F64)
    c = lambda x: torch.as_tensor(np.asarray(x), dtype=F64)  # noqa: E731
    force = ADMPPmeForce(sysd["box"], sysd["axis_types"],
                         sysd["axis_indices"], sysd["covalent_map"], 3.0,
                         1e-3, 2, lpol=True,
                         scf_config=SCFConfig(max_iter=20), device="cpu",
                         dtype=F64)
    force.kappa, (force.K1, force.K2, force.K3) = 0.62, GRID
    force.refresh_calculators()
    m = c(M_SCALES)
    e = force.get_energy(c(sysd["positions"]), c(sysd["box"]), pairs,
                         q_local, c(sysd["pol"]), c(sysd["tholes"]), m, m, m,
                         U_init=torch.zeros(sysd["positions"].shape,
                                            dtype=F64))
    np.testing.assert_allclose(out["e_pol"], float(e.detach()), rtol=1e-9)
    assert out["pol_iters"] == force.n_cycle
