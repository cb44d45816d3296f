"""The exact-adjoint SCF profile (default SCFConfig(): implicit-function
adjoint) of the port's plain path against admp_tpu at float64 on
water_system(n_side=3): energy 1e-9 relative, forces 1e-8 relative RMSE,
identical PCG iteration counts. Its own file: admp_tpu's second-order
compile is the slowest step of the port's tests."""

import pytest

from admp_tpu.settings import SCFConfig as JSCF
from test_torch_pme import _j_pol_args, _setup, _t_pol_args
from torch_port_cases import rel_err


# admp_tpu's own cache_influence guard fires from its internal adjoint
# linearizations (admp_tpu/ops/reciprocal.py:704-721); the box is not
# differentiated here
@pytest.mark.filterwarnings("ignore:cache_influence")
def test_exact_adjoint_profile_on_plain_path():
    """Default SCFConfig(): exact implicit-function adjoint (plain path)."""
    s, jf, tf, st = _setup(True, scf=JSCF(), seed=2)
    ej, gj = jf.get_forces(*_j_pol_args(s, s["positions"]))
    et, gt = tf.get_forces(*_t_pol_args(st, s["positions"]))
    assert abs(float(et) - float(ej)) <= 1e-9 * abs(float(ej))
    assert rel_err(gt, gj) < 1e-8
    assert tf.n_cycle == int(jf.n_cycle)
