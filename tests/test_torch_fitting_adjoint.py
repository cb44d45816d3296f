"""Second-order paths of the port against admp_tpu at float64 on
water_system(n_side=3), on the plain path:

* the exact-adjoint (default SCFConfig()) parameter gradients dE/dQ_local,
  dE/dpol and dE/dtholes through get_energy: 1e-8 relative RMSE;
* fitting.energy_force_loss on the fixed-multipole model, a stacked batch of
  two configurations: the loss value and its Q_local gradient, 1e-9.

Its own file: admp_tpu's second-order compiles are the slowest steps of the
port's tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import fitting as jfit
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch import fitting as tfit
from test_torch_pme import SCALES, _j_pol_args, _setup, _t_pol_args
from torch_port_cases import rel_err


# admp_tpu's own cache_influence guard fires from its internal adjoint
# linearizations (admp_tpu/ops/reciprocal.py:704-721); the box is not
# differentiated here
@pytest.mark.filterwarnings("ignore:cache_influence")
def test_exact_adjoint_parameter_gradients():
    s, jf, tf, st = _setup(True, scf=JSCF(), seed=2)
    n = s["positions"].shape[0]
    j_args = _j_pol_args(s, s["positions"])

    def j_energy(q, pol, tholes):
        a = list(j_args)
        a[3:6] = q, pol, tholes
        return jf._energy_and_aux(*a, jnp.zeros((n, 3)))[0]

    gj = jax.grad(j_energy, argnums=(0, 1, 2))(*j_args[3:6])
    t_args = _t_pol_args(st, s["positions"])
    params = [t_args[k].clone().requires_grad_(True) for k in (3, 4, 5)]
    t_args[3:6] = params
    et = tf.get_energy(*t_args, U_init=torch.zeros((n, 3), dtype=torch.float64))
    gt = torch.autograd.grad(et, params)
    for name, a, b in zip(("Q_local", "pol", "tholes"), gt, gj):
        assert rel_err(a, b) < 1e-8, (name, rel_err(a, b))
        assert float(np.abs(np.asarray(b)).max()) > 0, name


def _drifted_entries(s, force_fn, q, n_conf=2, seed=3):
    """(positions, box, pairs, E, F) for n_conf drifted configurations,
    numpy, from admp_tpu's fixed-multipole force at charges q."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_conf):
        pos = s["positions"] + 0.01 * rng.standard_normal(s["positions"].shape)
        e, g = force_fn(jnp.asarray(pos), jnp.asarray(s["box"]),
                        jnp.asarray(s["pairs"]), jnp.asarray(q),
                        jnp.asarray(SCALES))
        out.append((pos, s["box"], s["pairs"], float(e), -np.asarray(g)))
    return out


def test_energy_force_loss_matches():
    s, jf, tf, st = _setup(False, seed=5)
    entries = _drifted_entries(s, jf.get_forces, s["q_local"])

    def j_pot(positions, box, pairs, params):
        return jf.get_energy(positions, box, pairs, params["q"],
                             jnp.asarray(SCALES))

    def t_pot(positions, box, pairs, params):
        return tf.get_energy(positions, box, pairs, params["q"],
                             st["m_scales"])

    q0 = 1.02 * s["q_local"]
    j_loss = jfit.energy_force_loss(j_pot)
    lj, gj = jax.value_and_grad(j_loss)({"q": jnp.asarray(q0)},
                                        jfit.stack_batch(entries))
    params = {"q": torch.tensor(q0, requires_grad=True)}
    lt = tfit.energy_force_loss(t_pot)(params, tfit.stack_batch(entries))
    (gt,) = torch.autograd.grad(lt, [params["q"]])
    assert abs(float(lt.detach()) - float(lj)) <= 1e-9 * abs(float(lj))
    assert rel_err(gt, gj["q"]) < 1e-9
    # the list-of-entries form gives the same loss
    listed = tfit.energy_force_loss(t_pot)(
        params, [tuple(torch.as_tensor(np.asarray(a)) for a in e)
                 for e in entries])
    assert abs(float(listed.detach()) - float(lt.detach())) <= 1e-12 * abs(
        float(lt.detach()))
