"""The port's fitting path: fitting.fit with torch.optim, checkpoint.py, and
the conversion of an optax fit (convert.convert_params,
convert.adam_state_from_optax), against admp_tpu at float64 where admp_tpu
has the counterpart; and the host-checked exact adjoint's refusal of a third
derivative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from admp_tpu_torch import (
    ADMPPmeForce,
    EngineConfig,
    SCFConfig,
    energy_force_loss,
    fit,
    restore_checkpoint,
    save_checkpoint,
    stack_batch,
)
from admp_tpu_torch.convert import adam_state_from_optax, convert_params
from admp_tpu_torch.fitting import adam
from test_torch_pme import SCALES, _setup
from torch_port_cases import assert_close, dense_pairs, t64, water


def test_optax_adam_state_carries_across():
    """Three optax Adam steps in admp_tpu, carried into the port, then two
    more steps in each package: the parameters agree to 1e-10."""
    s, jf, tf, st = _setup(False, seed=7)
    j_args = [jnp.asarray(x) for x in (s["positions"], s["box"], s["pairs"])]
    e_target = float(jf.get_energy(*j_args, jnp.asarray(s["q_local"]),
                                   jnp.asarray(SCALES))) + 5.0

    def j_loss(params):
        e = jf.get_energy(*j_args, params["q"], jnp.asarray(SCALES))
        return (e - e_target) ** 2

    opt = optax.adam(1e-3)
    params = {"q": jnp.asarray(1.05 * s["q_local"])}
    state = opt.init(params)
    grad = jax.jit(jax.grad(j_loss))
    for _ in range(3):
        updates, state = opt.update(grad(params), state, params)
        params = optax.apply_updates(params, updates)
    adam_state = state[0]

    def t_loss(p, batch):
        del batch
        e = tf.get_energy(st["positions"], st["box"], st["pairs"], p["q"],
                          st["m_scales"])
        return (e - e_target) ** 2

    def carried(ps):
        optimizer = torch.optim.Adam(list(ps.values()), lr=1e-3)
        optimizer.state.update(adam_state_from_optax(
            {"q": adam_state.mu["q"]}, {"q": adam_state.nu["q"]},
            adam_state.count, ps))
        return optimizer

    start = convert_params({"q": np.asarray(params["q"])}, device="cpu")
    assert start["q"].requires_grad and start["q"].dtype == torch.float64
    result = fit(t_loss, start, [None] * 2, optimizer=carried, log_every=0)
    for _ in range(2):
        updates, state = opt.update(grad(params), state, params)
        params = optax.apply_updates(params, updates)
    assert result.steps == 2
    assert_close(result.params["q"], params["q"], rel=1e-10, abs_=0.0)


def _quadratic_fit(tmp_path, n_steps, every=1):
    target = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)

    def loss(p, batch):
        return torch.sum((p["x"] * batch - target) ** 2)

    return fit(loss, {"x": torch.zeros(3, dtype=torch.float64)},
               [torch.tensor(1.5, dtype=torch.float64)] * n_steps,
               optimizer=adam(0.1), checkpoint_dir=str(tmp_path),
               checkpoint_every=every, log_fn=lambda msg: None, log_every=0)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    state = {"a": torch.arange(5.0, dtype=torch.float64),
             "b": {"c": torch.ones((2, 2)), "n": 3}, "l": [torch.zeros(2)]}
    path = save_checkpoint(tmp_path / "rt", state, 7)
    assert path.endswith("step_00000007")
    save_checkpoint(tmp_path / "rt", {"a": torch.zeros(1)}, 3)
    restored, step = restore_checkpoint(tmp_path / "rt", state)
    assert step == 7
    assert torch.equal(restored["a"], state["a"])
    assert torch.equal(restored["b"]["c"], state["b"]["c"])
    assert restored["b"]["n"] == 3 and torch.equal(restored["l"][0],
                                                   state["l"][0])
    # a template sets dtype; re-saving a step overwrites it atomically
    as32, _ = restore_checkpoint(tmp_path / "rt",
                                 {"a": torch.zeros(1, dtype=torch.float32)})
    assert as32["a"].dtype == torch.float32
    save_checkpoint(tmp_path / "rt", {"a": torch.ones(1)}, 7)
    again, _ = restore_checkpoint(tmp_path / "rt", step=7)
    assert torch.equal(again["a"], torch.ones(1))
    assert restore_checkpoint(tmp_path / "missing") == (None, None)
    assert not list((tmp_path / "rt").glob("*.tmp"))

    # resume: 2 steps, then 2 more from the checkpoint == 4 steps at once
    first = _quadratic_fit(tmp_path / "fit", 2)
    resumed = _quadratic_fit(tmp_path / "fit", 2)
    straight = _quadratic_fit(tmp_path / "fresh", 4)
    assert first.steps == 2 and resumed.steps == 4
    assert [h["step"] for h in resumed.history] == [3, 4]
    assert torch.equal(resumed.params["x"], straight.params["x"])
    assert resumed.history[-1]["loss"] < first.history[0]["loss"]


def test_stack_batch_validation():
    s = water(n_side=2)
    entry = (s["positions"], s["box"], np.zeros((4, 2), np.int64), 1.0,
             s["positions"])
    loss = energy_force_loss(lambda *a: None)
    with pytest.raises(ValueError, match="stacked batch must be"):
        loss({}, tuple(t64(np.asarray(x)) for x in entry[:4]))
    with pytest.raises(ValueError, match="leading"):
        loss({}, tuple(t64(np.asarray(x)) for x in entry))
    stacked = stack_batch([entry, entry])
    assert [tuple(t.shape) for t in stacked] == [
        (2, 24, 3), (2, 3, 3), (2, 4, 2), (2,), (2, 24, 3)]


def _pol_potential(scf):
    s = water(n_side=2, seed=8)
    force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                         config=EngineConfig(scf=scf), device="cpu",
                         dtype=torch.float64)
    pairs = dense_pairs(s["positions"], s["box"], 4.0)
    sc = t64(SCALES)

    def potential(positions, box, pairs_, params):
        return force.get_energy(positions, box, pairs_, params["q"],
                                t64(s["pol"]), t64(s["tholes"]), sc, sc, sc)

    f = t64(s["positions"]) * 0.0
    batch = [(t64(s["positions"]), t64(s["box"]), torch.as_tensor(pairs),
              torch.tensor(0.0, dtype=torch.float64), f)]
    return potential, {"q": t64(s["q_local"]).requires_grad_(True)}, batch


def test_force_matching_through_exact_adjoint_raises():
    """A force-matching loss on a polarizable exact-adjoint potential needs
    the third derivative through the implicit solve. Under SCFConfig() the
    adjoint solve is the host-checked loop, whose iterates carry no graph,
    so the port refuses it (scf/solver.ImplicitSolve's differentiated
    backward raises, naming adjoint_fixed_iters), as admp_tpu refuses
    reverse mode through its adjoint while_loop; with adjoint_fixed_iters
    set both differentiate the unrolled adjoint
    (tests/test_torch_third_order.py). Under the Feynman-Hellmann profile
    the solve is cut and the loss differentiates."""
    potential, params, batch = _pol_potential(SCFConfig())
    loss = energy_force_loss(potential)(params, batch)
    with pytest.raises(RuntimeError, match="adjoint_fixed_iters"):
        loss.backward()
    potential, params, batch = _pol_potential(SCFConfig.md())
    energy_force_loss(potential)(params, batch).backward()
    assert float(params["q"].grad.abs().max()) > 0
