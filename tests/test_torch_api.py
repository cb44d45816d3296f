"""The port's XML/PDB front end (admp_tpu_torch.api.Hamiltonian) against
admp_tpu's at float64 on the CPU: the MPID water force field written from
its constants and a PDB of water_system(n_side=3), the same pairs.
Generator parameters within 1e-12, energies within 1e-9 relative,
parameter gradients within 1e-8 of max|grad|; the PDBData-object and
createPotentialFromSystem paths and the direct force objects give the
path-based energies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import neighbor_list_dense
from admp_tpu.api import Hamiltonian as JHamiltonian
from admp_tpu.systems import water_system
from admp_tpu_torch import (
    ADMPDispPmeForce,
    ADMPPmeForce,
    Hamiltonian,
    convert_cart2harm,
    generate_pairwise_interaction,
    tt_damping_qq_c6_kernel,
)
from admp_tpu_torch.convert import convert_params
from admp_tpu_torch.io.pdb import read_pdb
from admp_tpu_torch.systems import write_water_inputs
from torch_port_cases import assert_close

RC = 4.0


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    s = water_system(n_side=3, spacing=3.104, jitter=0.12, seed=0)
    xml, pdb = write_water_inputs(tmp_path_factory.mktemp("ff"),
                                  s["positions"], s["box"])
    jh = JHamiltonian(xml)
    jh.getGenerators()[1].ref_dip = ""
    j_pots = jh.createPotential(pdb, nonbondedCutoff=RC)
    th = Hamiltonian(xml, device="cpu", dtype=torch.float64)
    th.getGenerators()[1].ref_dip = ""
    t_pots = th.createPotential(pdb, nonbondedCutoff=RC)
    pairs = np.asarray(neighbor_list_dense(
        jnp.asarray(s["positions"]), jnp.asarray(s["box"]), RC).pairs)
    return dict(s=s, xml=xml, pdb=pdb, jh=jh, th=th, j_pots=j_pots,
                t_pots=t_pots, pairs=pairs)


def _j_args(case):
    s = case["s"]
    return (jnp.asarray(s["positions"]), jnp.asarray(s["box"]),
            jnp.asarray(case["pairs"]))


def _t_args(case):
    s = case["s"]
    return (torch.tensor(s["positions"]), torch.tensor(s["box"]),
            torch.tensor(case["pairs"]))


def _leaves(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def test_generators_and_params(case):
    j_gens, t_gens = case["jh"].getGenerators(), case["th"].getGenerators()
    assert [type(g).__name__ for g in t_gens] == [
        type(g).__name__ for g in j_gens] == ["ADMPDispGenerator",
                                              "ADMPPmeGenerator"]
    for jg, tg in zip(j_gens, t_gens):
        assert (tg.ethresh, getattr(tg, "pmax", None)) == (
            jg.ethresh, getattr(jg, "pmax", None))
        assert set(tg.params) == set(jg.params)
        for k, v in tg.params.items():
            assert v.dtype == torch.float64 and v.device.type == "cpu"
            assert_close(v.numpy(), np.asarray(jg.params[k]), rel=1e-12)
    assert (t_gens[1].lmax, t_gens[1].lpol) == (2, True)
    assert list(t_gens[0].types) == list(j_gens[0].types)
    # the assembled system is water_system's
    sys_t, s = case["th"]._system, case["s"]
    for k in ("axis_types", "axis_indices", "covalent_map"):
        assert np.array_equal(getattr(sys_t, k), s[k])
    for k in ("q_cart", "pol", "tholes"):
        assert_close(getattr(sys_t, k), s[k], rel=1e-12)


@pytest.mark.parametrize("which", [0, 1], ids=["dispersion", "polarizable"])
def test_energy_and_parameter_gradients(case, which):
    jg = case["jh"].getGenerators()[which]
    tg = case["th"].getGenerators()[which]
    e_j, g_j = jax.value_and_grad(case["j_pots"][which], argnums=3)(
        *_j_args(case), jg.params)
    params = _leaves(tg.params)
    e_t = case["t_pots"][which](*_t_args(case), params)
    names = list(params)
    grads = torch.autograd.grad(e_t, [params[k] for k in names],
                                allow_unused=True)
    assert abs(float(e_t.detach()) - float(e_j)) <= 1e-9 * abs(float(e_j))
    for k, g in zip(names, grads):
        ref = np.asarray(g_j[k])
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert_close(got, ref, rel=1e-8, abs_=1e-300)
    if which == 1:
        assert bool(tg.pme_force.lconverg)
        assert np.any(grads[names.index("pol")].numpy()[0::3] != 0.0)


def test_other_topology_paths(case):
    """createPotential on a parsed PDBData and createPotentialFromSystem
    give the path-based energies; so do the admp_tpu generator's params
    carried across by convert_params."""
    ref = [float(p(*_t_args(case), g.params)) for p, g in
           zip(case["t_pots"], case["th"].getGenerators())]
    h_obj = Hamiltonian(case["xml"], device="cpu", dtype=torch.float64)
    pots = h_obj.createPotential(read_pdb(case["pdb"]), nonbondedCutoff=RC)
    h_sys = Hamiltonian(case["xml"], device="cpu", dtype=torch.float64)
    n = case["th"]._system.n_atoms
    pots_sys = h_sys.createPotentialFromSystem(
        case["th"]._system, ["380", "381", "381"] * (n // 3),
        nonbondedCutoff=RC)
    for h, ps in ((h_obj, pots), (h_sys, pots_sys)):
        for k, (p, g) in enumerate(zip(ps, h.getGenerators())):
            e = float(p(*_t_args(case), g.params))
            assert abs(e - ref[k]) <= 1e-12 * abs(ref[k])
    for k, (p, jg) in enumerate(zip(case["t_pots"],
                                    case["jh"].getGenerators())):
        e = float(p(*_t_args(case), convert_params(jg.params, device="cpu")))
        assert abs(e - ref[k]) <= 1e-12 * abs(ref[k])


def test_hamiltonian_equals_direct_force_objects(case):
    """The same energies from ADMPDispPmeForce + Tang-Toennies and
    ADMPPmeForce built directly on water_system's arrays."""
    s = case["s"]
    pos, box, pairs = _t_args(case)
    sc = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    kw = dict(device="cpu", dtype=torch.float64)
    disp = ADMPDispPmeForce(s["box"], s["covalent_map"], RC, 1e-5, 10, **kw)
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device="cpu")
    c_list = torch.tensor(s["c_list"])
    e_disp = (tt(pos, box, pairs, sc, *(torch.tensor(s[k]) for k in
                                        ("tt_a", "tt_b", "tt_q")),
                 c_list[:, 0])
              - disp.get_energy(pos, box, pairs, c_list, sc))
    pme = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                       s["covalent_map"], RC, 1e-5, 2, lpol=True, **kw)
    e_pme = pme.get_energy(pos, box, pairs,
                           convert_cart2harm(torch.tensor(s["q_cart"]), 2),
                           torch.tensor(s["pol"]), torch.tensor(s["tholes"]),
                           sc, sc, sc, U_init=torch.zeros_like(pos))
    for e_direct, p, g in zip((e_disp, e_pme), case["t_pots"],
                              case["th"].getGenerators()):
        e = float(p(pos, box, pairs, g.params))
        assert abs(e - float(e_direct)) <= 1e-10 * abs(e)


def test_hamiltonian_needs_the_card_unless_asked(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Hamiltonian(case["xml"])
