"""The precision modes (EngineConfig.spread_precision, realspace_precision,
recip_precision, the high_accuracy() and ds_accuracy() presets) of the port
against admp_tpu's on water_system(n_side=2), each mode built on both
packages (force_from_jax copies kappa, the grid and the configuration).

The grid is 8^3 (a power of two: the DS modes take it), so that admp_tpu's
DS engine, which runs op by op here, stays cheap. At float64 working dtype
the port matches admp_tpu to 1e-9 (energy) and 1e-8 (force relative RMSE).
At float32, with f32-representable inputs and admp_tpu's float64 plain path
as the oracle:

* the presets that reach below the f32 floor (high_accuracy(), 'f64-all',
  'f64-dft', ds_accuracy()) match admp_tpu to 2e-6 in the forces and 1e-6
  in the energy, and sit within 5e-6 of the oracle; under ds_accuracy()
  ('f64-near' real space) admp_tpu's energy keeps the rounding of its
  plain-f32 near-pair sum, at most one f32 unit of the real-space term,
  which the port's compensated near pass cancels (ROADMAP, deliberate
  differences);
* the other modes match admp_tpu's forces within the gap measured between
  the two packages' f32 pipelines on this box, doubled: 2.3e-4 and 2.4e-4
  at the plain f32 floor (None, 'f64-near'), 2.6e-6 with the f64 spread
  weights (each package ~1e-6 to 2e-6 from the oracle, on its own side),
  1.0e-6 with the DS reciprocal alone;
* every mode's force error against the oracle is within 1.5x admp_tpu's
  + 1e-8, and its energy error within 1.5x admp_tpu's plus two f32 units of
  the reciprocal term and of the total, which both packages round to the
  working dtype; for the modes whose error stays at the plain f32 floor of
  the spline weights (None, 'f64-near' alone) the factor is 2: the two
  packages' f32 pipelines round differently, and over eight boxes (seeds
  0-3, n_side 2 and 3) the port's plain f32 force error ranged from 0.83x
  to 1.62x admp_tpu's.

The polarizable step: high_accuracy() with SCFConfig.md() over two drift
steps against admp_tpu; ds_accuracy() with the exact adjoint (SCFConfig(),
second derivatives through the DS engine) against the port's float64 exact
adjoint, which test_torch_pme_adjoint.py holds against admp_tpu (why not
against admp_tpu's own DS step: see that test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu.ops.exclusions import exclusion_pair_list as j_excl_list
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch import ADMPPmeForce, EngineConfig, SCFConfig
from admp_tpu_torch.convert import force_from_jax
from admp_tpu_torch.ops.exclusions import exclusion_pair_list
from admp_tpu_torch.ops.influence import ck_1
from admp_tpu_torch.ops.reciprocal import (
    make_pme_recip,
    spectrum_sq,
    spectrum_sq_dft,
)
from torch_port_cases import dense_pairs, rel_err, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC, ETHRESH, KAPPA, K = 3.0, 1e-3, 0.7, 8
F32_EPS = float(np.finfo(np.float32).eps)

MODES = {
    "plain": dict(compensated_sums=False),
    "high_accuracy": "high",
    "f64-all": dict(realspace="f64-all"),
    "f64-dft": dict(realspace="f64-all", recip="f64-dft"),
    "ds_accuracy": "ds",
    "spread-f64": dict(spread_precision="f64"),
    "recip-ds": dict(recip_precision="ds"),
    "f64-near": dict(realspace_precision="f64-near"),
}
BELOW_FLOOR = ("high_accuracy", "f64-all", "f64-dft", "ds_accuracy")
AT_F32_FLOOR = ("plain", "f64-near")
# port vs admp_tpu at float32, force relative RMSE (module docstring)
PORT_VS_JAX = {"plain": 5e-4, "f64-near": 5e-4, "spread-f64": 5e-6,
               "recip-ds": 2e-6}


def _config(cls, mode, **extra):
    spec = MODES[mode]
    if spec == "high":
        return cls.high_accuracy(**extra)
    if spec == "ds":
        return cls.ds_accuracy(**extra)
    spec = dict(spec)
    if "realspace" in spec:
        over = dict(realspace_precision=spec.pop("realspace"))
        if "recip" in spec:
            over["recip_precision"] = spec.pop("recip")
        return cls.high_accuracy(**over, **extra)
    return cls(**spec, **extra)


@pytest.fixture(scope="module")
def case():
    s = water(n_side=2, seed=0)
    s["pairs"] = dense_pairs(s["positions"], s["box"], 4.0)
    # f32-representable inputs shared by every pipeline
    for k in ("positions", "box", "q_local"):
        s[k] = s[k].astype(np.float32).astype(np.float64)
    cache = {}

    def jax_force(mode, lpol=False, scf=None):
        cfg = (JEngine() if mode is None
               else _config(JEngine, mode, **({} if scf is None
                                               else dict(scf=scf))))
        jf = JForce(jnp.asarray(s["box"]), s["axis_types"],
                    s["axis_indices"], s["covalent_map"], RC, ETHRESH,
                    lmax=2, lpol=lpol, config=cfg)
        jf.kappa = KAPPA
        jf.K1 = jf.K2 = jf.K3 = K
        jf.refresh_calculators()
        return jf

    def run(mode, dtype):
        """admp_tpu's energy and forces, the port's, and the port's
        reciprocal and real-space terms."""
        key = (mode, dtype)
        if key in cache:
            return cache[key]
        jf = jax_force(mode)
        jd = jnp.float64 if dtype == "f64" else jnp.float32
        td = torch.float64 if dtype == "f64" else torch.float32
        j_args = [jnp.asarray(s[k], jd) for k in ("positions", "box")] + [
            jnp.asarray(s["pairs"]), jnp.asarray(s["q_local"], jd),
            jnp.asarray(SCALES, jd)]
        t_args = [torch.tensor(s[k], dtype=td) for k in ("positions", "box")]
        t_args += [torch.tensor(s["pairs"]),
                   torch.tensor(s["q_local"], dtype=td),
                   torch.tensor(SCALES, dtype=td)]
        if jf.config.recip_precision == "ds":
            # admp_tpu's DS engine runs op by op: its compile under jit
            # takes about a minute per mode on the CPU
            with jax.disable_jit():
                ej, fj = jf.get_forces(*j_args)
        else:
            ej, fj = jf.get_forces(*j_args)
        tf = force_from_jax(jf, s["box"], device="cpu", dtype=td)
        assert (tf.K1, tf.K2, tf.K3) == (jf.K1, jf.K2, jf.K3)
        et, ft = tf.get_forces(*t_args)
        terms = tf.get_metrics(*t_args)
        cache[key] = (float(ej), np.asarray(fj, np.float64), float(et),
                      ft.numpy().astype(np.float64), float(terms["e_recip"]),
                      float(terms["e_real"]))
        return cache[key]

    e_ref, f_ref = run(None, "f64")[:2]
    return dict(s=s, run=run, jax_force=jax_force, e_ref=e_ref, f_ref=f_ref)


@pytest.mark.parametrize("mode", ["high_accuracy", "f64-dft", "ds_accuracy",
                                  "f64-near"])
def test_f64_modes_match_admp_tpu(case, mode):
    ej, fj, et, ft = case["run"](mode, "f64")[:4]
    assert abs(et - ej) <= 1e-9 * abs(ej)
    assert rel_err(ft, fj) < 1e-8


@pytest.mark.parametrize("mode", sorted(MODES))
def test_f32_modes(case, mode):
    ej, fj, et, ft, e_recip, e_real = case["run"](mode, "f32")
    f_ref = case["f_ref"]
    err_t, err_j = rel_err(ft, f_ref), rel_err(fj, f_ref)
    factor = 2.0 if mode in AT_F32_FLOOR else 1.5
    assert err_t <= factor * err_j + 1e-8, (err_t, err_j)
    de_t, de_j = abs(et - case["e_ref"]), abs(ej - case["e_ref"])
    rounding = 2 * F32_EPS * (abs(e_recip) + abs(case["e_ref"]))
    assert de_t <= factor * de_j + rounding, (de_t, de_j)
    assert np.all(np.isfinite(ft))
    if mode in BELOW_FLOOR:
        assert rel_err(ft, fj) < 2e-6
        assert err_t < 5e-6
        near = _config(EngineConfig, mode).realspace_precision == "f64-near"
        assert abs(et - ej) <= (1e-6 * abs(ej)
                                + (F32_EPS * abs(e_real) if near else 0.0))
    else:
        assert rel_err(ft, fj) < PORT_VS_JAX[mode], rel_err(ft, fj)


def test_f64_exclusions_keep_the_exclusion_list_semantics(case):
    """The float64 exclusion pass takes exactly the pairs the masked pass
    drops: at float64 working dtype 'f64' gives the plain total, and the
    static list holds the 3 topological pairs of each water, as admp_tpu's."""
    s = case["s"]
    n = s["positions"].shape[0]
    excl = exclusion_pair_list(torch.as_tensor(s["covalent_map"]))
    rows = excl[excl[:, 0] < n].numpy()
    assert rows.shape[0] == n
    want = np.asarray(j_excl_list(jnp.asarray(s["covalent_map"])))
    np.testing.assert_array_equal(excl.numpy(), want)
    args = [torch.tensor(s[k]) for k in ("positions", "box")] + [
        torch.tensor(s["pairs"]), torch.tensor(s["q_local"]),
        torch.tensor(SCALES)]
    energies = []
    for cfg in (EngineConfig(), EngineConfig(realspace_precision="f64")):
        f = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], RC, ETHRESH, 2, config=cfg,
                         device="cpu", dtype=torch.float64)
        energies.append(float(f.get_energy(*args)))
    assert abs(energies[1] - energies[0]) <= 1e-10 * abs(energies[0])


def _fixed_args(s, dtype):
    return [torch.tensor(s[k], dtype=dtype) for k in ("positions", "box")] + [
        torch.tensor(s["pairs"]), torch.tensor(s["q_local"], dtype=dtype),
        torch.tensor(SCALES, dtype=dtype)]


def test_f64_near_overflow_poisons_energy_and_forces(case):
    s = case["s"]
    n_pairs = int((s["pairs"][:, 0] < s["pairs"][:, 1]).sum())
    assert n_pairs > 128  # more near pairs than the smallest capacity
    cfg = EngineConfig(realspace_precision="f64-near",
                       realspace_near_radius=100.0, realspace_near_frac=1e-6)
    f = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                     s["covalent_map"], RC, ETHRESH, 2, config=cfg,
                     device="cpu", dtype=torch.float32)
    e, g = f.get_forces(*_fixed_args(s, torch.float32))
    assert torch.isnan(e)
    assert bool(torch.isnan(g).all())
    # at full capacity the same radius is fine
    f = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                     s["covalent_map"], RC, ETHRESH, 2,
                     config=EngineConfig(realspace_precision="f64-near",
                                         realspace_near_radius=100.0,
                                         realspace_near_frac=1.0),
                     device="cpu", dtype=torch.float32)
    e, g = f.get_forces(*_fixed_args(s, torch.float32))
    assert bool(torch.isfinite(e)) and bool(torch.isfinite(g).all())


def test_spread_precision_keyword_and_ds_grid(case):
    s = case["s"]
    kw = dict(device="cpu", dtype=torch.float32)
    a = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                     s["covalent_map"], RC, ETHRESH, 2,
                     spread_precision="f64", **kw)
    b = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                     s["covalent_map"], RC, ETHRESH, 2,
                     config=EngineConfig(spread_precision="f64"), **kw)
    assert a.config.spread_precision == "f64"
    ea, ga = a.get_forces(*_fixed_args(s, torch.float32))
    eb, gb = b.get_forces(*_fixed_args(s, torch.float32))
    assert float(ea) == float(eb) and torch.equal(ga, gb)
    # 'ds' rounds the heuristic grid up to powers of two, as admp_tpu does
    ds = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                      s["covalent_map"], RC, ETHRESH, 2,
                      config=EngineConfig.ds_accuracy(), **kw)
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                s["covalent_map"], RC, ETHRESH, lmax=2,
                config=JEngine.ds_accuracy())
    assert (ds.K1, ds.K2, ds.K3) == (jf.K1, jf.K2, jf.K3)
    assert all(k & (k - 1) == 0 for k in (ds.K1, ds.K2, ds.K3))
    with pytest.raises(ValueError, match="power-of-two"):
        make_pme_recip(ck_1, KAPPA, (12, 16, 16), 2,
                       recip_precision="ds")(
            torch.zeros(3, 3), torch.eye(3) * 10.0, torch.zeros(3, 9))


@pytest.mark.parametrize("field,value", [
    ("spread_precision", "f64"), ("realspace_precision", "f64"),
    ("realspace_precision", "f64-near"), ("realspace_precision", "f64-all"),
    ("recip_precision", "ds"), ("recip_precision", "f64"),
    ("recip_precision", "f64-dft")])
def test_settings_accept_admp_tpu_values(field, value):
    assert getattr(EngineConfig(**{field: value}), field) == value
    assert getattr(JEngine(**{field: value}), field) == value


@pytest.mark.parametrize("field,value", [
    ("spread_precision", "ds"), ("spread_precision", "f32"),
    ("realspace_precision", "ds"), ("realspace_precision", "f64-dft"),
    ("recip_precision", "f64-near"), ("recip_precision", "double")])
def test_settings_refuse_other_values(field, value):
    with pytest.raises(ValueError, match=field):
        EngineConfig(**{field: value})


def test_presets_and_near_fields_match_admp_tpu():
    for name in ("high_accuracy", "ds_accuracy"):
        t = getattr(EngineConfig, name)(realspace_near_frac=0.25)
        j = getattr(JEngine, name)(realspace_near_frac=0.25)
        for field in ("spread_precision", "realspace_precision",
                      "recip_precision", "compensated_sums",
                      "realspace_near_radius", "realspace_near_frac"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    d = EngineConfig()
    assert (d.realspace_near_radius, d.realspace_near_frac) == (2.5, 0.5)


def _pol_args(s, pos, lib, dtype):
    arrays = [pos, s["box"]]
    rest = [s["q_local"], s["pol"], s["tholes"], SCALES, SCALES, SCALES]
    if lib == "jax":
        d = jnp.float64 if dtype == torch.float64 else jnp.float32
        return ([jnp.asarray(a, d) for a in arrays] + [jnp.asarray(s["pairs"])]
                + [jnp.asarray(a, d) for a in rest])
    return ([torch.tensor(a, dtype=dtype) for a in arrays]
            + [torch.tensor(s["pairs"])]
            + [torch.tensor(a, dtype=dtype) for a in rest])


def test_polarizable_high_accuracy_md_two_drift_steps(case):
    s = case["s"]
    jf = case["jax_force"]("high_accuracy", lpol=True, scf=JSCF.md())
    tf = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float32)
    drift = 0.005 * np.random.default_rng(1).standard_normal(
        s["positions"].shape)
    pos = s["positions"]
    for step in range(2):
        ej, gj = jf.get_forces(*_pol_args(s, pos, "jax", torch.float32))
        et, gt = tf.get_forces(*_pol_args(s, pos, "torch", torch.float32))
        assert abs(float(et) - float(ej)) <= 1e-6 * abs(float(ej)), step
        assert rel_err(gt, gj) < 2e-6, step
        assert tf.n_cycle == int(jf.n_cycle), step
        pos = (pos + drift).astype(np.float32).astype(np.float64)


def test_polarizable_ds_accuracy_exact_adjoint(case):
    """ds_accuracy() with SCFConfig(): the adjoint differentiates the field,
    itself the DS engine's gradient, so the forces take second derivatives
    through the engine; against the port's float64 exact adjoint.

    admp_tpu's DS step does not fit in the suite's time on a CPU: compiled,
    one gradient of its DS engine alone takes over 40 s to build at these
    sizes; op by op, each gradient of the engine
    costs about 5 s once its operations are cached, the SCF takes one per
    iteration, and the adjoint's reverse over reverse about 80 s more. The
    one piece this step adds to the paths held against admp_tpu above,
    second derivatives through the DS engine, is held against admp_tpu's in
    tests/test_torch_ds.py::test_ds_recip_second_derivatives."""
    s = case["s"]
    common = (s["box"], s["axis_types"], s["axis_indices"], s["covalent_map"],
              RC, ETHRESH, 2)
    ds = ADMPPmeForce(*common, lpol=True, device="cpu", dtype=torch.float32,
                      config=EngineConfig.ds_accuracy(scf=SCFConfig()))
    ref = ADMPPmeForce(*common, lpol=True, device="cpu", dtype=torch.float64,
                       config=EngineConfig(scf=SCFConfig()))
    plain = ADMPPmeForce(*common, lpol=True, device="cpu",
                         dtype=torch.float32,
                         config=EngineConfig(scf=SCFConfig()))
    for f in (ds, ref, plain):
        f.update_env("kappa", KAPPA)
    ref.K1, ref.K2, ref.K3 = ds.K1, ds.K2, ds.K3
    plain.K1, plain.K2, plain.K3 = ds.K1, ds.K2, ds.K3
    for f in (ref, plain):
        f.refresh_calculators()
    pos = s["positions"]
    e_ds, g_ds = ds.get_forces(*_pol_args(s, pos, "torch", torch.float32))
    e_64, g_64 = ref.get_forces(*_pol_args(s, pos, "torch", torch.float64))
    _, g_32 = plain.get_forces(*_pol_args(s, pos, "torch", torch.float32))
    assert ds.scf_config.exact_adjoint and ds.lconverg
    err_ds, err_32 = rel_err(g_ds, g_64), rel_err(g_32, g_64)
    assert err_ds < 5e-6, err_ds
    assert err_ds < err_32 / 10, (err_ds, err_32)
    assert abs(float(e_ds) - float(e_64)) <= 1e-6 * abs(float(e_64))


def test_f64_spectrum_split_and_dft_match_admp_tpu():
    """The float64 spectrum three ways: the native FFT (the card's), the
    hi/lo float32 split (admp_tpu's TPU path, force_split) and the
    explicit-matmul DFT ('f64-dft'), each against admp_tpu's."""
    from admp_tpu.ops import reciprocal as jr

    mesh = np.random.RandomState(9).randn(8, 12, 16)
    t = torch.tensor(mesh)
    native = spectrum_sq(t).numpy()
    split = spectrum_sq(t, force_split=True).numpy()
    dft = spectrum_sq_dft(t).numpy()
    scale = np.abs(native).max()
    want = np.asarray(jr.spectrum_sq_dft(jnp.asarray(mesh)))
    assert np.abs(dft - want).max() <= 1e-12 * scale
    assert np.abs(dft - native).max() <= 1e-12 * scale
    # the split loses only the float32 FFTs' own rounding, in either
    # package (their float32 FFT libraries round differently)
    want = np.asarray(jr.spectrum_sq(jnp.asarray(mesh), force_split=True))
    assert 0 < np.abs(split - native).max() <= 1e-6 * scale
    assert np.abs(want - native).max() <= 1e-6 * scale
    assert np.abs(split - want).max() <= 1e-6 * scale
