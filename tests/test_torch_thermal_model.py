"""``ThermalModel``'s XLA-path entry points of the port against heatx's, f64,
CPU, and against the port's own day march.

* ``run`` in its four modes (parity with a fixed and the adaptive number of
  no-mass iterations, ``trbdf2``, ``trbdf2_refresh`` with k = 2, ``exp``),
  ``march``, ``march_imp`` (frozen, refresh, k = 2), ``march_exp`` and
  ``engine.exponential.expm_phi1`` against heatx, 1e-9 K (``expm_phi1``
  rtol 1e-12);
* ``inputs_sequence`` gives heatx's leaves, ``warmup`` heatx's repeat
  count, ``run_checked`` raises at heatx's step and zone;
* the XLA path against the port's kernel-route plain march
  (``FastRunner.run`` on the CPU) on one building, to heatx's own tolerances
  for its kernel against its XLA path: parity with 2 no-mass iterations
  1e-10 K (tests/test_pallas_imp.py), the adaptive loop 5e-8 K
  (tests/test_pallas_hour.py), ``trbdf2_refresh`` k = 2 1e-12 K.

All buildings use the coarse discretization (6 stability sub-steps per
hour).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import bench
import heatx
from heatx.engine import exponential as hx_exp
from heatx_torch import SimConfig, ThermalModel, convert, testing
from heatx_torch.engine import exponential as exp_mod

torch.set_num_threads(1)

ATOL_K = 1e-9
HOURS = 6
COARSE = dict(max_dx=0.5, min_dt=900.0)


def _models(iters=2, zones=4, **cfg):
    htm = heatx.ThermalModel(bench.build_city_model(zones, 4),
                             config=heatx.SimConfig(dtype=jnp.float64, nomass_fixed_iters=iters, **COARSE, **cfg))
    ptm = ThermalModel(testing.build_city_model(zones, 4),
                       config=SimConfig(dtype=torch.float64, nomass_fixed_iters=iters, **COARSE, **cfg),
                       device="cpu")
    return htm, ptm


def _weather(S, hours=HOURS, seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        t_out=rng.uniform(-5.0, 12.0, hours), wind_speed=rng.uniform(0.0, 6.0, hours),
        wind_direction=rng.uniform(0.0, 6.28, hours), sol_front=rng.uniform(0.0, 500.0, (hours, S)),
        ir_front=rng.uniform(260.0, 380.0, (hours, S)), lum_power=150.0,
    )


def _close(got, ref, atol=ATOL_K, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


def _check_state(got, ref, mask, atol=ATOL_K):
    _close(got.zone_T, ref.zone_T, atol, "zone_T")
    _close(got.node_T.numpy() * mask, np.asarray(ref.node_T) * mask, atol, "node_T")


RUN_MODES = {
    "parity": (2, dict(mode="parity")),
    "parity_adaptive": (None, dict(mode="parity")),
    "trbdf2": (2, dict(mode="trbdf2")),
    "trbdf2_refresh": (2, dict(mode="trbdf2_refresh", substeps=8, refresh_every=2)),
    "exp": (2, dict(mode="exp", substeps=6)),
}


@pytest.mark.parametrize("mode", list(RUN_MODES))
def test_run_modes_match_heatx(mode):
    iters, kw = RUN_MODES[mode]
    htm, ptm = _models(iters)
    w = _weather(ptm.building.n_surfaces)
    hseq, pseq = htm.inputs_sequence(HOURS, **w), ptm.inputs_sequence(HOURS, **w)
    ref_final, ref_hist = htm.run(htm.initial_state(), hseq, **kw)
    final, hist = ptm.run(ptm.initial_state(), pseq, **kw)
    _close(hist, ref_hist, what="zone_T history")
    _check_state(final, ref_final, np.asarray(htm.building.surfaces.node_mask))
    assert np.ptp(hist.numpy()) > 1.0


@pytest.mark.parametrize("march", ["march", "imp_frozen", "imp_refresh", "imp_k2", "exp"])
def test_one_step_marches_match_heatx(march):
    htm, ptm = _models(None)
    S = ptm.building.n_surfaces
    rng = np.random.default_rng(2)
    kw = dict(t_out=-4.0, wind_speed=3.0, sol_front=rng.uniform(0, 400, S), ir_front=np.full(S, 300.0),
              lum_power=np.full(ptm.building.n_luminaires, 200.0))
    hi, pi = htm.inputs(**kw), ptm.inputs(**kw)
    if march == "march":
        ref, got = htm.march(htm.initial_state(), hi), ptm.march(ptm.initial_state(), pi)
    elif march == "exp":
        ref = htm.march_exp(htm.initial_state(), hi, substeps=6)
        got = ptm.march_exp(ptm.initial_state(), pi, substeps=6)
    else:
        args = dict(imp_frozen={}, imp_refresh=dict(refresh_h=True), imp_k2=dict(refresh_every=2))[march]
        ref = htm.march_imp(htm.initial_state(), hi, substeps=6, **args)
        got = ptm.march_imp(ptm.initial_state(), pi, substeps=6, **args)
    _check_state(got, ref, np.asarray(htm.building.surfaces.node_mask))
    assert np.abs(got.zone_T.numpy() - 22.0).max() > 0.1


def test_expm_phi1_matches_heatx():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 7, 7)) * rng.uniform(0.1, 3.0, (5, 1, 1))
    E_h, P_h = jax.jit(hx_exp.expm_phi1)(jnp.asarray(A))
    E, P = exp_mod.expm_phi1(torch.as_tensor(A))
    np.testing.assert_allclose(E.numpy(), np.asarray(E_h), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(P.numpy(), np.asarray(P_h), rtol=1e-12, atol=1e-14)
    lo, d, up = (rng.normal(size=(6, 3)) for _ in range(3))
    np.testing.assert_array_equal(exp_mod._tridiag_to_dense(*(torch.as_tensor(a) for a in (lo, d, up))).numpy(),
                                  np.asarray(hx_exp._tridiag_to_dense(lo, d, up)))


def test_inputs_sequence_matches_heatx():
    htm, ptm = _models()
    b = ptm.building
    S, Z, sub = b.n_surfaces, b.n_zones, b.dt_subdivisions
    rng = np.random.default_rng(8)
    T = 5
    forms = [
        dict(t_out=rng.uniform(0, 9, T), wind_speed=3.0, sol_front=rng.uniform(0, 300, (T, S))),
        dict(t_out=rng.uniform(0, 9, (T, sub)), wind_direction=rng.uniform(0, 6, sub),
             ir_front=rng.uniform(250, 350, T), inf_vol=rng.uniform(0, 0.1, Z), inf_mask=np.ones(Z, bool)),
        dict(t_out=None, lum_power=rng.uniform(0, 300, (T, b.n_luminaires)), heat_sp=20.0,
             shade_sp=rng.uniform(18, 25, S), mix_vol=np.zeros(0)),
    ]
    for kw in forms:
        h, p = htm.inputs_sequence(T, **kw), ptm.inputs_sequence(T, **kw)
        # and heatx's sequence carried across by heatx_torch.convert
        c = convert.inputs_from_arrays({n: None if v is None else np.asarray(v) for n, v in h._asdict().items()})
        for f in dataclasses.fields(p):
            a, r, cv = getattr(p, f.name), getattr(h, f.name), getattr(c, f.name)
            assert (a is None) == (r is None) == (cv is None), f.name
            if a is not None:
                assert tuple(a.shape) == tuple(r.shape), f.name
                np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=f.name)
                assert cv.dtype == a.dtype and torch.equal(cv, a), f.name
    # the no-mass loop's settings cross with the configuration
    cfg = convert.config_from_dict(dict(dataclasses.asdict(heatx.SimConfig(
        dtype=jnp.float64, nomass_fixed_iters=None, nomass_max_iter=70, nomass_tol=0.02,
        nomass_tol_escalated=0.3, nomass_escalate_after=9))))
    assert (cfg.nomass_fixed_iters, cfg.nomass_max_iter, cfg.nomass_tol, cfg.nomass_tol_escalated,
            cfg.nomass_escalate_after) == (None, 70, 0.02, 0.3, 9)


def test_warmup_matches_heatx():
    htm, ptm = _models(2, zones=2)
    kw = dict(t_out=np.full(12, -5.0), wind_speed=3.0, ir_front=300.0)
    h_warm, h_reps = htm.warmup(htm.initial_state(), htm.inputs_sequence(12, **kw), max_repeats=25, tol=0.1)
    p_warm, p_reps = ptm.warmup(ptm.initial_state(), ptm.inputs_sequence(12, **kw), max_repeats=25, tol=0.1)
    assert 2 <= p_reps == h_reps < 25
    _check_state(p_warm, h_warm, np.asarray(htm.building.surfaces.node_mask))


def test_run_checked_locates_the_first_bad_step_and_zone():
    htm, ptm = _models(2)
    b = ptm.building
    lum = np.full((HOURS, b.n_luminaires), 150.0)
    lum[3, np.nonzero(np.asarray(b.lum_space) == 2)[0]] = np.nan  # zone 2's lights at main step 3
    w = _weather(b.n_surfaces)
    w.update(lum_power=lum)
    with pytest.raises(checkify.JaxRuntimeError) as ref:
        htm.run_checked(htm.initial_state(), htm.inputs_sequence(HOURS, **w))
    with pytest.raises(FloatingPointError) as got:
        ptm.run_checked(ptm.initial_state(), ptm.inputs_sequence(HOURS, **w))
    assert "non-finite temperature at main step 3 (first bad zone 2)" in str(ref.value)
    assert "non-finite temperature at main step 3 (first bad zone 2)" in str(got.value)
    w["lum_power"] = 150.0
    _, hist = ptm.run_checked(ptm.initial_state(), ptm.inputs_sequence(HOURS, **w))
    assert torch.isfinite(hist).all()


def test_run_validation():
    _, ptm = _models()
    seq = ptm.inputs_sequence(2, t_out=0.0)
    st = ptm.initial_state()
    with pytest.raises(ValueError, match="stability-dictated"):
        ptm.run(st, seq, mode="parity", substeps=4)
    with pytest.raises(ValueError, match="unknown mode"):
        ptm.run(st, seq, mode="bogus")
    with pytest.raises(ValueError, match="refresh_every applies"):
        ptm.run(st, seq, mode="trbdf2", refresh_every=2)
    with pytest.raises(ValueError, match="collect_loads requires"):
        ptm.run(st, seq, collect_loads=True)


# ---------------------------------------------------------------------------
# The XLA path against the port's own day march
# ---------------------------------------------------------------------------

#: mode -> (nomass_fixed_iters, run keywords, fast_runner keywords, heatx's tolerance)
ROUTES = {
    "parity": (2, dict(mode="parity"), dict(mode="parity"), 1e-10),
    "parity_adaptive": (None, dict(mode="parity"), dict(mode="parity"), 5e-8),
    "trbdf2_refresh": (2, dict(mode="trbdf2_refresh", substeps=8, refresh_every=2),
                       dict(mode="trbdf2_refresh", substeps=8, refresh_every=2), 1e-12),
}


@pytest.mark.parametrize("mode", list(ROUTES))
def test_xla_path_matches_plain_day_march(mode, monkeypatch):
    monkeypatch.setenv("HEATX_KERNEL_WHILE", "1")
    iters, run_kw, fast_kw, atol = ROUTES[mode]
    _, tm = _models(iters)
    seq = testing.bench_inputs(tm.building, HOURS)
    fields = {f.name: getattr(seq, f.name) for f in dataclasses.fields(seq) if getattr(seq, f.name) is not None}
    final, hist = tm.run(tm.initial_state(), tm.inputs_sequence(HOURS, **fields), **run_kw)
    runner = tm.fast_runner(hours=HOURS, use_kernel=False, **fast_kw)
    k_final, k_hist = runner.run(tm.initial_state(), seq)
    _close(hist, k_hist, atol, "zone_T history")
    _check_state(final, k_final, np.asarray(tm.building.surfaces.node_mask), atol)
    assert np.ptp(hist.numpy()) > 1.0
