"""heatx_torch.engine.zone against heatx.engine.zone, f64, CPU, and the port's
blocking of thermostat rows and mixing flows against heatx's.

``zone_update`` runs on 4,000 seeded zone rows that take every branch of
the setpoint-landing control (heating and cooling, each free and clamped,
the deadband, |B| ~ 0, never-act sentinels) and agrees with heatx's at rtol
1e-12 (both are the same closed form; measured ~1e-15).  Its autograd
gradient agrees with ``jax.grad`` of heatx's at rtol 1e-9 on rows that sit
on no tie (asserted), and is exactly zero, not NaN, on sentinel slots.
No kernel is compiled here: heatx's functions run under one ``jax.jit``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
from heatx.build.layout import compile_building as hx_compile
from heatx.engine import zone as hx_zone
from heatx.ops import pallas_step
from heatx_torch import SimConfig, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.engine import zone as zone_mod
from heatx_torch.ops import day_march
from torch_thermostat_case import heatx_thermostat_model

torch.set_num_threads(1)

RTOL = 1e-12
N = 4000
DT = 450.0
NAMES = ("zone_T", "a", "b", "c", "heat_sp", "cool_sp", "max_heat", "max_cool")


def _rows():
    """Seeded zone rows, in heatx's argument order.  Free-float targets a/b
    span 5..35 C around setpoints near 20/26 C, so heating, cooling and the
    deadband all occur; a third of the capacities are small enough to clamp,
    some are infinite; some rows are uncontrolled (sentinels, zero capacity)
    and some have |B| <= 1e-9."""
    rng = np.random.default_rng(5)
    zone_T = rng.uniform(12.0, 32.0, N)
    b = rng.uniform(20.0, 400.0, N)
    b[:40] = rng.uniform(-1e-9, 1e-9, 40)  # hold, control stands down
    a = b * rng.uniform(5.0, 35.0, N)
    c = rng.uniform(1e5, 4e5, N)
    heat_sp = rng.uniform(18.0, 22.0, N)
    cool_sp = heat_sp + rng.uniform(2.0, 6.0, N)
    max_heat = np.where(rng.random(N) < 0.33, rng.uniform(10.0, 300.0, N), np.inf)
    max_cool = np.where(rng.random(N) < 0.33, rng.uniform(10.0, 300.0, N), np.inf)
    off = slice(40, 140)  # uncontrolled zones of a controlled building
    heat_sp[off], cool_sp[off], max_heat[off], max_cool[off] = day_march.CTL_FILL
    return dict(zip(NAMES, (zone_T, a, b, c, heat_sp, cool_sp, max_heat, max_cool)))


def _heatx_update(r):
    bld = SimpleNamespace(
        has_ideal_hvac=True, ctl_heat_sp=r["heat_sp"], ctl_cool_sp=r["cool_sp"],
        ctl_max_heat=r["max_heat"], ctl_max_cool=r["max_cool"],
    )
    return hx_zone.zone_update(bld, r["zone_T"], r["a"], r["b"], r["c"], DT)


@pytest.fixture(scope="module")
def rows():
    return _rows()


def _torch_rows(r, grad=()):
    return [torch.as_tensor(r[k]).requires_grad_(k in grad) for k in NAMES]


def test_zone_update_matches_heatx_on_every_branch(rows):
    t = _torch_rows(rows)
    counts = testing.branch_counts(t[0], t[1], t[2], t[3], DT, *t[4:])
    print("zone rows per branch:", counts)
    for name in ("heating", "cooling", "clamped", "deadband", "smallb"):
        assert counts[name] > 20, counts
    assert counts["ties"] == 0, counts
    ref_T, ref_load = jax.jit(lambda r: _heatx_update(r))({k: jnp.asarray(v) for k, v in rows.items()})
    got_T, got_load = zone_mod.zone_update(t[0], t[1], t[2], t[3], DT, *t[4:])
    np.testing.assert_allclose(got_T.numpy(), np.asarray(ref_T), rtol=RTOL, atol=0)
    np.testing.assert_allclose(got_load.numpy(), np.asarray(ref_load), rtol=RTOL, atol=1e-12 * 1e4)
    # Clamped rows sit on their capacity, free ones land on the setpoint.
    load = got_load.numpy()
    heating = load > 0
    free_heat = heating & (load < rows["max_heat"])
    assert free_heat.sum() > 20
    np.testing.assert_allclose(got_T.numpy()[free_heat], rows["heat_sp"][free_heat], rtol=0, atol=1e-9)
    assert (load[40:140] == 0).all() and (load[:40] == 0).all()


def test_future_zone_temperatures_matches_heatx(rows):
    t = _torch_rows(rows)
    ref = jax.jit(hx_zone.future_zone_temperatures, static_argnums=4)(
        *(jnp.asarray(rows[k]) for k in ("zone_T", "a", "b", "c")), DT)
    got = zone_mod.future_zone_temperatures(t[0], t[1], t[2], t[3], DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got.numpy()[:40], rows["zone_T"][:40])  # |B| ~ 0 holds


def test_zone_update_gradient_matches_jax_off_the_ties(rows):
    """Off the clamp limits and branch edges torch.clamp/where and jnp.clip/
    where differentiate alike; the rows sit on no tie (asserted above)."""
    diff = ("zone_T", "a", "b", "c", "heat_sp", "cool_sp")
    rng = np.random.default_rng(6)
    wT, wl = rng.normal(size=N), rng.normal(size=N) * 1e-2

    def hx_loss(d):
        T, load = _heatx_update({**{k: jnp.asarray(v) for k, v in rows.items()}, **d})
        return jnp.sum(T * wT) + jnp.sum(load * wl)

    ref = jax.jit(jax.grad(hx_loss))({k: jnp.asarray(rows[k]) for k in diff})
    t = _torch_rows(rows, grad=diff)
    T, load = zone_mod.zone_update(t[0], t[1], t[2], t[3], DT, *t[4:])
    loss = (T * torch.as_tensor(wT)).sum() + (load * torch.as_tensor(wl)).sum()
    got = dict(zip(diff, torch.autograd.grad(loss, [x for x in t if x.requires_grad])))
    for k in diff:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9 * np.abs(r).max(), err_msg=k)
    # Sentinel slots: exact zeros for the setpoints, nothing non-finite.
    assert (got["heat_sp"].numpy()[40:140] == 0).all() and (got["cool_sp"].numpy()[40:140] == 0).all()
    assert np.abs(got["heat_sp"].numpy()).max() > 0 and np.abs(got["cool_sp"].numpy()).max() > 0


@pytest.mark.parametrize("uncontrolled", [True, False])
def test_blocking_ctl_rows_and_mixing_match_heatx(uncontrolled):
    """``block_building``'s four thermostat rows (never-act sentinels in
    padded and uncontrolled slots) and its mixing entries equal heatx's
    ``bb.ctl`` and dense ``bb.mix_wt`` exactly."""
    hb = hx_compile(heatx_thermostat_model(uncontrolled), n=1, config=heatx.SimConfig(dtype=jnp.float64))
    pb = compile_building(testing.build_thermostat_model(uncontrolled), n=1, config=SimConfig(dtype=torch.float64))
    ref = pallas_step.block_building(hb, block_size=16, node_split=None)
    got = day_march.block_building(pb, block_size=16)
    np.testing.assert_array_equal(got.layout.zone_table, ref.layout.zone_table)
    assert len(got.ctl) == 4
    for g, r, fill in zip(got.ctl, ref.ctl, day_march.CTL_FILL):
        np.testing.assert_array_equal(g, np.asarray(r))
        assert (g[~got.zone_valid] == fill).all()
    if uncontrolled:
        slot = np.asarray(got.layout.zone_table) == 3
        assert [float(c[slot][0]) for c in got.ctl] == list(day_march.CTL_FILL)
    ZB = got.zones_per_block
    np.testing.assert_array_equal(got.mix.dense(ZB), np.asarray(ref.mix_wt))
    assert np.count_nonzero(ref.mix_wt) == 3
    # The transposed lists hold the same entries, grouped by source.
    t = day_march.MixLists(got.mix.t_ptr, got.mix.t_dst, got.mix.t_vol, None, None, None)
    slot = np.repeat(np.arange(len(t.ptr) - 1), np.diff(t.ptr))
    W = np.zeros_like(ref.mix_wt)
    W[slot, t.src] = t.vol
    np.testing.assert_array_equal(W, np.asarray(ref.mix_wt))
    # ... and heatx's dense matrix converts to the same lists.
    back = day_march.mix_lists_from_dense(ref.mix_wt)
    for name in ("ptr", "src", "vol", "t_ptr", "t_dst", "t_vol"):
        np.testing.assert_array_equal(getattr(back, name), getattr(got.mix, name), err_msg=name)


def test_param_blocker_blocks_setpoints_differentiably():
    """ParamBlocker re-blocks ctl_heat_sp/ctl_cool_sp with the sentinels in
    padded slots, equal to params_from_blocked, and routes cotangents back."""
    pb = compile_building(testing.build_thermostat_model(), n=1, config=SimConfig(dtype=torch.float64))
    bb = day_march.block_building(pb, block_size=16)
    ref = day_march.params_from_blocked(bb, torch.float64, "cpu")
    heat = torch.as_tensor(pb.ctl_heat_sp).requires_grad_()
    got = day_march.ParamBlocker(bb, "cpu")(ref, pb.surfaces, pb.zone_volume, heat, pb.ctl_cool_sp)
    torch.testing.assert_close(got.ctl, ref.ctl, rtol=0, atol=0)
    (g,) = torch.autograd.grad(got.ctl[0].sum(), heat)
    assert torch.equal(g, torch.ones_like(g))
