"""Interior MRT in the port against heatx, f64, CPU: the gradients.

* The plain day adjoint with ``interior_mrt`` against heatx's adjoint kernel
  in interpret mode (trbdf2, one operator over the hour's two sub-steps),
  1e-9 of max |ref| on every output, the effective emissivities' cotangents
  ``mrt_eps_f``/``mrt_eps_b`` included.
* The plain parity adjoint with ``interior_mrt`` against central differences
  of the plain parity march (1 and 2 no-mass iterations) along the start
  state, ``mrt_eps_b``, and ``eps_back`` and ``area`` through the network's
  statics (``mrt_eps_blocked``).
* ``FastRunner.chunk_forward``/``chunk_grad`` with the emissivities and the
  areas as parameters against heatx's pure-XLA chunked adjoint (the
  reference heatx's own tests/test_kernel_adjoint.py:856 holds its
  ``chunk_grad`` to), rtol 1e-8, and against central differences of the
  port's own chunked value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
import heatx.model.building as hmb
from heatx.build.layout import compile_building as hx_compile
from heatx.engine import implicit as hx_imp
from heatx.engine.adjoint import chunked_value_and_grad as hx_chunked_value_and_grad
from heatx.ops import pallas_adjoint, pallas_step
from heatx_torch import SimConfig, ThermalModel, testing
from heatx_torch.build.layout import compile_building
from heatx_torch.engine.adjoint import chunked_value_and_grad, tree_map
from heatx_torch.model import building as pmb
from heatx_torch.ops import day_adjoint, day_march
from torch_reference import unoptimized

torch.set_num_threads(1)

ADJ_RTOL = 1e-9  # of max |ref|, per output
GRAD_RTOL = 1e-8
FD_RTOL = 1e-5  # central differences, eps 1e-6, of the f64 march


def t(a):
    return torch.as_tensor(np.asarray(a))


def _flat(g):
    out = {k: v for k, v in g.items() if k != "d_params"}
    out.update({"p:" + k: v for k, v in g["d_params"].items()})
    return out


def _unblock(lay, S, Z, g):
    out = {}
    for k, v in g.items():
        v = np.asarray(v)
        if k in ("d_zT0", "d_zone_volume"):
            out[k] = lay.zones_from_blocked(v, Z)
        elif k in ("d_a_extra", "d_b_extra"):
            out[k] = np.stack([lay.zones_from_blocked(x, Z) for x in v])
        else:
            out[k] = lay.surfaces_from_blocked(v, S)
    return out


def _day(lay, b, sub, hours, seed=7):
    """Seeded hour inputs, start state and cotangents of one launch."""
    rng = np.random.default_rng(seed)
    S, Z = b.n_surfaces, b.n_zones
    SP, NB, ZB = lay.padded_surfaces, lay.n_blocks, lay.zones_per_block
    hi = (
        rng.uniform(-10, 5, hours * sub), rng.uniform(0, 8, hours * sub), rng.uniform(0, 6.28, hours * sub),
        np.stack([lay.surfaces_to_blocked(rng.uniform(0, 500, S)) for _ in range(hours)]), np.zeros((hours, SP)),
        np.stack([lay.surfaces_to_blocked(rng.uniform(250, 400, S)) for _ in range(hours)]), np.zeros((hours, SP)),
        np.stack([lay.zones_to_blocked(rng.uniform(100, 900, Z))] * hours), np.zeros((hours, NB, ZB)),
    )
    mask = np.asarray(b.surfaces.node_mask)
    T0 = lay.surfaces_to_blocked(np.where(mask, rng.uniform(5, 28, mask.shape), 0.0))
    zT0 = lay.zones_to_blocked(rng.uniform(17, 27, Z))
    cots = (lay.surfaces_to_blocked(np.where(mask, rng.normal(size=mask.shape), 0.0)),
            lay.zones_to_blocked(rng.normal(size=Z)),
            np.stack([lay.zones_to_blocked(rng.normal(size=Z)) for _ in range(hours)]))
    return hi, T0, zT0, cots


def test_plain_adjoint_with_mrt_matches_heatx_kernel():
    kw = dict(substeps=2, mode="trbdf2", hours=1)
    hb = hx_compile(testing.build_two_zone_model(hmb), n=1,
                    config=heatx.SimConfig(dtype=jnp.float64, interior_mrt=True))
    pb = compile_building(testing.build_two_zone_model(pmb), n=1,
                          config=SimConfig(dtype=torch.float64, interior_mrt=True))
    hbb = pallas_step.block_building(hb, block_size=8, node_split=None)
    _, params = pallas_step.make_hour_march(hbb, interpret=True, **kw)
    adj = pallas_adjoint.make_day_adjoint(hbb, interpret=True, **kw)
    hi, T0, zT0, cots = _day(hbb.layout, hb, 2, 1)
    ref = unoptimized(adj)(params, jnp.asarray(T0), jnp.asarray(zT0), tuple(jnp.asarray(x) for x in hi),
                           tuple(jnp.asarray(c) for c in cots) + (None,))
    ref = _unblock(hbb.layout, hb.n_surfaces, hb.n_zones, _flat(ref))

    pbb = day_march.block_building(pb, block_size=8)
    assert np.array_equal(np.asarray(pbb.layout.surf_perm), np.asarray(hbb.layout.surf_perm))
    _, pparams = day_march.make_hour_march(pbb, device="cpu", **kw)
    padj = day_adjoint.make_day_adjoint(pbb, device="cpu", **kw)
    g = padj(pparams, t(T0), t(zT0), tuple(t(x) for x in hi), tuple(t(c) for c in cots))
    got = _unblock(pbb.layout, pb.n_surfaces, pb.n_zones, {k: v.numpy() for k, v in _flat(g).items()})
    assert sorted(got) == sorted(ref) and "p:mrt_eps_f" in got and "p:mrt_eps_b" in got
    for name, r in ref.items():
        scale = np.abs(r).max()
        np.testing.assert_allclose(got[name], r, rtol=0, atol=ADJ_RTOL * scale, err_msg=name)
    assert np.abs(got["p:mrt_eps_b"]).max() > 0 and np.abs(got["p:mrt_eps_f"]).max() > 0


def _mrt_rows(bb, surf):
    f = day_march.SURF_FIELDS.index
    return torch.stack(day_march.mrt_eps_blocked(
        surf[f("area")], surf[f("eps_front")], surf[f("eps_back")], t(bb.mrt_part),
        t(bb.front_oh).double(), t(bb.back_oh).double(), bb.n_blocks, bb.zones_per_block))


@pytest.mark.parametrize("iters", [1, 2])
def test_plain_parity_adjoint_with_mrt_matches_finite_differences(iters):
    tm = ThermalModel(testing.build_two_zone_model(), device="cpu",
                      config=testing.coarse_config(nomass_fixed_iters=iters, interior_mrt=True))
    pb = tm.building
    bb = day_march.block_building(pb)
    sub = pb.dt_subdivisions
    hm, params = day_march.make_hour_march(bb, mode="parity", hours=1, device="cpu")
    adj = day_adjoint.make_day_adjoint(bb, substeps=sub, mode="parity", hours=1, device="cpu")
    hi, T0, zT0, cots = _day(bb.layout, pb, sub, 1)
    hi, T0, zT0, cots = tuple(t(x) for x in hi), t(T0), t(zT0), tuple(t(c) for c in cots)
    g = _flat(adj(params, T0, zT0, hi, cots))

    def loss(p, T):
        out = hm(p, T, zT0, hi)
        return float((out[0] * cots[0]).sum() + (out[1] * cots[1]).sum() + (out[3] * cots[2]).sum())

    rng = np.random.default_rng(2)
    row = day_march.SURF_FIELDS.index
    lanes = t(np.asarray(bb.layout.surf_perm) >= 0)
    D_T = t(rng.normal(size=T0.shape)) * day_march.bit_rows(params, "node_bits")
    D_m = t(rng.normal(size=params.mrt.shape[1])) * params.mrt[1]

    def moved_mrt(e):
        mrt = params.mrt.clone()
        mrt[1] += e * D_m
        return dataclasses.replace(params, mrt=mrt)

    def chained(name):
        """Move a surface row and the network rows built from it."""
        D = t(rng.normal(size=params.surf.shape[1])) * params.surf[row(name)] * lanes

        def at(e):
            surf = params.surf.clone()
            surf[row(name)] += e * D
            return dataclasses.replace(params, surf=surf, mrt=_mrt_rows(bb, surf))

        def rows_of(x):
            surf = params.surf.clone()
            surf[row(name)] = x
            return _mrt_rows(bb, surf)

        _, dm = torch.func.jvp(rows_of, (params.surf[row(name)],), (D,))
        an = (g["p:" + name] * D).sum() + (g["p:mrt_eps_f"] * dm[0]).sum() + (g["p:mrt_eps_b"] * dm[1]).sum()
        return float(an), lambda e: loss(at(e), T0)

    eps = 1e-6
    checks = [("T0", float((g["dT0"] * D_T).sum()), lambda e: loss(params, T0 + e * D_T)),
              ("mrt_eps_b", float((g["p:mrt_eps_b"] * D_m).sum()), lambda e: loss(moved_mrt(e), T0)),
              ("eps_back", *chained("eps_back")), ("area", *chained("area"))]
    for name, an, f in checks:
        fd = (f(eps) - f(-eps)) / (2 * eps)
        assert an != 0 and abs(fd - an) <= FD_RTOL * abs(an), (name, fd, an)


# ---------------------------------------------------------------------------
# chunked_value_and_grad
# ---------------------------------------------------------------------------

T_STEPS, CHUNKS, SUBS = 4, 2, 2


def _seq_kw(n_hvacs):
    return dict(t_out=5.0 + 8.0 * np.sin(np.arange(T_STEPS) / 4), wind_speed=3.0, wind_direction=45.0,
                hvac_power=np.full(n_hvacs, 800.0))


def test_chunked_value_and_grad_with_mrt_matches_heatx_xla():
    """heatx tests/test_kernel_adjoint.py:856's calibration, on the two-zone
    building with three parameters: scales of the back and front
    emissivities and of the areas.  The port's chunk_grad pulls the
    adjoint's ``mrt_eps_*`` cotangents back through ``mrt_eps_blocked``;
    heatx's XLA path differentiates the whole composition natively."""
    cfg = heatx.SimConfig(dtype=jnp.float64, interior_mrt=True)
    tm = heatx.ThermalModel(testing.build_two_zone_model(hmb), n=1, config=cfg)
    building = tm._device()
    seq = tm.inputs_sequence(T_STEPS, **_seq_kw(building.n_hvacs))
    xs = jax.tree.map(lambda v: (v.reshape((CHUNKS, T_STEPS // CHUNKS) + v.shape[1:])
                                 if v.ndim and v.shape[0] == T_STEPS
                                 else jnp.broadcast_to(v, (CHUNKS, T_STEPS // CHUNKS) + v.shape)), seq)
    sb0 = building.surfaces

    def hx_params(p):
        sb = dataclasses.replace(sb0, eps_back=sb0.eps_back * p["eb"], eps_front=sb0.eps_front * p["ef"],
                                 area=sb0.area * p["a"])
        return dataclasses.replace(building, surfaces=sb)

    def chunk_fn(p, state, xs):
        b = hx_params(p)

        def hour(s, x):
            s = hx_imp.imp_march(b, s, x, substeps=SUBS)
            return s, s.zone_T

        state, zt = jax.lax.scan(hour, state, xs)
        return state, jnp.mean((zt - 21.0) ** 2) / CHUNKS

    guess = {"eb": jnp.asarray(0.9), "ef": jnp.asarray(1.1), "a": jnp.asarray(1.05)}
    val, g = hx_chunked_value_and_grad(chunk_fn, guess, tm.initial_state(), xs)
    ref = [float(val)] + [float(g[k]) for k in ("eb", "ef", "a")]

    ptm = ThermalModel(testing.build_two_zone_model(), n=1, device="cpu",
                       config=SimConfig(dtype=torch.float64, interior_mrt=True))
    b = ptm.building
    pxs = tree_map(lambda v: v.reshape((CHUNKS, T_STEPS // CHUNKS) + tuple(v.shape[1:]))
                   if v.ndim and v.shape[0] == T_STEPS
                   else torch.broadcast_to(v, (CHUNKS, T_STEPS // CHUNKS) + tuple(v.shape)),
                   ptm.inputs(**{k: (np.broadcast_to(v, (T_STEPS,)) if k != "hvac_power" else v)
                                 for k, v in _seq_kw(b.n_hvacs).items()}))
    eb0, ef0, a0 = (t(getattr(b.surfaces, k)) for k in ("eps_back", "eps_front", "area"))

    def with_params(p):
        sb = dataclasses.replace(b.surfaces, eps_back=eb0 * p["eb"], eps_front=ef0 * p["ef"], area=a0 * p["a"])
        return dataclasses.replace(b, surfaces=sb)

    def loss_fn(zt, xs):
        return torch.mean((zt - 21.0) ** 2) / CHUNKS

    runner = ptm.fast_runner(mode="trbdf2", substeps=SUBS, hours=T_STEPS // CHUNKS)
    kf, kb = runner.chunk_forward(with_params, loss_fn), runner.chunk_grad(with_params, loss_fn)

    def value_and_grad(p):
        p = {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}
        val, g = chunked_value_and_grad(None, p, ptm.initial_state(), pxs, forward_fn=kf, backward_fn=kb)
        return [float(val)] + [float(g[k]) for k in ("eb", "ef", "a")]

    p0 = {k: float(v) for k, v in guess.items()}
    got = value_and_grad(p0)
    np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL)
    assert all(abs(x) > 0 for x in got)
    # The port's own value, by central differences in each parameter.
    eps = 1e-6
    for i, k in enumerate(("eb", "ef", "a")):
        up = value_and_grad({**p0, k: p0[k] + eps})[0]
        dn = value_and_grad({**p0, k: p0[k] - eps})[0]
        fd = (up - dn) / (2 * eps)
        assert abs(fd - got[1 + i]) <= FD_RTOL * abs(got[1 + i]), (k, fd, got[1 + i])
