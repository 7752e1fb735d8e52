"""The port's device-physics twins against heatx on the same random operands
(f64): tridiagonal ops, TARP convection, the surface border conditions and
forcing, the TR-BDF2 operators, and the air properties.

Tolerance rtol 1e-12: both sides evaluate the same formulas in the same
order, but the cube root and power functions of the two libraries (and any
fused multiply-adds) may differ by a few ulps.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatx
from heatx.engine import exponential as hx_exp
from heatx.engine import implicit as hx_imp
from heatx.engine import surface as hx_surf
from heatx.ops import tridiag as hx_tri
from heatx.physics import convection as hx_conv
from heatx.physics import gas as hx_gas
from heatx_torch import SimConfig
from heatx_torch.engine import implicit as imp
from heatx_torch.engine import surface as surf
from heatx_torch.ops import tridiag as tri
from heatx_torch.physics import convection as conv
from heatx_torch.physics import gas

torch.set_num_threads(1)

RTOL = 1e-12
N, S = 9, 23


def close(port, ref, atol=0.0):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=atol)


def t(a):
    return torch.as_tensor(np.array(a))


def _system(seed):
    """A random diagonally dominant tridiagonal system [N, S] with some
    identity rows (the padding encoding)."""
    rng = np.random.default_rng(seed)
    lower = rng.uniform(-1, 1, (N, S))
    upper = rng.uniform(-1, 1, (N, S))
    diag = 2.5 + rng.uniform(0, 2, (N, S))
    ident = rng.uniform(size=(N, S)) < 0.2
    lower[ident] = upper[ident] = 0.0
    diag[ident] = 1.0
    return lower, diag, upper, rng.uniform(-5, 30, (N, S))


@pytest.mark.parametrize("seed", [0, 1])
def test_tridiag_matvec_and_thomas(seed):
    lo, d, up, x = _system(seed)
    close(tri.matvec(t(lo), t(d), t(up), t(x)), hx_tri.matvec(lo, d, up, x))
    cs, inv = tri.factor(t(lo), t(d), t(up))
    hcs, hinv = hx_tri.factor(lo, d, up)
    close(cs, hcs)
    close(inv, hinv)
    close(tri.solve_factored(t(lo), cs, inv, t(x)), hx_tri.solve_factored(lo, hcs, hinv, x))


@pytest.mark.parametrize("seed", [0, 1])
def test_tridiag_pcr(seed):
    lo, d, up, x = _system(seed)
    levels, inv_b = tri.pcr_factor(t(lo), t(d), t(up))
    hlev, hinv_b = hx_tri.pcr_factor(lo, d, up)
    close(inv_b, hinv_b)
    close(tri.pcr_apply(levels, inv_b, t(x)), hx_tri.pcr_apply(hlev, hinv_b, x), atol=1e-12)


def _faces(seed):
    rng = np.random.default_rng(seed)
    air = rng.uniform(-10, 35, S)
    srf = air + rng.choice([0.0, 1e-4, 0.3, -2.0, 8.0], S) * rng.uniform(0.5, 1, S)
    cos_t = rng.choice([0.0, 1.0, -1.0, 0.5, -0.3, 1e-4], S)
    return air, srf, cos_t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tarp_natural(seed):
    air, srf, cos_t = _faces(seed)
    c_p = conv.tarp_natural_coeffs(t(cos_t))
    c_h = hx_conv.tarp_natural_coeffs(cos_t)
    close(c_p[0], c_h[0])
    close(c_p[1], c_h[1])
    # heatx's day kernel form (pow-based cube root, hoisted coefficients).
    close(
        conv.tarp_natural_convection_coefficient(t(air), t(srf), t(cos_t), c_p),
        hx_conv.tarp_natural_convection_coefficient(air, srf, cos_t, mosaic_compat=True, coeffs=c_h),
    )
    # heatx's XLA form (cbrt, per-branch division): the same h to round-off.
    close(
        conv.tarp_natural_convection_coefficient(t(air), t(srf), t(cos_t)),
        hx_conv.tarp_natural_convection_coefficient(air, srf, cos_t),
    )


@pytest.mark.parametrize("wd", [0.0, 0.7, 2.5, 4.4])
def test_is_windward(wd):
    rng = np.random.default_rng(3)
    nx, ny = rng.uniform(-1, 1, S), rng.uniform(-1, 1, S)
    cos_t = rng.choice([0.0, 0.99, -0.99, 0.3], S)
    np.testing.assert_array_equal(
        conv.is_windward(wd, t(cos_t), t(nx), t(ny)).numpy(),
        np.asarray(hx_conv.is_windward(wd, cos_t, nx, ny)),
    )


def _batch(seed):
    """Random surface batches in both packages' forms: node columns of 1..N
    nodes, outdoor/space/ambient faces, some pinned convection coefficients."""
    rng = np.random.default_rng(seed)
    n_nodes = rng.integers(1, N + 1, S)
    node_mask = np.arange(N)[:, None] < n_nodes[None, :]
    massive = node_mask & (rng.uniform(size=(N, S)) < 0.7)
    fixed_hf = np.where(rng.uniform(size=S) < 0.15, 20.0, np.nan)
    fields = dict(
        node_mask=node_mask,
        massive=massive,
        mass=np.where(node_mask, rng.uniform(1e3, 1e5, (N, S)), 0.0),
        seg_u=np.where(node_mask, rng.uniform(0.5, 60.0, (N, S)), 0.0),
        front_alphas=np.where(node_mask, rng.uniform(0, 0.5, (N, S)), 0.0),
        back_alphas=np.where(node_mask, rng.uniform(0, 0.2, (N, S)), 0.0),
        area=rng.uniform(1, 40, S),
        perimeter=rng.uniform(0, 30, S),
        cos_tilt=rng.choice([0.0, 1.0, -1.0, 0.2], S),
        wind_mod=rng.uniform(0.5, 1.5, S),
        eps_front=rng.uniform(0.1, 0.95, S),
        eps_back=rng.uniform(0.1, 0.95, S),
        rf=np.full(S, 1.67),
        front_code=rng.integers(0, 3, S).astype(np.int32),
        back_code=rng.integers(0, 3, S).astype(np.int32),
        front_temp=rng.uniform(0, 30, S),
        back_temp=rng.uniform(0, 30, S),
        fixed_h_front=fixed_hf,
        fixed_h_back=np.where(rng.uniform(size=S) < 0.15, 5.0, np.nan),
    )
    nx, ny = rng.uniform(-1, 1, S), rng.uniform(-1, 1, S)
    hx = SimpleNamespace(
        **fields, normal=(nx, ny), has_cavity=False,
        same_chunk=np.zeros((N, S), bool), nomass_chunk_id=-np.ones((N, S), np.int32),
        nomass_chunk_count=np.zeros((1, S)),
    )
    port = SimpleNamespace(
        **{k: t(v) for k, v in fields.items()}, normal=(t(nx), t(ny)), has_cavity=False
    )
    T = np.where(node_mask, rng.uniform(-5, 35, (N, S)), 0.0)
    return hx, port, T, rng


@pytest.mark.parametrize("seed", [0, 1])
def test_statics_and_last_node(seed):
    hx, port, T, _ = _batch(seed)
    hst, pst = hx_surf.compute_statics(hx), surf.compute_statics(port)
    for name in ("left_exists", "right_exists", "is_first", "is_last"):
        np.testing.assert_array_equal(getattr(pst, name).numpy(), np.asarray(getattr(hst, name)))
    close(surf._last_node(port, t(T), pst), hx_surf._last_node(hx, T, hst))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ambient_bug", [True, False])
def test_border_conditions(seed, ambient_bug):
    hx, port, T, rng = _batch(seed)
    t_front, t_back = rng.uniform(-10, 30, S), rng.uniform(15, 25, S)
    ir_f, ir_b = rng.uniform(200, 420, S), rng.uniform(0, 420, S)
    wd, ws = 1.3, 4.2
    h_cfg = heatx.SimConfig(dtype=jnp.float64, kernel_mode=True,
                            replicate_ambient_back_bug=ambient_bug)
    p_cfg = SimConfig(dtype=torch.float64, replicate_ambient_back_bug=ambient_bug)
    hst, pst = hx_surf.compute_statics(hx), surf.compute_statics(port)
    h_env = hx_surf.border_conditions(hx, T, t_front, t_back, wd, ws, ir_f, ir_b, h_cfg, statics=hst)
    p_env = surf.border_conditions(port, t(T), t(t_front), t(t_back), wd, ws, t(ir_f), t(ir_b),
                                   p_cfg, statics=pst)
    for he, pe in zip(h_env, p_env):
        for k in range(4):
            close(pe[k], he[k])
        close(surf.linearized_rad_coefficient(port.eps_front, pe),
              hx_surf.linearized_rad_coefficient(hx.eps_front, he))
    close(surf.radiant_out_temperatures(t(ir_f), t(ir_b))[1],
          hx_surf.radiant_out_temperatures(ir_f, ir_b, jnp.float64)[1])
    for pf, hf in zip(surf.forced_context(port, wd, ws), hx_surf.forced_context(hx, wd, ws)):
        close(pf, hf)


@pytest.mark.parametrize("seed", [0, 1])
def test_operators_and_forcing(seed):
    hx, port, T, rng = _batch(seed)
    hst, pst = hx_surf.compute_statics(hx), surf.compute_statics(port)
    cfg_h = heatx.SimConfig(dtype=jnp.float64, kernel_mode=True)
    t_front, t_back = rng.uniform(-10, 30, S), rng.uniform(15, 25, S)
    ir = rng.uniform(250, 400, S)
    h_env = hx_surf.border_conditions(hx, T, t_front, t_back, 0.4, 3.0, ir, ir, cfg_h, statics=hst)
    p_env = tuple(surf.FaceEnv(*(t(np.asarray(x)) for x in e)) for e in h_env)
    rad_f = hx_surf.linearized_rad_coefficient(hx.eps_front, h_env[0])
    rad_b = hx_surf.linearized_rad_coefficient(hx.eps_back, h_env[1])
    np.testing.assert_array_equal(surf.segment_u(port, t(T), p_env[1].air).numpy(),
                                  np.asarray(hx_surf.segment_u(hx, T, h_env[1].air)))
    sol_f = rng.uniform(-50, 600, S)
    sol_f[:3] = np.nan
    sol_b = rng.uniform(0, 100, S)
    sol_b[3] = np.nan
    sq_h = hx_surf.absorbed_solar_q(hx, sol_f, sol_b)
    sq_p = surf.absorbed_solar_q(port, t(sol_f), t(sol_b))
    close(sq_p, sq_h)
    K_h = hx_exp._full_system_K(hx, hx.seg_u, *h_env, rad_f, rad_b, hst)
    K_p = imp._full_system_K(port, port.seg_u, *p_env, t(np.asarray(rad_f)), t(np.asarray(rad_b)), pst)
    for a, b in zip(K_p, K_h):
        close(a, b)
    close(imp._substep_forcing(*p_env, t(np.asarray(rad_f)), t(np.asarray(rad_b)), sq_p, pst),
          hx_exp._substep_forcing(*h_env, rad_f, rad_b, sq_h, hst))
    C = np.where(hx.massive, hx.mass, 0.0)
    a_dt = hx_imp.GAMMA * 450.0 / 2.0
    for a, b in zip(imp._stage_matrix(port, K_p, t(C), a_dt),
                    hx_imp._stage_matrix(hx, K_h, C, a_dt)):
        close(a, b)


def test_scheme_constants_and_air():
    assert (imp.GAMMA, imp.BETA, imp.C1, imp.C2) == (
        hx_imp.GAMMA, hx_imp.BETA, hx_imp.C1, hx_imp.C2
    )
    t_k = np.linspace(250.0, 320.0, 11)
    close(gas.density(gas.AIR, t(t_k)), hx_gas.density(hx_gas.AIR, t_k))
    close(gas.heat_capacity(gas.AIR, t(t_k)), hx_gas.heat_capacity(hx_gas.AIR, t_k))
    assert tuple(gas.GASES) == tuple(hx_gas.GASES)
    for name in gas.GASES:
        assert tuple(gas.GASES[name]) == tuple(hx_gas.GASES[name])
