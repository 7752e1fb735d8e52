"""Gradient-based optimal control: minimal-energy heating schedules.

heatx_torch's counterpart of examples/optimal_control.py.  Two
model-predictive-control phases, both solved through the physics:

1. HEATER POWER schedule (the XLA path): autograd through a loop of the
   TR-BDF2 integrator (``heatx_torch.engine.implicit.imp_march``, 8
   sub-steps an hour) with respect to a 24-hour heater power series, to find
   the cheapest schedule that holds a comfort setpoint through a cold day.
   It runs plain PyTorch on the model's device, no kernel, as heatx's phase
   runs plain XLA.
2. THERMOSTAT SETPOINT schedule (the kernel-adjoint path): a thermostatic
   (ideal-loads) zone whose heating-setpoint schedule is the optimization
   variable, run through the day march on both sweeps:
   ``FastRunner.chunk_forward``/``chunk_grad`` with ``schedule_fn`` pull the
   per-hour setpoint cotangents of the day adjoint (``d_sp_heat``) back into
   the schedule parameters, with a finite-difference gate on the gradient
   before optimizing.  On the card both sweeps are the CUDA day kernels; on
   the CPU their plain PyTorch versions.

Deliberate differences from heatx: both phases run in float64 on the card
(heatx pins the CPU only because the TPU has no float64); the optimizer is
``torch.optim.Adam`` with optax's defaults (betas 0.9/0.999, eps 1e-8 outside
the square root); ``setpoint_problem(..., zones=2)`` gives every zone its
own schedule, and ``fd_gate`` then holds the gradient to central
differences zone by zone (heatx's one zone shares one schedule, where a
permutation of the zones' cotangents cannot show).

Run:  python examples_torch/optimal_control.py [--platform gpu|cpu] [--phase 1|2]
      (HEATX_EXAMPLE_FAST=1: 10 + 2 iterations, a 12 h setpoint horizon)
"""

import argparse
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

SETPOINT = 20.0
COMFORT_WEIGHT = 50.0  # K^-2 weighting of violations vs kWh
SUBS = 4  # the setpoint phase's sub-steps an hour
COMFORT, WEIGHT = 19.0, 20.0
FD_EPS = 1e-5
FD_RTOL = 1e-3


def build(zones=1, thermostat=False, classes=None):
    """heatx's one-room building (a north wall of polyurethane on concrete,
    120 m3, an electric heater, or with ``thermostat`` an ideal heater at
    20/28 C).  ``zones`` > 1 adds rooms of other sizes, each with its own
    heater.  ``classes`` is the module of the model classes (default
    ``heatx_torch.model.building``; heatx's has the same names)."""
    if classes is None:
        from heatx_torch.model import building as classes
    m = classes.BuildingModel()
    m.add_substance(classes.Substance("concrete", thermal_conductivity=0.816, density=1700.0,
                                      specific_heat_capacity=800.0))
    m.add_substance(classes.Substance("poly", thermal_conductivity=0.0252, density=17.5,
                                      specific_heat_capacity=2400.0))
    m.add_material(classes.Material("c15", "concrete", 0.15))
    m.add_material(classes.Material("p4", "poly", 0.04))
    m.add_construction(classes.Construction("wall", ["p4", "c15"]))
    for z in range(zones):
        name = "room" if z == 0 else f"room{z}"
        width = 6.0 + 3.0 * z  # the rooms differ: their gradients do too
        m.add_space(classes.SpaceDef(name, 120.0 + 60.0 * z))
        verts = np.array([[0, 0, 0], [width, 0, 0], [width, 0, 3], [0, 0, 3]], float)
        m.add_surface(classes.SurfaceDef("north" if z == 0 else f"north{z}", "wall", classes.Boundary.outdoor(),
                                         classes.Boundary.space_(name), vertices=verts))
        if thermostat:
            # The setpoint schedule is the control variable; demand is the
            # in-kernel ideal load.
            m.add_hvac(classes.IdealHeaterCooler("tstat" if z == 0 else f"tstat{z}", [name], heat_setpoint=20.0,
                                                 cool_setpoint=28.0, max_heating=1e4, max_cooling=1e4))
        else:
            m.add_hvac(classes.ElectricHeater("h" if z == 0 else f"h{z}", name))
    return m


# -- phase 1: the heater-power schedule (the XLA path) ----------------------

def power_problem(device):
    """Phase 1's model, start state and cold day."""
    from heatx_torch import SimConfig, ThermalModel
    from heatx_torch.engine.adjoint import tree_map

    cfg = SimConfig(dtype=torch.float64, nomass_fixed_iters=1)
    tm = ThermalModel(build(), n=1, config=cfg, device=device)
    T = 24
    t_out = -2.0 + 6.0 * np.sin((np.arange(T) - 8) / 24 * 2 * np.pi)  # cold day
    one = tm.inputs(t_out=0.0, wind_speed=3.0, wind_direction=45.0)
    seq = tree_map(lambda x: x.expand((T,) + tuple(x.shape)), one)
    seq = seq.replace(t_out=torch.as_tensor(t_out, dtype=torch.float64, device=device))
    return tm, seq, T


def simulate(tm, seq, T, power_kw):
    """Zone temperature [T] under the hourly heater power ``power_kw`` [T]
    (kW): a loop of ``imp_march`` at 8 sub-steps an hour, differentiable."""
    from heatx_torch.engine import implicit as imp_mod
    from heatx_torch.engine.adjoint import tree_map

    building = tm._device()
    s = tm.initial_state()
    zt = []
    for h in range(T):
        xs = tree_map(lambda v: v[h], seq)
        s = imp_mod.imp_march(building, s, xs.replace(hvac_power=power_kw[h].reshape(1) * 1e3), substeps=8)
        zt.append(s.zone_T[0])
    return torch.stack(zt)


def power_objective(tm, seq, T, raw):
    power_kw = torch.nn.functional.softplus(raw)  # nonnegative power via softplus
    zT = simulate(tm, seq, T, power_kw)
    energy = power_kw.sum()  # kWh over the day
    discomfort = (torch.clamp(SETPOINT - zT, min=0.0) ** 2).sum()
    return energy + COMFORT_WEIGHT * discomfort


def power_phase(fast, device):
    tm, seq, T = power_problem(device)
    iters = 10 if fast else 150
    raw = torch.full((T,), 1.0, dtype=torch.float64, device=device, requires_grad=True)  # ~1.3 kW flat
    opt = torch.optim.Adam([raw], lr=0.25)
    for i in range(iters):
        opt.zero_grad()
        val = power_objective(tm, seq, T, raw)
        val.backward()
        val = val.detach()
        opt.step()
        if i % 30 == 0 or i == iters - 1:
            print(f"iter {i:3d}  objective {float(val):8.2f}")
    with torch.no_grad():
        power = torch.nn.functional.softplus(raw)
        zT = simulate(tm, seq, T, power)
        worst = float(zT.min())
        kwh = float(power.sum())
        print(f"optimized schedule: {kwh:.1f} kWh, min zone T {worst:.2f} C (setpoint {SETPOINT})")
        print("hourly kW:", np.round(power.cpu().numpy(), 2))
        assert np.isfinite(worst) and np.isfinite(kwh)
        if not fast:  # 10 smoke iterations don't reach the constraint yet
            assert worst > SETPOINT - 0.5, "comfort constraint badly violated"
        flat = torch.full((T,), kwh / T, dtype=torch.float64, device=device)
        worst_flat = float(simulate(tm, seq, T, flat).min())
    print(f"same energy as a flat schedule would give min T {worst_flat:.2f} C"
          " — the optimizer shifts heat ahead of the cold hours")


# -- phase 2: the setpoint schedule (the kernel-adjoint path) ---------------

def setpoint_problem(fast, device, zones=1, use_kernel=True):
    """Phase 2's runner, sweeps and start point.  ``use_kernel=False`` runs
    the same route on the plain versions of the day march and its adjoint
    (on the card: the reference the kernels are held to)."""
    from heatx_torch import SimConfig, ThermalModel
    from heatx_torch.engine.adjoint import tree_map

    cfg = SimConfig(dtype=torch.float64, nomass_fixed_iters=1)
    tm = ThermalModel(build(zones, thermostat=True), n=1, config=cfg, device=device)
    building = tm.building
    T = 12 if fast else 24
    t_out = -12.0 + 4.0 * np.sin((np.arange(T) - 8) / 24 * 2 * np.pi)
    seq = tm.inputs_sequence(T, t_out=t_out, wind_speed=3.0, wind_direction=45.0)
    xs_chunks = tree_map(lambda v: v[None], seq)  # one chunk
    fr = tm.fast_runner(block_size=8, mode="trbdf2", substeps=SUBS, hours=T, scheduled_setpoints=True,
                        use_kernel=use_kernel)
    Z = building.n_zones
    occ = (np.arange(T) % 24 >= 8) & (np.arange(T) % 24 < 18)  # occupied
    occ_t = torch.as_tensor(occ, device=device)[:, None]

    def schedule_fn(params, xs):
        # Setpoints in (14, 22) C via sigmoid: night setback allowed.
        sp = 14.0 + 8.0 * torch.sigmoid(params["raw"])
        return {"heat_sp": (sp[:, None] if sp.ndim == 1 else sp).expand(T, Z)}

    def loss(zt, ld, xs):
        energy_kwh = ld.sum() / 1e3  # hourly mean W -> kWh
        discomfort = torch.where(occ_t, torch.clamp(COMFORT - zt, min=0.0) ** 2, 0.0).sum()
        return energy_kwh + WEIGHT * discomfort

    def apply_params(p):  # schedule-only control
        return building

    kf = fr.chunk_forward(apply_params, loss, collect_loads=True, schedule_fn=schedule_fn)
    kb = fr.chunk_grad(apply_params, loss, collect_loads=True, schedule_fn=schedule_fn)
    # Start at ~20 C (sigmoid(1.1) ~ 0.75): heating must be ACTIVE at the
    # start point; below the free-float band the thermostat never fires and
    # the schedule gradient is genuinely zero.  One schedule for all zones
    # (heatx's), or one a zone.
    shape = (T,) if zones == 1 else (T, Z)
    params = {"raw": torch.full(shape, 1.1, dtype=torch.float64, device=device)}
    return SimpleNamespace(kf=kf, kb=kb, params=params, st=tm.initial_state(), seq=seq, xs_chunks=xs_chunks,
                           T=T, Z=Z, occ=occ)


def value_and_grad(pb, params):
    from heatx_torch.engine.adjoint import chunked_value_and_grad

    return chunked_value_and_grad(None, params, pb.st, pb.xs_chunks, forward_fn=pb.kf, backward_fn=pb.kb)


def fd_gate(pb, params, g):
    """The kernel-adjoint schedule gradient against a central finite
    difference of the forward sweep along a seeded direction: one direction
    (heatx's) for a shared schedule, one per zone for per-zone schedules.
    Returns ``[(fd, ad, rel), ...]``; raises AssertionError over FD_RTOL."""
    rng = np.random.default_rng(0)
    raw = params["raw"]
    d = torch.as_tensor(rng.normal(size=tuple(raw.shape)), dtype=raw.dtype, device=raw.device)
    dirs = [d] if raw.ndim == 1 else [d * (torch.arange(pb.Z, device=raw.device) == z) for z in range(pb.Z)]
    rows = []
    for dz in dirs:
        _, vp = pb.kf({"raw": raw + FD_EPS * dz}, pb.st, pb.seq)
        _, vm = pb.kf({"raw": raw - FD_EPS * dz}, pb.st, pb.seq)
        fd = (float(vp) - float(vm)) / (2 * FD_EPS)
        ad = float((g["raw"] * dz).sum())
        assert abs(ad) > 0, "schedule gradient has no signal"
        rel = abs(fd - ad) / max(abs(fd), abs(ad))
        rows.append((fd, ad, rel))
    for z, (fd, ad, rel) in enumerate(rows):
        where = "" if len(rows) == 1 else f" zone {z}"
        print(f"setpoint-schedule FD gate{where}: fd {fd:.6g}  adjoint {ad:.6g}  rel {rel:.2e}")
    for fd, ad, rel in rows:
        assert rel < FD_RTOL, (fd, ad)
    return rows


def setpoint_phase(fast, device, zones=1):
    """Phase 2: optimize a thermostat heating-SETPOINT schedule through the
    day adjoint (chunk_forward/chunk_grad with schedule_fn)."""
    pb = setpoint_problem(fast, device, zones)
    params = pb.params
    val0, g = value_and_grad(pb, params)
    fd_gate(pb, params, g)

    raw = params["raw"].clone().requires_grad_()
    opt = torch.optim.Adam([raw], lr=0.3)
    iters = 2 if fast else 25
    for i in range(iters):
        val, g = value_and_grad(pb, {"raw": raw.detach()})
        raw.grad = g["raw"]
        opt.step()
        if i % 5 == 0 or i == iters - 1:
            print(f"setpoint iter {i:3d}  objective {float(val):8.3f}")
    assert np.isfinite(float(val)) and float(val) <= float(val0)
    sp = (14.0 + 8.0 * torch.sigmoid(raw.detach())).cpu().numpy()
    print("optimized heating setpoints (C):", np.round(sp, 2))
    if not fast:
        # Night setback: unoccupied-hour setpoints drop below occupied ones.
        assert sp[pb.occ].mean() > sp[~pb.occ].mean() + 0.5, sp
    return pb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--phase", type=int, choices=(1, 2), default=None, help="run one phase only (default: both)")
    args = ap.parse_args(argv)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    fast = os.environ.get("HEATX_EXAMPLE_FAST") == "1"

    if args.phase in (None, 1):
        t0 = time.time()
        power_phase(fast, device)
        print(f"phase 1 (heater power, autograd through imp_march on {device.type}): {time.time() - t0:.2f}s "
              "(xla engine)")
    if args.phase in (None, 2):
        t0 = time.time()
        setpoint_phase(fast, device)
        print(f"phase 2 (setpoint schedule, chunk_forward/chunk_grad on {device.type}): {time.time() - t0:.2f}s "
              "(kernel engine)")
    print("optimal control OK")


if __name__ == "__main__":
    main()
