"""Construction discretization: node sizing and segment building.

Host-side ("trace-time") equivalent of the reference's src/discretization.rs.
This runs once per construction when a building is compiled, in pure Python /
float64, and mirrors the reference's node-layout algorithm exactly so the
resulting thermal networks match node for node:

* ``discretize_construction`` — recursive search for the smallest timestep
  subdivision ``n`` such that every layer admits an Euler-stable element size
  (discretization.rs:410-544).  Layers whose minimum stable element is thicker
  than the layer itself (or whose dx would exceed ``max_dx`` at the ``min_dt``
  floor) get **0 elements** and are treated as no-mass.
* ``build_segments`` — per-node (mass, U-value) pairs (discretization.rs:163-298):
  solid elements contribute ``rho*cp*dx`` mass split half/half to the adjacent
  nodes and a static ``U = k/dx``; gas layers become zero-mass Cavity segments
  whose U-value is temperature-dependent and is re-evaluated on device every
  sub-step.

The output is a plain :class:`Discretization` of python segments; the padded
device arrays are produced by ``heatx_torch.build.layout``.

heatx_torch copy of ``heatx.build.discretize``: the same numpy code, without
the optional native stability search (its pure-Python loop is used) and
without ``Discretization.r_value``, which needs the gas-cavity U-value that
the port does not carry yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from heatx_torch.constants import DEFAULT_EMISSIVITY, MAX_RS
from heatx_torch.model.building import BuildingModel, Construction, GasSubstance, Substance
from heatx_torch.physics.gas import GASES, GasProps


@dataclass
class CavitySpec:
    """Static description of a gas cavity segment (cavity.rs:28-50)."""

    gas: GasProps
    thickness: float
    height: float
    angle: float
    eout: float
    ein: float


@dataclass
class Segment:
    """One node of the thermal network: its mass and the U-value of the
    connection to the *next* node (discretization.rs:32-56, 73)."""

    mass: float = 0.0
    kind: str = "none"  # solid | cavity | back | none
    u: float = 0.0  # static U for solid segments (k/dx)
    cavity: Optional[CavitySpec] = None


@dataclass
class Discretization:
    """Per-surface discretization result (discretization.rs:70-87)."""

    segments: List[Segment] = field(default_factory=list)
    tstep_subdivision: int = 1
    n_elements: List[int] = field(default_factory=list)

    # -- queries -------------------------------------------------------------

    def get_chunks(self) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """(massive_chunks, nomass_chunks) as [ini, fin) runs
        (discretization.rs:139-160); the massive threshold is mass >= 1e-5."""

        def runs(indexes: List[int]) -> List[Tuple[int, int]]:
            if not indexes:
                return []
            out = []
            start = prev = indexes[0]
            for i in indexes[1:]:
                if i - prev == 1:
                    prev = i
                else:
                    out.append((start, prev + 1))
                    start = prev = i
            out.append((start, prev + 1))
            return out

        mass_nodes = [i for i, s in enumerate(self.segments) if s.mass >= 1e-5]
        nomass_nodes = [i for i, s in enumerate(self.segments) if s.mass < 1e-5]
        return runs(mass_nodes), runs(nomass_nodes)


def _normal_props(sub) -> Tuple[float, float, float]:
    if sub.thermal_conductivity is None:
        raise ValueError(
            f"substance '{sub.name}' lacks 'thermal conductivity' required for discretization"
        )
    if sub.density is None:
        raise ValueError(f"substance '{sub.name}' lacks 'density' required for discretization")
    if sub.specific_heat_capacity is None:
        raise ValueError(
            f"substance '{sub.name}' lacks 'specific heat capacity' required for discretization"
        )
    return sub.thermal_conductivity, sub.density, sub.specific_heat_capacity


def discretize_construction(
    construction: Construction,
    model: BuildingModel,
    model_dt: float,
    max_dx: float,
    min_dt: float,
) -> Tuple[int, List[int]]:
    """Find (tstep_subdivision, n_elements per layer) — discretization.rs:410-544.

    Searches n = 1, 2, 3, ... for the smallest timestep subdivision such that
    each layer can be split into elements larger than the positive root of

        dx^2 - (dt / (rho cp Rs)) dx - 2 dt k / (rho cp) = 0     (Rs = 0.05)

    while keeping dx <= max_dx; a layer that cannot comply at the dt floor is
    marked no-mass (0 elements).  Implemented iteratively (the reference
    recursion restarts the whole layer scan on each n bump).
    """
    n = 1
    while True:
        dt = model_dt / n
        n_elements: List[int] = []
        retry = False
        for mat_name in construction.materials:
            material = model.get_material(mat_name)
            substance = model.get_substance(material.substance)
            if substance.is_gas:
                n_elements.append(0)
                continue
            k, rho, cp = _normal_props(substance)
            thickness = material.thickness

            b_coef = -dt / (rho * cp * MAX_RS)
            c_coef = -2.0 * dt * k / (rho * cp)
            disc = b_coef * b_coef - 4.0 * c_coef
            min_dx = (-b_coef + math.sqrt(disc)) / 2.0

            if min_dx > thickness:
                # This layer cannot comply at this dt; shrink dt if allowed,
                # else mark it no-mass (discretization.rs:467-479).
                if model_dt / (n + 1) > min_dt:
                    retry = True
                    break
                n_elements.append(0)
            else:
                m = math.floor(thickness / min_dx)
                dx = thickness / m
                if dx > max_dx:
                    if model_dt / (n + 1) > min_dt:
                        retry = True
                        break
                    n_elements.append(0)
                else:
                    n_elements.append(int(m))
        if retry:
            n += 1
            continue
        return n, n_elements


def build_segments(
    construction: Construction,
    model: BuildingModel,
    tstep_subdivision: int,
    n_elements: List[int],
    height: float,
    angle: float,
) -> Discretization:
    """Emit the (mass, UValue) segments — discretization.rs:163-298."""
    if len(n_elements) != len(construction.materials):
        raise ValueError("n_elements length must match construction layers")

    n_nodes = sum(n_elements) + sum(1 for x in n_elements if x == 0) + 1
    segments = [Segment() for _ in range(n_nodes)]

    n_segment = 0
    for n_layer, n in enumerate(n_elements):
        mat_name = construction.materials[n_layer]
        material = model.get_material(mat_name)
        substance = model.get_substance(material.substance)

        if n == 0 or substance.is_gas:
            mass = 0.0
        else:
            k, rho, cp = _normal_props(substance)
            dx = material.thickness / n
            mass = rho * cp * dx

        count = max(n, 1)
        for _ in range(count):
            if isinstance(substance, Substance):
                segments[n_segment].mass += mass / 2.0
                segments[n_segment + 1].mass += mass / 2.0
                dx = material.thickness / count
                k, _, _ = _normal_props(substance)
                segments[n_segment].kind = "solid"
                segments[n_segment].u = k / dx
            elif isinstance(substance, GasSubstance):
                if substance.gas not in GASES:
                    raise ValueError(
                        f"substance '{substance.name}' does not have a standard gas"
                    )
                if n_layer == 0:
                    raise ValueError(
                        f"construction '{construction.name}' has a Gas as its first layer"
                    )
                if n_layer + 1 >= len(construction.materials):
                    raise ValueError(
                        f"construction '{construction.name}' has a Gas as its last layer"
                    )
                next_sub = model.get_material_substance(construction.materials[n_layer + 1])
                prev_sub = model.get_material_substance(construction.materials[n_layer - 1])
                if next_sub.is_gas or prev_sub.is_gas:
                    raise ValueError(
                        f"construction '{construction.name}' has two gases without a "
                        "solid layer between them"
                    )
                ein = (
                    next_sub.front_thermal_absorbtance
                    if next_sub.front_thermal_absorbtance is not None
                    else DEFAULT_EMISSIVITY
                )
                eout = (
                    prev_sub.back_thermal_absorbtance
                    if prev_sub.back_thermal_absorbtance is not None
                    else DEFAULT_EMISSIVITY
                )
                segments[n_segment].kind = "cavity"
                segments[n_segment].cavity = CavitySpec(
                    gas=GASES[substance.gas],
                    thickness=material.thickness,
                    height=height,
                    angle=angle,
                    eout=eout,
                    ein=ein,
                )
            n_segment += 1
    segments[n_nodes - 1].kind = "back"
    segments[n_nodes - 1].u = 0.0
    segments[n_nodes - 1].cavity = None

    return Discretization(
        segments=segments,
        tstep_subdivision=tstep_subdivision,
        n_elements=list(n_elements),
    )


def discretize(
    construction: Construction,
    model: BuildingModel,
    model_dt: float,
    max_dx: float,
    min_dt: float,
    height: float,
    angle: float,
) -> Discretization:
    """Full Discretization::new equivalent (discretization.rs:95-114)."""
    tstep, n_elements = discretize_construction(construction, model, model_dt, max_dx, min_dt)
    return build_segments(construction, model, tstep, n_elements, height, angle)
