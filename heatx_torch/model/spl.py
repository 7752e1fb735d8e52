"""Parser for the subset of SIMPLE's ``.spl`` model format the heat module
consumes: Substance / Material / Construction / Surface / Fenestration /
Space plus the gain devices (Luminaire, HVAC — ElectricHeater and
IdealHeaterCooler, heating_cooling.rs:41-65) and SiteDetails (terrain ->
wind profile, surface.rs:135-166).  ``Building`` objects parse and are
skipped (metadata only).  Power ratings (``max_power`` /
``max_heating_power``) on scheduled devices are not compiled: consumption
is a per-step input channel (``StepInputs.hvac_power``/``lum_power``),
matching how the reference reads power from the state vector at run time;
IdealHeaterCooler capacities DO compile (they clamp the ideal loads).

heatx_torch copy of ``heatx.model.spl`` (numpy only): it builds the
port's own ``heatx_torch.model.building`` classes.

The grammar is ``ObjectName { key: value, ... }`` where values are numbers,
quoted strings, ``[ ... ]`` arrays, or nested ``{ ... }`` objects.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from heatx_torch.model.building import (
    Boundary,
    BuildingModel,
    Construction,
    ElectricHeater,
    GasSubstance,
    IdealHeaterCooler,
    Luminaire,
    Material,
    SiteDetails,
    SpaceDef,
    Substance,
    SurfaceDef,
)


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[str] = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if c.isspace() or c == ",":
                i += 1
            elif c in "{}[]:":
                self.toks.append(c)
                i += 1
            elif c == '"':
                j = text.index('"', i + 1)
                self.toks.append(text[i : j + 1])
                i = j + 1
            else:
                j = i
                while j < n and not text[j].isspace() and text[j] not in '{}[]:,"':
                    j += 1
                self.toks.append(text[i:j])
                i = j
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.pos += 1
        return t


def _parse_value(t: _Tokens) -> Any:
    tok = t.next()
    if tok == "{":
        return _parse_body(t)
    if tok == "[":
        arr = []
        while t.peek() != "]":
            arr.append(_parse_value(t))
        t.next()
        return arr
    if tok.startswith('"'):
        return tok[1:-1]
    try:
        return float(tok)
    except ValueError:
        return tok


def _parse_body(t: _Tokens) -> Dict[str, Any]:
    body: Dict[str, Any] = {}
    while t.peek() != "}":
        key = t.next()
        colon = t.next()
        if colon != ":":
            raise ValueError(f"expected ':' after key '{key}', got '{colon}'")
        body[key] = _parse_value(t)
    t.next()
    return body


def parse_spl(text: str) -> List[Tuple[str, Dict[str, Any]]]:
    """Parse an .spl document into (object_kind, fields) pairs."""
    t = _Tokens(text)
    objects = []
    while t.peek() is not None:
        kind = t.next()
        if t.next() != "{":
            raise ValueError(f"expected '{{' after object kind '{kind}'")
        objects.append((kind, _parse_body(t)))
    return objects


def _boundary_from(field: Any) -> Boundary:
    if field is None:
        return Boundary.outdoor()
    kind = field.get("type", "Outdoor")
    if kind == "Space":
        return Boundary.space_(field["space"])
    if kind == "Outdoor":
        return Boundary.outdoor()
    if kind == "AmbientTemperature":
        return Boundary.ambient(float(field["temperature"]))
    if kind == "Ground":
        # Honor the file's soil temperature when present (dropping it used
        # to silently pin every ground face at the 10 C default).
        if "temperature" in field:
            return Boundary.ground(float(field["temperature"]))
        return Boundary.ground()
    raise ValueError(f"unknown boundary type '{kind}'")


def load_spl(path: str) -> BuildingModel:
    """Load an .spl building description into a BuildingModel."""
    with open(path) as f:
        objects = parse_spl(f.read())

    m = BuildingModel()
    for kind, f_ in objects:
        if kind == "Substance":
            sub_type = f_.get("type", "Normal")
            if sub_type == "Normal":
                m.add_substance(
                    Substance(
                        f_["name"],
                        thermal_conductivity=f_.get("thermal_conductivity"),
                        density=f_.get("density"),
                        specific_heat_capacity=f_.get("specific_heat_capacity"),
                        front_thermal_absorbtance=f_.get("front_thermal_absorbtance"),
                        back_thermal_absorbtance=f_.get("back_thermal_absorbtance"),
                        solar_transmittance=f_.get("solar_transmittance"),
                        front_solar_absorbtance=f_.get("front_solar_absorbtance"),
                        back_solar_absorbtance=f_.get("back_solar_absorbtance"),
                    )
                )
            elif sub_type == "Gas":
                m.add_substance(GasSubstance(f_["name"], str(f_.get("gas", "air")).lower()))
            else:
                raise ValueError(f"unknown substance type '{sub_type}'")
        elif kind == "Material":
            m.add_material(Material(f_["name"], f_["substance"], float(f_["thickness"])))
        elif kind == "Construction":
            m.add_construction(Construction(f_["name"], list(f_["materials"])))
        elif kind == "Surface":
            verts = np.array(f_["vertices"], dtype=np.float64).reshape(-1, 3)
            m.add_surface(
                SurfaceDef(
                    f_["name"],
                    f_["construction"],
                    front_boundary=_boundary_from(f_.get("front_boundary")),
                    back_boundary=_boundary_from(f_.get("back_boundary")),
                    vertices=verts,
                )
            )
        elif kind == "Fenestration":
            verts = np.array(f_["vertices"], dtype=np.float64).reshape(-1, 3)
            m.add_fenestration(
                SurfaceDef(
                    f_["name"],
                    f_["construction"],
                    front_boundary=_boundary_from(f_.get("front_boundary")),
                    back_boundary=_boundary_from(f_.get("back_boundary")),
                    vertices=verts,
                )
            )
        elif kind == "Space":
            m.add_space(SpaceDef(f_["name"], float(f_["volume"])))
        elif kind == "Luminaire":
            m.add_luminaire(Luminaire(f_["name"], f_["target_space"]))
        elif kind == "HVAC":
            h_type = f_.get("type", "ElectricHeater")
            if h_type == "ElectricHeater":
                m.add_hvac(ElectricHeater(f_["name"], f_["target_space"]))
            elif h_type == "IdealHeaterCooler":
                spaces = f_.get("target_spaces")
                if spaces is None:
                    spaces = [f_["target_space"]]
                m.add_hvac(IdealHeaterCooler(
                    f_["name"], list(spaces),
                    heat_setpoint=f_.get("heating_setpoint"),
                    cool_setpoint=f_.get("cooling_setpoint"),
                    max_heating=float(
                        f_.get("max_heating_power", float("inf"))
                    ),
                    max_cooling=float(
                        f_.get("max_cooling_power", float("inf"))
                    ),
                ))
            else:
                raise ValueError(f"unknown HVAC type '{h_type}'")
        elif kind == "SiteDetails":
            tc = str(
                f_.get("terrain_class") or f_.get("terrain") or ""
            ).lower()
            if tc:
                m.site_details = SiteDetails(terrain=tc)
        elif kind == "Building":
            pass  # metadata (name, shelter class): no thermal content
        else:
            raise ValueError(f"unsupported .spl object '{kind}'")
    return m
