"""Beam shading from context geometry (heatx extension).

heatx_torch copy of ``heatx.weather.shadow`` (numpy only).

The reference takes per-surface incident solar as an input and has no
shading machinery; EnergyPlus computes sunlit fractions from its
Shading:*:Detailed polygons.  heatx does the same with a vectorized
ray-cast: sample points on each receiving surface, trace toward the sun,
and test intersections against every opaque shading polygon
(``BuildingModel.shades`` — overhangs, fins, neighboring buildings).
The resulting [T, S] sunlit fraction multiplies the BEAM component of
the plane-of-array irradiance (``surface_irradiance(beam_fraction=...)``);
:func:`sky_view_fraction` additionally carries the obstruction into the
DIFFUSE terms — the static per-face unobstructed-sky fraction scales the
sky diffuse and blends the longwave (one tier beyond EnergyPlus's
"MinimalShadowing").

Resolution: each surface samples its centroid plus its vertices shrunk
30 % toward the centroid (V+1 points — exact for fully-lit /
fully-shaded hours, quantized to V+1 steps for partially-shaded ones;
``shrink`` tunes the ring).  Everything is host-side numpy (weather
preprocessing, like the solar module).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_EPS = 1e-6  # m along the ray; also excludes coplanar geometry (t ~ 0)


def _poly_plane(poly: np.ndarray):
    """Plane + 2D projection basis of a vertex loop: (origin, normal,
    e1, e2, verts2 [V, 2])."""
    from heatx_torch.model.geometry import polygon_normal

    v = np.asarray(poly, np.float64)
    origin = v[0]
    n = polygon_normal(v)  # Newell normal; raises on degenerate loops
    e1 = v[1] - v[0]
    e1 = e1 - n * (e1 @ n)
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    verts2 = np.column_stack([(v - origin) @ e1, (v - origin) @ e2])
    return origin, n, e1, e2, verts2


def _in_polygon(px: np.ndarray, py: np.ndarray, poly2: np.ndarray):
    """Crossing-number point-in-polygon, vectorized over px/py's shape
    (poly2: [V, 2], CCW or CW, convex or not)."""
    inside = np.zeros(px.shape, bool)
    x0, y0 = poly2[:, 0], poly2[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    for i in range(len(poly2)):
        crosses = (y0[i] > py) != (y1[i] > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            xi = x0[i] + (py - y0[i]) * (x1[i] - x0[i]) / (y1[i] - y0[i])
        inside ^= crosses & (px < xi)
    return inside


def sample_points(vertices: np.ndarray, shrink: float = 0.3) -> np.ndarray:
    """[K, 3] receiver sample points: the centroid plus each vertex pulled
    ``shrink`` of the way toward it (interior for star-shaped polygons —
    every practical facade)."""
    v = np.asarray(vertices, np.float64)
    c = v.mean(axis=0)
    return np.vstack([c[None, :], c + (1.0 - shrink) * (v - c)])


def _fibonacci_hemisphere(n: int) -> np.ndarray:
    """[n, 3] deterministic unit directions over the +z hemisphere
    (Fibonacci spiral — low-discrepancy, reproducible)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    z = i / n  # uniform in z: equal-area bands on the hemisphere
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.clip(1.0 - z**2, 0.0, None))
    return np.column_stack([r * np.cos(phi), r * np.sin(phi), z])


def _gather_planes(model, defs, include_building, extra_shades):
    """(owner, plane) blocker list: owner None for shade polygons, the
    surface index for the building's own massing (so a surface can skip
    itself)."""
    blockers = [np.asarray(p, np.float64) for p in model.shades]
    if extra_shades:
        blockers += [np.asarray(p, np.float64) for p in extra_shades]
    planes = [(None, _poly_plane(p)) for p in blockers]
    if include_building:
        for i, sd in enumerate(defs):
            if sd.vertices is not None and len(sd.vertices) >= 3:
                planes.append((i, _poly_plane(np.asarray(sd.vertices,
                                                         np.float64))))
    return planes


def _blocked(pts, dirs, planes, skip):
    """[D, K] mask: does the ray from point k along direction d hit any
    blocker plane polygon (excluding owner ``skip``)?"""
    blocked = np.zeros((len(dirs), len(pts)), bool)
    for owner, (q0, nq, e1, e2, v2) in planes:
        if owner == skip:
            continue  # a surface never shades itself
        denom = dirs @ nq
        ok = np.abs(denom) > 1e-12
        tdist = np.where(
            ok[:, None],
            ((q0 - pts) @ nq)[None, :] / np.where(ok, denom, 1.0)[:, None],
            -1.0,
        )
        hit = tdist > _EPS
        if not hit.any():
            continue
        x = pts[None, :, :] + tdist[:, :, None] * dirs[:, None, :]
        rel = x - q0
        blocked |= hit & _in_polygon(rel @ e1, rel @ e2, v2)
    return blocked


def sky_view_fraction(
    model,
    samples: int = 256,
    side: str = "front",
    include_building: bool = False,
    shrink: float = 0.3,
    extra_shades: Optional[List[np.ndarray]] = None,
) -> np.ndarray:
    """Per-FACE unobstructed sky fraction under context shading.

    For each vertex-bearing surface, cosine-weighted hemisphere rays
    (deterministic Fibonacci directions, restricted above the horizon and
    in front of the requested face) are cast from its
    :func:`sample_points` against the blockers; the result is the visible
    fraction of the isotropic-sky irradiance the unobstructed face would
    receive.  Returns [S] in the compiled order (1.0 where there is
    nothing to ray-cast or no geometry).  ``side`` selects the face — a
    wall hard against a neighbor has ~0 sky view on that face while the
    other face may be wide open, so the factor is inherently per-face.

    Use it to carry obstruction into the DIFFUSE terms — scale the sky
    diffuse (``poa_irradiance(sky_view=...)``) and blend the longwave
    (an obstruction radiates at ~air temperature where the cold sky
    would be) — on top of :func:`sunlit_fraction`'s beam handling.
    """
    from heatx_torch.model.geometry import polygon_normal

    sign = 1.0 if side == "front" else -1.0
    defs = list(model.surfaces) + list(model.fenestrations)
    out = np.ones(len(defs))
    planes = _gather_planes(model, defs, include_building, extra_shades)
    if not planes:
        return out

    dirs = _fibonacci_hemisphere(int(samples))  # +z hemisphere (sky dome)
    for si, sd in enumerate(defs):
        if sd.vertices is None or len(sd.vertices) < 3:
            continue
        n = sign * polygon_normal(sd.vertices)
        # Rays this face's sky irradiance actually arrives on: above the
        # horizon AND in front of the face, weighted by cos(incidence) —
        # the isotropic-sky kernel.
        w = np.clip(dirs @ n, 0.0, None)
        total = w.sum()
        if total <= 0.0:
            continue  # the face sees no sky at all (e.g. a floor's top)
        pts = sample_points(sd.vertices, shrink=shrink)
        visible = 1.0 - _blocked(pts, dirs, planes, si).mean(axis=1)
        out[si] = float((w * visible).sum() / total)
    return out


def sunlit_fraction(
    model,
    altitude_rad,
    azimuth_rad,
    include_building: bool = False,
    shrink: float = 0.3,
    extra_shades: Optional[List[np.ndarray]] = None,
) -> np.ndarray:
    """Per-hour beam sunlit fraction for every surface of ``model``.

    Returns [T, S] aligned with the compiled surface order (surfaces then
    fenestrations): 1.0 fully lit, 0.0 fully blocked, sampled over
    :func:`sample_points` (surfaces without vertex geometry stay 1.0 —
    there is nothing to ray-cast).  Blockers: ``model.shades`` (+
    ``extra_shades``), and with ``include_building=True`` every OTHER
    vertex-bearing surface of the model (self-shadowing by the building's
    own massing; windows are never blocked by their coplanar host — the
    ray leaves the shared plane).  Below the horizon everything is 1.0
    (the beam is zero anyway).

    Feed the result to ``surface_irradiance(beam_fraction=...)`` — it
    scales only the direct term.
    """
    from heatx_torch.weather.solar import sun_vector

    alt = np.asarray(altitude_rad, np.float64)
    az = np.asarray(azimuth_rad, np.float64)
    T = alt.shape[0]
    defs = list(model.surfaces) + list(model.fenestrations)
    S = len(defs)
    out = np.ones((T, S))

    planes = _gather_planes(model, defs, include_building, extra_shades)
    if not planes:
        return out
    no_geom = [
        sd.name for sd in defs
        if sd.vertices is None or len(sd.vertices) < 3
    ]
    if no_geom:
        import warnings

        # Silence here would read as "shading applied" while the panes
        # most exposed to beam gain stayed fully sunlit.
        warnings.warn(
            "context shading cannot ray-cast surfaces without vertex "
            f"geometry — they stay fully sunlit: {', '.join(no_geom)} "
            "(rectangular Window/GlazedDoor imports carry no vertex loop; "
            "model them as FenestrationSurface:Detailed to shade them)",
            stacklevel=2,
        )

    d = np.column_stack(sun_vector(alt, az))  # [T, 3] toward the sun
    up = alt > 0.0
    for si, sd in enumerate(defs):
        if sd.vertices is None or len(sd.vertices) < 3:
            continue
        pts = sample_points(sd.vertices, shrink=shrink)  # [K, 3]
        blocked = _blocked(pts, d, planes, si)  # [T, K]
        out[:, si] = np.where(up, 1.0 - blocked.mean(axis=1), 1.0)
    return out
