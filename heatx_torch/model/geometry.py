"""Minimal 3-D polygon geometry for building surfaces.

Host-side replacement for the slice of the reference's external ``geometry3d``
crate that the heat module consumes (normal / area / perimeter / centroid of a
surface polygon, see model.rs:248-256).  Pure-Python float arithmetic over
the (tiny, typically 4-vertex) loops: per-vertex numpy calls cost ~10x more
than the math itself and dominated 100k-surface model builds.  Runs once at
model build; results are cached per vertex array in
``SurfaceDef.resolved_geometry``.

heatx_torch copy of ``heatx.model.geometry`` (unchanged).
"""

from __future__ import annotations

import math

import numpy as np


def _loop(vertices) -> list:
    v = np.asarray(vertices, dtype=np.float64)
    if v.ndim != 2 or v.shape[1] != 3:
        raise ValueError(f"expected (n, 3) vertex array, got {v.shape}")
    return v.tolist()


def polygon_normal(vertices: np.ndarray) -> np.ndarray:
    """Unit normal of a planar polygon via Newell's method."""
    v = _loop(vertices)
    nx = ny = nz = 0.0
    n = len(v)
    for i in range(n):
        ax, ay, az = v[i]
        bx, by, bz = v[(i + 1) % n]
        nx += (ay - by) * (az + bz)
        ny += (az - bz) * (ax + bx)
        nz += (ax - bx) * (ay + by)
    norm = math.sqrt(nx * nx + ny * ny + nz * nz)
    if norm < 1e-12:
        raise ValueError("degenerate polygon (zero normal)")
    return np.array([nx / norm, ny / norm, nz / norm])


def polygon_area(vertices: np.ndarray) -> float:
    """Area of a planar polygon (outer loop only)."""
    v = _loop(vertices)
    normal = polygon_normal(vertices)
    tx = ty = tz = 0.0
    n = len(v)
    for i in range(n):
        ax, ay, az = v[i]
        bx, by, bz = v[(i + 1) % n]
        tx += ay * bz - az * by
        ty += az * bx - ax * bz
        tz += ax * by - ay * bx
    return abs(tx * normal[0] + ty * normal[1] + tz * normal[2]) / 2.0


def polygon_perimeter(vertices: np.ndarray) -> float:
    v = _loop(vertices)
    n = len(v)
    total = 0.0
    for i in range(n):
        ax, ay, az = v[i]
        bx, by, bz = v[(i + 1) % n]
        total += math.sqrt((bx - ax) ** 2 + (by - ay) ** 2 + (bz - az) ** 2)
    return total


def polygon_centroid(vertices: np.ndarray) -> np.ndarray:
    """Vertex-average centroid (sufficient for the centroid.z height used by
    the wind-speed profile, model.rs:256)."""
    v = np.asarray(vertices, dtype=np.float64)
    return v.mean(axis=0)
