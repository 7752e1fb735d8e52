"""ISO 9050 glazing optics (solar transmittance/reflectance/absorbtance).

Host-side equivalent of the reference's src/glazing.rs.  Glazing combination
runs once per construction at model-build ("compile") time and produces the
static per-node solar-absorption vectors used on device, so this module is
plain Python/float64 — there is nothing to accelerate here.

heatx_torch copy of ``heatx.physics.glazing`` (unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass(frozen=True)
class Glazing:
    """A glazing layer abstracted to its optical properties (glazing.rs:31-65)."""

    tau: float
    rho_front: float
    rho_back: float
    alpha_front: float = field(init=False)
    alpha_back: float = field(init=False)

    def __post_init__(self):
        if not (0.0 <= self.tau <= 1.0):
            raise ValueError(f"transmittance out of [0,1]: {self.tau}")
        if not (0.0 <= self.rho_front <= 1.0):
            raise ValueError(f"front reflectance out of [0,1]: {self.rho_front}")
        if not (0.0 <= self.rho_back <= 1.0):
            raise ValueError(f"back reflectance out of [0,1]: {self.rho_back}")
        object.__setattr__(self, "alpha_front", 1.0 - self.tau - self.rho_front)
        object.__setattr__(self, "alpha_back", 1.0 - self.tau - self.rho_back)

    def combined_tau(self, other: "Glazing") -> float:
        """ISO 9050 Eq. 2 (glazing.rs:180-182)."""
        return self.tau * other.tau / (1.0 - self.rho_back * other.rho_front)

    def combined_rho_front(self, other: "Glazing") -> float:
        """ISO 9050 Eq. 5 (glazing.rs:191-193)."""
        return self.rho_front + self.tau**2 * other.rho_front / (
            1.0 - self.rho_back * other.rho_front
        )

    def combined_rho_back(self, other: "Glazing") -> float:
        """Derived back reflectance (glazing.rs:204-206)."""
        return other.rho_back + other.tau**2 * self.rho_back / (
            1.0 - other.rho_front * self.rho_back
        )

    def combine(self, other: "Glazing") -> "Glazing":
        """Equivalent single layer for self+other (glazing.rs:213-218)."""
        return Glazing(
            self.combined_tau(other),
            self.combined_rho_front(other),
            self.combined_rho_back(other),
        )

    def combined_alphas(self, other: "Glazing"):
        """ISO 9050 Eq. 17-18 (glazing.rs:247-252)."""
        denom = 1.0 - self.rho_back * other.rho_front
        a1 = self.alpha_front + self.alpha_back * self.tau * other.rho_front / denom
        a2 = other.alpha_front * self.tau / denom
        return a1, a2


def combine_layers(layers: List[Glazing]) -> Glazing:
    """Fold several layers into one equivalent layer (glazing.rs:221-230)."""
    if not layers:
        raise ValueError("cannot combine an empty glazing system")
    if len(layers) == 1:
        return layers[0]
    return layers[0].combine(combine_layers(layers[1:]))


def alphas(layers: List[Glazing]) -> List[float]:
    """Absorbed fraction of incident irradiance per layer (glazing.rs:259-286).

    Fractions are relative to the incident irradiance (they do not sum to 1).
    Assumes a gas cavity between consecutive layers.
    """
    n = len(layers)
    if n == 0:
        return []
    if n == 1:
        return [layers[0].alpha_front]

    ret: List[float] = []
    acc = 0.0
    for i in range(1, n):
        g0 = combine_layers(layers[:i])
        g1 = combine_layers(layers[i:])
        a0, _ = g0.combined_alphas(g1)
        ret.append(a0 - acc)
        acc = a0
    g0 = combine_layers(layers[:-1])
    _, a1 = g0.combined_alphas(layers[-1])
    ret.append(a1)
    return ret
