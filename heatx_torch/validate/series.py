"""Series validation + HTML report generation.

heatx_torch copy of ``heatx.validate.series`` (numpy and HTML only).

heatx equivalent of SIMPLE's external ``validate`` crate (SeriesValidator +
Validator), which the reference uses to publish its "Is it accurate?" HTML
reports (docs/validation/walls.html, convection_coefficients.html;
README.md:12-14).  A validation compares a found series against an expected
one with range-relative RMSE/bias thresholds and renders an inline-SVG chart
per case into a standalone HTML report.
"""

from __future__ import annotations

import html
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class SeriesValidation:
    """One expected-vs-found series comparison."""

    title: str
    expected: np.ndarray
    found: np.ndarray
    expected_legend: str = "expected"
    found_legend: str = "heatx"
    x_label: str = "time step"
    y_label: str = "value"
    y_units: str = ""
    # Thresholds relative to the range of the expected series.
    max_rmse_frac: float = 0.05
    max_bias_frac: float = 0.03

    def metrics(self):
        e = np.asarray(self.expected, dtype=np.float64)
        f = np.asarray(self.found, dtype=np.float64)
        n = min(len(e), len(f))
        e, f = e[:n], f[:n]
        err = f - e
        rng = max(float(e.max() - e.min()), 1e-9)
        return {
            "rmse": float(np.sqrt(np.mean(err**2))),
            "bias": float(np.mean(err)),
            "max_abs": float(np.max(np.abs(err))),
            "range": rng,
        }

    def passes(self) -> bool:
        m = self.metrics()
        return (
            m["rmse"] <= self.max_rmse_frac * m["range"]
            and abs(m["bias"]) <= self.max_bias_frac * m["range"]
        )

    # -- rendering -----------------------------------------------------------

    def _svg(self, width=760, height=260, pad=40) -> str:
        e = np.asarray(self.expected, dtype=np.float64)
        f = np.asarray(self.found, dtype=np.float64)
        n = min(len(e), len(f))
        if n == 0:
            return "<svg/>"
        stride = max(1, n // 2000)  # keep the SVG small
        e, f = e[:n:stride], f[:n:stride]
        lo = min(e.min(), f.min())
        hi = max(e.max(), f.max())
        span = max(hi - lo, 1e-9)
        xs = np.linspace(pad, width - pad, len(e))

        def path(vals, color):
            ys = height - pad - (vals - lo) / span * (height - 2 * pad)
            pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
            return (
                f'<polyline fill="none" stroke="{color}" stroke-width="1.2" '
                f'points="{pts}"/>'
            )

        return (
            f'<svg viewBox="0 0 {width} {height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
            f'<rect width="{width}" height="{height}" fill="#fff"/>'
            f'{path(e, "#888888")}{path(f, "#c5461c")}'
            f'<text x="{pad}" y="{height - 8}" font-size="11" fill="#888888">'
            f"{html.escape(self.expected_legend)}</text>"
            f'<text x="{width // 2}" y="{height - 8}" font-size="11" '
            f'fill="#c5461c">{html.escape(self.found_legend)}</text>'
            f'<text x="8" y="{pad - 16}" font-size="11">'
            f"{html.escape(self.y_label)} [{html.escape(self.y_units)}]</text>"
            f"</svg>"
        )

    def to_html(self) -> str:
        m = self.metrics()
        status = "PASS" if self.passes() else "FAIL"
        color = "#2a7a2a" if status == "PASS" else "#b22222"
        return (
            f"<section><h2>{html.escape(self.title)} "
            f'<span style="color:{color}">[{status}]</span></h2>'
            f"<p>RMSE {m['rmse']:.4f} | bias {m['bias']:.4f} | "
            f"max |err| {m['max_abs']:.4f} | expected range {m['range']:.3f} "
            f"({html.escape(self.y_units)})</p>"
            f"{self._svg()}</section>"
        )


@dataclass
class Validator:
    """Collects SeriesValidations and renders one HTML report
    (the reference's Validator, tests/validate_wall_heat_transfer.rs:1126-1139)."""

    title: str
    target_file: Optional[str] = None
    validations: List[SeriesValidation] = field(default_factory=list)

    def push(self, v: SeriesValidation):
        self.validations.append(v)

    def validate(self, raise_on_fail: bool = True) -> bool:
        ok = all(v.passes() for v in self.validations)
        if self.target_file:
            d = os.path.dirname(self.target_file)
            if d:  # bare filename: cwd needs no makedirs
                os.makedirs(d, exist_ok=True)
            body = "\n".join(v.to_html() for v in self.validations)
            doc = (
                "<!DOCTYPE html><html><head><meta charset='utf-8'>"
                f"<title>{html.escape(self.title)}</title></head>"
                f"<body><h1>{html.escape(self.title)}</h1>{body}</body></html>"
            )
            with open(self.target_file, "w") as f:
                f.write(doc)
        if raise_on_fail and not ok:
            failed = [v.title for v in self.validations if not v.passes()]
            raise AssertionError(f"validation failures: {failed}")
        return ok
