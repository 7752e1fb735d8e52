"""Validation: series comparison, HTML reports, EnergyPlus fixture replay
(heatx_torch copy of ``heatx.validate``)."""

from heatx_torch.validate.series import SeriesValidation, Validator  # noqa: F401
