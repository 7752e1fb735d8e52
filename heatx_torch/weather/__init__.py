"""Weather inputs (hourly series to sub-step values)."""

from heatx_torch.weather.epw import interpolate_to_steps  # noqa: F401
