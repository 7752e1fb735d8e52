"""Tridiagonal ops and the day-march kernel (CUDA) with its plain twin."""

from heatx_torch.ops import tridiag  # noqa: F401
