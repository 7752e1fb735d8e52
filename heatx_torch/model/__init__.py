"""Building data model (numpy copy of heatx.model)."""

from heatx_torch.model import building, geometry  # noqa: F401
