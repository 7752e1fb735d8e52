"""Host-side building compiler (numpy copy of heatx.build)."""

from heatx_torch.build import blocking, discretize, layout  # noqa: F401
