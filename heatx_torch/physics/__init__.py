"""Physics on torch tensors: TARP convection, air properties, glazing optics."""

from heatx_torch.physics import convection, gas, glazing  # noqa: F401
