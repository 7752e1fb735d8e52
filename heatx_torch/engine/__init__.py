"""Device-side physics on torch tensors (the TR-BDF2 day march's pieces)."""

from heatx_torch.engine import implicit, state, surface  # noqa: F401
