"""Observability utilities: profiling, NaN guards, step timing."""

from heatx_torch.utils.debug import assert_state_finite, check_state_finite  # noqa: F401
from heatx_torch.utils.profiling import profile_trace, time_steps  # noqa: F401
