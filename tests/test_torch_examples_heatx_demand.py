"""examples_torch/calibrate_demand.py against heatx's CPU route of the same
computation, f64, CPU, at its smoke size (``HEATX_EXAMPLE_FAST=1``: 12 h in 2
chunks), the 4-zone block built from the same numbers in both packages: the
first value and gradient of the metered-energy objective on both of the example's routes
(heatx's CPU route, autograd through ``imp_march``; the kernel route,
``chunk_forward``/``chunk_grad``, the plain day march and adjoint here)
against heatx's ``chunked_value_and_grad`` with its ``chunk_fn``, within
1e-9 relative (``torch_examples_ref.check_calibration``).  heatx's XLA path
is the reference, never its interpret-mode kernels.
"""

import torch
from torch_examples_ref import check_calibration

torch.set_num_threads(1)


def test_calibrate_demand_first_step_matches_heatx():
    check_calibration("calibrate_demand")
