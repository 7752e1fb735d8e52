"""Profiling helpers.

heatx_torch copy of ``heatx.utils.profiling``: a ``torch.profiler`` trace
in place of the XLA profiler, and step timing that waits for the device
before it reads the clock (a CUDA launch returns before its kernel ends).
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync(device=None):
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, the device (a Chrome trace under ``log_dir``, readable by
    TensorBoard's profiler plugin or chrome://tracing).  Yields the
    profiler, so callers can read ``key_averages()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))
    ) as prof:
        yield prof


def time_steps(step_fn, state, n_steps: int, fetch=lambda s: float(s.zone_T.reshape(-1)[0])):
    """Run ``state = step_fn(state)`` n times and time it honestly.

    Returns (final_state, seconds_per_step).  The device is synchronized
    before the clock starts and after the last step, and ``fetch``
    materializes one value of the final state on the host."""
    device = getattr(getattr(state, "zone_T", None), "device", None)
    cuda = device is not None and device.type == "cuda"
    if cuda:
        _sync(device)
    t0 = time.time()
    for _ in range(n_steps):
        state = step_fn(state)
    if cuda:
        _sync(device)
    fetch(state)
    return state, (time.time() - t0) / max(n_steps, 1)
