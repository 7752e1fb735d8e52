"""heatx's interpret-mode kernels as the port's tests call them.

The reference's Pallas kernels run in interpret mode on the CPU, and XLA's
compile of their unrolled sub-steps is most of these tests' time.
:func:`unoptimized` compiles a call with XLA's backend optimizations off:
~40 % less compile time for heatx's adjoint kernel, and the same values to
round-off (4e-15 of 1.0 on its day-start cotangent).  It changes no
tolerance, only how the reference is compiled; the jitted call is local to
the test, so heatx's own tests keep XLA's defaults.
"""

import jax

_OPTIONS = {"xla_backend_optimization_level": 0}


def unoptimized(fn):
    """``fn`` (a heatx kernel callable) under ``jax.jit`` without XLA's
    backend optimizations."""
    return jax.jit(fn, compiler_options=_OPTIONS)
