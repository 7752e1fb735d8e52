// What the parity day march (day_march_parity.cu) and its adjoint
// (day_adjoint_parity.cu) take from heatx `_hour_body`'s configuration
// (heatx/ops/pallas_step.py:633): the lane row of the chunk words, and the
// no-mass iteration's and the march's parameters in the working type.  The
// four-thread device code is day_parity_rows.cuh's (forward) and
// day_parity_adj.cuh's (reverse).
#pragma once

#include "day_common.cuh"

namespace heatx {

// The lane row of the chunk words: nodes i and i+1 share a chunk where bit i
// is set (engine.surface.compute_statics; day_parity_rows.cuh RowWords).
constexpr int LN_CHUNK = LN_MASS + 1;

// The no-mass iteration's and the march's parameters, in the working type.
// iters is the fixed iteration count, or -1 for the adaptive loop of at most
// max_iter iterations.
template <typename T>
struct ParityCfg {
  int iters, esc_after, max_iter;
  T tol, tol_esc, dt;
  __device__ explicit ParityCfg(const DayArgs<T>& a)
      : iters(a.nomass_iters), esc_after(a.esc_after), max_iter(a.nomass_max_iter),
        tol(T(a.nomass_tol)), tol_esc(T(a.nomass_tol_esc)), dt(T(a.dt)) {}
};

}  // namespace heatx
