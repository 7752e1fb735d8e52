// The parity day adjoint's cluster variant (G = 8 threads a surface, 64 rows, up to 8 CTAs
// of 128 lanes a block: kLaunchVariants[3], day_cluster.cuh; day_adjoint_parity.cu has the
// kernel), every kind, compiled as a unit of its own so that the other
// variants keep their code, as the kMrt units do.  day_adjoint_parity.cu launches it
// through heatx_day_adjoint_parity_b1_f32/_f64.
#define HEATX_DAY_ADJOINT_PARITY_B1_UNIT
#include "day_adjoint_parity.cu"
