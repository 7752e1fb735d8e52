// The parity day adjoint's kMrt kinds (interior MRT: the network's reverse
// and the effective emissivities' cotangents; day_adjoint_parity.cu has the
// kernel), compiled as a unit of their own so that the other kinds keep
// their code, as the day march's kMrt units do.  day_adjoint_parity.cu
// launches them through heatx_day_adjoint_parity_mrt_f32/_f64.
#define HEATX_DAY_ADJOINT_PARITY_KMRT_UNIT
#include "day_adjoint_parity.cu"
