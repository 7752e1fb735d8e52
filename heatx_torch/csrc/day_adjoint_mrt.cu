// The parity day adjoint's kMrt instantiations (interior MRT: the network's
// reverse and the effective emissivities' cotangents; day_adjoint.cu has the
// kernel), compiled as a unit of their own so that the other instantiations
// keep their code (as the day march's kMrt units do).  day_adjoint.cu launches them
// through heatx_day_adjoint_mrt_f32/_f64.
#define HEATX_DAY_ADJOINT_KMRT_UNIT
#include "day_adjoint.cu"
