// The day march's kMrt instantiations (interior MRT and the per-hour h/q
// and operative histories; day_march.cu has the kernel), compiled as a unit
// of their own so that the other instantiations keep their code: ptxas
// shares out-of-line device functions among the kernels of one unit, and
// with these kernels beside them the gas-cavity parity kernels' stack and
// spills changed.  day_march.cu launches them through
// heatx_day_march_mrt_f32/_f64.
#define HEATX_DAY_MARCH_KMRT_UNIT
#include "day_march.cu"
