// The TR-BDF2 day march's kMrt kinds (interior MRT and the per-hour h/q and
// operative histories; day_march_tr.cu has the kernel), compiled as a unit
// of their own so that the other kinds keep their code, as the parity body's
// kMrt kinds are (day_march_parity_mrt.cu).  day_march_tr.cu launches them through
// heatx_day_march_tr_mrt_f32/_f64.
#define HEATX_DAY_MARCH_TR_KMRT_UNIT
#include "day_march_tr.cu"
