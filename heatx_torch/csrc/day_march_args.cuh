// The day march's launch arguments, shared by its two kernels: the parity
// body (day_march.cu, day_march_mrt.cu) and the TR-BDF2 body
// (day_march_tr.cu, day_march_tr_mrt.cu).  day_march.cu fills one
// MrtMarchArgs per launch and hands it to the unit that runs the launch's
// kind; the instantiations without the network take its MarchArgs.
#pragma once

#include <type_traits>

#include "day_common.cuh"

namespace heatx {

template <typename T>
struct MarchArgs {
  DayArgs<T> in;
  T* T_out;    // [N, SP]
  T* zT_out;   // [NB, ZB]
  T* hq;       // [4, SP]: h_front, h_back, q_front, q_back
  T* zt_hist;  // [hours, NB, ZB]
  T* bad;      // [hours, NB]
  T* ld_hist;  // [hours, NB, ZB] mean ideal load per hour (thermostats), or null
};

// The kMrt instantiations' arguments: the network's operands and the two
// histories beside the others' (whose layout stays as it was).
template <typename T>
struct MrtMarchArgs : MarchArgs<T> {
  MrtArgs<T> net;
  T* hq_hist;  // [hours, 4, SP] each hour's last h/q, or null
  T* top;      // [hours, NB, ZB] each hour's closing operative temperature, or null
};
template <typename T, bool kMrt>
using MarchArgsOf = std::conditional_t<kMrt, MrtMarchArgs<T>, MarchArgs<T>>;

// Bytes of dynamic shared memory of a block: the zone row, the two per-face
// rows, and with kExt the new zone row and the load sums, with kMrt the
// zones' MRT nodes, with gates the gated rows.
template <typename T, bool kExt, bool kMrt>
size_t march_smem(const DayArgs<T>& a) {
  return sizeof(T) * (static_cast<size_t>(a.ZB) * ((kMrt ? 4 : (kExt ? 3 : 1)) + (kExt && a.vent_min ? 2 : 0)) +
                      4 * static_cast<size_t>(a.SB));
}

}  // namespace heatx
