// The day march's launch arguments and launch variants, shared by its two
// kernels: the parity body (day_march_parity.cu, day_march_parity_mrt.cu) and
// the TR-BDF2 body (day_march_tr.cu, day_march_tr_mrt.cu).  day_march.cu
// fills one MrtMarchArgs per launch and hands it to the unit that runs the
// launch's kind; the instantiations without the network take its MarchArgs.
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

// The launch variants of both day-march kernels, G = kGroup threads a
// surface lane: the most lanes a block of each takes, its threads (the
// launch bound) and, in f32, the blocks an SM must hold (f64: one).  The
// 128-thread variant with three f32 blocks an SM runs the bench city's 334
// blocks of 32 lanes in one wave on 132 SMs; the 1024-thread one takes B1's
// edge (256 lanes) at 64 registers a thread.  launch_variant picks the first
// that takes a block's lanes; the C entry (day_march.cu) writes back the
// threads of the one that ran.
constexpr int kGroup = 4;
struct LaunchVariant {
  int lanes, threads, f32_blocks;
};
constexpr LaunchVariant kLaunchVariants[] = {{32, 128, 3}, {64, 256, 1}, {256, 1024, 1}};
constexpr int kVariants = sizeof(kLaunchVariants) / sizeof(kLaunchVariants[0]);
// The variant that takes a block of `lanes` lanes, or -1 for none.
constexpr int launch_variant(int lanes) {
  for (int v = 0; v < kVariants; ++v)
    if (lanes >= 1 && lanes <= kLaunchVariants[v].lanes) return v;
  return -1;
}
template <typename T, int kV>
constexpr int kVariantBlocks = sizeof(T) == 4 ? kLaunchVariants[kV].f32_blocks : 1;

// The TR-BDF2 day adjoint's launch variants (day_adjoint_tr.cu), the same
// G, lanes and threads as the day march's.  Its f32 128-thread variant asks
// for three blocks an SM like the day march's (168 registers, some spilled):
// at two (255 registers) the bench city's 334 blocks take two waves on 132
// SMs, 18 % slower a day-launch.
constexpr LaunchVariant kAdjLaunchVariants[] = {{32, 128, 3}, {64, 256, 1}, {256, 1024, 1}};
constexpr int kAdjVariants = sizeof(kAdjLaunchVariants) / sizeof(kAdjLaunchVariants[0]);
constexpr int adj_launch_variant(int lanes) {
  for (int v = 0; v < kAdjVariants; ++v)
    if (lanes >= 1 && lanes <= kAdjLaunchVariants[v].lanes) return v;
  return -1;
}
template <typename T, int kV>
constexpr int kAdjVariantBlocks = sizeof(T) == 4 ? kAdjLaunchVariants[kV].f32_blocks : 1;

}  // namespace heatx
