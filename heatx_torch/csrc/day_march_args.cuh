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

// The launch variants of both day-march kernels: the most lanes one CTA of
// each takes, its threads (the launch bound), in f32 the blocks an SM must
// hold (f64: one), G threads a surface lane (M = 8 rows each), the column's
// node capacity M x G, and the most CTAs of a thread-block cluster (1: a
// zone-closed block is one CTA).  The 128-thread variant with three f32
// blocks an SM runs the bench city's 334 blocks of 32 lanes in one wave on
// 132 SMs; the 1024-thread G = 4 one takes 256 lanes at 64 registers a
// thread.  The last one takes what those do not: columns of 33-64 rows at G
// = 8, and components past 256 lanes (at 32 rows too) as a cluster of up to
// 8 CTAs (portable) of 128 lanes each, which read each other's face rows
// over distributed shared memory (day_cluster.cuh); only it compiles the
// cluster code.  The host picks the variant (heatx_torch/ops/day_march.py
// launch_shape: the first that takes a block's lanes and rows, from
// LAUNCH_VARIANTS, which mirrors the table; tests/test_torch_partitioned_solve.py
// holds the two equal) and hands its index in DayArgs::variant; the C entry
// (day_march.cu) checks that the variant takes the block (variant_takes) and
// writes back the threads of a CTA of the one that ran.
struct LaunchVariant {
  int lanes, threads, f32_blocks, group, nodes, cluster;
};
constexpr LaunchVariant kLaunchVariants[] = {
    {32, 128, 3, 4, 32, 1}, {64, 256, 1, 4, 32, 1}, {256, 1024, 1, 4, 32, 1}, {128, 1024, 1, 8, 64, 8}};
constexpr int kVariants = sizeof(kLaunchVariants) / sizeof(kLaunchVariants[0]);
// Whether variant v of a table of `count` takes a block of `lanes` lanes and
// `nodes` rows: its columns take the rows, and one CTA takes the lanes or
// they are whole CTAs of a cluster the variant allows.
constexpr bool variant_takes(const LaunchVariant* table, int count, int v, int lanes, int nodes) {
  if (v < 0 || v >= count || lanes < 1 || nodes > table[v].nodes) return false;
  const LaunchVariant& V = table[v];
  return lanes <= V.lanes || (V.cluster > 1 && lanes % V.lanes == 0 && lanes / V.lanes <= V.cluster);
}
template <typename T, int kV>
constexpr int kVariantBlocks = sizeof(T) == 4 ? kLaunchVariants[kV].f32_blocks : 1;
// Whether variant kV compiles the cluster code.
template <int kV>
constexpr bool kVariantCluster = kLaunchVariants[kV].cluster > 1;
// The CTAs of the cluster that runs a block of `lanes` lanes in variant v
// (the host blocks a cluster's component in whole CTAs: lanes = C x lanes
// a CTA, day_march.launch_block_lanes), 1 for one CTA.
constexpr int cluster_ctas(const LaunchVariant& v, int lanes) {
  return lanes <= v.lanes ? 1 : (lanes + v.lanes - 1) / v.lanes;
}

// The day adjoints' launch variants (day_adjoint_tr.cu,
// day_adjoint_parity.cu), the same G, lanes, threads, rows and clusters as
// the day march's.  The TR-BDF2 adjoint's f32 128-thread variant asks for
// three blocks an SM like the day march's (168 registers, some spilled): at
// two (255 registers) the bench city's 334 blocks take two waves on 132 SMs,
// 18 % slower a day-launch.
constexpr LaunchVariant kAdjLaunchVariants[] = {
    {32, 128, 3, 4, 32, 1}, {64, 256, 1, 4, 32, 1}, {256, 1024, 1, 4, 32, 1}, {128, 1024, 1, 8, 64, 8}};
constexpr int kAdjVariants = sizeof(kAdjLaunchVariants) / sizeof(kAdjLaunchVariants[0]);
// The unstaged G = 4 variant, which takes a block whose staged rows would not
// fit a staged variant's shared memory.
constexpr int kAdjUnstaged = 2;
template <typename T, int kV>
constexpr int kAdjVariantBlocks = sizeof(T) == 4 ? kAdjLaunchVariants[kV].f32_blocks : 1;

}  // namespace heatx
