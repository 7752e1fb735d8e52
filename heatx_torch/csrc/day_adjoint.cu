// The day adjoints for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes; see heatx_torch/ops/day_adjoint.py): the C entry of
// both bodies.
//
// Replaces heatx/ops/pallas_adjoint.py::make_day_adjoint -> `kernel` (the
// pl.pallas_call at pallas_adjoint.py:717) in modes trbdf2 / trbdf2_refresh
// and parity, with gas cavities or without.  Given the cotangents of a day's final
// state (dT, d_zT), of its per-hour zone history and, with thermostats, of
// its per-hour mean ideal loads, one launch returns the cotangents of the
// day-start state, of the differentiated building rows (seg_u, mass, the
// solar absorption fractions, the 11 surface parameters, the zone volumes),
// of the per-hour inputs (solar and IR per face, the zone gain rows
// a_extra/b_extra) and of the thermostat setpoints (the compiled rows, or the
// per-hour schedule rows): exactly what autograd through the plain day march
// (heatx_torch/ops/day_march.py) gives.
//
// heatx builds the reverse pass with jax.vjp at trace time.  CUDA has no
// such thing, so every primitive's adjoint is written by hand, as the
// transpose of the device function that the forward uses:
//  * zone update: exact exponential in a_z, b_z and zT, with the air
//    capacity's dependence on zT; |b_z| <= 1e-9 passes the cotangent
//    through to zT;
//  * thermostat update (kExt): the branch is recomputed from the taped
//    (zT, a_z, b_z).  A zero load is the free-float update.  Otherwise the
//    result is the exponential update at a_z + load, whose a-cotangent joins
//    the load's own; an unclamped load passes both on through the landing
//    power to a_z, b_z, zT, the volume and the setpoint, a clamped one is a
//    constant (the capacities are not differentiated);
//  * mixing (kExt): the transpose of the sums over a zone's sources is a sum
//    over a source's destinations, in the fixed order of the lists grouped by
//    source, run by the source zone's own thread;
//  * zone sums: the transpose of the fixed-order sum is a gather (each face
//    reads its zone's cotangent from shared memory), and the transpose of the
//    boundary-temperature gather is the same fixed-order face sum the
//    forward uses.  Per-zone cotangents stay in one thread per zone: no
//    float atomics, deterministic;
//  * gas cavities: a cavity segment's U is a function of its two node
//    temperatures at each operator build (day_common.cuh cavity_u), so its
//    share of K's band cotangent goes through dU/dT to those nodes, not to
//    seg_u, whose cotangent there is exactly 0 (heatx: jnp.where(
//    seg_is_cavity, ...)).  The gas operands and the cavity geometry are not
//    differentiated, as in heatx (pallas_adjoint.py:44-47).  This code is in
//    the kCav instantiations only (x kExt), which every building with a
//    cavity takes.
// Both bodies run four threads per surface on their forward kernel's own
// device code: the TR-BDF2 body (day_adjoint_tr.cu, day_adjoint_tr_mrt.cu;
// device code in day_tr_adj.cuh) and the parity body (day_adjoint_parity.cu,
// day_adjoint_parity_mrt.cu; device code in day_parity_adj.cuh).  The C entry
// below checks a launch's arguments, the host's launch variant among them, and
// hands it to the body of its mode, whose units pick the kind.

#include <type_traits>

#include "day_adjoint_args.cuh"
#include "day_common.cuh"
#include "day_march_args.cuh"

extern "C" int heatx_day_adjoint_tr_f32(const void* g, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_tr_f64(const void* g, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_parity_f32(const void* g, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_parity_f64(const void* g, void* stream, int* block_threads);

namespace {

using namespace heatx;

template <typename T>
int launch(const MrtAdjArgs<T>& g, cudaStream_t stream, int* block_threads) {
  const DayArgs<T>& a = g.in;
  if (a.N < 1 || a.SB < 1 || a.NB < 1 || a.ZB < 1 || a.hours < 1 || a.refresh_every < 1 ||
      a.substeps % a.refresh_every || g.tape == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // The host's launch variant must take the block's lanes and rows, a
  // cluster's block in whole CTAs.
  if (!variant_takes(kAdjLaunchVariants, kAdjVariants, a.variant, a.SB, a.N))
    return static_cast<int>(cudaErrorInvalidValue);
  // The parity march rebuilds its operators every sub-step; its adjoint
  // takes a fixed number of no-mass iterations (heatx refuses the adaptive
  // loop's).
  if (a.parity && (a.refresh_every != 1 || a.nomass_iters < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // Thermostat rows come with the load cotangent and the rows' output;
  // schedule rows with theirs; mixing with both groupings of its entries.
  const bool ctl = a.ctl != nullptr, sched = a.sp_heat != nullptr;
  if (ctl != (g.d_ld_hist != nullptr) || ctl != (g.d_ctl != nullptr) || (sched && !ctl) ||
      sched != (a.sp_cool != nullptr) || sched != (g.d_sp_heat != nullptr) ||
      sched != (g.d_sp_cool != nullptr) || (a.mix_ptr != nullptr) != (a.mixt_ptr != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // MRT physics comes with the network's operands and its cotangents' output.
  const bool mrt = g.net.phys != 0;
  if (mrt != (g.net.mrt != nullptr) || mrt != (g.d_mrt != nullptr) || (mrt && !g.net.mrt_ptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = std::is_same_v<T, float>;
  if (a.parity)
    return f32 ? heatx_day_adjoint_parity_f32(&g, stream, block_threads)
               : heatx_day_adjoint_parity_f64(&g, stream, block_threads);
  return f32 ? heatx_day_adjoint_tr_f32(&g, stream, block_threads)
             : heatx_day_adjoint_tr_f64(&g, stream, block_threads);
}

constexpr int kPointers = 49;

template <typename T>
int day_adjoint(void* const* p, int n_ptrs, const int* ints, const double* reals, int* block_threads,
                void* stream) {
  if (block_threads) *block_threads = 0;
  if (n_ptrs != kPointers) return static_cast<int>(cudaErrorInvalidValue);
  MrtAdjArgs<T> g;  // the kMrt instantiations take it whole, the others its AdjArgs
  DayArgs<T>& a = g.in;
  int i = 0;
  a.node = static_cast<const T*>(p[i++]);
  a.surf = static_cast<const T*>(p[i++]);
  a.lane = static_cast<const int*>(p[i++]);
  a.zone_volume = static_cast<const T*>(p[i++]);
  a.zone_ptr = static_cast<const int*>(p[i++]);
  a.zone_faces = static_cast<const int*>(p[i++]);
  a.t_out = static_cast<const T*>(p[i++]);
  a.wind = static_cast<const T*>(p[i++]);
  a.wdir = static_cast<const T*>(p[i++]);
  a.sol_f = static_cast<const T*>(p[i++]);
  a.sol_b = static_cast<const T*>(p[i++]);
  a.ir_f = static_cast<const T*>(p[i++]);
  a.ir_b = static_cast<const T*>(p[i++]);
  a.a_extra = static_cast<const T*>(p[i++]);
  a.b_extra = static_cast<const T*>(p[i++]);
  a.T0 = static_cast<const T*>(p[i++]);
  a.zT0 = static_cast<const T*>(p[i++]);
  g.dT = static_cast<const T*>(p[i++]);
  g.d_zT = static_cast<const T*>(p[i++]);
  g.d_zt_hist = static_cast<const T*>(p[i++]);
  g.T_ws = static_cast<T*>(p[i++]);
  g.zT_ws = static_cast<T*>(p[i++]);
  g.dT0 = static_cast<T*>(p[i++]);
  g.d_zT0 = static_cast<T*>(p[i++]);
  g.d_node = static_cast<T*>(p[i++]);
  g.d_surf = static_cast<T*>(p[i++]);
  g.d_zv = static_cast<T*>(p[i++]);
  g.d_chan = static_cast<T*>(p[i++]);
  g.d_a = static_cast<T*>(p[i++]);
  g.d_b = static_cast<T*>(p[i++]);
  g.d_ld_hist = static_cast<const T*>(p[i++]);
  a.ctl = static_cast<const T*>(p[i++]);
  a.sp_heat = static_cast<const T*>(p[i++]);
  a.sp_cool = static_cast<const T*>(p[i++]);
  a.mix_ptr = static_cast<const int*>(p[i++]);
  a.mix_src = static_cast<const int*>(p[i++]);
  a.mix_vol = static_cast<const T*>(p[i++]);
  a.mixt_ptr = static_cast<const int*>(p[i++]);
  a.mixt_dst = static_cast<const int*>(p[i++]);
  a.mixt_vol = static_cast<const T*>(p[i++]);
  g.d_ctl = static_cast<T*>(p[i++]);
  g.d_sp_heat = static_cast<T*>(p[i++]);
  g.d_sp_cool = static_cast<T*>(p[i++]);
  a.cav = static_cast<const T*>(p[i++]);
  g.net.mrt = static_cast<const T*>(p[i++]);
  g.net.mrt_ptr = static_cast<const int*>(p[i++]);
  g.net.mrt_faces = static_cast<const int*>(p[i++]);
  g.d_mrt = static_cast<T*>(p[i++]);
  g.tape = static_cast<T*>(p[i++]);
  a.N = ints[0];
  a.NB = ints[1];
  a.SB = ints[2];
  a.ZB = ints[3];
  a.hours = ints[4];
  a.substeps = ints[5];
  a.refresh_every = ints[6];
  a.amb_bug = ints[7];
  a.dt = reals[0];
  a.half_dt = reals[1];
  a.gamma_dt = reals[2];
  a.beta_dt = reals[3];
  a.c1 = reals[4];
  a.c2 = reals[5];
  a.parity = ints[8];
  a.nomass_iters = ints[9];
  a.esc_after = ints[10];
  g.net.phys = ints[11];
  a.variant = ints[12];
  a.nomass_tol = reals[6];
  a.nomass_tol_esc = reals[7];
  return launch<T>(g, static_cast<cudaStream_t>(stream), block_threads);
}

}  // namespace

extern "C" {

// Launch on `stream`.  `ptrs` holds the 49 device pointers in the order of
// DayAdjointKernel (operands, cotangents, workspace, outputs, then the
// thermostat, schedule and mixing operands and outputs, null where the
// building has none, the gas-cavity operands, the MRT network's
// operands and its cotangents' output, and last the tape workspace of both
// bodies), `ints` N, NB, SB, ZB, hours, substeps, refresh_every, amb_bug,
// parity, nomass_iters, esc_after, mrt_phys, the launch variant (an index
// of kAdjLaunchVariants: heatx_torch/ops/day_march.py launch_shape), `reals` dt, gamma dt/2, gamma
// dt, beta dt, c1, c2, nomass_tol, nomass_tol_esc.  Writes the threads of a
// block of the launch variant the launch ran in to *block_threads.  Returns
// cudaGetLastError() of the launch.
int heatx_day_adjoint_f32(void* const* ptrs, int n_ptrs, const int* ints, const double* reals,
                          int* block_threads, void* stream) {
  return day_adjoint<float>(ptrs, n_ptrs, ints, reals, block_threads, stream);
}
int heatx_day_adjoint_f64(void* const* ptrs, int n_ptrs, const int* ints, const double* reals,
                          int* block_threads, void* stream) {
  return day_adjoint<double>(ptrs, n_ptrs, ints, reals, block_threads, stream);
}

const char* heatx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
