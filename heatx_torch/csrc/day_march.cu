// The day march for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes; see heatx_torch/ops/day_march.py).
//
// Replaces heatx/ops/pallas_step.py::make_hour_march -> `kernel` (the
// pl.pallas_call at pallas_step.py:1976) in modes trbdf2 / trbdf2_refresh,
// body `_hour_body_imp`, and in mode parity, body `_hour_body` (kParity; the
// sub-step itself is in day_parity.cuh), with gas cavities or without,
// free-float, or with thermostats (`_zone_update_ctl`, the per-hour mean load
// history), per-hour setpoint schedules, inter-zone mixing, and the in-run
// passive controls (zone shading and ventilation gates, pallas_step.py
// :1576-1594 and :1614-1635).
// One launch marches `hours` hours of `substeps` sub-steps per sub-step
// operator group of `refresh_every` (frozen mode: refresh_every == substeps).
//
// What bounds it: per-thread serial FLOPs and latency, not bytes.  The state
// at bench scale (10,752 lanes x 25 nodes) is about 1 MB in f32, and each
// sub-step is a chain of dependent Thomas sweeps down each surface's node
// column, so the time is the length of that chain times the latency of its
// steps.
//
// Design:
//  * One CTA per zone-closed block, one thread per surface lane (blockDim ==
//    lanes per block, at most 256).  Blocks are independent: zones never
//    cross blocks, so nothing is shared across the grid.
//  * Each thread keeps its surface's node column (N <= 32) in per-thread
//    arrays: the state, the stage-1 result and the pre-factored stage
//    matrix (modified upper coefficients and pivot reciprocals).  The
//    static node data (U, capacity, solar absorption fractions) is re-read
//    from global memory, coalesced across the lanes.  Local-memory spills
//    are accepted in this first version.
//  * Zone coupling in shared memory: boundary temperatures are indexed reads
//    of the block's zone row s_zT[ZB] through a block-local zone index per
//    face (-1: the face bounds no zone).  The zone A/B sums are one thread
//    per zone summing its faces' h*A*T_s and h*A in a fixed order (a lane
//    list built on the host: front faces, then back faces, ascending lane),
//    so two runs give the same bits; no float atomics.
//  * The zone update is the exact exponential with expm1, one thread per
//    zone.  __syncthreads() separates the phases of each sub-step.
//  * Thermostats, schedules and mixing are a second instantiation of the
//    kernel template (kExt), so a free-float building runs the code it ran
//    without them.  There the zone thread adds the mixing sums of its
//    sources' sub-step-start temperatures, applies the setpoint-landing
//    update and accumulates the load.  Because a zone reads other zones' old
//    temperatures while it computes its own new one, the new row goes to a
//    second shared row and the two swap after the sub-step's last barrier: no
//    third barrier.  The hour's mean load goes to ld_hist.
//  * The hour loop runs inside the kernel; weather per sub-step, the hour's
//    solar/IR per lane and the zone gains come from device memory.  Outputs:
//    final T and zT, the last h/q, the per-hour zone history and the
//    per-hour non-finite count.
//  * The device functions (lane statics, operator build, one sub-step, zone
//    sums and update) live in day_common.cuh, shared with the adjoint kernel
//    (day_adjoint.cu), whose recompute is therefore this kernel's arithmetic.
//  * Gas cavities: a cavity lane's K reads its segment U-values from a
//    per-launch copy of the U row (cav_u, written by the wrapper) whose
//    cavity segments an out-of-line device function rewrites at every
//    operator build.  That code is compiled only into two more
//    instantiations (kCav, with kExt, TR-BDF2 and parity), which every
//    building with a cavity takes: without kCav the lane's cavity word is
//    the constant 0, the cavity branches fold away, and the other
//    instantiations keep their code and their ptxas lines (a call to the
//    out-of-line function alone raised the TR-BDF2 kernel from 77 to 112
//    registers).
//  * The parity march is two more instantiations (kParity x kExt): the same
//    hour loop, zone phases and outputs around parity_substep, with the
//    operators rebuilt every sub-step (refresh_every == 1), so the four
//    TR-BDF2 instantiations keep their code.
//  * Interior MRT (heatx _mrt_context) and the two per-hour histories are
//    four more instantiations (kMrt, with kExt; TR-BDF2 and parity, with and
//    without kCav), which every launch with MRT physics, the h/q history or
//    the operative history takes.  The Carroll network's static part rides as
//    operands (day_march.mrt_eps_blocked); its 4-iteration fixed point runs
//    where the operators are built (TR-BDF2: each refresh group's start
//    column; parity: each sub-step's start), block-local because blocks are
//    zone-closed: per iteration each lane writes its network faces'
//    conductances to the zone-sum rows, one thread per zone sums its network
//    faces (mrt_ptr/mrt_faces, fixed order) into a shared row of zone nodes,
//    each lane gathers them; eight barriers per evaluation.  The operative
//    history is one more evaluation at each hour's end, from the zone air, on
//    the hour's final state (a runtime flag: it needs no MRT physics); the h/q
//    history is the hour's last h/q.  What bounds it is unchanged: the MRT
//    phase adds ~12 operations per network face and iteration and its
//    barriers to each operator build.
//  * In-run zone shading and ventilation gates are code of the kExt
//    instantiations (a gated building takes one, and so does every kCav and
//    kMrt kind), at the top of the hour loop: one kernel "hour" is one main
//    step, and both decisions read the zone carry s_zT at its start, before
//    the first sub-step's barrier (the last barrier of the previous hour, or
//    the one after the start state's load, made the row whole).  Shading: a
//    controlled lane reads its controlling zone's slot and scales the hour's
//    front solar by the device's transmittance (scale, then clamp; heatx's
//    order).  Gates: each zone's owner thread writes a_extra (+ a_vent) and
//    b_extra (+ b_vent) into two shared rows once per hour, and the same
//    thread reads them in every sub-step's zone sums, so no barrier is
//    added; the decision is held even as s_zT moves.  O(lanes + zones) per
//    hour against O(sub-steps x nodes).

#include <type_traits>

#include "day_common.cuh"
#include "day_parity.cuh"

// The kMrt instantiations live in their own compilation unit
// (day_march_mrt.cu, which includes this file): ptxas shares the out-of-line
// device functions among the kernels of one unit, and the kMrt kernels beside
// the others changed those others' registers and stack.  The units meet here,
// at a launch function of the kMrt unit that takes its MrtMarchArgs by address.
extern "C" int heatx_day_march_mrt_f32(const void* m, void* stream, int parity);
extern "C" int heatx_day_march_mrt_f64(const void* m, void* stream, int parity);

namespace {

using namespace heatx;

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

template <typename T, bool kExt, bool kParity, bool kCav, bool kMrt>
__global__ void __launch_bounds__(kMaxLanes) day_march_kernel(const MarchArgsOf<T, kMrt> m) {
  const DayArgs<T>& a = m.in;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_zT = reinterpret_cast<T*>(smem_raw);  // [ZB] zone air temperatures
  T* s_haT = s_zT + a.ZB;                    // [2*SB] h*A*T_s per face (kMrt: also w*T_s)
  T* s_ha = s_haT + 2 * a.SB;                // [2*SB] h*A per face (kMrt: also w)
  T* s_zN = s_ha + 2 * a.SB;                 // kExt: [ZB] the sub-step's new zone row
  T* s_ld = s_zN + a.ZB;                     // kExt: [ZB] the hour's load sum
  T* s_tm = s_ld + a.ZB;                     // kMrt: [ZB] the zones' MRT nodes
  T* s_ga = s_tm + (kMrt ? a.ZB : 0);        // kExt, gated: [ZB] the hour's gated a_extra
  T* s_gb = s_ga + a.ZB;                     // kExt, gated: [ZB] the hour's gated b_extra
  __shared__ int s_bad;

  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int SP = NB * SB;
  const int lane = b * SB + tid;
  const Lane<T> L(a, lane, kCav);
  MrtLane<T> M;
  if constexpr (kMrt) M = MrtLane<T>(a, m.net, lane);
  const Scheme<T> sc(a);

  T Tn[kMaxNodes], T1[kMaxNodes], cs[kMaxNodes], inv[kMaxNodes];
  for (int i = 0; i < N; ++i) Tn[i] = a.T0[i * SP + lane];
  for (int z = tid; z < ZB; z += SB) {
    s_zT[z] = a.zT0[b * ZB + z];
    if (kExt) s_ld[z] = T(0);
  }
  __syncthreads();

  Ops<T> o{};
  T qf = T(0), qb = T(0);
  for (int h = 0; h < a.hours; ++h) {
    // The in-run controls at the main step's start (see the design notes).
    T shade = T(1);
    if (kExt && a.shade_slot) {
      const int z = a.shade_slot[lane];
      if (z >= 0 && s_zT[z] > a.shade_sp[(size_t)h * a.shade_sp_stride + lane])
        shade = a.shade_tau[lane];
    }
    const HourIn<T> hi(a, h, lane, shade);
    const T* a_ex = a.a_extra + (size_t)h * NB * ZB + b * ZB;
    const T* b_ex = a.b_extra + (size_t)h * NB * ZB + b * ZB;
    const bool gated = kExt && a.vent_min;
    if (gated) {
      const size_t row = (size_t)h * NB * ZB + b * ZB;
      for (int z = tid; z < ZB; z += SB) {
        const int gz = b * ZB + z;
        const T zt = s_zT[z];
        const bool on = zt > a.vent_min[gz] && zt < a.vent_max[gz] && zt > a.vent_thr[row + z];
        s_ga[z] = a_ex[z] + (on ? a.a_vent[row + z] : T(0));
        s_gb[z] = b_ex[z] + (on ? a.b_vent[row + z] : T(0));
      }
    }
    for (int i0 = 0; i0 < a.substeps; i0 += a.refresh_every) {
      const int w = h * a.substeps + i0;
      T t_front, t_back;
      if (!kParity) {
        L.boundary(s_zT, a.t_out[w], t_front, t_back);
        if constexpr (kMrt) {
          // The network frozen with the operators, from the group's start
          // (without MRT physics an empty context: the faces' own radiation).
          MrtFace<T> mf{};
          if (m.net.phys)
            mf = mrt_context(a, m.net, L, M, b, tid, Tn, t_front, t_back, s_zT, s_ha, s_haT, s_tm);
          o = build_ops<T, true>(L, Tn, t_front, t_back, a.wind[w], a.wdir[w], hi, a.amb_bug, sc.a_dt,
                                 cs, inv, &mf);
        } else {
          o = build_ops(L, Tn, t_front, t_back, a.wind[w], a.wdir[w], hi, a.amb_bug, sc.a_dt, cs, inv);
        }
      }

      for (int i = i0; i < i0 + a.refresh_every; ++i) {
        L.boundary(s_zT, a.t_out[h * a.substeps + i], t_front, t_back);
        if (kParity) {  // refresh_every is 1: the operators are the sub-step's own
          ParityWork<T> W;
          if constexpr (kMrt) {  // the network of the sub-step's start state
            MrtFace<T> mf{};
            if (m.net.phys)
              mf = mrt_context(a, m.net, L, M, b, tid, Tn, t_front, t_back, s_zT, s_ha, s_haT, s_tm);
            o = parity_substep<T, true>(Chunks<T>(a, L, lane), ParityCfg<T>(a), hi, t_front, t_back,
                                        a.wind[w], a.wdir[w], a.amb_bug, Tn, W, &mf);
          } else {
            o = parity_substep(Chunks<T>(a, L, lane), ParityCfg<T>(a), hi, t_front, t_back,
                               a.wind[w], a.wdir[w], a.amb_bug, Tn, W);
          }
        } else {
          march_substep(L, o, cs, inv, hi, t_front, t_back, sc, Tn, T1);
        }
        const T ts_front = Tn[0];
        const T ts_back = L.last_node(Tn);
        qf = (ts_front - t_front) * o.hf;
        qb = (ts_back - t_back) * o.hb;
        const T haf = o.hf * L.area, hab = o.hb * L.area;
        s_haT[2 * tid] = haf * ts_front;
        s_ha[2 * tid] = haf;
        s_haT[2 * tid + 1] = hab * ts_back;
        s_ha[2 * tid + 1] = hab;
        __syncthreads();

        // Zone sums and the exact exponential zone update, one thread per zone.
        for (int z = tid; z < ZB; z += SB) {
          const int gz = b * ZB + z;
          T az, bz;
          zone_sums(a.zone_ptr, a.zone_faces, gz, s_haT, s_ha, gated ? s_ga[z] : a_ex[z],
                    gated ? s_gb[z] : b_ex[z], az, bz);
          if (kExt) {
            if (a.mix_ptr) mix_sums(a, gz, s_zT, az, bz);
            if (a.ctl) {
              T load;
              s_zN[z] = zone_update_ctl(s_zT[z], az, bz, a.zone_volume[gz], sc.dt,
                                        Setpoints<T>(a, h, gz), load);
              s_ld[z] += load;
            } else {
              s_zN[z] = zone_update(s_zT[z], az, bz, a.zone_volume[gz], sc.dt);
            }
          } else {
            s_zT[z] = zone_update(s_zT[z], az, bz, a.zone_volume[gz], sc.dt);
          }
        }
        __syncthreads();
        if (kExt) {  // the new row becomes the current one
          T* t = s_zT;
          s_zT = s_zN;
          s_zN = t;
        }
      }
    }

    // ---- end of hour: the histories, the non-finite count -----------------
    if constexpr (kMrt) {
      if (m.hq_hist) {
        T* hq_h = m.hq_hist + (size_t)h * 4 * SP + lane;
        hq_h[0] = o.hf;
        hq_h[SP] = o.hb;
        hq_h[2 * SP] = qf;
        hq_h[3 * SP] = qb;
      }
      if (m.top) {  // the zone-air-started network on the hour's final state
        T t_front, t_back;
        L.boundary(s_zT, a.t_out[h * a.substeps + a.substeps - 1], t_front, t_back);
        mrt_context(a, m.net, L, M, b, tid, Tn, t_front, t_back, s_zT, s_ha, s_haT, s_tm);
        for (int z = tid; z < ZB; z += SB)
          m.top[(size_t)h * NB * ZB + b * ZB + z] = (s_zT[z] + s_tm[z]) / T(2);
      }
    }
    int cnt = 0;
    for (int i = 0; i < N; ++i)
      if (L.valid(i) && !is_finite(Tn[i])) ++cnt;
    for (int z = tid; z < ZB; z += SB) {
      const T zt = s_zT[z];
      m.zt_hist[(size_t)h * NB * ZB + b * ZB + z] = zt;
      if (!is_finite(zt)) ++cnt;
      if (kExt && a.ctl) {
        m.ld_hist[(size_t)h * NB * ZB + b * ZB + z] = s_ld[z] / T(a.substeps);
        s_ld[z] = T(0);
      }
    }
    if (tid == 0) s_bad = 0;
    __syncthreads();
    if (cnt) atomicAdd(&s_bad, cnt);
    __syncthreads();
    if (tid == 0) m.bad[h * NB + b] = T(s_bad);
  }

  for (int i = 0; i < N; ++i) m.T_out[i * SP + lane] = Tn[i];
  m.hq[lane] = o.hf;
  m.hq[SP + lane] = o.hb;
  m.hq[2 * SP + lane] = qf;
  m.hq[3 * SP + lane] = qb;
  for (int z = tid; z < ZB; z += SB) m.zT_out[b * ZB + z] = s_zT[z];
}

template <typename T>
int check_args(const MarchArgs<T>& m) {
  const DayArgs<T>& a = m.in;
  if (a.N < 1 || a.N > kMaxNodes || a.SB < 1 || a.SB > kMaxLanes || a.NB < 1 ||
      a.ZB < 1 || a.hours < 1 || a.refresh_every < 1 || a.substeps % a.refresh_every)
    return static_cast<int>(cudaErrorInvalidValue);
  // The parity march rebuilds its operators every sub-step.
  if (a.parity && (a.refresh_every != 1 || a.nomass_iters < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // Thermostat rows come with a load history; schedules need the rows.
  if ((a.ctl != nullptr) != (m.ld_hist != nullptr) ||
      (a.sp_heat != nullptr) != (a.sp_cool != nullptr) || (a.sp_heat && !a.ctl))
    return static_cast<int>(cudaErrorInvalidValue);
  // Shading comes with its transmittances and setpoints, gates with their rows.
  if ((a.shade_slot != nullptr) != (a.shade_tau != nullptr) ||
      (a.vent_min != nullptr) != (a.a_vent && a.b_vent && a.vent_thr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSuccess);
}

template <typename T, bool kExt, bool kParity, bool kCav = false, bool kMrt = false>
int launch_as(const MarchArgsOf<T, kMrt>& m, cudaStream_t stream) {
  const DayArgs<T>& a = m.in;
  const size_t smem = sizeof(T) * (static_cast<size_t>(a.ZB) * ((kMrt ? 4 : (kExt ? 3 : 1)) +
                                                                 (kExt && a.vent_min ? 2 : 0)) +
                                   4 * static_cast<size_t>(a.SB));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(day_march_kernel<T, kExt, kParity, kCav, kMrt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  day_march_kernel<T, kExt, kParity, kCav, kMrt><<<a.NB, a.SB, smem, stream>>>(m);
  return static_cast<int>(cudaGetLastError());
}

#ifndef HEATX_DAY_MARCH_KMRT_UNIT
template <typename T>
int day_march(const void* node, const void* surf, const void* lane, const void* zone_volume,
              const void* zone_ptr, const void* zone_faces, const void* t_out, const void* wind,
              const void* wdir, const void* sol_f, const void* sol_b, const void* ir_f,
              const void* ir_b, const void* a_extra, const void* b_extra, const void* T0,
              const void* zT0, void* T_out, void* zT_out, void* hq, void* zt_hist, void* bad,
              void* ld_hist, const void* ctl, const void* sp_heat, const void* sp_cool,
              const void* mix_ptr, const void* mix_src, const void* mix_vol, void* cav_u, const void* cav,
              const void* mrt, const void* mrt_ptr, const void* mrt_faces, void* hq_hist, void* top,
              const void* shade_slot, const void* shade, const void* shade_sp, const void* vent,
              const void* a_vent, const void* b_vent, const void* vent_thr, int N,
              int NB, int SB, int ZB, int hours, int substeps, int refresh_every, int amb_bug,
              int parity, int nomass_iters, int esc_after, int mrt_phys, double dt, double half_dt,
              double gamma_dt, double beta_dt, double c1, double c2, double nomass_tol,
              double nomass_tol_esc, void* stream) {
  MrtMarchArgs<T> m;  // the kMrt instantiations take it whole, the others its MarchArgs
  DayArgs<T>& a = m.in;
  a.node = static_cast<const T*>(node);
  a.surf = static_cast<const T*>(surf);
  a.lane = static_cast<const int*>(lane);
  a.zone_volume = static_cast<const T*>(zone_volume);
  a.zone_ptr = static_cast<const int*>(zone_ptr);
  a.zone_faces = static_cast<const int*>(zone_faces);
  a.t_out = static_cast<const T*>(t_out);
  a.wind = static_cast<const T*>(wind);
  a.wdir = static_cast<const T*>(wdir);
  a.sol_f = static_cast<const T*>(sol_f);
  a.sol_b = static_cast<const T*>(sol_b);
  a.ir_f = static_cast<const T*>(ir_f);
  a.ir_b = static_cast<const T*>(ir_b);
  a.a_extra = static_cast<const T*>(a_extra);
  a.b_extra = static_cast<const T*>(b_extra);
  a.T0 = static_cast<const T*>(T0);
  a.zT0 = static_cast<const T*>(zT0);
  m.T_out = static_cast<T*>(T_out);
  m.zT_out = static_cast<T*>(zT_out);
  m.hq = static_cast<T*>(hq);
  m.zt_hist = static_cast<T*>(zt_hist);
  m.bad = static_cast<T*>(bad);
  m.ld_hist = static_cast<T*>(ld_hist);
  a.ctl = static_cast<const T*>(ctl);
  a.sp_heat = static_cast<const T*>(sp_heat);
  a.sp_cool = static_cast<const T*>(sp_cool);
  a.mix_ptr = static_cast<const int*>(mix_ptr);
  a.mix_src = static_cast<const int*>(mix_src);
  a.mix_vol = static_cast<const T*>(mix_vol);
  a.mixt_ptr = nullptr;  // the transposed lists are the adjoint's
  a.mixt_dst = nullptr;
  a.mixt_vol = nullptr;
  a.cav_u = static_cast<T*>(cav_u);
  a.cav = static_cast<const T*>(cav);
  m.net.mrt = static_cast<const T*>(mrt);
  m.net.mrt_ptr = static_cast<const int*>(mrt_ptr);
  m.net.mrt_faces = static_cast<const int*>(mrt_faces);
  m.net.phys = mrt_phys;
  m.hq_hist = static_cast<T*>(hq_hist);
  m.top = static_cast<T*>(top);
  // shade [2, SP]: the transmittances, then the compiled setpoints (read
  // when no per-hour series comes); vent [2, NB, ZB]: the indoor limits.
  a.shade_slot = static_cast<const int*>(shade_slot);
  a.shade_tau = static_cast<const T*>(shade);
  a.shade_sp = shade_sp ? static_cast<const T*>(shade_sp)
                        : (shade ? a.shade_tau + static_cast<size_t>(NB) * SB : nullptr);
  a.shade_sp_stride = shade_sp ? NB * SB : 0;
  a.vent_min = static_cast<const T*>(vent);
  a.vent_max = vent ? a.vent_min + static_cast<size_t>(NB) * ZB : nullptr;
  a.a_vent = static_cast<const T*>(a_vent);
  a.b_vent = static_cast<const T*>(b_vent);
  a.vent_thr = static_cast<const T*>(vent_thr);
  a.N = N;
  a.NB = NB;
  a.SB = SB;
  a.ZB = ZB;
  a.hours = hours;
  a.substeps = substeps;
  a.refresh_every = refresh_every;
  a.amb_bug = amb_bug;
  a.dt = dt;
  a.half_dt = half_dt;
  a.gamma_dt = gamma_dt;
  a.beta_dt = beta_dt;
  a.c1 = c1;
  a.c2 = c2;
  a.parity = parity;
  a.nomass_iters = nomass_iters;
  a.esc_after = esc_after;
  a.nomass_tol = nomass_tol;
  a.nomass_tol_esc = nomass_tol_esc;
  const int err = check_args<T>(m);
  if (err) return err;
  // MRT physics and the histories take the network operands (an empty face
  // list may come as a null pointer: it is never read).
  if ((mrt_phys || m.top || m.hq_hist) && !(m.net.mrt && m.net.mrt_ptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((a.cav != nullptr) != (a.cav_u != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  // Free-float buildings run the instantiation without the extra zone code
  // (thermostats, mixing, in-run shading and gates); buildings with gas
  // cavities the extended one with the cavity code (kCav), whatever their
  // zones have, so the others keep their code.  MRT physics and the
  // histories take the extended instantiations with the network (kMrt),
  // with the cavity code where the building has it.
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ext = a.ctl || a.mix_ptr || a.shade_slot || a.vent_min;
  if (m.net.mrt)
    return std::is_same_v<T, float> ? heatx_day_march_mrt_f32(&m, stream, parity)
                                    : heatx_day_march_mrt_f64(&m, stream, parity);
  const MarchArgs<T>& b = m;
  if (a.cav)
    return parity ? launch_as<T, true, true, true>(b, st) : launch_as<T, true, false, true>(b, st);
  if (parity) return ext ? launch_as<T, true, true>(b, st) : launch_as<T, false, true>(b, st);
  return ext ? launch_as<T, true, false>(b, st) : launch_as<T, false, false>(b, st);
}
#else
// The kMrt unit: MRT physics and the histories, with the cavity code where
// the building has gas cavities (kMrt implies kExt).
template <typename T>
int day_march_mrt(const void* args, void* stream, int parity) {
  const MrtMarchArgs<T>& m = *static_cast<const MrtMarchArgs<T>*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m.in.cav)
    return parity ? launch_as<T, true, true, true, true>(m, st)
                  : launch_as<T, true, false, true, true>(m, st);
  return parity ? launch_as<T, true, true, false, true>(m, st)
                : launch_as<T, true, false, false, true>(m, st);
}
#endif

}  // namespace

#ifdef HEATX_DAY_MARCH_KMRT_UNIT
int heatx_day_march_mrt_f32(const void* m, void* stream, int parity) {
  return day_march_mrt<float>(m, stream, parity);
}
int heatx_day_march_mrt_f64(const void* m, void* stream, int parity) {
  return day_march_mrt<double>(m, stream, parity);
}
#else

#define HEATX_DAY_MARCH_ARGS                                                               \
  const void *node, const void *surf, const void *lane, const void *zone_volume,           \
      const void *zone_ptr, const void *zone_faces, const void *t_out, const void *wind,   \
      const void *wdir, const void *sol_f, const void *sol_b, const void *ir_f,            \
      const void *ir_b, const void *a_extra, const void *b_extra, const void *T0,          \
      const void *zT0, void *T_out, void *zT_out, void *hq, void *zt_hist, void *bad,      \
      void *ld_hist, const void *ctl, const void *sp_heat, const void *sp_cool,            \
      const void *mix_ptr, const void *mix_src, const void *mix_vol, void *cav_u, const void *cav,  \
      const void *mrt, const void *mrt_ptr, const void *mrt_faces, void *hq_hist, void *top,  \
      const void *shade_slot, const void *shade, const void *shade_sp, const void *vent,  \
      const void *a_vent, const void *b_vent, const void *vent_thr, int N,                 \
      int NB, int SB, int ZB, int hours, int substeps, int refresh_every, int amb_bug,     \
      int parity, int nomass_iters, int esc_after, int mrt_phys, double dt, double half_dt, \
      double gamma_dt, double beta_dt, double c1, double c2, double nomass_tol,            \
      double nomass_tol_esc, void *stream
#define HEATX_DAY_MARCH_CALL                                                               \
  node, surf, lane, zone_volume, zone_ptr, zone_faces, t_out, wind, wdir, sol_f, sol_b,    \
      ir_f, ir_b, a_extra, b_extra, T0, zT0, T_out, zT_out, hq, zt_hist, bad, ld_hist,     \
      ctl, sp_heat, sp_cool, mix_ptr, mix_src, mix_vol, cav_u, cav, mrt, mrt_ptr, mrt_faces, \
      hq_hist, top, shade_slot, shade, shade_sp, vent, a_vent, b_vent, vent_thr, N, NB, SB, ZB, hours, \
      substeps, refresh_every, amb_bug, parity, nomass_iters, esc_after, mrt_phys, dt, half_dt, \
      gamma_dt, beta_dt, c1, c2, nomass_tol, nomass_tol_esc, stream

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
int heatx_day_march_f32(HEATX_DAY_MARCH_ARGS) { return day_march<float>(HEATX_DAY_MARCH_CALL); }
int heatx_day_march_f64(HEATX_DAY_MARCH_ARGS) { return day_march<double>(HEATX_DAY_MARCH_CALL); }

const char* heatx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif
