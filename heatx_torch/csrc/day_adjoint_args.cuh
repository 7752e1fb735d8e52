// What both day adjoints share (the TR-BDF2 body in day_adjoint_tr.cu and
// day_tr_adj.cuh, the parity body in day_adjoint_parity.cu and
// day_parity_adj.cuh): the launch arguments,
// which the C entry (day_adjoint.cu) fills once and hands to the unit that
// runs the launch's kind, the surface parameters' cotangents, and the
// reverse of the zone-air updates (day_common.cuh zone_update and
// zone_update_ctl).
#pragma once

#include <type_traits>

#include "day_common.cuh"

namespace heatx {

template <typename T>
struct AdjArgs {
  DayArgs<T> in;
  const T* dT;         // [N, SP] cotangent of the day's final T
  const T* d_zT;       // [NB, ZB] cotangent of the final zone T
  const T* d_zt_hist;  // [hours, NB, ZB] cotangent of the zone history
  T* T_ws;             // [hours, N, SP] workspace: hour-start node T
  T* zT_ws;            // [hours, NB, ZB] workspace: hour-start zone T
  T* dT0;              // [N, SP]
  T* d_zT0;            // [NB, ZB]
  T* d_node;           // [4, N, SP]: seg_u, mass (0 off massive nodes), FA, FB
  T* d_surf;           // [13, SP]: SURF_FIELDS order, normal rows 0
  T* d_zv;             // [NB, ZB]
  T* d_chan;           // [4, hours, SP]: sol_f, sol_b, ir_f, ir_b
  T* d_a;              // [hours, NB, ZB]
  T* d_b;              // [hours, NB, ZB]
  // Thermostats (null without): the load history's cotangent in; out the
  // setpoint rows' cotangents, and the schedule rows' where scheduled.
  const T* d_ld_hist;  // [hours, NB, ZB]
  T* d_ctl;            // [4, NB, ZB]; rows 0 (heat_sp) and 1 (cool_sp) written
  T* d_sp_heat;        // [hours, NB, ZB]
  T* d_sp_cool;
  // Workspace, an hour's tape: TR-BDF2 [2 substeps + 1, kMaxNodes, SP] (each
  // thread's rows of T at every sub-step start (and the hour's end), then of
  // each sub-step's stage-1 state T1), parity [substeps, kMaxNodes, SP] (each
  // thread's rows at every sub-step start); then [NB] blocks' hour zone rows
  // and weather, read by the 1024-thread variants (day_adjoint_tr.cu
  // hour_zone_rows, day_adjoint_parity.cu parity_hour_rows)
  T* tape;
};

// The kMrt instantiations' arguments: the network's operands and their
// cotangents beside the others' (whose layout stays as it was).
template <typename T>
struct MrtAdjArgs : AdjArgs<T> {
  MrtArgs<T> net;
  T* d_mrt;  // [2, SP] cotangents of the faces' effective emissivities
};
template <typename T, bool kMrt>
using AdjArgsOf = std::conditional_t<kMrt, MrtAdjArgs<T>, AdjArgs<T>>;

// Cotangents of the lane's surface parameters (SURF_FIELDS rows 0-10).
template <typename T>
struct SurfGrad {
  T v[SF_NX];
};

// Adjoint of zone_update: lz (cotangent of the new zone T) pulled back to
// a_z, b_z, the old zone T and the zone volume.
template <typename T>
__device__ void zone_update_adj(T zt, T az, T bz, T volume, T dt, T lz, T& laz, T& lbz, T& lzt,
                                T& lvol) {
  if (!(m_abs(bz) > T(1e-9))) {
    laz = lbz = lvol = T(0);
    lzt = lz;
    return;
  }
  const T t_k = zt + T(kKelvin);
  const T rho = T(kRhoNum) / (T(kGasR) * t_k);
  const T cp = T(kAirCp0) + T(kAirCp1) * t_k;
  const T c_z = volume * rho * cp;
  const T x = bz * dt / c_z;
  const T em = m_expm1(-x);
  const T ratio = az / bz;
  laz = -lz * em / bz;
  const T l_x = lz * (ratio - zt) * (em + T(1));
  lbz = lz * (ratio / bz) * em + l_x * dt / c_z;
  const T l_cz = -l_x * x / c_z;
  lzt = lz * (T(1) + em) + l_cz * volume * rho * (T(kAirCp1) - cp / t_k);
  lvol = l_cz * rho * cp;
}

// Adjoint of zone_update_ctl: lz (cotangent of the new zone T) and lload
// (cotangent of this sub-step's load) pulled back to a_z, b_z, the old zone T,
// the zone volume and the active setpoint (l_heat or l_cool; the other is 0).
template <typename T>
__device__ void zone_update_ctl_adj(T zt, T az, T bz, T volume, T dt, const Setpoints<T>& sp, T lz,
                                    T lload, T& laz, T& lbz, T& lzt, T& lvol, T& l_heat,
                                    T& l_cool) {
  l_heat = l_cool = T(0);
  if (m_abs(bz) <= T(1e-9)) {
    laz = lbz = lvol = T(0);
    lzt = lz;
    return;
  }
  const T t_k = zt + T(kKelvin);
  const T rho = T(kRhoNum) / (T(kGasR) * t_k);
  const T cp = T(kAirCp0) + T(kAirCp1) * t_k;
  const T c_z = volume * rho * cp;
  const T x = bz * dt / c_z;
  const T em = m_expm1(-x);
  const T t_free = zt - (az / bz - zt) * em;
  const bool heat = t_free < sp.heat;
  const bool cool = !heat && t_free > sp.cool;
  T load = T(0), t_set = T(0);
  bool live = false;  // the clamp passes the cotangent (autograd: lo <= x <= hi)
  if (heat || cool) {
    t_set = heat ? sp.heat : sp.cool;
    const T lo = heat ? T(0) : -sp.max_cool, hi = heat ? sp.max_heat : T(0);
    const T xr = landing_power(zt, az, bz, em, t_set);
    load = m_min(m_max(xr, lo), hi);
    live = xr >= lo && xr <= hi;
  }
  if (load == T(0)) {  // the free-float value was returned
    zone_update_adj(zt, az, bz, volume, dt, lz, laz, lbz, lzt, lvol);
    return;
  }
  zone_update_adj(zt, az + load, bz, volume, dt, lz, laz, lbz, lzt, lvol);
  if (!live) return;  // a clamped load is a constant
  const T lx = lload + laz;  // the load enters its own history and a_z + load
  // load = b u / em - a, u = zT (1 + em) - t_set.
  const T u = zt * (T(1) + em) - t_set;
  const T l_u = lx * bz / em;
  laz -= lx;
  lbz += lx * u / em;
  lzt += l_u * (T(1) + em);
  const T l_em = l_u * zt - lx * bz * u / (em * em);
  // em = expm1(-x), x = b dt / c_z, c_z = V rho(zT) cp(zT).
  const T l_x = -l_em * (em + T(1));
  lbz += l_x * dt / c_z;
  const T l_cz = -l_x * x / c_z;
  lzt += l_cz * volume * rho * (T(kAirCp1) - cp / t_k);
  lvol += l_cz * rho * cp;
  if (heat)
    l_heat = -l_u;
  else
    l_cool = -l_u;
}

}  // namespace heatx
