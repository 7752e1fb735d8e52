// Adjoint (reverse sweep) of the TR-BDF2 day march for NVIDIA Hopper
// (sm_90a), bound through a plain C interface (ctypes; see
// heatx_torch/ops/day_adjoint.py).
//
// Replaces heatx/ops/pallas_adjoint.py::make_day_adjoint -> `kernel` (the
// pl.pallas_call at pallas_adjoint.py:717) in modes trbdf2 / trbdf2_refresh
// for buildings without gas cavities.  Given the cotangents of a day's final
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
// such thing, so every primitive's adjoint is written here by hand, as the
// transpose of the device function in day_common.cuh that the forward uses:
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
//    forward uses.  Per-lane cotangents stay in the lane's thread and
//    per-zone ones in one thread per zone: no float atomics, deterministic;
//  * the two stage solves: transposed tridiagonal solves on the same Thomas
//    factors (M = L U, so M^T y = g is U^T then L^T), and the band cotangent
//    -lambda x^T of both stages and every sub-step of a refresh group,
//    chained through the stage matrix, K and the forcing, then the
//    linearized radiation and the TARP/forced film coefficients (with
//    autograd's subgradients: |x|' = sign(x), 0 at 0; clamp and where pass
//    or stop the cotangent as their forward branch does), to the
//    parameters, the IR channels and the group-start state.
//
// What bounds it: like the forward, per-thread serial latency.  It re-marches
// the day (to store each hour's start state), re-marches each hour again
// with a tape, and sweeps it backwards: about 3x the forward's sub-step
// chain, plus the transposed sweeps.
//
// Design:
//  * One CTA per zone-closed block, one thread per surface lane, as the
//    forward kernel.
//  * Pass 1 marches the day, writing each hour's start state to a workspace
//    the wrapper allocates ([hours, N, SP] and [hours, NB, ZB]; the kernel
//    allocates nothing).
//  * Pass 2 walks the hours backwards.  Per hour it reloads the start state,
//    re-marches the hour keeping a per-thread tape of T at every sub-step
//    boundary and the stage-1 result T1 of every sub-step ((substeps + 1) *
//    N <= kTape values each; the zone temperatures and a_z/b_z per sub-step
//    go to shared memory), then sweeps the refresh groups backwards: it
//    rebuilds the group's operators from the tape, reverses each sub-step,
//    and at the group start pulls the accumulated operator cotangents back
//    through the operator build.
//  * Parameter cotangents accumulate per thread in the working type over the
//    whole day and are written once.

#include "day_common.cuh"

namespace {

using namespace heatx;

constexpr int kTape = 384;  // day_adjoint.MAX_TAPE

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
};

// Cotangents of one refresh group's operators.
template <typename T>
struct OpsGrad {
  T hf, hb, radf, radb, rad_ft, rad_bt;
};

// Cotangents of the lane's surface parameters (SURF_FIELDS rows 0-10).
template <typename T>
struct SurfGrad {
  T v[SF_NX];
};

// Solve M^T y = g with the Thomas factors of the stage matrix M = L U
// (L lower bidiagonal: diagonal 1/inv, sub-diagonal the stage matrix's lower
// band; U unit upper: super-diagonal cs).
template <typename T>
__device__ void solve_transposed(const Lane<T>& L, T a_dt, const T* cs, const T* inv,
                                 const T* g, T* y) {
  const int N = L.N;
  y[0] = g[0];
  for (int i = 1; i < N; ++i) y[i] = g[i] - cs[i - 1] * y[i - 1];
  y[N - 1] *= inv[N - 1];
  for (int i = N - 2; i >= 0; --i) y[i] = (y[i] - m_lower(L, i + 1, a_dt) * y[i + 1]) * inv[i];
}

// The band cotangent -lr x^T of one stage solve x = M^{-1} r, mapped through
// M = C - (gamma dt/2) K onto the capacity and K's band.
template <typename T>
__device__ void band_adj(const Lane<T>& L, T a_dt, const T* lr, const T* x, T* gKl, T* gKd,
                         T* gKu, T* dCap) {
  for (int n = 0; n < L.N; ++n) {
    if (!L.valid(n)) continue;
    const T l = a_dt * lr[n];
    gKd[n] += l * x[n];
    dCap[n] -= lr[n] * x[n];
    if (L.left(n)) gKl[n] += l * x[n - 1];
    if (L.right(n)) gKu[n] += l * x[n + 1];
  }
}

// Adjoint of natural_h: the cotangent lh of h pulled back to the air and
// surface temperatures and the two TARP branch coefficients.
template <typename T>
__device__ void natural_h_adj(T lh, T air, T surf, T cos_eff, T c_same, T c_opp, T& l_air,
                              T& l_surf, T& l_same, T& l_opp) {
  const T dT = air - surf;
  const T adt = m_abs(dT);
  const T x = m_max(adt, T(1e-30));
  const T cb = m_pow(x, T(1.0 / 3.0));
  const bool near_zero = (adt < T(1e-3)) || (m_abs(cos_eff) < T(1e-3));
  const bool same = dT * cos_eff > T(0);
  const T coef = near_zero ? T(1.31) : (same ? c_same : c_opp);
  const T lp = coef * cb >= T(kMinH) ? lh : T(0);  // the floor stops it below MIN_H
  if (!near_zero) {
    if (same)
      l_same += lp * cb;
    else
      l_opp += lp * cb;
  }
  const T lx = lp * coef * T(1.0 / 3.0) * m_pow(x, T(-2.0 / 3.0));
  const T ldT = (adt >= T(1e-30) ? lx : T(0)) * m_sign(dT);
  l_air += ldT;
  l_surf -= ldT;
}

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

template <typename T, bool kExt>
__global__ void __launch_bounds__(kMaxLanes) day_adjoint_kernel(const AdjArgs<T> g) {
  const DayArgs<T>& a = g.in;
  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB;
  const int sub = a.substeps, k = a.refresh_every;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int SP = NB * SB;
  const int lane = b * SB + tid;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_zT = reinterpret_cast<T*>(smem_raw);  // [ZB] marching zone T
  T* s_zt = s_zT + ZB;                       // [(sub+1)*ZB] zone T at each sub-step start
  T* s_az = s_zt + (sub + 1) * ZB;           // [sub*ZB] a_z of each sub-step
  T* s_bz = s_az + sub * ZB;                 // [sub*ZB] b_z of each sub-step
  T* s_lz = s_bz + sub * ZB;                 // [ZB] zone-T cotangent
  T* s_laz = s_lz + ZB;                      // [ZB] a_z cotangent
  T* s_lbz = s_laz + ZB;                     // [ZB] b_z cotangent
  T* s_dV = s_lbz + ZB;                      // [ZB] zone-volume cotangent (day)
  T* s_da = s_dV + ZB;                       // [ZB] a_extra cotangent (hour)
  T* s_db = s_da + ZB;                       // [ZB] b_extra cotangent (hour)
  T* s_haT = s_db + ZB;                      // [2*SB] h*A*T_s per face
  T* s_ha = s_haT + 2 * SB;                  // [2*SB] h*A per face
  T* s_lt = s_ha + 2 * SB;                   // [2*SB] boundary-T cotangent per face
  T* s_lld = s_lt + 2 * SB;                  // kExt: [ZB] cotangent of each sub-step's load (hour)
  T* s_dsh = s_lld + ZB;                     // kExt: [ZB] heating-setpoint cotangent (hour or day)
  T* s_dsc = s_dsh + ZB;                     // kExt: [ZB] cooling-setpoint cotangent

  const Lane<T> L(a, lane);
  const Scheme<T> sc(a);
  T Tt[kTape], T1t[kTape];  // the hour's tape: T at sub-step starts (+ end), T1
  T cs[kMaxNodes], inv[kMaxNodes];

  // March hour h from (Tt[0:N], s_zT), writing the tape.
  auto march_hour = [&](int h) {
    const HourIn<T> hi(a, h, lane);
    const T* a_ex = a.a_extra + (size_t)h * NB * ZB + b * ZB;
    const T* b_ex = a.b_extra + (size_t)h * NB * ZB + b * ZB;
    for (int i0 = 0; i0 < sub; i0 += k) {
      const int w = h * sub + i0;
      T t_front, t_back;
      L.boundary(s_zT, a.t_out[w], t_front, t_back);
      const Ops<T> o = build_ops(L, Tt + i0 * N, t_front, t_back, a.wind[w], a.wdir[w], hi,
                                 a.amb_bug, sc.a_dt, cs, inv);
      for (int i = i0; i < i0 + k; ++i) {
        T* Tn = Tt + (i + 1) * N;
        for (int n = 0; n < N; ++n) Tn[n] = Tt[i * N + n];
        for (int z = tid; z < ZB; z += SB) s_zt[i * ZB + z] = s_zT[z];
        L.boundary(s_zT, a.t_out[h * sub + i], t_front, t_back);
        march_substep(L, o, cs, inv, hi, t_front, t_back, sc, Tn, T1t + i * N);
        const T ts_front = Tn[0];
        const T ts_back = L.last_node(Tn);
        const T haf = o.hf * L.area, hab = o.hb * L.area;
        s_haT[2 * tid] = haf * ts_front;
        s_ha[2 * tid] = haf;
        s_haT[2 * tid + 1] = hab * ts_back;
        s_ha[2 * tid + 1] = hab;
        __syncthreads();
        for (int z = tid; z < ZB; z += SB) {
          const int gz = b * ZB + z;
          T az, bz;
          zone_sums(a.zone_ptr, a.zone_faces, gz, s_haT, s_ha, a_ex[z], b_ex[z], az, bz);
          // Mixing reads the sub-step-start row s_zt[i], which no thread
          // writes here, so s_zT updates in place.
          if (kExt && a.mix_ptr) mix_sums(a, gz, s_zt + i * ZB, az, bz);
          s_az[i * ZB + z] = az;
          s_bz[i * ZB + z] = bz;
          if (kExt && a.ctl) {
            T load;
            s_zT[z] = zone_update_ctl(s_zT[z], az, bz, a.zone_volume[gz], sc.dt,
                                      Setpoints<T>(a, h, gz), load);
          } else {
            s_zT[z] = zone_update(s_zT[z], az, bz, a.zone_volume[gz], sc.dt);
          }
        }
        __syncthreads();
      }
    }
  };

  // ---- pass 1: march the day, storing each hour's start state -------------
  for (int n = 0; n < N; ++n) Tt[n] = a.T0[n * SP + lane];
  for (int z = tid; z < ZB; z += SB) s_zT[z] = a.zT0[b * ZB + z];
  __syncthreads();
  for (int h = 0; h < a.hours; ++h) {
    for (int n = 0; n < N; ++n) g.T_ws[((size_t)h * N + n) * SP + lane] = Tt[n];
    for (int z = tid; z < ZB; z += SB) g.zT_ws[(size_t)h * NB * ZB + b * ZB + z] = s_zT[z];
    march_hour(h);
    for (int n = 0; n < N; ++n) Tt[n] = Tt[sub * N + n];
  }

  // ---- pass 2: the hours backwards ----------------------------------------
  T lT[kMaxNodes], lr[kMaxNodes], lA[kMaxNodes], lq[kMaxNodes], lT1[kMaxNodes];
  T gKl[kMaxNodes], gKd[kMaxNodes], gKu[kMaxNodes];
  T dU[kMaxNodes], dCap[kMaxNodes], dFA[kMaxNodes], dFB[kMaxNodes];
  SurfGrad<T> sg;
  for (int f = 0; f < SF_NX; ++f) sg.v[f] = T(0);
  for (int n = 0; n < N; ++n) {
    lT[n] = g.dT[n * SP + lane];
    dU[n] = dCap[n] = dFA[n] = dFB[n] = T(0);
  }
  for (int z = tid; z < ZB; z += SB) {
    s_lz[z] = g.d_zT[b * ZB + z];
    s_dV[z] = T(0);
    if (kExt) s_dsh[z] = s_dsc[z] = T(0);
  }

  for (int h = a.hours - 1; h >= 0; --h) {
    for (int n = 0; n < N; ++n) Tt[n] = g.T_ws[((size_t)h * N + n) * SP + lane];
    for (int z = tid; z < ZB; z += SB) {
      s_zT[z] = g.zT_ws[(size_t)h * NB * ZB + b * ZB + z];
      s_lz[z] += g.d_zt_hist[(size_t)h * NB * ZB + b * ZB + z];
      s_da[z] = s_db[z] = T(0);
      // The hour's load is the mean over its sub-steps.
      if (kExt && a.ctl)
        s_lld[z] = g.d_ld_hist[(size_t)h * NB * ZB + b * ZB + z] / T(sub);
    }
    __syncthreads();
    march_hour(h);

    const HourIn<T> hi(a, h, lane);
    T l_sol_f = T(0), l_sol_b = T(0), l_rad_out_f = T(0), l_rad_out_b = T(0);
    for (int i0 = ((sub - 1) / k) * k; i0 >= 0; i0 -= k) {
      const int w = h * sub + i0;
      const T* Tg = Tt + i0 * N;
      T tf0, tb0;
      L.boundary(s_zt + i0 * ZB, a.t_out[w], tf0, tb0);
      const T ws = a.wind[w], wd = a.wdir[w];
      const Ops<T> o = build_ops(L, Tg, tf0, tb0, ws, wd, hi, a.amb_bug, sc.a_dt, cs, inv);
      OpsGrad<T> og{T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int n = 0; n < N; ++n) gKl[n] = gKd[n] = gKu[n] = T(0);

      for (int i = i0 + k - 1; i >= i0; --i) {
        // (a) zone update, one thread per zone.
        for (int z = tid; z < ZB; z += SB) {
          const int gz = b * ZB + z;
          T laz, lbz, lzt, lvol;
          if (kExt && a.ctl) {
            T l_heat, l_cool;
            zone_update_ctl_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z],
                                a.zone_volume[gz], sc.dt, Setpoints<T>(a, h, gz), s_lz[z],
                                s_lld[z], laz, lbz, lzt, lvol, l_heat, l_cool);
            s_dsh[z] += l_heat;
            s_dsc[z] += l_cool;
          } else {
            zone_update_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z],
                            a.zone_volume[gz], sc.dt, s_lz[z], laz, lbz, lzt, lvol);
          }
          s_laz[z] = laz;
          s_lbz[z] = lbz;
          s_lz[z] = lzt;
          s_dV[z] += lvol;
          s_da[z] += laz;
          s_db[z] += lbz;
        }
        __syncthreads();

        // (b) the lane's sub-step, backwards.
        const T* Ts = Tt + i * N;
        const T* Tnew = Tt + (i + 1) * N;
        const T* T1s = T1t + i * N;
        T tf, tb;
        L.boundary(s_zt + i * ZB, a.t_out[h * sub + i], tf, tb);
        // Zone sums: a_z += h A T_s, b_z += h A.
        if (L.zone_f >= 0) {
          const T la = s_laz[L.zone_f], lb = s_lbz[L.zone_f];
          lT[0] += la * (o.hf * L.area);
          const T lha = la * Tnew[0] + lb;
          og.hf += lha * L.area;
          sg.v[SF_AREA] += lha * o.hf;
        }
        if (L.zone_b >= 0) {
          const T la = s_laz[L.zone_b], lb = s_lbz[L.zone_b];
          const T hab = o.hb * L.area;
          for (int n = 0; n < N; ++n)
            if (L.last(n)) lT[n] += la * hab;
          const T lha = la * L.last_node(Tnew) + lb;
          og.hb += lha * L.area;
          sg.v[SF_AREA] += lha * o.hb;
        }
        // Stage 2: Tnew = M^{-1} (c1 C T1 - c2 C T + beta dt q).
        solve_transposed(L, sc.a_dt, cs, inv, lT, lr);
        band_adj(L, sc.a_dt, lr, Tnew, gKl, gKd, gKu, dCap);
        for (int n = 0; n < N; ++n) {
          if (L.valid(n)) {
            const T cap = L.Cap[n * SP];
            lT1[n] = sc.c1 * cap * lr[n];
            lA[n] = -sc.c2 * cap * lr[n];
            dCap[n] += lr[n] * (sc.c1 * T1s[n] - sc.c2 * Ts[n]);
            lq[n] = sc.b_dt * lr[n];
          } else {
            lT1[n] = T(0);
            lA[n] = lr[n];
            lq[n] = T(0);
          }
        }
        // Stage 1: T1 = M^{-1} (C T + (gamma dt/2) K T + gamma dt q).
        solve_transposed(L, sc.a_dt, cs, inv, lT1, lr);
        band_adj(L, sc.a_dt, lr, T1s, gKl, gKd, gKu, dCap);
        for (int n = 0; n < N; ++n) {
          if (!L.valid(n)) {
            lA[n] += lr[n];
            continue;
          }
          const T lk = sc.a_dt * lr[n];
          T kl, kd, ku;
          k_row(L, o, n, kl, kd, ku);
          lA[n] += L.Cap[n * SP] * lr[n] + kd * lk;
          if (n > 0) lA[n - 1] += kl * lk;
          if (n + 1 < N) lA[n + 1] += ku * lk;
          dCap[n] += lr[n] * Ts[n];
          lq[n] += sc.g_dt * lr[n];
          gKd[n] += lk * Ts[n];
          if (L.left(n)) gKl[n] += lk * Ts[n - 1];
          if (L.right(n)) gKu[n] += lk * Ts[n + 1];
        }
        // Forcing q: absorbed solar and the faces' sources.
        T lt_f = T(0), lt_b = T(0);
        for (int n = 0; n < N; ++n) {
          if (!L.valid(n)) continue;
          const T l = lq[n];
          dFA[n] += l * hi.sol_f;
          dFB[n] += l * hi.sol_b;
          l_sol_f += l * L.FA[n * SP];
          l_sol_b += l * L.FB[n * SP];
          if (L.first(n)) {
            lt_f += l * o.hf;
            og.hf += l * tf;
            og.radf += l * o.rad_ft;
            og.rad_ft += l * o.radf;
          }
          if (L.last(n)) {
            lt_b += l * o.hb;
            og.hb += l * tb;
            og.radb += l * o.rad_bt;
            og.rad_bt += l * o.radb;
          }
        }
        for (int n = 0; n < N; ++n) lT[n] = lA[n];

        if (i == i0) {
          // ---- the group's operator build, backwards -----------------------
          // K's band -> U and the boundary coefficients.
          for (int n = 0; n < N; ++n) {
            if (!L.valid(n)) continue;
            const T gd = gKd[n];
            if (L.left(n)) dU[n - 1] += gKl[n] - gd;
            if (L.right(n)) dU[n] += gKu[n] - gd;
            if (L.first(n)) {
              og.hf -= gd;
              og.radf -= gd;
            }
            if (L.last(n)) {
              og.hb -= gd;
              og.radb -= gd;
            }
          }
          const FaceTemps<T> ft(L, Tg, tf0, tb0, hi, a.amb_bug);
          // Linearized radiation 4 eps sigma x^3, x = K + (T_rad + T_s)/2.
          const T xf = T(kKelvin) + (ft.front_rad + ft.front_surf) / T(2);
          const T xb = T(kKelvin) + (ft.back_rad + ft.back_surf_eff) / T(2);
          sg.v[SF_EPSF] += og.radf * T(4) * T(kSigma) * (xf * xf * xf);
          sg.v[SF_EPSB] += og.radb * T(4) * T(kSigma) * (xb * xb * xb);
          const T lxf = og.radf * T(12) * L.eps_f * T(kSigma) * (xf * xf);
          const T lxb = og.radb * T(12) * L.eps_b * T(kSigma) * (xb * xb);
          T l_frad = og.rad_ft + lxf / T(2), l_fs = lxf / T(2);
          T l_brad = og.rad_bt + lxb / T(2), l_bse = lxb / T(2);
          // Film coefficients: a fixed h takes the whole cotangent.
          const T lhf = is_nan(L.fix_hf) ? og.hf : T(0);
          const T lhb = is_nan(L.fix_hb) ? og.hb : T(0);
          if (!is_nan(L.fix_hf)) sg.v[SF_FIXHF] += og.hf;
          if (!is_nan(L.fix_hb)) sg.v[SF_FIXHB] += og.hb;
          // Forced part 2.537 W rf sqrt(P v / A) on outdoor faces.
          const T lbase = (L.f_out ? lhf : T(0)) + (L.b_out ? lhb : T(0));
          const T pva = L.perim * (ws * L.wmod) / L.area;
          if (pva > T(0)) {
            const T wf = L.windward(wd) ? T(1) : T(0.5);
            const T sq = m_sqrt(pva);
            sg.v[SF_RF] += lbase * T(2.537) * wf * sq;
            const T lpva = lbase * T(2.537) * wf * L.rf / (T(2) * sq);
            sg.v[SF_PERIM] += lpva * (ws * L.wmod) / L.area;
            sg.v[SF_WMOD] += lpva * L.perim * ws / L.area;
            sg.v[SF_AREA] -= lpva * pva / L.area;
          }
          // Natural part, and the TARP coefficients' dependence on |cos|.
          T l_tf = T(0), l_tb = T(0), l_same = T(0), l_opp = T(0);
          const T front_cos = L.f_out ? -L.cos_t : L.cos_t;
          natural_h_adj(lhf, tf0, ft.front_surf, front_cos, L.c_same, L.c_opp, l_tf, l_fs,
                        l_same, l_opp);
          natural_h_adj(lhb, tb0, ft.back_surf_eff, L.cos_t, L.c_same, L.c_opp, l_tb, l_bse,
                        l_same, l_opp);
          const T ac = m_abs(L.cos_t);
          sg.v[SF_COS] += (l_same * T(9.482) / ((T(7.238) - ac) * (T(7.238) - ac)) -
                           l_opp * T(1.81) / ((T(1.382) + ac) * (T(1.382) + ac))) *
                          m_sign(L.cos_t);
          // Radiant temperatures: outdoor IR, else the boundary air (the
          // ambient-back quirk reads the front's).
          if (L.f_out)
            l_rad_out_f += l_frad;
          else
            l_tf += l_frad;
          if (L.b_out)
            l_rad_out_b += l_brad;
          else if (L.b_amb && a.amb_bug)
            l_tf += l_brad;
          else
            l_tb += l_brad;
          // Surface temperatures: node 0 and the last node (the quirk again).
          T l_bs = T(0);
          if (L.b_amb && a.amb_bug)
            l_fs += l_bse;
          else
            l_bs += l_bse;
          lT[0] += l_fs;
          for (int n = 0; n < N; ++n)
            if (L.last(n)) lT[n] += l_bs;
          lt_f += l_tf;
          lt_b += l_tb;
        }

        // Boundary temperatures: zone air (summed per zone below), the fixed
        // ambient/ground temperature, or outdoor air (not differentiated).
        s_lt[2 * tid] = L.code_f == kSpace ? lt_f : T(0);
        s_lt[2 * tid + 1] = L.code_b == kSpace ? lt_b : T(0);
        if (L.code_f != kSpace && !L.f_out) sg.v[SF_TEMPF] += lt_f;
        if (L.code_b != kSpace && !L.b_out) sg.v[SF_TEMPB] += lt_b;
        __syncthreads();

        // (c) the faces' boundary cotangents into their zones.
        for (int z = tid; z < ZB; z += SB) {
          const int gz = b * ZB + z;
          s_lz[z] += face_sum(a.zone_ptr, a.zone_faces, gz, s_lt);
          if (kExt && a.mixt_ptr) {
            // The transpose of the mixing sums: this zone as a source.
            const T zs = s_zt[i * ZB + z];
            const T s0 = air_rho_cp(zs), ds0 = air_rho_cp_dt(zs);
            T lm = T(0);
            for (int e = a.mixt_ptr[gz]; e < a.mixt_ptr[gz + 1]; ++e) {
              const int to = a.mixt_dst[e];
              lm += a.mixt_vol[e] * (s_laz[to] * (s0 + zs * ds0) + s_lbz[to] * ds0);
            }
            s_lz[z] += lm;
          }
        }
        __syncthreads();
      }
    }

    // ---- end of hour: the channel and gain cotangents ----------------------
    const T sfr = a.sol_f[h * SP + lane], sbr = a.sol_b[h * SP + lane];
    const T irf = a.ir_f[h * SP + lane], irb = a.ir_b[h * SP + lane];
    T* dc = g.d_chan + (size_t)h * SP + lane;
    const size_t row = (size_t)a.hours * SP;
    dc[0] = (is_nan(sfr) || sfr < T(0)) ? T(0) : l_sol_f;
    dc[row] = is_nan(sbr) ? T(0) : l_sol_b;
    dc[2 * row] = irf >= T(1e-30)
                      ? l_rad_out_f * T(0.25) * m_pow(irf / T(kSigma), T(-0.75)) / T(kSigma)
                      : T(0);
    dc[3 * row] = irb >= T(1e-30)
                      ? l_rad_out_b * T(0.25) * m_pow(irb / T(kSigma), T(-0.75)) / T(kSigma)
                      : T(0);
    for (int z = tid; z < ZB; z += SB) {
      g.d_a[(size_t)h * NB * ZB + b * ZB + z] = s_da[z];
      g.d_b[(size_t)h * NB * ZB + b * ZB + z] = s_db[z];
      if (kExt && a.sp_heat) {  // scheduled: the hour's rows take the cotangents
        g.d_sp_heat[(size_t)h * NB * ZB + b * ZB + z] = s_dsh[z];
        g.d_sp_cool[(size_t)h * NB * ZB + b * ZB + z] = s_dsc[z];
        s_dsh[z] = s_dsc[z] = T(0);
      }
    }
  }

  // ---- outputs ------------------------------------------------------------
  for (int n = 0; n < N; ++n) {
    g.dT0[n * SP + lane] = lT[n];
    g.d_node[(ND_U * N + n) * SP + lane] = dU[n];
    g.d_node[(ND_CAP * N + n) * SP + lane] = ((L.mass_bits >> n) & 1u) ? dCap[n] : T(0);
    g.d_node[(ND_FA * N + n) * SP + lane] = dFA[n];
    g.d_node[(ND_FB * N + n) * SP + lane] = dFB[n];
  }
  for (int f = 0; f < SF_COUNT; ++f) g.d_surf[f * SP + lane] = f < SF_NX ? sg.v[f] : T(0);
  for (int z = tid; z < ZB; z += SB) {
    g.d_zT0[b * ZB + z] = s_lz[z];
    g.d_zv[b * ZB + z] = s_dV[z];
    if (kExt && a.ctl) {  // the compiled rows (0 where the march was scheduled)
      g.d_ctl[b * ZB + z] = s_dsh[z];
      g.d_ctl[NB * ZB + b * ZB + z] = s_dsc[z];
    }
  }
}

template <typename T, bool kExt>
int launch_as(const AdjArgs<T>& g, cudaStream_t stream) {
  const DayArgs<T>& a = g.in;
  const size_t smem = sizeof(T) * (static_cast<size_t>(a.ZB) * (3 * a.substeps + (kExt ? 11 : 8)) +
                                   6 * static_cast<size_t>(a.SB));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(day_adjoint_kernel<T, kExt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  day_adjoint_kernel<T, kExt><<<a.NB, a.SB, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const AdjArgs<T>& g, cudaStream_t stream) {
  const DayArgs<T>& a = g.in;
  if (a.N < 1 || a.N > kMaxNodes || a.SB < 1 || a.SB > kMaxLanes || a.NB < 1 || a.ZB < 1 ||
      a.hours < 1 || a.refresh_every < 1 || a.substeps % a.refresh_every ||
      (a.substeps + 1) * a.N > kTape)
    return static_cast<int>(cudaErrorInvalidValue);
  // Thermostat rows come with the load cotangent and the rows' output;
  // schedule rows with theirs; mixing with both groupings of its entries.
  const bool ctl = a.ctl != nullptr, sched = a.sp_heat != nullptr;
  if (ctl != (g.d_ld_hist != nullptr) || ctl != (g.d_ctl != nullptr) || (sched && !ctl) ||
      sched != (a.sp_cool != nullptr) || sched != (g.d_sp_heat != nullptr) ||
      sched != (g.d_sp_cool != nullptr) || (a.mix_ptr != nullptr) != (a.mixt_ptr != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // Free-float buildings run the instantiation without the extra zone code.
  if (ctl || a.mix_ptr) return launch_as<T, true>(g, stream);
  return launch_as<T, false>(g, stream);
}

constexpr int kPointers = 43;

template <typename T>
int day_adjoint(void* const* p, int n_ptrs, const int* ints, const double* reals, void* stream) {
  if (n_ptrs != kPointers) return static_cast<int>(cudaErrorInvalidValue);
  AdjArgs<T> g;
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
  return launch<T>(g, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Launch on `stream`.  `ptrs` holds the 43 device pointers in the order of
// DayAdjointKernel (operands, cotangents, workspace, outputs, then the
// thermostat, schedule and mixing operands and outputs, null where the
// building has none), `ints` N, NB, SB, ZB, hours, substeps, refresh_every,
// amb_bug, `reals` dt, gamma dt/2, gamma dt, beta dt, c1, c2.  Returns
// cudaGetLastError() of the launch.
int heatx_day_adjoint_f32(void* const* ptrs, int n_ptrs, const int* ints, const double* reals,
                          void* stream) {
  return day_adjoint<float>(ptrs, n_ptrs, ints, reals, stream);
}
int heatx_day_adjoint_f64(void* const* ptrs, int n_ptrs, const int* ints, const double* reals,
                          void* stream) {
  return day_adjoint<double>(ptrs, n_ptrs, ints, reals, stream);
}

const char* heatx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
