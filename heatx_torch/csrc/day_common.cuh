// Device code shared by the day march (day_march.cu) and its adjoint
// (day_adjoint.cu), in TR-BDF2 and (with day_parity.cuh) reference-parity
// mode: the packed-operand layout, one surface lane's statics,
// the operator build (film coefficients, linearized radiation, the stage
// matrix and its Thomas factors), one TR-BDF2 sub-step of a lane's node
// column, the zone sums, the inter-zone mixing sums, the exact exponential
// zone update and its setpoint-landing (thermostat) form.  Both kernels march
// with these functions, so the adjoint's recompute is the forward's
// arithmetic.  The layout follows heatx_torch/ops/day_march.py (NODE_FIELDS,
// SURF_FIELDS, LANE_FIELDS).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace heatx {

constexpr int kMaxNodes = 32;
constexpr int kMaxLanes = 256;

// Boundary codes (heatx_torch/build/layout.py).
constexpr int kOutdoor = 0;
constexpr int kSpace = 1;
constexpr int kAmbient = 2;

// Row order of the packed operands.
enum { ND_U, ND_CAP, ND_FA, ND_FB, ND_COUNT };
enum {
  SF_AREA, SF_PERIM, SF_COS, SF_WMOD, SF_EPSF, SF_EPSB, SF_RF, SF_TEMPF,
  SF_TEMPB, SF_FIXHF, SF_FIXHB, SF_NX, SF_NY, SF_COUNT
};
enum { LN_FCODE, LN_BCODE, LN_FZONE, LN_BZONE, LN_BITS, LN_MASS };

constexpr double kKelvin = 273.15;
constexpr double kSigma = 5.670374419e-8;
constexpr double kMinH = 0.1;
// Air (heatx_torch/physics/gas.py): rho = 101325 M / (R T), cp = cp0 + cp1 T.
constexpr double kRhoNum = 101325.0 * 28.97;
constexpr double kGasR = 8314.46261815324;
constexpr double kAirCp0 = 1002.7370;
constexpr double kAirCp1 = 1.2324e-2;

// Math in the working precision: explicit float/double overloads, so a float
// kernel never widens to double by accident.
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_max(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double m_max(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float m_min(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double m_min(double x, double y) { return fmin(x, y); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double m_expm1(double x) { return expm1(x); }
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool is_finite(double x) { return fabs(x) <= DBL_MAX; }
template <typename T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }
// sign(x) with sign(0) = 0: the derivative of |x| that autograd uses.
template <typename T>
__device__ __forceinline__ T m_sign(T x) { return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0)); }

// The operands of one day march (both kernels read these).
template <typename T>
struct DayArgs {
  const T* node;         // [4, N, SP]
  const T* surf;         // [13, SP]
  const int* lane;       // [6, SP]
  const T* zone_volume;  // [NB, ZB]
  const int* zone_ptr;   // [NB*ZB + 1]
  const int* zone_faces; // [E]: block-local lane*2 + side
  const T* t_out;        // [hours*substeps]
  const T* wind;
  const T* wdir;
  const T* sol_f;        // [hours, SP]
  const T* sol_b;
  const T* ir_f;
  const T* ir_b;
  const T* a_extra;      // [hours, NB, ZB]
  const T* b_extra;
  const T* T0;           // [N, SP]
  const T* zT0;          // [NB, ZB]
  // Thermostats, setpoint schedules and inter-zone mixing: null where the
  // building has none (the free-float instantiation never reads them).
  const T* ctl;          // [4, NB, ZB]: heat_sp, cool_sp, max_heat, max_cool
  const T* sp_heat;      // [hours, NB, ZB] per-hour setpoints (override ctl's)
  const T* sp_cool;
  const int* mix_ptr;    // [NB*ZB + 1] mixing entries by destination zone slot
  const int* mix_src;    // [M] block-local source zone
  const T* mix_vol;      // [M] flow, m3/s
  const int* mixt_ptr;   // the same entries by source zone slot (the transpose)
  const int* mixt_dst;   // [M] block-local destination zone
  const T* mixt_vol;
  int N, NB, SB, ZB, hours, substeps, refresh_every, amb_bug;
  double dt, half_dt, gamma_dt, beta_dt, c1, c2;
  // The reference-parity march (day_parity.cuh): whether it runs instead of
  // TR-BDF2, and its no-mass iteration count, escalation and tolerances.
  int parity, nomass_iters, esc_after;
  double nomass_tol, nomass_tol_esc;
};

// TR-BDF2 scheme constants in the working precision.
template <typename T>
struct Scheme {
  T dt, a_dt, g_dt, b_dt, c1, c2;
  __device__ explicit Scheme(const DayArgs<T>& a)
      : dt(T(a.dt)), a_dt(T(a.half_dt)), g_dt(T(a.gamma_dt)), b_dt(T(a.beta_dt)),
        c1(T(a.c1)), c2(T(a.c2)) {}
};

// The statics of one surface lane.
template <typename T>
struct Lane {
  T area, perim, cos_t, wmod, eps_f, eps_b, rf, temp_f, temp_b, fix_hf, fix_hb, nx, ny;
  T c_same, c_opp;  // TARP branch coefficients (|cos| is tilt-flip invariant)
  int code_f, code_b, zone_f, zone_b, N, SP;
  unsigned bits, mass_bits;
  bool f_out, b_out, b_amb;
  const T* U;  // node rows, stride SP
  const T* Cap;
  const T* FA;
  const T* FB;

  __device__ Lane(const DayArgs<T>& a, int lane) : N(a.N), SP(a.NB * a.SB) {
    const T* sf = a.surf + lane;
    area = sf[SF_AREA * SP];
    perim = sf[SF_PERIM * SP];
    cos_t = sf[SF_COS * SP];
    wmod = sf[SF_WMOD * SP];
    eps_f = sf[SF_EPSF * SP];
    eps_b = sf[SF_EPSB * SP];
    rf = sf[SF_RF * SP];
    temp_f = sf[SF_TEMPF * SP];
    temp_b = sf[SF_TEMPB * SP];
    fix_hf = sf[SF_FIXHF * SP];
    fix_hb = sf[SF_FIXHB * SP];
    nx = sf[SF_NX * SP];
    ny = sf[SF_NY * SP];
    code_f = a.lane[LN_FCODE * SP + lane];
    code_b = a.lane[LN_BCODE * SP + lane];
    zone_f = a.lane[LN_FZONE * SP + lane];
    zone_b = a.lane[LN_BZONE * SP + lane];
    bits = static_cast<unsigned>(a.lane[LN_BITS * SP + lane]);
    mass_bits = static_cast<unsigned>(a.lane[LN_MASS * SP + lane]);
    f_out = code_f == kOutdoor;
    b_out = code_b == kOutdoor;
    b_amb = code_b == kAmbient;
    c_same = T(9.482) / (T(7.238) - m_abs(cos_t));
    c_opp = T(1.81) / (T(1.382) + m_abs(cos_t));
    U = a.node + (ND_U * N) * SP + lane;
    Cap = a.node + (ND_CAP * N) * SP + lane;
    FA = a.node + (ND_FA * N) * SP + lane;
    FB = a.node + (ND_FB * N) * SP + lane;
  }

  __device__ bool valid(int i) const { return i >= 0 && i < N && ((bits >> i) & 1u); }
  __device__ bool left(int i) const { return valid(i) && valid(i - 1); }
  __device__ bool right(int i) const { return valid(i) && valid(i + 1); }
  __device__ bool first(int i) const { return valid(i) && !valid(i - 1); }
  __device__ bool last(int i) const { return valid(i) && !valid(i + 1); }
  // K's off-diagonals of row i (U of the segments to the row's neighbours).
  __device__ T kl(int i) const { return left(i) ? U[(i - 1) * SP] : T(0); }
  __device__ T ku(int i) const { return right(i) ? U[i * SP] : T(0); }

  // The masked sum of x over the last valid nodes (engine.surface._last_node).
  __device__ T last_node(const T* x) const {
    T s = T(0);
    for (int i = 0; i < N; ++i)
      if (last(i)) s += x[i];
    return s;
  }

  // Boundary air temperatures: outdoor air, the face's zone air (zT is the
  // block's zone row), or the fixed ambient/ground temperature.
  __device__ void boundary(const T* zT, T t_out, T& t_front, T& t_back) const {
    const T zf = zone_f >= 0 ? zT[zone_f] : T(0);
    const T zb = zone_b >= 0 ? zT[zone_b] : T(0);
    t_front = f_out ? t_out : (code_f == kSpace ? zf : temp_f);
    t_back = b_out ? t_out : (code_b == kSpace ? zb : temp_b);
  }

  __device__ bool windward(T wd) const {
    return m_abs(cos_t) >= T(0.98) || (nx * m_sin(wd) + ny * m_cos(wd) > T(0));
  }
};

// The hour's per-lane forcing: clamped solar irradiance and the outdoor
// radiant temperatures from the incident IR.
template <typename T>
struct HourIn {
  T sol_f, sol_b, rad_out_f, rad_out_b;
  __device__ HourIn(const DayArgs<T>& a, int h, int lane) {
    const int SP = a.NB * a.SB;
    const T sfr = a.sol_f[h * SP + lane], sbr = a.sol_b[h * SP + lane];
    sol_f = (is_nan(sfr) || sfr < T(0)) ? T(0) : sfr;
    sol_b = is_nan(sbr) ? T(0) : sbr;
    rad_out_f = m_pow(m_max(a.ir_f[h * SP + lane], T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
    rad_out_b = m_pow(m_max(a.ir_b[h * SP + lane], T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
  }
};

// TARP natural convection (convection.rs:87-110) with hoisted branch
// coefficients; cube root as pow(max(|dT|, 1e-30), 1/3), as in heatx's kernel.
template <typename T>
__device__ __forceinline__ T natural_h(T air, T surf, T cos_eff, T c_same, T c_opp) {
  const T dT = air - surf;
  const T adt = m_abs(dT);
  const T cbrt_dt = m_pow(m_max(adt, T(1e-30)), T(1.0 / 3.0));
  const bool near_zero = (adt < T(1e-3)) || (m_abs(cos_eff) < T(1e-3));
  const T coef = near_zero ? T(1.31) : (dT * cos_eff > T(0) ? c_same : c_opp);
  return m_max(coef * cbrt_dt, T(kMinH));
}

// The operators of one refresh group, frozen over its sub-steps.
template <typename T>
struct Ops {
  T hf, hb;          // film coefficients
  T radf, radb;      // linearized radiation coefficients
  T rad_ft, rad_bt;  // radiant temperatures
};

// The faces' radiant and surface temperatures (border_conditions with the
// ambient-back quirk): shared by the operator build and its adjoint.
template <typename T>
struct FaceTemps {
  T front_surf, back_surf, front_rad, back_rad, back_surf_eff;
  __device__ FaceTemps(const Lane<T>& L, const T* Tn, T t_front, T t_back,
                       const HourIn<T>& hi, int amb_bug) {
    front_surf = Tn[0];
    back_surf = L.last_node(Tn);
    front_rad = L.f_out ? hi.rad_out_f : t_front;
    const T amb_rad = amb_bug ? t_front : t_back;
    const T amb_surf = amb_bug ? front_surf : back_surf;
    back_rad = L.b_out ? hi.rad_out_b : (L.b_amb ? amb_rad : t_back);
    back_surf_eff = L.b_amb ? amb_surf : back_surf;
  }
};

// The forced-convection base term 2.537 W rf sqrt(P v / A) (zero at rest).
template <typename T>
__device__ __forceinline__ T forced_base(const Lane<T>& L, T ws, T wd) {
  const T pva = L.perim * (ws * L.wmod) / L.area;
  return T(2.537) * (L.windward(wd) ? T(1) : T(0.5)) * L.rf * (pva > T(0) ? m_sqrt(pva) : T(0));
}

// Row i of K (kl, kd, ku) with the group's film and radiation coefficients.
template <typename T>
__device__ __forceinline__ void k_row(const Lane<T>& L, const Ops<T>& o, int i, T& kl, T& kd, T& ku) {
  kl = L.kl(i);
  ku = L.ku(i);
  kd = -(kl + ku + (L.first(i) ? o.hf + o.radf : T(0)) + (L.last(i) ? o.hb + o.radb : T(0)));
}

// Stage matrix lower diagonal of row i: -(gamma dt/2) kl (0 on padded rows).
template <typename T>
__device__ __forceinline__ T m_lower(const Lane<T>& L, int i, T a_dt) {
  return L.valid(i) ? -a_dt * L.kl(i) : T(0);
}

// Operators from the marching state (implicit.build_operators): film
// coefficients, linearized radiation, and the Thomas factors (cs, inv) of the
// stage matrix C - (gamma dt/2) K, identity rows on padded nodes.
template <typename T>
__device__ Ops<T> build_ops(const Lane<T>& L, const T* Tn, T t_front, T t_back, T ws, T wd,
                            const HourIn<T>& hi, int amb_bug, T a_dt, T* cs, T* inv) {
  Ops<T> o;
  const FaceTemps<T> ft(L, Tn, t_front, t_back, hi, amb_bug);
  const T front_cos = L.f_out ? -L.cos_t : L.cos_t;
  const T base = forced_base(L, ws, wd);
  o.hf = natural_h(t_front, ft.front_surf, front_cos, L.c_same, L.c_opp) + (L.f_out ? base : T(0));
  o.hb = natural_h(t_back, ft.back_surf_eff, L.cos_t, L.c_same, L.c_opp) + (L.b_out ? base : T(0));
  if (!is_nan(L.fix_hf)) o.hf = L.fix_hf;
  if (!is_nan(L.fix_hb)) o.hb = L.fix_hb;
  const T xf = T(kKelvin) + (ft.front_rad + ft.front_surf) / T(2);
  const T xb = T(kKelvin) + (ft.back_rad + ft.back_surf_eff) / T(2);
  o.radf = T(4) * L.eps_f * T(kSigma) * (xf * xf * xf);
  o.radb = T(4) * L.eps_b * T(kSigma) * (xb * xb * xb);
  o.rad_ft = ft.front_rad;
  o.rad_bt = ft.back_rad;
  for (int i = 0; i < L.N; ++i) {
    const bool v = L.valid(i);
    T kl, kd, ku;
    k_row(L, o, i, kl, kd, ku);
    const T md = v ? L.Cap[i * L.SP] - a_dt * kd : T(1);
    const T ml = v ? -a_dt * kl : T(0);
    const T mu = v ? -a_dt * ku : T(0);
    const T iv = T(1) / (i == 0 ? md : md - ml * cs[i - 1]);
    inv[i] = iv;
    cs[i] = mu * iv;
  }
  return o;
}

// Node i's forcing q: absorbed solar plus, on a boundary node, the face's
// convective and radiative sources.
template <typename T>
__device__ __forceinline__ T forcing(const Lane<T>& L, const Ops<T>& o, const HourIn<T>& hi,
                                     int i, T src_f, T src_b) {
  T q = L.FA[i * L.SP] * hi.sol_f + L.FB[i * L.SP] * hi.sol_b;
  if (L.first(i)) q += src_f;
  if (L.last(i)) q += src_b;
  return q;
}

// One TR-BDF2 sub-step of the lane's node column on the group's factors:
// stage 1 (rhs1 = C T + (gamma dt/2) K T + gamma dt q, fused with the forward
// sweep) into T1, stage 2 (rhs2 = c1 C T1 - c2 C T + beta dt q) into Tn.
template <typename T>
__device__ void march_substep(const Lane<T>& L, const Ops<T>& o, const T* cs, const T* inv,
                              const HourIn<T>& hi, T t_front, T t_back, const Scheme<T>& s,
                              T* Tn, T* T1) {
  const int N = L.N;
  const T src_f = t_front * o.hf + o.radf * o.rad_ft;
  const T src_b = t_back * o.hb + o.radb * o.rad_bt;
  for (int n = 0; n < N; ++n) {
    const bool v = L.valid(n);
    const T q = forcing(L, o, hi, n, src_f, src_b);
    T kl, kd, ku;
    k_row(L, o, n, kl, kd, ku);
    const T x_dn = n > 0 ? Tn[n - 1] : T(0);
    const T x_up = n + 1 < N ? Tn[n + 1] : T(0);
    const T kt = kd * Tn[n] + kl * x_dn + ku * x_up;
    const T rhs = v ? L.Cap[n * L.SP] * Tn[n] + s.a_dt * kt + s.g_dt * q : Tn[n];
    const T ml = v ? -s.a_dt * kl : T(0);
    T1[n] = (n == 0 ? rhs : rhs - ml * T1[n - 1]) * inv[n];
  }
  for (int n = N - 2; n >= 0; --n) T1[n] = T1[n] - cs[n] * T1[n + 1];

  for (int n = 0; n < N; ++n) {
    const bool v = L.valid(n);
    const T q = forcing(L, o, hi, n, src_f, src_b);
    const T cap = L.Cap[n * L.SP];
    const T rhs = v ? s.c1 * cap * T1[n] - s.c2 * cap * Tn[n] + s.b_dt * q : Tn[n];
    Tn[n] = (n == 0 ? rhs : rhs - m_lower(L, n, s.a_dt) * Tn[n - 1]) * inv[n];
  }
  for (int n = N - 2; n >= 0; --n) Tn[n] = Tn[n] - cs[n] * Tn[n + 1];
}

// A zone's A/B sums: the gains plus its faces' h A T_s and h A, in the fixed
// order of the zone's face list (front faces, then back faces, ascending lane).
template <typename T>
__device__ __forceinline__ void zone_sums(const int* zone_ptr, const int* zone_faces, int gz,
                                          const T* s_haT, const T* s_ha, T a_ex, T b_ex,
                                          T& az, T& bz) {
  T af = T(0), bf = T(0), ab = T(0), bb = T(0);
  for (int e = zone_ptr[gz]; e < zone_ptr[gz + 1]; ++e) {
    const int f = zone_faces[e];
    if (f & 1) {
      ab += s_haT[f];
      bb += s_ha[f];
    } else {
      af += s_haT[f];
      bf += s_ha[f];
    }
  }
  az = (a_ex + af) + ab;
  bz = (b_ex + bf) + bb;
}

// The fixed-order sum of a zone's per-face values (the transpose of the
// boundary-temperature gather).
template <typename T>
__device__ __forceinline__ T face_sum(const int* zone_ptr, const int* zone_faces, int gz,
                                      const T* s_face) {
  T sf = T(0), sb = T(0);
  for (int e = zone_ptr[gz]; e < zone_ptr[gz + 1]; ++e) {
    const int f = zone_faces[e];
    if (f & 1)
      sb += s_face[f];
    else
      sf += s_face[f];
  }
  return sf + sb;
}

// Zone air heat capacity V rho(T) cp(T).
template <typename T>
__device__ __forceinline__ T air_capacity(T zt, T volume) {
  const T t_k = zt + T(kKelvin);
  return volume * (T(kRhoNum) / (T(kGasR) * t_k)) * (T(kAirCp0) + T(kAirCp1) * t_k);
}

// rho(T) cp(T) of zone air, and its derivative in T.
template <typename T>
__device__ __forceinline__ T air_rho_cp(T zt) {
  const T t_k = zt + T(kKelvin);
  return (T(kRhoNum) / (T(kGasR) * t_k)) * (T(kAirCp0) + T(kAirCp1) * t_k);
}
template <typename T>
__device__ __forceinline__ T air_rho_cp_dt(T zt) {
  const T t_k = zt + T(kKelvin);
  const T rho = T(kRhoNum) / (T(kGasR) * t_k);
  return rho * (T(kAirCp1) - (T(kAirCp0) + T(kAirCp1) * t_k) / t_k);
}

// Inter-zone mixing into zone slot gz: ventilation whose inlet is the source
// zone's air at the sub-step's start (zT_old is the block's row then),
// a += sum s0 T W, b += sum s0 W with s0 = rho cp of the SOURCE zone, summed
// in the fixed order of the slot's entry list.
template <typename T>
__device__ __forceinline__ void mix_sums(const DayArgs<T>& a, int gz, const T* zT_old, T& az,
                                         T& bz) {
  T am = T(0), bm = T(0);
  for (int e = a.mix_ptr[gz]; e < a.mix_ptr[gz + 1]; ++e) {
    const T zs = zT_old[a.mix_src[e]];
    const T s0 = air_rho_cp(zs);
    am += (s0 * zs) * a.mix_vol[e];
    bm += s0 * a.mix_vol[e];
  }
  az += am;
  bz += bm;
}

// A zone's thermostat for hour h: the hour's setpoint rows where the march is
// scheduled, else the compiled rows; capacities always from the compiled rows.
template <typename T>
struct Setpoints {
  T heat, cool, max_heat, max_cool;
  __device__ Setpoints(const DayArgs<T>& a, int h, int gz) {
    const int NZ = a.NB * a.ZB;
    heat = a.sp_heat ? a.sp_heat[(size_t)h * NZ + gz] : a.ctl[gz];
    cool = a.sp_cool ? a.sp_cool[(size_t)h * NZ + gz] : a.ctl[NZ + gz];
    max_heat = a.ctl[2 * NZ + gz];
    max_cool = a.ctl[3 * NZ + gz];
  }
};

// The power that lands the exact exponential update on t_set:
// B (T0 (1 + em) - T_set) / em - A.
template <typename T>
__device__ __forceinline__ T landing_power(T zt, T az, T bz, T em, T t_set) {
  return bz * (zt * (T(1) + em) - t_set) / em - az;
}

// Zone update with setpoint-driven ideal loads (heatx _zone_update_ctl):
// predict the free-float temperature; where it crosses a setpoint, inject the
// power that lands on it, clamped to the capacity.  |B| ~ 0 holds and control
// stands down; a zero load returns the free-float value bit for bit.  The
// landing power is formed only on a zone that crossed its setpoint, so the
// never-act sentinels (-1e9, 1e9) never enter the arithmetic.
template <typename T>
__device__ __forceinline__ T zone_update_ctl(T zt, T az, T bz, T volume, T dt,
                                             const Setpoints<T>& sp, T& load) {
  load = T(0);
  if (m_abs(bz) <= T(1e-9)) return zt;
  const T em = m_expm1(-(bz * dt / air_capacity(zt, volume)));
  const T t_free = zt - (az / bz - zt) * em;
  if (t_free < sp.heat)
    load = m_min(m_max(landing_power(zt, az, bz, em, sp.heat), T(0)), sp.max_heat);
  else if (t_free > sp.cool)
    load = m_min(m_max(landing_power(zt, az, bz, em, sp.cool), -sp.max_cool), T(0));
  if (load == T(0)) return t_free;
  return zt - ((az + load) / bz - zt) * em;
}

// The exact exponential zone-air update (model.rs:650-674); |B| ~ 0 holds.
template <typename T>
__device__ __forceinline__ T zone_update(T zt, T az, T bz, T volume, T dt) {
  const T c_z = air_capacity(zt, volume);
  const bool ok = m_abs(bz) > T(1e-9);
  const T safe_b = ok ? bz : T(1);
  const T em = m_expm1(-(safe_b * dt / c_z));
  return ok ? zt - (az / safe_b - zt) * em : zt;
}

}  // namespace heatx
