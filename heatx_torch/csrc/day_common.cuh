// Device code shared by the day march (day_march_tr.cu, day_march_parity.cu) and its adjoints
// (day_adjoint_tr.cu, day_adjoint_parity.cu), in TR-BDF2 and reference-parity
// mode: the packed-operand layout, one surface lane's statics, the ISO 15099
// gas-cavity U-value and its two partial derivatives, TARP natural
// convection, the inter-zone mixing sums, the exact exponential zone update
// and its setpoint-landing (thermostat) form, and one face's share of the
// interior MRT network (Carroll) and of its reverse.  The four-thread code is
// day_tr.cuh's and day_parity_rows.cuh's (forward) and day_tr_adj.cuh's and
// day_parity_adj.cuh's (reverse).  The layout follows
// heatx_torch/ops/day_march.py (NODE_FIELDS, SURF_FIELDS, LANE_FIELDS).
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
constexpr int LN_CAV = LN_MASS + 2;  // after the chunk words (day_parity.cuh LN_CHUNK)
constexpr int LN_MRT = LN_CAV + 1;   // bit 0: the front face is on the MRT network, bit 1: the back

constexpr double kKelvin = 273.15;
constexpr double kSigma = 5.670374419e-8;
constexpr double kPi = 3.14159265358979323846;
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
__device__ __forceinline__ float m_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double m_fmod(double x, double y) { return fmod(x, y); }
__device__ __forceinline__ float m_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double m_expm1(double x) { return expm1(x); }
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool is_finite(double x) { return fabs(x) <= DBL_MAX; }
template <typename T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }
// sign(x) with sign(0) = 0: the derivative of |x| that autograd uses.
template <typename T>
__device__ __forceinline__ T m_sign(T x) { return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0)); }

// ---------------------------------------------------------------------------
// The gas-cavity U-value (heatx/physics/cavity.py, gas.py): ISO 15099
// convection through the Rayleigh and Nusselt numbers of the cavity, plus
// the linearized radiation between its panes.  Only the tilt band's own
// correlation is evaluated (heatx evaluates all five and selects); its
// derivative in Ra comes with it.  Out of line, and called only from the
// kCav instantiations, so the others keep their code.
// ---------------------------------------------------------------------------

// max(x1, x2) with its derivative; a tie takes the mean, as torch.maximum's.
template <typename T>
__device__ __forceinline__ T max_d(T x1, T d1, T x2, T d2, T& d) {
  d = x1 > x2 ? d1 : (x1 < x2 ? d2 : (d1 + d2) / T(2));
  return m_max(x1, x2);
}

// Nusselt at 60 deg (ISO 15099 Eq. 45-48); where (Ra/3160)^20.6 overflows
// the type, g is the 0 it rounds to in heatx.
template <typename T>
__device__ T nu_60(T ra, T a_gi, T& d) {
  const T x = m_pow(ra / T(3160), T(20.6));
  T g = T(0), dg = T(0);
  if (is_finite(x)) {
    g = T(0.5) / m_pow(T(1) + x, T(0.1));
    dg = T(-0.05) * m_pow(T(1) + x, T(-1.1)) * T(20.6) * x / ra;
  }
  const T y = T(0.0936) * m_pow(ra, T(0.314)) / (T(1) + g);
  const T dy = y * (T(0.314) / ra - dg / (T(1) + g));
  const T y7 = m_pow(y, T(7));
  const T nu1 = m_pow(T(1) + y7, T(1.0 / 7.0));
  const T d1 = nu1 / (T(1) + y7) * m_pow(y, T(6)) * dy;
  const T nu2 = (T(0.104) + T(0.175) / a_gi) * m_pow(ra, T(0.283));
  return max_d(nu1, d1, nu2, T(0.283) * nu2 / ra, d);
}

// Nusselt at 90 deg (ISO 15099 Eq. 49-53): three Ra ranges, then the
// aspect-ratio term.
template <typename T>
__device__ T nu_90(T ra, T a_gi, T& d) {
  T nu1, d1;
  if (ra <= T(1e4)) {
    const T c = T(1.7596678e-10) * m_pow(ra, T(1.2984755));
    nu1 = T(1) + c * ra;
    d1 = T(2.2984755) * c;
  } else if (ra < T(5e4)) {
    nu1 = T(0.028154) * m_pow(ra, T(0.4134));
    d1 = T(0.4134) * nu1 / ra;
  } else {
    nu1 = T(0.0673838) * m_pow(ra, T(1.0 / 3.0));
    d1 = nu1 / (T(3) * ra);
  }
  const T nu2 = T(0.242) * m_pow(ra / a_gi, T(0.272));
  return max_d(nu1, d1, nu2, T(0.272) * nu2 / ra, d);
}

// The cavity Nusselt number of tilt gamma (heatx nusselt: reduced modulo pi,
// bands of +-0.5 deg around 60 and 90 deg) and its derivative in Ra.
template <typename T>
__device__ T nusselt(T ra, T gamma, T a_gi, T& d) {
  T g = m_fmod(gamma, T(kPi));
  if (g < T(0)) g += T(kPi);
  const T thirty = T(30.0 * kPi / 180.0), eps = T(0.5 * kPi / 180.0);
  if (g < T(2) * thirty - eps) {  // 0-60 deg (Eq. 43-44)
    const T cg = m_cos(g);
    const T prod = ra * cg;
    const T safe = m_max(prod, T(1e-30));
    const T dsafe = prod > T(1e-30) ? cg : T(0);
    const T a_in = T(1) - T(1708) / safe;
    const T a = m_max(a_in, T(0));
    const T da = a_in > T(0) ? T(1708) / (safe * safe) : T(0);
    const T s16 = m_pow(m_max(m_sin(T(1.8) * g), T(0)), T(1.6));
    const T b = T(1) - T(1708) * s16 / safe;
    const T db = T(1708) * s16 / (safe * safe);
    const T cr = m_pow(safe / T(5830), T(1.0 / 3.0));
    const T c = cr - T(1);
    const T dc = c > T(0) ? cr / (T(3) * safe) : T(0);
    d = (T(1.44) * (da * b + a * db) + dc) * dsafe;
    return T(1) + T(1.44) * a * b + m_max(c, T(0));
  }
  if (g < T(2) * thirty + eps) return nu_60(ra, a_gi, d);
  if (g < T(3) * thirty - eps) {  // linear between 60 and 90 deg
    T d60, d90;
    const T n60 = nu_60(ra, a_gi, d60);
    const T n90 = nu_90(ra, a_gi, d90);
    const T x = (g - T(kPi / 3.0)) / T(kPi / 2.0 - kPi / 3.0);
    d = d60 + (d90 - d60) * x;
    return n60 + (n90 - n60) * x;
  }
  if (g < T(3) * thirty + eps) return nu_90(ra, a_gi, d);
  T dv;  // 90-180 deg (Eq. 54)
  const T nv = nu_90(ra, a_gi, dv);
  const T s = m_sin(g);
  d = dv * s;
  return T(1) + (nv - T(1)) * s;
}

// U of one cavity segment between node temperatures tf (front) and tb (C):
// p points at its first operand (day_march.CAV_FIELDS), the others follow at
// `stride`.  With d_tf/d_tb it also returns dU/dtf and dU/dtb (autograd's
// conventions: |x|' = sign(x), the isothermal Ra constant, the tilt branch
// and the front-warmer complement piecewise constant).
template <typename T>
__device__ __noinline__ T cavity_u(const T* p, size_t stride, T tf, T tb, T* d_tf, T* d_tb) {
  const T k0 = p[0], k1 = p[stride], mu0 = p[2 * stride], mu1 = p[3 * stride];
  const T cp0 = p[4 * stride], cp1 = p[5 * stride], mm = p[6 * stride];
  const T thick = p[7 * stride], height = p[8 * stride], angle = p[9 * stride];
  const T ein = p[10 * stride], eout = p[11 * stride];
  // Radiation 4 Tm^3 sigma e_in e_out / (1 - (1 - e_in)(1 - e_out)).
  const T tm = (tb + tf) / T(2) + T(kKelvin);
  const T e = ein * eout / (T(1) - (T(1) - ein) * (T(1) - eout));
  const T rad = T(4) * (tm * tm * tm) * T(kSigma) * e;
  // Convection: Ra (Eq. 40), Nu of the tilt band, h = Nu lambda / d.
  const T gamma = tf > tb ? T(kPi) - angle : angle;
  const T safe_th = thick > T(0) ? thick : T(1);
  const T dtt = m_abs(tf - tb);
  const T temp = (tf + tb) / T(2) + T(kKelvin);
  const T cp = cp0 + cp1 * temp, mu = mu0 + mu1 * temp, lam = k0 + k1 * temp;
  const T rho = T(101325) * mm / (T(kGasR) * temp);
  const bool iso = dtt < T(1e-10);
  const T ra = iso ? T(1e-7)
                   : rho * rho * (thick * thick * thick) * T(9.81) * (T(1) / temp) * cp * dtt /
                         (mu * lam);
  T dnu;
  const T nu = nusselt(ra, gamma, height / safe_th, dnu);
  if (d_tf) {
    // d ln Ra / d temp = -3/temp + cp'/cp - mu'/mu - lambda'/lambda.
    const T dra_dtemp = iso ? T(0) : ra * (T(-3) / temp + cp1 / cp - mu1 / mu - k1 / lam);
    const T dra_ddt = iso ? T(0) : ra / dtt;
    const T sg = m_sign(tf - tb);
    const T l_ra = dnu * lam / safe_th;
    const T common = T(6) * (tm * tm) * T(kSigma) * e + nu * k1 / safe_th / T(2) +
                     l_ra * dra_dtemp / T(2);
    *d_tf = common + l_ra * dra_ddt * sg;
    *d_tb = common - l_ra * dra_ddt * sg;
  }
  return rad + nu * lam / safe_th;
}

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
  // Gas cavities (null without): cav [12, N, SP] the cavity operands
  // (day_march.CAV_FIELDS), read only; a cavity segment's U is computed from
  // them at each operator build.
  const T* cav;
  // In-run passive controls (null without; the day march's extended
  // instantiations read them, nothing else does).  Zone shading: per lane
  // the block-local slot of the controlling zone (-1: uncontrolled), the
  // deployed transmittance, and hour h's setpoint at shade_sp[h *
  // shade_sp_stride + lane] (stride 0: the compiled row; SP: a per-hour
  // series).  Ventilation gates: the indoor limits [NB, ZB] and the hour's
  // gated ventilation terms and delta threshold [hours, NB, ZB].
  const int* shade_slot = nullptr;
  const T* shade_tau = nullptr;
  const T* shade_sp = nullptr;
  int shade_sp_stride = 0;
  const T* vent_min = nullptr;
  const T* vent_max = nullptr;
  const T* a_vent = nullptr;
  const T* b_vent = nullptr;
  const T* vent_thr = nullptr;
  int N, NB, SB, ZB, hours, substeps, refresh_every, amb_bug;
  double dt, half_dt, gamma_dt, beta_dt, c1, c2;
  // The reference-parity march (day_parity.cuh): whether it runs instead of
  // TR-BDF2, and its no-mass iteration count (-1: the adaptive loop, at
  // most nomass_max_iter iterations), escalation and tolerances.
  int parity, nomass_iters, esc_after;
  int nomass_max_iter = 0;
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
  int code_f, code_b, zone_f, zone_b, SP;
  unsigned cav_bits;  // bit i: segment i is a gas cavity
  bool f_out, b_out, b_amb;
  const T* Cav;  // a cavity lane's cavity operands (rows of N x SP), else null

  // `cavities` is the kernel's compile-time kCav: without it cav_bits is the
  // constant 0 and every cavity branch folds away.
  __device__ Lane(const DayArgs<T>& a, int lane, bool cavities) : SP(a.NB * a.SB) {
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
    f_out = code_f == kOutdoor;
    b_out = code_b == kOutdoor;
    b_amb = code_b == kAmbient;
    c_same = T(9.482) / (T(7.238) - m_abs(cos_t));
    c_opp = T(1.81) / (T(1.382) + m_abs(cos_t));
    cav_bits = cavities ? static_cast<unsigned>(a.lane[LN_CAV * SP + lane]) : 0u;
    Cav = cav_bits ? a.cav + lane : nullptr;
  }

  __device__ bool windward(T wd) const {
    return m_abs(cos_t) >= T(0.98) || (nx * m_sin(wd) + ny * m_cos(wd) > T(0));
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
  // From values staged elsewhere (the TR-BDF2 kernel's shared rows).
  __device__ Setpoints(T heat_, T cool_, T max_heat_, T max_cool_)
      : heat(heat_), cool(cool_), max_heat(max_heat_), max_cool(max_cool_) {}
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

// ---------------------------------------------------------------------------
// Interior MRT: the Carroll network (heatx _mrt_context, pallas_step.py:555),
// in the kMrt instantiations only.  Blocks are zone-closed, so a zone's
// network lies in one block.  Each of the four iterations: every face on the
// network writes its linearized conductance w = 4 sigma eps_eff (K + (tm_face
// + ts)/2)^3 A and w ts to two shared rows laid out like the zone sums'
// (lane*2 + side); each zone sums its network faces in the fixed order of
// mrt_faces and writes the zone's node num/den (the zone air where it has no
// conductance); every face gathers its zone's node (day_tr.cuh mrt_face_node;
// its reverse day_tr_adj.cuh mrt_face_node_adj).
// ---------------------------------------------------------------------------

// The network's operands.  They ride beside DayArgs in the kMrt
// instantiations' own argument structs (day_march_args.cuh, day_adjoint.cu), so
// the other instantiations keep their parameter layout and their code.
template <typename T>
struct MrtArgs {
  const T* mrt;          // [2, SP]: the faces' effective emissivities (front row, back row)
  const int* mrt_ptr;    // [NB*ZB + 1]: each zone slot's network faces,
  const int* mrt_faces;  // block-local lane*2 + side, in zone_faces' order
  int phys;              // whether the network drives the march (else only the operative history reads it)
};

// A lane's faces on the network (bit 0 front, bit 1 back) and their
// effective emissivities.
template <typename T>
struct MrtLane {
  unsigned bits;
  T ef, eb;
  __device__ MrtLane(const DayArgs<T>& a, const MrtArgs<T>& r, int lane) {
    const int SP = a.NB * a.SB;
    bits = static_cast<unsigned>(a.lane[LN_MRT * SP + lane]);
    ef = r.mrt[lane];
    eb = r.mrt[SP + lane];
  }
};

// A face's conductance to its zone's node, linearized at (tm + ts)/2.
template <typename T>
__device__ __forceinline__ T mrt_weight(T eps, T area, T tm, T ts) {
  const T x = T(kKelvin) + (tm + ts) / T(2);
  return T(4) * T(kSigma) * eps * (x * x * x) * area;
}

// The reverse of one face's share of an iteration: w = 4 sigma eps x^3 A,
// x = K + (tm + ts)/2, num += w ts, den += w, given the cotangents of its
// zone's sums (l_num, l_den).  Adds to l_ts, l_eps, l_area and returns the
// cotangent of tm.
template <typename T>
__device__ __forceinline__ T mrt_face_adj(T eps, T area, T tm, T ts, T l_num, T l_den, T& l_ts,
                                          T& l_eps, T& l_area) {
  const T x = T(kKelvin) + (tm + ts) / T(2);
  const T x3 = x * x * x;
  const T w = T(4) * T(kSigma) * eps * x3 * area;
  const T l_w = l_num * ts + l_den;
  l_ts += l_num * w;
  l_eps += l_w * T(4) * T(kSigma) * x3 * area;
  l_area += l_w * T(4) * T(kSigma) * eps * x3;
  const T l_x = l_w * T(12) * T(kSigma) * eps * (x * x) * area;
  l_ts += l_x / T(2);
  return l_x / T(2);
}

}  // namespace heatx
