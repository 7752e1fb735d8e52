// Device code shared by the day march (day_march.cu) and its adjoint
// (day_adjoint.cu), in TR-BDF2 and (with day_parity.cuh) reference-parity
// mode: the packed-operand layout, one surface lane's statics, the ISO 15099
// gas-cavity U-value and its two partial derivatives, the operator build
// (film coefficients, linearized radiation, the cavity U, the stage
// matrix and its Thomas factors), one TR-BDF2 sub-step of a lane's node
// column, the zone sums, the inter-zone mixing sums, the exact exponential
// zone update and its setpoint-landing (thermostat) form, and the interior
// MRT network (Carroll) with its reverse.  Both kernels march
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
constexpr int LN_CAV = LN_MASS + 2;  // after day_parity.cuh's chunk words
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
// kCav instantiations (day_march.cu), so the others keep their code.
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

// Rewrite a cavity lane's cavity-segment U-values (u: the lane's column of
// cav_u, rows of SP) from the node temperatures Tn; cav: the lane's column of
// the cavity operands.
template <typename T>
__device__ __noinline__ void cavity_u_update(T* u, const T* cav, const T* Tn, int N, int SP,
                                             unsigned cav_bits) {
  const size_t ns = static_cast<size_t>(N) * SP;
  for (int s = 0; s + 1 < N; ++s)
    if ((cav_bits >> s) & 1u) u[s * SP] = cavity_u(cav + s * SP, ns, Tn[s], Tn[s + 1],
                                                   static_cast<T*>(nullptr), static_cast<T*>(nullptr));
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
  // Gas cavities (null without): cav_u [N, SP] the segment U-values, a
  // per-launch copy of the U row whose cavity segments the march rewrites at
  // each operator build; cav [12, N, SP] the cavity operands
  // (day_march.CAV_FIELDS), read only.
  T* cav_u;
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
  int code_f, code_b, zone_f, zone_b, N, SP;
  unsigned bits, mass_bits;
  unsigned cav_bits;  // bit i: segment i is a gas cavity
  bool f_out, b_out, b_amb;
  const T* U;  // node rows, stride SP
  const T* Cav;  // a cavity lane's cavity operands (rows of N x SP), else null
  const T* Cap;
  const T* FA;
  const T* FB;

  // `cavities` is the kernel's compile-time kCav: without it cav_bits is the
  // constant 0 and every cavity branch folds away.
  __device__ Lane(const DayArgs<T>& a, int lane, bool cavities) : N(a.N), SP(a.NB * a.SB) {
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
    // A cavity lane's K reads its segment U-values from cav_u, rewritten at
    // each operator build.
    cav_bits = cavities ? static_cast<unsigned>(a.lane[LN_CAV * SP + lane]) : 0u;
    Cav = cav_bits ? a.cav + lane : nullptr;
    if (cav_bits) U = a.cav_u + lane;
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
// radiant temperatures from the incident IR.  `shade` scales the incident
// front solar before the clamp (in-run zone shading: the deployed device's
// transmittance, else 1), heatx's order.
template <typename T>
struct HourIn {
  T sol_f, sol_b, rad_out_f, rad_out_b;
  __device__ HourIn(const DayArgs<T>& a, int h, int lane, T shade = T(1)) {
    const int SP = a.NB * a.SB;
    const T sfr = a.sol_f[h * SP + lane] * shade, sbr = a.sol_b[h * SP + lane];
    sol_f = (is_nan(sfr) || sfr < T(0)) ? T(0) : sfr;
    sol_b = is_nan(sbr) ? T(0) : sbr;
    rad_out_f = m_pow(m_max(a.ir_f[h * SP + lane], T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
    rad_out_b = m_pow(m_max(a.ir_b[h * SP + lane], T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
  }
};

// The cavity segments' U-values of a cavity lane at the node temperatures Tn.
template <typename T>
__device__ __forceinline__ void cavity_refresh(const Lane<T>& L, const T* Tn) {
  cavity_u_update(const_cast<T*>(L.U), L.Cav, Tn, L.N, L.SP, L.cav_bits);
}

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

// A lane's faces on the interior MRT network: their effective emissivities
// (0 off the network) and, after the network's fixed point, their zones' MRT
// nodes.  apply_interior_mrt: a face with a positive effective emissivity
// radiates with it toward that node instead of its boundary's temperature.
template <typename T>
struct MrtFace {
  T ef, eb, tmf, tmb;
};

// The radiant temperatures and emissivities of the linearized radiation:
// the boundary's and the surface's, or the MRT context's on a network face.
template <typename T>
__device__ __forceinline__ void rad_view(const Lane<T>& L, const FaceTemps<T>& ft, const MrtFace<T>& m,
                                         T& rad_f, T& rad_b, T& eps_f, T& eps_b) {
  const bool on_f = m.ef > T(0), on_b = m.eb > T(0);
  rad_f = on_f ? m.tmf : ft.front_rad;
  rad_b = on_b ? m.tmb : ft.back_rad;
  eps_f = on_f ? m.ef : L.eps_f;
  eps_b = on_b ? m.eb : L.eps_b;
}

// Operators from the marching state (implicit.build_operators): film
// coefficients, linearized radiation, the cavity U-values (segment_u), and
// the Thomas factors (cs, inv) of the stage matrix C - (gamma dt/2) K,
// identity rows on padded nodes.  kMrt: the linearized radiation of a face on
// the MRT network runs toward the context *m (its zone's node, its effective
// emissivity); only the kMrt instantiations' unit instantiates it.
template <typename T, bool kMrt = false>
__device__ Ops<T> build_ops(const Lane<T>& L, const T* Tn, T t_front, T t_back, T ws, T wd,
                            const HourIn<T>& hi, int amb_bug, T a_dt, T* cs, T* inv,
                            const MrtFace<T>* m = nullptr) {
  Ops<T> o;
  if (L.cav_bits) cavity_refresh(L, Tn);
  const FaceTemps<T> ft(L, Tn, t_front, t_back, hi, amb_bug);
  const T front_cos = L.f_out ? -L.cos_t : L.cos_t;
  const T base = forced_base(L, ws, wd);
  o.hf = natural_h(t_front, ft.front_surf, front_cos, L.c_same, L.c_opp) + (L.f_out ? base : T(0));
  o.hb = natural_h(t_back, ft.back_surf_eff, L.cos_t, L.c_same, L.c_opp) + (L.b_out ? base : T(0));
  if (!is_nan(L.fix_hf)) o.hf = L.fix_hf;
  if (!is_nan(L.fix_hb)) o.hb = L.fix_hb;
  T rad_f = ft.front_rad, rad_b = ft.back_rad, eps_f = L.eps_f, eps_b = L.eps_b;
  if constexpr (kMrt) rad_view(L, ft, *m, rad_f, rad_b, eps_f, eps_b);
  const T xf = T(kKelvin) + (rad_f + ft.front_surf) / T(2);
  const T xb = T(kKelvin) + (rad_b + ft.back_surf_eff) / T(2);
  o.radf = T(4) * eps_f * T(kSigma) * (xf * xf * xf);
  o.radb = T(4) * eps_b * T(kSigma) * (xb * xb * xb);
  o.rad_ft = rad_f;
  o.rad_bt = rad_b;
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
// network lies in one block.  Each of the four iterations: every lane writes
// its network faces' linearized conductances w = 4 sigma eps_eff (K +
// (tm_face + ts)/2)^3 A and w ts to two shared rows laid out like the zone
// sums' (lane*2 + side); one thread per zone sums its network faces in the
// fixed order of mrt_faces and writes the zone's node num/den (the zone air
// where it has no conductance); every lane gathers its zones' nodes.  Eight
// barriers, reached by every thread of the block (padded lanes too).
// ---------------------------------------------------------------------------

// The network's operands.  They ride beside DayArgs in the kMrt
// instantiations' own argument structs (day_march.cu, day_adjoint.cu), so
// the other instantiations keep their parameter layout and their code.
template <typename T>
struct MrtArgs {
  const T* mrt;          // [2, SP]: the faces' effective emissivities (front row, back row)
  const int* mrt_ptr;    // [NB*ZB + 1]: each zone slot's network faces,
  const int* mrt_faces;  // block-local lane*2 + side, in zone_faces' order
  int phys;              // whether the network drives the march (else only the operative history reads it)
};

// A lane's faces on the network (bit 0 front, bit 1 back) and their
// effective emissivities (all 0 default-constructed).
template <typename T>
struct MrtLane {
  unsigned bits = 0u;
  T ef = T(0), eb = T(0);
  MrtLane() = default;
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

// Zone slot gz's sums of w ts and w over its network faces, in list order.
template <typename T>
__device__ __forceinline__ void mrt_sums(const MrtArgs<T>& r, int gz, const T* s_wt, const T* s_w,
                                         T& num, T& den) {
  num = den = T(0);
  for (int e = r.mrt_ptr[gz]; e < r.mrt_ptr[gz + 1]; ++e) {
    const int f = r.mrt_faces[e];
    num += s_wt[f];
    den += s_w[f];
  }
}

// Zone slot gz's sum of a per-face row over its network faces.
template <typename T>
__device__ __forceinline__ T mrt_face_sum(const MrtArgs<T>& r, int gz, const T* s_face) {
  T s = T(0);
  for (int e = r.mrt_ptr[gz]; e < r.mrt_ptr[gz + 1]; ++e) s += s_face[r.mrt_faces[e]];
  return s;
}

// The network's fixed point from a state whose face temperatures are ts_f
// (node 0) and ts_b (last node).  tm_f/tm_b hold the linearization's start
// (the faces' boundary air temperatures) and return each face's zone node;
// hist_f/hist_b (when given) keep the value before each iteration.  s_zT is
// the block's zone row (the fallback), s_w/s_wt [2*SB] and s_tm [ZB] shared
// work rows; s_tm holds the zones' nodes on return.
template <typename T>
__device__ void mrt_network(const DayArgs<T>& a, const MrtArgs<T>& r, const Lane<T>& L,
                            const MrtLane<T>& M, int b, int tid, T ts_f, T ts_b, T& tm_f, T& tm_b,
                            const T* s_zT, T* s_w,
                            T* s_wt, T* s_tm, T* hist_f = nullptr, T* hist_b = nullptr) {
  for (int it = 0; it < 4; ++it) {
    if (hist_f) {
      hist_f[it] = tm_f;
      hist_b[it] = tm_b;
    }
    if (M.bits & 1u) {
      const T w = mrt_weight(M.ef, L.area, tm_f, ts_f);
      s_w[2 * tid] = w;
      s_wt[2 * tid] = w * ts_f;
    }
    if (M.bits & 2u) {
      const T w = mrt_weight(M.eb, L.area, tm_b, ts_b);
      s_w[2 * tid + 1] = w;
      s_wt[2 * tid + 1] = w * ts_b;
    }
    __syncthreads();
    for (int z = tid; z < a.ZB; z += a.SB) {
      T num, den;
      mrt_sums(r, b * a.ZB + z, s_wt, s_w, num, den);
      s_tm[z] = den > T(1e-30) ? num / den : s_zT[z];
    }
    __syncthreads();
    tm_f = L.zone_f >= 0 ? s_tm[L.zone_f] : T(0);
    tm_b = L.zone_b >= 0 ? s_tm[L.zone_b] : T(0);
  }
}

// The lane's MRT context for an operator build from the node column Tn: the
// block's network fixed point started at the faces' boundary air
// temperatures (t_front, t_back), the zone row s_zT its fallback; every
// thread of the block calls it (hist_f/hist_b: as mrt_network).
template <typename T>
__device__ MrtFace<T> mrt_context(const DayArgs<T>& a, const MrtArgs<T>& r, const Lane<T>& L,
                                  const MrtLane<T>& M, int b, int tid, const T* Tn, T t_front,
                                  T t_back, const T* s_zT, T* s_w, T* s_wt, T* s_tm,
                                  T* hist_f = nullptr, T* hist_b = nullptr) {
  MrtFace<T> f{M.ef, M.eb, t_front, t_back};
  mrt_network(a, r, L, M, b, tid, Tn[0], L.last_node(Tn), f.tmf, f.tmb, s_zT, s_w, s_wt, s_tm,
              hist_f, hist_b);
  return f;
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

// The reverse of mrt_network from its history (hist_f/hist_b, the face
// temperatures ts_f/ts_b and the zone row it fell back on): l_tm_f/l_tm_b
// are the cotangents of the faces' final nodes.  Adds the cotangents of the
// face temperatures (l_ts_*), of the linearization's start (l_t0_*, the
// boundary air temperatures), of the effective emissivities (l_e*) and of
// the area; s_lzf[z] accumulates the zone row's (the fallback's).  The
// transpose of a face's gather of its zone's node is the zone's sum over
// its network faces (mrt_face_sum), the transpose of the zone sums a
// per-face read of the zone's cotangents.  Shared rows: s_w/s_wt/s_lt
// [2*SB], s_lnum/s_lden/s_lm [ZB].  Thirteen barriers.
template <typename T>
__device__ void mrt_network_adj(const DayArgs<T>& a, const MrtArgs<T>& r, const Lane<T>& L,
                                const MrtLane<T>& M, int b, int tid, T ts_f, T ts_b, const T* hist_f, const T* hist_b,
                                T l_tm_f, T l_tm_b, T& l_ts_f, T& l_ts_b, T& l_t0_f, T& l_t0_b,
                                T& l_ef, T& l_eb, T& l_area, T* s_w, T* s_wt, T* s_lt, T* s_lnum,
                                T* s_lden, T* s_lm, T* s_lzf) {
  const bool on_f = M.bits & 1u, on_b = (M.bits >> 1) & 1u;
  if (on_f) s_lt[2 * tid] = l_tm_f;
  if (on_b) s_lt[2 * tid + 1] = l_tm_b;
  __syncthreads();
  for (int z = tid; z < a.ZB; z += a.SB) s_lm[z] = mrt_face_sum(r, b * a.ZB + z, s_lt);
  for (int k = 3; k >= 0; --k) {
    if (on_f) {
      const T w = mrt_weight(M.ef, L.area, hist_f[k], ts_f);
      s_w[2 * tid] = w;
      s_wt[2 * tid] = w * ts_f;
    }
    if (on_b) {
      const T w = mrt_weight(M.eb, L.area, hist_b[k], ts_b);
      s_w[2 * tid + 1] = w;
      s_wt[2 * tid + 1] = w * ts_b;
    }
    __syncthreads();
    for (int z = tid; z < a.ZB; z += a.SB) {
      T num, den;
      mrt_sums(r, b * a.ZB + z, s_wt, s_w, num, den);
      const T lm = s_lm[z];
      if (den > T(1e-30)) {
        s_lnum[z] = lm / den;
        s_lden[z] = -lm * (num / den) / den;
      } else {
        s_lnum[z] = s_lden[z] = T(0);
        s_lzf[z] += lm;
      }
    }
    __syncthreads();
    T lf = T(0), lb = T(0);
    if (on_f)
      lf = mrt_face_adj(M.ef, L.area, hist_f[k], ts_f, s_lnum[L.zone_f], s_lden[L.zone_f], l_ts_f,
                        l_ef, l_area);
    if (on_b)
      lb = mrt_face_adj(M.eb, L.area, hist_b[k], ts_b, s_lnum[L.zone_b], s_lden[L.zone_b], l_ts_b,
                        l_eb, l_area);
    if (k > 0) {
      if (on_f) s_lt[2 * tid] = lf;
      if (on_b) s_lt[2 * tid + 1] = lb;
      __syncthreads();
      for (int z = tid; z < a.ZB; z += a.SB) s_lm[z] = mrt_face_sum(r, b * a.ZB + z, s_lt);
    } else {
      l_t0_f += lf;
      l_t0_b += lb;
    }
  }
}

}  // namespace heatx
