// TR-BDF2 day march for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes; see heatx_torch/ops/day_march.py).
//
// Replaces heatx/ops/pallas_step.py::make_hour_march -> `kernel` (the
// pl.pallas_call at pallas_step.py:1976) in modes trbdf2 / trbdf2_refresh,
// body `_hour_body_imp`, for free-float buildings without gas cavities.
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
//  * The hour loop runs inside the kernel; weather per sub-step, the hour's
//    solar/IR per lane and the zone gains come from device memory.  Outputs:
//    final T and zT, the last h/q, the per-hour zone history and the
//    per-hour non-finite count.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kMaxNodes = 32;
constexpr int kMaxLanes = 256;

// Boundary codes (heatx_torch/build/layout.py).
constexpr int kOutdoor = 0;
constexpr int kSpace = 1;
constexpr int kAmbient = 2;

// Row order of the packed operands (NODE_FIELDS, SURF_FIELDS, LANE_FIELDS in
// heatx_torch/ops/day_march.py).
enum { ND_U, ND_CAP, ND_FA, ND_FB };
enum {
  SF_AREA, SF_PERIM, SF_COS, SF_WMOD, SF_EPSF, SF_EPSB, SF_RF, SF_TEMPF,
  SF_TEMPB, SF_FIXHF, SF_FIXHB, SF_NX, SF_NY
};
enum { LN_FCODE, LN_BCODE, LN_FZONE, LN_BZONE, LN_BITS };

constexpr double kKelvin = 273.15;
constexpr double kSigma = 5.670374419e-8;
constexpr double kMinH = 0.1;
// Air (heatx_torch/physics/gas.py): rho = 101325 M / (R T), cp = cp0 + cp1 T.
constexpr double kRhoNum = 101325.0 * 28.97;
constexpr double kGasR = 8314.46261815324;
constexpr double kAirCp0 = 1002.7370;
constexpr double kAirCp1 = 1.2324e-2;

template <typename T>
struct DayArgs {
  const T* node;         // [4, N, SP]
  const T* surf;         // [13, SP]
  const int* lane;       // [5, SP]
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
  T* T_out;              // [N, SP]
  T* zT_out;             // [NB, ZB]
  T* hq;                 // [4, SP]: h_front, h_back, q_front, q_back
  T* zt_hist;            // [hours, NB, ZB]
  T* bad;                // [hours, NB]
  int N, NB, SB, ZB, hours, substeps, refresh_every, amb_bug;
  double dt, half_dt, gamma_dt, beta_dt, c1, c2;
};

// Math in the working precision: explicit float/double overloads, so a float
// kernel never widens to double by accident.
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_max(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double m_max(double x, double y) { return fmax(x, y); }
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

template <typename T>
__global__ void __launch_bounds__(kMaxLanes) day_march_kernel(const DayArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_zT = reinterpret_cast<T*>(smem_raw);  // [ZB] zone air temperatures
  T* s_haT = s_zT + a.ZB;                    // [2*SB] h*A*T_s per face
  T* s_ha = s_haT + 2 * a.SB;                // [2*SB] h*A per face
  __shared__ int s_bad;

  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int SP = NB * SB;
  const int lane = b * SB + tid;

  // ---- per-lane statics ---------------------------------------------------
  const T* sf = a.surf + lane;
  const T area = sf[SF_AREA * SP], perim = sf[SF_PERIM * SP];
  const T cos_t = sf[SF_COS * SP], wmod = sf[SF_WMOD * SP];
  const T eps_f = sf[SF_EPSF * SP], eps_b = sf[SF_EPSB * SP], rf = sf[SF_RF * SP];
  const T temp_f = sf[SF_TEMPF * SP], temp_b = sf[SF_TEMPB * SP];
  const T fix_hf = sf[SF_FIXHF * SP], fix_hb = sf[SF_FIXHB * SP];
  const T nx = sf[SF_NX * SP], ny = sf[SF_NY * SP];
  const int code_f = a.lane[LN_FCODE * SP + lane];
  const int code_b = a.lane[LN_BCODE * SP + lane];
  const int zone_f = a.lane[LN_FZONE * SP + lane];
  const int zone_b = a.lane[LN_BZONE * SP + lane];
  const unsigned bits = static_cast<unsigned>(a.lane[LN_BITS * SP + lane]);
  const bool f_out = code_f == kOutdoor, b_out = code_b == kOutdoor;
  const bool b_amb = code_b == kAmbient;
  const T c_same = T(9.482) / (T(7.238) - m_abs(cos_t));
  const T c_opp = T(1.81) / (T(1.382) + m_abs(cos_t));

  const T* U = a.node + (ND_U * N) * SP + lane;   // U[i * SP]
  const T* Cap = a.node + (ND_CAP * N) * SP + lane;
  const T* FA = a.node + (ND_FA * N) * SP + lane;
  const T* FB = a.node + (ND_FB * N) * SP + lane;
  auto valid = [&](int i) -> bool { return i >= 0 && i < N && ((bits >> i) & 1u); };

  // ---- state --------------------------------------------------------------
  T Tn[kMaxNodes], T1[kMaxNodes], cs[kMaxNodes], inv[kMaxNodes];
  for (int i = 0; i < N; ++i) Tn[i] = a.T0[i * SP + lane];
  for (int z = tid; z < ZB; z += SB) s_zT[z] = a.zT0[b * ZB + z];
  __syncthreads();

  auto boundary = [&](T t_out, T& t_front, T& t_back) {
    const T zf = zone_f >= 0 ? s_zT[zone_f] : T(0);
    const T zb = zone_b >= 0 ? s_zT[zone_b] : T(0);
    t_front = f_out ? t_out : (code_f == kSpace ? zf : temp_f);
    t_back = b_out ? t_out : (code_b == kSpace ? zb : temp_b);
  };
  auto last_node = [&](const T* x) -> T {
    T s = T(0);
    for (int i = 0; i < N; ++i)
      if (valid(i) && !valid(i + 1)) s += x[i];
    return s;
  };

  const T a_dt = T(a.half_dt);
  const T g_dt = T(a.gamma_dt), b_dt = T(a.beta_dt);
  const T c1 = T(a.c1), c2 = T(a.c2), dt = T(a.dt);
  // Frozen operators of the current refresh group.
  T hf = T(0), hb = T(0), radf = T(0), radb = T(0), rad_ft = T(0), rad_bt = T(0);
  T qf = T(0), qb = T(0);

  for (int h = 0; h < a.hours; ++h) {
    const T sfr = a.sol_f[h * SP + lane], sbr = a.sol_b[h * SP + lane];
    const T sol_f = (is_nan(sfr) || sfr < T(0)) ? T(0) : sfr;
    const T sol_b = is_nan(sbr) ? T(0) : sbr;
    const T rad_out_f = m_pow(m_max(a.ir_f[h * SP + lane], T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
    const T rad_out_b = m_pow(m_max(a.ir_b[h * SP + lane], T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
    const T* a_ex = a.a_extra + (size_t)h * NB * ZB + b * ZB;
    const T* b_ex = a.b_extra + (size_t)h * NB * ZB + b * ZB;

    for (int i0 = 0; i0 < a.substeps; i0 += a.refresh_every) {
      // ---- operators from the marching state (implicit.build_operators) ----
      {
        const int w = h * a.substeps + i0;
        const T ws = a.wind[w], wd = a.wdir[w];
        T t_front, t_back;
        boundary(a.t_out[w], t_front, t_back);
        const T front_surf = Tn[0];
        const T back_surf = last_node(Tn);
        const T front_rad = f_out ? rad_out_f : t_front;
        const T front_cos = f_out ? -cos_t : cos_t;
        const T amb_rad = a.amb_bug ? t_front : t_back;
        const T amb_surf = a.amb_bug ? front_surf : back_surf;
        const T back_rad = b_out ? rad_out_b : (b_amb ? amb_rad : t_back);
        const T back_surf_eff = b_amb ? amb_surf : back_surf;
        const bool windward = m_abs(cos_t) >= T(0.98) || (nx * m_sin(wd) + ny * m_cos(wd) > T(0));
        const T pva = perim * (ws * wmod) / area;
        const T base = T(2.537) * (windward ? T(1) : T(0.5)) * rf * (pva > T(0) ? m_sqrt(pva) : T(0));
        hf = natural_h(t_front, front_surf, front_cos, c_same, c_opp) + (f_out ? base : T(0));
        hb = natural_h(t_back, back_surf_eff, cos_t, c_same, c_opp) + (b_out ? base : T(0));
        if (!is_nan(fix_hf)) hf = fix_hf;
        if (!is_nan(fix_hb)) hb = fix_hb;
        const T xf = T(kKelvin) + (front_rad + front_surf) / T(2);
        const T xb = T(kKelvin) + (back_rad + back_surf_eff) / T(2);
        radf = T(4) * eps_f * T(kSigma) * (xf * xf * xf);
        radb = T(4) * eps_b * T(kSigma) * (xb * xb * xb);
        rad_ft = front_rad;
        rad_bt = back_rad;
        // Stage matrix C - (gamma dt/2) K and its Thomas factorization.
        for (int i = 0; i < N; ++i) {
          const bool v = valid(i), le = v && valid(i - 1), re = v && valid(i + 1);
          const T kl = le ? U[(i - 1) * SP] : T(0);
          const T ku = re ? U[i * SP] : T(0);
          const T kd = -(kl + ku + (v && !le ? hf + radf : T(0)) + (v && !re ? hb + radb : T(0)));
          const T md = v ? Cap[i * SP] - a_dt * kd : T(1);
          const T ml = v ? -a_dt * kl : T(0);
          const T mu = v ? -a_dt * ku : T(0);
          const T iv = T(1) / (i == 0 ? md : md - ml * cs[i - 1]);
          inv[i] = iv;
          cs[i] = mu * iv;
        }
      }

      for (int i = i0; i < i0 + a.refresh_every; ++i) {
        T t_front, t_back;
        boundary(a.t_out[h * a.substeps + i], t_front, t_back);
        const T src_f = t_front * hf + radf * rad_ft;
        const T src_b = t_back * hb + radb * rad_bt;

        // Stage 1: rhs1 = C T + (gamma dt/2) K T + gamma dt q, fused with the
        // forward sweep (ds into T1), then the back substitution.
        for (int n = 0; n < N; ++n) {
          const bool v = valid(n), le = v && valid(n - 1), re = v && valid(n + 1);
          T q = FA[n * SP] * sol_f + FB[n * SP] * sol_b;
          if (v && !le) q += src_f;
          if (v && !re) q += src_b;
          const T kl = le ? U[(n - 1) * SP] : T(0);
          const T ku = re ? U[n * SP] : T(0);
          const T kd = -(kl + ku + (v && !le ? hf + radf : T(0)) + (v && !re ? hb + radb : T(0)));
          const T x_dn = n > 0 ? Tn[n - 1] : T(0);
          const T x_up = n + 1 < N ? Tn[n + 1] : T(0);
          const T kt = kd * Tn[n] + kl * x_dn + ku * x_up;
          const T rhs = v ? Cap[n * SP] * Tn[n] + a_dt * kt + g_dt * q : Tn[n];
          const T ml = v ? -a_dt * kl : T(0);
          T1[n] = (n == 0 ? rhs : rhs - ml * T1[n - 1]) * inv[n];
        }
        for (int n = N - 2; n >= 0; --n) T1[n] = T1[n] - cs[n] * T1[n + 1];

        // Stage 2: rhs2 = c1 C T1 - c2 C T + beta dt q, solved in place.
        for (int n = 0; n < N; ++n) {
          const bool v = valid(n), le = v && valid(n - 1), re = v && valid(n + 1);
          T q = FA[n * SP] * sol_f + FB[n * SP] * sol_b;
          if (v && !le) q += src_f;
          if (v && !re) q += src_b;
          const T cap = Cap[n * SP];
          const T rhs = v ? c1 * cap * T1[n] - c2 * cap * Tn[n] + b_dt * q : Tn[n];
          const T ml = v ? -a_dt * (le ? U[(n - 1) * SP] : T(0)) : T(0);
          Tn[n] = (n == 0 ? rhs : rhs - ml * Tn[n - 1]) * inv[n];
        }
        for (int n = N - 2; n >= 0; --n) Tn[n] = Tn[n] - cs[n] * Tn[n + 1];

        const T ts_front = Tn[0];
        const T ts_back = last_node(Tn);
        qf = (ts_front - t_front) * hf;
        qb = (ts_back - t_back) * hb;
        const T haf = hf * area, hab = hb * area;
        s_haT[2 * tid] = haf * ts_front;
        s_ha[2 * tid] = haf;
        s_haT[2 * tid + 1] = hab * ts_back;
        s_ha[2 * tid + 1] = hab;
        __syncthreads();

        // Zone sums and the exact exponential zone update, one thread per zone.
        for (int z = tid; z < ZB; z += SB) {
          const int gz = b * ZB + z;
          T af = T(0), bf = T(0), ab = T(0), bb = T(0);
          for (int e = a.zone_ptr[gz]; e < a.zone_ptr[gz + 1]; ++e) {
            const int f = a.zone_faces[e];
            if (f & 1) {
              ab += s_haT[f];
              bb += s_ha[f];
            } else {
              af += s_haT[f];
              bf += s_ha[f];
            }
          }
          const T az = (a_ex[z] + af) + ab;
          const T bz = (b_ex[z] + bf) + bb;
          const T zt = s_zT[z];
          const T t_k = zt + T(kKelvin);
          const T c_z = a.zone_volume[gz] * (T(kRhoNum) / (T(kGasR) * t_k)) *
                        (T(kAirCp0) + T(kAirCp1) * t_k);
          const bool ok = m_abs(bz) > T(1e-9);
          const T safe_b = ok ? bz : T(1);
          const T em = m_expm1(-(safe_b * dt / c_z));
          s_zT[z] = ok ? zt - (az / safe_b - zt) * em : zt;
        }
        __syncthreads();
      }
    }

    // ---- end of hour: zone history and the non-finite count ----------------
    int cnt = 0;
    for (int i = 0; i < N; ++i)
      if (valid(i) && !is_finite(Tn[i])) ++cnt;
    for (int z = tid; z < ZB; z += SB) {
      const T zt = s_zT[z];
      a.zt_hist[(size_t)h * NB * ZB + b * ZB + z] = zt;
      if (!is_finite(zt)) ++cnt;
    }
    if (tid == 0) s_bad = 0;
    __syncthreads();
    if (cnt) atomicAdd(&s_bad, cnt);
    __syncthreads();
    if (tid == 0) a.bad[h * NB + b] = T(s_bad);
  }

  for (int i = 0; i < N; ++i) a.T_out[i * SP + lane] = Tn[i];
  a.hq[lane] = hf;
  a.hq[SP + lane] = hb;
  a.hq[2 * SP + lane] = qf;
  a.hq[3 * SP + lane] = qb;
  for (int z = tid; z < ZB; z += SB) a.zT_out[b * ZB + z] = s_zT[z];
}

template <typename T>
int launch(const DayArgs<T>& a, cudaStream_t stream) {
  if (a.N < 1 || a.N > kMaxNodes || a.SB < 1 || a.SB > kMaxLanes || a.NB < 1 ||
      a.ZB < 1 || a.hours < 1 || a.refresh_every < 1 || a.substeps % a.refresh_every)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * (static_cast<size_t>(a.ZB) + 4 * static_cast<size_t>(a.SB));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        day_march_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  day_march_kernel<T><<<a.NB, a.SB, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int day_march(const void* node, const void* surf, const void* lane, const void* zone_volume,
              const void* zone_ptr, const void* zone_faces, const void* t_out, const void* wind,
              const void* wdir, const void* sol_f, const void* sol_b, const void* ir_f,
              const void* ir_b, const void* a_extra, const void* b_extra, const void* T0,
              const void* zT0, void* T_out, void* zT_out, void* hq, void* zt_hist, void* bad,
              int N, int NB, int SB, int ZB, int hours, int substeps, int refresh_every,
              int amb_bug, double dt, double half_dt, double gamma_dt, double beta_dt,
              double c1, double c2, void* stream) {
  DayArgs<T> a;
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
  a.T_out = static_cast<T*>(T_out);
  a.zT_out = static_cast<T*>(zT_out);
  a.hq = static_cast<T*>(hq);
  a.zt_hist = static_cast<T*>(zt_hist);
  a.bad = static_cast<T*>(bad);
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
  return launch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define HEATX_DAY_MARCH_ARGS                                                              \
  const void *node, const void *surf, const void *lane, const void *zone_volume,          \
      const void *zone_ptr, const void *zone_faces, const void *t_out, const void *wind,  \
      const void *wdir, const void *sol_f, const void *sol_b, const void *ir_f,           \
      const void *ir_b, const void *a_extra, const void *b_extra, const void *T0,         \
      const void *zT0, void *T_out, void *zT_out, void *hq, void *zt_hist, void *bad,     \
      int N, int NB, int SB, int ZB, int hours, int substeps, int refresh_every,          \
      int amb_bug, double dt, double half_dt, double gamma_dt, double beta_dt, double c1, \
      double c2, void *stream
#define HEATX_DAY_MARCH_CALL                                                              \
  node, surf, lane, zone_volume, zone_ptr, zone_faces, t_out, wind, wdir, sol_f, sol_b,   \
      ir_f, ir_b, a_extra, b_extra, T0, zT0, T_out, zT_out, hq, zt_hist, bad, N, NB, SB,  \
      ZB, hours, substeps, refresh_every, amb_bug, dt, half_dt, gamma_dt, beta_dt, c1, c2, \
      stream

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
int heatx_day_march_f32(HEATX_DAY_MARCH_ARGS) { return day_march<float>(HEATX_DAY_MARCH_CALL); }
int heatx_day_march_f64(HEATX_DAY_MARCH_ARGS) { return day_march<double>(HEATX_DAY_MARCH_CALL); }

const char* heatx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
