// The C entry of every day-march launch for NVIDIA Hopper (sm_90a), bound
// through a plain C interface (ctypes; see heatx_torch/ops/day_march.py): it
// fills the launch's arguments, checks them, and hands the launch to the
// kernel of its mode, picking the launch variant from the block's lanes
// (launch_variant, day_march_args.cuh; the same table for both kernels) and
// writing back the threads a block of it runs.  The TR-BDF2 modes (trbdf2,
// trbdf2_refresh) run in day_march_tr.cu (and day_march_tr_mrt.cu), parity in
// day_march_parity.cu (and day_march_parity_mrt.cu); both replace
// heatx/ops/pallas_step.py::make_hour_march -> `kernel` (the pl.pallas_call at
// pallas_step.py:1976), and their notes say how.

#include <type_traits>

#include "day_common.cuh"
#include "day_march_args.cuh"

extern "C" int heatx_day_march_tr_f32(const void* m, void* stream);
extern "C" int heatx_day_march_tr_f64(const void* m, void* stream);
extern "C" int heatx_day_march_parity_f32(const void* m, void* stream);
extern "C" int heatx_day_march_parity_f64(const void* m, void* stream);

namespace {

using namespace heatx;

template <typename T>
int check_args(const MarchArgs<T>& m) {
  const DayArgs<T>& a = m.in;
  if (a.N < 1 || a.N > kMaxNodes || a.SB < 1 || a.SB > kMaxLanes || a.NB < 1 ||
      a.ZB < 1 || a.hours < 1 || a.refresh_every < 1 || a.substeps % a.refresh_every)
    return static_cast<int>(cudaErrorInvalidValue);
  // The parity march rebuilds its operators every sub-step; nomass_iters -1
  // is the adaptive loop, capped at nomass_max_iter iterations.
  if (a.parity && (a.refresh_every != 1 || a.nomass_iters < -1 ||
                   (a.nomass_iters < 0 && a.nomass_max_iter < 1)))
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

template <typename T>
int day_march(const void* node, const void* surf, const void* lane, const void* zone_volume,
              const void* zone_ptr, const void* zone_faces, const void* t_out, const void* wind,
              const void* wdir, const void* sol_f, const void* sol_b, const void* ir_f,
              const void* ir_b, const void* a_extra, const void* b_extra, const void* T0,
              const void* zT0, void* T_out, void* zT_out, void* hq, void* zt_hist, void* bad,
              void* ld_hist, const void* ctl, const void* sp_heat, const void* sp_cool,
              const void* mix_ptr, const void* mix_src, const void* mix_vol, const void* cav,
              const void* mrt, const void* mrt_ptr, const void* mrt_faces, void* hq_hist, void* top,
              const void* shade_slot, const void* shade, const void* shade_sp, const void* vent,
              const void* a_vent, const void* b_vent, const void* vent_thr, int N,
              int NB, int SB, int ZB, int hours, int substeps, int refresh_every, int amb_bug,
              int parity, int nomass_iters, int esc_after, int nomass_max_iter, int mrt_phys,
              double dt, double half_dt, double gamma_dt, double beta_dt, double c1, double c2,
              double nomass_tol, double nomass_tol_esc, int* block_threads, void* stream) {
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
  a.nomass_max_iter = nomass_max_iter;
  a.nomass_tol = nomass_tol;
  a.nomass_tol_esc = nomass_tol_esc;
  const int err = check_args<T>(m);
  if (err) return err;
  // MRT physics and the histories take the network operands (an empty face
  // list may come as a null pointer: it is never read).
  if ((mrt_phys || m.top || m.hq_hist) && !(m.net.mrt && m.net.mrt_ptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // The launch variant that takes the block's lanes (both kernels' table).
  const int v = launch_variant(SB);
  if (v < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (block_threads) *block_threads = kLaunchVariants[v].threads;
  if (parity)
    return std::is_same_v<T, float> ? heatx_day_march_parity_f32(&m, stream)
                                    : heatx_day_march_parity_f64(&m, stream);
  return std::is_same_v<T, float> ? heatx_day_march_tr_f32(&m, stream) : heatx_day_march_tr_f64(&m, stream);
}

}  // namespace


#define HEATX_DAY_MARCH_ARGS                                                               \
  const void *node, const void *surf, const void *lane, const void *zone_volume,           \
      const void *zone_ptr, const void *zone_faces, const void *t_out, const void *wind,   \
      const void *wdir, const void *sol_f, const void *sol_b, const void *ir_f,            \
      const void *ir_b, const void *a_extra, const void *b_extra, const void *T0,          \
      const void *zT0, void *T_out, void *zT_out, void *hq, void *zt_hist, void *bad,      \
      void *ld_hist, const void *ctl, const void *sp_heat, const void *sp_cool,            \
      const void *mix_ptr, const void *mix_src, const void *mix_vol, const void *cav,  \
      const void *mrt, const void *mrt_ptr, const void *mrt_faces, void *hq_hist, void *top,  \
      const void *shade_slot, const void *shade, const void *shade_sp, const void *vent,  \
      const void *a_vent, const void *b_vent, const void *vent_thr, int N,                 \
      int NB, int SB, int ZB, int hours, int substeps, int refresh_every, int amb_bug,     \
      int parity, int nomass_iters, int esc_after, int nomass_max_iter, int mrt_phys,      \
      double dt, double half_dt, double gamma_dt, double beta_dt, double c1, double c2,   \
      double nomass_tol, double nomass_tol_esc, int *block_threads, void *stream
#define HEATX_DAY_MARCH_CALL                                                               \
  node, surf, lane, zone_volume, zone_ptr, zone_faces, t_out, wind, wdir, sol_f, sol_b,    \
      ir_f, ir_b, a_extra, b_extra, T0, zT0, T_out, zT_out, hq, zt_hist, bad, ld_hist,     \
      ctl, sp_heat, sp_cool, mix_ptr, mix_src, mix_vol, cav, mrt, mrt_ptr, mrt_faces, \
      hq_hist, top, shade_slot, shade, shade_sp, vent, a_vent, b_vent, vent_thr, N, NB, SB, ZB, hours, \
      substeps, refresh_every, amb_bug, parity, nomass_iters, esc_after, nomass_max_iter,  \
      mrt_phys, dt, half_dt, gamma_dt, beta_dt, c1, c2, nomass_tol, nomass_tol_esc, block_threads, stream

extern "C" {

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok) and
// writes the threads of a block of the variant that ran to *block_threads.
int heatx_day_march_f32(HEATX_DAY_MARCH_ARGS) { return day_march<float>(HEATX_DAY_MARCH_CALL); }
int heatx_day_march_f64(HEATX_DAY_MARCH_ARGS) { return day_march<double>(HEATX_DAY_MARCH_CALL); }

const char* heatx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
