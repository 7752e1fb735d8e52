// Device code of the reference-parity sub-step, shared by the day march
// (day_march.cu) and its adjoint (day_adjoint.cu): heatx `_hour_body`
// (heatx/ops/pallas_step.py:633) per surface lane.  One sub-step is
//   1. the TARP film coefficients and the linearized radiation of the state,
//   2. K (U couplings inside a chunk, every neighbour and the films on the
//      diagonal) and the forcing q (solar, the faces' convection and
//      radiation, the couplings across chunks as frozen sources),
//   3. the relaxed solve K x = -q(T) on the no-mass nodes, a fixed number of
//      iterations or the adaptive loop,
//   4. RK4 on the massive nodes with K and q(T) scaled row-wise by dt/C,
//   5. the film coefficients again on the new temperatures, with the same
//      forced-convection term: they enter the zone sums and h/q.
// On a lane with gas cavities U depends on the temperatures, so K and q are
// rebuilt at every no-mass iteration's input and at the post-no-mass column
// before RK4 (heatx march_nomass/march_massive with has_cavity); other lanes
// build K once per sub-step.
// A lane's chunks follow from its node masks: nodes i and i+1 share a chunk
// where bit i of the lane's chunk word is set, and a no-mass chunk is a
// maximal run of valid no-mass nodes joined that way.  The no-mass system is
// solved per thread with the Thomas sweeps over the identity-padded column
// (heatx picks a closed form for runs of at most 2 nodes and PCR or Thomas
// otherwise; all agree to rounding).  RK4 stage values are never flushed to
// zero: heatx's kernel path does not flush either.
//
// What bounds it: as for the TR-BDF2 sub-step, the per-thread chain of
// dependent operations, not bytes or the card's FLOP rate.  A sub-step reads
// K's three rows, the forcing and four RK4 work columns from per-thread local
// memory (1.4 KB of stack in f32), about twice a TR-BDF2 sub-step's work, and
// a day at the stability sub-step count has 15 times as many of them.
#pragma once

#include "day_common.cuh"

namespace heatx {

constexpr int LN_CHUNK = LN_MASS + 1;  // the lane row of the chunk words

// The no-mass iteration's and the march's parameters, in the working type.
// iters is the fixed iteration count, or -1 for the adaptive loop of at most
// max_iter iterations.
template <typename T>
struct ParityCfg {
  int iters, esc_after, max_iter;
  T tol, tol_esc, dt;
  __device__ explicit ParityCfg(const DayArgs<T>& a)
      : iters(a.nomass_iters), esc_after(a.esc_after), max_iter(a.nomass_max_iter),
        tol(T(a.nomass_tol)), tol_esc(T(a.nomass_tol_esc)), dt(T(a.dt)) {}
};

// The chunk structure of one lane.
template <typename T>
struct Chunks {
  const Lane<T>& L;
  unsigned cbits;
  __device__ Chunks(const DayArgs<T>& a, const Lane<T>& lane_ref, int lane)
      : L(lane_ref), cbits(static_cast<unsigned>(a.lane[LN_CHUNK * lane_ref.SP + lane])) {}
  __device__ bool massive(int i) const { return L.valid(i) && ((L.mass_bits >> i) & 1u); }
  __device__ bool sel(int i) const { return L.valid(i) && !((L.mass_bits >> i) & 1u); }
  __device__ bool joined(int i) const { return i >= 0 && ((cbits >> i) & 1u); }  // i with i+1
  __device__ bool coup_l(int i) const { return L.left(i) && joined(i - 1); }
  __device__ bool coup_r(int i) const { return L.right(i) && joined(i); }
  __device__ bool dir_l(int i) const { return L.left(i) && !joined(i - 1); }
  __device__ bool dir_r(int i) const { return L.right(i) && !joined(i); }
  // One past the last node of the no-mass run that starts at node i.
  __device__ int run_end(int i) const {
    int e = i + 1;
    while (e < L.N && sel(e) && joined(e - 1)) ++e;
    return e;
  }
  // dt / C on a massive node, 0 elsewhere.
  __device__ T scale(int i, T dt) const { return massive(i) ? dt / L.Cap[i * L.SP] : T(0); }
};

// Film coefficients of the state Tn (border_conditions), `base` the
// sub-step's forced-convection term.
template <typename T>
__device__ __forceinline__ void film(const Lane<T>& L, const FaceTemps<T>& ft, T t_front, T t_back,
                                     T base, T& hf, T& hb) {
  const T front_cos = L.f_out ? -L.cos_t : L.cos_t;
  hf = natural_h(t_front, ft.front_surf, front_cos, L.c_same, L.c_opp) + (L.f_out ? base : T(0));
  hb = natural_h(t_back, ft.back_surf_eff, L.cos_t, L.c_same, L.c_opp) + (L.b_out ? base : T(0));
  if (!is_nan(L.fix_hf)) hf = L.fix_hf;
  if (!is_nan(L.fix_hb)) hb = L.fix_hb;
}

// The sub-step's operators from its start state: films, linearized radiation
// and radiant temperatures (kMrt: toward the MRT context *m on a network
// face, as build_ops).
template <typename T, bool kMrt = false>
__device__ Ops<T> parity_ops(const Lane<T>& L, const T* Tn, T t_front, T t_back, T base,
                             const HourIn<T>& hi, int amb_bug, const MrtFace<T>* m = nullptr) {
  Ops<T> o;
  const FaceTemps<T> ft(L, Tn, t_front, t_back, hi, amb_bug);
  film(L, ft, t_front, t_back, base, o.hf, o.hb);
  T rad_f = ft.front_rad, rad_b = ft.back_rad, eps_f = L.eps_f, eps_b = L.eps_b;
  if constexpr (kMrt) rad_view(L, ft, *m, rad_f, rad_b, eps_f, eps_b);
  const T xf = T(kKelvin) + (rad_f + ft.front_surf) / T(2);
  const T xb = T(kKelvin) + (rad_b + ft.back_surf_eff) / T(2);
  o.radf = T(4) * eps_f * T(kSigma) * (xf * xf * xf);
  o.radb = T(4) * eps_b * T(kSigma) * (xb * xb * xb);
  o.rad_ft = rad_f;
  o.rad_bt = rad_b;
  return o;
}

// K's rows (assemble_K): couplings inside a chunk off the diagonal, every
// neighbour's U and the films on it.
template <typename T>
__device__ void parity_k_rows(const Chunks<T>& C, T hf, T hb, T* kl, T* kd, T* ku) {
  const Lane<T>& L = C.L;
  for (int i = 0; i < L.N; ++i) {
    const T ul = L.left(i) ? L.U[(i - 1) * L.SP] : T(0);
    const T ur = L.right(i) ? L.U[i * L.SP] : T(0);
    kd[i] = -(((ul + ur) + (L.first(i) ? hf : T(0))) + (L.last(i) ? hb : T(0)));
    kl[i] = C.coup_l(i) ? ul : T(0);
    ku[i] = C.coup_r(i) ? ur : T(0);
  }
}

// Node i's forcing at the working temperatures Tw (assemble_q).
template <typename T>
__device__ __forceinline__ T parity_q(const Chunks<T>& C, const Ops<T>& o, const HourIn<T>& hi,
                                      T t_front, T t_back, const T* Tw, int i) {
  const Lane<T>& L = C.L;
  T q = L.FA[i * L.SP] * hi.sol_f + L.FB[i * L.SP] * hi.sol_b;
  q += L.first(i) ? t_front * o.hf + o.radf * (o.rad_ft - Tw[i]) : T(0);
  q += L.last(i) ? t_back * o.hb + o.radb * (o.rad_bt - Tw[i]) : T(0);
  q += C.dir_l(i) ? L.U[(i - 1) * L.SP] * Tw[i - 1] : T(0);
  q += C.dir_r(i) ? L.U[i * L.SP] * Tw[i + 1] : T(0);
  return q;
}

// K's rows of a cavity lane at the working temperatures Tw: the cavity
// U-values first.
template <typename T>
__device__ __forceinline__ void cavity_k_rows(const Chunks<T>& C, const Ops<T>& o, const T* Tw,
                                              T* kl, T* kd, T* ku) {
  cavity_refresh(C.L, Tw);
  parity_k_rows(C, o.hf, o.hb, kl, kd, ku);
}

// Thomas factors of the no-mass system: K's rows on no-mass nodes, identity
// rows elsewhere.
template <typename T>
__device__ void nomass_factor(const Chunks<T>& C, const T* kl, const T* kd, const T* ku, T* cs,
                              T* inv) {
  for (int i = 0; i < C.L.N; ++i) {
    const bool s = C.sel(i);
    const T d = s ? kd[i] : T(1);
    const T iv = T(1) / ((i == 0 || !s) ? d : d - kl[i] * cs[i - 1]);
    inv[i] = iv;
    cs[i] = s ? ku[i] * iv : T(0);
  }
}

// Ts = M^{-1} rhs(Tw): rhs = -q(Tw) on no-mass nodes, Tw elsewhere.
template <typename T>
__device__ void nomass_solve(const Chunks<T>& C, const Ops<T>& o, const HourIn<T>& hi, T t_front,
                             T t_back, const T* kl, const T* cs, const T* inv, const T* Tw,
                             T* Ts) {
  const int N = C.L.N;
  for (int i = 0; i < N; ++i) {
    const bool s = C.sel(i);
    const T rhs = s ? -parity_q(C, o, hi, t_front, t_back, Tw, i) : Tw[i];
    Ts[i] = ((i == 0 || !s) ? rhs : rhs - kl[i] * Ts[i - 1]) * inv[i];
  }
  for (int i = N - 2; i >= 0; --i) Ts[i] = Ts[i] - cs[i] * Ts[i + 1];
}

// Per-run state of the masked no-mass iteration, kept at each run's first
// node: the last accepted error, the count of iterations it stayed active
// and whether it still is (act has a bit only at runs' first nodes, so it is
// 0 once every run has stopped).
template <typename T>
struct NomassState {
  T oerr[kMaxNodes];
  int cnt[kMaxNodes];
  unsigned act;
  __device__ void init(const Chunks<T>& C) {
    act = 0u;
    for (int i = 0; i < C.L.N; ++i) {
      oerr[i] = T(99999.0);
      cnt[i] = 0;
      if (C.sel(i) && !(i > 0 && C.sel(i - 1) && C.joined(i - 1))) act |= 1u << i;
    }
  }
};

// One masked iteration (march_nomass `body`): given Ts = solve(Tw), relax the
// runs that are active and whose error did not grow (an increasing update is
// discarded), test convergence on the mean error with the escalating
// tolerance.  Returns the bits of the nodes it updates; `apply` false leaves
// Tw and the state as they were (the adjoint asks which nodes an iteration
// moved).
template <typename T>
__device__ unsigned nomass_step(const Chunks<T>& C, const ParityCfg<T>& pc, NomassState<T>& st,
                                T* Tw, const T* Ts, bool apply = true) {
  unsigned upd = 0u;
  const int N = C.L.N;
  for (int i = 0; i < N;) {
    if (!C.sel(i)) {
      ++i;
      continue;
    }
    const int e = C.run_end(i);
    T err = T(0);
    for (int m = i; m < e; ++m) {
      const T d = m_abs(Ts[m] - Tw[m]);
      err += d < T(1e-25) ? T(0) : d;
    }
    const bool active = (st.act >> i) & 1u;
    const bool increase = err > st.oerr[i];
    if (active && !increase)
      for (int m = i; m < e; ++m) upd |= 1u << m;
    if (apply) {
      if (active && !increase) {
        for (int m = i; m < e; ++m) Tw[m] = T(0.5) * (Tw[m] + Ts[m]);
        st.oerr[i] = err;
      }
      const T tol = st.cnt[i] < pc.esc_after ? pc.tol : pc.tol_esc;
      const bool converged = err / T(e - i) < tol;
      if (active && !increase && !converged)
        ++st.cnt[i];
      else
        st.act &= ~(1u << i);
    }
    i = e;
  }
  return upd;
}

// The no-mass march of one sub-step on Tn, in place.  w1..w3 are work
// columns.  One iteration is a relaxed solve on every no-mass node; K's rows
// (kl, kd, ku) are those of Tn, and a cavity lane rebuilds them at each later
// iteration's input.
//
// The adaptive loop (pc.iters == -1, heatx march_nomass's while_loop) stops
// when this lane's runs are all inactive or after pc.max_iter iterations.
// heatx stops when no run of the whole building is active, and that gives
// the same answer: an inactive run is never updated again (nomass_step
// relaxes only active runs) and its state does not move, so the iterations
// heatx runs after a lane's last run stopped leave the lane as it is; the
// cap counts iterations, which both forms run in step.  The loop holds no
// barrier: the block's barriers come after the surface march, which every
// thread reaches whatever its count.
template <typename T>
__device__ void march_nomass(const Chunks<T>& C, const ParityCfg<T>& pc, const Ops<T>& o,
                             const HourIn<T>& hi, T t_front, T t_back, T* kl, T* kd, T* ku, T* Tn,
                             T* cs, T* inv, T* Ts) {
  nomass_factor(C, kl, kd, ku, cs, inv);
  if (pc.iters == 1) {
    nomass_solve(C, o, hi, t_front, t_back, kl, cs, inv, Tn, Ts);
    for (int i = 0; i < C.L.N; ++i)
      if (C.sel(i)) Tn[i] = T(0.5) * (Tn[i] + Ts[i]);
    return;
  }
  NomassState<T> st;
  st.init(C);
  const bool adaptive = pc.iters < 0;
  const int n = adaptive ? pc.max_iter : pc.iters;
  for (int it = 0; it < n && (!adaptive || st.act); ++it) {
    if (it > 0 && C.L.cav_bits) {
      cavity_k_rows(C, o, Tn, kl, kd, ku);
      nomass_factor(C, kl, kd, ku, cs, inv);
    }
    nomass_solve(C, o, hi, t_front, t_back, kl, cs, inv, Tn, Ts);
    nomass_step(C, pc, st, Tn, Ts);
  }
}

// One RK4 stage: k = K' y + q' with K' = (dt/C) K row-wise, qs = (dt/C) q.
template <typename T>
__device__ __forceinline__ void rk4_stage(const Chunks<T>& C, T dt, const T* kl, const T* kd,
                                          const T* ku, const T* qs, const T* y, T* k) {
  const int N = C.L.N;
  for (int i = 0; i < N; ++i) {
    const T s = C.scale(i, dt);
    const T y_dn = i > 0 ? y[i - 1] : T(0);
    const T y_up = i + 1 < N ? y[i + 1] : T(0);
    k[i] = ((kd[i] * s) * y[i] + (kl[i] * s) * y_dn + (ku[i] * s) * y_up) + qs[i];
  }
}

// RK4 on the massive nodes of Tn (march_massive), in place; K and q(Tn) are
// frozen over the four stages, so the no-mass nodes and the couplings across
// chunks read frozen temperatures (a cavity lane first rebuilds K at Tn).
// qs, y, k, acc are work columns.
template <typename T>
__device__ void march_massive(const Chunks<T>& C, const ParityCfg<T>& pc, const Ops<T>& o,
                              const HourIn<T>& hi, T t_front, T t_back, T* kl, T* kd, T* ku, T* Tn,
                              T* qs, T* y, T* k, T* acc) {
  const int N = C.L.N;
  if (C.L.cav_bits) cavity_k_rows(C, o, Tn, kl, kd, ku);
  for (int i = 0; i < N; ++i)
    qs[i] = parity_q(C, o, hi, t_front, t_back, Tn, i) * C.scale(i, pc.dt);
  rk4_stage(C, pc.dt, kl, kd, ku, qs, Tn, k);
  for (int i = 0; i < N; ++i) {
    acc[i] = Tn[i] + k[i] / T(6);
    y[i] = Tn[i] + T(0.5) * k[i];
  }
  rk4_stage(C, pc.dt, kl, kd, ku, qs, y, k);
  for (int i = 0; i < N; ++i) {
    acc[i] += k[i] / T(3);
    y[i] = Tn[i] + T(0.5) * k[i];
  }
  rk4_stage(C, pc.dt, kl, kd, ku, qs, y, k);
  for (int i = 0; i < N; ++i) {
    acc[i] += k[i] / T(3);
    y[i] = Tn[i] + k[i];
  }
  rk4_stage(C, pc.dt, kl, kd, ku, qs, y, k);
  for (int i = 0; i < N; ++i)
    if (C.massive(i)) Tn[i] = acc[i] + k[i] / T(6);
}

// The work columns of one parity sub-step.
template <typename T>
struct ParityWork {
  T kl[kMaxNodes], kd[kMaxNodes], ku[kMaxNodes];
  T w1[kMaxNodes], w2[kMaxNodes], w3[kMaxNodes], w4[kMaxNodes];
};

// One parity sub-step of the lane's node column Tn, in place.  Returns the
// operators whose hf/hb are the films of the NEW temperatures (the ones the
// zone sums and h/q read).  kMrt: the radiation runs toward the MRT context
// *m of the sub-step's start state.
template <typename T, bool kMrt = false>
__device__ Ops<T> parity_substep(const Chunks<T>& C, const ParityCfg<T>& pc, const HourIn<T>& hi,
                                 T t_front, T t_back, T ws, T wd, int amb_bug, T* Tn,
                                 ParityWork<T>& W, const MrtFace<T>* m = nullptr) {
  const Lane<T>& L = C.L;
  const T base = forced_base(L, ws, wd);
  Ops<T> o = parity_ops<T, kMrt>(L, Tn, t_front, t_back, base, hi, amb_bug, m);
  if (L.cav_bits) cavity_refresh(L, Tn);
  parity_k_rows(C, o.hf, o.hb, W.kl, W.kd, W.ku);
  march_nomass(C, pc, o, hi, t_front, t_back, W.kl, W.kd, W.ku, Tn, W.w1, W.w2, W.w3);
  march_massive(C, pc, o, hi, t_front, t_back, W.kl, W.kd, W.ku, Tn, W.w1, W.w2, W.w3, W.w4);
  const FaceTemps<T> ft(L, Tn, t_front, t_back, hi, amb_bug);
  film(L, ft, t_front, t_back, base, o.hf, o.hb);
  return o;
}

}  // namespace heatx
