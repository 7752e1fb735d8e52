// The day adjoints for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes; see heatx_torch/ops/day_adjoint.py): the C entry for
// both, and the reference-parity body.
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
// The TR-BDF2 body (day_adjoint_tr.cu, day_adjoint_tr_mrt.cu; device code in
// day_tr_adj.cuh) runs four threads per surface on the forward kernel's own
// device code; the C entry below hands it every trbdf2 / trbdf2_refresh
// launch.

#include <type_traits>

#include "day_adjoint_args.cuh"
#include "day_common.cuh"
#include "day_parity.cuh"

// The kMrt instantiations live in their own compilation unit
// (day_adjoint_mrt.cu, which includes this file), as the day march's do
// (day_march_tr_mrt.cu, day_march_parity_mrt.cu): launched through the kMrt
// unit's function, which takes its MrtAdjArgs by address.  The TR-BDF2 body's
// units are entered the same way.
extern "C" int heatx_day_adjoint_mrt_f32(const void* g, void* stream);
extern "C" int heatx_day_adjoint_mrt_f64(const void* g, void* stream);
extern "C" int heatx_day_adjoint_tr_f32(const void* g, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_tr_f64(const void* g, void* stream, int* block_threads);

namespace {

using namespace heatx;

// Cotangents of one sub-step's operators (films, linearized radiation,
// radiant temperatures).
template <typename T>
struct OpsGrad {
  T hf, hb, radf, radb, rad_ft, rad_bt;
};

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

// ---------------------------------------------------------------------------
// The reference-parity adjoint (heatx `_hour_body(unroll=True)` under jax.vjp,
// pallas_adjoint.py:573-592), by hand as the transpose of day_parity.cuh.
//
// At the stability sub-step count (118 per hour on the bench city) an hour of
// sub-step states does not fit a per-thread tape, so the hour's re-march
// writes each sub-step's START column to a workspace in device memory
// ([substeps, N, SP], allocated by the wrapper, reused hour after hour) and
// the reverse sweep reloads one column per sub-step, recomputes that
// sub-step's intermediates (the post-no-mass column and the four RK4 stages)
// in the thread and transposes them:
//  * the second film evaluation (on the new temperatures), whose h enters the
//    zone sums;
//  * RK4: four transposed mat-vecs with the frozen scaled K, the band
//    cotangent of every stage, the dt/C scale's cotangent onto the mass;
//  * the forcing q at the post-no-mass column: solar fractions and channels,
//    the faces' sources, the Dirichlet couplings across chunks (U and the
//    frozen neighbour);
//  * the relaxed no-mass iterations, last to first: each is re-marched from
//    the sub-step start to learn which runs it updated (the update, increase
//    and convergence masks are piecewise constant and carry no cotangent),
//    then transposed: a transposed Thomas solve on the same factors, the
//    band cotangent -y x^T, and q again;
//  * K's band onto U and the films, then the first film evaluation with the
//    linearized radiation (the same chain as the TR-BDF2 operator build) and
//    the forced-convection term shared by both film evaluations;
//  * on a cavity lane K and q are rebuilt at each no-mass iteration's input
//    and at the post-no-mass column, so each of those instances turns its
//    own band and Dirichlet cotangents into U's at once and sends the cavity
//    segments' share through dU/dT into its own input column (the lane's
//    day accumulator of a cavity segment's seg_u cotangent is scratch,
//    emptied after each instance, and written out as 0).
// Zone coupling, thermostat, mixing and the end-of-hour outputs are the
// TR-BDF2 adjoint's (day_adjoint_tr.cu), one thread per zone.

// The lane's parameter cotangents: the day's node rows and surface rows, the
// hour's channel sums.
template <typename T>
struct LaneGrad {
  T dU[kMaxNodes], dCap[kMaxNodes], dFA[kMaxNodes], dFB[kMaxNodes];
  SurfGrad<T> sg;
  T l_sol_f, l_sol_b, l_rad_out_f, l_rad_out_b;
};

// Adjoint of parity_ops / film on the state Tg: the cotangents og of the
// films (and, from the first evaluation, of the radiation coefficients and
// radiant temperatures) onto the state (lT), the boundary temperatures, the
// surface parameters and the hour's radiant channels; the forced term's share
// goes to lbase.  kMrt: a network face's radiant temperature and emissivity
// are the MRT context *m's, and their cotangents go to *mc (the zone node's
// at the face and the effective emissivity's) instead of the boundary and
// eps_front/back.
template <typename T, bool kMrt = false>
__device__ void film_rad_adj(const Lane<T>& L, const T* Tg, T tf0, T tb0, const HourIn<T>& hi,
                             int amb_bug, const OpsGrad<T>& og, LaneGrad<T>& G, T* lT, T& lt_f,
                             T& lt_b, T& lbase, const MrtFace<T>* m = nullptr,
                             MrtFace<T>* mc = nullptr) {
  SurfGrad<T>& sg = G.sg;
  const FaceTemps<T> ft(L, Tg, tf0, tb0, hi, amb_bug);
  T rad_f = ft.front_rad, rad_b = ft.back_rad, eps_f = L.eps_f, eps_b = L.eps_b;
  bool on_f = false, on_b = false;
  if constexpr (kMrt) {
    rad_view(L, ft, *m, rad_f, rad_b, eps_f, eps_b);
    on_f = m->ef > T(0);
    on_b = m->eb > T(0);
  }
  const T xf = T(kKelvin) + (rad_f + ft.front_surf) / T(2);
  const T xb = T(kKelvin) + (rad_b + ft.back_surf_eff) / T(2);
  const T l_epsf = og.radf * T(4) * T(kSigma) * (xf * xf * xf);
  const T l_epsb = og.radb * T(4) * T(kSigma) * (xb * xb * xb);
  if (kMrt && on_f)
    mc->ef += l_epsf;
  else
    sg.v[SF_EPSF] += l_epsf;
  if (kMrt && on_b)
    mc->eb += l_epsb;
  else
    sg.v[SF_EPSB] += l_epsb;
  const T lxf = og.radf * T(12) * eps_f * T(kSigma) * (xf * xf);
  const T lxb = og.radb * T(12) * eps_b * T(kSigma) * (xb * xb);
  T l_frad = og.rad_ft + lxf / T(2), l_fs = lxf / T(2);
  T l_brad = og.rad_bt + lxb / T(2), l_bse = lxb / T(2);
  // Film coefficients: a fixed h takes the whole cotangent.
  const T lhf = is_nan(L.fix_hf) ? og.hf : T(0);
  const T lhb = is_nan(L.fix_hb) ? og.hb : T(0);
  if (!is_nan(L.fix_hf)) sg.v[SF_FIXHF] += og.hf;
  if (!is_nan(L.fix_hb)) sg.v[SF_FIXHB] += og.hb;
  lbase += (L.f_out ? lhf : T(0)) + (L.b_out ? lhb : T(0));
  // Natural part, and the TARP coefficients' dependence on |cos|.
  T l_tf = T(0), l_tb = T(0), l_same = T(0), l_opp = T(0);
  const T front_cos = L.f_out ? -L.cos_t : L.cos_t;
  natural_h_adj(lhf, tf0, ft.front_surf, front_cos, L.c_same, L.c_opp, l_tf, l_fs, l_same, l_opp);
  natural_h_adj(lhb, tb0, ft.back_surf_eff, L.cos_t, L.c_same, L.c_opp, l_tb, l_bse, l_same,
                l_opp);
  const T ac = m_abs(L.cos_t);
  sg.v[SF_COS] += (l_same * T(9.482) / ((T(7.238) - ac) * (T(7.238) - ac)) -
                   l_opp * T(1.81) / ((T(1.382) + ac) * (T(1.382) + ac))) *
                  m_sign(L.cos_t);
  // Radiant temperatures: outdoor IR, else the boundary air (the ambient-back
  // quirk reads the front's); a network face's is its zone's MRT node.
  if (kMrt && on_f)
    mc->tmf += l_frad;
  else if (L.f_out)
    G.l_rad_out_f += l_frad;
  else
    l_tf += l_frad;
  if (kMrt && on_b)
    mc->tmb += l_brad;
  else if (L.b_out)
    G.l_rad_out_b += l_brad;
  else if (L.b_amb && amb_bug)
    l_tf += l_brad;
  else
    l_tb += l_brad;
  // Surface temperatures: node 0 and the last node (the quirk again).
  T l_bs = T(0);
  if (L.b_amb && amb_bug)
    l_fs += l_bse;
  else
    l_bs += l_bse;
  lT[0] += l_fs;
  for (int n = 0; n < L.N; ++n)
    if (L.last(n)) lT[n] += l_bs;
  lt_f += l_tf;
  lt_b += l_tb;
}

// Adjoint of forced_base: 2.537 W rf sqrt(P v / A).
template <typename T>
__device__ void forced_base_adj(const Lane<T>& L, T ws, T wd, T lbase, SurfGrad<T>& sg) {
  const T pva = L.perim * (ws * L.wmod) / L.area;
  if (!(pva > T(0))) return;
  const T wf = L.windward(wd) ? T(1) : T(0.5);
  const T sq = m_sqrt(pva);
  sg.v[SF_RF] += lbase * T(2.537) * wf * sq;
  const T lpva = lbase * T(2.537) * wf * L.rf / (T(2) * sq);
  sg.v[SF_PERIM] += lpva * (ws * L.wmod) / L.area;
  sg.v[SF_WMOD] += lpva * L.perim * ws / L.area;
  sg.v[SF_AREA] -= lpva * pva / L.area;
}

// Adjoint of parity_q over the column: lq (cotangent of q at the working
// temperatures Tw) onto Tw (lT), the operators, the boundary temperatures, U
// and the solar fractions and channels.
template <typename T>
__device__ void parity_q_adj(const Chunks<T>& C, const Ops<T>& o, const HourIn<T>& hi, T tf, T tb,
                             const T* Tw, const T* lq, T* lT, OpsGrad<T>& og, LaneGrad<T>& G,
                             T& lt_f, T& lt_b) {
  const Lane<T>& L = C.L;
  for (int n = 0; n < L.N; ++n) {
    const T l = lq[n];
    if (!L.valid(n) || l == T(0)) continue;
    G.dFA[n] += l * hi.sol_f;
    G.dFB[n] += l * hi.sol_b;
    G.l_sol_f += l * L.FA[n * L.SP];
    G.l_sol_b += l * L.FB[n * L.SP];
    if (L.first(n)) {
      lt_f += l * o.hf;
      og.hf += l * tf;
      og.radf += l * (o.rad_ft - Tw[n]);
      og.rad_ft += l * o.radf;
      lT[n] -= l * o.radf;
    }
    if (L.last(n)) {
      lt_b += l * o.hb;
      og.hb += l * tb;
      og.radb += l * (o.rad_bt - Tw[n]);
      og.rad_bt += l * o.radb;
      lT[n] -= l * o.radb;
    }
    if (C.dir_l(n)) {
      G.dU[n - 1] += l * Tw[n - 1];
      lT[n - 1] += l * L.U[(n - 1) * L.SP];
    }
    if (C.dir_r(n)) {
      G.dU[n] += l * Tw[n + 1];
      lT[n + 1] += l * L.U[n * L.SP];
    }
  }
}

// The films' share of one K instance's band cotangent.
template <typename T>
struct FilmCot {
  T hf, hb;
};

// One K instance of a cavity lane, backwards (parity): its band cotangent
// (gKl, gKd, gKu, emptied here) onto U (dU) and the films (returned), then
// each cavity segment's U cotangent, its Dirichlet share already in dU[s],
// through dU/dT into lT at that instance's working column Tw; dU[s] is
// emptied again.  cav is the lane's column of the cavity operands; bits,
// cbits the node and chunk words.
template <typename T>
__device__ __noinline__ FilmCot<T> cavity_band_adj(const T* cav, int N, int SP, unsigned bits,
                                                   unsigned cbits, unsigned cav_bits, const T* Tw,
                                                   T* gKl, T* gKd, T* gKu, T* lT, T* dU) {
  auto valid = [&](int i) { return i >= 0 && i < N && ((bits >> i) & 1u); };
  auto joined = [&](int i) { return i >= 0 && ((cbits >> i) & 1u); };
  FilmCot<T> f{T(0), T(0)};
  for (int n = 0; n < N; ++n) {
    if (!valid(n)) continue;
    const T gd = gKd[n];
    if (valid(n - 1)) dU[n - 1] += (joined(n - 1) ? gKl[n] : T(0)) - gd;
    if (valid(n + 1)) dU[n] += (joined(n) ? gKu[n] : T(0)) - gd;
    if (!valid(n - 1)) f.hf -= gd;
    if (!valid(n + 1)) f.hb -= gd;
  }
  for (int n = 0; n < N; ++n) gKl[n] = gKd[n] = gKu[n] = T(0);
  const size_t ns = static_cast<size_t>(N) * SP;
  for (int s = 0; s + 1 < N; ++s) {
    if (!((cav_bits >> s) & 1u)) continue;
    T d_f, d_b;
    cavity_u(cav + s * SP, ns, Tw[s], Tw[s + 1], &d_f, &d_b);
    lT[s] += dU[s] * d_f;
    lT[s + 1] += dU[s] * d_b;
    dU[s] = T(0);
  }
  return f;
}

// A cavity lane's K instance at Tw, backwards, into og.
template <typename T>
__device__ __forceinline__ void cavity_instance_adj(const Chunks<T>& C, const T* Tw, T* gKl,
                                                    T* gKd, T* gKu, T* lT, T* dU, OpsGrad<T>& og) {
  const Lane<T>& L = C.L;
  const FilmCot<T> f =
      cavity_band_adj(L.Cav, L.N, L.SP, L.bits, C.cbits, L.cav_bits, Tw, gKl, gKd, gKu, lT, dU);
  og.hf += f.hf;
  og.hb += f.hb;
}

// The columns the reverse of one parity sub-step works on.
template <typename T>
struct ParityTape {
  T kl[kMaxNodes], kd[kMaxNodes], ku[kMaxNodes];  // K's rows
  T Tm[kMaxNodes];                                // the post-no-mass column
  T k[4][kMaxNodes];                              // the RK4 stages
  T gKl[kMaxNodes], gKd[kMaxNodes], gKu[kMaxNodes];  // K's band cotangent
  T lq[kMaxNodes], g[kMaxNodes], y[kMaxNodes];
  T cs[kMaxNodes], inv[kMaxNodes], Tw[kMaxNodes], Ts[kMaxNodes];
};

// Adjoint of march_massive at the post-no-mass column P.Tm with the stages
// P.k: lT holds the new column's cotangent in and Tm's out (q's share is left
// in P.lq); the band cotangent goes to P.gK*, the dt/C scale's to the mass.
template <typename T>
__device__ void march_massive_adj(const Chunks<T>& C, T dt, ParityTape<T>& P, T* lT,
                                  LaneGrad<T>& G) {
  const Lane<T>& L = C.L;
  const int N = L.N;
  const T wts[4] = {T(1) / T(6), T(1) / T(3), T(1) / T(3), T(1) / T(6)};
  const T cin[4] = {T(0), T(0.5), T(0.5), T(1)};  // y_s = Tm + cin[s] k_{s-1}
  for (int n = 0; n < N; ++n) {
    P.Tw[n] = C.massive(n) ? lT[n] : T(0);  // the output cotangent on the marched rows
    P.lq[n] = T(0);
    P.Ts[n] = T(0);  // the later stage's input cotangent
  }
  for (int s = 3; s >= 0; --s) {
    for (int n = 0; n < N; ++n) {
      const T lk = wts[s] * P.Tw[n] + (s < 3 ? cin[s + 1] * P.Ts[n] : T(0));
      P.g[n] = C.scale(n, dt) * lk;
      P.lq[n] += P.g[n];
      if (C.massive(n)) G.dCap[n] -= lk * P.k[s][n] / L.Cap[n * L.SP];
      P.y[n] = s == 0 ? P.Tm[n] : P.Tm[n] + cin[s] * P.k[s - 1][n];
    }
    for (int n = 0; n < N; ++n) {
      const T gn = P.g[n];
      P.gKd[n] += gn * P.y[n];
      if (n > 0) P.gKl[n] += gn * P.y[n - 1];
      if (n + 1 < N) P.gKu[n] += gn * P.y[n + 1];
      const T ly = P.kd[n] * gn + (n + 1 < N ? P.kl[n + 1] * P.g[n + 1] : T(0)) +
                   (n > 0 ? P.ku[n - 1] * P.g[n - 1] : T(0));  // (K^T g)[n]
      lT[n] += ly;
      P.Ts[n] = ly;
    }
  }
}

// Solve M^T y = g on the no-mass system's Thomas factors (nomass_factor).
template <typename T>
__device__ void nomass_solve_transposed(const Chunks<T>& C, const T* kl, const T* cs, const T* inv,
                                        const T* g, T* y) {
  const int N = C.L.N;
  y[0] = g[0];
  for (int i = 1; i < N; ++i) y[i] = g[i] - cs[i - 1] * y[i - 1];
  y[N - 1] *= inv[N - 1];
  for (int i = N - 2; i >= 0; --i)
    y[i] = (y[i] - (C.sel(i + 1) ? kl[i + 1] : T(0)) * y[i + 1]) * inv[i];
}

// A cavity lane's no-mass K rows and factors at the iteration input P.Tw.
template <typename T>
__device__ __forceinline__ void cavity_nomass_factor(const Chunks<T>& C, const Ops<T>& o,
                                                     ParityTape<T>& P) {
  cavity_k_rows(C, o, P.Tw, P.kl, P.kd, P.ku);
  nomass_factor(C, P.kl, P.kd, P.ku, P.cs, P.inv);
}

// Adjoint of march_nomass from the sub-step's start column T0: lT holds the
// post-no-mass column's cotangent in and the start column's out.
template <typename T>
__device__ void march_nomass_adj(const Chunks<T>& C, const ParityCfg<T>& pc, const Ops<T>& o,
                                 const HourIn<T>& hi, T tf, T tb, const T* T0, ParityTape<T>& P,
                                 T* lT, OpsGrad<T>& og, LaneGrad<T>& G, T& lt_f, T& lt_b) {
  const int N = C.L.N;
  nomass_factor(C, P.kl, P.kd, P.ku, P.cs, P.inv);
  for (int j = pc.iters - 1; j >= 0; --j) {
    // Iteration j's input column, its solve and the nodes it updated.
    // (A cavity lane factors each iteration's own K, at its input.)
    for (int n = 0; n < N; ++n) P.Tw[n] = T0[n];
    unsigned upd = 0u;
    if (pc.iters == 1) {
      if (C.L.cav_bits) cavity_nomass_factor(C, o, P);
      nomass_solve(C, o, hi, tf, tb, P.kl, P.cs, P.inv, P.Tw, P.Ts);
      for (int n = 0; n < N; ++n)
        if (C.sel(n)) upd |= 1u << n;
    } else {
      NomassState<T> st;
      st.init(C);
      for (int jj = 0; jj < j; ++jj) {
        if (C.L.cav_bits) cavity_nomass_factor(C, o, P);
        nomass_solve(C, o, hi, tf, tb, P.kl, P.cs, P.inv, P.Tw, P.Ts);
        nomass_step(C, pc, st, P.Tw, P.Ts);
      }
      if (C.L.cav_bits) cavity_nomass_factor(C, o, P);
      nomass_solve(C, o, hi, tf, tb, P.kl, P.cs, P.inv, P.Tw, P.Ts);
      upd = nomass_step(C, pc, st, P.Tw, P.Ts, false);
    }
    if (!upd) continue;
    // T' = where(upd, (T + Ts)/2, T), Ts = M^{-1} rhs(T).
    for (int n = 0; n < N; ++n) {
      const bool u = (upd >> n) & 1u;
      P.g[n] = u ? T(0.5) * lT[n] : T(0);
      if (u) lT[n] = T(0.5) * lT[n];
    }
    nomass_solve_transposed(C, P.kl, P.cs, P.inv, P.g, P.y);
    for (int n = 0; n < N; ++n) {
      const T yn = P.y[n];
      if (C.sel(n)) {  // rhs = -q(T); the band cotangent is -y x^T
        P.gKd[n] -= yn * P.Ts[n];
        if (n > 0) P.gKl[n] -= yn * P.Ts[n - 1];
        if (n + 1 < N) P.gKu[n] -= yn * P.Ts[n + 1];
        P.lq[n] = -yn;
      } else {  // rhs = T
        lT[n] += yn;
        P.lq[n] = T(0);
      }
    }
    parity_q_adj(C, o, hi, tf, tb, P.Tw, P.lq, lT, og, G, lt_f, lt_b);
    if (C.L.cav_bits) cavity_instance_adj(C, P.Tw, P.gKl, P.gKd, P.gKu, lT, G.dU, og);
  }
}

// The reverse of one parity sub-step of the lane.  Ts is the sub-step's start
// column, (tf, tb) its boundary temperatures, (la_f, lb_f, la_b, lb_b) the
// cotangents of the a_z/b_z sums of the zones its faces bound (0 where
// none).  lT holds the new column's cotangent in and the start column's out;
// lt_f/lt_b return the boundary temperatures' cotangents.  kMrt: the
// sub-step's radiation runs toward the MRT context *m of its start state,
// and the cotangents of m's zone nodes and effective emissivities come out in
// *mc (the network's own reverse is the caller's: it is block-wide).
template <typename T, bool kMrt = false>
__device__ void parity_substep_adj(const Chunks<T>& C, const ParityCfg<T>& pc,
                                   const HourIn<T>& hi, const T* Ts, T tf, T tb, T ws, T wd,
                                   int amb_bug, T la_f, T lb_f, T la_b, T lb_b, ParityTape<T>& P,
                                   T* lT, LaneGrad<T>& G, T& lt_f, T& lt_b,
                                   const MrtFace<T>* m = nullptr, MrtFace<T>* mc = nullptr) {
  const Lane<T>& L = C.L;
  const int N = L.N;
  // ---- the sub-step forward, keeping Tm and the stages --------------------
  const T base = forced_base(L, ws, wd);
  const Ops<T> o = parity_ops<T, kMrt>(L, Ts, tf, tb, base, hi, amb_bug, m);
  if (L.cav_bits) cavity_refresh(L, Ts);
  parity_k_rows(C, o.hf, o.hb, P.kl, P.kd, P.ku);
  for (int n = 0; n < N; ++n) P.Tm[n] = Ts[n];
  march_nomass(C, pc, o, hi, tf, tb, P.kl, P.kd, P.ku, P.Tm, P.cs, P.inv, P.Ts);
  T* Tnew = P.Tw;  // the new column, until the no-mass adjoint reuses the work columns
  if (L.cav_bits) cavity_k_rows(C, o, P.Tm, P.kl, P.kd, P.ku);  // RK4's K
  {
    T* qs = P.lq;
    for (int n = 0; n < N; ++n)
      qs[n] = parity_q(C, o, hi, tf, tb, P.Tm, n) * C.scale(n, pc.dt);
    rk4_stage(C, pc.dt, P.kl, P.kd, P.ku, qs, P.Tm, P.k[0]);
    for (int n = 0; n < N; ++n) P.y[n] = P.Tm[n] + T(0.5) * P.k[0][n];
    rk4_stage(C, pc.dt, P.kl, P.kd, P.ku, qs, P.y, P.k[1]);
    for (int n = 0; n < N; ++n) P.y[n] = P.Tm[n] + T(0.5) * P.k[1][n];
    rk4_stage(C, pc.dt, P.kl, P.kd, P.ku, qs, P.y, P.k[2]);
    for (int n = 0; n < N; ++n) P.y[n] = P.Tm[n] + P.k[2][n];
    rk4_stage(C, pc.dt, P.kl, P.kd, P.ku, qs, P.y, P.k[3]);
    for (int n = 0; n < N; ++n)
      Tnew[n] = C.massive(n) ? (((P.Tm[n] + P.k[0][n] / T(6)) + P.k[1][n] / T(3)) +
                                P.k[2][n] / T(3)) + P.k[3][n] / T(6)
                             : P.Tm[n];
  }
  T hf2, hb2;
  {
    const FaceTemps<T> ft2(L, Tnew, tf, tb, hi, amb_bug);
    film(L, ft2, tf, tb, base, hf2, hb2);
  }

  // ---- backwards ----------------------------------------------------------
  lt_f = lt_b = T(0);
  T lbase = T(0);
  // Zone sums: a_z += h A T_s, b_z += h A with the new column's films.
  OpsGrad<T> og2{T(0), T(0), T(0), T(0), T(0), T(0)};
  if (L.zone_f >= 0) {
    lT[0] += la_f * (hf2 * L.area);
    const T lha = la_f * Tnew[0] + lb_f;
    og2.hf += lha * L.area;
    G.sg.v[SF_AREA] += lha * hf2;
  }
  if (L.zone_b >= 0) {
    const T hab = hb2 * L.area;
    for (int n = 0; n < N; ++n)
      if (L.last(n)) lT[n] += la_b * hab;
    const T lha = la_b * L.last_node(Tnew) + lb_b;
    og2.hb += lha * L.area;
    G.sg.v[SF_AREA] += lha * hb2;
  }
  film_rad_adj(L, Tnew, tf, tb, hi, amb_bug, og2, G, lT, lt_f, lt_b, lbase);
  // RK4, the forcing at Tm, the no-mass iterations.
  for (int n = 0; n < N; ++n) P.gKl[n] = P.gKd[n] = P.gKu[n] = T(0);
  OpsGrad<T> og{T(0), T(0), T(0), T(0), T(0), T(0)};
  march_massive_adj(C, pc.dt, P, lT, G);
  parity_q_adj(C, o, hi, tf, tb, P.Tm, P.lq, lT, og, G, lt_f, lt_b);
  if (L.cav_bits) cavity_instance_adj(C, P.Tm, P.gKl, P.gKd, P.gKu, lT, G.dU, og);
  march_nomass_adj(C, pc, o, hi, tf, tb, Ts, P, lT, og, G, lt_f, lt_b);
  // K's band -> U and the films (a cavity lane's band is already empty).
  for (int n = 0; n < N; ++n) {
    if (!L.valid(n)) continue;
    const T gd = P.gKd[n];
    if (L.left(n)) G.dU[n - 1] += (C.coup_l(n) ? P.gKl[n] : T(0)) - gd;
    if (L.right(n)) G.dU[n] += (C.coup_r(n) ? P.gKu[n] : T(0)) - gd;
    if (L.first(n)) og.hf -= gd;
    if (L.last(n)) og.hb -= gd;
  }
  film_rad_adj<T, kMrt>(L, Ts, tf, tb, hi, amb_bug, og, G, lT, lt_f, lt_b, lbase, m, mc);
  forced_base_adj(L, ws, wd, lbase, G.sg);
}

template <typename T, bool kExt, bool kCav, bool kMrt>
__global__ void __launch_bounds__(kMaxLanes) day_parity_adjoint_kernel(const AdjArgsOf<T, kMrt> g) {
  const DayArgs<T>& a = g.in;
  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB;
  const int sub = a.substeps;
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
  T* s_tm = s_dsc + ZB;                      // kMrt: [ZB] the zones' MRT nodes
  T* s_lnum = s_tm + ZB;                     // kMrt: [ZB] cotangents of a zone's network sums
  T* s_lden = s_lnum + ZB;
  T* s_lm = s_lden + ZB;                     // kMrt: [ZB] cotangent of a zone's MRT node
  T* s_lzf = s_lm + ZB;                      // kMrt: [ZB] the network's fallback cotangent

  const Lane<T> L(a, lane, kCav);
  MrtLane<T> M;  // kMrt: launched with MRT physics only
  if constexpr (kMrt) M = MrtLane<T>(a, g.net, lane);
  const Chunks<T> C(a, L, lane);
  const ParityCfg<T> pc(a);
  T Tn[kMaxNodes];

  // March hour h from (Tn, s_zT); with `tape`, write each sub-step's start
  // column to the workspace and the zone rows and sums to shared memory.
  auto march_hour = [&](int h, bool tape) {
    const HourIn<T> hi(a, h, lane);
    const T* a_ex = a.a_extra + (size_t)h * NB * ZB + b * ZB;
    const T* b_ex = a.b_extra + (size_t)h * NB * ZB + b * ZB;
    ParityWork<T> W;
    for (int i = 0; i < sub; ++i) {
      const int w = h * sub + i;
      if (tape) {
        for (int n = 0; n < N; ++n) g.sub_ws[((size_t)i * N + n) * SP + lane] = Tn[n];
      }
      for (int z = tid; z < ZB; z += SB) s_zt[i * ZB + z] = s_zT[z];
      T t_front, t_back;
      L.boundary(s_zT, a.t_out[w], t_front, t_back);
      Ops<T> o;
      if constexpr (kMrt) {  // the network of the sub-step's start state
        const MrtFace<T> mf = mrt_context(a, g.net, L, M, b, tid, Tn, t_front, t_back, s_zT, s_ha, s_haT, s_tm);
        o = parity_substep<T, true>(C, pc, hi, t_front, t_back, a.wind[w], a.wdir[w], a.amb_bug, Tn, W,
                                    &mf);
      } else {
        o = parity_substep(C, pc, hi, t_front, t_back, a.wind[w], a.wdir[w], a.amb_bug, Tn, W);
      }
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
        // Mixing reads the sub-step-start row s_zt[i], which no thread writes
        // here, so s_zT updates in place.
        if (kExt && a.mix_ptr) mix_sums(a, gz, s_zt + i * ZB, az, bz);
        s_az[i * ZB + z] = az;
        s_bz[i * ZB + z] = bz;
        if (kExt && a.ctl) {
          T load;
          s_zT[z] = zone_update_ctl(s_zT[z], az, bz, a.zone_volume[gz], pc.dt,
                                    Setpoints<T>(a, h, gz), load);
        } else {
          s_zT[z] = zone_update(s_zT[z], az, bz, a.zone_volume[gz], pc.dt);
        }
      }
      __syncthreads();
    }
  };

  // ---- pass 1: march the day, storing each hour's start state -------------
  for (int n = 0; n < N; ++n) Tn[n] = a.T0[n * SP + lane];
  for (int z = tid; z < ZB; z += SB) s_zT[z] = a.zT0[b * ZB + z];
  __syncthreads();
  for (int h = 0; h < a.hours; ++h) {
    for (int n = 0; n < N; ++n) g.T_ws[((size_t)h * N + n) * SP + lane] = Tn[n];
    for (int z = tid; z < ZB; z += SB) g.zT_ws[(size_t)h * NB * ZB + b * ZB + z] = s_zT[z];
    march_hour(h, false);
  }

  // ---- pass 2: the hours backwards ----------------------------------------
  T lT[kMaxNodes];
  LaneGrad<T> G;
  for (int f = 0; f < SF_NX; ++f) G.sg.v[f] = T(0);
  for (int n = 0; n < N; ++n) {
    lT[n] = g.dT[n * SP + lane];
    G.dU[n] = G.dCap[n] = G.dFA[n] = G.dFB[n] = T(0);
  }
  for (int z = tid; z < ZB; z += SB) {
    s_lz[z] = g.d_zT[b * ZB + z];
    s_dV[z] = T(0);
    if (kExt) s_dsh[z] = s_dsc[z] = T(0);
    if constexpr (kMrt) s_lzf[z] = T(0);
  }
  T d_mef = T(0), d_meb = T(0);  // kMrt: the effective emissivities' cotangents (day)

  for (int h = a.hours - 1; h >= 0; --h) {
    for (int n = 0; n < N; ++n) Tn[n] = g.T_ws[((size_t)h * N + n) * SP + lane];
    for (int z = tid; z < ZB; z += SB) {
      s_zT[z] = g.zT_ws[(size_t)h * NB * ZB + b * ZB + z];
      s_lz[z] += g.d_zt_hist[(size_t)h * NB * ZB + b * ZB + z];
      s_da[z] = s_db[z] = T(0);
      // The hour's load is the mean over its sub-steps.
      if (kExt && a.ctl) s_lld[z] = g.d_ld_hist[(size_t)h * NB * ZB + b * ZB + z] / T(sub);
    }
    __syncthreads();
    march_hour(h, true);

    const HourIn<T> hi(a, h, lane);
    G.l_sol_f = G.l_sol_b = G.l_rad_out_f = G.l_rad_out_b = T(0);
    for (int i = sub - 1; i >= 0; --i) {
      // (a) zone update, one thread per zone.
      for (int z = tid; z < ZB; z += SB) {
        const int gz = b * ZB + z;
        T laz, lbz, lzt, lvol;
        if (kExt && a.ctl) {
          T l_heat, l_cool;
          zone_update_ctl_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z],
                              a.zone_volume[gz], pc.dt, Setpoints<T>(a, h, gz), s_lz[z], s_lld[z],
                              laz, lbz, lzt, lvol, l_heat, l_cool);
          s_dsh[z] += l_heat;
          s_dsc[z] += l_cool;
        } else {
          zone_update_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z], a.zone_volume[gz],
                          pc.dt, s_lz[z], laz, lbz, lzt, lvol);
        }
        s_laz[z] = laz;
        s_lbz[z] = lbz;
        s_lz[z] = lzt;
        s_dV[z] += lvol;
        s_da[z] += laz;
        s_db[z] += lbz;
      }
      __syncthreads();

      // (b) the lane's sub-step, backwards, from its start column.
      {
        ParityTape<T> P;
        for (int n = 0; n < N; ++n) Tn[n] = g.sub_ws[((size_t)i * N + n) * SP + lane];
        const int w = h * sub + i;
        T tf, tb, lt_f, lt_b;
        L.boundary(s_zt + i * ZB, a.t_out[w], tf, tb);
        const bool zf = L.zone_f >= 0, zb = L.zone_b >= 0;
        if constexpr (kMrt) {
          // The sub-step's network from its start column, the sub-step
          // backwards on it, then the network backwards.
          T hist_f[4], hist_b[4];
          const MrtFace<T> mf = mrt_context(a, g.net, L, M, b, tid, Tn, tf, tb, s_zt + i * ZB, s_ha, s_haT,
                                            s_tm, hist_f, hist_b);
          MrtFace<T> mc{T(0), T(0), T(0), T(0)};
          parity_substep_adj<T, true>(C, pc, hi, Tn, tf, tb, a.wind[w], a.wdir[w], a.amb_bug,
                                      zf ? s_laz[L.zone_f] : T(0), zf ? s_lbz[L.zone_f] : T(0),
                                      zb ? s_laz[L.zone_b] : T(0), zb ? s_lbz[L.zone_b] : T(0), P,
                                      lT, G, lt_f, lt_b, &mf, &mc);
          d_mef += mc.ef;
          d_meb += mc.eb;
          T l_fs = T(0), l_bs = T(0), l_t0f = T(0), l_t0b = T(0), l_area = T(0);
          mrt_network_adj(a, g.net, L, M, b, tid, Tn[0], L.last_node(Tn), hist_f, hist_b, mc.tmf, mc.tmb,
                          l_fs, l_bs, l_t0f, l_t0b, d_mef, d_meb, l_area, s_ha, s_haT, s_lt, s_lnum,
                          s_lden, s_lm, s_lzf);
          lT[0] += l_fs;
          for (int n = 0; n < N; ++n)
            if (L.last(n)) lT[n] += l_bs;
          lt_f += l_t0f;
          lt_b += l_t0b;
          G.sg.v[SF_AREA] += l_area;
        } else {
          parity_substep_adj(C, pc, hi, Tn, tf, tb, a.wind[w], a.wdir[w], a.amb_bug,
                             zf ? s_laz[L.zone_f] : T(0), zf ? s_lbz[L.zone_f] : T(0),
                             zb ? s_laz[L.zone_b] : T(0), zb ? s_lbz[L.zone_b] : T(0), P, lT, G,
                             lt_f, lt_b);
        }
        // Boundary temperatures: zone air (summed per zone below), the fixed
        // ambient/ground temperature, or outdoor air (not differentiated).
        s_lt[2 * tid] = L.code_f == kSpace ? lt_f : T(0);
        s_lt[2 * tid + 1] = L.code_b == kSpace ? lt_b : T(0);
        if (L.code_f != kSpace && !L.f_out) G.sg.v[SF_TEMPF] += lt_f;
        if (L.code_b != kSpace && !L.b_out) G.sg.v[SF_TEMPB] += lt_b;
      }
      __syncthreads();

      // (c) the faces' boundary cotangents into their zones.
      for (int z = tid; z < ZB; z += SB) {
        const int gz = b * ZB + z;
        s_lz[z] += face_sum(a.zone_ptr, a.zone_faces, gz, s_lt);
        if constexpr (kMrt) {  // the network's fallback onto the zone row
          s_lz[z] += s_lzf[z];
          s_lzf[z] = T(0);
        }
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

    // ---- end of hour: the channel and gain cotangents ----------------------
    const T sfr = a.sol_f[h * SP + lane], sbr = a.sol_b[h * SP + lane];
    const T irf = a.ir_f[h * SP + lane], irb = a.ir_b[h * SP + lane];
    T* dc = g.d_chan + (size_t)h * SP + lane;
    const size_t row = (size_t)a.hours * SP;
    dc[0] = (is_nan(sfr) || sfr < T(0)) ? T(0) : G.l_sol_f;
    dc[row] = is_nan(sbr) ? T(0) : G.l_sol_b;
    dc[2 * row] = irf >= T(1e-30)
                      ? G.l_rad_out_f * T(0.25) * m_pow(irf / T(kSigma), T(-0.75)) / T(kSigma)
                      : T(0);
    dc[3 * row] = irb >= T(1e-30)
                      ? G.l_rad_out_b * T(0.25) * m_pow(irb / T(kSigma), T(-0.75)) / T(kSigma)
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
    g.d_node[(ND_U * N + n) * SP + lane] = ((L.cav_bits >> n) & 1u) ? T(0) : G.dU[n];
    g.d_node[(ND_CAP * N + n) * SP + lane] = ((L.mass_bits >> n) & 1u) ? G.dCap[n] : T(0);
    g.d_node[(ND_FA * N + n) * SP + lane] = G.dFA[n];
    g.d_node[(ND_FB * N + n) * SP + lane] = G.dFB[n];
  }
  for (int f = 0; f < SF_COUNT; ++f) g.d_surf[f * SP + lane] = f < SF_NX ? G.sg.v[f] : T(0);
  if constexpr (kMrt) {
    g.d_mrt[lane] = d_mef;
    g.d_mrt[SP + lane] = d_meb;
  }
  for (int z = tid; z < ZB; z += SB) {
    g.d_zT0[b * ZB + z] = s_lz[z];
    g.d_zv[b * ZB + z] = s_dV[z];
    if (kExt && a.ctl) {  // the compiled rows (0 where the march was scheduled)
      g.d_ctl[b * ZB + z] = s_dsh[z];
      g.d_ctl[NB * ZB + b * ZB + z] = s_dsc[z];
    }
  }
}

template <typename T, bool kExt, bool kCav = false, bool kMrt = false>
int launch_parity(const AdjArgsOf<T, kMrt>& g, cudaStream_t stream) {
  const DayArgs<T>& a = g.in;
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(a.ZB) * (3 * a.substeps + (kExt ? 11 : 8) + (kMrt ? 5 : 0)) +
                   6 * static_cast<size_t>(a.SB));
  const auto kernel = day_parity_adjoint_kernel<T, kExt, kCav, kMrt>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.NB, a.SB, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

#ifndef HEATX_DAY_ADJOINT_KMRT_UNIT
template <typename T>
int launch(const MrtAdjArgs<T>& g, cudaStream_t stream, int* block_threads) {
  const DayArgs<T>& a = g.in;
  if (a.N < 1 || a.N > kMaxNodes || a.SB < 1 || a.SB > kMaxLanes || a.NB < 1 || a.ZB < 1 ||
      a.hours < 1 || a.refresh_every < 1 || a.substeps % a.refresh_every)
    return static_cast<int>(cudaErrorInvalidValue);
  // The parity march rebuilds its operators every sub-step and tapes an hour
  // of sub-step starts in its workspace; the TR-BDF2 body tapes an hour of
  // sub-step states in its own.
  if (a.parity ? (a.refresh_every != 1 || a.nomass_iters < 0 || g.sub_ws == nullptr) : g.tape == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // Thermostat rows come with the load cotangent and the rows' output;
  // schedule rows with theirs; mixing with both groupings of its entries.
  const bool ctl = a.ctl != nullptr, sched = a.sp_heat != nullptr;
  if (ctl != (g.d_ld_hist != nullptr) || ctl != (g.d_ctl != nullptr) || (sched && !ctl) ||
      sched != (a.sp_cool != nullptr) || sched != (g.d_sp_heat != nullptr) ||
      sched != (g.d_sp_cool != nullptr) || (a.mix_ptr != nullptr) != (a.mixt_ptr != nullptr) ||
      (a.cav != nullptr) != (a.cav_u != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // MRT physics comes with the network's operands and its cotangents' output.
  const bool mrt = g.net.phys != 0;
  if (mrt != (g.net.mrt != nullptr) || mrt != (g.d_mrt != nullptr) || (mrt && !g.net.mrt_ptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // The TR-BDF2 body picks its kind in its own units.  Parity: free-float
  // buildings run the instantiation without the extra zone code; buildings
  // with gas cavities the extended one with the cavity code (kCav); MRT
  // physics the extended ones with the network (kMrt).
  if (!a.parity)
    return std::is_same_v<T, float> ? heatx_day_adjoint_tr_f32(&g, stream, block_threads)
                                    : heatx_day_adjoint_tr_f64(&g, stream, block_threads);
  const bool ext = ctl || a.mix_ptr;
  if (mrt)
    return std::is_same_v<T, float> ? heatx_day_adjoint_mrt_f32(&g, stream)
                                    : heatx_day_adjoint_mrt_f64(&g, stream);
  if (a.cav) return launch_parity<T, true, true>(g, stream);
  return ext ? launch_parity<T, true>(g, stream) : launch_parity<T, false>(g, stream);
}

constexpr int kPointers = 51;

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
  g.sub_ws = static_cast<T*>(p[i++]);
  a.cav_u = static_cast<T*>(p[i++]);
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
  a.nomass_tol = reals[6];
  a.nomass_tol_esc = reals[7];
  return launch<T>(g, static_cast<cudaStream_t>(stream), block_threads);
}
#else
// The kMrt unit: the parity body with MRT physics, with the cavity code
// where the building has gas cavities (kMrt implies kExt).
template <typename T>
int day_adjoint_mrt(const void* args, void* stream) {
  const MrtAdjArgs<T>& g = *static_cast<const MrtAdjArgs<T>*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return g.in.cav ? launch_parity<T, true, true, true>(g, st) : launch_parity<T, true, false, true>(g, st);
}
#endif

}  // namespace

#ifdef HEATX_DAY_ADJOINT_KMRT_UNIT
int heatx_day_adjoint_mrt_f32(const void* g, void* stream) { return day_adjoint_mrt<float>(g, stream); }
int heatx_day_adjoint_mrt_f64(const void* g, void* stream) { return day_adjoint_mrt<double>(g, stream); }
#else

extern "C" {

// Launch on `stream`.  `ptrs` holds the 51 device pointers in the order of
// DayAdjointKernel (operands, cotangents, workspace, outputs, then the
// thermostat, schedule and mixing operands and outputs, null where the
// building has none, the parity march's sub-step workspace, the
// gas-cavity U row and operands, the MRT network's operands and its
// cotangents' output, and last the TR-BDF2 body's tape workspace), `ints`
// N, NB, SB, ZB, hours, substeps, refresh_every, amb_bug, parity,
// nomass_iters, esc_after, mrt_phys, `reals` dt, gamma dt/2, gamma dt, beta dt, c1, c2,
// nomass_tol, nomass_tol_esc.  Writes the threads of a block of the launch
// variant a TR-BDF2 launch ran in to *block_threads (0 for the parity body).
// Returns cudaGetLastError() of the launch.
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
#endif
