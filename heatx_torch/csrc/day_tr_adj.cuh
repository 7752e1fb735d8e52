// Device code of the TR-BDF2 day adjoint with four threads per surface
// (day_adjoint_tr.cu has the kernel): the transposed partitioned stage solve
// on the forward's factors, the reverse of one face's operator work
// (face_ops), and the reverse of the interior MRT fixed point with the faces
// split over the group (mrt_face_node).  The plain statement of the
// transposed solve is heatx_torch/ops/tridiag.py partition_solve_transposed.
#pragma once

#include "day_adjoint_args.cuh"
#include "day_tr.cuh"

namespace heatx {

// Solve M^T y = g on the PartFactors of M (PartFactors::solve, each step
// transposed and taken in reverse order): y holds the thread's rows of g in
// and of the solution out; ml the rows' lower coefficients, as solve takes.
//  * the interior rows' back-substitution x_j = D_j - A_j x_first - C_j x_last
//    sends their cotangents to the first and last rows;
//  * x = r / b of the reduced rows, then the PCR levels from the last to
//    the first, each row taking its neighbours' coefficients times their
//    cotangents (the level's shuffles in the opposite direction);
//  * the chunk's row 0 normalization, its backward sweep from the top down
//    and its forward sweep from the bottom up.
template <typename T, int G, int kM>
__device__ __forceinline__ void solve_transposed(const PartFactors<T, G, kM>& P, const Group<G>& g,
                                                 const T (&ml)[kM], T (&y)[kM]) {
  constexpr int M = kM, R = PartFactors<T, G, kM>::R;
  T lf = y[0], ll = y[M - 1];
#pragma unroll
  for (int j = 1; j < M - 1; ++j) {
    lf -= P.A[j] * y[j];
    ll -= P.C[j] * y[j];
  }
  T l0 = lf * P.ib[0], l1 = ll * P.ib[1];
#pragma unroll
  for (int k = R - 1; k >= 1; --k) {
    const int d = 1 << (k - 1);
    const T n0 = l0 + g.next(P.al[k][0] * l0, d, T(0)) + g.prev(P.ga[k][0] * l0, d, T(0));
    const T n1 = l1 + g.next(P.al[k][1] * l1, d, T(0)) + g.prev(P.ga[k][1] * l1, d, T(0));
    l0 = n0;
    l1 = n1;
  }
  {  // stride 1: first took (previous last, own last), last (own first, next first)
    const T n0 = l0 + P.al[0][1] * l1 + g.prev(P.ga[0][1] * l1, 1, T(0));
    const T n1 = l1 + P.ga[0][0] * l0 + g.next(P.al[0][0] * l0, 1, T(0));
    y[0] = n0;
    y[M - 1] = n1;
  }
  if (M >= 3) {
    y[1] = y[1] - P.cf[0] * P.einv * y[0];
    y[0] = y[0] * P.einv;
  }
#pragma unroll
  for (int j = 1; j <= M - 3; ++j) y[j + 1] = y[j + 1] - P.cf[j] * y[j];
#pragma unroll
  for (int j = M - 1; j >= 0; --j) {
    y[j] = y[j] * P.f[j];
    if (j >= 2) y[j - 1] = y[j - 1] - ml[j] * y[j];
  }
}

// Adjoint of natural_h_cbrt: the cotangent lh of h pulled back to the air and
// surface temperatures and the two TARP branch coefficients (the floor at
// MIN_H decided as the forward decides it, on the same cube root).
template <typename T>
__device__ __forceinline__ void natural_h_cbrt_adj(T lh, T air, T surf, T cos_eff, T c_same, T c_opp, T& l_air,
                                                   T& l_surf, T& l_same, T& l_opp) {
  const T dT = air - surf;
  const T adt = m_abs(dT);
  const T cb = m_cbrt(m_max(adt, T(1e-30)));
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
  const T lx = lp * coef / (T(3) * (cb * cb));  // d cbrt(x) / dx = x^(-2/3) / 3
  const T ldT = (adt >= T(1e-30) ? lx : T(0)) * m_sign(dT);
  l_air += ldT;
  l_surf -= ldT;
}

// Cotangents one face's reverse sends to the lane's temperatures: its
// surfaces (node 0, the last nodes), its boundary air temperatures, its
// outdoor radiant temperature, its MRT node.
template <typename T>
struct FaceCot {
  T l_fs, l_bs, l_tf, l_tb, l_rad_out, l_tm;
};

// The reverse of face_ops for face `back` of lane L, given the cotangents of
// its film coefficient (l_h), linearized radiation coefficient (l_rc) and
// radiant temperature (l_rt).  The surface parameters' cotangents go to sg,
// a network face's effective emissivity's to d_me.
template <typename T, bool kMrt>
__device__ FaceCot<T> face_ops_adj(const Lane<T>& L, bool back, T ts_front, T ts_back, T t_front, T t_back,
                                   T rad_out, T ws, T wd, int amb_bug, T me, T tm, T l_h, T l_rc, T l_rt,
                                   SurfGrad<T>& sg, T& d_me) {
  FaceCot<T> c{T(0), T(0), T(0), T(0), T(0), T(0)};
  const bool quirk = back && L.b_amb && amb_bug;  // the ambient back face reads the front's
  const bool out = back ? L.b_out : L.f_out;
  const T air = back ? t_back : t_front;
  const T surf = (back && !quirk) ? ts_back : ts_front;
  T rad = out ? rad_out : (back ? (L.b_amb ? (amb_bug ? t_front : t_back) : t_back) : t_front);
  T eps = back ? L.eps_b : L.eps_f;
  bool on = false;
  if constexpr (kMrt) {
    on = me > T(0);
    rad = on ? tm : rad;
    eps = on ? me : eps;
  }
  const T cos_eff = (!back && L.f_out) ? -L.cos_t : L.cos_t;
  // Linearized radiation 4 eps sigma x^3, x = K + (T_rad + T_s)/2.
  const T x = T(kKelvin) + (rad + surf) / T(2);
  const T l_eps = l_rc * T(4) * T(kSigma) * (x * x * x);
  if (on)
    d_me += l_eps;
  else
    sg.v[back ? SF_EPSB : SF_EPSF] += l_eps;
  const T lx = l_rc * T(12) * eps * T(kSigma) * (x * x);
  const T l_rad = l_rt + lx / T(2);
  T l_surf = lx / T(2), l_air = T(0);
  // Film coefficient: a fixed h takes the whole cotangent.
  const T fix = back ? L.fix_hb : L.fix_hf;
  const T lh = is_nan(fix) ? l_h : T(0);
  if (!is_nan(fix)) sg.v[back ? SF_FIXHB : SF_FIXHF] += l_h;
  // Forced part 2.537 W rf sqrt(P v / A) on an outdoor face.
  const T pva = L.perim * (ws * L.wmod) / L.area;
  if (out && pva > T(0)) {
    const T wf = L.windward(wd) ? T(1) : T(0.5);
    const T sq = m_sqrt(pva);
    sg.v[SF_RF] += lh * T(2.537) * wf * sq;
    const T lpva = lh * T(2.537) * wf * L.rf / (T(2) * sq);
    sg.v[SF_PERIM] += lpva * (ws * L.wmod) / L.area;
    sg.v[SF_WMOD] += lpva * L.perim * ws / L.area;
    sg.v[SF_AREA] -= lpva * pva / L.area;
  }
  // Natural part, and the TARP coefficients' dependence on |cos|.
  T l_same = T(0), l_opp = T(0);
  natural_h_cbrt_adj(lh, air, surf, cos_eff, L.c_same, L.c_opp, l_air, l_surf, l_same, l_opp);
  const T ac = m_abs(L.cos_t);
  sg.v[SF_COS] += (l_same * T(9.482) / ((T(7.238) - ac) * (T(7.238) - ac)) -
                   l_opp * T(1.81) / ((T(1.382) + ac) * (T(1.382) + ac))) *
                  m_sign(L.cos_t);
  // Radiant temperature: the MRT node, outdoor IR, else the boundary air
  // (the ambient back face's quirk reads the front's).
  if (on)
    c.l_tm = l_rad;
  else if (out)
    c.l_rad_out = l_rad;
  else if (back && !(L.b_amb && amb_bug))
    c.l_tb = l_rad;
  else
    c.l_tf = l_rad;
  if (back)
    c.l_tb += l_air;
  else
    c.l_tf += l_air;
  if (back && !quirk)
    c.l_bs = l_surf;
  else
    c.l_fs = l_surf;
  return c;
}

// Zone z's sum of a per-face row over its network faces, in list order (the
// block's lists in shared memory, as mrt_face_node reads them).
template <typename T, typename R>
__device__ __forceinline__ T mrt_face_sum_shared(const int* s_mptr, const int* s_mf, int z, const T* s_face,
                                                 R rd) {
  T s = T(0);
  for (int e = s_mptr[z]; e < s_mptr[z + 1]; ++e) s += rd.face(s_face, s_mf[e]);
  return s;
}

// The reverse of mrt_face_node from its history hist[4] (the node before each
// iteration) for the face each thread follows: l_tm is the cotangent of the
// face's final node (its writer's; `writer` and `on` as mrt_face_node).  Adds
// the cotangents of the face temperature ts (l_ts), its effective emissivity
// (l_eps) and the area (l_area), and returns that of the start tm0 (the
// face's boundary air temperature); s_lzf[z] accumulates the zone row's (the
// fallback's).  The transpose of a face's gather of its zone's node is the
// zone's sum over its network faces, the transpose of the zone sums a
// per-face read of the zone's cotangents: a thread per zone, in list order.
// Every thread of the block calls it.  Shared rows: s_w/s_wt/s_lt [2*SB],
// s_lnum/s_lden/s_lm [ZB].  `cc` is the block's CTAs (day_cluster.cuh).
template <typename T, typename R>
__device__ T mrt_face_node_adj(int ZB, const int* s_mptr, const int* s_mf, int tid, int nthreads, bool writer,
                               bool on, int slot, int zone, T eps, T area, T ts, const T* hist, T l_tm, T& l_ts,
                               T& l_eps, T& l_area, T* s_w, T* s_wt, T* s_lt, T* s_lnum, T* s_lden, T* s_lm,
                               T* s_lzf, R cc) {
  const bool mine = writer && on;
  if (mine) s_lt[slot] = l_tm;
  cc.sync();
  for (int z = tid; z < ZB; z += nthreads) s_lm[z] = mrt_face_sum_shared(s_mptr, s_mf, z, s_lt, cc);
  T l_t0 = T(0);
  for (int it = 3; it >= 0; --it) {
    if (mine) {
      const T w = mrt_weight(eps, area, hist[it], ts);
      s_w[slot] = w;
      s_wt[slot] = w * ts;
    }
    cc.sync();
    for (int z = tid; z < ZB; z += nthreads) {
      T num, den;
      mrt_sums_shared(s_mptr, s_mf, z, -1, s_wt, s_w, num, den, cc);
      const T lm = s_lm[z];
      if (den > T(1e-30)) {
        s_lnum[z] = lm / den;
        s_lden[z] = -lm * (num / den) / den;
      } else {
        s_lnum[z] = s_lden[z] = T(0);
        s_lzf[z] += lm;
      }
    }
    cc.sync();
    T lf = T(0);
    if (mine) lf = mrt_face_adj(eps, area, hist[it], ts, s_lnum[zone], s_lden[zone], l_ts, l_eps, l_area);
    if (it > 0) {
      if (mine) s_lt[slot] = lf;
      cc.sync();
      for (int z = tid; z < ZB; z += nthreads) s_lm[z] = mrt_face_sum_shared(s_mptr, s_mf, z, s_lt, cc);
    } else {
      l_t0 = lf;
    }
  }
  return l_t0;
}

}  // namespace heatx
