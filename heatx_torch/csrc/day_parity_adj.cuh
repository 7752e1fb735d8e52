// Device code of the parity day adjoint with four threads per surface
// (day_adjoint_parity.cu has the kernel): the reverse of one face's film
// coefficient and operators as the parity march evaluates them
// (day_parity_rows.cuh parity_face_h / parity_face_ops: TARP with pow's cube
// root, the MIN_H floor decided on that same root) and of the forced term that
// both film evaluations of a sub-step share.  The plain statement of the
// reverse's row plan is tests/torch_parity_adj_rows_plain.py.
#pragma once

#include "day_parity_rows.cuh"
#include "day_tr_adj.cuh"

namespace heatx {

// Adjoint of natural_h: the cotangent lh of h pulled back to the air and
// surface temperatures and the two TARP branch coefficients.
template <typename T>
__device__ __forceinline__ void natural_h_adj(T lh, T air, T surf, T cos_eff, T c_same, T c_opp, T& l_air,
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

// The reverse of parity_face_h for face `back` at (air, surf): the film's
// cotangent l_h onto the air and surface temperatures (l_air, l_surf), the
// surface parameters (sg) and the forced term (lbase).
template <typename T>
__device__ __forceinline__ void parity_face_h_adj(const FaceStatics<T>& L, bool back, T air, T surf, T l_h,
                                                  SurfGrad<T>& sg, T& l_air, T& l_surf, T& lbase) {
  const T fix = back ? L.fix_hb : L.fix_hf;
  if (!is_nan(fix)) {  // a fixed h takes the whole cotangent
    sg.v[back ? SF_FIXHB : SF_FIXHF] += l_h;
    return;
  }
  lbase += (back ? L.b_out : L.f_out) ? l_h : T(0);
  const T cos_eff = (!back && L.f_out) ? -L.cos_t : L.cos_t;
  T l_same = T(0), l_opp = T(0);
  natural_h_adj(l_h, air, surf, cos_eff, L.c_same, L.c_opp, l_air, l_surf, l_same, l_opp);
  const T ac = m_abs(L.cos_t);
  sg.v[SF_COS] += (l_same * T(9.482) / ((T(7.238) - ac) * (T(7.238) - ac)) -
                   l_opp * T(1.81) / ((T(1.382) + ac) * (T(1.382) + ac))) *
                  m_sign(L.cos_t);
}

// The reverse of parity_face_ops for face `back` of lane L, given the
// cotangents of its film coefficient (l_h), linearized radiation coefficient
// (l_rc) and radiant temperature (l_rt).  The surface parameters' cotangents
// go to sg, a network face's effective emissivity's to d_me, the forced
// term's to lbase.
template <typename T, bool kMrt>
__device__ FaceCot<T> parity_face_ops_adj(const FaceStatics<T>& L, bool back, T ts_front, T ts_back, T t_front,
                                          T t_back, T rad_out, int amb_bug, T me, T tm, T l_h, T l_rc, T l_rt,
                                          SurfGrad<T>& sg, T& d_me, T& lbase) {
  FaceCot<T> c{T(0), T(0), T(0), T(0), T(0), T(0)};
  const bool quirk = back && L.b_amb && amb_bug;  // the ambient back face reads the front's
  const bool out = back ? L.b_out : L.f_out;
  const T surf = parity_face_surf(L, back, ts_front, ts_back, amb_bug);
  T rad = out ? rad_out : (back ? (L.b_amb ? (amb_bug ? t_front : t_back) : t_back) : t_front);
  T eps = back ? L.eps_b : L.eps_f;
  bool on = false;
  if constexpr (kMrt) {
    on = me > T(0);
    rad = on ? tm : rad;
    eps = on ? me : eps;
  }
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
  parity_face_h_adj(L, back, back ? t_back : t_front, surf, l_h, sg, l_air, l_surf, lbase);
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

// The reverse of FaceStatics::base, 2.537 W rf sqrt(P v / A), with the
// sub-step's sine and cosine of the wind direction.
template <typename T>
__device__ __forceinline__ void parity_base_adj(const FaceStatics<T>& L, T ws, T sin_wd, T cos_wd, T lbase,
                                                SurfGrad<T>& sg) {
  const T pva = L.perim * (ws * L.wmod) / L.area;
  if (!(pva > T(0))) return;
  const bool windward = m_abs(L.cos_t) >= T(0.98) || (L.nx * sin_wd + L.ny * cos_wd > T(0));
  const T wf = windward ? T(1) : T(0.5);
  const T sq = m_sqrt(pva);
  sg.v[SF_RF] += lbase * T(2.537) * wf * sq;
  const T lpva = lbase * T(2.537) * wf * L.rf / (T(2) * sq);
  sg.v[SF_PERIM] += lpva * (ws * L.wmod) / L.area;
  sg.v[SF_WMOD] += lpva * L.perim * ws / L.area;
  sg.v[SF_AREA] -= lpva * pva / L.area;
}

}  // namespace heatx
