// Device code of the TR-BDF2 day march with several threads per surface
// (day_march_tr.cu has the kernel): a surface's thread group and its shuffles,
// the partitioned tridiagonal factorization and solve, the per-face operator
// work, and the interior MRT fixed point with the faces split over the group.
// The plain statement of the solve is heatx_torch/ops/tridiag.py
// (partition_factor, partition_solve).
#pragma once

#include "day_common.cuh"

namespace heatx {

__host__ __device__ constexpr int ilog2(int g) { return g <= 1 ? 0 : 1 + ilog2(g / 2); }

__device__ __forceinline__ float m_cbrt(float x) { return cbrtf(x); }
__device__ __forceinline__ double m_cbrt(double x) { return cbrt(x); }

// TARP natural convection (natural_h) with the cube root as cbrt: the same
// function, rounded differently from pow(x, 1/3) in the last place.
template <typename T>
__device__ __forceinline__ T natural_h_cbrt(T air, T surf, T cos_eff, T c_same, T c_opp) {
  const T dT = air - surf;
  const T adt = m_abs(dT);
  const T cbrt_dt = m_cbrt(m_max(adt, T(1e-30)));
  const bool near_zero = (adt < T(1e-3)) || (m_abs(cos_eff) < T(1e-3));
  const T coef = near_zero ? T(1.31) : (dT * cos_eff > T(0) ? c_same : c_opp);
  return m_max(coef * cbrt_dt, T(kMinH));
}

// The warp's threads that belong to the block (a block's last warp may be
// partial when its thread count is not a multiple of 32).
__device__ __forceinline__ unsigned block_warp_mask() {
  const int left = static_cast<int>(blockDim.x) - static_cast<int>(threadIdx.x & ~31u);
  return left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
}

// One surface's G threads: a G-wide segment of a warp.  Every thread of the
// block reaches every shuffle (no shuffle sits under a branch that splits a
// warp), so the warp's mask is the block's part of it.
template <int G>
struct Group {
  unsigned mask;
  int rank;  // this thread's chunk of the column: rows [rank*M, rank*M + M)

  // v of the group's thread `src`.
  template <typename T>
  __device__ __forceinline__ T from(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  // v of the thread d ranks before (fill for the first d ranks).
  template <typename T>
  __device__ __forceinline__ T prev(T v, int d, T fill) const {
    const T u = __shfl_up_sync(mask, v, d, G);
    return rank >= d ? u : fill;
  }
  // v of the thread d ranks after (fill for the last d ranks).
  template <typename T>
  __device__ __forceinline__ T next(T v, int d, T fill) const {
    const T u = __shfl_down_sync(mask, v, d, G);
    return rank + d < G ? u : fill;
  }
  // The group's sum of v, the same bits on every thread (each butterfly step
  // adds two operands that its partner adds in the other order).
  template <typename T>
  __device__ __forceinline__ T sum(T v) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);
    return v;
  }
};

// One reduced-system PCR level on one row: the neighbours' reciprocal
// diagonals and (a, c) come in as up/dn, the new (b, a, c) and the level's
// elimination coefficients go out.  Multiplying by the neighbours'
// reciprocals (each row's own, shuffled) keeps the couplings, often exactly
// 0 on identity rows, out of a division's operand checks, whose slow path a
// whole warp would take for one such lane.
template <typename T>
__device__ __forceinline__ void pcr_level(T& b, T& a, T& c, T ru, T au, T cu, T rd, T ad, T cd,
                                          T& al, T& ga) {
  al = -a * ru;
  ga = -c * rd;
  b = b + al * cu + ga * ad;
  a = al * au;
  c = ga * cd;
}

// The partitioned factorization of one surface's stage matrix, a thread's
// share: its M = kMaxNodes/G rows eliminated locally (a forward sweep, a
// backward sweep, row 0 against row 1) until each interior row reads
// x_j + A_j x_first + C_j x_last = D_j, then the reduced system of the
// group's 2G first and last rows (first_0, last_0, first_1, ...) factored by
// parallel cyclic reduction across the group, log2(G) + 1 levels with the
// neighbours' rows by shuffle.  Identity rows (md 1, ml = mu = 0) stay
// identity rows.  factor() runs at each operator build; solve() in both
// stages of every sub-step of the refresh group.
template <typename T, int G>
struct PartFactors {
  static constexpr int M = kMaxNodes / G;
  static constexpr int R = ilog2(G) + 1;
  static_assert(M >= 2, "the reduced system takes two rows per thread");
  T f[M];        // the forward sweep's pivot reciprocals
  T cf[M];       // its upper coefficients (the backward sweep reads rows 0..M-3)
  T A[M], C[M];  // interior rows' couplings to the chunk's first and last rows
  T einv;        // row 0's normalization once it took row 1 out (M >= 3)
  T al[R][2], ga[R][2];
  T ib[2];       // the reduced rows' reciprocal diagonals

  __device__ __forceinline__ void factor(const Group<G>& g, const T (&ml)[M], const T (&md)[M],
                                         const T (&mu)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j < 2) {
        f[j] = T(1) / md[j];
        A[j] = ml[j] * f[j];
      } else {
        f[j] = T(1) / (md[j] - ml[j] * C[j - 1]);
        A[j] = -ml[j] * A[j - 1] * f[j];
      }
      C[j] = mu[j] * f[j];
      cf[j] = C[j];
    }
#pragma unroll
    for (int j = M - 3; j >= 1; --j) {
      A[j] = A[j] - cf[j] * A[j + 1];
      C[j] = -cf[j] * C[j + 1];
    }
    einv = T(1);
    if (M >= 3) {
      einv = T(1) / (T(1) - cf[0] * A[1]);
      A[0] = A[0] * einv;
      C[0] = -cf[0] * C[1] * einv;
    }
    // The reduced rows: first (a: the previous chunk's last, c: own last),
    // last (a: own first, c: the next chunk's first).  Their diagonals are 1
    // (normalized rows), so stride 1 needs no reciprocal.
    T b0 = T(1), a0 = A[0], c0 = C[0], b1 = T(1), a1 = A[M - 1], c1 = C[M - 1];
    {  // stride 1: first <- (previous last, own last), last <- (own first, next first)
      const T au = g.prev(a1, 1, T(0)), cu = g.prev(c1, 1, T(0));
      const T ad = g.next(a0, 1, T(0)), cd = g.next(c0, 1, T(0));
      T nb0 = b0, na0 = a0, nc0 = c0, nb1 = b1, na1 = a1, nc1 = c1;
      pcr_level(nb0, na0, nc0, T(1), au, cu, T(1), a1, c1, al[0][0], ga[0][0]);
      pcr_level(nb1, na1, nc1, T(1), a0, c0, T(1), ad, cd, al[0][1], ga[0][1]);
      b0 = nb0, a0 = na0, c0 = nc0, b1 = nb1, a1 = na1, c1 = nc1;
    }
    T r0 = T(1) / b0, r1 = T(1) / b1;  // the rows' reciprocal diagonals
#pragma unroll
    for (int k = 1; k < R; ++k) {  // stride 2^k rows: the same row of the thread 2^(k-1) ranks away
      const int d = 1 << (k - 1);
      const T ru0 = g.prev(r0, d, T(1)), au0 = g.prev(a0, d, T(0)), cu0 = g.prev(c0, d, T(0));
      const T rd0 = g.next(r0, d, T(1)), ad0 = g.next(a0, d, T(0)), cd0 = g.next(c0, d, T(0));
      const T ru1 = g.prev(r1, d, T(1)), au1 = g.prev(a1, d, T(0)), cu1 = g.prev(c1, d, T(0));
      const T rd1 = g.next(r1, d, T(1)), ad1 = g.next(a1, d, T(0)), cd1 = g.next(c1, d, T(0));
      pcr_level(b0, a0, c0, ru0, au0, cu0, rd0, ad0, cd0, al[k][0], ga[k][0]);
      pcr_level(b1, a1, c1, ru1, au1, cu1, rd1, ad1, cd1, al[k][1], ga[k][1]);
      r0 = T(1) / b0;
      r1 = T(1) / b1;
    }
    ib[0] = r0;
    ib[1] = r1;
  }

  // x: the thread's rows of the right-hand side in, of the solution out; ml
  // the rows' lower coefficients (the forward sweep's).
  __device__ __forceinline__ void solve(const Group<G>& g, const T (&ml)[M], T (&x)[M]) const {
    T D[M];
#pragma unroll
    for (int j = 0; j < M; ++j) D[j] = j < 2 ? x[j] * f[j] : (x[j] - ml[j] * D[j - 1]) * f[j];
#pragma unroll
    for (int j = M - 3; j >= 1; --j) D[j] = D[j] - cf[j] * D[j + 1];
    if (M >= 3) D[0] = (D[0] - cf[0] * D[1]) * einv;
    T r0 = D[0], r1 = D[M - 1];
    {
      const T u = g.prev(r1, 1, T(0)), v = g.next(r0, 1, T(0));
      const T n0 = r0 + al[0][0] * u + ga[0][0] * r1;
      r1 = r1 + al[0][1] * r0 + ga[0][1] * v;
      r0 = n0;
    }
#pragma unroll
    for (int k = 1; k < R; ++k) {
      const int d = 1 << (k - 1);
      const T u0 = g.prev(r0, d, T(0)), v0 = g.next(r0, d, T(0));
      const T u1 = g.prev(r1, d, T(0)), v1 = g.next(r1, d, T(0));
      r0 = r0 + al[k][0] * u0 + ga[k][0] * v0;
      r1 = r1 + al[k][1] * u1 + ga[k][1] * v1;
    }
    const T xf = r0 * ib[0], xl = r1 * ib[1];
    x[0] = xf;
    x[M - 1] = xl;
#pragma unroll
    for (int j = 1; j < M - 1; ++j) x[j] = D[j] - A[j] * xf - C[j] * xl;
  }
};

// A thread's M per-row values: in shared memory (row j of thread t at
// base[j * stride], stride the block's thread count, read by that thread
// only) when kShared, else a register array.
template <typename T, int M, bool kShared>
struct Rows {
  T* base;
  int stride;
  T reg[kShared ? 1 : M];
  __device__ __forceinline__ T& operator[](int j) {
    if constexpr (kShared)
      return base[j * stride];
    else
      return reg[j];
  }
};

// What the sub-steps read of a lane's statics: its faces' boundaries
// (Lane::boundary) and its area; the other statics are loaded again at each
// operator build, so that they hold no registers across the sub-steps.
template <typename T>
struct LaneBounds {
  int zone_f, zone_b;
  T temp_f, temp_b, area;
  bool f_out, b_out, f_space, b_space;
  __device__ explicit LaneBounds(const Lane<T>& L)
      : zone_f(L.zone_f), zone_b(L.zone_b), temp_f(L.temp_f), temp_b(L.temp_b), area(L.area),
        f_out(L.f_out), b_out(L.b_out), f_space(L.code_f == kSpace), b_space(L.code_b == kSpace) {}
  __device__ __forceinline__ void operator()(const T* zT, T t_out, T& t_front, T& t_back) const {
    // unconditional reads (slot 0 for a face without a zone, then discarded):
    // a read under a condition costs a branch region
    const T zf0 = zT[zone_f >= 0 ? zone_f : 0], zb0 = zT[zone_b >= 0 ? zone_b : 0];
    const T zf = zone_f >= 0 ? zf0 : T(0), zb = zone_b >= 0 ? zb0 : T(0);
    t_front = f_out ? t_out : (f_space ? zf : temp_f);
    t_back = b_out ? t_out : (b_space ? zb : temp_b);
  }
};

// A zone's A/B sums (zone_sums) from the block's face list in shared memory
// (s_zptr: block-local offsets, s_zf: block-local lane*2 + side), computed by
// one thread in the list's order; the loads of eight entries go out together.
template <typename T>
__device__ __forceinline__ void zone_sums_shared(const int* s_zptr, const int* s_zf, int z, const T* s_haT,
                                                 const T* s_ha, T a_ex, T b_ex, T& az, T& bz) {
  T af = T(0), bf = T(0), ab = T(0), bb = T(0);
  const int e1 = s_zptr[z + 1];
  for (int e0 = s_zptr[z]; e0 < e1; e0 += 8) {
    int f[8];
    T ht[8], hh[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = e0 + k < e1 ? s_zf[e0 + k] : -1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // unconditional reads (entry 0 for an absent one)
      ht[k] = s_haT[f[k] >= 0 ? f[k] : 0];
      hh[k] = s_ha[f[k] >= 0 ? f[k] : 0];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // adding +0 for an absent entry or the other side changes no bit
      const bool bk = f[k] >= 0 && (f[k] & 1), fk = f[k] >= 0 && !(f[k] & 1);
      ab += bk ? ht[k] : T(0);
      bb += bk ? hh[k] : T(0);
      af += fk ? ht[k] : T(0);
      bf += fk ? hh[k] : T(0);
    }
  }
  az = (a_ex + af) + ab;
  bz = (b_ex + bf) + bb;
}

// The sum over a whole warp by a fixed xor tree: every lane ends with the
// same bits (each step adds two operands that its partner adds in the other
// order), and the shape, hence the rounding, is the same from run to run.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The same sums by a whole warp (lane wl of 32): each lane adds the entries
// wl, wl + 32, ... of the zone's list in order, the warp adds the lanes' sums
// by warp_sum.  Every lane returns the zone's sums.
template <typename T>
__device__ __forceinline__ void zone_sums_warp(const int* s_zptr, const int* s_zf, int z, int wl, const T* s_haT,
                                               const T* s_ha, T a_ex, T b_ex, T& az, T& bz) {
  T af = T(0), bf = T(0), ab = T(0), bb = T(0);
  const int e1 = s_zptr[z + 1];
  for (int e = s_zptr[z] + wl; e < e1; e += 32) {
    const int f = s_zf[e];
    const T ht = s_haT[f], hh = s_ha[f];
    const bool bk = f & 1;
    ab += bk ? ht : T(0);
    bb += bk ? hh : T(0);
    af += bk ? T(0) : ht;
    bf += bk ? T(0) : hh;
  }
  az = (a_ex + warp_sum(af)) + warp_sum(ab);
  bz = (b_ex + warp_sum(bf)) + warp_sum(bb);
}

// One face's share of the operators: film coefficient, linearized radiation
// coefficient and radiant temperature.
template <typename T>
struct FaceOps {
  T h, rad, rad_t;
};

// The operator work of face `back` (0 front, 1 back) of lane L from the
// faces' surface temperatures and boundary air temperatures (build_ops's
// film, TARP and linearized-radiation lines for one face; FaceTemps's
// ambient-back quirk).  rad_out is the face's outdoor radiant temperature;
// with kMrt a face with a positive effective emissivity me radiates toward
// its zone's node tm.
template <typename T, bool kMrt>
__device__ __forceinline__ FaceOps<T> face_ops(const Lane<T>& L, bool back, T ts_front, T ts_back,
                                               T t_front, T t_back, T rad_out, T ws, T wd, int amb_bug,
                                               T me, T tm) {
  // forced_base, with P v / A as a product with 1/A and the root of a
  // positive argument: at rest (and on padded lanes) P v is 0, whose
  // division and square root would take their slow paths.
  const T pva = L.perim * (ws * L.wmod) * (T(1) / L.area);
  const T base = T(2.537) * (L.windward(wd) ? T(1) : T(0.5)) * L.rf *
                 (pva > T(0) ? m_sqrt(m_max(pva, T(1e-30))) : T(0));
  const T air = back ? t_back : t_front;
  const T surf = back ? ((L.b_amb && amb_bug) ? ts_front : ts_back) : ts_front;
  T rad = back ? (L.b_out ? rad_out : (L.b_amb ? (amb_bug ? t_front : t_back) : t_back))
               : (L.f_out ? rad_out : t_front);
  const T cos_eff = (!back && L.f_out) ? -L.cos_t : L.cos_t;
  T h = natural_h_cbrt(air, surf, cos_eff, L.c_same, L.c_opp) + ((back ? L.b_out : L.f_out) ? base : T(0));
  const T fix = back ? L.fix_hb : L.fix_hf;
  if (!is_nan(fix)) h = fix;
  T eps = back ? L.eps_b : L.eps_f;
  if constexpr (kMrt) {
    if (me > T(0)) {
      rad = tm;
      eps = me;
    }
  }
  const T x = T(kKelvin) + (rad + surf) / T(2);
  return {h, T(4) * eps * T(kSigma) * (x * x * x), rad};
}

// Zone z's sums of w ts and w over its network faces (mrt_sums) from the
// block's network lists in shared memory (s_mptr: block-local offsets, s_mf:
// block-local lane*2 + side): by one thread in list order (wl < 0), or by a
// whole warp as zone_sums_warp (lane wl; every lane returns the sums).
template <typename T>
__device__ __forceinline__ void mrt_sums_shared(const int* s_mptr, const int* s_mf, int z, int wl, const T* s_wt,
                                                const T* s_w, T& num, T& den) {
  num = den = T(0);
  const int e1 = s_mptr[z + 1];
  if (wl < 0) {
    for (int e = s_mptr[z]; e < e1; ++e) {
      num += s_wt[s_mf[e]];
      den += s_w[s_mf[e]];
    }
    return;
  }
  for (int e = s_mptr[z] + wl; e < e1; e += 32) {
    num += s_wt[s_mf[e]];
    den += s_w[s_mf[e]];
  }
  num = warp_sum(num);
  den = warp_sum(den);
}

// The Carroll network's fixed point (mrt_network) with a lane's two faces
// split over its group: each thread follows one face's node (`slot`: the
// lane's front or back entry of the shared face rows) from tm0, its
// boundary air temperature; the `writer` of the face (ranks 0 and 1) writes
// its conductance when the face is on the network (`on`).  The block's
// network lists are in shared memory (s_mptr, s_mf), summed a warp per zone
// when the block is whole warps (else a thread per zone).  Every thread of
// the block calls it; s_tm holds the zones' nodes on return, and the return
// value is the face's node.
template <typename T>
__device__ T mrt_face_node(int ZB, const int* s_mptr, const int* s_mf, int tid, int nthreads, bool writer,
                           bool on, int slot, int zone, T eps, T area, T ts, T tm0, const T* s_zT, T* s_w,
                           T* s_wt, T* s_tm) {
  const bool by_warp = (nthreads & 31) == 0;
  T tm = tm0;
  for (int it = 0; it < 4; ++it) {
    if (writer && on) {
      const T w = mrt_weight(eps, area, tm, ts);
      s_w[slot] = w;
      s_wt[slot] = w * ts;
    }
    __syncthreads();
    for (int z = by_warp ? tid >> 5 : tid; z < ZB; z += by_warp ? nthreads >> 5 : nthreads) {
      T num, den;
      mrt_sums_shared(s_mptr, s_mf, z, by_warp ? tid & 31 : -1, s_wt, s_w, num, den);
      if (!by_warp || (tid & 31) == 0) s_tm[z] = den > T(1e-30) ? num / den : s_zT[z];
    }
    __syncthreads();
    const T t = s_tm[zone >= 0 ? zone : 0];
    tm = zone >= 0 ? t : T(0);
  }
  return tm;
}

}  // namespace heatx
