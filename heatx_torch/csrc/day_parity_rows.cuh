// Device code of the parity day march with four threads per surface
// (day_march_parity.cu has the kernel): one face's share of a sub-step's
// operators, a row of a thread's register array picked or set at a runtime
// index, a group's OR, and the lane-wide row words of a lane's chunk
// structure.  The plain statement of the row plan (the per-run no-mass
// solve over the thread partition, RK4 on the launch-constant scaled rows)
// is tests/torch_parity_rows_plain.py.
#pragma once

#include "day_common.cuh"
#include "day_tr.cuh"

namespace heatx {

// A lane's statics as the sub-steps' films and forced term read them
// (Lane's, TARP's branch coefficients included), kept once per launch.
template <typename T>
struct FaceStatics {
  T cos_t, c_same, c_opp, eps_f, eps_b, fix_hf, fix_hb, perim, wmod, area, rf, nx, ny;
  bool f_out, b_out, b_amb;
  __device__ explicit FaceStatics(const Lane<T>& L)
      : cos_t(L.cos_t), c_same(L.c_same), c_opp(L.c_opp), eps_f(L.eps_f), eps_b(L.eps_b), fix_hf(L.fix_hf),
        fix_hb(L.fix_hb), perim(L.perim), wmod(L.wmod), area(L.area), rf(L.rf), nx(L.nx), ny(L.ny),
        f_out(L.f_out), b_out(L.b_out), b_amb(L.b_amb) {}
  // The forced term 2.537 W rf sqrt(P v / A), with the sub-step's sine and
  // cosine of the wind direction.
  __device__ __forceinline__ T base(T ws, T sin_wd, T cos_wd) const {
    const T pva = perim * (ws * wmod) / area;
    const bool windward = m_abs(cos_t) >= T(0.98) || (nx * sin_wd + ny * cos_wd > T(0));
    return T(2.537) * (windward ? T(1) : T(0.5)) * rf * (pva > T(0) ? m_sqrt(pva) : T(0));
  }
};

// One face's film coefficient (surface.border_conditions for one side): TARP
// natural convection with pow's cube root, the forced term `base` on an
// outdoor face, the fixed coefficient where the face has one.
template <typename T>
__device__ __forceinline__ T parity_face_h(const FaceStatics<T>& L, bool back, T air, T surf, T base) {
  const T cos_eff = (!back && L.f_out) ? -L.cos_t : L.cos_t;
  const T h = natural_h(air, surf, cos_eff, L.c_same, L.c_opp) + ((back ? L.b_out : L.f_out) ? base : T(0));
  const T fix = back ? L.fix_hb : L.fix_hf;
  return is_nan(fix) ? h : fix;
}

// One face's surface temperature as the films read it (the quirk: the
// back face of an ambient boundary reads the front surface with amb_bug).
template <typename T>
__device__ __forceinline__ T parity_face_surf(const FaceStatics<T>& L, bool back, T ts_front, T ts_back,
                                              int amb_bug) {
  return back ? ((L.b_amb && amb_bug) ? ts_front : ts_back) : ts_front;
}

// One face's share of the sub-step's operators from its start state
// (parity_ops for one side): the film, the linearized radiation coefficient
// and the radiant temperature; rad_out is the face's outdoor radiant
// temperature, and with kMrt a face with a positive effective emissivity me
// radiates toward its zone's node tm.
template <typename T, bool kMrt>
__device__ __forceinline__ FaceOps<T> parity_face_ops(const FaceStatics<T>& L, bool back, T ts_front, T ts_back,
                                                      T t_front, T t_back, T rad_out, T base, int amb_bug,
                                                      T me, T tm) {
  const T surf = parity_face_surf(L, back, ts_front, ts_back, amb_bug);
  T rad = back ? (L.b_out ? rad_out : (L.b_amb ? (amb_bug ? t_front : t_back) : t_back))
               : (L.f_out ? rad_out : t_front);
  T eps = back ? L.eps_b : L.eps_f;
  if constexpr (kMrt) {
    if (me > T(0)) {
      rad = tm;
      eps = me;
    }
  }
  const T x = T(kKelvin) + (rad + surf) / T(2);
  return {parity_face_h(L, back, back ? t_back : t_front, surf, base), T(4) * eps * T(kSigma) * (x * x * x), rad};
}

// Row j of a thread's register array at a runtime index (a select per row:
// the array stays in registers).
template <int M, typename T>
__device__ __forceinline__ T pick(const T (&v)[M], int j) {
  T x = v[0];
#pragma unroll
  for (int i = 1; i < M; ++i) x = j == i ? v[i] : x;
  return x;
}
template <int M, typename T>
__device__ __forceinline__ void put(T (&v)[M], int j, T x) {
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = j == i ? x : v[i];
}

// Row k of the lane's column of a per-thread array v (rows [rank*M, rank*M
// + M) on each rank), on every thread of the group.
template <int M, int G, typename T>
__device__ __forceinline__ T row_of(const Group<G>& g, const T (&v)[M], int k) {
  return g.from(pick(v, k % M), k / M);
}

// The group's OR of a word, the same on every thread.
template <int G, typename W>
__device__ __forceinline__ W group_or(const Group<G>& g, W v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(g.mask, v, o, G);
  return v;
}

// A lane's rows as column words W (ColBits: bit i, row i) from its node,
// mass and chunk words (day_parity.cuh LN_CHUNK; engine.surface.compute_statics): valid,
// first and last rows, the couplings inside a chunk and across chunks (the
// frozen sources), massive and no-mass rows, and the no-mass runs: a row
// that continues the run above it (no-mass, joined to a no-mass row), the
// runs' heads, and the heads of 2-node runs (heatx's pair_head).
template <typename W>
struct RowWords {
  static constexpr int kBits = 8 * sizeof(W);
  W valid, first, last, coup_l, coup_r, dir_l, dir_r, mass, sel, cont, head, pair;
  __device__ RowWords(W node_bits, W mass_bits, W joined, int N) {
    valid = node_bits & (N < kBits ? (W(1) << N) - W(1) : ~W(0));
    const W left = valid & (valid << 1), right = valid & (valid >> 1);
    first = valid & ~(valid << 1);
    last = valid & ~(valid >> 1);
    coup_l = left & (joined << 1);
    coup_r = right & joined;
    dir_l = left & ~(joined << 1);
    dir_r = right & ~joined;
    mass = valid & mass_bits;
    sel = valid & ~mass_bits;
    cont = sel & ((sel & joined) << 1);
    head = sel & ~cont;
    pair = sel & coup_r;
  }
  // The rows of the no-mass run whose head is row i.
  __device__ __forceinline__ W run(int i) const {
    W r = W(1) << i;
    for (int k = i + 1; k < kBits && ((cont >> k) & 1u); ++k) r |= W(1) << k;
    return r;
  }
  // Whether some no-mass run has more than two rows.
  __device__ __forceinline__ bool long_run() const { return (cont & (cont >> 1)) != W(0); }
};

}  // namespace heatx
