// The parity day march for NVIDIA Hopper (sm_90a): four threads per surface.
// day_march.cu's C entry hands every parity launch to
// heatx_day_march_parity_f32/_f64 here (ctypes; heatx_torch/ops/day_march.py).
//
// Replaces heatx/ops/pallas_step.py::make_hour_march -> `kernel` (the
// pl.pallas_call at pallas_step.py:1976) in mode parity, body `_hour_body`
// (:633): RK4 on the massive nodes after a relaxed no-mass solve, a fixed
// number of iterations or the adaptive loop (:1345-1353, surface.march_nomass),
// free-float, with thermostats, schedules, mixing and the in-run shading and
// ventilation gates (kExt), with gas cavities (kCav), with interior MRT and the
// h/q and operative histories (kMrt, in day_march_parity_mrt.cu).  One launch
// marches `hours` hours of `substeps` sub-steps, each with its own operators.
// Its plain version is ops/day_march.py plain_hour_parity; the row plan below
// is stated plainly in tests/torch_parity_rows_plain.py.
//
// What bounded the first design (one thread per surface, day_parity.cuh's
// parity_substep, which the parity adjoint's recompute still runs): a serial
// chain of ~49 us a sub-step on the bench city (2,832 sub-steps a day, 139 ms
// a day-launch against a 0.32 ms bound by operations), from five causes:
//  1. one thread per surface: the bench city's 334 blocks of 32 threads held
//     2.5 warps an SM, so nothing hid the latency;
//  2. the node column and seven work columns were runtime-indexed per-thread
//     arrays in local memory (1.4 KB of stack in f32);
//  3. work constant over the launch redone in the chain of every sub-step:
//     dt/C as a load and a division per row in the forcing and in each of the
//     four RK4 stages, all of K rebuilt from U in device memory, a reciprocal
//     on every row of the no-mass factorization, identity rows included, the
//     solar fractions and U re-read per row and evaluation;
//  4. the no-mass solve swept the whole identity-padded column (Thomas) at
//     every iteration, where heatx solves runs of at most two nodes in closed
//     form (tridiag.solve_runs2);
//  5. the four RK4 stages were four serial sweeps on one thread, although a
//     stage's row needs only its two neighbours.
//
// This design, cause by cause:
//  1. G = 4 threads per surface lane (kGroup; blockDim = lanes x G) in the
//     TR-BDF2 kernel's launch variants (kLaunchVariants, day_march_args.cuh:
//     128 threads and three f32 blocks an SM for blocks of up to 32 lanes,
//     256 up to 64, 1024 up to 256).  Thread `rank` owns the M = 8 rows
//     [rank*M, rank*M + M).
//  2. Each thread's rows live in unrolled register arrays: the column, the
//     row's operator and its U to the row above.
//  3. Launch-constant operators: each row's dt/C and its K row (massive rows:
//     scaled by dt/C, no-mass rows: as they are), loaded and formed once per
//     launch; the hour's solar forcing once per hour, after shading; per
//     sub-step only the face rows' diagonals take the films (heatx hoists the
//     same pieces: compute_statics(dt=...), the static-U forms of K and q).
//     A cavity lane rebuilds its rows where heatx rebuilds them: at each
//     no-mass iteration's input and on the post-no-mass column, the cavity U
//     computed in registers by the thread that owns the segment's first row
//     (the next row by shuffle), with no device-memory round trip.
//  4. The no-mass solve is per run: heatx's closed form (solve_runs2) on the
//     thread that holds the run's head, a pair across a rank boundary taking
//     its partner's row by one shuffle each way; the reciprocal of each
//     run's denominator is kept, recomputed only where a face row's film
//     moves it (every run of a cavity lane at each rebuild).  A block with a
//     no-mass run of three or more nodes solves every lane's column by
//     Thomas's sweeps instead (heatx's own choice when a run is longer than
//     two), each row's coefficients broadcast from its owner down the column:
//     a serial chain, but only the small test buildings have such runs, and
//     it needs no shared memory at B1's edge.  The adaptive loop's per-run
//     state (last error, count, activity) lives at the run's head; a run's
//     error is summed in ascending node order as nomass_step sums it.
//  5. Each RK4 stage is k = kd' y + kl' y_up + ku' y_down + qs' per row, the
//     neighbour rows at a thread's edges by two shuffles; the stage
//     combinations stay in registers and only massive rows take the result.
// The rest is the TR-BDF2 kernel's machinery (day_tr.cuh): the faces' work
// on rank 0 (front) and rank 1 (back) for both film evaluations of a
// sub-step, which share one forced term; the back face's temperature by one
// shuffle from the owner of the last valid row; the lane's boundaries in a
// shared row; the hour's weather, gains, setpoints and the zone and network
// lists in shared memory; a warp per zone summing a zone's faces in a fixed
// order, two barriers per sub-step and the kExt swap of the zone rows; the
// Carroll network's 4-iteration fixed point at each sub-step's start, from
// the start state (mrt_face_node).
//
// The adaptive loop holds no barrier.  A warp iterates until none of its
// lanes has an active run (the shuffles need the whole warp); an iteration
// after a lane's last run stopped leaves the lane as it is (day_parity.cuh
// march_nomass has the argument), so each lane stops where its own loop does.
//
// In-run zone shading and ventilation gates (kExt) are decided at the top of
// the hour loop: one kernel "hour" is one main step, and both decisions read
// the zone carry s_zT at its start, before the first sub-step's barrier (the
// last barrier of the previous hour, or the one after the start state's load,
// made the row whole).  Shading: a controlled lane reads its controlling
// zone's slot and scales the hour's front solar by the device's transmittance
// (scale, then clamp; heatx's order).  Gates: the hour's a_extra (+ a_vent)
// and b_extra (+ b_vent) go to two shared rows once per hour; the decision is
// held even as s_zT moves.

#include <type_traits>

#include "day_common.cuh"
#include "day_march_args.cuh"
#include "day_parity.cuh"
#include "day_parity_rows.cuh"

// The kMrt kinds live in their own compilation unit (day_march_parity_mrt.cu,
// which includes this file): kernels that share a unit move each other's
// registers and stack.
extern "C" int heatx_day_march_parity_mrt_f32(const void* m, void* stream);
extern "C" int heatx_day_march_parity_mrt_f64(const void* m, void* stream);

namespace {

using namespace heatx;

// Bytes of a block's dynamic shared memory: the zone row, the per-face rows,
// the hour's gains and the zones' volumes, with kExt the new zone row, the
// load sums and the hour's four setpoint rows, with kMrt the MRT nodes; the
// hour's weather; with kShared each thread's rows' solar forcing (kMaxNodes
// rows a lane); the lanes' boundaries and face statics; then the zone lists
// and, with kMrt, the network lists (ints).
template <typename T, bool kExt, bool kMrt, bool kShared>
size_t parity_smem(const DayArgs<T>& a) {
  const size_t zrows = 4 + (kExt ? 6 : 0) + (kMrt ? 1 : 0);
  const size_t lists = (kMrt ? 2 : 1) * (a.ZB + 1 + 2 * static_cast<size_t>(a.SB));
  const size_t rows = kShared ? static_cast<size_t>(kMaxNodes) * a.SB : 0;
  return sizeof(T) * (zrows * a.ZB + 4 * static_cast<size_t>(a.SB) + 5 * static_cast<size_t>(a.substeps) + rows) +
         (sizeof(LaneBounds<T>) * a.SB + 16) + (sizeof(FaceStatics<T>) * a.SB + 16) + sizeof(int) * lists;
}

template <typename T, int kThreads, int kMinBlocks, bool kExt, bool kCav, bool kMrt>
__global__ void __launch_bounds__(kThreads, kMinBlocks) day_march_parity_kernel(const MarchArgsOf<T, kMrt> m) {
  constexpr int G = kGroup;
  constexpr int M = kMaxNodes / G;
  const DayArgs<T>& a = m.in;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_zT = reinterpret_cast<T*>(smem_raw);  // [ZB] zone air temperatures
  T* s_haT = s_zT + a.ZB;                    // [2*SB] h*A*T_s per face (kMrt: also w*T_s)
  T* s_ha = s_haT + 2 * a.SB;                // [2*SB] h*A per face (kMrt: also w)
  T* s_ga = s_ha + 2 * a.SB;                 // [ZB] the hour's a_extra (gated: plus a_vent)
  T* s_gb = s_ga + a.ZB;                     // [ZB] the hour's b_extra (gated: plus b_vent)
  T* s_vol = s_gb + a.ZB;                    // [ZB] zone volumes
  T* s_zN = s_vol + a.ZB;                    // kExt: [ZB] the sub-step's new zone row
  T* s_ld = s_zN + (kExt ? a.ZB : 0);        // kExt: [ZB] the hour's load sum
  T* s_sp = s_ld + (kExt ? a.ZB : 0);        // kExt, thermostats: [4][ZB] the hour's Setpoints
  T* s_tm = s_sp + (kExt ? 4 * a.ZB : 0);    // kMrt: [ZB] the zones' MRT nodes
  T* s_wx = s_tm + (kMrt ? a.ZB : 0);        // [5*substeps] the hour's t_out, wind, wdir, sin and cos wdir
  // [M][blockDim] each thread's rows' solar forcing of the hour (row j of
  // thread t at j*blockDim + t: read by that thread only), but for the
  // 1024-thread variant, which keeps them in its registers
  constexpr bool kShared = kThreads < 1024;
  T* s_sq = s_wx + 5 * a.substeps;
  // [SB] each lane's boundaries (LaneBounds) and face statics, read by its
  // group's threads
  LaneBounds<T>* s_lb = reinterpret_cast<LaneBounds<T>*>(
      (reinterpret_cast<size_t>(s_sq + (kShared ? kMaxNodes * a.SB : 0)) + 15) & ~static_cast<size_t>(15));
  FaceStatics<T>* s_fs = reinterpret_cast<FaceStatics<T>*>(
      (reinterpret_cast<size_t>(s_lb + a.SB) + 15) & ~static_cast<size_t>(15));
  int* s_zptr = reinterpret_cast<int*>(s_fs + a.SB);  // [ZB+1] block-local face offsets
  int* s_zf = s_zptr + a.ZB + 1;                      // [<= 2*SB] the zones' faces
  int* s_mptr = s_zf + 2 * a.SB;  // kMrt: [ZB+1] block-local offsets of the network lists
  int* s_mf = s_mptr + a.ZB + 1;  // kMrt: [<= 2*SB] the zones' network faces
  __shared__ int s_bad;

  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB, sub = a.substeps;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int SP = NB * SB;
  const int slot = tid / G;  // the lane's place in the block
  const int lane = b * SB + slot;
  const Group<G> g{block_warp_mask(), tid % G};
  const int row0 = g.rank * M;
  const bool back = g.rank != 0;  // this thread's face
  const ParityCfg<T> pc(a);
  const T dt = pc.dt;
  if (g.rank == 0) {
    const Lane<T> L(a, lane, kCav);
    s_lb[slot] = LaneBounds<T>(L);
    s_fs[slot] = FaceStatics<T>(L);
  }
  const LaneBounds<T>& LB = s_lb[slot];
  const FaceStatics<T>& L = s_fs[slot];

  // The lane's rows as words (bit i: row i), and the thread's share (bit j:
  // row row0 + j).
  const RowWords W(static_cast<unsigned>(a.lane[LN_BITS * SP + lane]),
                   static_cast<unsigned>(a.lane[LN_MASS * SP + lane]),
                   static_cast<unsigned>(a.lane[LN_CHUNK * SP + lane]), N);
  constexpr unsigned own = (1u << M) - 1u;
  const unsigned vb = (W.valid >> row0) & own, fb = (W.first >> row0) & own, lb = (W.last >> row0) & own;
  const unsigned mb = (W.mass >> row0) & own, sb = (W.sel >> row0) & own;
  const unsigned cl = (W.coup_l >> row0) & own, cr = (W.coup_r >> row0) & own;
  const unsigned dl = (W.dir_l >> row0) & own, dr = (W.dir_r >> row0) & own;
  const unsigned hd = (W.head >> row0) & own;
  const unsigned ph = (W.pair >> row0) & own, pt = ((W.pair << 1) >> row0) & own;
  const unsigned left = W.coup_l | W.dir_l;
  const unsigned cav_w = kCav ? static_cast<unsigned>(a.lane[LN_CAV * SP + lane]) : 0u;
  const unsigned cav = (cav_w >> row0) & own;
  const bool cav_lane = cav_w != 0u;
  // A block with a no-mass run of three or more nodes solves by Thomas.
  const bool long_runs = __syncthreads_or(W.long_run()) != 0;
  // The runs whose denominator a face row's film moves: face rows and the
  // heads of pairs whose tail is a face row (tails copy their head's).
  const unsigned faces_w = W.first | W.last;
  const unsigned heads1 = sb & ~pt;
  const unsigned dyn = (((W.sel & (faces_w | (W.pair & (faces_w >> 1)))) >> row0) & own) & ~pt;
  // The back face's temperature: one shuffle from the owner of the column's
  // last valid row when every lane of the warp has one such row (the sum of
  // the group's partial sums otherwise, as engine.surface._last_node sums them).
  const bool one_last = __all_sync(g.mask, __popc(W.last) <= 1);
  const int last_owner = W.last ? (31 - __clz(W.last)) / M : 0;

  const T* U = a.node + (ND_U * N) * SP + lane;
  const T* FA = a.node + (ND_FA * N) * SP + lane;
  const T* FB = a.node + (ND_FB * N) * SP + lane;
  // The thread's rows: the column; U to the row above (0 off the column);
  // each row's operator A, D, C (K's lower, diagonal and upper entries,
  // scaled by dt/C on massive rows); P: dt/C on massive rows, the reciprocal
  // of the closed form's denominator on a no-mass run's rows; the hour's
  // absorbed solar.  Rows load unconditionally (clamped indices, then a
  // select): a load under a condition becomes a branch region per row.
  T Tn[M], ul[M], A[M], D[M], C[M], P[M];
  Rows<T, M, kShared> sq{s_sq + tid, nthreads};
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int i = row0 + j, ic = min(i, N - 1);
    const T t0 = a.T0[ic * SP + lane], c = a.node[(ND_CAP * N + ic) * SP + lane];
    const T u = U[min(max(i - 1, 0), N - 1) * SP];
    Tn[j] = i < N ? t0 : T(0);
    ul[j] = ((left >> i) & 1u) ? u : T(0);
    P[j] = ((mb >> j) & 1u) ? dt / c : T(0);
    sq[j] = T(0);
  }
  const int il = row0 + M - 1;  // the segment below the thread's last row
  T ur_last = (il + 1 < 32 && ((left >> (il + 1)) & 1u)) ? U[il * SP] : T(0);

  // The sub-step's face operators (the first film evaluation's films and
  // linearized radiation; src: t_air h).
  T hf = T(0), hb = T(0), radf = T(0), radb = T(0), rad_ft = T(0), rad_bt = T(0), src_f = T(0), src_b = T(0);
  // Row j's operator from its U and the films (assemble_K; scaled on a
  // massive row).
  auto row_op = [&](int j) {
    const T ur = j + 1 < M ? ul[j + 1] : ur_last;
    const T kd = -(((ul[j] + ur) + (((fb >> j) & 1u) ? hf : T(0))) + (((lb >> j) & 1u) ? hb : T(0)));
    const T kl = ((cl >> j) & 1u) ? ul[j] : T(0), ku = ((cr >> j) & 1u) ? ur : T(0);
    const bool ms = (mb >> j) & 1u;
    A[j] = ms ? kl * P[j] : kl;
    D[j] = ms ? kd * P[j] : kd;
    C[j] = ms ? ku * P[j] : ku;
  };
#pragma unroll
  for (int j = 0; j < M; ++j) row_op(j);

  // The closed form's reciprocal denominators of the runs whose heads (or
  // singles) are in `mask` (solve_runs2: a pair's head and tail share one),
  // and the neighbours' coefficients across the thread's edges.
  T nD = T(1), nA = T(0), pD = T(1), pC = T(0);
  auto factor = [&](unsigned mask) {
    nD = g.next(D[0], 1, T(1));
    nA = g.next(A[0], 1, T(0));
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T dn = j + 1 < M ? D[j + 1] : nD, an = j + 1 < M ? A[j + 1] : nA;
      const T den = ((ph >> j) & 1u) ? D[j] * dn - C[j] * an : D[j];
      if ((mask >> j) & 1u) P[j] = T(1) / den;
    }
    const T pP = g.prev(P[M - 1], 1, T(1));
#pragma unroll
    for (int j = 0; j < M; ++j)
      if ((pt >> j) & 1u) P[j] = j > 0 ? P[j - 1] : pP;
    pD = g.prev(D[M - 1], 1, T(1));
    pC = g.prev(C[M - 1], 1, T(0));
  };
  if (!long_runs) factor(heads1);

  // Row j's forcing at the working column w (assemble_q): the hour's solar,
  // the faces' sources, the couplings across chunks as frozen sources; wu
  // and wd are the rows above and below the thread's rows.
  auto row_q = [&](int j, const T(&w)[M], T wu, T wd) {
    T q = sq[j];
    q += ((fb >> j) & 1u) ? src_f + radf * (rad_ft - w[j]) : T(0);
    q += ((lb >> j) & 1u) ? src_b + radb * (rad_bt - w[j]) : T(0);
    q += ((dl >> j) & 1u) ? ul[j] * (j > 0 ? w[j - 1] : wu) : T(0);
    q += ((dr >> j) & 1u) ? (j + 1 < M ? ul[j + 1] : ur_last) * (j + 1 < M ? w[j + 1] : wd) : T(0);
    return q;
  };

  // x = the no-mass system's solution at the working column w: -q(w) on
  // no-mass rows (K's rows), w elsewhere (identity rows).
  auto nomass_solve = [&](const T(&w)[M], T(&x)[M]) {
    const T wu = g.prev(w[M - 1], 1, T(0)), wd = g.next(w[0], 1, T(0));
    T r[M];
#pragma unroll
    for (int j = 0; j < M; ++j) r[j] = -row_q(j, w, wu, wd);
    if (!long_runs) {  // runs of one or two rows in closed form (solve_runs2)
      const T rn = g.next(r[0], 1, T(0)), rp = g.prev(r[M - 1], 1, T(0));
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T dn = j + 1 < M ? D[j + 1] : nD, rnj = j + 1 < M ? r[j + 1] : rn;
        const T dp = j > 0 ? D[j - 1] : pD, rpj = j > 0 ? r[j - 1] : rp;
        const T num = ((ph >> j) & 1u) ? r[j] * dn - C[j] * rnj
                                       : (((pt >> j) & 1u) ? dp * r[j] - A[j] * rpj : r[j]);
        x[j] = num * P[j];
      }
      return;
    }
    // Thomas down the lane's column (tridiag.solve), each row's coefficients
    // broadcast from the thread that holds it.
    T cs[M], ds[M];
#pragma unroll
    for (int j = 0; j < M; ++j) x[j] = w[j];
    T cs_p = T(0), ds_p = T(0);
    for (int k = 0; k < N; ++k) {
      const T lk = row_of<M>(g, A, k), dk = row_of<M>(g, D, k), uk = row_of<M>(g, C, k);
      const T rk = row_of<M>(g, r, k), wk = row_of<M>(g, w, k);
      const bool s = (W.sel >> k) & 1u;
      const T l = s ? lk : T(0), u = s ? uk : T(0), rh = s ? rk : wk;
      const T inv = T(1) / ((s ? dk : T(1)) - l * cs_p);
      cs_p = u * inv;
      ds_p = (rh - l * ds_p) * inv;
      if (k / M == g.rank) {
        put(cs, k % M, cs_p);
        put(ds, k % M, ds_p);
      }
    }
    T xn = T(0);
    for (int k = N - 1; k >= 0; --k) {
      const T xo = k == N - 1 ? pick(ds, k % M) : pick(ds, k % M) - pick(cs, k % M) * xn;
      xn = g.from(xo, k / M);
      if (k / M == g.rank) put(x, k % M, xn);
    }
  };

  // A cavity lane's segment U-values at the column w (segment_u): computed
  // by the thread that owns the segment's first row, the next row by shuffle;
  // a thread's last segment reaches its successor by one shuffle.  Then the
  // lane's rows are rebuilt.
  auto cavity = [&](const T(&w)[M]) {
    const T w_next = g.next(w[0], 1, T(0));
    const size_t ns = static_cast<size_t>(N) * SP;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int s = row0 + j;
      if (((cav >> j) & 1u) && s + 1 < N) {
        const T u = cavity_u(a.cav + lane + s * SP, ns, w[j], j + 1 < M ? w[j + 1] : w_next,
                             static_cast<T*>(nullptr), static_cast<T*>(nullptr));
        const bool link = (left >> (s + 1)) & 1u;
        if (j + 1 < M)
          ul[j + 1] = link ? u : T(0);
        else
          ur_last = link ? u : T(0);
      }
    }
    ul[0] = g.prev(ur_last, 1, T(0));
    if (cav_lane) {
#pragma unroll
      for (int j = 0; j < M; ++j) row_op(j);
    }
  };

  // The face temperatures of the column Tn: (front, back).
  auto faces = [&](T& ts_f, T& ts_b) {
    T part = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j)
      if ((lb >> j) & 1u) part += Tn[j];
    ts_b = one_last ? g.from(part, last_owner) : g.sum(part);
    ts_f = g.from(Tn[0], 0);
  };

  // One RK4 stage k = K' y + q' on the massive rows (0 elsewhere).
  T qs[M], kk[M];
  auto stage = [&](const T(&y)[M]) {
    const T yu = g.prev(y[M - 1], 1, T(0)), yd = g.next(y[0], 1, T(0));
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T up = j > 0 ? y[j - 1] : yu, down = j + 1 < M ? y[j + 1] : yd;
      const T k = ((D[j] * y[j] + A[j] * up) + C[j] * down) + qs[j];
      kk[j] = ((mb >> j) & 1u) ? k : T(0);
    }
  };

  const int e_base = a.zone_ptr[b * ZB];
  for (int z = tid; z <= ZB; z += nthreads) s_zptr[z] = a.zone_ptr[b * ZB + z] - e_base;
  for (int e = tid; e < a.zone_ptr[b * ZB + ZB] - e_base; e += nthreads) s_zf[e] = a.zone_faces[e_base + e];
  if constexpr (kMrt) {
    const int m_base = m.net.mrt_ptr[b * ZB];
    for (int z = tid; z <= ZB; z += nthreads) s_mptr[z] = m.net.mrt_ptr[b * ZB + z] - m_base;
    for (int e = tid; e < m.net.mrt_ptr[b * ZB + ZB] - m_base; e += nthreads) s_mf[e] = m.net.mrt_faces[m_base + e];
  }
  for (int z = tid; z < ZB; z += nthreads) {
    s_zT[z] = a.zT0[b * ZB + z];
    s_vol[z] = a.zone_volume[b * ZB + z];
    if (kExt) s_ld[z] = T(0);
  }
  __syncthreads();

  // The zone phase's threads: a warp per zone when the block is whole warps.
  const bool by_warp = (nthreads & 31) == 0;
  const int zstep = by_warp ? nthreads >> 5 : nthreads;

  T qf = T(0), qb = T(0);
  for (int h = 0; h < a.hours; ++h) {
    // The in-run controls at the main step's start (see the design notes).
    T shade = T(1);
    if (kExt && a.shade_slot) {
      const int z = a.shade_slot[lane];
      if (z >= 0 && s_zT[z] > a.shade_sp[(size_t)h * a.shade_sp_stride + lane])
        shade = a.shade_tau[lane];
    }
    {  // the hour's clamped solar per row (the fractions read once an hour)
      const T sfr = a.sol_f[h * SP + lane] * shade, sbr = a.sol_b[h * SP + lane];
      const T sol_f = (is_nan(sfr) || sfr < T(0)) ? T(0) : sfr;
      const T sol_b = is_nan(sbr) ? T(0) : sbr;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int ic = min(row0 + j, N - 1);
        const T q = FA[ic * SP] * sol_f + FB[ic * SP] * sol_b;
        sq[j] = row0 + j < N ? q : T(0);
      }
    }
    const T ir = (back ? a.ir_b : a.ir_f)[h * SP + lane];
    const T rad_out = m_pow(m_max(ir, T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
    {  // the hour's gains (gated where the building has ventilation gates) and weather
      const size_t row = (size_t)h * NB * ZB + b * ZB;
      for (int z = tid; z < ZB; z += nthreads) {
        T ga = a.a_extra[row + z], gb = a.b_extra[row + z];
        if (kExt && a.vent_min) {
          const int gz = b * ZB + z;
          const T zt = s_zT[z];
          const bool on = zt > a.vent_min[gz] && zt < a.vent_max[gz] && zt > a.vent_thr[row + z];
          ga += on ? a.a_vent[row + z] : T(0);
          gb += on ? a.b_vent[row + z] : T(0);
        }
        s_ga[z] = ga;
        s_gb[z] = gb;
        if (kExt && a.ctl) {
          const Setpoints<T> sp(a, h, b * ZB + z);
          s_sp[z] = sp.heat;
          s_sp[ZB + z] = sp.cool;
          s_sp[2 * ZB + z] = sp.max_heat;
          s_sp[3 * ZB + z] = sp.max_cool;
        }
      }
      for (int i = tid; i < sub; i += nthreads) {
        s_wx[i] = a.t_out[h * sub + i];
        s_wx[sub + i] = a.wind[h * sub + i];
        s_wx[2 * sub + i] = a.wdir[h * sub + i];
        s_wx[3 * sub + i] = m_sin(a.wdir[h * sub + i]);
        s_wx[4 * sub + i] = m_cos(a.wdir[h * sub + i]);
      }
      __syncthreads();
    }
    for (int i = 0; i < sub; ++i) {
      // ---- the sub-step's operators from its start column -------------------
      T t_front, t_back, ts_f, ts_b;
      LB(s_zT, s_wx[i], t_front, t_back);
      faces(ts_f, ts_b);
      T me = T(0), tm = T(0);
      if constexpr (kMrt) {
        // The network of the sub-step's start state (without MRT physics an
        // empty context: the faces' own radiation).
        if (m.net.phys) {
          const MrtLane<T> ML(a, m.net, lane);
          me = back ? ML.eb : ML.ef;
          tm = mrt_face_node(ZB, s_mptr, s_mf, tid, nthreads, g.rank < 2, ((ML.bits >> int(back)) & 1u) != 0,
                             2 * slot + int(back), back ? LB.zone_b : LB.zone_f, me, L.area, back ? ts_b : ts_f,
                             back ? t_back : t_front, s_zT, s_ha, s_haT, s_tm);
        }
      }
      const T base = L.base(s_wx[sub + i], s_wx[3 * sub + i], s_wx[4 * sub + i]);
      const FaceOps<T> fo =
          parity_face_ops<T, kMrt>(L, back, ts_f, ts_b, t_front, t_back, rad_out, base, a.amb_bug, me, tm);
      hf = g.from(fo.h, 0);
      radf = g.from(fo.rad, 0);
      rad_ft = g.from(fo.rad_t, 0);
      hb = g.from(fo.h, 1);
      radb = g.from(fo.rad, 1);
      rad_bt = g.from(fo.rad_t, 1);
      src_f = t_front * hf;
      src_b = t_back * hb;
      // The face rows take the films; a cavity lane rebuilds every row at its
      // start column's cavity U.
      if constexpr (kCav) cavity(Tn);
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (((fb | lb) >> j) & 1u) row_op(j);
      if (!long_runs) factor(cav_lane ? heads1 : dyn);

      // ---- the no-mass march (march_nomass) ---------------------------------
      if (pc.iters == 1) {
        T x[M];
        nomass_solve(Tn, x);
#pragma unroll
        for (int j = 0; j < M; ++j)
          if ((sb >> j) & 1u) Tn[j] = T(0.5) * (Tn[j] + x[j]);
      } else {
        // The masked iterations (nomass_step); per-run state at each head.
        T oerr[M];
        int cnt[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          oerr[j] = T(99999.0);
          cnt[j] = 0;
        }
        unsigned act = hd;
        const bool adaptive = pc.iters < 0;
        const int n = adaptive ? pc.max_iter : pc.iters;
        for (int it = 0; it < n; ++it) {
          if (adaptive && !__any_sync(g.mask, act != 0u)) break;
          if (kCav && it > 0) {  // a cavity lane's rows at this iteration's input
            cavity(Tn);
            if (!long_runs) factor(cav_lane ? heads1 : 0u);
          }
          T x[M], d[M], err[M];
#pragma unroll
          for (int j = 0; j < M; ++j) err[j] = T(0);
          nomass_solve(Tn, x);
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const T e = m_abs(x[j] - Tn[j]);
            d[j] = (((sb >> j) & 1u) && !(e < T(1e-25))) ? e : T(0);
          }
          // Each run's error in ascending node order, at its head.
          if (!long_runs) {
            const T dn0 = g.next(d[0], 1, T(0));
#pragma unroll
            for (int j = 0; j < M; ++j)
              err[j] = (T(0) + d[j]) + (((ph >> j) & 1u) ? (j + 1 < M ? d[j + 1] : dn0) : T(0));
          } else {
            T e = T(0);
            int head = 0;
            for (int k = 0; k < N; ++k) {
              const T dk = row_of<M>(g, d, k);
              if ((W.head >> k) & 1u) {
                e = T(0);
                head = k;
              }
              if ((W.sel >> k) & 1u) {
                e += dk;
                const bool end = k + 1 >= 32 || !((W.cont >> (k + 1)) & 1u);
                if (end && head / M == g.rank) put(err, head % M, e);
              }
            }
          }
          // Relax the active runs whose error did not grow; test convergence
          // on the mean error with the escalating tolerance.
          unsigned moved = 0u;
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (!((hd >> j) & 1u)) continue;
            const unsigned run = long_runs ? W.run(row0 + j) : (((ph >> j) & 1u) ? 3u : 1u) << (row0 + j);
            const bool active = (act >> j) & 1u;
            const bool increase = err[j] > oerr[j];
            if (active && !increase) {
              moved |= run;
              oerr[j] = err[j];
            }
            const T tol = cnt[j] < pc.esc_after ? pc.tol : pc.tol_esc;
            const bool converged = err[j] / T(__popc(run)) < tol;
            if (active && !increase && !converged)
              ++cnt[j];
            else
              act &= ~(1u << j);
          }
          moved = group_or(g, moved);
#pragma unroll
          for (int j = 0; j < M; ++j)
            if ((moved >> (row0 + j)) & 1u) Tn[j] = T(0.5) * (Tn[j] + x[j]);
        }
      }

      // ---- RK4 on the massive rows (march_massive) ---------------------------
      if constexpr (kCav) cavity(Tn);  // a cavity lane's rows at the post-no-mass column
      {
        const T wu = g.prev(Tn[M - 1], 1, T(0)), wd = g.next(Tn[0], 1, T(0));
#pragma unroll
        for (int j = 0; j < M; ++j) qs[j] = ((mb >> j) & 1u) ? row_q(j, Tn, wu, wd) * P[j] : T(0);
      }
      T acc[M], y[M];
      stage(Tn);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        acc[j] = Tn[j] + kk[j] * T(1.0 / 6.0);
        y[j] = Tn[j] + T(0.5) * kk[j];
      }
      stage(y);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        acc[j] += kk[j] * T(1.0 / 3.0);
        y[j] = Tn[j] + T(0.5) * kk[j];
      }
      stage(y);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        acc[j] += kk[j] * T(1.0 / 3.0);
        y[j] = Tn[j] + kk[j];
      }
      stage(y);
#pragma unroll
      for (int j = 0; j < M; ++j)
        if ((mb >> j) & 1u) Tn[j] = acc[j] + kk[j] * T(1.0 / 6.0);

      // ---- the films of the new column, the zone sums -----------------------
      faces(ts_f, ts_b);
      const T h2 = parity_face_h(L, back, back ? t_back : t_front,
                                 parity_face_surf(L, back, ts_f, ts_b, a.amb_bug), base);
      hf = g.from(h2, 0);
      hb = g.from(h2, 1);
      if (g.rank == 0) {
        qf = (ts_f - t_front) * hf;
        qb = (ts_b - t_back) * hb;
        const T haf = hf * LB.area, hab = hb * LB.area;
        s_haT[2 * slot] = haf * ts_f;
        s_ha[2 * slot] = haf;
        s_haT[2 * slot + 1] = hab * ts_b;
        s_ha[2 * slot + 1] = hab;
      }
      __syncthreads();

      // Zone sums and the exact exponential zone update: a warp per zone
      // when the block is whole warps (zone_sums_warp; its lane 0 updates the
      // zone), else a thread per zone in list order.
      for (int z = by_warp ? tid >> 5 : tid; z < ZB; z += zstep) {
        const int gz = b * ZB + z;
        T az, bz;
        if (by_warp)
          zone_sums_warp(s_zptr, s_zf, z, tid & 31, s_haT, s_ha, s_ga[z], s_gb[z], az, bz);
        else
          zone_sums_shared(s_zptr, s_zf, z, s_haT, s_ha, s_ga[z], s_gb[z], az, bz);
        if (by_warp && (tid & 31)) continue;
        if (kExt) {
          if (a.mix_ptr) mix_sums(a, gz, s_zT, az, bz);
          if (a.ctl) {
            T load;
            const Setpoints<T> sp(s_sp[z], s_sp[ZB + z], s_sp[2 * ZB + z], s_sp[3 * ZB + z]);
            s_zN[z] = zone_update_ctl(s_zT[z], az, bz, s_vol[z], dt, sp, load);
            s_ld[z] += load;
          } else {
            s_zN[z] = zone_update(s_zT[z], az, bz, s_vol[z], dt);
          }
        } else {
          s_zT[z] = zone_update(s_zT[z], az, bz, s_vol[z], dt);
        }
      }
      __syncthreads();
      if (kExt) {  // the new row becomes the current one
        T* t = s_zT;
        s_zT = s_zN;
        s_zN = t;
      }
    }

    // ---- end of hour: the histories, the non-finite count -----------------
    if constexpr (kMrt) {
      if (m.hq_hist && g.rank == 0) {
        T* hq_h = m.hq_hist + (size_t)h * 4 * SP + lane;
        hq_h[0] = hf;
        hq_h[SP] = hb;
        hq_h[2 * SP] = qf;
        hq_h[3 * SP] = qb;
      }
      if (m.top) {  // the zone-air-started network on the hour's final state
        const MrtLane<T> ML(a, m.net, lane);
        T t_front, t_back, ts_f, ts_b;
        LB(s_zT, s_wx[sub - 1], t_front, t_back);
        faces(ts_f, ts_b);
        mrt_face_node(ZB, s_mptr, s_mf, tid, nthreads, g.rank < 2, ((ML.bits >> int(back)) & 1u) != 0,
                      2 * slot + int(back), back ? LB.zone_b : LB.zone_f, back ? ML.eb : ML.ef, LB.area,
                      back ? ts_b : ts_f, back ? t_back : t_front, s_zT, s_ha, s_haT, s_tm);
        for (int z = tid; z < ZB; z += nthreads)
          m.top[(size_t)h * NB * ZB + b * ZB + z] = (s_zT[z] + s_tm[z]) / T(2);
      }
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (((vb >> j) & 1u) && !is_finite(Tn[j])) ++cnt;
    for (int z = tid; z < ZB; z += nthreads) {
      const T zt = s_zT[z];
      m.zt_hist[(size_t)h * NB * ZB + b * ZB + z] = zt;
      if (!is_finite(zt)) ++cnt;
      if (kExt && a.ctl) {
        m.ld_hist[(size_t)h * NB * ZB + b * ZB + z] = s_ld[z] / T(sub);
        s_ld[z] = T(0);
      }
    }
    if (tid == 0) s_bad = 0;
    __syncthreads();
    if (cnt) atomicAdd(&s_bad, cnt);
    __syncthreads();
    if (tid == 0) m.bad[h * NB + b] = T(s_bad);
  }

#pragma unroll
  for (int j = 0; j < M; ++j)
    if (row0 + j < N) m.T_out[(row0 + j) * SP + lane] = Tn[j];
  if (g.rank == 0) {
    m.hq[lane] = hf;
    m.hq[SP + lane] = hb;
    m.hq[2 * SP + lane] = qf;
    m.hq[3 * SP + lane] = qb;
  }
  for (int z = tid; z < ZB; z += nthreads) m.zT_out[b * ZB + z] = s_zT[z];
}

template <typename T, int kV, bool kExt, bool kCav, bool kMrt>
int launch_parity(const MarchArgsOf<T, kMrt>& m, cudaStream_t stream) {
  constexpr int kThreads = kLaunchVariants[kV].threads;
  constexpr int kBlocks = kVariantBlocks<T, kV>;
  const DayArgs<T>& a = m.in;
  const size_t smem = parity_smem<T, kExt, kMrt, (kThreads < 1024)>(a);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(day_march_parity_kernel<T, kThreads, kBlocks, kExt, kCav, kMrt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  day_march_parity_kernel<T, kThreads, kBlocks, kExt, kCav, kMrt><<<a.NB, a.SB * kGroup, smem, stream>>>(m);
  return static_cast<int>(cudaGetLastError());
}

// The kind's kernel in the launch variant that takes the block's lanes.
template <typename T, bool kExt, bool kCav, bool kMrt>
int launch_kind(const MarchArgsOf<T, kMrt>& m, cudaStream_t st) {
  switch (launch_variant(m.in.SB)) {
    case 0: return launch_parity<T, 0, kExt, kCav, kMrt>(m, st);
    case 1: return launch_parity<T, 1, kExt, kCav, kMrt>(m, st);
    case 2: return launch_parity<T, 2, kExt, kCav, kMrt>(m, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifndef HEATX_DAY_MARCH_PARITY_KMRT_UNIT
// Free-float buildings run the kind without the extra zone code; thermostats,
// mixing, shading or gates the extended one (kExt); gas cavities the extended
// one with the cavity code (kCav); MRT physics and the histories the kMrt
// unit's kinds.
template <typename T>
int day_march_parity(const void* args, void* stream) {
  const MrtMarchArgs<T>& m = *static_cast<const MrtMarchArgs<T>*>(args);
  const DayArgs<T>& a = m.in;
  if (m.net.mrt)
    return std::is_same_v<T, float> ? heatx_day_march_parity_mrt_f32(args, stream)
                                    : heatx_day_march_parity_mrt_f64(args, stream);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MarchArgs<T>& base = m;
  if (a.cav) return launch_kind<T, true, true, false>(base, st);
  const bool ext = a.ctl || a.mix_ptr || a.shade_slot || a.vent_min;
  return ext ? launch_kind<T, true, false, false>(base, st) : launch_kind<T, false, false, false>(base, st);
}
#else
template <typename T>
int day_march_parity_mrt(const void* args, void* stream) {
  const MrtMarchArgs<T>& m = *static_cast<const MrtMarchArgs<T>*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return m.in.cav ? launch_kind<T, true, true, true>(m, st) : launch_kind<T, true, false, true>(m, st);
}
#endif

}  // namespace

extern "C" {
#ifndef HEATX_DAY_MARCH_PARITY_KMRT_UNIT
int heatx_day_march_parity_f32(const void* m, void* stream) { return day_march_parity<float>(m, stream); }
int heatx_day_march_parity_f64(const void* m, void* stream) { return day_march_parity<double>(m, stream); }
#else
int heatx_day_march_parity_mrt_f32(const void* m, void* stream) { return day_march_parity_mrt<float>(m, stream); }
int heatx_day_march_parity_mrt_f64(const void* m, void* stream) { return day_march_parity_mrt<double>(m, stream); }
#endif
}  // extern "C"
