// The parity day adjoint for NVIDIA Hopper (sm_90a): four threads per
// surface.  day_adjoint.cu's C entry hands every parity launch to
// heatx_day_adjoint_parity_f32/_f64 here (ctypes; heatx_torch/ops/
// day_adjoint.py); the kMrt kinds are day_adjoint_parity_mrt.cu's.
//
// Replaces heatx/ops/pallas_adjoint.py::make_day_adjoint -> `kernel` (the
// pl.pallas_call at pallas_adjoint.py:717) in mode parity: the reverse of
// `_hour_body(unroll=True)` (pallas_adjoint.py:573-592) under jax.vjp
// (:651-680), free-float and with thermostats, schedules and mixing (one
// kind: their rows are checked at run time), with gas cavities (kCav), with
// interior MRT (kMrt), with 1, 2 or 3 fixed no-mass
// iterations (heatx refuses the adaptive loop, and so does the C entry).  It
// returns what autograd through the plain parity march gives
// (ops/day_march.py plain_hour_parity; day_adjoint.cu lists the outputs).
//
// What bounded the first design (one thread per surface, in day_adjoint.cu
// until this kernel replaced it): 1,594 ms a bench-city day-launch against a
// bound of 0.825 ms.  Each thread carried a per-thread tape of 18 runtime-
// indexed columns in local memory; each reverse sub-step first re-ran its
// forward on a one-thread sub-step with Thomas sweeps down the whole column,
// a code the forward kernel no longer ran, so in f32 the adjoint
// differentiated a march the forward never took; 2.5 warps an SM held the
// latency of one block's chain.
//
// This design:
//  * G = 4 threads per surface lane (kGroup), thread `rank` owning the M =
//    32/G node rows [rank*M, rank*M + M) in unrolled register arrays, in the
//    launch variants of kAdjLaunchVariants (day_march_args.cuh).
//  * The recompute is the parity forward kernel's (day_march_parity.cu), in
//    its order: the launch-constant rows (dt/C, K's rows scaled on massive
//    rows), the faces split over the group (parity_face_ops), the cavity U in
//    registers, mrt_face_node, heatx's closed form for runs of one or two
//    no-mass rows (a pair across a rank edge by shuffle) or Thomas broadcast
//    down the column for longer runs, RK4 by rows, the warp zone sums and the
//    zone updates.  So the f32 hour starts are the forward kernel's to the
//    bit.  Pass 1 marches the day to store each hour's start (the last hour
//    is not marched); pass 2 re-marches each hour from its start, writing
//    each sub-step's start column to the tape, and sweeps the hour backwards.
//  * The tape lives in a workspace the wrapper allocates (one hour: each
//    thread's rows at every sub-step start, [substeps, 32, SP] values, laid
//    out so that a warp's 32 threads read 32 consecutive values); the zone
//    rows and sums of each sub-step stay in shared memory (in the
//    1024-thread variant in the workspace after the tape, so that its shared
//    memory does not grow with the sub-steps and no block is refused).
//  * The reverse of a sub-step recomputes its forward from the taped start
//    (the post-no-mass column, the four RK4 stages, both film evaluations),
//    then, backwards: the zone sums and the second film on the face ranks;
//    RK4's stages 3 to 0, each a transposed stage by rows (K^T g, the
//    neighbour rows by two shuffles), the capacity's cotangent on the owning
//    thread, the band's folded at once into one cotangent per segment's U;
//    the forcing q; the no-mass iterations backwards, each iteration's input
//    recomputed from the start column (its update mask with it; the masks
//    carry no cotangent), the closed form transposed on the run's head (a
//    pair across a rank edge by one shuffle each way) or Thomas transposed,
//    a cavity lane's K at that iteration's input; the first film and the
//    forced term on the face ranks (the front's on rank 0, the back's on
//    rank 1; the MIN_H floor decided on the forward's own cube root), the
//    MRT network backwards (mrt_face_node_adj); a cavity segment's U through
//    dU/dT into the column it was built on.
//  * Day accumulators (the node rows' cotangents) sit in per-thread shared
//    slots in the 128- and 256-thread variants, in registers in the 1024
//    one; the surface parameters' cotangents accumulate on the thread that
//    computed each term and are summed over the group once a day.  Per-zone
//    cotangents stay on one thread per zone, the boundary cotangents' face
//    sums in the forward's fixed order: no float atomics, deterministic.

#include <type_traits>

#include "day_adjoint_args.cuh"
#include "day_march_args.cuh"
#include "day_parity.cuh"
#include "day_parity_adj.cuh"

// The kMrt kinds live in their own compilation unit (day_adjoint_parity_mrt.cu,
// which includes this file), as the day march's do.
extern "C" int heatx_day_adjoint_parity_mrt_f32(const void* g, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_parity_mrt_f64(const void* g, void* stream, int* block_threads);

namespace {

using namespace heatx;

// Whether a variant keeps each thread's rows' solar forcing and day
// accumulators in shared memory, and the hour's zone rows of every sub-step
// and its weather (the 1024-thread variant keeps the rows in registers and
// the hour's zone rows and weather in the workspace after the tape).
template <int kThreads>
constexpr bool kParityAdjStaged = kThreads < 1024;

// Values of the hour's zone rows and weather of one block: zone T at each
// sub-step start and the hour's end, a_z and b_z of each sub-step, t_out,
// wind and the sine and cosine of wdir of each sub-step.
__host__ __device__ inline size_t parity_hour_rows(int substeps, int ZB) {
  return static_cast<size_t>(3 * substeps + 1) * ZB + 4 * static_cast<size_t>(substeps);
}

// Per-thread rows a staged variant keeps in shared memory: the hour's solar
// forcing, the day's cotangents of U (to the row below), the capacity and the
// two absorption fractions, and the hour's cotangent of the absorbed solar.
constexpr int kParityAdjRows = 6;

// Bytes of a block's dynamic shared memory: with kStaged the hour's zone
// rows and weather (parity_hour_rows) and kParityAdjRows rows per thread; the
// zone rows of the hour (volumes, gains, cotangents, the setpoints and
// their cotangents; with kMrt the network's rows), the per-face rows, the
// lanes' boundaries and face statics, then the zone lists and, with kMrt, the
// network lists (ints).
template <typename T, bool kMrt, bool kStaged>
size_t parity_adj_smem(const DayArgs<T>& a) {
  const size_t ZB = a.ZB, SB = a.SB;
  const size_t zrows = 16 + (kMrt ? 5 : 0);
  const size_t staged =
      kStaged ? parity_hour_rows(a.substeps, a.ZB) + kParityAdjRows * static_cast<size_t>(kMaxNodes) * SB : 0;
  const size_t lists = (kMrt ? 2 : 1) * (ZB + 1 + 2 * SB);
  return sizeof(T) * (zrows * ZB + 6 * SB + staged) + (sizeof(LaneBounds<T>) * SB + 16) +
         (sizeof(FaceStatics<T>) * SB + 16) + sizeof(int) * lists;
}

template <typename T, int kThreads, int kMinBlocks, bool kCav, bool kMrt>
__global__ void __launch_bounds__(kThreads, kMinBlocks) day_adjoint_parity_kernel(const AdjArgsOf<T, kMrt> g) {
  constexpr int G = kGroup;
  constexpr int M = kMaxNodes / G;
  constexpr bool kShared = kParityAdjStaged<kThreads>;
  const DayArgs<T>& a = g.in;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB, sub = a.substeps;
  // The hour's zone rows of every sub-step and its weather: in shared memory
  // (kShared) or in this block's part of the workspace after the tape.
  T* const hz = kShared ? reinterpret_cast<T*>(smem_raw)
                        : g.tape + static_cast<size_t>(sub) * kMaxNodes * NB * SB +
                              static_cast<size_t>(blockIdx.x) * parity_hour_rows(sub, ZB);
  T* s_zt = hz;                     // [(sub+1)*ZB] zone T at each sub-step start, and the hour's end
  T* s_az = s_zt + (sub + 1) * ZB;  // [sub*ZB] a_z of each sub-step
  T* s_bz = s_az + sub * ZB;        // [sub*ZB] b_z of each sub-step
  T* s_wx = s_bz + sub * ZB;        // [4*sub] the hour's t_out, wind, sin and cos wdir
  T* s_vol = kShared ? s_wx + 4 * sub : reinterpret_cast<T*>(smem_raw);  // [ZB] zone volumes
  T* s_ga = s_vol + ZB;                      // [ZB] the hour's a_extra
  T* s_gb = s_ga + ZB;                       // [ZB] the hour's b_extra
  T* s_lz = s_gb + ZB;                       // [ZB] zone-T cotangent
  T* s_laz = s_lz + ZB;                      // [ZB] a_z cotangent
  T* s_lbz = s_laz + ZB;                     // [ZB] b_z cotangent
  T* s_dV = s_lbz + ZB;                      // [ZB] zone-volume cotangent (day)
  T* s_da = s_dV + ZB;                       // [ZB] a_extra cotangent (hour)
  T* s_db = s_da + ZB;                       // [ZB] b_extra cotangent (hour)
  T* s_lld = s_db + ZB;                      // [ZB] cotangent of each sub-step's load (hour)
  T* s_dsh = s_lld + ZB;                     // [ZB] heating-setpoint cotangent (hour or day)
  T* s_dsc = s_dsh + ZB;                     // [ZB] cooling-setpoint cotangent
  T* s_sp = s_dsc + ZB;                      // [4][ZB] the hour's Setpoints
  T* s_tm = s_sp + 4 * ZB;                   // kMrt: [ZB] the zones' MRT nodes
  T* s_lnum = s_tm + (kMrt ? ZB : 0);        // kMrt: [ZB] cotangents of a zone's network sums
  T* s_lden = s_lnum + (kMrt ? ZB : 0);
  T* s_lm = s_lden + (kMrt ? ZB : 0);        // kMrt: [ZB] cotangent of a zone's MRT node
  T* s_lzf = s_lm + (kMrt ? ZB : 0);         // kMrt: [ZB] the network's fallback cotangent
  T* s_haT = s_lzf + (kMrt ? ZB : 0);        // [2*SB] h*A*T_s per face (kMrt: also w*T_s)
  T* s_ha = s_haT + 2 * SB;                  // [2*SB] h*A per face (kMrt: also w)
  T* s_lt = s_ha + 2 * SB;                   // [2*SB] boundary-T cotangent per face
  // [M][blockDim] each: the thread's kParityAdjRows rows (row j of thread t at
  // j*blockDim + t, read by that thread only)
  T* s_rows = s_lt + 2 * SB;
  LaneBounds<T>* s_lb = reinterpret_cast<LaneBounds<T>*>(
      (reinterpret_cast<size_t>(s_rows + (kShared ? kParityAdjRows * kMaxNodes * SB : 0)) + 15) &
      ~static_cast<size_t>(15));
  FaceStatics<T>* s_fs = reinterpret_cast<FaceStatics<T>*>(
      (reinterpret_cast<size_t>(s_lb + SB) + 15) & ~static_cast<size_t>(15));
  int* s_zptr = reinterpret_cast<int*>(s_fs + SB);  // [ZB+1] block-local face offsets
  int* s_zf = s_zptr + ZB + 1;                      // [<= 2*SB] the zones' faces
  int* s_mptr = s_zf + 2 * SB;                      // kMrt: [ZB+1] the network lists' offsets
  int* s_mf = s_mptr + ZB + 1;                      // kMrt: [<= 2*SB] the zones' network faces

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int SP = NB * SB;
  const int slot = tid / G;  // the lane's place in the block
  const int lane = b * SB + slot;
  const Group<G> gr{block_warp_mask(), tid % G};
  const int row0 = gr.rank * M;
  const bool back = gr.rank != 0;  // this thread's face in the film evaluations
  const bool owner = gr.rank < 2;  // the face's reverse: front on rank 0, back on rank 1
  const ParityCfg<T> pc(a);
  const T dt = pc.dt;
  if (gr.rank == 0) {
    const Lane<T> L(a, lane, kCav);
    s_lb[slot] = LaneBounds<T>(L);
    s_fs[slot] = FaceStatics<T>(L);
  }
  const LaneBounds<T>& LB = s_lb[slot];
  const FaceStatics<T>& L = s_fs[slot];

  // The lane's rows as words (bit i: row i), and the thread's share (bit j:
  // row row0 + j), as the forward kernel takes them.
  const RowWords W(static_cast<unsigned>(a.lane[LN_BITS * SP + lane]),
                   static_cast<unsigned>(a.lane[LN_MASS * SP + lane]),
                   static_cast<unsigned>(a.lane[LN_CHUNK * SP + lane]), N);
  constexpr unsigned own = (1u << M) - 1u;
  const unsigned fb = (W.first >> row0) & own, lb = (W.last >> row0) & own;
  const unsigned mb = (W.mass >> row0) & own, sb = (W.sel >> row0) & own;
  const unsigned cl = (W.coup_l >> row0) & own, cr = (W.coup_r >> row0) & own;
  const unsigned dl = (W.dir_l >> row0) & own, dr = (W.dir_r >> row0) & own;
  const unsigned hd = (W.head >> row0) & own;
  const unsigned ph = (W.pair >> row0) & own, pt = ((W.pair << 1) >> row0) & own;
  const unsigned left = W.coup_l | W.dir_l;
  const unsigned links = (left >> (row0 + 1)) & own;  // bit j: rows j and j+1 joined by a segment
  const unsigned cav_w = kCav ? static_cast<unsigned>(a.lane[LN_CAV * SP + lane]) : 0u;
  const unsigned cav = (cav_w >> row0) & own;
  const bool cav_lane = cav_w != 0u;
  // A block with a no-mass run of three or more nodes solves by Thomas.
  const bool long_runs = __syncthreads_or(W.long_run()) != 0;
  const unsigned faces_w = W.first | W.last;
  const unsigned heads1 = sb & ~pt;
  const unsigned dyn = (((W.sel & (faces_w | (W.pair & (faces_w >> 1)))) >> row0) & own) & ~pt;
  const bool one_last = __all_sync(gr.mask, __popc(W.last) <= 1);
  const int last_owner = W.last ? (31 - __clz(W.last)) / M : 0;

  const T* U = a.node + (ND_U * N) * SP + lane;
  const T* FA = a.node + (ND_FA * N) * SP + lane;
  const T* FB = a.node + (ND_FB * N) * SP + lane;
  // The forward kernel's rows: the column; U to the row above (0 off the
  // column); K's rows A, D, C (scaled by dt/C on massive rows); P: dt/C on
  // massive rows, the closed form's reciprocal denominator on a no-mass run's
  // rows.  Rows load unconditionally (clamped indices, then a select).
  T Tn[M], ul[M], A[M], D[M], C[M], P[M];
  T* const rows = s_rows + tid;
  Rows<T, M, kShared> sq{rows, nthreads};  // the hour's absorbed solar
  Rows<T, M, kShared> dU{rows + kMaxNodes * SB, nthreads}, dCap{rows + 2 * kMaxNodes * SB, nthreads};
  Rows<T, M, kShared> dFA{rows + 3 * kMaxNodes * SB, nthreads}, dFB{rows + 4 * kMaxNodes * SB, nthreads};
  Rows<T, M, kShared> lqh{rows + 5 * kMaxNodes * SB, nthreads};  // the hour's cotangent of sq
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int i = row0 + j, ic = min(i, N - 1);
    const T t0 = a.T0[ic * SP + lane], c = a.node[(ND_CAP * N + ic) * SP + lane];
    const T u = U[min(max(i - 1, 0), N - 1) * SP];
    Tn[j] = i < N ? t0 : T(0);
    ul[j] = ((left >> i) & 1u) ? u : T(0);
    P[j] = ((mb >> j) & 1u) ? dt / c : T(0);
    sq[j] = T(0);
    dU[j] = dCap[j] = dFA[j] = dFB[j] = T(0);
  }
  const int il = row0 + M - 1;  // the segment below the thread's last row
  T ur_last = (il + 1 < 32 && ((left >> (il + 1)) & 1u)) ? U[il * SP] : T(0);

  // ---- the forward kernel's sub-step pieces (day_march_parity.cu) ----------
  T hf = T(0), hb = T(0), radf = T(0), radb = T(0), rad_ft = T(0), rad_bt = T(0), src_f = T(0), src_b = T(0);
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

  T nD = T(1), nA = T(0), pD = T(1), pC = T(0);
  auto factor = [&](unsigned mask) {
    nD = gr.next(D[0], 1, T(1));
    nA = gr.next(A[0], 1, T(0));
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T dn = j + 1 < M ? D[j + 1] : nD, an = j + 1 < M ? A[j + 1] : nA;
      const T den = ((ph >> j) & 1u) ? D[j] * dn - C[j] * an : D[j];
      if ((mask >> j) & 1u) P[j] = T(1) / den;
    }
    const T pP = gr.prev(P[M - 1], 1, T(1));
#pragma unroll
    for (int j = 0; j < M; ++j)
      if ((pt >> j) & 1u) P[j] = j > 0 ? P[j - 1] : pP;
    pD = gr.prev(D[M - 1], 1, T(1));
    pC = gr.prev(C[M - 1], 1, T(0));
  };
  if (!long_runs) factor(heads1);

  auto row_q = [&](int j, const T(&w)[M], T wu, T wd) {
    T q = sq[j];
    q += ((fb >> j) & 1u) ? src_f + radf * (rad_ft - w[j]) : T(0);
    q += ((lb >> j) & 1u) ? src_b + radb * (rad_bt - w[j]) : T(0);
    q += ((dl >> j) & 1u) ? ul[j] * (j > 0 ? w[j - 1] : wu) : T(0);
    q += ((dr >> j) & 1u) ? (j + 1 < M ? ul[j + 1] : ur_last) * (j + 1 < M ? w[j + 1] : wd) : T(0);
    return q;
  };

  // Thomas down the lane's column on the rows (Al, Dl, Cl) of the no-mass
  // rows, identity rows elsewhere: x solves it for the right-hand side r
  // (w on the identity rows), each row's coefficients broadcast from the
  // thread that holds it.
  auto thomas = [&](const T(&Al)[M], const T(&Cl)[M], const T(&r)[M], const T(&w)[M], T(&x)[M]) {
    T cs[M], ds[M];
#pragma unroll
    for (int j = 0; j < M; ++j) x[j] = w[j];
    T cs_p = T(0), ds_p = T(0);
    for (int k = 0; k < N; ++k) {
      const T lk = row_of<M>(gr, Al, k), dk = row_of<M>(gr, D, k), uk = row_of<M>(gr, Cl, k);
      const T rk = row_of<M>(gr, r, k), wk = row_of<M>(gr, w, k);
      const bool s = (W.sel >> k) & 1u;
      const T l = s ? lk : T(0), u = s ? uk : T(0), rh = s ? rk : wk;
      const T inv = T(1) / ((s ? dk : T(1)) - l * cs_p);
      cs_p = u * inv;
      ds_p = (rh - l * ds_p) * inv;
      if (k / M == gr.rank) {
        put(cs, k % M, cs_p);
        put(ds, k % M, ds_p);
      }
    }
    T xn = T(0);
    for (int k = N - 1; k >= 0; --k) {
      const T xo = k == N - 1 ? pick(ds, k % M) : pick(ds, k % M) - pick(cs, k % M) * xn;
      xn = gr.from(xo, k / M);
      if (k / M == gr.rank) put(x, k % M, xn);
    }
  };

  auto nomass_solve = [&](const T(&w)[M], T(&x)[M]) {
    const T wu = gr.prev(w[M - 1], 1, T(0)), wd = gr.next(w[0], 1, T(0));
    T r[M];
#pragma unroll
    for (int j = 0; j < M; ++j) r[j] = -row_q(j, w, wu, wd);
    if (!long_runs) {
      const T rn = gr.next(r[0], 1, T(0)), rp = gr.prev(r[M - 1], 1, T(0));
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
    thomas(A, C, r, w, x);
  };

  auto cavity = [&](const T(&w)[M]) {
    const T w_next = gr.next(w[0], 1, T(0));
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
    ul[0] = gr.prev(ur_last, 1, T(0));
    if (cav_lane) {
#pragma unroll
      for (int j = 0; j < M; ++j) row_op(j);
    }
  };

  auto faces = [&](const T(&x)[M], T& ts_f, T& ts_b) {
    T part = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j)
      if ((lb >> j) & 1u) part += x[j];
    ts_b = one_last ? gr.from(part, last_owner) : gr.sum(part);
    ts_f = gr.from(x[0], 0);
  };

  T qs[M];
  auto stage = [&](const T(&y)[M], T(&kk)[M]) {
    const T yu = gr.prev(y[M - 1], 1, T(0)), yd = gr.next(y[0], 1, T(0));
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T up = j > 0 ? y[j - 1] : yu, down = j + 1 < M ? y[j + 1] : yd;
      const T k = ((D[j] * y[j] + A[j] * up) + C[j] * down) + qs[j];
      kk[j] = ((mb >> j) & 1u) ? k : T(0);
    }
  };

  // The sub-step's operators from its start column x (sub-step i of the
  // current hour, zone row zt): the first film evaluation on the face ranks,
  // the cavity U, the face rows, the runs' factors.  Returns the boundary
  // temperatures (tf, tb), the forced term, and with kMrt this thread's face's
  // effective emissivity and MRT node (the network's history in hist).
  T rad_out = T(0);  // the hour's outdoor radiant temperature of this thread's face
  T me = T(0), tm = T(0), hist[4];
  auto operators = [&](int i, const T* zt, const T(&x)[M], T& tf, T& tb, T& base) {
    T ts_f, ts_b;
    LB(zt, s_wx[i], tf, tb);
    faces(x, ts_f, ts_b);
    if constexpr (kMrt) {  // kMrt launches run MRT physics
      const MrtLane<T> ML(a, g.net, lane);
      me = back ? ML.eb : ML.ef;
      tm = mrt_face_node<T, true>(ZB, s_mptr, s_mf, tid, nthreads, owner, ((ML.bits >> int(back)) & 1u) != 0,
                                  2 * slot + int(back), back ? LB.zone_b : LB.zone_f, me, L.area,
                                  back ? ts_b : ts_f, back ? tb : tf, zt, s_ha, s_haT, s_tm, hist);
    }
    base = L.base(s_wx[sub + i], s_wx[2 * sub + i], s_wx[3 * sub + i]);
    const FaceOps<T> fo = parity_face_ops<T, kMrt>(L, back, ts_f, ts_b, tf, tb, rad_out, base, a.amb_bug, me, tm);
    hf = gr.from(fo.h, 0);
    radf = gr.from(fo.rad, 0);
    rad_ft = gr.from(fo.rad_t, 0);
    hb = gr.from(fo.h, 1);
    radb = gr.from(fo.rad, 1);
    rad_bt = gr.from(fo.rad_t, 1);
    src_f = tf * hf;
    src_b = tb * hb;
    if constexpr (kCav) cavity(x);
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (((fb | lb) >> j) & 1u) row_op(j);
    if (!long_runs) factor(cav_lane ? heads1 : dyn);
  };

  // The masked no-mass iterations (nomass_step) from the sub-step's start
  // column x, on the operators `operators` built from it: iterations 0 ..
  // upto - 1 applied to x in place, then iteration upto's solve w -> xs and
  // the lane's rows it moves (`moved`, the lane-wide word); with upto = iters
  // the whole march (no solve after it).  Per-run state at each head.
  auto nomass_run = [&](T(&x)[M], int upto, T(&xs)[M], unsigned& moved) {
    T oerr[M];
    int cnt[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      oerr[j] = T(99999.0);
      cnt[j] = 0;
    }
    unsigned act = hd;
    const int n = upto < pc.iters ? upto + 1 : pc.iters;
    for (int it = 0; it < n; ++it) {
      if (kCav && it > 0) {  // a cavity lane's rows at this iteration's input
        cavity(x);
        if (!long_runs) factor(cav_lane ? heads1 : 0u);
      }
      T d[M], err[M];
#pragma unroll
      for (int j = 0; j < M; ++j) err[j] = T(0);
      nomass_solve(x, xs);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T e = m_abs(xs[j] - x[j]);
        d[j] = (((sb >> j) & 1u) && !(e < T(1e-25))) ? e : T(0);
      }
      if (!long_runs) {
        const T dn0 = gr.next(d[0], 1, T(0));
#pragma unroll
        for (int j = 0; j < M; ++j)
          err[j] = (T(0) + d[j]) + (((ph >> j) & 1u) ? (j + 1 < M ? d[j + 1] : dn0) : T(0));
      } else {
        T e = T(0);
        int head = 0;
        for (int k = 0; k < N; ++k) {
          const T dk = row_of<M>(gr, d, k);
          if ((W.head >> k) & 1u) {
            e = T(0);
            head = k;
          }
          if ((W.sel >> k) & 1u) {
            e += dk;
            const bool end = k + 1 >= 32 || !((W.cont >> (k + 1)) & 1u);
            if (end && head / M == gr.rank) put(err, head % M, e);
          }
        }
      }
      unsigned mv = 0u;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (!((hd >> j) & 1u)) continue;
        const unsigned run = long_runs ? W.run(row0 + j) : (((ph >> j) & 1u) ? 3u : 1u) << (row0 + j);
        const bool active = (act >> j) & 1u;
        const bool increase = err[j] > oerr[j];
        if (active && !increase) {
          mv |= run;
          oerr[j] = err[j];
        }
        const T tol = cnt[j] < pc.esc_after ? pc.tol : pc.tol_esc;
        const bool converged = err[j] / T(__popc(run)) < tol;
        if (active && !increase && !converged)
          ++cnt[j];
        else
          act &= ~(1u << j);
      }
      moved = group_or(gr, mv);
      if (it == upto) return;
#pragma unroll
      for (int j = 0; j < M; ++j)
        if ((moved >> (row0 + j)) & 1u) x[j] = T(0.5) * (x[j] + xs[j]);
    }
  };

  // The no-mass march of the sub-step from x, in place (march_nomass).
  auto nomass = [&](T(&x)[M]) {
    T xs[M];
    if (pc.iters == 1) {
      nomass_solve(x, xs);
#pragma unroll
      for (int j = 0; j < M; ++j)
        if ((sb >> j) & 1u) x[j] = T(0.5) * (x[j] + xs[j]);
    } else {
      unsigned moved = 0u;
      nomass_run(x, pc.iters, xs, moved);
    }
  };

  // RK4 on the massive rows from the post-no-mass column Tm: qs and the four
  // stages k[s]; Tnew the new column.
  auto massive = [&](const T(&Tm)[M], T(&k)[4][M], T(&Tnew)[M]) {
    if constexpr (kCav) cavity(Tm);  // a cavity lane's rows at the post-no-mass column
    {
      const T wu = gr.prev(Tm[M - 1], 1, T(0)), wd = gr.next(Tm[0], 1, T(0));
#pragma unroll
      for (int j = 0; j < M; ++j) qs[j] = ((mb >> j) & 1u) ? row_q(j, Tm, wu, wd) * P[j] : T(0);
    }
    T acc[M], y[M];
    stage(Tm, k[0]);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      acc[j] = Tm[j] + k[0][j] * T(1.0 / 6.0);
      y[j] = Tm[j] + T(0.5) * k[0][j];
    }
    stage(y, k[1]);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      acc[j] += k[1][j] * T(1.0 / 3.0);
      y[j] = Tm[j] + T(0.5) * k[1][j];
    }
    stage(y, k[2]);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      acc[j] += k[2][j] * T(1.0 / 3.0);
      y[j] = Tm[j] + k[2][j];
    }
    stage(y, k[3]);
#pragma unroll
    for (int j = 0; j < M; ++j) Tnew[j] = ((mb >> j) & 1u) ? acc[j] + k[3][j] * T(1.0 / 6.0) : Tm[j];
  };

  // ---- zone lists and the day's start -------------------------------------
  const int e_base = a.zone_ptr[b * ZB];
  for (int z = tid; z <= ZB; z += nthreads) s_zptr[z] = a.zone_ptr[b * ZB + z] - e_base;
  for (int e = tid; e < a.zone_ptr[b * ZB + ZB] - e_base; e += nthreads) s_zf[e] = a.zone_faces[e_base + e];
  if constexpr (kMrt) {
    const int m_base = g.net.mrt_ptr[b * ZB];
    for (int z = tid; z <= ZB; z += nthreads) s_mptr[z] = g.net.mrt_ptr[b * ZB + z] - m_base;
    for (int e = tid; e < g.net.mrt_ptr[b * ZB + ZB] - m_base; e += nthreads) s_mf[e] = g.net.mrt_faces[m_base + e];
  }
  for (int z = tid; z < ZB; z += nthreads) {
    s_zt[z] = a.zT0[b * ZB + z];
    s_vol[z] = a.zone_volume[b * ZB + z];
  }
  __syncthreads();

  // The zone phase's threads in the march: a warp per zone when the block is
  // whole warps (as the forward kernel).
  const bool by_warp = (nthreads & 31) == 0;
  const int zstep = by_warp ? nthreads >> 5 : nthreads;

  // The tape: column c's row j of this thread at tape[(c*M + j) * TP], T at
  // sub-step c's start.
  const size_t TP = static_cast<size_t>(NB) * nthreads;
  T* const tape = g.tape + static_cast<size_t>(b) * nthreads + tid;
  auto tape_put = [&](int c, const T(&x)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) tape[(static_cast<size_t>(c) * M + j) * TP] = x[j];
  };
  auto tape_get = [&](int c, T(&x)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) x[j] = tape[(static_cast<size_t>(c) * M + j) * TP];
  };

  // March hour h from (Tn, the zone row s_zt[0:ZB]) as the forward kernel
  // does; with `taped`, write each sub-step's start column to the tape.  The
  // zone rows of every sub-step (and a_z, b_z) stay in s_zt, s_az, s_bz.
  auto march_hour = [&](int h, bool taped) {
    {  // the hour's clamped solar per row, the face's outdoor radiant temperature
      const T sfr = a.sol_f[h * SP + lane], sbr = a.sol_b[h * SP + lane];
      const T sol_f = (is_nan(sfr) || sfr < T(0)) ? T(0) : sfr;
      const T sol_b = is_nan(sbr) ? T(0) : sbr;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int ic = min(row0 + j, N - 1);
        const T q = FA[ic * SP] * sol_f + FB[ic * SP] * sol_b;
        sq[j] = row0 + j < N ? q : T(0);
      }
      const T ir = (back ? a.ir_b : a.ir_f)[h * SP + lane];
      rad_out = m_pow(m_max(ir, T(1e-30)) / T(kSigma), T(0.25)) - T(kKelvin);
    }
    {  // the hour's gains, setpoints and weather
      const size_t row = (size_t)h * NB * ZB + b * ZB;
      for (int z = tid; z < ZB; z += nthreads) {
        s_ga[z] = a.a_extra[row + z];
        s_gb[z] = a.b_extra[row + z];
        if (a.ctl) {
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
        s_wx[2 * sub + i] = m_sin(a.wdir[h * sub + i]);
        s_wx[3 * sub + i] = m_cos(a.wdir[h * sub + i]);
      }
      __syncthreads();
    }
    for (int i = 0; i < sub; ++i) {
      if (taped) tape_put(i, Tn);
      T tf, tb, base;
      operators(i, s_zt + i * ZB, Tn, tf, tb, base);
      nomass(Tn);
      {
        T k[4][M], Tm[M];
#pragma unroll
        for (int j = 0; j < M; ++j) Tm[j] = Tn[j];
        massive(Tm, k, Tn);
      }
      T ts_f, ts_b;
      faces(Tn, ts_f, ts_b);
      const T h2 = parity_face_h(L, back, back ? tb : tf, parity_face_surf(L, back, ts_f, ts_b, a.amb_bug), base);
      const T h2f = gr.from(h2, 0), h2b = gr.from(h2, 1);
      if (gr.rank == 0) {
        const T haf = h2f * LB.area, hab = h2b * LB.area;
        s_haT[2 * slot] = haf * ts_f;
        s_ha[2 * slot] = haf;
        s_haT[2 * slot + 1] = hab * ts_b;
        s_ha[2 * slot + 1] = hab;
      }
      __syncthreads();
      const T* zt = s_zt + i * ZB;
      for (int z = by_warp ? tid >> 5 : tid; z < ZB; z += zstep) {
        const int gz = b * ZB + z;
        T az, bz;
        if (by_warp)
          zone_sums_warp(s_zptr, s_zf, z, tid & 31, s_haT, s_ha, s_ga[z], s_gb[z], az, bz);
        else
          zone_sums_shared(s_zptr, s_zf, z, s_haT, s_ha, s_ga[z], s_gb[z], az, bz);
        if (by_warp && (tid & 31)) continue;
        if (a.mix_ptr) mix_sums(a, gz, zt, az, bz);
        s_az[i * ZB + z] = az;
        s_bz[i * ZB + z] = bz;
        T znew;
        if (a.ctl) {
          T load;
          const Setpoints<T> sp(s_sp[z], s_sp[ZB + z], s_sp[2 * ZB + z], s_sp[3 * ZB + z]);
          znew = zone_update_ctl(zt[z], az, bz, s_vol[z], dt, sp, load);
        } else {
          znew = zone_update(zt[z], az, bz, s_vol[z], dt);
        }
        s_zt[(i + 1) * ZB + z] = znew;
      }
      __syncthreads();
    }
  };

  // ---- pass 1: march the day, storing each hour's start state -------------
  for (int h = 0; h < a.hours; ++h) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (row0 + j < N) g.T_ws[((size_t)h * N + row0 + j) * SP + lane] = Tn[j];
    for (int z = tid; z < ZB; z += nthreads) g.zT_ws[(size_t)h * NB * ZB + b * ZB + z] = s_zt[z];
    if (h + 1 == a.hours) break;  // the last hour's end is not needed
    march_hour(h, false);
    for (int z = tid; z < ZB; z += nthreads) s_zt[z] = s_zt[sub * ZB + z];
    __syncthreads();
  }

  // ---- pass 2: the hours backwards ----------------------------------------
  T lT[M];  // the cotangent of the column
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int ic = min(row0 + j, N - 1);
    const T d = g.dT[ic * SP + lane];
    lT[j] = row0 + j < N ? d : T(0);
  }
  for (int z = tid; z < ZB; z += nthreads) {
    s_lz[z] = g.d_zT[b * ZB + z];
    s_dV[z] = T(0);
    s_dsh[z] = s_dsc[z] = T(0);
    if constexpr (kMrt) s_lzf[z] = T(0);
  }
  SurfGrad<T> sg;  // this thread's share of the lane's surface-parameter cotangents (day)
#pragma unroll
  for (int f = 0; f < SF_NX; ++f) sg.v[f] = T(0);
  T d_me = T(0);  // kMrt: this thread's face's effective emissivity cotangent (day)

  // The per-instance reverse pieces.  gU: the sub-step's cotangent of each
  // segment's U (the segment below the row); l_*: this thread's share of the
  // sub-step's operators' cotangents.
  T gU[M];
  T l_hf = T(0), l_hb = T(0), l_radf = T(0), l_radb = T(0), l_rft = T(0), l_rbt = T(0), l_sf = T(0), l_sb = T(0);
  // The band of K used as c^T K v (one instance: c_j v_k on the entries K_jk
  // of row j) onto the segments' U and the films.
  auto band_adj = [&](const T(&c)[M], const T(&v)[M]) {
    const T cn0 = gr.next(c[0], 1, T(0)), vn0 = gr.next(v[0], 1, T(0));
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T cn = j + 1 < M ? c[j + 1] : cn0, vn = j + 1 < M ? v[j + 1] : vn0;
      const T own_d = c[j] * v[j];
      const T seg = ((cr >> j) & 1u) ? -(c[j] - cn) * (v[j] - vn) : -(own_d + cn * vn);
      gU[j] += ((links >> j) & 1u) ? seg : T(0);
      if ((fb >> j) & 1u) l_hf -= own_d;
      if ((lb >> j) & 1u) l_hb -= own_d;
    }
  };
  // The reverse of row_q at the working column w: lq the cotangent of each
  // row's q; the column's cotangent goes to lw.
  auto q_adj = [&](const T(&lq)[M], const T(&w)[M], T(&lw)[M]) {
    const T wu = gr.prev(w[M - 1], 1, T(0)), wd = gr.next(w[0], 1, T(0));
    // A thread's first row's coupling to the row above (the previous thread's
    // last row) and its last row's to the row below.
    const bool d0 = dl & 1u, dM = (dr >> (M - 1)) & 1u;
    const T up_u = gr.next(d0 ? lq[0] * wu : T(0), 1, T(0));      // into gU[M-1]
    const T up_w = gr.next(d0 ? lq[0] * ul[0] : T(0), 1, T(0));   // into lw[M-1]
    const T dn_w = gr.prev(dM ? lq[M - 1] * ur_last : T(0), 1, T(0));  // into lw[0]
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T l = lq[j];
      lqh[j] += l;
      if ((fb >> j) & 1u) {
        l_sf += l;
        l_radf += l * (rad_ft - w[j]);
        l_rft += l * radf;
        lw[j] -= l * radf;
      }
      if ((lb >> j) & 1u) {
        l_sb += l;
        l_radb += l * (rad_bt - w[j]);
        l_rbt += l * radb;
        lw[j] -= l * radb;
      }
      if (j > 0 && ((dl >> j) & 1u)) {
        gU[j - 1] += l * w[j - 1];
        lw[j - 1] += l * ul[j];
      }
      if (j + 1 < M && ((dr >> j) & 1u)) {
        gU[j] += l * w[j + 1];
        lw[j + 1] += l * ul[j + 1];
      }
    }
    if (dM) gU[M - 1] += lq[M - 1] * wd;
    gU[M - 1] += up_u;
    lw[M - 1] += up_w;
    lw[0] += dn_w;
  };
  // A cavity lane's K built at w: its cavity segments' U cotangent through
  // dU/dT into lw (their seg_u cotangent is written as 0).
  auto cavity_adj = [&](const T(&w)[M], T(&lw)[M]) {
    if constexpr (kCav) {
      const T w_next = gr.next(w[0], 1, T(0));
      const size_t ns = static_cast<size_t>(N) * SP;
      T carry = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int s = row0 + j;
        if (((cav >> j) & 1u) && s + 1 < N) {
          T d_f, d_b;
          cavity_u(a.cav + lane + s * SP, ns, w[j], j + 1 < M ? w[j + 1] : w_next, &d_f, &d_b);
          lw[j] += gU[j] * d_f;
          if (j + 1 < M)
            lw[j + 1] += gU[j] * d_b;
          else
            carry = gU[j] * d_b;
          gU[j] = T(0);
        }
      }
      lw[0] += gr.prev(carry, 1, T(0));
    }
  };
  // y = M^-T lx on the no-mass rows: the closed form transposed (a pair's
  // head takes its tail's A, the tail its head's C) or Thomas on M^T.
  auto nomass_solve_t = [&](const T(&lx)[M], T(&y)[M]) {
    const T An = gr.next(A[0], 1, T(0)), Cp = gr.prev(C[M - 1], 1, T(0));
    if (!long_runs) {
      const T Dn = gr.next(D[0], 1, T(1)), Dp = gr.prev(D[M - 1], 1, T(1));
      const T ln = gr.next(lx[0], 1, T(0)), lp = gr.prev(lx[M - 1], 1, T(0));
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T dn = j + 1 < M ? D[j + 1] : Dn, an = j + 1 < M ? A[j + 1] : An, lnj = j + 1 < M ? lx[j + 1] : ln;
        const T dp = j > 0 ? D[j - 1] : Dp, cp = j > 0 ? C[j - 1] : Cp, lpj = j > 0 ? lx[j - 1] : lp;
        const T num = ((ph >> j) & 1u) ? lx[j] * dn - an * lnj
                                       : (((pt >> j) & 1u) ? dp * lx[j] - cp * lpj : lx[j]);
        y[j] = num * P[j];
      }
      return;
    }
    T At[M], Ct[M], zero[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      At[j] = j > 0 ? C[j - 1] : Cp;
      Ct[j] = j + 1 < M ? A[j + 1] : An;
      zero[j] = T(0);
    }
    thomas(At, Ct, lx, zero, y);
  };

  for (int h = a.hours - 1; h >= 0; --h) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int ic = min(row0 + j, N - 1);
      const T t = g.T_ws[((size_t)h * N + ic) * SP + lane];
      Tn[j] = row0 + j < N ? t : T(0);
    }
    for (int z = tid; z < ZB; z += nthreads) {
      s_zt[z] = g.zT_ws[(size_t)h * NB * ZB + b * ZB + z];
      s_lz[z] += g.d_zt_hist[(size_t)h * NB * ZB + b * ZB + z];
      s_da[z] = s_db[z] = T(0);
      // The hour's load is the mean over its sub-steps.
      if (a.ctl) s_lld[z] = g.d_ld_hist[(size_t)h * NB * ZB + b * ZB + z] / T(sub);
    }
    march_hour(h, true);

#pragma unroll
    for (int j = 0; j < M; ++j) lqh[j] = T(0);
    T l_rad_out = T(0);  // the owner's: the hour's cotangent of its face's outdoor radiant temperature
    for (int i = sub - 1; i >= 0; --i) {
      // (a) zone update, one thread per zone.
      for (int z = tid; z < ZB; z += nthreads) {
        T laz, lbz, lzt, lvol;
        if (a.ctl) {
          T l_heat, l_cool;
          const Setpoints<T> sp(s_sp[z], s_sp[ZB + z], s_sp[2 * ZB + z], s_sp[3 * ZB + z]);
          zone_update_ctl_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z], s_vol[z], dt, sp, s_lz[z],
                              s_lld[z], laz, lbz, lzt, lvol, l_heat, l_cool);
          s_dsh[z] += l_heat;
          s_dsc[z] += l_cool;
        } else {
          zone_update_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z], s_vol[z], dt, s_lz[z], laz, lbz,
                          lzt, lvol);
        }
        s_laz[z] = laz;
        s_lbz[z] = lbz;
        s_lz[z] = lzt;
        s_dV[z] += lvol;
        s_da[z] += laz;
        s_db[z] += lbz;
      }
      __syncthreads();

      // (b) the lane's sub-step: its forward recomputed from the taped start,
      // then backwards.
      const T* zt = s_zt + i * ZB;
      T tf, tb, base, lt_f = T(0), lt_b = T(0), lbase = T(0);
      T lT_m[M];  // the cotangent of the post-no-mass column
      {
        T Tm[M], k[4][M], Tnew[M];
        tape_get(i, Tm);
        operators(i, zt, Tm, tf, tb, base);
        nomass(Tm);
        massive(Tm, k, Tnew);
#pragma unroll
        for (int j = 0; j < M; ++j) gU[j] = T(0);
        l_hf = l_hb = l_radf = l_radb = l_rft = l_rbt = l_sf = l_sb = T(0);

        // Zone sums a_z += h A T_s, b_z += h A, and the second film, on the
        // new column.
        {
          T ts_f, ts_b;
          faces(Tnew, ts_f, ts_b);
          const int zf = LB.zone_f, zb = LB.zone_b;
          const T laf0 = s_laz[zf >= 0 ? zf : 0], lbf0 = s_lbz[zf >= 0 ? zf : 0];
          const T lab0 = s_laz[zb >= 0 ? zb : 0], lbb0 = s_lbz[zb >= 0 ? zb : 0];
          const T la_f = zf >= 0 ? laf0 : T(0), lb_f = zf >= 0 ? lbf0 : T(0);
          const T la_b = zb >= 0 ? lab0 : T(0), lb_b = zb >= 0 ? lbb0 : T(0);
          const T air = back ? tb : tf, surf = parity_face_surf(L, back, ts_f, ts_b, a.amb_bug);
          const T h2 = parity_face_h(L, back, air, surf, base);
          const T h2f = gr.from(h2, 0), h2b = gr.from(h2, 1);
          if (gr.rank == 0) lT[0] += la_f * (h2f * LB.area);
          const T hab = h2b * LB.area;
#pragma unroll
          for (int j = 0; j < M; ++j)
            if ((lb >> j) & 1u) lT[j] += la_b * hab;
          T l_fs = T(0), l_bs = T(0);
          if (owner) {
            const T lha = back ? la_b * ts_b + lb_b : la_f * ts_f + lb_f;
            sg.v[SF_AREA] += lha * h2;
            T l_air = T(0), l_surf = T(0);
            parity_face_h_adj(L, back, air, surf, lha * LB.area, sg, l_air, l_surf, lbase);
            if (back)
              lt_b += l_air;
            else
              lt_f += l_air;
            if (back && !(L.b_amb && a.amb_bug))
              l_bs = l_surf;
            else
              l_fs = l_surf;
          }
          const T lfs = gr.from(l_fs, 0) + gr.from(l_fs, 1), lbs = gr.from(l_bs, 1);
          if (gr.rank == 0) lT[0] += lfs;
#pragma unroll
          for (int j = 0; j < M; ++j)
            if ((lb >> j) & 1u) lT[j] += lbs;
        }

        // RK4, stages 3 to 0: Tnew = Tm + k0/6 + k1/3 + k2/3 + k3/6 on the
        // massive rows, Tm elsewhere; k_s = K' y_s + qs, y_s = Tm + c_s k_{s-1}.
        T lqs[M], gkc[M], ly[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          lT_m[j] = lT[j];
          lqs[j] = gkc[j] = ly[j] = T(0);
        }
        const T wts[4] = {T(1.0 / 6.0), T(1.0 / 3.0), T(1.0 / 3.0), T(1.0 / 6.0)};
        const T cin[4] = {T(0), T(0.5), T(0.5), T(1)};
#pragma unroll
        for (int s = 3; s >= 0; --s) {
          T gs[M], y[M], gp[M];
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool ms = (mb >> j) & 1u;
            const T lk = wts[s] * lT[j] + (s < 3 ? cin[s + 1] * ly[j] : T(0));
            gs[j] = ms ? lk : T(0);
            y[j] = s == 0 ? Tm[j] : Tm[j] + cin[s] * k[s > 0 ? s - 1 : 0][j];
            gp[j] = gs[j] * P[j];  // the cotangent of the unscaled row
            lqs[j] += gs[j];
            gkc[j] += gs[j] * k[s][j];
          }
          const T gn = gr.next(gs[0], 1, T(0)), gq = gr.prev(gs[M - 1], 1, T(0));
          const T An = gr.next(A[0], 1, T(0)), Cp = gr.prev(C[M - 1], 1, T(0));
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const T an = j + 1 < M ? A[j + 1] : An, gnj = j + 1 < M ? gs[j + 1] : gn;
            const T cp = j > 0 ? C[j - 1] : Cp, gpj = j > 0 ? gs[j - 1] : gq;
            ly[j] = (D[j] * gs[j] + an * gnj) + cp * gpj;  // (K'^T g)_j
            lT_m[j] += ly[j];
          }
          band_adj(gp, y);
        }
        // The forcing at Tm: qs = q(Tm) dt/C on the massive rows; dt/C's
        // cotangent onto the capacity, -sum_s g_s k_s / C.
        {
          T lq[M];
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool ms = (mb >> j) & 1u;
            lq[j] = ms ? lqs[j] * P[j] : T(0);
            dCap[j] += ms ? -gkc[j] * (P[j] / dt) : T(0);
          }
          q_adj(lq, Tm, lT_m);
        }
        cavity_adj(Tm, lT_m);  // RK4's K and q at Tm
      }

      // The no-mass iterations backwards, each from its input recomputed from
      // the sub-step's start column (a cavity lane's rows at that input).
      for (int it = pc.iters - 1; it >= 0; --it) {
        T w[M], x[M];
        unsigned moved = W.sel;
        tape_get(i, w);
        if constexpr (kCav) {  // the rows at the sub-step's start
          cavity(w);
          if (!long_runs) factor(cav_lane ? heads1 : dyn);
        }
        if (pc.iters == 1)
          nomass_solve(w, x);
        else
          nomass_run(w, it, x, moved);
        const unsigned upd = (moved >> row0) & own;
        T lx[M], y[M], c[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool u = (upd >> j) & 1u;
          lx[j] = u ? T(0.5) * lT_m[j] : T(0);
          lT_m[j] = u ? T(0.5) * lT_m[j] : lT_m[j];
        }
        nomass_solve_t(lx, y);
#pragma unroll
        for (int j = 0; j < M; ++j) c[j] = ((sb >> j) & 1u) ? -y[j] : T(0);
        band_adj(c, x);  // the system's band: -y x^T
        q_adj(c, w, lT_m);  // r = -q(w) on the no-mass rows
        cavity_adj(w, lT_m);
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        lT[j] = lT_m[j];
        dU[j] += gU[j];
      }

      // The first film evaluation, backwards, from the start column (the
      // films, me, tm and the network's history are still the recompute's).
      {
        T Ts[M];
        tape_get(i, Ts);
        T ts_f, ts_b;
        faces(Ts, ts_f, ts_b);
        l_hf += l_sf * tf;
        l_hb += l_sb * tb;
        lt_f += l_sf * hf;
        lt_b += l_sb * hb;
        l_hf = gr.sum(l_hf);
        l_hb = gr.sum(l_hb);
        l_radf = gr.sum(l_radf);
        l_radb = gr.sum(l_radb);
        l_rft = gr.sum(l_rft);
        l_rbt = gr.sum(l_rbt);
        FaceCot<T> fc{T(0), T(0), T(0), T(0), T(0), T(0)};
        if (owner) {
          fc = parity_face_ops_adj<T, kMrt>(L, back, ts_f, ts_b, tf, tb, rad_out, a.amb_bug, me, tm,
                                            back ? l_hb : l_hf, back ? l_radb : l_radf, back ? l_rbt : l_rft, sg,
                                            d_me, lbase);
          parity_base_adj(L, s_wx[sub + i], s_wx[2 * sub + i], s_wx[3 * sub + i], lbase, sg);
        }
        if constexpr (kMrt) {  // the network, backwards, from the start column
          const MrtLane<T> ML(a, g.net, lane);
          T l_ts = T(0);
          const T l_t0 = mrt_face_node_adj(ZB, s_mptr, s_mf, tid, nthreads, owner, ((ML.bits >> int(back)) & 1u) != 0,
                                           2 * slot + int(back), back ? LB.zone_b : LB.zone_f, me, L.area,
                                           back ? ts_b : ts_f, hist, fc.l_tm, l_ts, d_me, sg.v[SF_AREA], s_ha,
                                           s_haT, s_lt, s_lnum, s_lden, s_lm, s_lzf);
          if (back) {
            fc.l_bs += l_ts;
            fc.l_tb += l_t0;
          } else {
            fc.l_fs += l_ts;
            fc.l_tf += l_t0;
          }
        }
        const T l_fs = gr.from(fc.l_fs, 0) + gr.from(fc.l_fs, 1), l_bs = gr.from(fc.l_bs, 1);
        if (gr.rank == 0) lT[0] += l_fs;
#pragma unroll
        for (int j = 0; j < M; ++j)
          if ((lb >> j) & 1u) lT[j] += l_bs;
        lt_f += fc.l_tf;
        lt_b += fc.l_tb;
        l_rad_out += fc.l_rad_out;
      }

      // Boundary temperatures: zone air (summed per zone below), the fixed
      // ambient/ground temperature, or outdoor air (not differentiated).
      lt_f = gr.sum(lt_f);
      lt_b = gr.sum(lt_b);
      if (gr.rank == 0) {
        s_lt[2 * slot] = LB.f_space ? lt_f : T(0);
        s_lt[2 * slot + 1] = LB.b_space ? lt_b : T(0);
        if (!LB.f_space && !LB.f_out) sg.v[SF_TEMPF] += lt_f;
        if (!LB.b_space && !LB.b_out) sg.v[SF_TEMPB] += lt_b;
      }
      __syncthreads();

      // (c) the faces' boundary cotangents into their zones, in the
      // forward's fixed order of each zone's face list.
      for (int z = tid; z < ZB; z += nthreads) {
        const int gz = b * ZB + z;
        T sf = T(0), sbk = T(0);
        for (int e2 = s_zptr[z]; e2 < s_zptr[z + 1]; ++e2) {
          const int f = s_zf[e2];
          if (f & 1)
            sbk += s_lt[f];
          else
            sf += s_lt[f];
        }
        s_lz[z] += sf + sbk;
        if constexpr (kMrt) {  // the network's fallback onto the zone row
          s_lz[z] += s_lzf[z];
          s_lzf[z] = T(0);
        }
        if (a.mixt_ptr) {
          // The transpose of the mixing sums: this zone as a source.
          const T zs = s_zt[i * ZB + z];
          const T s0 = air_rho_cp(zs), ds0 = air_rho_cp_dt(zs);
          T lm = T(0);
          for (int e2 = a.mixt_ptr[gz]; e2 < a.mixt_ptr[gz + 1]; ++e2) {
            const int to = a.mixt_dst[e2];
            lm += a.mixt_vol[e2] * (s_laz[to] * (s0 + zs * ds0) + s_lbz[to] * ds0);
          }
          s_lz[z] += lm;
        }
      }
      // The next sub-step's zone phase runs on the same threads per zone;
      // only the mixing transpose reads other zones' rows.
      if (a.mixt_ptr) __syncthreads();
    }

    // ---- end of hour: the channel and gain cotangents ----------------------
    {
      const T sfr = a.sol_f[h * SP + lane], sbr = a.sol_b[h * SP + lane];
      const T sol_f = (is_nan(sfr) || sfr < T(0)) ? T(0) : sfr;
      const T sol_b = is_nan(sbr) ? T(0) : sbr;
      T psf = T(0), psb = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int ic = min(row0 + j, N - 1);
        const T fa = FA[ic * SP], fbv = FB[ic * SP];
        psf += lqh[j] * fa;
        psb += lqh[j] * fbv;
        dFA[j] += lqh[j] * sol_f;
        dFB[j] += lqh[j] * sol_b;
      }
      psf = gr.sum(psf);
      psb = gr.sum(psb);
      const T lro_f = gr.from(l_rad_out, 0), lro_b = gr.from(l_rad_out, 1);
      if (gr.rank == 0) {
        const T irf = a.ir_f[h * SP + lane], irb = a.ir_b[h * SP + lane];
        T* dch = g.d_chan + (size_t)h * SP + lane;
        const size_t row = (size_t)a.hours * SP;
        dch[0] = (is_nan(sfr) || sfr < T(0)) ? T(0) : psf;
        dch[row] = is_nan(sbr) ? T(0) : psb;
        dch[2 * row] = irf >= T(1e-30) ? lro_f * T(0.25) * m_pow(irf / T(kSigma), T(-0.75)) / T(kSigma) : T(0);
        dch[3 * row] = irb >= T(1e-30) ? lro_b * T(0.25) * m_pow(irb / T(kSigma), T(-0.75)) / T(kSigma) : T(0);
      }
    }
    for (int z = tid; z < ZB; z += nthreads) {
      g.d_a[(size_t)h * NB * ZB + b * ZB + z] = s_da[z];
      g.d_b[(size_t)h * NB * ZB + b * ZB + z] = s_db[z];
      if (a.sp_heat) {  // scheduled: the hour's rows take the cotangents
        g.d_sp_heat[(size_t)h * NB * ZB + b * ZB + z] = s_dsh[z];
        g.d_sp_cool[(size_t)h * NB * ZB + b * ZB + z] = s_dsc[z];
        s_dsh[z] = s_dsc[z] = T(0);
      }
    }
  }

  // ---- outputs ------------------------------------------------------------
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int n = row0 + j;
    if (n >= N) continue;
    g.dT0[n * SP + lane] = lT[j];
    g.d_node[(ND_U * N + n) * SP + lane] = ((cav >> j) & 1u) ? T(0) : dU[j];
    g.d_node[(ND_CAP * N + n) * SP + lane] = ((mb >> j) & 1u) ? dCap[j] : T(0);
    g.d_node[(ND_FA * N + n) * SP + lane] = dFA[j];
    g.d_node[(ND_FB * N + n) * SP + lane] = dFB[j];
  }
#pragma unroll
  for (int f = 0; f < SF_COUNT; ++f) {
    const T v = f < SF_NX ? gr.sum(sg.v[f < SF_NX ? f : 0]) : T(0);
    if (gr.rank == 0) g.d_surf[f * SP + lane] = v;
  }
  if constexpr (kMrt) {
    const T ef = gr.from(d_me, 0), eb = gr.from(d_me, 1);
    if (gr.rank == 0) {
      g.d_mrt[lane] = ef;
      g.d_mrt[SP + lane] = eb;
    }
  }
  for (int z = tid; z < ZB; z += nthreads) {
    g.d_zT0[b * ZB + z] = s_lz[z];
    g.d_zv[b * ZB + z] = s_dV[z];
    if (a.ctl) {  // the compiled rows (0 where the march was scheduled)
      g.d_ctl[b * ZB + z] = s_dsh[z];
      g.d_ctl[NB * ZB + b * ZB + z] = s_dsc[z];
    }
  }
}

template <typename T, int kThreads, int kMinBlocks, bool kCav, bool kMrt>
int launch_parity_adj(const AdjArgsOf<T, kMrt>& g, cudaStream_t stream, int* block_threads) {
  const DayArgs<T>& a = g.in;
  const size_t smem = parity_adj_smem<T, kMrt, kParityAdjStaged<kThreads>>(a);
  const auto kernel = day_adjoint_parity_kernel<T, kThreads, kMinBlocks, kCav, kMrt>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.NB, a.SB * kGroup, smem, stream>>>(g);
  if (block_threads) *block_threads = kThreads;
  return static_cast<int>(cudaGetLastError());
}

// The kind's kernel in the launch variant that takes the block's lanes
// (adj_launch_variant); a block whose staged rows would not fit a block's
// shared memory runs the unstaged variant.  f64 runs one block an SM in the
// 128- and 256-thread variants alike (255 registers both), so its 128-thread
// blocks run the 256-thread instantiation.  Writes the threads of a block of
// the variant that ran to *block_threads.
template <typename T, bool kCav, bool kMrt>
int launch_kind(const AdjArgsOf<T, kMrt>& g, cudaStream_t st, int* bt) {
  int v = adj_launch_variant(g.in.SB);
  if (v < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (parity_adj_smem<T, kMrt, true>(g.in) > static_cast<size_t>(optin)) v = kAdjVariants - 1;
  switch (v) {
    case 0:
      if constexpr (sizeof(T) == 4)
        return launch_parity_adj<T, kAdjLaunchVariants[0].threads, kAdjVariantBlocks<T, 0>, kCav, kMrt>(g, st, bt);
      [[fallthrough]];
    case 1:
      return launch_parity_adj<T, kAdjLaunchVariants[1].threads, kAdjVariantBlocks<T, 1>, kCav, kMrt>(g, st, bt);
    case 2:
      return launch_parity_adj<T, kAdjLaunchVariants[2].threads, kAdjVariantBlocks<T, 2>, kCav, kMrt>(g, st, bt);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifndef HEATX_DAY_ADJOINT_PARITY_KMRT_UNIT
// One kind for free-float buildings and those with thermostats, schedules or
// mixing (their rows checked at run time); gas cavities the kind with the
// cavity code (kCav); MRT physics the kMrt unit's kinds.
template <typename T>
int day_adjoint_parity(const void* args, void* stream, int* bt) {
  const MrtAdjArgs<T>& g = *static_cast<const MrtAdjArgs<T>*>(args);
  if (g.net.phys)
    return std::is_same_v<T, float> ? heatx_day_adjoint_parity_mrt_f32(args, stream, bt)
                                    : heatx_day_adjoint_parity_mrt_f64(args, stream, bt);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdjArgs<T>& base = g;
  return g.in.cav ? launch_kind<T, true, false>(base, st, bt) : launch_kind<T, false, false>(base, st, bt);
}
#else
template <typename T>
int day_adjoint_parity_mrt(const void* args, void* stream, int* bt) {
  const MrtAdjArgs<T>& g = *static_cast<const MrtAdjArgs<T>*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return g.in.cav ? launch_kind<T, true, true>(g, st, bt) : launch_kind<T, false, true>(g, st, bt);
}
#endif

}  // namespace

extern "C" {
#ifndef HEATX_DAY_ADJOINT_PARITY_KMRT_UNIT
int heatx_day_adjoint_parity_f32(const void* g, void* stream, int* bt) {
  return day_adjoint_parity<float>(g, stream, bt);
}
int heatx_day_adjoint_parity_f64(const void* g, void* stream, int* bt) {
  return day_adjoint_parity<double>(g, stream, bt);
}
#else
int heatx_day_adjoint_parity_mrt_f32(const void* g, void* stream, int* bt) {
  return day_adjoint_parity_mrt<float>(g, stream, bt);
}
int heatx_day_adjoint_parity_mrt_f64(const void* g, void* stream, int* bt) {
  return day_adjoint_parity_mrt<double>(g, stream, bt);
}
#endif
}  // extern "C"
