// The TR-BDF2 day adjoint for NVIDIA Hopper (sm_90a): four threads per
// surface.  day_adjoint.cu's C entry hands every trbdf2 / trbdf2_refresh
// launch to heatx_day_adjoint_tr_f32/_f64 here (ctypes; heatx_torch/ops/
// day_adjoint.py); the kMrt kinds are day_adjoint_tr_mrt.cu's.
//
// Replaces heatx/ops/pallas_adjoint.py::make_day_adjoint -> `kernel` (the
// pl.pallas_call at pallas_adjoint.py:717) in modes trbdf2 / trbdf2_refresh:
// the reverse of `_hour_body_imp` (pallas_step.py:777) under jax.vjp
// (pallas_adjoint.py:593-673), free-float, with thermostats, schedules and
// mixing (kExt), with gas cavities (kCav), with interior MRT (kMrt).  It
// returns what autograd through the plain day march gives (day_adjoint.cu
// has the list and the primitives' adjoints).
//
// What bounded the first design (one thread per surface, in day_adjoint.cu
// until this kernel replaced it): a serial latency chain, three times the
// forward's.  It marched the day to store each hour's start, re-marched each
// hour with a per-thread tape of 768 values in local memory, and swept the
// tape backwards, on one thread per surface with Thomas sweeps down a column
// in local memory and a 32-thread block per zone-closed block (2.5 warps an
// SM).  Its bench-city day-launch took 21.96 ms against a bound of 0.026 ms.
//
// This design:
//  * G = 4 threads per surface lane, thread `rank` owning the M = 8 node rows
//    [rank*M, rank*M + M) in unrolled register arrays, in the launch variants
//    of kAdjLaunchVariants (day_march_args.cuh); G = 8 for columns of 33-64
//    rows and for components past 256 lanes, which run as a thread-block
//    cluster of CTAs of 128 lanes (day_cluster.cuh: cluster barriers, the
//    zone phases' face sums read from each face's CTA, every CTA keeping the
//    component's zone rows, the lead CTA writing the per-zone outputs).
//  * The recompute is the forward kernel's (day_march_tr.cu): its operator
//    build (face_ops with the faces split over the group, the cavity U in
//    registers, mrt_face_node), its partitioned factorization and solve
//    (day_tr.cuh PartFactors), its warp zone sums and zone updates, in its
//    order, so the f32 recompute rounds as the forward kernel did.  Pass 1
//    marches the day to store each hour's start (the last hour is not
//    marched); pass 2 re-marches each hour from its start, writing the hour's
//    tape, and sweeps the hour backwards.
//  * The tape lives in a workspace the wrapper allocates (one hour: each
//    thread's rows of T at every sub-step start and of each sub-step's T1,
//    [2 substeps + 1, 32, SP] values, 23 MB in f32 on the bench city, in the
//    card's L2), laid out so that a warp's 32 threads read 32 consecutive
//    values; the zone rows and sums of each sub-step stay in shared memory
//    (in the 1024-thread variant in the workspace after the tape, so that no
//    block is refused for its sub-steps).
//  * The reverse rebuilds each refresh group's operators and factors from
//    the taped group start, then reverses its sub-steps: the stage solves
//    transposed on the same factors (solve_transposed, day_tr_adj.cuh: the
//    steps of the partitioned solve in reverse order, PCR's shuffles in the
//    opposite direction); the band cotangent of both stages folded at once
//    into one cotangent per segment's U, -a dt (l_s - l_s+1)(x_s - x_s+1),
//    kept in registers over the group; the capacity's, the forcing's and the
//    boundary rows' cotangents by rows on the owning thread, the
//    neighbouring rows by shuffle.  At the group start the operators'
//    cotangents are summed over the group once and the operator build runs
//    backwards with the faces split as the forward splits them (the front
//    face's on rank 0, the back face's on rank 1), the MRT network the same
//    way (mrt_face_node_adj), a cavity segment's U through dU/dT on the
//    thread that owns its first row.
//  * Day accumulators (the node rows' cotangents) sit in per-thread shared
//    slots in the 128- and 256-thread variants, in registers in the 1024
//    one; the surface parameters' cotangents accumulate on the thread that
//    computed each term and are summed over the group once a day.  Per-zone
//    cotangents stay on one thread per zone, the boundary cotangents' face
//    sums in the forward's fixed order: no float atomics, deterministic.

#include <type_traits>

#include "day_adjoint_args.cuh"
#include "day_march_args.cuh"
#include "day_tr_adj.cuh"

// The kMrt kinds live in their own compilation unit (day_adjoint_tr_mrt.cu,
// which includes this file), as the day march's do.
extern "C" int heatx_day_adjoint_tr_mrt_f32(const void* g, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_tr_mrt_f64(const void* g, void* stream, int* block_threads);
// The cluster variant (kAdjLaunchVariants[3]) lives in a unit of its own
// (day_adjoint_tr_b1.cu), as the kMrt kinds do: ptxas compiles the out-of-line
// device functions that a unit's kernels share once for all of them, so
// the other variants keep the code they had without it.
extern "C" int heatx_day_adjoint_tr_b1_f32(const void* g, int ext, int cav, int mrt, void* stream, int* block_threads);
extern "C" int heatx_day_adjoint_tr_b1_f64(const void* g, int ext, int cav, int mrt, void* stream, int* block_threads);

namespace {

using namespace heatx;

// Whether a variant keeps each thread's rows' capacities, solar forcing, U to
// the row above and its day accumulators in shared memory, and the hour's
// zone rows of every sub-step and its weather (the 1024-thread variant keeps
// the thread's rows in registers and the hour's zone rows and weather in the
// workspace after the tape, so that its shared memory does not grow with the
// sub-steps and every block fits it).
template <int kThreads>
constexpr bool kAdjStaged = kThreads < 1024;

// Values of the hour's zone rows and weather of one block: zone T at each
// sub-step start and the hour's end, a_z and b_z of each sub-step, t_out,
// wind and wdir of each sub-step.
__host__ __device__ inline size_t hour_zone_rows(int substeps, int ZB) {
  return static_cast<size_t>(3 * substeps + 1) * ZB + 3 * static_cast<size_t>(substeps);
}

// Bytes of a CTA's dynamic shared memory: with kStaged the hour's zone
// rows and weather (hour_zone_rows) and seven rows per thread; the zone rows
// of the hour (volumes, gains, cotangents; with kExt the setpoints and their
// cotangents; with kMrt the network's rows), the per-face rows, the lanes'
// boundaries, then the zone lists and, with kMrt, the network lists (ints).
// `lanes` is the CTA's (the block's, but for a cluster's CTA).
template <typename T, bool kExt, bool kMrt, bool kStaged, int kNodes>
size_t tr_adj_smem(const DayArgs<T>& a, int lanes) {
  const size_t ZB = a.ZB, SB = a.SB, SBc = lanes;
  const size_t zrows = 9 + (kExt ? 7 : 0) + (kMrt ? 5 : 0);
  const size_t staged = kStaged ? hour_zone_rows(a.substeps, a.ZB) + 7 * static_cast<size_t>(kNodes) * SBc : 0;
  const size_t lists = (kMrt ? 2 : 1) * (ZB + 1 + 2 * SB);
  return sizeof(T) * (zrows * ZB + 6 * SBc + staged) + (sizeof(LaneBounds<T>) * SBc + 16) + sizeof(int) * lists;
}

template <typename T, int kThreads, int kMinBlocks, bool kExt, bool kCav, bool kMrt, int G, int kNodes, bool kCl>
__global__ void __launch_bounds__(kThreads, kMinBlocks) day_adjoint_tr_kernel(const AdjArgsOf<T, kMrt> g) {
  constexpr int M = kNodes / G;
  using W = ColBits<kNodes>;
  constexpr bool kShared = kAdjStaged<kThreads>;
  const DayArgs<T>& a = g.in;
  const Ctas<kCl, kThreads / G> cc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, SB = a.SB, ZB = a.ZB, NB = a.NB, sub = a.substeps, k = a.refresh_every;
  // The CTA's lanes (the block's, or one CTA's share of a cluster's), the
  // CTA's index and the launch's CTAs (the blocks', or every cluster's).
  const int SBc = kCl ? static_cast<int>(blockDim.x) / G : SB;
  const int cta = kCl ? static_cast<int>(blockIdx.x) : cc.block();
  const int n_cta = kCl ? static_cast<int>(gridDim.x) : NB;
  // The hour's zone rows of every sub-step and its weather: in shared memory
  // (kShared) or in this CTA's part of the workspace after the tape.
  T* const hz = kShared ? reinterpret_cast<T*>(smem_raw)
                        : g.tape + static_cast<size_t>(2 * sub + 1) * kNodes * NB * SB +
                              static_cast<size_t>(cta) * hour_zone_rows(sub, ZB);
  T* s_zt = hz;                              // [(sub+1)*ZB] zone T at each sub-step start, and the hour's end
  T* s_az = s_zt + (sub + 1) * ZB;           // [sub*ZB] a_z of each sub-step
  T* s_bz = s_az + sub * ZB;                 // [sub*ZB] b_z of each sub-step
  T* s_vol = kShared ? s_bz + sub * ZB : reinterpret_cast<T*>(smem_raw);  // [ZB] zone volumes
  T* s_ga = s_vol + ZB;                      // [ZB] the hour's a_extra
  T* s_gb = s_ga + ZB;                       // [ZB] the hour's b_extra
  T* s_lz = s_gb + ZB;                       // [ZB] zone-T cotangent
  T* s_laz = s_lz + ZB;                      // [ZB] a_z cotangent
  T* s_lbz = s_laz + ZB;                     // [ZB] b_z cotangent
  T* s_dV = s_lbz + ZB;                      // [ZB] zone-volume cotangent (day)
  T* s_da = s_dV + ZB;                       // [ZB] a_extra cotangent (hour)
  T* s_db = s_da + ZB;                       // [ZB] b_extra cotangent (hour)
  T* s_lld = s_db + ZB;                      // kExt: [ZB] cotangent of each sub-step's load (hour)
  T* s_dsh = s_lld + (kExt ? ZB : 0);        // kExt: [ZB] heating-setpoint cotangent (hour or day)
  T* s_dsc = s_dsh + (kExt ? ZB : 0);        // kExt: [ZB] cooling-setpoint cotangent
  T* s_sp = s_dsc + (kExt ? ZB : 0);         // kExt: [4][ZB] the hour's Setpoints
  T* s_tm = s_sp + (kExt ? 4 * ZB : 0);      // kMrt: [ZB] the zones' MRT nodes
  T* s_lnum = s_tm + (kMrt ? ZB : 0);        // kMrt: [ZB] cotangents of a zone's network sums
  T* s_lden = s_lnum + (kMrt ? ZB : 0);
  T* s_lm = s_lden + (kMrt ? ZB : 0);        // kMrt: [ZB] cotangent of a zone's MRT node
  T* s_lzf = s_lm + (kMrt ? ZB : 0);         // kMrt: [ZB] the network's fallback cotangent
  T* s_haT = s_lzf + (kMrt ? ZB : 0);        // [2*SBc] h*A*T_s per face (kMrt: also w*T_s)
  T* s_ha = s_haT + 2 * SBc;                 // [2*SBc] h*A per face (kMrt: also w)
  T* s_lt = s_ha + 2 * SBc;                  // [2*SBc] boundary-T cotangent per face
  T* s_wx = kShared ? s_lt + 2 * SBc : s_bz + sub * ZB;  // [3*sub] the hour's t_out, wind, wdir
  // [M][blockDim] each: the thread's rows' capacities, the hour's solar
  // forcing, U to the row above, and the day's cotangents of U (to the row
  // below), the capacity and the two absorption fractions (row j of thread t
  // at j*blockDim + t, read by that thread only)
  T* s_rows = kShared ? s_wx + 3 * sub : s_lt + 2 * SBc;
  LaneBounds<T>* s_lb = reinterpret_cast<LaneBounds<T>*>(
      (reinterpret_cast<size_t>(s_rows + (kShared ? 7 * kNodes * SBc : 0)) + 15) & ~static_cast<size_t>(15));
  int* s_zptr = reinterpret_cast<int*>(s_lb + SBc);  // [ZB+1] block-local face offsets
  int* s_zf = s_zptr + ZB + 1;                      // [<= 2*SB] the zones' faces
  int* s_mptr = s_zf + 2 * SB;                      // kMrt: [ZB+1] the network lists' offsets
  int* s_mf = s_mptr + ZB + 1;                      // kMrt: [<= 2*SB] the zones' network faces

  const int b = cc.block();
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int SP = NB * SB;
  const int slot = tid / G;  // the lane's place in the CTA
  const int lane = b * SB + cc.lane0 + slot;
  const Group<G> gr{block_warp_mask(), tid % G};
  const int row0 = gr.rank * M;
  const bool back = gr.rank != 0;   // this thread's face in the operator build
  const bool owner = gr.rank < 2;   // the face's reverse: front on rank 0, back on rank 1
  const Scheme<T> sc(a);
  if (gr.rank == 0) s_lb[slot] = LaneBounds<T>(Lane<T>(a, lane, kCav));

  // The thread's rows: bit j of each word is row row0 + j.
  const W col = N < 8 * static_cast<int>(sizeof(W)) ? (W(1) << N) - W(1) : ~W(0);
  const W bits = lane_word<W>(a.lane, SP, LN_BITS, lane, a.N) & col;
  constexpr unsigned own = (1u << M) - 1u;
  const unsigned vb = static_cast<unsigned>(bits >> row0) & own;
  const unsigned fb = static_cast<unsigned>((bits & ~(bits << 1)) >> row0) & own;
  const W lasts = bits & ~(bits >> 1);
  const unsigned lbits = static_cast<unsigned>(lasts >> row0) & own;
  const W lf = bits & (bits << 1);      // left(i): rows i-1 and i valid
  const unsigned links = static_cast<unsigned>(lf >> (row0 + 1)) & own;  // bit j: rows j and j+1 joined by a segment
  const unsigned cav = kCav ? static_cast<unsigned>(lane_word<W>(a.lane, SP, LN_CAV, lane, a.N) >> row0) & own : 0u;
  const bool one_last = __all_sync(gr.mask, popc(lasts) <= 1);
  const int last_owner = lasts ? hibit(lasts) / M : 0;
  const T* U = a.node + (ND_U * N) * SP + lane;
  const T* FA = a.node + (ND_FA * N) * SP + lane;
  const T* FB = a.node + (ND_FB * N) * SP + lane;
  T* const rows = s_rows + tid;
  Rows<T, M, kShared> cap{rows, nthreads}, sq{rows + kNodes * SBc, nthreads};
  Rows<T, M, kShared> kl{rows + 2 * kNodes * SBc, nthreads};  // K's lower coefficient, 0 off the column
  Rows<T, M, kShared> dU{rows + 3 * kNodes * SBc, nthreads}, dCap{rows + 4 * kNodes * SBc, nthreads};
  Rows<T, M, kShared> dFA{rows + 5 * kNodes * SBc, nthreads}, dFB{rows + 6 * kNodes * SBc, nthreads};
  T Tn[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int i = row0 + j, ic = min(i, N - 1);
    const bool in = i < N;
    const T t0 = a.T0[ic * SP + lane], c = a.node[(ND_CAP * N + ic) * SP + lane], u = U[max(i - 1, 0) * SP];
    Tn[j] = in ? t0 : T(0);
    cap[j] = in ? c : T(0);
    kl[j] = ((lf >> i) & 1u) ? u : T(0);
    dU[j] = dCap[j] = dFA[j] = dFB[j] = T(0);
  }
  const int il = row0 + M - 1;  // the segment below the thread's last row
  T ku_last = (il + 1 < kNodes && ((lf >> (il + 1)) & 1u)) ? U[il * SP] : T(0);
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
  cc.sync();
  const LaneBounds<T>& LB = s_lb[slot];

  // The zone phase's threads in the march: a warp per zone when the block is
  // whole warps (as the forward kernel).
  const bool by_warp = (nthreads & 31) == 0;
  const int zstep = by_warp ? nthreads >> 5 : nthreads;

  // The tape: column c's row j of this thread at tape[(c*M + j) * TP], T at
  // sub-step c's start for c <= sub, T1 of sub-step i at c = sub + 1 + i.
  const size_t TP = static_cast<size_t>(n_cta) * nthreads;
  T* const tape = g.tape + static_cast<size_t>(cta) * nthreads + tid;
  auto put = [&](int c, const T (&x)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) tape[(static_cast<size_t>(c) * M + j) * TP] = x[j];
  };
  auto get = [&](int c, T (&x)[M]) {
#pragma unroll
    for (int j = 0; j < M; ++j) x[j] = tape[(static_cast<size_t>(c) * M + j) * TP];
  };

  // The face temperatures of a column x: (front, back), as the forward.
  auto faces = [&](const T (&x)[M], T& ts_f, T& ts_b) {
    T part = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j)
      if ((lbits >> j) & 1u) part += x[j];
    ts_b = one_last ? gr.from(part, last_owner) : gr.sum(part);
    ts_f = gr.from(x[0], 0);
  };

  // The refresh group's operators and factors from its start column x
  // (sub-step i0 of the current hour): the forward kernel's operator build.
  Ops<T> o{};
  PartFactors<T, G, M> P;
  T e[M], ml[M], mu_last = T(0);
  T rad_out = T(0);        // the hour's outdoor radiant temperature of this thread's face
  T me = T(0), tm = T(0);  // kMrt: this thread's face's effective emissivity and MRT node
  T hist[4];               // kMrt: the node before each of the network's iterations
  auto build = [&](int i0, const T (&x)[M]) {
    const Lane<T> L(a, lane, kCav);
    T t_front, t_back, ts_front, ts_back;
    LB(s_zt + i0 * ZB, s_wx[i0], t_front, t_back);
    faces(x, ts_front, ts_back);
    if constexpr (kMrt) {  // kMrt launches run MRT physics
      const MrtLane<T> ML(a, g.net, lane);
      me = back ? ML.eb : ML.ef;
      tm = mrt_face_node<T, true>(ZB, s_mptr, s_mf, tid, nthreads, owner, ((ML.bits >> int(back)) & 1u) != 0,
                                  2 * slot + int(back), back ? L.zone_b : L.zone_f, me, L.area,
                                  back ? ts_back : ts_front, back ? t_back : t_front, s_zt + i0 * ZB, s_ha,
                                  s_haT, s_tm, hist, cc);
    }
    if constexpr (kCav) {  // the cavity segments' U from the start column
      const T t_next = gr.next(x[0], 1, T(0));
      const size_t ns = static_cast<size_t>(N) * SP;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int s = row0 + j;
        if (((cav >> j) & 1u) && s + 1 < N) {
          // a column past 32 rows may hold its cavities in rows 32-63 only
          const T* cav_ops = kNodes > 32 ? a.cav + lane : L.Cav;
          const T u = cavity_u(cav_ops + s * SP, ns, x[j], j + 1 < M ? x[j + 1] : t_next,
                               static_cast<T*>(nullptr), static_cast<T*>(nullptr));
          const bool link = (lf >> (s + 1)) & 1u;
          if (j + 1 < M)
            kl[j + 1] = link ? u : T(0);
          else
            ku_last = link ? u : T(0);
        }
      }
      kl[0] = gr.prev(ku_last, 1, T(0));
    }
    const FaceOps<T> fo = face_ops<T, kMrt>(L, back, ts_front, ts_back, t_front, t_back, rad_out, s_wx[sub + i0],
                                            s_wx[2 * sub + i0], a.amb_bug, me, tm);
    o.hf = gr.from(fo.h, 0);
    o.radf = gr.from(fo.rad, 0);
    o.rad_ft = gr.from(fo.rad_t, 0);
    o.hb = gr.from(fo.h, 1);
    o.radb = gr.from(fo.rad, 1);
    o.rad_bt = gr.from(fo.rad_t, 1);
    T md[M], mu[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const bool v = (vb >> j) & 1u;
      const T klj = kl[j], ku = j + 1 < M ? kl[j + 1] : ku_last;
      const T kd = -(klj + ku + (((fb >> j) & 1u) ? o.hf + o.radf : T(0)) +
                     (((lbits >> j) & 1u) ? o.hb + o.radb : T(0)));
      const T c = cap[j];
      e[j] = c + sc.a_dt * kd;
      md[j] = v ? c - sc.a_dt * kd : T(1);
      ml[j] = v ? -sc.a_dt * klj : T(0);
      mu[j] = v ? -sc.a_dt * ku : T(0);
    }
    mu_last = mu[M - 1];
    P.factor(gr, ml, md, mu);
  };

  // March hour h from (Tn, the zone row s_zt[0:ZB]) as the forward kernel
  // does; with `taped`, write the hour's tape.  The zone rows of every
  // sub-step (and a_z, b_z) stay in s_zt, s_az, s_bz.
  auto march_hour = [&](int h, bool taped) {
    {  // the hour's forcing: clamped solar per row, the face's outdoor radiant temperature
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
      }
      cc.sync();
    }
    for (int i0 = 0; i0 < sub; i0 += k) {
      build(i0, Tn);
      for (int i = i0; i < i0 + k; ++i) {
        if (taped) put(i, Tn);
        T t_front, t_back;
        LB(s_zt + i * ZB, s_wx[i], t_front, t_back);
        const T src_f = t_front * o.hf + o.radf * o.rad_ft;
        const T src_b = t_back * o.hb + o.radb * o.rad_bt;
        auto forcing = [&](int j) {
          const T q = sq[j];
          return (q + (((fb >> j) & 1u) ? src_f : T(0))) + (((lbits >> j) & 1u) ? src_b : T(0));
        };
        const T x_dn = gr.prev(Tn[M - 1], 1, T(0)), x_up = gr.next(Tn[0], 1, T(0));
        T T1[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool v = (vb >> j) & 1u;
          const T up = j > 0 ? Tn[j - 1] : x_dn, down = j + 1 < M ? Tn[j + 1] : x_up;
          const T mu = j + 1 < M ? ml[j + 1] : mu_last;
          const T r = e[j] * Tn[j] - ml[j] * up - mu * down + sc.g_dt * forcing(j);
          T1[j] = v ? r : Tn[j];
        }
        P.solve(gr, ml, T1);
        if (taped) put(sub + 1 + i, T1);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool v = (vb >> j) & 1u;
          const T c = cap[j];
          const T r = sc.c1 * c * T1[j] - sc.c2 * c * Tn[j] + sc.b_dt * forcing(j);
          Tn[j] = v ? r : Tn[j];
        }
        P.solve(gr, ml, Tn);

        T ts_f, ts_b;
        faces(Tn, ts_f, ts_b);
        if (gr.rank == 0) {
          const T haf = o.hf * LB.area, hab = o.hb * LB.area;
          s_haT[2 * slot] = haf * ts_f;
          s_ha[2 * slot] = haf;
          s_haT[2 * slot + 1] = hab * ts_b;
          s_ha[2 * slot + 1] = hab;
        }
        cc.sync();
        const T* zt = s_zt + i * ZB;
        for (int z = by_warp ? tid >> 5 : tid; z < ZB; z += zstep) {
          const int gz = b * ZB + z;
          T az, bz;
          if (by_warp)
            zone_sums_warp(s_zptr, s_zf, z, tid & 31, s_haT, s_ha, s_ga[z], s_gb[z], az, bz, cc);
          else
            zone_sums_shared(s_zptr, s_zf, z, s_haT, s_ha, s_ga[z], s_gb[z], az, bz, cc);
          if (by_warp && (tid & 31)) continue;
          if (kExt && a.mix_ptr) mix_sums(a, gz, zt, az, bz);
          s_az[i * ZB + z] = az;
          s_bz[i * ZB + z] = bz;
          T znew;
          if (kExt && a.ctl) {
            T load;
            const Setpoints<T> sp(s_sp[z], s_sp[ZB + z], s_sp[2 * ZB + z], s_sp[3 * ZB + z]);
            znew = zone_update_ctl(zt[z], az, bz, s_vol[z], sc.dt, sp, load);
          } else {
            znew = zone_update(zt[z], az, bz, s_vol[z], sc.dt);
          }
          s_zt[(i + 1) * ZB + z] = znew;
        }
        cc.sync();
      }
    }
    if (taped) put(sub, Tn);
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
    cc.sync();
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
    if (kExt) s_dsh[z] = s_dsc[z] = T(0);
    if constexpr (kMrt) s_lzf[z] = T(0);
  }
  SurfGrad<T> sg;  // this thread's share of the lane's surface-parameter cotangents (day)
#pragma unroll
  for (int f = 0; f < SF_NX; ++f) sg.v[f] = T(0);
  T d_me = T(0);  // kMrt: this thread's face's effective emissivity cotangent (day)

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
      if (kExt && a.ctl) s_lld[z] = g.d_ld_hist[(size_t)h * NB * ZB + b * ZB + z] / T(sub);
    }
    march_hour(h, true);

    T lqh[M];  // the hour's cotangent of each row's absorbed solar
#pragma unroll
    for (int j = 0; j < M; ++j) lqh[j] = T(0);
    T l_rad_out = T(0);  // the owner's: the hour's cotangent of its face's outdoor radiant temperature
    for (int i0 = ((sub - 1) / k) * k; i0 >= 0; i0 -= k) {
      {
        T x[M];
        get(i0, x);
        build(i0, x);
      }
      T gU[M];  // the group's cotangent of each segment's U (the segment below the row)
#pragma unroll
      for (int j = 0; j < M; ++j) gU[j] = T(0);
      // The thread's share of the group's operators' cotangents.
      T l_hf = T(0), l_hb = T(0), l_radf = T(0), l_radb = T(0), l_rft = T(0), l_rbt = T(0);

      for (int i = i0 + k - 1; i >= i0; --i) {
        // (a) zone update, one thread per zone.
        for (int z = tid; z < ZB; z += nthreads) {
          T laz, lbz, lzt, lvol;
          if (kExt && a.ctl) {
            T l_heat, l_cool;
            const Setpoints<T> sp(s_sp[z], s_sp[ZB + z], s_sp[2 * ZB + z], s_sp[3 * ZB + z]);
            zone_update_ctl_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z], s_vol[z], sc.dt, sp,
                                s_lz[z], s_lld[z], laz, lbz, lzt, lvol, l_heat, l_cool);
            s_dsh[z] += l_heat;
            s_dsc[z] += l_cool;
          } else {
            zone_update_adj(s_zt[i * ZB + z], s_az[i * ZB + z], s_bz[i * ZB + z], s_vol[z], sc.dt, s_lz[z], laz,
                            lbz, lzt, lvol);
          }
          s_laz[z] = laz;
          s_lbz[z] = lbz;
          s_lz[z] = lzt;
          s_dV[z] += lvol;
          s_da[z] += laz;
          s_db[z] += lbz;
        }
        cc.sync();

        // (b) the lane's sub-step, backwards.
        T Ts[M], T1[M], Tnew[M];
        get(i, Ts);
        get(sub + 1 + i, T1);
        get(i + 1, Tnew);
        T tf, tb;
        LB(s_zt + i * ZB, s_wx[i], tf, tb);
        {  // zone sums: a_z += h A T_s, b_z += h A, the faces' temperatures from Tnew
          const int zf = LB.zone_f, zb = LB.zone_b;
          const T laf0 = s_laz[zf >= 0 ? zf : 0], lbf0 = s_lbz[zf >= 0 ? zf : 0];
          const T lab0 = s_laz[zb >= 0 ? zb : 0], lbb0 = s_lbz[zb >= 0 ? zb : 0];
          const T la_f = zf >= 0 ? laf0 : T(0), lb_f = zf >= 0 ? lbf0 : T(0);
          const T la_b = zb >= 0 ? lab0 : T(0), lb_b = zb >= 0 ? lbb0 : T(0);
          T ts_f, ts_b;
          faces(Tnew, ts_f, ts_b);
          if (gr.rank == 0) lT[0] += la_f * (o.hf * LB.area);
          const T hab = o.hb * LB.area;
#pragma unroll
          for (int j = 0; j < M; ++j)
            if ((lbits >> j) & 1u) lT[j] += la_b * hab;
          if (owner) {
            const T lha = (back ? la_b * ts_b + lb_b : la_f * ts_f + lb_f);
            if (back)
              l_hb += lha * LB.area;
            else
              l_hf += lha * LB.area;
            sg.v[SF_AREA] += lha * (back ? o.hb : o.hf);
          }
        }
        // Stage 2: Tnew = M^{-1} (c1 C T1 - c2 C T + beta dt q).
        T lr[M], lT1[M], lq[M], dc[M];
#pragma unroll
        for (int j = 0; j < M; ++j) lr[j] = lT[j];
        solve_transposed(P, gr, ml, lr);
        {
          const T lr_dn = gr.next(lr[0], 1, T(0)), x_dn = gr.next(Tnew[0], 1, T(0));
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool v = (vb >> j) & 1u;
            const T c = cap[j], l = lr[j];
            lT1[j] = v ? sc.c1 * c * l : T(0);
            lT[j] = v ? -sc.c2 * c * l : l;
            lq[j] = v ? sc.b_dt * l : T(0);
            dc[j] = v ? l * ((sc.c1 * T1[j] - sc.c2 * Ts[j]) - Tnew[j]) : T(0);
            const T ln = j + 1 < M ? lr[j + 1] : lr_dn, xn = j + 1 < M ? Tnew[j + 1] : x_dn;
            gU[j] += ((links >> j) & 1u) ? -sc.a_dt * (l - ln) * (Tnew[j] - xn) : T(0);
            const T gd = v ? sc.a_dt * l * Tnew[j] : T(0);  // the band's diagonal cotangent on a face row
            if ((fb >> j) & 1u) {
              l_hf -= gd;
              l_radf -= gd;
            }
            if ((lbits >> j) & 1u) {
              l_hb -= gd;
              l_radb -= gd;
            }
          }
        }
        // Stage 1: T1 = M^{-1} (C T + (gamma dt/2) K T + gamma dt q).
        solve_transposed(P, gr, ml, lT1);
        {
          const T lr_up = gr.prev(lT1[M - 1], 1, T(0)), lr_dn = gr.next(lT1[0], 1, T(0));
          const T s_dn = gr.next(T1[0] + Ts[0], 1, T(0));
#pragma unroll
          for (int j = 0; j < M; ++j) {
            const bool v = (vb >> j) & 1u;
            const T l = lT1[j];
            const T up = j > 0 ? lT1[j - 1] : lr_up, dn = j + 1 < M ? lT1[j + 1] : lr_dn;
            const T mln = j + 1 < M ? ml[j + 1] : mu_last;
            lT[j] += v ? e[j] * l - mln * dn - ml[j] * up : l;
            dc[j] += v ? l * (Ts[j] - T1[j]) : T(0);
            lq[j] += v ? sc.g_dt * l : T(0);
            const T s = T1[j] + Ts[j], sn = j + 1 < M ? T1[j + 1] + Ts[j + 1] : s_dn;
            gU[j] += ((links >> j) & 1u) ? -sc.a_dt * (l - dn) * (s - sn) : T(0);
            const T gd = v ? sc.a_dt * l * s : T(0);
            if ((fb >> j) & 1u) {
              l_hf -= gd;
              l_radf -= gd;
            }
            if ((lbits >> j) & 1u) {
              l_hb -= gd;
              l_radb -= gd;
            }
            dCap[j] += dc[j];
          }
        }
        // Forcing q: absorbed solar and the faces' sources.
        T lt_f = T(0), lt_b = T(0);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T l = lq[j];
          lqh[j] += l;
          if ((fb >> j) & 1u) {
            lt_f += l * o.hf;
            l_hf += l * tf;
            l_radf += l * o.rad_ft;
            l_rft += l * o.radf;
          }
          if ((lbits >> j) & 1u) {
            lt_b += l * o.hb;
            l_hb += l * tb;
            l_radb += l * o.rad_bt;
            l_rbt += l * o.radb;
          }
        }

        if (i == i0) {
          // ---- the group's operator build, backwards (Ts is its start column)
          l_hf = gr.sum(l_hf);
          l_hb = gr.sum(l_hb);
          l_radf = gr.sum(l_radf);
          l_radb = gr.sum(l_radb);
          l_rft = gr.sum(l_rft);
          l_rbt = gr.sum(l_rbt);
          // K's band -> U; a cavity segment's through dU/dT into the start column
          // (its seg_u cotangent is written as 0).
          if constexpr (kCav) {
            const T t_next = gr.next(Ts[0], 1, T(0));
            const size_t ns = static_cast<size_t>(N) * SP;
            T carry = T(0);
#pragma unroll
            for (int j = 0; j < M; ++j) {
              const int s = row0 + j;
              if (((cav >> j) & 1u) && s + 1 < N) {
                T d_f, d_b;
                cavity_u(a.cav + lane + s * SP, ns, Ts[j], j + 1 < M ? Ts[j + 1] : t_next, &d_f, &d_b);
                lT[j] += gU[j] * d_f;
                if (j + 1 < M)
                  lT[j + 1] += gU[j] * d_b;
                else
                  carry = gU[j] * d_b;
              }
            }
            lT[0] += gr.prev(carry, 1, T(0));
          }
#pragma unroll
          for (int j = 0; j < M; ++j) dU[j] += gU[j];
          // The faces: the front's reverse on rank 0, the back's on rank 1.
          const Lane<T> L(a, lane, kCav);
          T ts_front, ts_back;
          faces(Ts, ts_front, ts_back);
          FaceCot<T> fc{T(0), T(0), T(0), T(0), T(0), T(0)};
          if (owner)
            fc = face_ops_adj<T, kMrt>(L, back, ts_front, ts_back, tf, tb, rad_out, s_wx[sub + i0], s_wx[2 * sub + i0],
                                       a.amb_bug, me, tm, back ? l_hb : l_hf, back ? l_radb : l_radf,
                                       back ? l_rbt : l_rft, sg, d_me);
          if constexpr (kMrt) {  // the network, backwards, from the group's start column
            const MrtLane<T> ML(a, g.net, lane);
            T l_ts = T(0);
            const T l_t0 = mrt_face_node_adj(ZB, s_mptr, s_mf, tid, nthreads, owner,
                                             ((ML.bits >> int(back)) & 1u) != 0, 2 * slot + int(back),
                                             back ? L.zone_b : L.zone_f, me, L.area, back ? ts_back : ts_front,
                                             hist, fc.l_tm, l_ts, d_me, sg.v[SF_AREA], s_ha, s_haT, s_lt, s_lnum,
                                             s_lden, s_lm, s_lzf, cc);
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
            if ((lbits >> j) & 1u) lT[j] += l_bs;
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
        cc.sync();

        // (c) the faces' boundary cotangents into their zones, in the
        // forward's fixed order of each zone's face list.
        for (int z = tid; z < ZB; z += nthreads) {
          const int gz = b * ZB + z;
          T sf = T(0), sb = T(0);
          for (int e2 = s_zptr[z]; e2 < s_zptr[z + 1]; ++e2) {
            const int f = s_zf[e2];
            if (f & 1)
              sb += cc.face(s_lt, f);
            else
              sf += cc.face(s_lt, f);
          }
          s_lz[z] += sf + sb;
          if constexpr (kMrt) {  // the network's fallback onto the zone row
            s_lz[z] += s_lzf[z];
            s_lzf[z] = T(0);
          }
          if (kExt && a.mixt_ptr) {
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
        if (kExt && a.mixt_ptr) cc.sync();
      }
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
      if (cc.lead()) {
        g.d_a[(size_t)h * NB * ZB + b * ZB + z] = s_da[z];
        g.d_b[(size_t)h * NB * ZB + b * ZB + z] = s_db[z];
      }
      if (kExt && a.sp_heat) {  // scheduled: the hour's rows take the cotangents
        if (cc.lead()) {
          g.d_sp_heat[(size_t)h * NB * ZB + b * ZB + z] = s_dsh[z];
          g.d_sp_cool[(size_t)h * NB * ZB + b * ZB + z] = s_dsc[z];
        }
        s_dsh[z] = s_dsc[z] = T(0);
      }
    }
  }

  // ---- outputs ------------------------------------------------------------
  // A cluster's CTAs read each other's face rows up to here: none leaves
  // (and frees its shared memory) before all are done.
  if constexpr (kCl) cc.sync();
  const unsigned mass = static_cast<unsigned>(lane_word<W>(a.lane, SP, LN_MASS, lane, a.N) >> row0) & own;
  const unsigned cav_all = kCav ? static_cast<unsigned>(lane_word<W>(a.lane, SP, LN_CAV, lane, a.N) >> row0) & own : 0u;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int n = row0 + j;
    if (n >= N) continue;
    g.dT0[n * SP + lane] = lT[j];
    g.d_node[(ND_U * N + n) * SP + lane] = ((cav_all >> j) & 1u) ? T(0) : dU[j];
    g.d_node[(ND_CAP * N + n) * SP + lane] = ((mass >> j) & 1u) ? dCap[j] : T(0);
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
  if (cc.lead()) {
    for (int z = tid; z < ZB; z += nthreads) {
      g.d_zT0[b * ZB + z] = s_lz[z];
      g.d_zv[b * ZB + z] = s_dV[z];
      if (kExt && a.ctl) {  // the compiled rows (0 where the march was scheduled)
        g.d_ctl[b * ZB + z] = s_dsh[z];
        g.d_ctl[NB * ZB + b * ZB + z] = s_dsc[z];
      }
    }
  }
}

template <typename T, int kV, bool kExt, bool kCav, bool kMrt>
int launch_tr_adj(const AdjArgsOf<T, kMrt>& g, cudaStream_t stream, int* block_threads) {
  constexpr LaunchVariant V = kAdjLaunchVariants[kV];
  constexpr bool kCl = V.cluster > 1;
  const DayArgs<T>& a = g.in;
  const int C = cluster_ctas(V, a.SB), lanes = a.SB / C;
  const size_t smem = tr_adj_smem<T, kExt, kMrt, kAdjStaged<V.threads>, V.nodes>(a, lanes);
  const auto kernel =
      day_adjoint_tr_kernel<T, V.threads, kAdjVariantBlocks<T, kV>, kExt, kCav, kMrt, V.group, V.nodes, kCl>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (block_threads) *block_threads = V.threads;
  if constexpr (kCl) return launch_cluster(kernel, a.NB, C, lanes * V.group, smem, stream, g);
  kernel<<<a.NB, a.SB * V.group, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The kind's kernel in the host's launch variant (DayArgs::variant, which
// the C entry checked); a block whose staged rows would not fit a block's
// shared memory runs the unstaged G = 4 variant.  Writes the threads
// of a CTA of the variant that ran to *block_threads.
template <typename T, bool kExt, bool kCav, bool kMrt>
int launch_kind(const AdjArgsOf<T, kMrt>& g, cudaStream_t st, int* bt) {
  int v = g.in.variant;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (v < kAdjUnstaged && tr_adj_smem<T, kExt, kMrt, true, 32>(g.in, g.in.SB) > static_cast<size_t>(optin))
    v = kAdjUnstaged;
  switch (v) {
    case 0: return launch_tr_adj<T, 0, kExt, kCav, kMrt>(g, st, bt);
    case 1: return launch_tr_adj<T, 1, kExt, kCav, kMrt>(g, st, bt);
    case 2: return launch_tr_adj<T, 2, kExt, kCav, kMrt>(g, st, bt);
    case 3:
      return std::is_same_v<T, float> ? heatx_day_adjoint_tr_b1_f32(&g, kExt, kCav, kMrt, st, bt)
                                      : heatx_day_adjoint_tr_b1_f64(&g, kExt, kCav, kMrt, st, bt);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#if defined(HEATX_DAY_ADJOINT_TR_B1_UNIT)
// The cluster variant's kind (the flags are launch_kind's).
template <typename T>
int day_adjoint_tr_b1(const void* args, int ext, int cav, int mrt, void* stream, int* bt) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mrt) {
    const MrtAdjArgs<T>& g = *static_cast<const MrtAdjArgs<T>*>(args);
    return cav ? launch_tr_adj<T, 3, true, true, true>(g, st, bt) : launch_tr_adj<T, 3, true, false, true>(g, st, bt);
  }
  const AdjArgs<T>& g = *static_cast<const AdjArgs<T>*>(args);
  if (cav) return launch_tr_adj<T, 3, true, true, false>(g, st, bt);
  return ext ? launch_tr_adj<T, 3, true, false, false>(g, st, bt) : launch_tr_adj<T, 3, false, false, false>(g, st, bt);
}
#elif !defined(HEATX_DAY_ADJOINT_TR_KMRT_UNIT)
// Free-float buildings run the kind without the extra zone code; thermostats,
// schedules or mixing the extended one (kExt); gas cavities the extended one
// with the cavity code (kCav); MRT physics the kMrt unit's kinds.
template <typename T>
int day_adjoint_tr(const void* args, void* stream, int* bt) {
  const MrtAdjArgs<T>& g = *static_cast<const MrtAdjArgs<T>*>(args);
  const DayArgs<T>& a = g.in;
  if (g.net.phys)
    return std::is_same_v<T, float> ? heatx_day_adjoint_tr_mrt_f32(args, stream, bt)
                                    : heatx_day_adjoint_tr_mrt_f64(args, stream, bt);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdjArgs<T>& base = g;
  if (a.cav) return launch_kind<T, true, true, false>(base, st, bt);
  const bool ext = a.ctl || a.mix_ptr;
  return ext ? launch_kind<T, true, false, false>(base, st, bt) : launch_kind<T, false, false, false>(base, st, bt);
}
#else
template <typename T>
int day_adjoint_tr_mrt(const void* args, void* stream, int* bt) {
  const MrtAdjArgs<T>& g = *static_cast<const MrtAdjArgs<T>*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return g.in.cav ? launch_kind<T, true, true, true>(g, st, bt) : launch_kind<T, true, false, true>(g, st, bt);
}
#endif

}  // namespace

extern "C" {
#if defined(HEATX_DAY_ADJOINT_TR_B1_UNIT)
int heatx_day_adjoint_tr_b1_f32(const void* g, int ext, int cav, int mrt, void* stream, int* bt) {
  return day_adjoint_tr_b1<float>(g, ext, cav, mrt, stream, bt);
}
int heatx_day_adjoint_tr_b1_f64(const void* g, int ext, int cav, int mrt, void* stream, int* bt) {
  return day_adjoint_tr_b1<double>(g, ext, cav, mrt, stream, bt);
}
#elif !defined(HEATX_DAY_ADJOINT_TR_KMRT_UNIT)
int heatx_day_adjoint_tr_f32(const void* g, void* stream, int* bt) { return day_adjoint_tr<float>(g, stream, bt); }
int heatx_day_adjoint_tr_f64(const void* g, void* stream, int* bt) { return day_adjoint_tr<double>(g, stream, bt); }
#else
int heatx_day_adjoint_tr_mrt_f32(const void* g, void* stream, int* bt) {
  return day_adjoint_tr_mrt<float>(g, stream, bt);
}
int heatx_day_adjoint_tr_mrt_f64(const void* g, void* stream, int* bt) {
  return day_adjoint_tr_mrt<double>(g, stream, bt);
}
#endif
}  // extern "C"
