// The TR-BDF2 day march for NVIDIA Hopper (sm_90a): several threads per
// surface.  day_march.cu's C entry hands every trbdf2 / trbdf2_refresh launch
// to heatx_day_march_tr_f32/_f64 here (ctypes; heatx_torch/ops/day_march.py).
//
// Replaces heatx/ops/pallas_step.py::make_hour_march -> `kernel` (the
// pl.pallas_call at pallas_step.py:1976) in modes trbdf2 / trbdf2_refresh,
// body `_hour_body_imp` (:777): free-float, with thermostats, schedules,
// mixing and the in-run shading and ventilation gates (kExt), with gas
// cavities (kCav), with interior MRT and the h/q and operative histories
// (kMrt, in day_march_tr_mrt.cu).  One launch marches `hours` hours of
// `substeps` sub-steps per operator group of `refresh_every`.
//
// What bounded the first design (one thread per surface, day_march.cu up to
// its parity-only form): a serial latency chain.  A sub-step is two stage
// solves of ~25 rows, four sweeps of about 100 dependent row steps, and every
// step re-read statics from device memory (capacity, U through the K rows,
// the solar fractions through the forcing, a cavity lane's U from a global
// per-launch row); the node columns were runtime-indexed per-thread arrays in
// local memory; and with one 32-thread block per zone-closed block the card
// held 2.5 warps per SM, so nothing hid the latency.  Its bench-city
// day-launch took 2.980 ms against a bound of 0.0094 ms by operations.
//
// This design:
//  * G threads per surface lane (G a template parameter: 4, 8 or 16; blockDim
//    = lanes x G), thread `rank` owning the M = 32/G consecutive node rows
//    [rank*M, rank*M + M) in unrolled register arrays: no runtime-indexed
//    per-thread array, no local memory.  The block is still one zone-closed
//    block of block_building; the wrapper picks G per launch so that lanes x
//    G stays within an instantiation's launch bound (below).
//  * Statics loaded once per launch: each row's valid/first/last bits in
//    registers, its capacity and U to the row above in shared memory (read by
//    its thread only: registers go to the column, its stage-1 operator and
//    the factors), the lane's boundaries and last face fluxes in a shared
//    row per lane (in registers the f32 kernel spilled).  The solar forcing of each row is formed once per hour,
//    after shading, into shared memory the same way.  Each operator build
//    leaves the stage-1 operator by rows in registers (e = C + (gamma dt/2)
//    K_d and the lower coefficient), so a row's right-hand side is three
//    fused multiply-adds.  A cavity segment's U is computed by the thread that owns the
//    segment's first row, with the next row's temperature by shuffle, and
//    stays in registers (a thread's last segment goes to its successor by
//    one shuffle): no device-memory round trip.
//  * Each stage solve is partitioned (day_tr.cuh PartFactors): every thread
//    eliminates its own M rows, the group's 2G first and last rows form a
//    tridiagonal reduced system that parallel cyclic reduction solves across
//    the group with warp shuffles, and every thread back-substitutes its
//    rows.  The factors are built at each operator build and serve both
//    stages of every sub-step of the group.  The stage matrix C - (gamma
//    dt/2) K is diagonally dominant (weakly on no-mass rows), so nothing
//    pivots.  K T needs one row from each neighbouring chunk: two shuffles.
//  * Face work in parallel: rank 0 computes the front face's film (TARP),
//    linearized radiation and MRT view, the other ranks the back face's, from
//    the faces' temperatures (row 0 by shuffle, the last valid rows by a
//    group sum); the six results reach the group by shuffle.  Rank 0 writes
//    the lane's rows of the shared face sums.
//  * The zone phase keeps its meaning and its determinism: no float atomics,
//    two barriers per sub-step; mixing, thermostats, the swap of the two
//    zone rows, shading and the gates at the hour's top are day_march.cu's.
//    A warp sums each zone (when the block is whole warps): lane l adds the
//    entries l, l+32, ... of the host's fixed-order face list, and a fixed
//    xor tree over the 32 lanes adds the lanes' sums, so the order of the
//    additions is the same from run to run (a block of another thread count
//    sums each zone on one thread in list order).
//  * Interior MRT: the network's fixed point with the faces split the same
//    way and its zone sums a warp per zone (mrt_face_node), eight barriers
//    per evaluation as before.

#include <type_traits>

#include "day_common.cuh"
#include "day_march_args.cuh"
#include "day_tr.cuh"

// The kMrt kinds live in their own compilation unit (day_march_tr_mrt.cu,
// which includes this file), as the parity body's do.
extern "C" int heatx_day_march_tr_mrt_f32(const void* m, void* stream, int group);
extern "C" int heatx_day_march_tr_mrt_f64(const void* m, void* stream, int group);

namespace {

using namespace heatx;

// Launch bounds (threads per block, and in f32 the blocks an SM must hold):
// G = 4 at 128 and three blocks (blocks of up to 32 lanes, such as the bench
// city's: its 334 blocks then run in one wave on 132 SMs), at 256 (up to 64
// lanes) and at 1024 (up to 256 lanes, 64 registers a thread); G = 8 at 256
// and three blocks; G = 16 at 512.
constexpr int kG4 = 128;
constexpr int kG4Mid = 256;
constexpr int kG8 = 256;
constexpr int kG16 = 512;
constexpr int kWide = 1024;
template <typename T>
constexpr int kThree = sizeof(T) == 4 ? 3 : 1;
// Whether a variant keeps each thread's rows' capacities, solar forcing and
// U in shared memory (the 1024-thread one, whose blocks may need more than a
// block's 227 KB for them in f64, keeps them in its registers).
template <int kThreads>
constexpr bool kStaged = kThreads < kWide;

// Bytes of a block's dynamic shared memory: the zone row, the per-face rows,
// the hour's gains and the zones' volumes, with kExt the new zone row, the
// load sums and the hour's four setpoint rows, with kMrt the MRT nodes; the
// hour's weather; the lanes' last face fluxes; with kRowsShared each thread's
// rows' capacities, solar forcing and U to the row above (kMaxNodes rows a
// lane: 48 KB in f64 at 64 lanes); the lanes' boundaries; then the zone lists
// and, with kMrt, the network lists (ints).
template <typename T, bool kExt, bool kMrt, bool kRowsShared>
size_t tr_smem(const DayArgs<T>& a) {
  const size_t zrows = 4 + (kExt ? 6 : 0) + (kMrt ? 1 : 0);
  const size_t lists = (kMrt ? 2 : 1) * (a.ZB + 1 + 2 * static_cast<size_t>(a.SB));
  const size_t rows = kRowsShared ? 3 * static_cast<size_t>(kMaxNodes) * a.SB : 0;
  return sizeof(T) * (zrows * a.ZB + 6 * static_cast<size_t>(a.SB) + 3 * static_cast<size_t>(a.substeps) + rows) +
         (sizeof(LaneBounds<T>) * a.SB + 16) + sizeof(int) * lists;
}

template <typename T, int G, int kThreads, int kMinBlocks, bool kExt, bool kCav, bool kMrt>
__global__ void __launch_bounds__(kThreads, kMinBlocks) day_march_tr_kernel(const MarchArgsOf<T, kMrt> m) {
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
  T* s_wx = s_tm + (kMrt ? a.ZB : 0);        // [3*substeps] the hour's t_out, wind, wdir
  // [M][blockDim] each thread's rows' capacities, the hour's solar forcing
  // and U to the row above (row j of thread t at j*blockDim + t: read by that
  // thread only, kept here to leave registers to the columns and the factors)
  constexpr bool kShared = kStaged<kThreads>;
  T* s_cap = s_wx + 3 * a.substeps;
  T* s_sq = s_cap + (kShared ? kMaxNodes * a.SB : 0);
  T* s_kl = s_sq + (kShared ? kMaxNodes * a.SB : 0);
  T* s_q = s_kl + (kShared ? kMaxNodes * a.SB : 0);  // [2*SB] each lane's last q_front, q_back
  // [SB] each lane's boundaries (LaneBounds), read by its group's threads
  LaneBounds<T>* s_lb = reinterpret_cast<LaneBounds<T>*>(
      (reinterpret_cast<size_t>(s_q + 2 * a.SB) + 15) & ~static_cast<size_t>(15));
  int* s_zptr = reinterpret_cast<int*>(s_lb + a.SB);  // [ZB+1] block-local face offsets
  int* s_zf = s_zptr + a.ZB + 1;                                // [<= 2*SB] the zones' faces
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
  const Scheme<T> sc(a);
  // The lane's boundaries live in shared memory (registers go to the column,
  // its operator and the factors).
  if (g.rank == 0) s_lb[slot] = LaneBounds<T>(Lane<T>(a, lane, kCav));
  const LaneBounds<T>& LB = s_lb[slot];

  // The thread's rows: bit j of each word is row row0 + j.
  const unsigned col = N < 32 ? (1u << N) - 1u : ~0u;
  const unsigned bits = static_cast<unsigned>(a.lane[LN_BITS * SP + lane]) & col;
  constexpr unsigned own = (1u << M) - 1u;
  const unsigned vb = (bits >> row0) & own;
  const unsigned fb = ((bits & ~(bits << 1)) >> row0) & own;
  const unsigned lasts = bits & ~(bits >> 1);
  const unsigned lb = (lasts >> row0) & own;
  const unsigned lf = bits & (bits << 1);  // left(i): rows i-1 and i valid
  const unsigned cav = kCav ? (static_cast<unsigned>(a.lane[LN_CAV * SP + lane]) >> row0) & own : 0u;
  // The back face's temperature: one shuffle from the owner of the column's
  // last valid row when every lane of the warp has one such row (the sum of
  // the group's partial sums otherwise, as Lane::last_node sums them).
  const bool one_last = __all_sync(g.mask, __popc(lasts) <= 1);
  const int last_owner = lasts ? (31 - __clz(lasts)) / M : 0;
  const T* U = a.node + (ND_U * N) * SP + lane;
  const T* FA = a.node + (ND_FA * N) * SP + lane;
  const T* FB = a.node + (ND_FB * N) * SP + lane;
  Rows<T, M, kShared> cap{s_cap + tid, nthreads}, sq{s_sq + tid, nthreads};
  Rows<T, M, kShared> kl{s_kl + tid, nthreads};  // K's lower coefficient (U to the row above), 0 off the column
  // Rows are loaded and computed unconditionally (clamped indices, then a
  // select): a load under a condition becomes a branch region per row, and
  // the rows then wait for each other's loads.
  T Tn[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int i = row0 + j, ic = min(i, N - 1);
    const bool in = i < N;
    const T t0 = a.T0[ic * SP + lane], c = a.node[(ND_CAP * N + ic) * SP + lane], u = U[max(i - 1, 0) * SP];
    Tn[j] = in ? t0 : T(0);
    cap[j] = in ? c : T(0);
    kl[j] = ((lf >> i) & 1u) ? u : T(0);
  }
  const int il = row0 + M - 1;  // the segment below the thread's last row
  T ku_last = (il + 1 < 32 && ((lf >> (il + 1)) & 1u)) ? U[il * SP] : T(0);
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

  // The face temperatures of the column Tn: (front, back).
  auto faces = [&](T& ts_f, T& ts_b) {
    T part = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j)
      if ((lb >> j) & 1u) part += Tn[j];
    ts_b = one_last ? g.from(part, last_owner) : g.sum(part);
    ts_f = g.from(Tn[0], 0);
  };

  Ops<T> o{};
  PartFactors<T, G> P;
  // The group's stage-1 operator by rows, from each operator build: the
  // diagonal e = C + (gamma dt/2) K_d and the lower coefficient ml = -(gamma
  // dt/2) K_l of valid rows (the upper one of row j is ml of row j + 1, the
  // thread's last row's is mu_last), so that C T + (gamma dt/2) K T = e T -
  // ml T_up - mu T_down.
  T e[M], ml[M], mu_last = T(0);
  if (g.rank == 0) s_q[2 * slot] = s_q[2 * slot + 1] = T(0);
  for (int h = 0; h < a.hours; ++h) {
    // The in-run controls at the main step's start (day_march.cu's notes).
    T shade = T(1);
    if (kExt && a.shade_slot) {
      const int z = a.shade_slot[lane];
      if (z >= 0 && s_zT[z] > a.shade_sp[(size_t)h * a.shade_sp_stride + lane])
        shade = a.shade_tau[lane];
    }
    {  // the hour's forcing: clamped solar per row (the absorption fractions
       // read once an hour), the face's outdoor radiant temperature
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
      }
      __syncthreads();
    }
    for (int i0 = 0; i0 < sub; i0 += a.refresh_every) {
      // ---- the operators of the group, from its start column ---------------
      const Lane<T> L(a, lane, kCav);
      T t_front, t_back, ts_front, ts_back;
      LB(s_zT, s_wx[i0], t_front, t_back);
      faces(ts_front, ts_back);
      T me = T(0), tm = T(0);
      if constexpr (kMrt) {
        // The network frozen with the operators, from the group's start
        // (without MRT physics an empty context: the faces' own radiation).
        if (m.net.phys) {
          const MrtLane<T> ML(a, m.net, lane);
          me = back ? ML.eb : ML.ef;
          tm = mrt_face_node(ZB, s_mptr, s_mf, tid, nthreads, g.rank < 2, ((ML.bits >> int(back)) & 1u) != 0,
                             2 * slot + int(back), back ? L.zone_b : L.zone_f, me, L.area,
                             back ? ts_back : ts_front, back ? t_back : t_front, s_zT, s_ha, s_haT, s_tm);
        }
      }
      if constexpr (kCav) {  // the cavity segments' U from the start column
        const T t_next = g.next(Tn[0], 1, T(0));
        const size_t ns = static_cast<size_t>(N) * SP;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int s = row0 + j;
          if (((cav >> j) & 1u) && s + 1 < N) {
            const T u = cavity_u(L.Cav + s * SP, ns, Tn[j], j + 1 < M ? Tn[j + 1] : t_next,
                                 static_cast<T*>(nullptr), static_cast<T*>(nullptr));
            const bool link = (lf >> (s + 1)) & 1u;
            if (j + 1 < M)
              kl[j + 1] = link ? u : T(0);
            else
              ku_last = link ? u : T(0);
          }
        }
        kl[0] = g.prev(ku_last, 1, T(0));
      }
      const FaceOps<T> fo = face_ops<T, kMrt>(L, back, ts_front, ts_back, t_front, t_back, rad_out,
                                              s_wx[sub + i0], s_wx[2 * sub + i0], a.amb_bug, me, tm);
      o.hf = g.from(fo.h, 0);
      o.radf = g.from(fo.rad, 0);
      o.rad_ft = g.from(fo.rad_t, 0);
      o.hb = g.from(fo.h, 1);
      o.radb = g.from(fo.rad, 1);
      o.rad_bt = g.from(fo.rad_t, 1);
      {
        T md[M], mu[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool v = (vb >> j) & 1u;
          const T klj = kl[j], ku = j + 1 < M ? kl[j + 1] : ku_last;
          const T kd = -(klj + ku + (((fb >> j) & 1u) ? o.hf + o.radf : T(0)) +
                         (((lb >> j) & 1u) ? o.hb + o.radb : T(0)));
          const T c = cap[j];
          e[j] = c + sc.a_dt * kd;
          md[j] = v ? c - sc.a_dt * kd : T(1);
          ml[j] = v ? -sc.a_dt * klj : T(0);
          mu[j] = v ? -sc.a_dt * ku : T(0);
        }
        mu_last = mu[M - 1];
        P.factor(g, ml, md, mu);
      }

      for (int i = i0; i < i0 + a.refresh_every; ++i) {
        // ---- one TR-BDF2 sub-step on the group's factors ---------------------
        LB(s_zT, s_wx[i], t_front, t_back);
        const T src_f = t_front * o.hf + o.radf * o.rad_ft;
        const T src_b = t_back * o.hb + o.radb * o.rad_bt;
        // row j's forcing: absorbed solar plus, on a boundary row, the face's
        // sources (+0 elsewhere changes no bit)
        auto forcing = [&](int j) {
          const T q = sq[j];
          return (q + (((fb >> j) & 1u) ? src_f : T(0))) + (((lb >> j) & 1u) ? src_b : T(0));
        };
        const T x_dn = g.prev(Tn[M - 1], 1, T(0)), x_up = g.next(Tn[0], 1, T(0));
        T T1[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool v = (vb >> j) & 1u;
          const T up = j > 0 ? Tn[j - 1] : x_dn, down = j + 1 < M ? Tn[j + 1] : x_up;
          const T mu = j + 1 < M ? ml[j + 1] : mu_last;
          const T r = e[j] * Tn[j] - ml[j] * up - mu * down + sc.g_dt * forcing(j);
          T1[j] = v ? r : Tn[j];
        }
        P.solve(g, ml, T1);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool v = (vb >> j) & 1u;
          const T c = cap[j];
          const T r = sc.c1 * c * T1[j] - sc.c2 * c * Tn[j] + sc.b_dt * forcing(j);
          Tn[j] = v ? r : Tn[j];
        }
        P.solve(g, ml, Tn);

        T ts_f, ts_b;
        faces(ts_f, ts_b);
        if (g.rank == 0) {
          s_q[2 * slot] = (ts_f - t_front) * o.hf;
          s_q[2 * slot + 1] = (ts_b - t_back) * o.hb;
          const T haf = o.hf * LB.area, hab = o.hb * LB.area;
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
              s_zN[z] = zone_update_ctl(s_zT[z], az, bz, s_vol[z], sc.dt, sp, load);
              s_ld[z] += load;
            } else {
              s_zN[z] = zone_update(s_zT[z], az, bz, s_vol[z], sc.dt);
            }
          } else {
            s_zT[z] = zone_update(s_zT[z], az, bz, s_vol[z], sc.dt);
          }
        }
        __syncthreads();
        if (kExt) {  // the new row becomes the current one
          T* t = s_zT;
          s_zT = s_zN;
          s_zN = t;
        }
      }
    }

    // ---- end of hour: the histories, the non-finite count -----------------
    if constexpr (kMrt) {
      if (m.hq_hist && g.rank == 0) {
        T* hq_h = m.hq_hist + (size_t)h * 4 * SP + lane;
        hq_h[0] = o.hf;
        hq_h[SP] = o.hb;
        hq_h[2 * SP] = s_q[2 * slot];
        hq_h[3 * SP] = s_q[2 * slot + 1];
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
    m.hq[lane] = o.hf;
    m.hq[SP + lane] = o.hb;
    m.hq[2 * SP + lane] = s_q[2 * slot];
    m.hq[3 * SP + lane] = s_q[2 * slot + 1];
  }
  for (int z = tid; z < ZB; z += nthreads) m.zT_out[b * ZB + z] = s_zT[z];
}

template <typename T, int G, int kThreads, int kMinBlocks, bool kExt, bool kCav, bool kMrt>
int launch_tr(const MarchArgsOf<T, kMrt>& m, cudaStream_t stream) {
  const DayArgs<T>& a = m.in;
  const size_t smem = tr_smem<T, kExt, kMrt, kStaged<kThreads>>(a);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(day_march_tr_kernel<T, G, kThreads, kMinBlocks, kExt, kCav, kMrt>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  day_march_tr_kernel<T, G, kThreads, kMinBlocks, kExt, kCav, kMrt><<<a.NB, a.SB * G, smem, stream>>>(m);
  return static_cast<int>(cudaGetLastError());
}

// The kind's kernel with `group` threads per surface whose launch bound holds
// lanes x group threads (day_march.threads_per_surface picks the group from
// day_march.GROUP_MAX_THREADS, which tests/test_torch_partitioned_solve.py
// holds to these lines).
template <typename T, bool kExt, bool kCav, bool kMrt>
int launch_group(const MarchArgsOf<T, kMrt>& m, int group, cudaStream_t st) {
  const int threads = m.in.SB * group;
  if (group == 4 && threads <= kG4) return launch_tr<T, 4, kG4, kThree<T>, kExt, kCav, kMrt>(m, st);
  if (group == 4 && threads <= kG4Mid) return launch_tr<T, 4, kG4Mid, 1, kExt, kCav, kMrt>(m, st);
  if (group == 4 && threads <= kWide) return launch_tr<T, 4, kWide, 1, kExt, kCav, kMrt>(m, st);
  if (group == 8 && threads <= kG8) return launch_tr<T, 8, kG8, kThree<T>, kExt, kCav, kMrt>(m, st);
  if (group == 16 && threads <= kG16) return launch_tr<T, 16, kG16, 1, kExt, kCav, kMrt>(m, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifndef HEATX_DAY_MARCH_TR_KMRT_UNIT
// Free-float buildings run the kind without the extra zone code; thermostats,
// mixing, shading or gates the extended one (kExt); gas cavities the extended
// one with the cavity code (kCav); MRT physics and the histories the kMrt
// unit's kinds.
template <typename T>
int day_march_tr(const void* args, void* stream, int group) {
  const MrtMarchArgs<T>& m = *static_cast<const MrtMarchArgs<T>*>(args);
  const DayArgs<T>& a = m.in;
  if (m.net.mrt)
    return std::is_same_v<T, float> ? heatx_day_march_tr_mrt_f32(args, stream, group)
                                    : heatx_day_march_tr_mrt_f64(args, stream, group);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MarchArgs<T>& base = m;
  if (a.cav) return launch_group<T, true, true, false>(base, group, st);
  const bool ext = a.ctl || a.mix_ptr || a.shade_slot || a.vent_min;
  return ext ? launch_group<T, true, false, false>(base, group, st)
             : launch_group<T, false, false, false>(base, group, st);
}
#else
template <typename T>
int day_march_tr_mrt(const void* args, void* stream, int group) {
  const MrtMarchArgs<T>& m = *static_cast<const MrtMarchArgs<T>*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return m.in.cav ? launch_group<T, true, true, true>(m, group, st)
                  : launch_group<T, true, false, true>(m, group, st);
}
#endif

}  // namespace

extern "C" {
#ifndef HEATX_DAY_MARCH_TR_KMRT_UNIT
int heatx_day_march_tr_f32(const void* m, void* stream, int group) {
  return day_march_tr<float>(m, stream, group);
}
int heatx_day_march_tr_f64(const void* m, void* stream, int group) {
  return day_march_tr<double>(m, stream, group);
}
#else
int heatx_day_march_tr_mrt_f32(const void* m, void* stream, int group) {
  return day_march_tr_mrt<float>(m, stream, group);
}
int heatx_day_march_tr_mrt_f64(const void* m, void* stream, int group) {
  return day_march_tr_mrt<double>(m, stream, group);
}
#endif
}  // extern "C"
