// Newview chunk kernel (B1) for Hopper, sm_90a.
//
// Replaces examl_tpu/ops/pallas_newview.py::_chunk_kernel (launched there
// by _run_chunk, driven by chunk_applier).  One host call runs a full
// traversal's launch table (examl_tpu_torch/ops/fastpath.py): as one
// dataflow launch over the whole table (point 8), or as one launch per
// chunk with real entries, in order (the route of each instance is a
// constant table in ops/newview_chunk.py).  A table row is `real`
// independent newview entries of one tip case, kind 0 = tip/tip, 1 =
// tip/inner (tip left), 2 = inner/inner; entry w reads packed slot
// slot + w and writes CLV arena row base + w and its scaler row in place:
//
//   y[r][a] = u[slot + w][side][part(b)][code][r][a] for a tip child (the
//             tip products, built once per traversal by the wrapper,
//             ops/newview_chunk.py chunk_apply: the JAX package's _ump), or
//             sum_k P[slot + w][side][part(b)][r][a][k] * x[r][k] for an
//             inner child whose arena row holds x
//   v = yl * yr;  where max|v| < 2^-E:  v *= 2^E and the scaler adds 1;
//   scaler = scaler(left) + scaler(right) + that increment.
//
// Bound.  Memory bandwidth.  Per site an entry reads two child rows
// (R*K values) or a 1-byte code per tip child, plus the children's int32
// scalers, and writes one row and one scaler.  A real-size DNA traversal
// (512 taxa x 131,072 patterns, f32) moves 9.14 GB: 2.73 ms at 3.35 TB/s,
// against 0.32 ms of FMAs at 67 TFLOP/s.  A real-size amino-acid one
// (32,768 patterns, K = 20) moves 10.82 GB, 3.23 ms, and does 5.5e10
// flops (2*R*K*K per inner child and site; chip_smoke.py's
// traversal_flops), 0.82 ms: a quarter of the bytes' time, so the FMAs
// have to hide under the copies, not merely fit.
//
// Why this design (each part against a measured loss; NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke.py phases 10 and 16; numbers in PERF.md):
//
// 1. No padding.  The TPU layout runs 97 chunks per real-size DNA
//    traversal (1,272 slots for 510 entries, 24.46 GB); the host hands
//    over only the 72 chunks with real entries at their real widths, and
//    a launch covers exactly real x tiles: 8.80 -> 4.04 ms.
// 2. Tiles and a bulk-copy ring.  A tile is (entry, TL consecutive sites
//    of one 128-site block); for an inner child it is one contiguous slab
//    of the arena row and a scaler slab, for a tip a code slab.
//    Persistent CTAs walk the launch's tiles with a grid stride.  A
//    producer warp keeps the ring's stages filling with 1-D cp.async.bulk
//    copies (mbarrier::complete_tx::bytes): both children's slabs, and
//    the entry's P (inner child) or tip products (tip) for the tile's
//    partition.  `full` barriers count the bytes in, `empty` barriers the
//    consumer warps out.  Slabs are 16-byte aligned (the wrapper checks
//    every base address; every piece is a 16-byte multiple).  No thread
//    returns early: the ring is drained and its barriers invalidated
//    before the CTA ends.
// 3. Tip products as an operand.  A tip child's y depends only on (code,
//    rate), so the wrapper builds u[code][r][a] for every slot once per
//    traversal (one einsum) and a tile copies its slot's C*R*K values.
//    The first K = 20 body built this table per 32-site tile in the
//    consumers (C*R*K*K = 36,800 FMAs per tile and tip child, as many as
//    the tile's own products, behind a runtime division by C): its
//    tip/tip launches ran at 0.52 TB/s and tip/inner at 0.84 TB/s.
// 4. Programmatic dependent launch.  Launches after the first carry
//    cudaLaunchAttributeProgrammaticStreamSerialization: chunk k+1's CTAs
//    start while chunk k drains and set up their barriers, then wait
//    (griddepcontrol.wait) before their first access to the arena; chunk
//    k signals (griddepcontrol.launch_dependents) once its last tile is
//    issued.  The tile walk steps (entry, tile) by subtraction (`Tile`):
//    no integer division in a loop over tiles or values.
// 5. K <= 4 (DNA, binary): one thread per (site, rate), a 128-site tile,
//    three stages, two or three CTAs per SM; each FMA chain per (r, a) as
//    in the plain version; the rescale decision is the max over the
//    site's R lanes by __shfl_xor_sync.  At K = 2 a rate's values are 8
//    bytes in f32, so load_vec takes its scalar path.
// 6. K = 20 (amino acids): the register-blocked body of newview_tile.cuh.
//    The first body (one thread per (site, rate), 32-site tiles, two CTAs
//    per SM) had 8 FMA warps per SM, each thread running 20 dependent
//    20-FMA chains with one shared-memory read per FMA: its inner/inner
//    launches reached 1.07 TB/s and ~7 TFLOP/s.  Now a thread owns one
//    rate, half the outputs and two sites: one 16-byte read of P feeds
//    eight FMAs in two independent chains (each still k = 0..K-1, so the
//    values stay the plain version's), and a tile is a whole block in
//    f32: 16 consumer warps, one CTA per SM, rings of 2 (inner/inner,
//    96 KB a stage), 3 or 4 stages by kind.  f64 takes a quarter block,
//    one site a thread (8 warps, one CTA per SM).  Outputs go through shared
//    memory (the right child's slab, or a buffer for tip/tip), so a warp
//    writes its sites' rows with contiguous 16-byte stores.  With 17
//    warps a thread may have 96 registers (5 warps share one of the SM's
//    four register files), so P rows are read 16 bytes at a time and the
//    stage layout is a kernel parameter (constant bank), not registers.
//
// Measured (f32, real size, per traversal through chunk_apply, the tip
// products included; NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phases
// 10 and 16): K = 20 4.47 ms against a 3.23 ms bound (tip products 0.16
// ms; 2.42 TB/s, 12.2 TFLOP/s; the kernel by kind: tip/tip 2.68 TB/s,
// tip/inner 2.52, inner/inner 2.40 at 16.0 TFLOP/s), where the first
// K = 20 body took 12.64 ms; K = 4 3.51 ms (tip products 0.10; bound
// 2.73; 3.55 ms with the tip table built per tile); K = 2 0.67 ms (bound
// 0.36).  ptxas: no K = 20 instance spills (f32 96 registers, f64 up to
// 152).
//
// 7. bfloat16 storage (the JAX package's EXAML_CLV_DTYPE=bf16; its chunk
//    program upcasts after the gather and rounds after the rescale,
//    examl_tpu/ops/fastpath.py:741, :770-782).  The instances with
//    storage type S = __nv_bfloat16 compute in T = float: the arena rows
//    and the staged child slabs are bfloat16, P, the tip products, the
//    FMA chains (k = 0..K-1, as in float32) and the rescale decision
//    float32.  A staged slab widens exactly on its load from shared
//    memory; each output is rounded to nearest even once, after the
//    rescale (__float2bfloat16_rn, as torch's and JAX's casts round).
//    Bound: bytes, as for float32, with 2-byte rows (a real-size DNA
//    traversal moves 4.87 GB instead of 9.14: 36 instead of 68 bytes per
//    site and row, 1.45 ms).  On the float32 geometry the K = 20
//    instance took 3.51 ms against a 1.64 ms bound: at half the bytes
//    the FMAs set the pace (19.1 TFLOP/s in its inner/inner launches),
//    and at 96 registers a thread it spilled.  Its blocked body now runs
//    NS = 4 sites a thread on 8 consumer warps (up to 224 registers; the
//    geometry is a property of (S, T, K), Blocked and Geom, so the f32
//    and f64 instances compile as before): 168 registers, no spill, one
//    16-byte P read feeding 16 FMAs in 4 chains, the x values widened to
//    f32 once per tile (packed bfloat16 pairs would cost an integer
//    unpack per FMA on the same issue port).  It keeps the per-chunk
//    launches: on the dataflow route (one kernel for every kind, sized
//    for inner/inner: one CTA an SM) its tip/tip and tip/inner tiles ran
//    slower than in their per-chunk kernels.  No tensor cores: an mma or
//    wgmma product sums in another order, and the rescale decision (max
//    < 2^-E) would then flip on some sites, so scalers would differ from
//    the plain version.
// 8. The dataflow launch (every other instance).  At K = 2 a traversal
//    was 72 launches, most of them one CTA round of barrier set-up, copy
//    latency, FMAs and drain, and a wave could not start before the whole
//    wave before it had drained.  Yet a tile (entry, sites) depends only
//    on its inner children's tiles over the same sites.  So one launch of
//    persistent CTAs claims groups of tiles in table order from a global
//    counter; the producer waits for the inner children's tiles (those
//    with the slot's wait bit, fastpath.dataflow_table: written by an
//    earlier row of the table) through per (arena row, tile) ready flags,
//    int32 [rows][NT] beside the arena: acquire loads until each holds
//    this traversal's epoch, then fence.proxy.async.global, since the
//    writer's stores are generic-proxy and the reader's bulk copies
//    async-proxy.  After a group's last tile the consumer warps meet at a
//    named barrier and publish the group's flags with release stores of
//    the epoch.  The epoch is a per-engine counter (ops/newview_chunk.py
//    Ready), so flags never need clearing, only a reset when it wraps.
//    Why no deadlock: a tile waits only for tiles of earlier table rows,
//    so for tiles claimed before it; a CTA claims only while it is
//    resident, holds at most its current group and the next claim, and
//    completes its claims in order; its consumers never wait on its
//    producer's spin (a tile's copies are issued before the producer
//    moves on).  By induction over the claim order every claimed group
//    completes.  A claim past the end puts a sentinel into the stage and
//    the ring drains as in the per-chunk kernels.  Design points, each
//    measured against the per-chunk route on the card (chip_smoke.py):
//    a stage holds either tip case of both children (tip kinds mix in one
//    launch); a group is up to 2,048 sites (256 in the blocked body) and
//    8 tiles, and fewer in narrow rows, so that a row still has a group
//    for every CTA (one-entry rows chained one after the other move in
//    short steps);
//    at K <= 4 a tile is several 128-site units (about 8 KB of slab) with
//    one copy of slab, scalers and codes and one of P or the tip products
//    per partition, since the copy count of 128-site tiles (five copies
//    of mostly 64-512 bytes) held K = 2 at about 1 TB/s on both routes,
//    and a thread computes 8 values of one site (all rates at K = 2, two
//    at K = 4), since one thread per (site, rate) issued an instruction
//    stream per 2 values; the ring is as deep as shared memory allows
//    for two CTAs an SM (three for CTAs of at most 320 threads).
//
// The rescale rule and the scaler sum are B1's.  Within a per-chunk
// launch no entry reads a row the launch writes (the layout's promise,
// tested on the host); a table that writes a row twice or reads a row
// that the same or a later row writes is refused on the host
// (ops/newview_chunk.py check_launch, ops/fastpath.py dataflow_table).
// A barrier or flag wait that has not completed after ~2^34 clock cycles
// traps, so a protocol fault ends the launch with an error instead of
// hanging the card.
//
// Interface: plain C, loaded with ctypes, entry points per storage type
// (f32, f64, bf16) for each route.  Every device pointer and the stream
// arrive as void*; the per-chunk route takes the launch table as a host
// int32 [n][4] array (kind, base, slot, real), the dataflow route its
// table, wait bits, flags and counter on the card.  The functions launch
// on the given stream, do not synchronise, allocate nothing, count the
// launches they made in *launched and return the first CUDA error.

#include "newview_tile.cuh"

namespace {

// Programmatic dependent launch (point 4).
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void allow_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Geometry of an instance.  A tile is kTile consecutive sites of one
// 128-lane block; its consumers are threads_per_site threads a site (one
// per (site, rate) for K <= 4; R * H lanes over NS sites in the blocked
// body, K >= 16), plus one producer warp.  The blocked body takes a whole
// block per tile in f32 (16 consumer warps, one CTA per SM) and in
// bfloat16 storage (NS = 4: 8 consumer warps, so that a thread may have
// 224 registers), and a quarter block in f64 (one site a thread, 8
// consumer warps, 168 registers).  The per-chunk rings are as deep as
// shared memory allows for the kind (an f32 inner/inner stage is 96 KB);
// the dataflow ring holds either tip case in every stage.
template <typename S, typename T, int R, int K>
struct Geom {
  static constexpr int kTile = kBlocked<K> && sizeof(T) == 8 ? 32 : 128;
  static constexpr int kConsumers =
      kTile * threads_per_site<T, R, K, S>();
  static constexpr int kThreads = kConsumers + 32;       // + producer warp
  static constexpr int kMinBlocks = kBlocked<K> ? 1 : 2;
  template <int KIND>
  __host__ __device__ static constexpr int stages() {
    return !kBlocked<K> ? 3 : KIND == 2 ? 2 : KIND == 1 ? 3 : 4;
  }

  // The dataflow kernel (point 8).  A tile is kFlowUnits units of kTile
  // sites (each inside one block): a K <= 4 tile's slab is about 8 KB, so
  // that its few small copies (P, tip products, codes, scalers) are not
  // most of the copies.
  static constexpr int kUnitBytes = kTile * R * K * (int)sizeof(S);
  static constexpr int kFlowUnits =
      kBlocked<K> || kUnitBytes >= 8192 ? 1 : 8192 / kUnitBytes;
  // The most tiles of one group (2,048 sites for K <= 4, 256 in the
  // blocked body, and at most the 8 flags wait_tiles reads): the unit of
  // a claim and of a wait.
  static constexpr int kGroupSites = kBlocked<K> ? 256 : 2048;
  static constexpr int kGroupMax =
      kGroupSites / (kTile * kFlowUnits) < 8
          ? kGroupSites / (kTile * kFlowUnits)
          : 8;
  // The K <= 4 body: a thread holds kRT rates of one site, 8 values (16
  // bytes of a bfloat16 row); kTPS threads a site.
  static constexpr int kRT = kBlocked<K> ? 1 : (8 / K < R ? 8 / K : R);
  static constexpr int kTPS = R / kRT;
  static constexpr int kFlowConsumers =
      kBlocked<K> ? kConsumers : kFlowUnits * kTile * kTPS;
  static constexpr int kFlowThreads = kFlowConsumers + 32;
  static_assert(kFlowThreads <= 1024, "dataflow CTA size");
  // Resident CTAs an SM that the registers are sized for (three small
  // CTAs, two of 544 threads), and the ring: as many stages (at most 8)
  // as fit their shared memory (chosen per (L, C) by configure).
  static constexpr int kFlowMinBlocks =
      kBlocked<K> ? 1 : kFlowThreads <= 320 ? 3 : 2;
  static constexpr int kFlowMaxStages = 8;
};

// y[a] = sum_k P[a*K + k] * x[k] for one rate's K x K block.
template <typename T, int K>
__device__ __forceinline__ void apply_p(const T* p, const T (&x)[K],
                                        T (&y)[K]) {
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T row[K];
    load_vec<T, K>(p + a * K, row);
    T acc = row[0] * x[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = fma(row[k], x[k], acc);
    y[a] = acc;
  }
}

// v[a] *= sum_k P[a*K + k] * x[k]: the right child's product, multiplied
// into the left child's (the same FMA chain as apply_p).
template <typename T, int K>
__device__ __forceinline__ void apply_p_mul(const T* p, const T (&x)[K],
                                            T (&v)[K]) {
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T row[K];
    load_vec<T, K>(p + a * K, row);
    T acc = row[0] * x[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = fma(row[k], x[k], acc);
    v[a] *= acc;
  }
}

// [full barriers | empty barriers] (128 B) | stages of a tile of TL sites
// (the left child a tip for kinds 0 and 1, the right one for kind 0) |
// for the blocked body's tip/tip kind, a [TL][R][K] output buffer (the
// other kinds stage their output in the right child's slab).
template <typename S, typename T, int R, int K, int KIND>
__host__ __device__ Stage chunk_stage(int TL, int C) {
  return stage_layout<T, R, K, S>(KIND == 2 ? kInner : kTip,
                                  KIND >= 1 ? kInner : kTip, TL, C);
}

template <typename S, typename T, int R, int K, int KIND>
__host__ __device__ int smem_bytes(int TL, int C) {
  return 128 + Geom<S, T, R, K>::template stages<KIND>() *
                   chunk_stage<S, T, R, K, KIND>(TL, C).bytes +
         (kBlocked<K> && KIND == 0 ? align128(TL * R * K * (int)sizeof(S))
                                   : 0);
}

// S: the arena's storage type; T: the compute type of P, u and the sums.
template <typename S, typename T>
struct Operands {
  S* clv;                       // [rows, B, L, R, K]
  int32_t* scaler;              // [rows, B, L]
  const uint8_t* codes;         // [ntips, B, L]
  const T* u;                   // [P, 2, M, C, R, K] tip products
  const int32_t* block_part;    // [B]
  const int32_t* lidx;          // [P] packed per slot
  const int32_t* ridx;
  const int32_t* lcode;
  const int32_t* rcode;
  const T* pmat;                // [P, 2, M, R, K, K]
  int B, L, M, C;
  int TL, NT;                   // sites per tile (unit), tiles per entry
  int UT;                       // dataflow: units of TL sites per entry
  int opstride;                 // dataflow: bytes of one P / u slot
  int stages;                   // dataflow: ring stages
  Stage lay;                    // a ring stage's layout, for (TL, C, kind)
  T minlik, two_e;
};

// One side of a unit of a K <= 4 dataflow tile as site_tile reads it
// from the stage: a tip's codes and tip products u[code][r][a], or an
// inner child's slab, scaler slab and P[r][a][k], each pointer at the
// unit's first site or at its partition's slot.
template <typename S, typename T>
struct SmallSide {
  const uint8_t* codes;
  const T* op;
  const S* x;
  const int32_t* sc;
};

// The dataflow kernel's K <= 4 body on one unit of a staged tile: thread
// (site l, rate group g) computes the RT rates r0 = g*RT .. of site l,
// each output's FMA chain k = 0..K-1 as apply_p's, and the site's scaler
// increment (its max over its own values, then over the site's TPS lanes
// by __shfl_xor_sync), and stores RT*K contiguous values.  `release` runs
// once the thread's reads of the stage are done.
template <typename S, typename T, int R, int K, int RT, typename Release>
__device__ __forceinline__ void site_tile(const SmallSide<S, T>& ls,
                                          const SmallSide<S, T>& rs,
                                          bool ltip, bool rtip, int l,
                                          int r0, S* clv_out,
                                          int32_t* sc_out, T minlik,
                                          T two_e, Release release) {
  constexpr int N = RT * K;
  T v[N];
  int sc = 0;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const SmallSide<S, T>& sd = side == 0 ? ls : rs;
    T y[N];
    if (side == 0 ? ltip : rtip) {
      load_vec<T, N>(sd.op + ((int)sd.codes[l] * R + r0) * K, y);
    } else {
      T x[N];
      load_cvt<S, T, N>(sd.x + (l * R + r0) * K, x);
      sc += sd.sc[l];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
#pragma unroll
        for (int a = 0; a < K; ++a) {
          T row[K];
          load_vec<T, K>(sd.op + ((r0 + rr) * K + a) * K, row);
          T acc = row[0] * x[rr * K];
#pragma unroll
          for (int k = 1; k < K; ++k) acc = fma(row[k], x[rr * K + k], acc);
          y[rr * K + a] = acc;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = side == 0 ? y[i] : v[i] * y[i];
  }
  __syncwarp();
  release();
  T vmax = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T u = fabs(v[i]);
    vmax = u > vmax ? u : vmax;
  }
#pragma unroll
  for (int o = 1; o < R / RT; o <<= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, vmax, o);
    vmax = u > vmax ? u : vmax;
  }
  const bool needs = vmax < minlik;
  if (needs) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] *= two_e;
  }
  store_cvt<S, T, N>(clv_out + (l * R + r0) * K, v);
  if (r0 == 0) sc_out[l] = sc + (needs ? 1 : 0);
}

template <typename S, typename T, int R, int K, int KIND>
__global__ void __launch_bounds__((Geom<S, T, R, K>::kThreads),
                                  (Geom<S, T, R, K>::kMinBlocks))
    newview_chunk_kernel(const Operands<S, T> op, int base, int slot,
                         int real) {
  constexpr int PN = R * K * K;               // per-rate P, one partition
  constexpr int kStages = Geom<S, T, R, K>::template stages<KIND>();
  constexpr bool kLTip = KIND <= 1, kRTip = KIND == 0;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + 128;
  const int L = op.L, TL = op.TL, NT = op.NT;
  // The layout lives in the kernel's parameters, not in registers.
  const Stage& lay = op.lay;
  const int consumers = TL * threads_per_site<T, R, K, S>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // Set-up touches only constants, so it overlaps the previous launch.
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  wait_for_prior_grid();        // the previous launch's rows are written

  const size_t nsite = (size_t)op.B * L;      // sites per row
  const size_t UN = (size_t)op.C * R * K;     // tip products, one partition
  if (tid >= consumers) {
    // Producer warp: lane 0 keeps the ring full.
    const uint32_t tx = side_tx<T, R, K, S>(kLTip, TL, op.C) +
                        side_tx<T, R, K, S>(kRTip, TL, op.C);
    Tile tile(NT);
    for (int i = 0; tile.w < real; ++i, tile.advance(NT)) {
      if (lane == 0) {
        const int s = i % kStages;
        const int sl = slot + tile.w;
        const size_t site0 = (size_t)tile.b * TL;   // first site of the tile
        const int m = op.block_part[site0 / L];
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        unsigned char* st = ring + (size_t)s * lay.bytes;
        mbar_arrive_expect_tx(&full[s], tx);
        const int rows[2] = {kLTip ? op.lcode[sl] : op.lidx[sl],
                             kRTip ? op.rcode[sl] : op.ridx[sl]};
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const bool tip = side == 0 ? kLTip : kRTip;
          const size_t e = ((size_t)sl * 2 + side) * op.M + m;
          const size_t at = (size_t)rows[side] * nsite + site0;
          load_side<T, R, K, S>(st, lay.side[side], tip, op.codes + at,
                                op.u + e * UN, op.clv + at * R * K,
                                op.scaler + at, op.pmat + e * PN, TL, op.C,
                                &full[s]);
        }
      }
      __syncwarp();
    }
    allow_dependent_grid();     // every tile of this CTA is issued
  } else if constexpr (kBlocked<K>) {
    // The sizes are read from the parameters (the constant bank) in this
    // loop: held in registers beside the role, they made ptxas spill the
    // bfloat16 inner/inner instance at 168 registers.
    const Role ro = blocked_role<T, R, K, S>(tid);
    Tile tile(op.NT);
    for (int i = 0; tile.w < real; ++i) {
      const int s = i % kStages;
      const size_t out = (size_t)(base + tile.w) * op.B * op.L +
                         (size_t)tile.b * op.TL;
      tile.advance(op.NT);
      if (tile.w >= real) allow_dependent_grid();   // this CTA's last tile
      mbar_wait(&full[s], (i / kStages) & 1);
      unsigned char* st = ring + (size_t)s * lay.bytes;
      S* obuf = reinterpret_cast<S*>(
          KIND == 0 ? ring + (size_t)kStages * lay.bytes
                    : st + lay.side[1].x);
      blocked_tile<T, R, K, S>(st, lay, kLTip, kRTip, ro, op.TL, &empty[s],
                               obuf, op.clv + out * R * K, op.scaler + out,
                               op.minlik, op.two_e);
    }
  } else {
    // Consumer warps, K <= 4: thread (site l of the tile, rate r).
    const int l = tid / R, r = tid % R;
    Tile tile(NT);
    for (int i = 0; tile.w < real; ++i) {
      const int s = i % kStages;
      const int w = tile.w;
      const size_t site0 = (size_t)tile.b * TL;
      tile.advance(NT);
      if (tile.w >= real) allow_dependent_grid();   // this CTA's last tile
      mbar_wait(&full[s], (i / kStages) & 1);
      const unsigned char* st = ring + (size_t)s * lay.bytes;
      const Side& ls = lay.side[0];
      const Side& rs = lay.side[1];
      // v holds the left child's y, then y(left) * y(right): one child's K
      // values at a time besides it.
      T v[K];
      int sc = 0;
      if constexpr (kLTip) {
        load_vec<T, K>(reinterpret_cast<const T*>(st + ls.op) +
                           ((int)st[ls.sc + l] * R + r) * K, v);
      } else {
        T x[K];
        load_cvt<S, T, K>(reinterpret_cast<const S*>(st + ls.x) + tid * K,
                          x);
        sc += reinterpret_cast<const int32_t*>(st + ls.sc)[l];
        apply_p<T, K>(reinterpret_cast<const T*>(st + ls.op) + r * K * K, x,
                      v);
      }
      if constexpr (kRTip) {
        T y[K];
        load_vec<T, K>(reinterpret_cast<const T*>(st + rs.op) +
                           ((int)st[rs.sc + l] * R + r) * K, y);
#pragma unroll
        for (int a = 0; a < K; ++a) v[a] *= y[a];
      } else {
        T x[K];
        load_cvt<S, T, K>(reinterpret_cast<const S*>(st + rs.x) + tid * K,
                          x);
        sc += reinterpret_cast<const int32_t*>(st + rs.sc)[l];
        apply_p_mul<T, K>(reinterpret_cast<const T*>(st + rs.op) + r * K * K,
                          x, v);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with s

      T vmax = T(0);
#pragma unroll
      for (int a = 0; a < K; ++a) {
        const T u = fabs(v[a]);
        vmax = u > vmax ? u : vmax;
      }
#pragma unroll
      for (int o = 1; o < R; o <<= 1) {
        const T u = __shfl_xor_sync(0xffffffffu, vmax, o);
        vmax = u > vmax ? u : vmax;
      }
      const bool needs = vmax < op.minlik;
      if (needs) {
#pragma unroll
        for (int a = 0; a < K; ++a) v[a] *= op.two_e;
      }
      const size_t out = (size_t)(base + w) * nsite + site0;  // (row, site)
      store_cvt<S, T, K>(op.clv + (out * R + tid) * K, v);
      if (r == 0) op.scaler[out + l] = sc + (needs ? 1 : 0);
    }
  }
  __syncthreads();              // every stage consumed, every copy landed
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_inval(&full[s]);
      mbar_inval(&empty[s]);
    }
  }
}

// -- the dataflow launch (point 8) -----------------------------------------

// One launch-table row as the dataflow kernel reads it: kind, first arena
// row written, first packed slot, and the row's first entry in table
// order (the last row of the table holds the entry count).
struct FlowArgs {
  const int4* rows;             // [n + 1] (kind, base, slot, first entry)
  const int32_t* wait;          // [P] bit 0: left child waits, 1: right
  int32_t* flags;               // [arena rows][NT] ready flags
  int32_t* counter;             // groups claimed (0 at the launch)
  int n;                        // table rows
  int epoch;                    // this traversal's flag value
};

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Whether the n <= 8 flags from `f` all hold `epoch` (acquire loads; a
// group has at most 8 tiles, Geom::kGroupMax).
__device__ __forceinline__ bool tiles_ready(const int32_t* f, int n,
                                            int epoch) {
  int v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < n ? ld_acquire(f + j) : epoch;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) ok = ok && v[j] == epoch;
  return ok;
}

// Wait until the n flags from `f` hold `epoch`, with a backoff and the same
// ~2^34-cycle trap as mbar_wait.
__device__ __forceinline__ void wait_tiles(const int32_t* f, int n,
                                           int epoch) {
  if (tiles_ready(f, n, epoch)) return;
  const long long t0 = clock64();
  unsigned ns = 32;
  while (!tiles_ready(f, n, epoch)) {
    __nanosleep(ns);
    if (ns < 512) ns *= 2;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Tiles of a group in a table row of `real` entries: the most that still
// leaves the row at least as many groups as the grid has CTAs (narrow rows
// take small groups, so that a chain of one-entry rows, each waiting on
// the one before, moves in short steps).
__device__ __forceinline__ int group_tiles(int real, int NT, int gmax) {
  int g = gmax;
  while (g > 1 && (long long)real * NT < (long long)g * gridDim.x) g >>= 1;
  return g;
}

// Named barrier 1 over the consumer warps (the producer warp keeps on).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// A dataflow stage: each side holds either case for a tile of NU units
// of TL sites: the slab [NU*TL][R][K] of S (inner), the scaler slab or
// the codes [NU*TL], and NU slots of `opstride` bytes for P or the tip
// products, one per unit whose partition differs from its predecessor's.
template <typename S, typename T, int R, int K>
__host__ __device__ Stage flow_stage(int TL, int C, int* opstride) {
  constexpr int NU = Geom<S, T, R, K>::kFlowUnits;
  const int u = C * R * K * (int)sizeof(T);
  const int p = p_span<T, R, K>();
  *opstride = align128(u > p ? u : p);
  Stage st{};
  int off = 0;
  for (int i = 0; i < 2; ++i) {
    st.side[i].x = off;
    off += align128(NU * TL * R * K * (int)sizeof(S));
    st.side[i].sc = off;
    off += align128(4 * NU * TL);
    st.side[i].op = off;
    off += NU * *opstride;
  }
  st.bytes = off;
  return st;
}

// One launch for a whole launch table.  Persistent CTAs claim groups of
// tiles in table order from a global counter (a group is up to kGroupMax
// consecutive tiles of one entry, group_tiles by the row's width), the
// next claim issued while the current group's last tile is staged.  A
// tile is NU consecutive units of TL sites (each inside one 128-lane
// block).  The producer lane walks the table's rows to decode (row,
// entry, group), waits for each inner child whose wait bit is set until
// that child's flags over the group's tiles hold this traversal's epoch
// (acquire loads), fences the async proxy (the child's rows were written
// with ordinary stores, the bulk copies read them through the async
// proxy) and stages the group's tiles: per side
// one copy of the slab and one of the scaler slab (inner) or of the codes
// (tip), and P or the tip products once per unit whose partition differs
// from its predecessor's.  A tile's kind, output row, tile index, units
// and slot map travel to the consumers in the stage's meta slots, and on
// a group's last tile its first tile: after their stores of that tile the
// consumer warps meet at named barrier 1 and threads 0.. publish the
// group's flags with release stores of the epoch (a CTA stores a group's
// tiles in order, so the flags cover all of them).  A claim past the end
// puts a sentinel (kind -1) into the stage: the consumers leave and the
// ring drains.
template <typename S, typename T, int R, int K>
__global__ void __launch_bounds__((Geom<S, T, R, K>::kFlowThreads),
                                  (Geom<S, T, R, K>::kFlowMinBlocks))
    newview_flow_kernel(const Operands<S, T> op, const FlowArgs fa) {
  using G = Geom<S, T, R, K>;
  constexpr int PN = R * K * K;               // per-rate P, one partition
  constexpr int NU = G::kFlowUnits;
  static_assert(2 * G::kFlowMaxStages * 8 <= 128 &&
                    G::kFlowMaxStages * 32 <= 256 && NU <= 8 &&
                    G::kGroupMax <= 8,
                "flow header, slot map and group size");
  const int stages = op.stages;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  int4* meta = reinterpret_cast<int4*>(smem + 128);   // 2 per stage
  unsigned char* ring = smem + 384;
  const int L = op.L, TL = op.TL, NT = op.NT;
  const Stage& lay = op.lay;
  const int consumers = kBlocked<K> ? TL * threads_per_site<T, R, K, S>()
                                    : NU * TL * G::kTPS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const size_t nsite = (size_t)op.B * L;      // sites per row
  const size_t UN = (size_t)op.C * R * K;     // tip products, one partition
  if (tid >= consumers) {
    if (lane == 0) {
      // The table row of the claim: its fields, group size, groups per
      // entry, and its first and its end group.
      int cur = -1, gt = 1, ng = 1, gfirst = 0, gend = 0;
      int4 row = make_int4(0, 0, 0, 0);
      int i = 0;                              // tiles staged
      int q = atomicAdd(fa.counter, 1);
      for (;;) {
        while (q >= gend && cur < fa.n) {
          if (++cur == fa.n) break;
          row = fa.rows[cur];
          const int real = fa.rows[cur + 1].w - row.w;
          gt = group_tiles(real, NT, G::kGroupMax);
          ng = (NT + gt - 1) / gt;
          gfirst = gend;
          gend = gfirst + real * ng;
        }
        if (cur == fa.n) {
          const int s = i % stages;
          if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
          meta[2 * s] = make_int4(-1, 0, 0, 0);
          mbar_arrive(&full[s]);
          break;
        }
        const int w = (q - gfirst) / ng, g = q - gfirst - w * ng;
        const int sl = row.z + w;
        const bool tip[2] = {row.x <= 1, row.x == 0};
        const int rows[2] = {tip[0] ? op.lcode[sl] : op.lidx[sl],
                             tip[1] ? op.rcode[sl] : op.ridx[sl]};
        const int b0 = g * gt;
        const int b1 = b0 + gt < NT ? b0 + gt : NT;
        const int wt = fa.wait[sl];
        if (wt) {
          if (wt & 1) wait_tiles(fa.flags + (size_t)rows[0] * NT + b0,
                                 b1 - b0, fa.epoch);
          if (wt & 2) wait_tiles(fa.flags + (size_t)rows[1] * NT + b0,
                                 b1 - b0, fa.epoch);
          asm volatile("fence.proxy.async.global;" ::: "memory");
        }
        int qn = 0;
        for (int b = b0; b < b1; ++b, ++i) {
          const bool last = b == b1 - 1;
          if (last) qn = atomicAdd(fa.counter, 1);   // the next claim
          const int s = i % stages;
          const int u0 = b * NU;
          const int nu = NU < op.UT - u0 ? NU : op.UT - u0;
          const size_t site0 = (size_t)u0 * TL;  // first site of the tile
          // Each unit's partition, and the P / u slot it reads: a new
          // slot where the partition changes.
          int ms[NU], pmap = 0, slots = 0;
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            if (j < nu) {
              ms[j] = op.block_part[(site0 + (size_t)j * TL) / L];
              if (j == 0 || ms[j] != ms[j - 1]) ++slots;
              pmap |= (slots - 1) << (4 * j);
            }
          }
          uint32_t tx = 0;
#pragma unroll
          for (int side = 0; side < 2; ++side)
            tx += tip[side] ? nu * TL + slots * UN * sizeof(T)
                            : nu * TL * (R * K * sizeof(S) + 4) +
                                  slots * PN * sizeof(T);
          if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
          meta[2 * s] = make_int4(row.x, row.y + w, b, last ? b0 : -1);
          meta[2 * s + 1] = make_int4(nu, pmap, 0, 0);
          unsigned char* st = ring + (size_t)s * lay.bytes;
          mbar_arrive_expect_tx(&full[s], tx);
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const Side& sd = lay.side[side];
            const size_t at = (size_t)rows[side] * nsite + site0;
            if (tip[side]) {
              bulk_load(st + sd.sc, op.codes + at, nu * TL, &full[s]);
            } else {
              bulk_load(st + sd.x, op.clv + at * R * K,
                        nu * TL * R * K * sizeof(S), &full[s]);
              bulk_load(st + sd.sc, op.scaler + at, 4 * nu * TL, &full[s]);
            }
#pragma unroll
            for (int j = 0; j < NU; ++j) {
              if (j >= nu || (j > 0 && ms[j] == ms[j - 1])) continue;
              const size_t e2 = ((size_t)sl * 2 + side) * op.M + ms[j];
              unsigned char* dst =
                  st + sd.op + ((pmap >> (4 * j)) & 15) * op.opstride;
              if (tip[side]) {
                bulk_load(dst, op.u + e2 * UN, UN * sizeof(T), &full[s]);
              } else if constexpr (kBlocked<K>) {
#pragma unroll
                for (int r = 0; r < R; ++r)
                  bulk_load(dst + p_rate_offset<T, R, K>(r),
                            op.pmat + e2 * PN + r * K * K,
                            K * K * sizeof(T), &full[s]);
              } else {
                bulk_load(dst, op.pmat + e2 * PN, PN * sizeof(T), &full[s]);
              }
            }
          }
        }
        q = qn;
      }
    }
    __syncwarp();
  } else {
    for (int i = 0;; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const int4 mt = meta[2 * s];
      if (mt.x < 0) break;
      const bool ltip = mt.x <= 1, rtip = mt.x == 0;
      unsigned char* st = ring + (size_t)s * lay.bytes;
      const size_t out = (size_t)mt.y * nsite + (size_t)mt.z * NU * TL;
      if constexpr (kBlocked<K>) {
        // The output goes through the right child's x area: its slab (each
        // warp overwrites only the rows it has read) or, for a tip, an
        // area the copies left empty.
        blocked_tile<T, R, K, S>(
            st, lay, ltip, rtip, blocked_role<T, R, K, S>(tid), TL,
            &empty[s],
            reinterpret_cast<S*>(st + lay.side[1].x), op.clv + out * R * K,
            op.scaler + out, op.minlik, op.two_e);
      } else {
        // Thread (unit j, site l, rate group g); a warp lies in one unit,
        // and the warps of units past the tile's only release the stage.
        const int4 m2 = meta[2 * s + 1];      // units, slot map
        const int j = tid / (TL * G::kTPS), p = tid - j * TL * G::kTPS;
        if (j < m2.x) {
          SmallSide<S, T> sd[2];
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const Side& d = lay.side[side];
            sd[side] = {st + d.sc + j * TL,
                        reinterpret_cast<const T*>(
                            st + d.op + ((m2.y >> (4 * j)) & 15) *
                                            op.opstride),
                        reinterpret_cast<const S*>(st + d.x) + j * TL * R * K,
                        reinterpret_cast<const int32_t*>(st + d.sc) +
                            j * TL};
          }
          const size_t o = out + (size_t)j * TL;
          site_tile<S, T, R, K, G::kRT>(
              sd[0], sd[1], ltip, rtip, p / G::kTPS,
              (p % G::kTPS) * G::kRT, op.clv + o * R * K, op.scaler + o,
              op.minlik, op.two_e, [&] {
                if (lane == 0) mbar_arrive(&empty[s]);
              });
        } else if (lane == 0) {
          mbar_arrive(&empty[s]);
        }
      }
      if (mt.w >= 0) {
        consumers_sync(consumers);        // every warp's stores are done
        if (tid <= mt.z - mt.w)
          st_release(fa.flags + (size_t)mt.y * NT + mt.w + tid, fa.epoch);
      }
    }
  }
  __syncthreads();              // every stage consumed, every copy landed
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_inval(&full[s]);
      mbar_inval(&empty[s]);
    }
  }
}

// Per-instance launch configuration: the tile (sites TL <= the lane width
// L, dividing it), dynamic shared memory, threads and resident CTAs per
// SM for (device, L, C), cached across calls (the shared-memory attribute
// is set per device).  KIND 0..2 is a per-chunk kernel, KIND 3 the
// dataflow kernel.  A configuration whose shared memory exceeds what a
// block may opt into on this device is refused before any launch.
struct Config {
  int dev = -1, L = -1, C = -1, tile = 0, stages = 0, smem = 0,
      threads = 0, per_sm = 0, sms = 0, units = 1;
};

constexpr int kFlow = 3;

template <typename S, typename T, int R, int K, int KIND>
cudaError_t configure(int L, int C, Config& cfg) {
  static Config cached;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cached.dev == dev && cached.L == L && cached.C == C) {
    cfg = cached;
    return cudaSuccess;
  }
  using G = Geom<S, T, R, K>;
  const int TL = L < G::kTile ? L : G::kTile;
  if (TL < 16 || TL % 16 || L % TL ||
      TL * threads_per_site<T, R, K, S>() % 32 || C < 1 ||
      (KIND == kFlow && TL * G::kTPS % 32))
    return cudaErrorInvalidValue;
  Config c;
  c.dev = dev;
  c.L = L;
  c.C = C;
  c.tile = TL;
  c.threads = KIND == kFlow && !kBlocked<K>
                  ? G::kFlowUnits * TL * G::kTPS + 32
                  : TL * threads_per_site<T, R, K, S>() + 32;
  const void* kern;
  int optin = 0;
  err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if constexpr (KIND == kFlow) {
    int opstride = 0;
    const int stage = flow_stage<S, T, R, K>(TL, C, &opstride).bytes;
    // 1 KB of an SM's shared memory is reserved per resident CTA; where
    // two stages do not fit kFlowMinBlocks CTAs, one CTA takes it all.
    int budget = (optin + 1024) / G::kFlowMinBlocks - 1024 - 384;
    if (budget < 2 * stage) budget = optin - 384;
    c.stages = budget / stage < G::kFlowMaxStages ? budget / stage
                                                  : G::kFlowMaxStages;
    if (c.stages < 2) return cudaErrorInvalidConfiguration;
    c.units = G::kFlowUnits;
    c.smem = 384 + c.stages * stage;
    kern = reinterpret_cast<const void*>(newview_flow_kernel<S, T, R, K>);
  } else {
    c.stages = G::template stages<KIND>();
    c.smem = smem_bytes<S, T, R, K, KIND>(TL, C);
    kern = reinterpret_cast<const void*>(
        newview_chunk_kernel<S, T, R, K, KIND>);
  }
  if (c.smem > optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             c.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kern,
                                                        c.threads, c.smem);
  if (err != cudaSuccess) return err;
  if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
  cached = c;
  cfg = c;
  return cudaSuccess;
}

template <typename S, typename T, int R, int K, int KIND>
cudaError_t launch_one(Operands<S, T> op, int base, int slot, int real,
                       bool dependent, cudaStream_t stream) {
  Config c;
  cudaError_t err = configure<S, T, R, K, KIND>(op.L, op.C, c);
  if (err != cudaSuccess) return err;
  op.TL = c.tile;
  op.NT = op.B * (op.L / c.tile);
  op.lay = chunk_stage<S, T, R, K, KIND>(c.tile, op.C);
  const long long tiles = (long long)real * op.NT;
  const long long resident = (long long)c.per_sm * c.sms;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)(tiles < resident ? tiles : resident));
  lc.blockDim = dim3(c.threads);
  lc.dynamicSmemBytes = c.smem;
  lc.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  lc.attrs = attr;
  lc.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&lc, newview_chunk_kernel<S, T, R, K, KIND>,
                            op, base, slot, real);
}

// The dataflow launch of a whole table: the claim counter zeroed on the
// stream, then one persistent grid of the resident CTAs.  `flag_nt` is
// the flags' row length, which must be this instance's tiles per entry.
template <typename S, typename T, int R, int K>
int launch_flow(Operands<S, T> op, FlowArgs fa, int entries, int flag_nt,
                cudaStream_t stream, int* launched) {
  Config c;
  cudaError_t err = configure<S, T, R, K, kFlow>(op.L, op.C, c);
  if (err != cudaSuccess) return (int)err;
  constexpr int NU = Geom<S, T, R, K>::kFlowUnits;
  op.TL = c.tile;
  op.UT = op.B * (op.L / c.tile);
  op.NT = (op.UT + NU - 1) / NU;
  op.lay = flow_stage<S, T, R, K>(c.tile, op.C, &op.opstride);
  op.stages = c.stages;
  const long long resident = (long long)c.per_sm * c.sms;
  if (fa.n < 1 || entries < 1 || flag_nt != op.NT ||
      (long long)entries * op.NT + 2 * resident >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(fa.counter, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)resident);
  lc.blockDim = dim3(c.threads);
  lc.dynamicSmemBytes = c.smem;
  lc.stream = stream;
  err = cudaLaunchKernelEx(&lc, newview_flow_kernel<S, T, R, K>, op, fa);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return (int)cudaSuccess;
}

template <typename S, typename T, int R, int K>
int launch_all(const Operands<S, T>& op, const int32_t* launch, int n,
               cudaStream_t stream, int* launched) {
  for (int i = 0; i < n; ++i) {
    const int kind = launch[4 * i], base = launch[4 * i + 1];
    const int slot = launch[4 * i + 2], real = launch[4 * i + 3];
    if (real < 1) return (int)cudaErrorInvalidValue;
    const bool dep = i > 0;
    cudaError_t err;
    switch (kind) {
      case 0:
        err = launch_one<S, T, R, K, 0>(op, base, slot, real, dep,
                                          stream);
        break;
      case 1:
        err = launch_one<S, T, R, K, 1>(op, base, slot, real, dep,
                                          stream);
        break;
      case 2:
        err = launch_one<S, T, R, K, 2>(op, base, slot, real, dep,
                                          stream);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

template <typename S, typename T>
Operands<S, T> operands(void* clv, void* scaler, const void* codes,
                        const void* u, const void* block_part,
                        const void* lidx, const void* ridx, const void* lcode,
                        const void* rcode, const void* pmat, int B, int L,
                        int M, int C, double minlik, double two_e) {
  Operands<S, T> op;
  op.clv = static_cast<S*>(clv);
  op.scaler = static_cast<int32_t*>(scaler);
  op.codes = static_cast<const uint8_t*>(codes);
  op.u = static_cast<const T*>(u);
  op.block_part = static_cast<const int32_t*>(block_part);
  op.lidx = static_cast<const int32_t*>(lidx);
  op.ridx = static_cast<const int32_t*>(ridx);
  op.lcode = static_cast<const int32_t*>(lcode);
  op.rcode = static_cast<const int32_t*>(rcode);
  op.pmat = static_cast<const T*>(pmat);
  op.B = B;
  op.L = L;
  op.M = M;
  op.C = C;
  op.minlik = static_cast<T>(minlik);
  op.two_e = static_cast<T>(two_e);
  op.TL = op.NT = op.UT = op.opstride = op.stages = 0;   // by the launch
  return op;
}

template <typename S, typename T>
int dispatch(void* clv, void* scaler, const void* codes, const void* u,
             const void* block_part, const void* lidx, const void* ridx,
             const void* lcode, const void* rcode, const void* pmat,
             const void* launch, int n, int B, int L, int M, int C, int R,
             int K, double minlik, double two_e, void* stream,
             int* launched) {
  *launched = 0;
  const Operands<S, T> op =
      operands<S, T>(clv, scaler, codes, u, block_part, lidx, ridx, lcode,
                     rcode, pmat, B, L, M, C, minlik, two_e);
  const int32_t* rows = static_cast<const int32_t*>(launch);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R == 4 && K == 2)
    return launch_all<S, T, 4, 2>(op, rows, n, st, launched);
  if (R == 4 && K == 4)
    return launch_all<S, T, 4, 4>(op, rows, n, st, launched);
  if (R == 4 && K == 20)
    return launch_all<S, T, 4, 20>(op, rows, n, st, launched);
  return (int)cudaErrorInvalidValue;
}

template <typename S, typename T>
int dispatch_flow(void* clv, void* scaler, const void* codes, const void* u,
                  const void* block_part, const void* lidx, const void* ridx,
                  const void* lcode, const void* rcode, const void* pmat,
                  const void* rows, const void* wait, void* flags,
                  void* counter, int n, int entries, int flag_nt,
                  int epoch, int B, int L, int M, int C, int R, int K,
                  double minlik, double two_e, void* stream,
                  int* launched) {
  *launched = 0;
  const Operands<S, T> op =
      operands<S, T>(clv, scaler, codes, u, block_part, lidx, ridx, lcode,
                     rcode, pmat, B, L, M, C, minlik, two_e);
  FlowArgs fa;
  fa.rows = static_cast<const int4*>(rows);
  fa.wait = static_cast<const int32_t*>(wait);
  fa.flags = static_cast<int32_t*>(flags);
  fa.counter = static_cast<int32_t*>(counter);
  fa.n = n;
  fa.epoch = epoch;
  if (epoch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R == 4 && K == 2)
    return launch_flow<S, T, 4, 2>(op, fa, entries, flag_nt, st, launched);
  if (R == 4 && K == 4)
    return launch_flow<S, T, 4, 4>(op, fa, entries, flag_nt, st, launched);
  if (R == 4 && K == 20)
    return launch_flow<S, T, 4, 20>(op, fa, entries, flag_nt, st, launched);
  return (int)cudaErrorInvalidValue;
}

template <typename S, typename T, int R, int K>
cudaError_t config_rk(int kind, int L, int C, Config& c) {
  switch (kind) {
    case 0: return configure<S, T, R, K, 0>(L, C, c);
    case 1: return configure<S, T, R, K, 1>(L, C, c);
    case 2: return configure<S, T, R, K, 2>(L, C, c);
    case kFlow: return configure<S, T, R, K, kFlow>(L, C, c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename S, typename T>
int config_of(int R, int K, int kind, int L, int C, int* out) {
  Config c;
  cudaError_t err = cudaErrorInvalidValue;
  if (R == 4 && K == 2) err = config_rk<S, T, 4, 2>(kind, L, C, c);
  if (R == 4 && K == 4) err = config_rk<S, T, 4, 4>(kind, L, C, c);
  if (R == 4 && K == 20) err = config_rk<S, T, 4, 20>(kind, L, C, c);
  out[0] = c.smem;
  out[1] = c.threads;
  out[2] = c.per_sm;
  out[3] = c.sms;
  out[4] = c.tile;
  out[5] = c.stages;
  out[6] = c.units;
  return (int)err;
}

}  // namespace

extern "C" {

int examl_newview_chunks_f32(void* clv, void* scaler, const void* codes,
                             const void* u, const void* block_part,
                             const void* lidx, const void* ridx,
                             const void* lcode, const void* rcode,
                             const void* pmat, const void* launch, int n,
                             int B, int L, int M, int C, int R, int K,
                             double minlik, double two_e, void* stream,
                             int* launched) {
  return dispatch<float, float>(clv, scaler, codes, u, block_part, lidx,
                                ridx, lcode, rcode, pmat, launch, n, B, L,
                                M, C, R, K, minlik, two_e, stream, launched);
}

int examl_newview_chunks_f64(void* clv, void* scaler, const void* codes,
                             const void* u, const void* block_part,
                             const void* lidx, const void* ridx,
                             const void* lcode, const void* rcode,
                             const void* pmat, const void* launch, int n,
                             int B, int L, int M, int C, int R, int K,
                             double minlik, double two_e, void* stream,
                             int* launched) {
  return dispatch<double, double>(clv, scaler, codes, u, block_part, lidx,
                                  ridx, lcode, rcode, pmat, launch, n, B, L,
                                  M, C, R, K, minlik, two_e, stream,
                                  launched);
}

// A bfloat16 arena with float32 u, P and arithmetic (point 7).
int examl_newview_chunks_bf16(void* clv, void* scaler, const void* codes,
                              const void* u, const void* block_part,
                              const void* lidx, const void* ridx,
                              const void* lcode, const void* rcode,
                              const void* pmat, const void* launch, int n,
                              int B, int L, int M, int C, int R, int K,
                              double minlik, double two_e, void* stream,
                              int* launched) {
  return dispatch<__nv_bfloat16, float>(
      clv, scaler, codes, u, block_part, lidx, ridx, lcode, rcode, pmat,
      launch, n, B, L, M, C, R, K, minlik, two_e, stream, launched);
}

// The dataflow launch of a whole launch table (point 8), one entry point
// per storage type: `rows` [n + 1][4] and `wait` [P] int32 on the card,
// `flags` [arena rows][flag_nt] int32, `counter` one int32 (zeroed here on
// the stream), n the table's rows and `entries` its entry count, `epoch`
// >= 1 the traversal's flag value.
int examl_newview_flow_f32(void* clv, void* scaler, const void* codes,
                            const void* u, const void* block_part,
                            const void* lidx, const void* ridx,
                            const void* lcode, const void* rcode,
                            const void* pmat, const void* rows,
                            const void* wait, void* flags, void* counter,
                            int n, int entries, int flag_nt, int epoch,
                            int B, int L, int M, int C, int R, int K,
                            double minlik, double two_e, void* stream,
                            int* launched) {
  return dispatch_flow<float, float>(
      clv, scaler, codes, u, block_part, lidx, ridx, lcode, rcode, pmat,
      rows, wait, flags, counter, n, entries, flag_nt, epoch, B, L, M, C, R,
      K, minlik, two_e, stream, launched);
}

int examl_newview_flow_f64(void* clv, void* scaler, const void* codes,
                            const void* u, const void* block_part,
                            const void* lidx, const void* ridx,
                            const void* lcode, const void* rcode,
                            const void* pmat, const void* rows,
                            const void* wait, void* flags, void* counter,
                            int n, int entries, int flag_nt, int epoch,
                            int B, int L, int M, int C, int R, int K,
                            double minlik, double two_e, void* stream,
                            int* launched) {
  return dispatch_flow<double, double>(
      clv, scaler, codes, u, block_part, lidx, ridx, lcode, rcode, pmat,
      rows, wait, flags, counter, n, entries, flag_nt, epoch, B, L, M, C, R,
      K, minlik, two_e, stream, launched);
}

int examl_newview_flow_bf16(void* clv, void* scaler, const void* codes,
                            const void* u, const void* block_part,
                            const void* lidx, const void* ridx,
                            const void* lcode, const void* rcode,
                            const void* pmat, const void* rows,
                            const void* wait, void* flags, void* counter,
                            int n, int entries, int flag_nt, int epoch,
                            int B, int L, int M, int C, int R, int K,
                            double minlik, double two_e, void* stream,
                            int* launched) {
  return dispatch_flow<__nv_bfloat16, float>(
      clv, scaler, codes, u, block_part, lidx, ridx, lcode, rcode, pmat,
      rows, wait, flags, counter, n, entries, flag_nt, epoch, B, L, M, C, R,
      K, minlik, two_e, stream, launched);
}

// The launch configuration of one instance (storage 0 = f32, 1 = f64, 2 =
// bf16 under f32; R rates, K states, kind 0..2 per chunk, 3 the dataflow
// kernel) for lane width L and C tip codes: out = {dynamic shared memory
// bytes, threads per CTA, resident CTAs per SM, SMs, sites per tile, ring
// stages, units of tile sites in a dataflow tile (1 per chunk)}.
int examl_newview_chunk_config(int storage, int R, int K, int kind, int L,
                               int C, int* out) {
  switch (storage) {
    case 0: return config_of<float, float>(R, K, kind, L, C, out);
    case 1: return config_of<double, double>(R, K, kind, L, C, out);
    case 2: return config_of<__nv_bfloat16, float>(R, K, kind, L, C, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* examl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
