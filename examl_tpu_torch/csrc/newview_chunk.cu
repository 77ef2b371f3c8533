// Newview chunk kernel (B1) for Hopper, sm_90a.
//
// Replaces examl_tpu/ops/pallas_newview.py::_chunk_kernel (launched there
// by _run_chunk, driven by chunk_applier).  One host call runs a full
// traversal's launch table (examl_tpu_torch/ops/fastpath.py): one launch
// per chunk with real entries, in order.  A launch applies `real`
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
//    rescale (__float2bfloat16_rn, as torch's and JAX's casts round).  The
//    geometry (tile, consumers, stages) is the float32 instance's; a slab
//    is half as many bytes, so a stage is smaller and the ring holds the
//    same depth in less shared memory.  Bound: bytes, as for float32,
//    with 2-byte rows (a real-size DNA traversal moves 4.87 GB instead of
//    9.14: 36 instead of 68 bytes per site and row, 1.45 ms).  Measured
//    (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 21, in turns
//    with float32 on one layout): K = 4 2.45 ms against 3.49, K = 20
//    3.51 against 4.42 (bound 1.64 ms: at half the bytes the FMAs set
//    the pace), K = 2 0.60 against 0.69 (launch-bound).
//
// The rescale rule and the scaler sum are B1's.  Within a launch no entry
// reads a row the launch writes (the layout's promise, tested on the
// host).  A barrier wait that has not completed after ~2^34 clock cycles
// traps, so a protocol fault ends the launch with an error instead of
// hanging the card.
//
// Interface: plain C, loaded with ctypes, one entry point per storage
// type (f32, f64, bf16).  Every device pointer and the stream arrive as
// void*, the launch table as a host int32 [n][4] array
// (kind, base, slot, real).  The function launches on the given stream,
// does not synchronise, allocates nothing, counts the launches it made in
// *launched and returns the first CUDA error.

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
// block per tile in f32 (16 consumer warps, one CTA per SM) and a quarter
// block in f64 (one site a thread, 8 consumer warps, so that a thread may
// have 168 registers).  Its rings are as deep as shared memory allows for
// the kind (an inner/inner stage is 96 KB in f32).
template <typename T, int R, int K>
struct Geom {
  static constexpr int kTile = kBlocked<K> && sizeof(T) == 8 ? 32 : 128;
  static constexpr int kConsumers = kTile * threads_per_site<T, R, K>();
  static constexpr int kThreads = kConsumers + 32;       // + producer warp
  static constexpr int kMinBlocks = kBlocked<K> ? 1 : 2;
  template <int KIND>
  __host__ __device__ static constexpr int stages() {
    return !kBlocked<K> ? 3 : KIND == 2 ? 2 : KIND == 1 ? 3 : 4;
  }
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
  return 128 + Geom<T, R, K>::template stages<KIND>() *
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
  int TL, NT;                   // sites per tile, tiles per entry
  Stage lay;                    // a ring stage's layout, for (TL, C, kind)
  T minlik, two_e;
};

template <typename S, typename T, int R, int K, int KIND>
__global__ void __launch_bounds__((Geom<T, R, K>::kThreads),
                                  (Geom<T, R, K>::kMinBlocks))
    newview_chunk_kernel(const Operands<S, T> op, int base, int slot,
                         int real) {
  constexpr int PN = R * K * K;               // per-rate P, one partition
  constexpr int kStages = Geom<T, R, K>::template stages<KIND>();
  constexpr bool kLTip = KIND <= 1, kRTip = KIND == 0;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + 128;
  const int L = op.L, TL = op.TL, NT = op.NT;
  // The layout lives in the kernel's parameters, not in registers.
  const Stage& lay = op.lay;
  const int consumers = TL * threads_per_site<T, R, K>();
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
    const Role ro = blocked_role<T, R, K>(tid);
    Tile tile(NT);
    for (int i = 0; tile.w < real; ++i) {
      const int s = i % kStages;
      const size_t out = (size_t)(base + tile.w) * nsite +
                         (size_t)tile.b * TL;
      tile.advance(NT);
      if (tile.w >= real) allow_dependent_grid();   // this CTA's last tile
      mbar_wait(&full[s], (i / kStages) & 1);
      unsigned char* st = ring + (size_t)s * lay.bytes;
      S* obuf = reinterpret_cast<S*>(
          KIND == 0 ? ring + (size_t)kStages * lay.bytes
                    : st + lay.side[1].x);
      blocked_tile<T, R, K, S>(st, lay, kLTip, kRTip, ro, TL, &empty[s],
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

// Per-instance launch configuration: the tile (sites TL <= the lane width
// L, dividing it), dynamic shared memory, threads and resident CTAs per
// SM for (device, L, C), cached across calls (the shared-memory attribute
// is set per device).  A configuration whose shared memory exceeds what a
// block may opt into on this device is refused before any launch.
struct Config {
  int dev = -1, L = -1, C = -1, tile = 0, stages = 0, smem = 0,
      threads = 0, per_sm = 0, sms = 0;
};

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
  constexpr int kTile = Geom<T, R, K>::kTile;
  const int TL = L < kTile ? L : kTile;
  if (TL < 16 || TL % 16 || L % TL ||
      TL * threads_per_site<T, R, K>() % 32 || C < 1)
    return cudaErrorInvalidValue;
  Config c;
  c.dev = dev;
  c.L = L;
  c.C = C;
  c.tile = TL;
  c.stages = Geom<T, R, K>::template stages<KIND>();
  c.smem = smem_bytes<S, T, R, K, KIND>(TL, C);
  c.threads = TL * threads_per_site<T, R, K>() + 32;
  int optin = 0;
  auto kern = newview_chunk_kernel<S, T, R, K, KIND>;
  err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
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
int dispatch(void* clv, void* scaler, const void* codes, const void* u,
             const void* block_part, const void* lidx, const void* ridx,
             const void* lcode, const void* rcode, const void* pmat,
             const void* launch, int n, int B, int L, int M, int C, int R,
             int K, double minlik, double two_e, void* stream,
             int* launched) {
  *launched = 0;
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
  op.TL = op.NT = 0;            // set per instance by launch_one
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

template <typename S, typename T, int R, int K>
cudaError_t config_rk(int kind, int L, int C, Config& c) {
  switch (kind) {
    case 0: return configure<S, T, R, K, 0>(L, C, c);
    case 1: return configure<S, T, R, K, 1>(L, C, c);
    case 2: return configure<S, T, R, K, 2>(L, C, c);
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

// The launch configuration of one instance (storage 0 = f32, 1 = f64, 2 =
// bf16 under f32; R rates, K states, kind) for lane width L and C tip
// codes: out = {dynamic shared memory bytes, threads per CTA, resident
// CTAs per SM, SMs, sites per tile, ring stages}.
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
