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
//   child:  x[r][k] = table[code][k] for a tip (the same for every rate r),
//           or the child's arena row for an inner node
//   y[r][a] = sum_k P[slot + w][side][part(b)][r][a][k] * x[r][k]
//   v = yl * yr;  where max|v| < 2^-E:  v *= 2^E and the scaler adds 1;
//   scaler = scaler(left) + scaler(right) + that increment.
//
// Bound.  Memory bandwidth.  Per site an entry reads two child rows
// (R*K values, 64 B in f32 for DNA) or a 1-byte code per tip child, plus
// the children's int32 scalers, and writes one row and one scaler,
// against at most 2*R*K*K FMAs: for DNA 128, about one FMA per byte, 1/60
// of the card's f32 balance, so tensor cores buy nothing.  A real-size
// DNA traversal (512 taxa x 131,072 patterns, f32) needs 9.14 GB: 2.73 ms
// at 3.35 TB/s.  At K = 20 an inner/inner entry costs 3,200 FMAs per
// site against about 970 B, 6.6 flops per byte against the card's f32
// balance of 20 (67e12 / 3.35e12): still bound by bytes, the operations
// taking about half the bytes' time over a traversal.
//
// Why this design (each part against a measured loss; NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke.py phase 7; numbers in PERF.md):
//
// 1. No padding.  The TPU layout runs 97 chunks per real-size traversal,
//    widths bucketed to a ladder from 8, pad chunks and scan-replay steps
//    included: 1,272 slots for 510 entries, 24.46 GB of nominal traffic.
//    The first body of this kernel (one thread per site, a grid of
//    (block, entry)) ran that in 8.80 ms (2.78 TB/s nominal; padding
//    slots reread row 0, so part of it came from L2).  The host now hands
//    over only the 72 chunks with real entries at their real widths
//    (22 of one entry, 19 of two); this kernel takes its width at run
//    time, so a launch covers exactly real x B tiles.  That alone took
//    the first body to 4.04 ms.
// 2. Tiles and threads.  A tile is (entry, block b of L = 128 sites; a
//    quarter block at K = 20, point 7); for one inner child it is one
//    contiguous slab of the arena row (8 KB in f32 for DNA), a 512 B
//    scaler slab, or a 128 B code slab for a tip.  One
//    thread per (site, rate): the R lanes of a site are neighbours, each
//    holds the K values of its rate, so a warp reads and writes 512
//    contiguous bytes with 16-byte accesses (the first body had one thread
//    per site and 16-byte accesses 64 B apart).  The rescale decision
//    takes the max over all R*K values of the site, reduced over its R
//    lanes with __shfl_xor_sync; each FMA chain stays per (r, a), as in
//    the plain version, and the rate-0 lane writes the scaler.
// 3. A cp.async.bulk ring.  Persistent CTAs walk the launch's tiles with
//    a grid stride; the grid is min(tiles, CTAs per SM x SMs), two CTAs
//    per SM.  A producer warp keeps kStages stages in shared memory
//    filling with 1-D bulk copies (cp.async.bulk ...
//    mbarrier::complete_tx::bytes; the slabs are contiguous, so no tensor
//    map): both children's slabs and scalers, or the tip codes, and the
//    entry's two P blocks for the tile's partition.  While the consumer
//    warps compute and store tile t, tiles t+1.. are loading.  `full`
//    barriers count the bytes in, `empty` barriers count the consumer
//    warps out; each stage's phase parity flips per use.  The [C, K] tip
//    table is staged once per CTA.  Slabs are 16-byte aligned: the
//    wrapper checks every base address, and every slab is a multiple of
//    16 B.  No thread returns early: the ring is drained and its barriers
//    invalidated before the CTA ends.  A fourth stage, deeper rings for
//    the tip kinds, a third CTA per SM and prefetching the tile indices
//    across the producer warp each measured no faster.
// 4. Tip products once per tile.  A tip child's y depends only on (code,
//    rate), so the consumers build u[code][r][a] for the tile's P (one
//    value per thread, the same FMA chain as per site) and each thread
//    looks its code up.  Tip/tip chunks were bound by the per-site
//    products; the table took a traversal from 3.81 to 3.65 ms.
// 5. Programmatic dependent launch.  41 of the 72 launches have 1 or 2
//    entries, so launch gaps and ramps matter.  Launches after the first
//    carry cudaLaunchAttributeProgrammaticStreamSerialization: chunk k+1's
//    CTAs start while chunk k drains, set up their barriers and stage the
//    table, then wait (griddepcontrol.wait) before their first access to
//    the arena, which waits for chunk k's writes.  Chunk k signals
//    (griddepcontrol.launch_dependents) once its last tile is issued.
//    The first launch is ordered normally after the operand build.
// 6. No 64-bit division per tile.  The tile walk steps (entry, block) by
//    subtraction (`Tile`); the per-tile 64-bit div/mod it replaced cost
//    the latency-bound tip/tip tiles most: 3.70 -> 3.53 ms a traversal.
// 7. f32 and f64, R and K are template parameters; (R, K) = (4, 2),
//    (4, 4) and (4, 20) are instantiated (GAMMA over binary, DNA and
//    amino-acid data: GTR, the empirical matrices, LG4M/LG4X, whose
//    per-rate matrices the per-rate P already carries), and no index
//    hard-codes K.  At K = 20 a tile is 32 sites, not the block's 128
//    (`Geom`): a 128-site stage would hold 80 KB of child slabs in f32,
//    and three stages would not fit a block's shared memory; the tile is
//    still one contiguous slab per child.  A thread keeps one child's K
//    values and the running product y(left) * y(right), never both
//    children's y, so the f64 instance holds 2K doubles, not 4K.  The
//    tip-product table u costs C*R*K*K FMAs per tile and tip child (C =
//    23 amino-acid codes: as many as the per-site products of a 32-site
//    tile); it stays.  At K = 2 a rate's values are 8 bytes in f32, so
//    load_vec takes its scalar path; slabs stay 16-byte multiples.
//
// Measured in one call: the first body over the launch table 4.03-4.04 ms
// per real-size traversal, this body 3.53 ms (2.59 TB/s; chip_smoke.py
// prints the card's rate for a two-read, one-write elementwise product
// beside it).
//
// The rescale rule and the scaler sum are B1's.  Within a launch no entry
// reads a row the launch writes (the layout's promise, tested on the
// host).  A barrier wait that has not completed after ~2^34 clock cycles
// traps, so a protocol fault ends the launch with an error instead of
// hanging the card.
//
// Interface: plain C, loaded with ctypes.  Every device pointer and the
// stream arrive as void*, the launch table as a host int32 [n][4] array
// (kind, base, slot, real).  The function launches on the given stream,
// does not synchronise, allocates nothing, counts the launches it made in
// *launched and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Geometry of an instance.  A tile is kTile consecutive sites of one
// 128-lane block (the whole block for K <= 4); its consumers are one
// thread per (site, rate), plus one producer warp.  At K = 20 a stage of
// 128 sites would hold two 40 KB child slabs in f32 (80 KB in f64) and
// three stages would not fit the 227 KB of shared memory a block can
// have, so an amino-acid tile is 32 sites: 33 KB per stage in f32 (two
// CTAs per SM), 67 KB in f64 (one CTA per SM).
template <typename T, int R, int K>
struct Geom {
  static constexpr int kTile = K >= 16 ? 32 : 128;      // sites per tile
  static constexpr int kStages = 3;                     // ring depth
  static constexpr int kThreads = kTile * R + 32;       // + producer warp
  static constexpr int kMinBlocks = K >= 16 && sizeof(T) == 8 ? 1 : 2;
};

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void unpack(const float4& u, float* d) {
  d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
}
__device__ __forceinline__ void unpack(const double2& u, double* d) {
  d[0] = u.x; d[1] = u.y;
}
__device__ __forceinline__ float4 pack(const float* d) {
  return make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ double2 pack(const double* d) {
  return make_double2(d[0], d[1]);
}

// N contiguous values, by 16-byte accesses where N allows it (the source
// or destination is 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* src, T (&dst)[N]) {
  constexpr int per = 16 / sizeof(T);
  if constexpr (N % per == 0) {
    using V = typename Vec16<T>::type;
    const V* s = reinterpret_cast<const V*>(src);
#pragma unroll
    for (int i = 0; i < N / per; ++i) unpack(s[i], dst + i * per);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[N]) {
  constexpr int per = 16 / sizeof(T);
  if constexpr (N % per == 0) {
    using V = typename Vec16<T>::type;
    V* d = reinterpret_cast<V*>(dst);
#pragma unroll
    for (int i = 0; i < N / per; ++i) d[i] = pack(src + i * per);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

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

// -- barriers, bulk copies, grid dependency control (PTX) -----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// `bytes` contiguous bytes from global memory into shared memory; the
// barrier's transaction count drops by `bytes` when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void allow_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// -- shared memory layout ---------------------------------------------------

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Byte offsets inside one ring stage of a tile of L sites.  xl / xr hold
// a child's CLV slab [L][R][K] (inner) or its code slab [L] (tip); sl / sr
// the inner children's scaler slabs [L]; p the entry's two P blocks
// [2][R][K][K];
// u the tile's tip products [tip children][C][R][K] (kinds 0 and 1),
// built by the consumers from p and the table.  tx counts the bytes the
// bulk copies bring in.
struct Stage {
  int xl, xr, sl, sr, p, u, bytes, tx;
};

template <typename T, int R, int K, int KIND>
__host__ __device__ Stage stage_layout(int L, int C) {
  const int clv = L * R * K * (int)sizeof(T);
  const int pb = 2 * R * K * K * (int)sizeof(T);
  const int left = KIND == 2 ? clv : L;
  const int right = KIND >= 1 ? clv : L;
  Stage s{};
  s.xl = 0;
  s.xr = s.xl + align128(left);
  s.sl = s.xr + align128(right);
  s.sr = s.sl + (KIND == 2 ? align128(4 * L) : 0);
  s.p = s.sr + (KIND >= 1 ? align128(4 * L) : 0);
  s.u = s.p + align128(pb);
  s.bytes = s.u + align128((2 - KIND > 0 ? 2 - KIND : 0) * C * R * K *
                           (int)sizeof(T));
  s.tx = left + right + (KIND == 2 ? 4 * L : 0) + (KIND >= 1 ? 4 * L : 0) +
         pb;
  return s;
}

// [full barriers | empty barriers] (128 B) | table [C][K] | kStages stages
// of a tile of TL sites.
template <typename T, int R, int K, int KIND>
__host__ __device__ int smem_bytes(int TL, int C) {
  return 128 + align128(C * K * (int)sizeof(T)) +
         Geom<T, R, K>::kStages * stage_layout<T, R, K, KIND>(TL, C).bytes;
}

// Barrier 1 over the consumer warps only (the producer warp never waits
// on it).
__device__ __forceinline__ void consumer_sync(int consumers) {
  asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
}

template <typename T>
struct Operands {
  T* clv;                       // [rows, B, L, R, K]
  int32_t* scaler;              // [rows, B, L]
  const uint8_t* codes;         // [ntips, B, L]
  const T* table;               // [C, K]
  const int32_t* block_part;    // [B]
  const int32_t* lidx;          // [P] packed per slot
  const int32_t* ridx;
  const int32_t* lcode;
  const int32_t* rcode;
  const T* pmat;                // [P, 2, M, R, K, K]
  int B, L, M, C;
  int TL, NT;                   // sites per tile, tiles per entry
  T minlik, two_e;
};

// The CTA's current tile (entry w, tile b of the entry's NT), walked with
// a grid stride; stepping by subtraction keeps 64-bit division out of the
// loops.
struct Tile {
  int w, b;
  __device__ explicit Tile(int NT) : w(blockIdx.x / NT), b(blockIdx.x % NT) {}
  __device__ void advance(int NT) {
    b += gridDim.x;
    while (b >= NT) {
      b -= NT;
      ++w;
    }
  }
};

template <typename T, int R, int K, int KIND>
__global__ void __launch_bounds__((Geom<T, R, K>::kThreads),
                                  (Geom<T, R, K>::kMinBlocks))
    newview_chunk_kernel(const Operands<T> op, int base, int slot, int real) {
  constexpr int PN = R * K * K;               // per-rate P, one partition
  constexpr int kStages = Geom<T, R, K>::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  T* s_tab = reinterpret_cast<T*>(smem + 128);
  unsigned char* ring = smem + 128 + align128(op.C * K * (int)sizeof(T));
  const int L = op.L, TL = op.TL, NT = op.NT;
  const Stage lay = stage_layout<T, R, K, KIND>(TL, op.C);
  const int consumers = TL * R;
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
  for (int i = tid; i < op.C * K; i += blockDim.x) s_tab[i] = op.table[i];
  __syncthreads();
  wait_for_prior_grid();        // the previous launch's rows are written

  const size_t S = (size_t)op.B * L;          // sites per row
  if (tid >= consumers) {
    // Producer warp: lane 0 keeps the ring full.
    const uint32_t clv_b = (uint32_t)(TL * R * K * sizeof(T));
    Tile tile(NT);
    for (int i = 0; tile.w < real; ++i, tile.advance(NT)) {
      if (lane == 0) {
        const int s = i % kStages;
        const int w = tile.w;
        const int sl = slot + w;
        const size_t site0 = (size_t)tile.b * TL;   // first site of the tile
        const int lrow = KIND == 2 ? op.lidx[sl] : op.lcode[sl];
        const int rrow = KIND >= 1 ? op.ridx[sl] : op.rcode[sl];
        const int m = op.block_part[site0 / L];
        const T* gp = op.pmat + ((size_t)sl * 2 * op.M + m) * PN;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        unsigned char* st = ring + (size_t)s * lay.bytes;
        mbar_arrive_expect_tx(&full[s], (uint32_t)lay.tx);
        bulk_load(st + lay.p, gp, PN * sizeof(T), &full[s]);
        bulk_load(st + lay.p + PN * sizeof(T), gp + (size_t)op.M * PN,
                  PN * sizeof(T), &full[s]);
        if constexpr (KIND == 2) {
          bulk_load(st + lay.xl, op.clv + ((size_t)lrow * S + site0) * R * K,
                    clv_b, &full[s]);
          bulk_load(st + lay.sl, op.scaler + (size_t)lrow * S + site0,
                    4 * TL, &full[s]);
        } else {
          bulk_load(st + lay.xl, op.codes + (size_t)lrow * S + site0, TL,
                    &full[s]);
        }
        if constexpr (KIND >= 1) {
          bulk_load(st + lay.xr, op.clv + ((size_t)rrow * S + site0) * R * K,
                    clv_b, &full[s]);
          bulk_load(st + lay.sr, op.scaler + (size_t)rrow * S + site0,
                    4 * TL, &full[s]);
        } else {
          bulk_load(st + lay.xr, op.codes + (size_t)rrow * S + site0, TL,
                    &full[s]);
        }
      }
      __syncwarp();
    }
    allow_dependent_grid();     // every tile of this CTA is issued
  } else {
    // Consumer warps: thread (site l of the tile, rate r).
    const int l = tid / R, r = tid % R;
    Tile tile(NT);
    for (int i = 0; tile.w < real; ++i) {
      const int s = i % kStages;
      const int w = tile.w;
      const size_t site0 = (size_t)tile.b * TL;
      tile.advance(NT);
      if (tile.w >= real) allow_dependent_grid();   // this CTA's last tile
      mbar_wait(&full[s], (i / kStages) & 1);
      unsigned char* st = ring + (size_t)s * lay.bytes;
      const T* p = reinterpret_cast<const T*>(st + lay.p) + r * K * K;
      // v holds the left child's y, then y(left) * y(right): one child's K
      // values at a time besides it.
      T v[K];
      int sc = 0;
      if constexpr (KIND <= 1) {
        // A tip child's y depends only on (code, rate): the consumers
        // build u[side][c][r][a] = sum_k P[side][r][a][k] * table[c][k]
        // for every code once per tile (the same FMA chain as per site),
        // then each thread looks its code up.
        constexpr int NT2 = 2 - KIND;           // tip children
        T* u = reinterpret_cast<T*>(st + lay.u);
        const T* pb = reinterpret_cast<const T*>(st + lay.p);
        for (int q = tid; q < NT2 * op.C * R * K; q += consumers) {
          const int side = q / (op.C * R * K);
          const int rem = q - side * op.C * R * K;
          const int c = rem / (R * K), ra = rem - c * (R * K);
          T prow[K], tv[K];
          load_vec<T, K>(pb + side * PN + ra * K, prow);
          load_vec<T, K>(s_tab + c * K, tv);
          T acc = prow[0] * tv[0];
#pragma unroll
          for (int k = 1; k < K; ++k) acc = fma(prow[k], tv[k], acc);
          u[q] = acc;
        }
        consumer_sync(consumers);
        load_vec<T, K>(u + ((int)st[lay.xl + l] * R + r) * K, v);
        if constexpr (KIND == 0) {
          T y[K];
          load_vec<T, K>(u + (((size_t)op.C + st[lay.xr + l]) * R + r) * K,
                         y);
#pragma unroll
          for (int a = 0; a < K; ++a) v[a] *= y[a];
        }
      } else {
        T x[K];
        load_vec<T, K>(reinterpret_cast<const T*>(st + lay.xl) + tid * K, x);
        sc += reinterpret_cast<const int32_t*>(st + lay.sl)[l];
        apply_p<T, K>(p, x, v);
      }
      if constexpr (KIND >= 1) {
        T x[K];
        load_vec<T, K>(reinterpret_cast<const T*>(st + lay.xr) + tid * K, x);
        sc += reinterpret_cast<const int32_t*>(st + lay.sr)[l];
        apply_p_mul<T, K>(p + PN, x, v);
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
      const size_t out = (size_t)(base + w) * S + site0;  // (row, site)
      store_vec<T, K>(op.clv + (out * R + tid) * K, v);
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

template <typename T, int R, int K, int KIND>
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
  if (TL < 16 || TL % 16 || L % TL || TL * R % 32 || C < 1)
    return cudaErrorInvalidValue;
  Config c;
  c.dev = dev;
  c.L = L;
  c.C = C;
  c.tile = TL;
  c.stages = Geom<T, R, K>::kStages;
  c.smem = smem_bytes<T, R, K, KIND>(TL, C);
  c.threads = TL * R + 32;
  int optin = 0;
  auto kern = newview_chunk_kernel<T, R, K, KIND>;
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

template <typename T, int R, int K, int KIND>
cudaError_t launch_one(Operands<T> op, int base, int slot, int real,
                       bool dependent, cudaStream_t stream) {
  Config c;
  cudaError_t err = configure<T, R, K, KIND>(op.L, op.C, c);
  if (err != cudaSuccess) return err;
  op.TL = c.tile;
  op.NT = op.B * (op.L / c.tile);
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
  return cudaLaunchKernelEx(&lc, newview_chunk_kernel<T, R, K, KIND>, op,
                            base, slot, real);
}

template <typename T, int R, int K>
int launch_all(const Operands<T>& op, const int32_t* launch, int n,
               cudaStream_t stream, int* launched) {
  for (int i = 0; i < n; ++i) {
    const int kind = launch[4 * i], base = launch[4 * i + 1];
    const int slot = launch[4 * i + 2], real = launch[4 * i + 3];
    if (real < 1) return (int)cudaErrorInvalidValue;
    const bool dep = i > 0;
    cudaError_t err;
    switch (kind) {
      case 0:
        err = launch_one<T, R, K, 0>(op, base, slot, real, dep, stream);
        break;
      case 1:
        err = launch_one<T, R, K, 1>(op, base, slot, real, dep, stream);
        break;
      case 2:
        err = launch_one<T, R, K, 2>(op, base, slot, real, dep, stream);
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

template <typename T>
int dispatch(void* clv, void* scaler, const void* codes, const void* table,
             const void* block_part, const void* lidx, const void* ridx,
             const void* lcode, const void* rcode, const void* pmat,
             const void* launch, int n, int B, int L, int M, int C, int R,
             int K, double minlik, double two_e, void* stream,
             int* launched) {
  *launched = 0;
  Operands<T> op;
  op.clv = static_cast<T*>(clv);
  op.scaler = static_cast<int32_t*>(scaler);
  op.codes = static_cast<const uint8_t*>(codes);
  op.table = static_cast<const T*>(table);
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
    return launch_all<T, 4, 2>(op, rows, n, st, launched);
  if (R == 4 && K == 4)
    return launch_all<T, 4, 4>(op, rows, n, st, launched);
  if (R == 4 && K == 20)
    return launch_all<T, 4, 20>(op, rows, n, st, launched);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int R, int K>
cudaError_t config_rk(int kind, int L, int C, Config& c) {
  switch (kind) {
    case 0: return configure<T, R, K, 0>(L, C, c);
    case 1: return configure<T, R, K, 1>(L, C, c);
    case 2: return configure<T, R, K, 2>(L, C, c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int config_of(int R, int K, int kind, int L, int C, int* out) {
  Config c;
  cudaError_t err = cudaErrorInvalidValue;
  if (R == 4 && K == 2) err = config_rk<T, 4, 2>(kind, L, C, c);
  if (R == 4 && K == 4) err = config_rk<T, 4, 4>(kind, L, C, c);
  if (R == 4 && K == 20) err = config_rk<T, 4, 20>(kind, L, C, c);
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
                             const void* table, const void* block_part,
                             const void* lidx, const void* ridx,
                             const void* lcode, const void* rcode,
                             const void* pmat, const void* launch, int n,
                             int B, int L, int M, int C, int R, int K,
                             double minlik, double two_e, void* stream,
                             int* launched) {
  return dispatch<float>(clv, scaler, codes, table, block_part, lidx, ridx,
                         lcode, rcode, pmat, launch, n, B, L, M, C, R, K,
                         minlik, two_e, stream, launched);
}

int examl_newview_chunks_f64(void* clv, void* scaler, const void* codes,
                             const void* table, const void* block_part,
                             const void* lidx, const void* ridx,
                             const void* lcode, const void* rcode,
                             const void* pmat, const void* launch, int n,
                             int B, int L, int M, int C, int R, int K,
                             double minlik, double two_e, void* stream,
                             int* launched) {
  return dispatch<double>(clv, scaler, codes, table, block_part, lidx, ridx,
                          lcode, rcode, pmat, launch, n, B, L, M, C, R, K,
                          minlik, two_e, stream, launched);
}

// The launch configuration of one instance (R rates, K states, kind) for
// lane width L and C tip codes: out = {dynamic shared memory bytes,
// threads per CTA, resident CTAs per SM, SMs, sites per tile, ring
// stages}.
int examl_newview_chunk_config(int f64, int R, int K, int kind, int L, int C,
                               int* out) {
  return f64 ? config_of<double>(R, K, kind, L, C, out)
             : config_of<float>(R, K, kind, L, C, out);
}

const char* examl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
