// Pieces shared by kernels B1 (newview_chunk.cu) and B2 (newview_whole.cu):
// vector loads, the mbarrier and bulk-copy PTX, the layout
// of a ring stage that holds one tile of an entry, the producer's copies
// for one child of a tile, and the register-blocked amino-acid body that
// both kernels run on a staged tile.
//
// A tile is TL consecutive sites of one 128-lane block of one entry, so
// one partition.  A child of the tile is either
//   inner: its arena row's slab [TL][R][K] (one contiguous piece), its
//          scaler slab [TL] and the entry's P for that side and
//          partition, [R][K][K]; y[r][a] = sum_k P[r][a][k] * x[r][k];
//   tip:   its code slab [TL] (1 byte a site) and the entry's tip
//          products for that side and partition, u[C][R][K] =
//          sum_k P[r][a][k] * table[c][k], built once per traversal by
//          the wrappers (ops/newview_chunk.py tip_products, the JAX
//          package's _ump); y[r][a] = u[code][r][a].
// Every piece is 16-byte aligned and a multiple of 16 bytes, so each is
// one cp.async.bulk copy; P at K >= 16 is R copies, one per rate, at the
// bank-spread offsets of p_rate_offset.
//
// Storage and compute types.  The pieces that touch CLV rows take a
// storage type S beside the compute type T (S defaults to T): the arena
// rows, a child's staged slab and a staged output are in S; P, the tip
// products, every FMA and the rescale decision are in T.  B2 and B1's
// float32 / float64 instances have S = T; B1's bfloat16-storage instances
// have S = __nv_bfloat16, T = float: a staged slab is converted on its
// load from shared memory (exact), each output is rounded to nearest even
// once, after the rescale (as torch's and JAX's casts round).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename A, typename B>
constexpr bool kSame = false;
template <typename A>
constexpr bool kSame<A, A> = true;

// -- vector loads and stores -----------------------------------------------

template <typename T, int V> struct VecT;
template <> struct VecT<float, 16> { using type = float4; };
template <> struct VecT<double, 16> { using type = double2; };
template <> struct VecT<float, 8> { using type = float2; };
// 16 bytes of bfloat16 rows, moved as they are (blocked_store's copy).
template <> struct VecT<__nv_bfloat16, 16> { using type = uint4; };

__device__ __forceinline__ void unpack(const float4& u, float* d) {
  d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
}
__device__ __forceinline__ void unpack(const double2& u, double* d) {
  d[0] = u.x; d[1] = u.y;
}
__device__ __forceinline__ void unpack(const float2& u, float* d) {
  d[0] = u.x; d[1] = u.y;
}
__device__ __forceinline__ void pack(const float* d, float4& u) {
  u = make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ void pack(const double* d, double2& u) {
  u = make_double2(d[0], d[1]);
}
__device__ __forceinline__ void pack(const float* d, float2& u) {
  u = make_float2(d[0], d[1]);
}

// The widest access (16 or 8 bytes, at most V) that N values of T split
// into; 0 where only single values do.
template <typename T, int N, int V>
__host__ __device__ constexpr int access_bytes() {
  return (V >= 16 && (N * sizeof(T)) % 16 == 0) ? 16
         : (V >= 8 && sizeof(T) == 4 && (N * sizeof(T)) % 8 == 0) ? 8
                                                                   : 0;
}

// N contiguous values by accesses of up to V bytes; the caller guarantees
// that `src` is aligned to the access access_bytes<T, N, V>() picks.
template <typename T, int N, int V = 16>
__device__ __forceinline__ void load_vec(const T* src, T (&dst)[N]) {
  constexpr int W = access_bytes<T, N, V>();
  if constexpr (W > 0) {
    using Vt = typename VecT<T, W>::type;
    constexpr int per = W / sizeof(T);
    const Vt* s = reinterpret_cast<const Vt*>(src);
#pragma unroll
    for (int i = 0; i < N / per; ++i) unpack(s[i], dst + i * per);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <typename T, int N, int V = 16>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[N]) {
  constexpr int W = access_bytes<T, N, V>();
  if constexpr (W > 0) {
    using Vt = typename VecT<T, W>::type;
    constexpr int per = W / sizeof(T);
    Vt* d = reinterpret_cast<Vt*>(dst);
#pragma unroll
    for (int i = 0; i < N / per; ++i) {
      Vt w;
      pack(src + i * per, w);
      d[i] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// bfloat16 <-> float.  A bfloat16 is the upper half of a float, so a
// 32-bit word w of two (element 0 in the low half) widens exactly by
// shifts; two floats narrow to one word by __float2bfloat16_rn each.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

template <int W> struct Words;
template <> struct Words<16> {
  using type = uint4;
  __device__ static void get(const uint4& v, uint32_t* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ static uint4 make(const uint32_t* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Words<8> {
  using type = uint2;
  __device__ static void get(const uint2& v, uint32_t* w) {
    w[0] = v.x; w[1] = v.y;
  }
  __device__ static uint2 make(const uint32_t* w) {
    return make_uint2(w[0], w[1]);
  }
};
template <> struct Words<4> {
  using type = uint32_t;
  __device__ static void get(const uint32_t& v, uint32_t* w) { w[0] = v; }
  __device__ static uint32_t make(const uint32_t* w) { return w[0]; }
};

// The widest access (16, 8 or 4 bytes, at most V) that N bfloat16 values
// split into; 0 where only single values do.
template <int N, int V>
__host__ __device__ constexpr int bf16_access_bytes() {
  return (V >= 16 && (2 * N) % 16 == 0) ? 16
         : (V >= 8 && (2 * N) % 8 == 0) ? 8
         : (2 * N) % 4 == 0             ? 4
                                        : 0;
}

// N contiguous values of storage type S into compute type T: load_vec
// where S = T, else N bfloat16 values widened to float.  The caller
// guarantees the alignment of the access the widths pick.
template <typename S, typename T, int N, int V = 16>
__device__ __forceinline__ void load_cvt(const S* src, T (&dst)[N]) {
  if constexpr (kSame<S, T>) {
    load_vec<T, N, V>(src, dst);
  } else {
    static_assert(kSame<S, __nv_bfloat16> && kSame<T, float>,
                  "storage types: T itself, or bfloat16 under float");
    constexpr int W = bf16_access_bytes<N, V>();
    if constexpr (W > 0) {
      using Wt = Words<W>;
      constexpr int nw = W / 4;
      const typename Wt::type* s =
          reinterpret_cast<const typename Wt::type*>(src);
#pragma unroll
      for (int i = 0; i < 2 * N / W; ++i) {
        uint32_t w[nw];
        Wt::get(s[i], w);
#pragma unroll
        for (int j = 0; j < nw; ++j) {
          dst[i * 2 * nw + 2 * j] = bf16_lo(w[j]);
          dst[i * 2 * nw + 2 * j + 1] = bf16_hi(w[j]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) dst[i] = __bfloat162float(src[i]);
    }
  }
}

// N compute values stored as S: store_vec where S = T, else rounded to
// nearest even into bfloat16.
template <typename S, typename T, int N, int V = 16>
__device__ __forceinline__ void store_cvt(S* dst, const T (&src)[N]) {
  if constexpr (kSame<S, T>) {
    store_vec<T, N, V>(dst, src);
  } else {
    static_assert(kSame<S, __nv_bfloat16> && kSame<T, float>,
                  "storage types: T itself, or bfloat16 under float");
    constexpr int W = bf16_access_bytes<N, V>();
    if constexpr (W > 0) {
      using Wt = Words<W>;
      constexpr int nw = W / 4;
      typename Wt::type* d = reinterpret_cast<typename Wt::type*>(dst);
#pragma unroll
      for (int i = 0; i < 2 * N / W; ++i) {
        uint32_t w[nw];
#pragma unroll
        for (int j = 0; j < nw; ++j)
          w[j] = bf16_pack(src[i * 2 * nw + 2 * j],
                           src[i * 2 * nw + 2 * j + 1]);
        d[i] = Wt::make(w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) dst[i] = __float2bfloat16_rn(src[i]);
    }
  }
}

// -- barriers and bulk copies (PTX) -----------------------------------------

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

// Wait for the completion of the barrier's phase of the given parity.  A
// wait that has not completed after ~2^34 clock cycles traps, so a
// protocol fault ends the launch with an error instead of hanging the card.
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

// -- the layout of a ring stage --------------------------------------------

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Whether an instance runs the register-blocked body (amino acids) or one
// thread per (site, rate) (binary and DNA data).
template <int K>
constexpr bool kBlocked = K >= 16;

// Byte offset of rate r's [K][K] block inside a side's P area.  At K >= 16
// the blocked body's warp reads, at one step, the same 16-byte piece of
// rows a and a + K/2 of every rate: 2R pieces.  The offsets put those
// pieces in 2R distinct 16-byte bank groups (of the 8 that 32 banks form),
// so the read is one shared-memory wavefront and not two: rate r starts at
// the first 16-byte offset past rate r - 1 whose group g and g + d (d the
// groups between rows a and a + K/2) are still free.  For K < 16 the
// blocks are contiguous.
template <typename T, int R, int K>
__host__ __device__ constexpr int p_rate_offset(int r) {
  constexpr int blk = K * K * (int)sizeof(T) / 16;
  if constexpr (!kBlocked<K>) {
    return r * blk * 16;
  } else {
    constexpr int d = (K / 2) * K * (int)sizeof(T) / 16 % 8;
    int used = 0, off = 0;
    for (int q = 0;; ++q) {
      while (((used >> (off % 8)) & 1) || ((used >> ((off + d) % 8)) & 1))
        ++off;
      if (q == r) return off * 16;
      used |= (1 << (off % 8)) | (1 << ((off + d) % 8));
      off += blk;
    }
    return 0;
  }
}

template <typename T, int R, int K>
__host__ __device__ constexpr int p_span() {
  return p_rate_offset<T, R, K>(R - 1) + K * K * (int)sizeof(T);
}

// One child's areas inside a stage (byte offsets): x holds its CLV slab
// [TL][R][K] (inner); sc its scaler slab [TL] (inner) or its codes [TL]
// (tip); op its P (inner) or its tip products u [C][R][K] (tip).  A tip
// side of mode kEither leaves its x area free: the blocked body stages
// its output there.
struct Side {
  int x, sc, op;
};

struct Stage {
  Side side[2];
  int bytes;
};

// A side's mode: a tip, an inner child, or either (the stage holds room
// for both; B2, whose entries mix tip cases within a launch).
enum SideMode { kTip = 0, kInner = 1, kEither = 2 };

template <typename T, int R, int K, typename S = T>
__host__ __device__ void side_bytes(int mode, int TL, int C, int* x, int* sc,
                                    int* op) {
  const int clv = TL * R * K * (int)sizeof(S);
  const int u = C * R * K * (int)sizeof(T);
  const int p = p_span<T, R, K>();
  *x = mode == kTip ? 0 : clv;
  *sc = mode == kTip ? TL : 4 * TL;
  *op = mode == kTip ? u : mode == kInner ? p : (u > p ? u : p);
}

template <typename T, int R, int K, typename S = T>
__host__ __device__ Stage stage_layout(int lmode, int rmode, int TL, int C) {
  Stage s{};
  int off = 0;
  const int modes[2] = {lmode, rmode};
  for (int i = 0; i < 2; ++i) {
    int x, sc, op;
    side_bytes<T, R, K, S>(modes[i], TL, C, &x, &sc, &op);
    s.side[i].x = off;
    off += align128(x);
    s.side[i].sc = off;
    off += align128(sc);
    s.side[i].op = off;
    off += align128(op);
  }
  s.bytes = off;
  return s;
}

// The bytes the copies of one side bring in: the CLV slab in S, P and the
// tip products in T.
template <typename T, int R, int K, typename S = T>
__host__ __device__ int side_tx(bool tip, int TL, int C) {
  return tip ? TL + C * R * K * (int)sizeof(T)
             : TL * R * K * (int)sizeof(S) + 4 * TL + R * K * K *
                                                          (int)sizeof(T);
}

// The producer's copies of one side of a tile into stage `st`: for a tip
// the code slab at `codes` and the tip products `u`, for an inner child
// the CLV slab at `slab`, the scaler slab at `sc` and P at `p` (each
// pointer already at the tile's first site / the entry's side and
// partition).
template <typename T, int R, int K, typename S = T>
__device__ __forceinline__ void load_side(unsigned char* st, const Side& sd,
                                          bool tip, const uint8_t* codes,
                                          const T* u, const S* slab,
                                          const int32_t* sc, const T* p,
                                          int TL, int C, uint64_t* bar) {
  if (tip) {
    bulk_load(st + sd.sc, codes, TL, bar);
    bulk_load(st + sd.op, u, C * R * K * sizeof(T), bar);
    return;
  }
  bulk_load(st + sd.x, slab, TL * R * K * sizeof(S), bar);
  bulk_load(st + sd.sc, sc, 4 * TL, bar);
  if constexpr (kBlocked<K>) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      bulk_load(st + sd.op + p_rate_offset<T, R, K>(r), p + r * K * K,
                K * K * sizeof(T), bar);
  } else {
    bulk_load(st + sd.op, p, R * K * K * sizeof(T), bar);
  }
}

// The CTA's current tile (entry w, tile b of the entry's NT), walked with
// a grid stride; stepping by subtraction keeps integer division out of the
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

// -- the register-blocked body (K >= 16) -----------------------------------
//
// A consumer thread owns one rate r, one half h of the K outputs a (A =
// K/2 of them) and NS sites, sg + j*TL/NS.  NS is a property of the
// storage and compute types: 2 for f32 (16 consumer warps a 128-site tile,
// 96 registers a thread), 1 for f64 (whose values take twice the
// registers), 4 for bfloat16 storage under f32 (8 consumer warps, up to
// 224 registers a thread: x[4][K] and v[4][K/2] in f32 registers with room
// for the next P reads; at NS = 2 and 96 registers that instance spilled).
// Lanes run (rate, half, site group) fastest first, so the R*H = 8 lanes
// of a site are neighbours (the rescale's max is three shuffles) and a
// warp holds 4 sites of all 8 (rate, half) pairs.  For each output a the
// thread reads P's row (r, a) from shared memory once and runs NS
// independent k-chains with it, each k = 0..K-1 in order (apply_p's chain,
// so the values do not change); the child's K values of each site stay in
// registers, widened to f32 once per tile (kept as packed bfloat16 pairs,
// every FMA would need an integer unpack on the same issue port, halving
// the FMA rate).  One 16-byte read of P feeds NS * 4 FMAs; a warp's
// reads of x touch distinct pieces (4 sites x 4 rates, conflict-free: a
// rate row is 80 bytes in f32, 40 in bfloat16) and of P 8 (bank-spread by
// p_rate_offset).

template <typename T, int R, int K, typename S = T>
struct Blocked {
  static constexpr int H = 2;            // output halves a thread may own
  // Sites a thread owns.
  static constexpr int NS = sizeof(T) == 8 ? 1 : sizeof(S) == 2 ? 4 : 2;
  static constexpr int A = K / H;        // outputs a thread owns
  static constexpr int kLanes = R * H;   // lanes of one site
  // Loads and stores of a thread's A outputs: 16 bytes where its half
  // starts 16-byte aligned, else 8.
  static constexpr int V = (A * sizeof(T)) % 16 == 0 ? 16 : 8;
  static_assert(K % H == 0 && 32 % kLanes == 0, "blocked body geometry");
};

// A consumer thread's part: rate, half, site group, and the byte offset
// of its rate's P block (computed once per thread).
struct Role {
  int r, h, sg, prate;
};

// Consumer threads a site: one per rate for K <= 4, R*H/NS in the blocked
// body.
template <typename T, int R, int K, typename S = T>
__host__ __device__ constexpr int threads_per_site() {
  if constexpr (kBlocked<K>)
    return R * Blocked<T, R, K, S>::H / Blocked<T, R, K, S>::NS;
  else
    return R;
}

template <typename T, int R, int K, typename S = T>
__device__ __forceinline__ Role blocked_role(int tid) {
  using G = Blocked<T, R, K, S>;
  const int r = tid % R;
  return Role{r, (tid / R) % G::H, tid / G::kLanes,
              p_rate_offset<T, R, K>(r)};
}

// v[j][i] (= or *=) y of output a = h*A + i at site j, for an inner child
// whose slab (in S) and P are staged in `st` at `sd`.
template <typename T, int R, int K, bool MUL, typename S = T>
__device__ __forceinline__ void blocked_inner(
    const unsigned char* st, const Side& sd, const Role& ro,
    const int (&site)[Blocked<T, R, K, S>::NS],
    T (&v)[Blocked<T, R, K, S>::NS][Blocked<T, R, K, S>::A]) {
  using G = Blocked<T, R, K, S>;
  const S* slab = reinterpret_cast<const S*>(st + sd.x);
  const T* p = reinterpret_cast<const T*>(st + sd.op + ro.prate) +
               ro.h * G::A * K;
  T x[G::NS][K];
#pragma unroll
  for (int j = 0; j < G::NS; ++j)
    load_cvt<S, T, K>(slab + (site[j] * R + ro.r) * K, x[j]);
  constexpr int per = 16 / sizeof(T);        // P values a 16-byte read
  static_assert(K % per == 0, "P rows are read 16 bytes at a time");
#pragma unroll
  for (int i = 0; i < G::A; ++i) {
    T acc[G::NS];
#pragma unroll
    for (int c = 0; c < K / per; ++c) {
      T q[per];
      load_vec<T, per>(p + i * K + c * per, q);
#pragma unroll
      for (int kk = 0; kk < per; ++kk) {
        const int k = c * per + kk;
#pragma unroll
        for (int j = 0; j < G::NS; ++j)
          acc[j] = k == 0 ? q[0] * x[j][0] : fma(q[kk], x[j][k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < G::NS; ++j) {
      if constexpr (MUL)
        v[j][i] *= acc[j];
      else
        v[j][i] = acc[j];
    }
  }
}

// The same for a tip child: y = u[code][r][h*A ..].
template <typename T, int R, int K, bool MUL, typename S = T>
__device__ __forceinline__ void blocked_tip(
    const unsigned char* st, const Side& sd, const Role& ro,
    const int (&site)[Blocked<T, R, K, S>::NS],
    T (&v)[Blocked<T, R, K, S>::NS][Blocked<T, R, K, S>::A]) {
  using G = Blocked<T, R, K, S>;
  const uint8_t* codes = st + sd.sc;
  const T* u = reinterpret_cast<const T*>(st + sd.op) + ro.r * K + ro.h * G::A;
#pragma unroll
  for (int j = 0; j < G::NS; ++j) {
    T y[G::A];
    load_vec<T, G::A, G::V>(u + (int)codes[site[j]] * R * K, y);
#pragma unroll
    for (int i = 0; i < G::A; ++i) {
      if constexpr (MUL)
        v[j][i] *= y[i];
      else
        v[j][i] = y[i];
    }
  }
}

template <typename T, int R, int K, bool MUL, typename S = T>
__device__ __forceinline__ void blocked_child(
    const unsigned char* st, const Side& sd, bool tip, const Role& ro,
    const int (&site)[Blocked<T, R, K, S>::NS],
    T (&v)[Blocked<T, R, K, S>::NS][Blocked<T, R, K, S>::A],
    int (&sc)[Blocked<T, R, K, S>::NS]) {
  if (tip) {
    blocked_tip<T, R, K, MUL, S>(st, sd, ro, site, v);
  } else {
    blocked_inner<T, R, K, MUL, S>(st, sd, ro, site, v);
    const int32_t* s = reinterpret_cast<const int32_t*>(st + sd.sc);
#pragma unroll
    for (int j = 0; j < Blocked<T, R, K, S>::NS; ++j) sc[j] += s[site[j]];
  }
}

// Rescale and store a thread's products: the max over a site's R*K values
// is reduced over its kLanes neighbouring lanes; a site under 2^-E (minlik)
// is multiplied by 2^E and its scaler adds 1.  The values go to `obuf`
// ([TL][R][K] of S in shared memory, rounded there when S is narrower)
// first, so that each warp then writes its sites' rows to the parent row
// with contiguous 16-byte stores (a thread's own A values are 40 bytes
// of a 320-byte site row in f32).  A warp's sites are its own in `obuf`
// too: only __syncwarp orders the two steps.
// `out` is the parent row at the tile's first site, `out_sc` its scaler
// row there.
template <typename T, int R, int K, typename S = T>
__device__ __forceinline__ void blocked_store(
    T (&v)[Blocked<T, R, K, S>::NS][Blocked<T, R, K, S>::A], const Role& ro,
    const int (&site)[Blocked<T, R, K, S>::NS],
    const int (&sc)[Blocked<T, R, K, S>::NS], int TL, S* obuf, S* out,
    int32_t* out_sc, T minlik, T two_e) {
  using G = Blocked<T, R, K, S>;
#pragma unroll
  for (int j = 0; j < G::NS; ++j) {
    T vmax = T(0);
#pragma unroll
    for (int i = 0; i < G::A; ++i) {
      const T a = fabs(v[j][i]);
      vmax = a > vmax ? a : vmax;
    }
#pragma unroll
    for (int o = 1; o < G::kLanes; o <<= 1) {
      const T a = __shfl_xor_sync(0xffffffffu, vmax, o);
      vmax = a > vmax ? a : vmax;
    }
    const bool needs = vmax < minlik;
    if (needs) {
#pragma unroll
      for (int i = 0; i < G::A; ++i) v[j][i] *= two_e;
    }
    store_cvt<S, T, G::A, G::V>(
        obuf + (site[j] * R + ro.r) * K + ro.h * G::A, v[j]);
    if (ro.r == 0 && ro.h == 0) out_sc[site[j]] = sc[j] + (needs ? 1 : 0);
  }
  __syncwarp();
  // The warp's sites: kSites consecutive ones from site[j] of its lane 0.
  constexpr int kSites = 32 / G::kLanes;
  constexpr int kVec = kSites * R * K * (int)sizeof(S) / 16;
  using V4 = typename VecT<S, 16>::type;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < G::NS; ++j) {
    const int first = (ro.sg & ~(kSites - 1)) + j * (TL / G::NS);
    const V4* src = reinterpret_cast<const V4*>(obuf + first * R * K);
    V4* dst = reinterpret_cast<V4*>(out + first * R * K);
    for (int q = lane; q < kVec; q += 32) dst[q] = src[q];
  }
  // `obuf` may be a ring stage, which a bulk copy (the async proxy)
  // refills once the stage is released: order these ordinary writes
  // before it.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
}

// One staged tile through the blocked body: left child, right child
// multiplied in, rescale and store (through `obuf`), then the stage
// released (one arrival per consumer warp on `empty`).
template <typename T, int R, int K, typename S = T>
__device__ __forceinline__ void blocked_tile(
    const unsigned char* st, const Stage& lay, bool ltip, bool rtip,
    const Role& ro, int TL, uint64_t* empty, S* obuf, S* out,
    int32_t* out_sc, T minlik, T two_e) {
  using G = Blocked<T, R, K, S>;
  int site[G::NS];
#pragma unroll
  for (int j = 0; j < G::NS; ++j) site[j] = ro.sg + j * (TL / G::NS);
  T v[G::NS][G::A];
  int sc[G::NS] = {};
  blocked_child<T, R, K, false, S>(st, lay.side[0], ltip, ro, site, v, sc);
  blocked_child<T, R, K, true, S>(st, lay.side[1], rtip, ro, site, v, sc);
  __syncwarp();                 // the warp's reads of the stage are done
  blocked_store<T, R, K, S>(v, ro, site, sc, TL, obuf, out, out_sc, minlik,
                            two_e);
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);   // this warp is done
}

}  // namespace
