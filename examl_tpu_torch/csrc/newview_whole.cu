// Whole-traversal kernel (B2) for Hopper, sm_90a.
//
// Replaces examl_tpu/ops/pallas_whole.py::_kernel (launched there by
// run_flat_arrays over the schedule of build_flat).  One launch runs a
// whole full traversal.  Entries come in dependency-wave order; entry e
// writes CLV arena row w_row (= e) and its scaler row in place:
//
//   y[r][a] = sum_k P[e][side][part(b)][r][a][k] * x[r][k], x the arena
//             row l_row / r_row of an inner child, or the [C][K] table's
//             row of a tip child's code tiled over the rates; at K = 20 a
//             tip child's y is u[e][side][part(b)][code][r][a], the tip
//             products the wrapper builds once per traversal
//   v = yl * yr;  where max|v| < 2^-E:  v *= 2^E and the scaler adds 1;
//   scaler = scaler(left) + scaler(right) + that increment.
//
// Design.  One cooperative, persistent grid: the host sizes it to the
// number of blocks that can be resident at once (occupancy x SM count),
// so a grid-wide barrier is legal.  For each wave, the blocks stride over
// the wave's work items, (entry of the wave) x (tile of sites, one
// partition); then every thread of the grid meets at
// cooperative_groups::this_grid().sync().  The barrier orders memory, so
// the next wave reads the rows this wave wrote.  It takes the place of
// the TPU kernel's single in-flight output slot and its sync-flag drain,
// which were correct only because the TPU's grid ran in order.  No thread
// returns early: every thread reaches every barrier.
//
// Bound.  Memory bandwidth: the same bytes per traversal as B1 (each
// entry writes one row; each inner child's row and scaler are read once,
// a tip child reads 1-byte codes): 2.73 ms for a real-size DNA traversal,
// 3.23 ms for a real-size amino-acid one, whose 5.5e10 flops take 0.82 ms
// at 67 TFLOP/s (chip_smoke.py's traversal_bytes / traversal_flops).
//
// Two bodies, chosen by K at compile time:
//
// * K <= 4 (DNA, binary): one thread per site of a 128-site item, every
//   value of the site in registers; the entry's two P blocks for the
//   item's partition staged in shared memory; an inner child's row read
//   with 16-byte loads; a tip child's indicator row, from the [C][K] table
//   in shared memory, contracted with P like an inner child (B2's own
//   formulation: R*K*K FMAs a site from registers and shared memory, where
//   the tip products would be R*K values read per site from device
//   memory).
// * K = 20 (amino acids): the item is a tile of B1's blocked body (128
//   sites in f32, 32 in f64) and runs through the same code
//   (newview_tile.cuh): a producer warp stages each item's inner-child
//   slabs, scalers and P, or a tip's codes and tip products, with bulk
//   copies into a two-stage ring that runs on across waves, so the next
//   item of the wave loads while this one computes; the consumers run
//   the register-blocked contraction, rescale from registers and write
//   through shared memory (the right child's x area).  The producer
//   fences the async proxy after each grid barrier, since the bulk copies
//   read rows other CTAs wrote with ordinary stores.  The first K = 20
//   body (one thread per site, rate by rate, 80-byte reads 320 bytes
//   apart, P read from shared memory for every FMA, a tip contracted
//   like an inner child, the parent row read back to rescale) ran at 0.26
//   of the bound.
//
// Measured (f32, real size, per traversal through whole_apply, the tip
// products included; NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phases
// 13 and 16): K = 20 4.57 ms against a 3.23 ms bound (tip products 0.12
// ms; 2.37 TB/s, 11.9 TFLOP/s), where the first K = 20 body took 12.30
// ms; K = 4 4.00 ms (bound 2.73), K = 2 0.60 ms (bound 0.36).  ptxas: the
// K = 20 body spills 28 bytes in f32 (96 registers), none in f64 (154).
//
// The arena and the scaler are read and written inside one launch, so
// they carry no __restrict__ / read-only-cache qualifiers: a row is read
// only after the barrier that follows its write.
//
// Interface: plain C, loaded with ctypes.  Every device pointer and the
// stream arrive as void*; `tips` is what the instance reads for a tip
// child: the [C][K] table at K <= 4, the tip products
// [E][2][M][C][R][K] at K = 20; the function launches with
// cudaLaunchCooperativeKernel on the given stream, does not synchronise,
// allocates nothing, writes the grid size (blocks) to *grid_out and
// returns the launch's error code (a refused cooperative launch included:
// there is no retry in another form).

#include <cooperative_groups.h>

#include "newview_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// -- K <= 4: one thread per site, every value in registers ------------------

// y[r*K + a] = sum_k P[(r*K + a)*K + k] * x[r*K + k]
template <typename T, int R, int K>
__device__ __forceinline__ void apply_p(const T* p, const T (&x)[R * K],
                                        T (&y)[R * K]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const T* pr = p + (r * K + a) * K;
      T acc = pr[0] * x[r * K];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = fma(pr[k], x[r * K + k], acc);
      y[r * K + a] = acc;
    }
  }
}

// One child of one site: y = P x, x the child's arena row (its scaler
// added to sc) or the tip's indicator row from the table, the same for
// every rate.
template <typename T, int R, int K>
__device__ __forceinline__ void child(
    const T* clv, const int32_t* scaler, const uint8_t* __restrict__ codes,
    const T* s_tab, const T* s_p, int is_tip, int row, int tip, size_t S,
    size_t site, T (&y)[R * K], int& sc) {
  constexpr int RK = R * K;
  T x[RK];
  if (is_tip) {
    const T* t = s_tab + (int)codes[(size_t)tip * S + site] * K;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) x[r * K + k] = t[k];
    }
  } else {
    load_vec<T, RK>(clv + ((size_t)row * S + site) * RK, x);
    sc += scaler[(size_t)row * S + site];
  }
  apply_p<T, R, K>(s_p, x, y);
}

template <typename T, int R, int K>
__global__ void newview_whole_kernel(
    T* clv, int32_t* scaler, const uint8_t* __restrict__ codes,
    const T* __restrict__ table, const int32_t* __restrict__ block_part,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ l_code,
    const int32_t* __restrict__ r_code,
    const int32_t* __restrict__ wave_start, const T* __restrict__ pmat,
    int nwaves, int B, int L, int M, int C, T minlik, T two_e) {
  constexpr int RK = R * K;
  constexpr int PN = R * K * K;               // per-rate P, one partition
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_p = reinterpret_cast<T*>(smem_raw);    // [2][PN]: left, right
  T* s_tab = s_p + 2 * PN;                    // [C][K]

  cg::grid_group grid = cg::this_grid();
  for (int i = threadIdx.x; i < C * K; i += blockDim.x) s_tab[i] = table[i];
  const int l = threadIdx.x;
  const bool active = l < L;
  const size_t S = (size_t)B * L;             // sites per arena row

  for (int w = 0; w < nwaves; ++w) {
    const int e0 = wave_start[w];
    const long long items = (long long)(wave_start[w + 1] - e0) * B;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int e = e0 + (int)(it / B);
      const int b = (int)(it % B);
      const int m = block_part[b];
      __syncthreads();                        // s_p of the last item read
      const T* g = pmat + (size_t)e * 2 * M * PN;
      for (int i = threadIdx.x; i < 2 * PN; i += blockDim.x) {
        const int side = i / PN;
        s_p[i] = g[((size_t)side * M + m) * PN + (i - side * PN)];
      }
      __syncthreads();
      if (active) {
        const int32_t* me = meta + (size_t)e * 8;
        const size_t site = (size_t)b * L + l;
        T yl[RK], yr[RK];
        int sc = 0;
        child<T, R, K>(clv, scaler, codes, s_tab, s_p, me[0], me[2],
                       l_code[e], S, site, yl, sc);
        child<T, R, K>(clv, scaler, codes, s_tab, s_p + PN, me[1], me[3],
                       r_code[e], S, site, yr, sc);
        T v[RK];
        T vmax = T(0);
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          v[j] = yl[j] * yr[j];
          const T a = fabs(v[j]);
          vmax = a > vmax ? a : vmax;
        }
        const bool needs = vmax < minlik;
        if (needs) {
#pragma unroll
          for (int j = 0; j < RK; ++j) v[j] *= two_e;
        }
        const size_t out = (size_t)me[4];
        store_vec<T, RK>(clv + (out * S + site) * RK, v);
        scaler[out * S + site] = sc + (needs ? 1 : 0);
      }
    }
    grid.sync();                              // wave w is written
  }
}

// -- K >= 16: staged tiles through the blocked body ------------------------

// Orders this thread's view of global memory (ordinary loads and stores,
// e.g. rows other CTAs wrote before a grid barrier) before its later bulk
// copies, which read through the async proxy.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// A work item is (entry of the wave, tile of TL sites): B1's blocked tile
// (a whole block and 16 consumer warps in f32, a quarter block and 8 in
// f64); two stages, each with room for either case of both children (a
// wave mixes tip cases).
template <typename T, int R, int K>
struct BlockedGeom {
  static constexpr int kTile = sizeof(T) == 8 ? 32 : 128;
  static constexpr int kStages = 2;
  static constexpr int kThreads =
      kTile * threads_per_site<T, R, K>() + 32;    // + producer warp
};

template <typename T, int R, int K>
__global__ void __launch_bounds__((BlockedGeom<T, R, K>::kThreads), 1)
    newview_whole_blocked_kernel(
        T* clv, int32_t* scaler, const uint8_t* __restrict__ codes,
        const T* __restrict__ u, const int32_t* __restrict__ block_part,
        const int32_t* __restrict__ meta,
        const int32_t* __restrict__ l_code,
        const int32_t* __restrict__ r_code,
        const int32_t* __restrict__ wave_start, const T* __restrict__ pmat,
        int nwaves, int B, int L, int M, int C, int TL, const Stage lay,
        T minlik, T two_e) {
  constexpr int PN = R * K * K;
  constexpr int kStages = BlockedGeom<T, R, K>::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + 128;
  const int consumers = TL * threads_per_site<T, R, K>();
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const size_t S = (size_t)B * L;             // sites per arena row
  const size_t UN = (size_t)C * R * K;        // tip products, one partition
  const int NT = B * (L / TL);                // tiles per entry
  const Role ro = blocked_role<T, R, K>(tid);
  // Items this CTA has taken over all waves: the ring position, the same
  // count on both sides of the ring.
  int i = 0;
  for (int w = 0; w < nwaves; ++w) {
    const int e0 = wave_start[w];
    const int n = wave_start[w + 1] - e0;
    if (tid >= consumers) {
      if (tid == consumers) {
        // Rows of earlier waves were written by ordinary stores; the bulk
        // copies read them through the async proxy.
        fence_proxy_async_global();
        for (Tile t(NT); t.w < n; t.advance(NT), ++i) {
          const int s = i % kStages;
          const int e = e0 + t.w;
          const int32_t* me = meta + (size_t)e * 8;
          const size_t site0 = (size_t)t.b * TL;
          const int m = block_part[site0 / L];
          const bool tip[2] = {me[0] != 0, me[1] != 0};
          const int rows[2] = {tip[0] ? l_code[e] : me[2],
                               tip[1] ? r_code[e] : me[3]};
          if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
          unsigned char* st = ring + (size_t)s * lay.bytes;
          mbar_arrive_expect_tx(&full[s], side_tx<T, R, K>(tip[0], TL, C) +
                                              side_tx<T, R, K>(tip[1], TL, C));
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const size_t g = ((size_t)e * 2 + side) * M + m;
            const size_t at = (size_t)rows[side] * S + site0;
            load_side<T, R, K>(st, lay.side[side], tip[side], codes + at,
                               u + g * UN, clv + at * R * K, scaler + at,
                               pmat + g * PN, TL, C, &full[s]);
          }
        }
      }
    } else {
      for (Tile t(NT); t.w < n; t.advance(NT), ++i) {
        const int s = i % kStages;
        const int32_t* me = meta + (size_t)(e0 + t.w) * 8;
        const size_t out = (size_t)me[4] * S + (size_t)t.b * TL;
        mbar_wait(&full[s], (i / kStages) & 1);
        unsigned char* st = ring + (size_t)s * lay.bytes;
        // The output goes through the right child's x area: its slab
        // (each warp overwrites only the rows it has read) or, for a tip,
        // an area the copies left empty.
        blocked_tile<T, R, K>(st, lay, me[0] != 0, me[1] != 0, ro, TL,
                              &empty[s],
                              reinterpret_cast<T*>(st + lay.side[1].x),
                              clv + out * R * K, scaler + out, minlik,
                              two_e);
      }
    }
    grid.sync();                              // wave w is written
  }
  __syncthreads();              // every stage consumed, every copy landed
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_inval(&full[s]);
      mbar_inval(&empty[s]);
    }
  }
}

template <typename T, int R, int K>
int launch(void* clv, void* scaler, const void* codes, const void* tips,
           const void* block_part, const void* meta, const void* l_code,
           const void* r_code, const void* wave_start, const void* pmat,
           int nwaves, int B, int L, int M, int C, double minlik,
           double two_e, void* stream, int* grid_out) {
  *grid_out = 0;
  if (L < 1 || L > 1024 || nwaves < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  int TL = 0;
  Stage lay{};
  size_t smem = 0;
  int threads = 0;
  const void* kern = nullptr;
  if constexpr (kBlocked<K>) {
    constexpr int kTile = BlockedGeom<T, R, K>::kTile;
    TL = L < kTile ? L : kTile;
    if (TL < 16 || TL % 16 || L % TL) return (int)cudaErrorInvalidValue;
    lay = stage_layout<T, R, K>(kEither, kEither, TL, C);
    smem = 128 + (size_t)BlockedGeom<T, R, K>::kStages * lay.bytes;
    threads = TL * threads_per_site<T, R, K>() + 32;
    kern = reinterpret_cast<const void*>(
        newview_whole_blocked_kernel<T, R, K>);
  } else {
    smem = (size_t)(2 * R * K * K + C * K) * sizeof(T);
    threads = L;
    kern = reinterpret_cast<const void*>(newview_whole_kernel<T, R, K>);
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(per_sm * sms);
  *grid_out = per_sm * sms;

  T* a_clv = static_cast<T*>(clv);
  int32_t* a_sc = static_cast<int32_t*>(scaler);
  const uint8_t* a_codes = static_cast<const uint8_t*>(codes);
  const T* a_tips = static_cast<const T*>(tips);
  const int32_t* a_bp = static_cast<const int32_t*>(block_part);
  const int32_t* a_meta = static_cast<const int32_t*>(meta);
  const int32_t* a_lc = static_cast<const int32_t*>(l_code);
  const int32_t* a_rc = static_cast<const int32_t*>(r_code);
  const int32_t* a_ws = static_cast<const int32_t*>(wave_start);
  const T* a_p = static_cast<const T*>(pmat);
  T a_minlik = static_cast<T>(minlik);
  T a_two_e = static_cast<T>(two_e);
  void* blocked_args[] = {&a_clv, &a_sc, &a_codes, &a_tips, &a_bp, &a_meta,
                          &a_lc, &a_rc, &a_ws, &a_p, &nwaves, &B, &L, &M,
                          &C, &TL, &lay, &a_minlik, &a_two_e};
  void* args[] = {&a_clv, &a_sc, &a_codes, &a_tips, &a_bp, &a_meta, &a_lc,
                  &a_rc, &a_ws, &a_p, &nwaves, &B, &L, &M, &C, &a_minlik,
                  &a_two_e};
  err = cudaLaunchCooperativeKernel(kern, grid, dim3(threads),
                                    kBlocked<K> ? blocked_args : args, smem,
                                    reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* clv, void* scaler, const void* codes, const void* tips,
             const void* block_part, const void* meta, const void* l_code,
             const void* r_code, const void* wave_start, const void* pmat,
             int nwaves, int B, int L, int M, int C, int R, int K,
             double minlik, double two_e, void* stream, int* grid_out) {
  if (R == 4 && K == 2)
    return launch<T, 4, 2>(clv, scaler, codes, tips, block_part, meta, l_code,
                           r_code, wave_start, pmat, nwaves, B, L, M, C,
                           minlik, two_e, stream, grid_out);
  if (R == 4 && K == 4)
    return launch<T, 4, 4>(clv, scaler, codes, tips, block_part, meta, l_code,
                           r_code, wave_start, pmat, nwaves, B, L, M, C,
                           minlik, two_e, stream, grid_out);
  if (R == 4 && K == 20)
    return launch<T, 4, 20>(clv, scaler, codes, tips, block_part, meta,
                            l_code, r_code, wave_start, pmat, nwaves, B, L,
                            M, C, minlik, two_e, stream, grid_out);
  *grid_out = 0;
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int examl_newview_whole_f32(void* clv, void* scaler, const void* codes,
                            const void* tips, const void* block_part,
                            const void* meta, const void* l_code,
                            const void* r_code, const void* wave_start,
                            const void* pmat, int nwaves, int B, int L,
                            int M, int C, int R, int K, double minlik,
                            double two_e, void* stream, int* grid_out) {
  return dispatch<float>(clv, scaler, codes, tips, block_part, meta,
                         l_code, r_code, wave_start, pmat, nwaves, B, L, M, C,
                         R, K, minlik, two_e, stream, grid_out);
}

int examl_newview_whole_f64(void* clv, void* scaler, const void* codes,
                            const void* tips, const void* block_part,
                            const void* meta, const void* l_code,
                            const void* r_code, const void* wave_start,
                            const void* pmat, int nwaves, int B, int L,
                            int M, int C, int R, int K, double minlik,
                            double two_e, void* stream, int* grid_out) {
  return dispatch<double>(clv, scaler, codes, tips, block_part, meta,
                          l_code, r_code, wave_start, pmat, nwaves, B, L, M,
                          C, R, K, minlik, two_e, stream, grid_out);
}

}  // extern "C"
