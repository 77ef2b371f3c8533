// Whole-traversal kernel (B2) for Hopper, sm_90a.
//
// Replaces examl_tpu/ops/pallas_whole.py::_kernel (launched there by
// run_flat_arrays over the schedule of build_flat).  One launch runs a
// whole full traversal.  Entries come in dependency-wave order; entry e
// writes CLV arena row w_row (= e) and its scaler row in place:
//
//   child:  x[r][k] = table[code][k] for a tip (the same for every rate r),
//           or the child's arena row l_row / r_row for an inner node
//   y[r][a] = sum_k P[e][side][part(b)][r][a][k] * x[r][k]
//   v = yl * yr;  where max|v| < 2^-E:  v *= 2^E and the scaler adds 1;
//   scaler = scaler(left) + scaler(right) + that increment.
//
// Design.  One cooperative, persistent grid: the host sizes it to the
// number of blocks that can be resident at once (occupancy x SM count),
// so a grid-wide barrier is legal.  For each wave, the blocks stride over
// the wave's work items, (entry of the wave) x (site block b of L lanes,
// one partition), one thread per site; then every thread of the grid
// meets at cooperative_groups::this_grid().sync().  The barrier orders
// memory, so the next wave reads the rows this wave wrote.  It takes the
// place of the TPU kernel's single in-flight output slot and its
// sync-flag drain, which were correct only because the TPU's grid ran in
// order.  No thread returns early: every thread reaches every barrier.
//
// A tip child expands its 1-byte code through the indicator table (kept
// in shared memory) and is contracted with P like an inner child: B2's
// own formulation, done as a lookup plus FMAs instead of a one-hot
// product, so a traversal's only operands are its P matrices.  The
// entry's two P blocks for the item's partition are staged in shared
// memory.  A child row (R*K contiguous values per site) is read with
// 16-byte vector loads, and the parent row is written the same way.
//
// Bound.  Memory bandwidth: the same bytes per traversal as B1 (each
// entry writes one row; each inner child's row and scaler are read once,
// a tip child reads 1-byte codes), against 2*R*K*K flops per child and
// site, far below the card's ops-per-byte balance.  The point of this
// kernel is one launch per traversal instead of ~1,000 small launches
// (B1's chunk program left the card idle for most of a traversal).  This
// first design is simple and right; cp.async staging of child rows and
// wider tiles per thread are later work.
//
// Instances: (R, K) = (4, 2), (4, 4) and (4, 20), f32 and f64 (GAMMA over
// binary, DNA and amino-acid data).  For K <= 4 a thread holds its site's
// R*K values of x, yl, yr and v in registers.  At K = 20 that is 320
// values, over the 255 registers a thread may have in f32 and far over in
// f64, so the amino-acid body (`site_by_rate`) goes rate by rate: one
// rate's x and product v (2K values) at a time, each rate's v written to
// the parent row as it is done, the site's max over all R*K values kept,
// and a site under 2^-E rescaled afterwards from its own row.  Compiling
// with -DEXAML_WHOLE_RK_IN_REGISTERS keeps the register body at K = 20 too
// (for comparing the compiler's spill report only).
//
// The arena and the scaler are read and written inside one launch, so
// they carry no __restrict__ / read-only-cache qualifiers: a row is read
// only after the barrier that follows its write.
//
// Interface: plain C, loaded with ctypes.  Every device pointer and the
// stream arrive as void*; the function launches with
// cudaLaunchCooperativeKernel on the given stream, does not synchronise,
// allocates nothing, writes the grid size (blocks) to *grid_out and
// returns the launch's error code (a refused cooperative launch included:
// there is no retry in another form).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void unpack(const float4& u, float* d) {
  d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
}
__device__ __forceinline__ void unpack(const double2& u, double* d) {
  d[0] = u.x; d[1] = u.y;
}
__device__ __forceinline__ float4 pack4(const float* d) {
  return make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ double2 pack4(const double* d) {
  return make_double2(d[0], d[1]);
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// N contiguous values of one site's row, by 16-byte accesses where the row
// length allows it (the wrapper checks that the arena base is 16-byte
// aligned; every row is then a multiple of 16 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&dst)[N]) {
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
__device__ __forceinline__ void store_row(T* dst, const T (&src)[N]) {
  constexpr int per = 16 / sizeof(T);
  if constexpr (N % per == 0) {
    using V = typename Vec16<T>::type;
    V* d = reinterpret_cast<V*>(dst);
#pragma unroll
    for (int i = 0; i < N / per; ++i) d[i] = pack4(src + i * per);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

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

// One child of one site: y = P x, and its scaler added to sc.
template <typename T, int R, int K>
__device__ __forceinline__ void child(
    const T* clv, const int32_t* scaler, const uint8_t* __restrict__ codes,
    const T* s_tab, const T* s_p, int is_tip, int row, int tip,
    size_t S, size_t site, T (&y)[R * K], int& sc) {
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
    load_row<T, RK>(clv + ((size_t)row * S + site) * RK, x);
    sc += scaler[(size_t)row * S + site];
  }
  apply_p<T, R, K>(s_p, x, y);
}

// One rate of one child of one site: y[a] = sum_k P_r[a][k] * x[k] with x
// the child's K values of rate r (a tip's indicator row is the same for
// every rate); with MUL the result multiplies into y instead.
template <typename T, int K, bool MUL>
__device__ __forceinline__ void child_rate(const T* pr, const T (&x)[K],
                                           T (&y)[K]) {
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const T* row = pr + a * K;
    T acc = row[0] * x[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = fma(row[k], x[k], acc);
    if constexpr (MUL)
      y[a] *= acc;
    else
      y[a] = acc;
  }
}

// The child's K values of rate r: its arena row's slice, or the tip's
// indicator row.
template <typename T, int R, int K>
__device__ __forceinline__ void child_x(const T* clv, const T* s_tab,
                                        const uint8_t* __restrict__ codes,
                                        int is_tip, int row, int tip,
                                        size_t S, size_t site, int r,
                                        T (&x)[K]) {
  if (is_tip) {
    load_row<T, K>(s_tab + (int)codes[(size_t)tip * S + site] * K, x);
  } else {
    load_row<T, K>(clv + ((size_t)row * S + site) * (R * K) + r * K, x);
  }
}

// Whether a site's R*K values stay in registers (the DNA and binary
// body) or go rate by rate (amino acids: R*K = 80 values a child would
// hold x, yl, yr and v, over 255 registers in f32 and far more in f64).
template <typename T, int R, int K>
constexpr bool kByRate =
#ifdef EXAML_WHOLE_RK_IN_REGISTERS
    false;
#else
    K >= 16;
#endif

// One entry at one site, every value in registers (R*K small: DNA and
// binary data).  me = the entry's meta row (l_tip, r_tip, l_row, r_row,
// w_row, ...).
template <typename T, int R, int K>
__device__ __forceinline__ void site_in_registers(
    T* clv, int32_t* scaler, const uint8_t* __restrict__ codes,
    const T* s_tab, const T* s_p, const int32_t* __restrict__ me, int lc,
    int rc, size_t S, size_t site, T minlik, T two_e) {
  constexpr int RK = R * K;
  constexpr int PN = R * K * K;
  T yl[RK], yr[RK];
  int sc = 0;
  child<T, R, K>(clv, scaler, codes, s_tab, s_p, me[0], me[2], lc, S, site,
                 yl, sc);
  child<T, R, K>(clv, scaler, codes, s_tab, s_p + PN, me[1], me[3], rc, S,
                 site, yr, sc);
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
  store_row<T, RK>(clv + (out * S + site) * RK, v);
  scaler[out * S + site] = sc + (needs ? 1 : 0);
}

// One entry at one site, rate by rate (amino acids): y(left) * y(right)
// of rate r is written to the parent row at once and the site's max taken
// over all R*K values; a site under 2^-E then rescales its own row in a
// second pass (reading back what this thread wrote), so the rule and the
// values stay the plain version's while a thread holds one rate's x and
// v (2K values) at a time.
template <typename T, int R, int K>
__device__ __forceinline__ void site_by_rate(
    T* clv, int32_t* scaler, const uint8_t* __restrict__ codes,
    const T* s_tab, const T* s_p, const int32_t* __restrict__ me, int lc,
    int rc, size_t S, size_t site, T minlik, T two_e) {
  constexpr int PN = R * K * K;
  T* o = clv + ((size_t)me[4] * S + site) * (R * K);
  T vmax = T(0);
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    T x[K], v[K];
    child_x<T, R, K>(clv, s_tab, codes, me[0], me[2], lc, S, site, r, x);
    child_rate<T, K, false>(s_p + r * K * K, x, v);
    child_x<T, R, K>(clv, s_tab, codes, me[1], me[3], rc, S, site, r, x);
    child_rate<T, K, true>(s_p + PN + r * K * K, x, v);
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const T u = fabs(v[a]);
      vmax = u > vmax ? u : vmax;
    }
    store_row<T, K>(o + r * K, v);
  }
  int sc = (me[0] ? 0 : scaler[(size_t)me[2] * S + site]) +
           (me[1] ? 0 : scaler[(size_t)me[3] * S + site]);
  if (vmax < minlik) {
    ++sc;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      T v[K];
      load_row<T, K>(o + r * K, v);
#pragma unroll
      for (int a = 0; a < K; ++a) v[a] *= two_e;
      store_row<T, K>(o + r * K, v);
    }
  }
  scaler[(size_t)me[4] * S + site] = sc;
}

template <typename T, int R, int K>
__global__ void newview_whole_kernel(
    T* clv, int32_t* scaler, const uint8_t* __restrict__ codes,
    const T* __restrict__ table, const int32_t* __restrict__ block_part,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ l_code,
    const int32_t* __restrict__ r_code,
    const int32_t* __restrict__ wave_start, const T* __restrict__ pmat,
    int nwaves, int B, int L, int M, int C, T minlik, T two_e) {
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
        if constexpr (kByRate<T, R, K>)
          site_by_rate<T, R, K>(clv, scaler, codes, s_tab, s_p, me,
                                l_code[e], r_code[e], S, site, minlik,
                                two_e);
        else
          site_in_registers<T, R, K>(clv, scaler, codes, s_tab, s_p, me,
                                     l_code[e], r_code[e], S, site, minlik,
                                     two_e);
      }
    }
    grid.sync();                              // wave w is written
  }
}

template <typename T, int R, int K>
int launch(void* clv, void* scaler, const void* codes, const void* table,
           const void* block_part, const void* meta, const void* l_code,
           const void* r_code, const void* wave_start, const void* pmat,
           int nwaves, int B, int L, int M, int C, double minlik,
           double two_e, void* stream, int* grid_out) {
  *grid_out = 0;
  const size_t smem = (size_t)(2 * R * K * K + C * K) * sizeof(T);
  if (smem > 48 * 1024 || L < 1 || L > 1024 || nwaves < 1)
    return (int)cudaErrorInvalidValue;
  auto kern = newview_whole_kernel<T, R, K>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, L,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(per_sm * sms);
  const dim3 block(L);
  *grid_out = per_sm * sms;

  T* a_clv = static_cast<T*>(clv);
  int32_t* a_sc = static_cast<int32_t*>(scaler);
  const uint8_t* a_codes = static_cast<const uint8_t*>(codes);
  const T* a_tab = static_cast<const T*>(table);
  const int32_t* a_bp = static_cast<const int32_t*>(block_part);
  const int32_t* a_meta = static_cast<const int32_t*>(meta);
  const int32_t* a_lc = static_cast<const int32_t*>(l_code);
  const int32_t* a_rc = static_cast<const int32_t*>(r_code);
  const int32_t* a_ws = static_cast<const int32_t*>(wave_start);
  const T* a_p = static_cast<const T*>(pmat);
  T a_minlik = static_cast<T>(minlik);
  T a_two_e = static_cast<T>(two_e);
  void* args[] = {&a_clv, &a_sc, &a_codes, &a_tab, &a_bp, &a_meta, &a_lc,
                  &a_rc, &a_ws, &a_p, &nwaves, &B, &L, &M, &C, &a_minlik,
                  &a_two_e};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    grid, block, args, smem,
                                    reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* clv, void* scaler, const void* codes, const void* table,
             const void* block_part, const void* meta, const void* l_code,
             const void* r_code, const void* wave_start, const void* pmat,
             int nwaves, int B, int L, int M, int C, int R, int K,
             double minlik, double two_e, void* stream, int* grid_out) {
  if (R == 4 && K == 2)
    return launch<T, 4, 2>(clv, scaler, codes, table, block_part, meta,
                           l_code, r_code, wave_start, pmat, nwaves, B, L,
                           M, C, minlik, two_e, stream, grid_out);
  if (R == 4 && K == 4)
    return launch<T, 4, 4>(clv, scaler, codes, table, block_part, meta,
                           l_code, r_code, wave_start, pmat, nwaves, B, L,
                           M, C, minlik, two_e, stream, grid_out);
  if (R == 4 && K == 20)
    return launch<T, 4, 20>(clv, scaler, codes, table, block_part, meta,
                            l_code, r_code, wave_start, pmat, nwaves, B, L,
                            M, C, minlik, two_e, stream, grid_out);
  *grid_out = 0;
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int examl_newview_whole_f32(void* clv, void* scaler, const void* codes,
                            const void* table, const void* block_part,
                            const void* meta, const void* l_code,
                            const void* r_code, const void* wave_start,
                            const void* pmat, int nwaves, int B, int L,
                            int M, int C, int R, int K, double minlik,
                            double two_e, void* stream, int* grid_out) {
  return dispatch<float>(clv, scaler, codes, table, block_part, meta, l_code,
                         r_code, wave_start, pmat, nwaves, B, L, M, C, R, K,
                         minlik, two_e, stream, grid_out);
}

int examl_newview_whole_f64(void* clv, void* scaler, const void* codes,
                            const void* table, const void* block_part,
                            const void* meta, const void* l_code,
                            const void* r_code, const void* wave_start,
                            const void* pmat, int nwaves, int B, int L,
                            int M, int C, int R, int K, double minlik,
                            double two_e, void* stream, int* grid_out) {
  return dispatch<double>(clv, scaler, codes, table, block_part, meta,
                          l_code, r_code, wave_start, pmat, nwaves, B, L, M,
                          C, R, K, minlik, two_e, stream, grid_out);
}

}  // extern "C"
