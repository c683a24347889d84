// K1 / K2: negacyclic NTT and inverse NTT of RNS residue rows (sm_90a).
//
// Replaces the Pallas kernels `_fwd_kernel` and `_inv_kernel` of the JAX
// package's ops/ntt_pallas.py (entries `fwd` and `inv`), which run the
// transform as a four-step pair of int8 digit-plane matmuls on the TPU's
// matrix unit.  Here both are butterfly networks on the CUDA cores: an exact
// NTT with the same psi and output order is unique, so the results are
// bit-identical.  Forward: Cooley-Tukey from natural order, the natural-order
// evaluations X[k] = x(psi^(2k+1)) out.  Inverse: Gentleman-Sande from the
// bit-reversed load, coefficient order out, times n^-1.  Every value stays
// canonical (< q).
//
// What bounds them on the H100: a 2^15 row is 128 KB in and 128 KB out,
// against 15 x 2^14 Shoup butterflies (3 32-bit multiplies each).  At the
// card's 64 integer multiplies per clock per SM that is under half the
// time the bytes take, so memory bounds both, provided no intermediate
// leaves the SM and the SM never sits waiting on a load.
//
// K1 (`ntt_fwd_kernel`), register-resident radix-32 phases, two blocks per
// row.  After the first stage (pairs at distance n/2) the two halves of a
// row are independent transforms of n/2 points, so block c of a row's pair
// computes stage 1 for its half straight from the loads (it reads both
// halves of the row; its partner's read of the same row hits L2) and then
// the n/2-point rest.  Thread tid of the n/64 threads holds 32 elements of
// the half in registers, and the remaining log2(n) - 1 stages run as three
// phases, each a radix-32 (or smaller) network in registers with no
// barrier:
//   phase 1  elements tid + (n/64)k: log2(n) - 11 stages,
//   phase 2  elements 1024 warp + lane + 32k: 5 stages (distances 512 .. 32),
//   phase 3  elements 32g + k with g = bitrev(tid): 5 stages (16 .. 1).
// In the half's own terms, stage group i of a stage with m groups takes the
// table's twiddle (2 + c) m + i.  Two shared-memory exchanges sit between
// the phases, both free of bank conflicts: the first writes each element
// back where the thread held it and reads 32 consecutive words per warp;
// the second stores 32-word line `line` at 32 line + (line >> (log2 n -
// 11)), a skew of up to 31 words that puts the lines phase 3 reads together
// in different banks.  Every exchange address is a per-thread base plus a
// constant, so none of them holds a register (an XOR swizzle would need
// 32).  Giving phase 3 the group g = bitrev(tid) makes the final bit
// reversal a store with neighbouring lanes on neighbouring evaluations:
// element 32g + k of half c lands at X[2 (bitrev5(k) n/64 + tid) + c] (the
// partner block fills the other word of each pair).  The phase 1-2 twiddles
// (n/64 entries, 4 KB at 2^15) sit in shared memory and are read as
// warp-wide broadcasts; each thread loads its own 31 phase-3 twiddles once,
// as 16-byte vectors, a few at a time (32 of the 64 registers hold data).
// Three block barriers per half row.
//
// Overlap: a block takes 512 threads x 64 registers at 2^15, half the
// register file, so two blocks (two half rows) run on each SM and one
// computes while the other waits on its loads or at a barrier.  Blocks go
// prime by prime (`RowMap`), so the rows of one prime share its twiddle
// table in L2.
//
// Rows: a limb map (D, L) names the basis index of each row of the limb
// axis, per entry of the leading axis, so the D digits of a key-switch
// decomposition go in one launch; a negative entry skips its rows (their
// output rows are left unwritten).  y must not alias x: both blocks of a
// row read all of it.
//
// K2 (`ntt_inv_kernel`), one block per row, the row in shared memory across
// all stages, radix 2.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as uint32; each entry returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

__device__ __forceinline__ int bitrev(int k, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logn));
}

__host__ __device__ constexpr int brev5(int k) {
  return ((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) |
         ((k & 16) >> 4);
}

__device__ __forceinline__ void butterfly(uint32_t& x, uint32_t& y,
                                          uint32_t w, uint32_t ws,
                                          uint32_t q) {
  const uint32_t u = x;
  const uint32_t v = shoup_mul(y, w, ws, q);
  x = add_mod(u, v, q);
  y = sub_mod(u, v, q);
}

// Keeps the compiler from hoisting the next twiddle loads above this
// point, so a stage's twiddles arrive four at a time: 32 of the thread's
// 64 registers hold data.
__device__ __forceinline__ void twiddle_fence() {
  asm volatile("" ::: "memory");
}

// Stage S (0..4) of a radix-32 phase on a thread's registers: a[k] pairs
// with a[k + (16 >> S)], and twiddle j = k >> (5 - S) of the stage is
// (w[j], ws[j]), read from shared memory (the same address across a warp)
// four at a time.
template <int S>
__device__ __forceinline__ void stage_shared(uint32_t (&a)[32],
                                             const uint32_t* w,
                                             const uint32_t* ws, uint32_t q) {
  constexpr int HK = 16 >> S;
#pragma unroll
  for (int j = 0; j < (1 << S); ++j) {
    if (j % 4 == 0) twiddle_fence();
    const uint32_t wj = w[j], sj = ws[j];
#pragma unroll
    for (int kk = 0; kk < HK; ++kk)
      butterfly(a[2 * HK * j + kk], a[2 * HK * j + kk + HK], wj, sj, q);
  }
}

// The same stage with the thread's own 2^S twiddles, contiguous in device
// memory, loaded once (16-byte vectors from S = 2 on).
template <int S>
__device__ __forceinline__ void stage_global(uint32_t (&a)[32],
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ ws,
                                             uint32_t q) {
  constexpr int HK = 16 >> S;
  constexpr int NJ = 1 << S;
  if constexpr (NJ < 4) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t wj = __ldg(w + j), sj = __ldg(ws + j);
#pragma unroll
      for (int kk = 0; kk < HK; ++kk)
        butterfly(a[2 * HK * j + kk], a[2 * HK * j + kk + HK], wj, sj, q);
    }
  } else {
#pragma unroll
    for (int c = 0; c < NJ / 4; ++c) {
      twiddle_fence();
      const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(w) + c);
      const uint4 s4 = __ldg(reinterpret_cast<const uint4*>(ws) + c);
      const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const uint32_t sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * c + jj;
#pragma unroll
        for (int kk = 0; kk < HK; ++kk)
          butterfly(a[2 * HK * j + kk], a[2 * HK * j + kk + HK], wv[jj],
                    sv[jj], q);
      }
    }
  }
}

// Rows (D, M, L) in work order: prime by prime (limb-axis position l
// outermost), so the D * M rows that share a prime's twiddle table run on
// neighbouring blocks at about the same time and read it from L2.
struct RowMap {
  const int32_t* limbs;  // (D, L) basis index per limb-axis position
  int D, M, L;
  int work;              // D * M * L

  __device__ int row(int i) const { return (i % (D * M)) * L + i / (D * M); }
  __device__ int limb(int i) const {
    return limbs[(i % (D * M)) / M * L + i / (D * M)];
  }
};

template <int LOGN>
__global__ void __launch_bounds__((1 << LOGN) / 64, 1024 / ((1 << LOGN) / 64))
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               RowMap map, const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tws) {
  constexpr int N = 1 << LOGN;
  constexpr int H = N / 2;            // the block's half row
  constexpr int T = H / 32;           // threads; thread tid owns column tid
  constexpr int S1 = LOGN - 11;       // stages of phase 1
  constexpr int SKEW = LOGN - 11;     // line >> SKEW: the line's skew
  constexpr int M3 = H / 32;          // stage groups at phase 3's first stage
  extern __shared__ uint32_t smem[];
  uint32_t* buf = smem;               // both exchanges: H + 32 words
  uint32_t* s_w = smem + H + 32;      // s_w[m + i] = w[(2 + c) m + i]
  uint32_t* s_ws = s_w + T;
  const int c = blockIdx.x & 1;
  const int item = blockIdx.x >> 1;
  const int limb_i = map.limb(item);
  if (limb_i < 0) return;
  const size_t limb = static_cast<size_t>(limb_i);
  const uint32_t q = qs[limb];
  const uint32_t* w = tw + limb * N;
  const uint32_t* ws = tws + limb * N;
  const uint32_t* src = x + static_cast<size_t>(map.row(item)) * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = bitrev(tid, LOGN - 6);  // phase 3: coefficients 32g .. 32g+31
  if (tid > 0) {
    const int m = 1 << (31 - __clz(tid));
    s_w[tid] = __ldg(w + tid + (1 + c) * m);
    s_ws[tid] = __ldg(ws + tid + (1 + c) * m);
  }

  // stage 1: a = x[p] +- w[1] x[p + n/2] for the half's positions p
  uint32_t a[32];
  {
    const uint32_t w1 = __ldg(w + 1), s1 = __ldg(ws + 1);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t u = __ldcs(src + tid + T * k);
      const uint32_t v = shoup_mul(__ldcs(src + H + tid + T * k), w1, s1, q);
      a[k] = c ? sub_mod(u, v, q) : add_mod(u, v, q);
    }
  }
  __syncthreads();                                       // barrier 1

  // phase 1
  if constexpr (S1 > 0) stage_shared<0>(a, s_w + 1, s_ws + 1, q);
  if constexpr (S1 > 1) stage_shared<1>(a, s_w + 2, s_ws + 2, q);
  if constexpr (S1 > 2) stage_shared<2>(a, s_w + 4, s_ws + 4, q);
  if constexpr (S1 > 3) stage_shared<3>(a, s_w + 8, s_ws + 8, q);

  // exchange 1: to 1024-element blocks, one per warp
#pragma unroll
  for (int k = 0; k < 32; ++k) buf[tid + T * k] = a[k];
  __syncthreads();                                       // barrier 2
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = buf[1024 * warp + lane + 32 * k];

  // phase 2
  stage_shared<0>(a, s_w + (1 << S1) + warp, s_ws + (1 << S1) + warp, q);
  stage_shared<1>(a, s_w + (2 << S1) + (warp << 1),
                  s_ws + (2 << S1) + (warp << 1), q);
  stage_shared<2>(a, s_w + (4 << S1) + (warp << 2),
                  s_ws + (4 << S1) + (warp << 2), q);
  stage_shared<3>(a, s_w + (8 << S1) + (warp << 3),
                  s_ws + (8 << S1) + (warp << 3), q);
  stage_shared<4>(a, s_w + (16 << S1) + (warp << 4),
                  s_ws + (16 << S1) + (warp << 4), q);

  // exchange 2: skewed 32-word lines (only this warp read its lines)
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int line = 32 * warp + k;
    buf[32 * line + lane + (line >> SKEW)] = a[k];
  }
  __syncthreads();                                       // barrier 3
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = buf[32 * g + (g >> SKEW) + k];

  // phase 3
  const int b3 = (2 + c) * M3 + g;    // stage s: twiddles (b3 << s) + j
  stage_global<0>(a, w + b3, ws + b3, q);
  stage_global<1>(a, w + (b3 << 1), ws + (b3 << 1), q);
  stage_global<2>(a, w + (b3 << 2), ws + (b3 << 2), q);
  stage_global<3>(a, w + (b3 << 3), ws + (b3 << 3), q);
  stage_global<4>(a, w + (b3 << 4), ws + (b3 << 4), q);

  uint32_t* dst = y + static_cast<size_t>(map.row(item)) * N + c;
#pragma unroll
  for (int k = 0; k < 32; ++k) dst[2 * (brev5(k) * T + tid)] = a[k];
}

template <int LOGN>
cudaError_t launch_fwd(const uint32_t* x, uint32_t* y, const RowMap& map,
                       const uint32_t* qs, const uint32_t* tw,
                       const uint32_t* tws, cudaStream_t stream) {
  constexpr int T = (1 << LOGN) / 64;
  constexpr int smem =
      static_cast<int>(sizeof(uint32_t)) * ((1 << LOGN) / 2 + 32 + 2 * T);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_fwd_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  ntt_fwd_kernel<LOGN><<<2 * map.work, T, smem, stream>>>(x, y, map, qs, tw,
                                                           tws);
  return cudaGetLastError();
}

// Gentleman-Sande, natural-order evaluations loaded bit-reversed,
// coefficient order out, times n^-1.
__global__ void __launch_bounds__(1024)
ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               const int32_t* __restrict__ row_limb,
               const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ itw,
               const uint32_t* __restrict__ itws,
               const uint32_t* __restrict__ ninv,
               const uint32_t* __restrict__ ninv_s, int logn) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = row_limb[row];
  const uint32_t q = qs[limb];
  const uint32_t* w = itw + static_cast<size_t>(limb) * n;
  const uint32_t* ws = itws + static_cast<size_t>(limb) * n;
  const uint32_t* src = x + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) a[bitrev(k, logn)] = src[k];
  __syncthreads();
  for (int logt = 0; logt < logn; ++logt) {
    const int t = 1 << logt;
    const int m = half >> logt;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> logt;
      const int idx = (i << (logt + 1)) + (k & (t - 1));
      const uint32_t u = a[idx];
      const uint32_t v = a[idx + t];
      a[idx] = add_mod(u, v, q);
      a[idx + t] = shoup_mul(sub_mod(u, v, q), w[m + i], ws[m + i], q);
    }
    __syncthreads();
  }
  const uint32_t s = ninv[limb];
  const uint32_t ss = ninv_s[limb];
  uint32_t* dst = y + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = shoup_mul(a[k], s, ss, q);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int logn, size_t* smem, int* threads) {
  *smem = sizeof(uint32_t) << logn;
  *threads = (1 << (logn - 1)) < 1024 ? (1 << (logn - 1)) : 1024;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

extern "C" {

// x, y: (D, M, L, 2^logn) rows; limb_map: (D, L) int32, < 0 skips a row.
int ntt_forward(const void* x, void* y, const void* limb_map, int D, int M,
                int L, int logn, const void* qs, const void* tw,
                const void* tws, void* stream) {
  const RowMap map{static_cast<const int32_t*>(limb_map), D, M, L, D * M * L};
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* yo = static_cast<uint32_t*>(y);
  const auto* q = static_cast<const uint32_t*>(qs);
  const auto* w = static_cast<const uint32_t*>(tw);
  const auto* ws = static_cast<const uint32_t*>(tws);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (logn) {
    case 11: return static_cast<int>(launch_fwd<11>(xi, yo, map, q, w, ws, s));
    case 12: return static_cast<int>(launch_fwd<12>(xi, yo, map, q, w, ws, s));
    case 13: return static_cast<int>(launch_fwd<13>(xi, yo, map, q, w, ws, s));
    case 14: return static_cast<int>(launch_fwd<14>(xi, yo, map, q, w, ws, s));
    case 15: return static_cast<int>(launch_fwd<15>(xi, yo, map, q, w, ws, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ntt_inverse(const void* x, void* y, const void* row_limb, int rows,
                int logn, const void* qs, const void* itw, const void* itws,
                const void* ninv, const void* ninv_s, void* stream) {
  size_t smem;
  int threads;
  cudaError_t e = prepare(ntt_inv_kernel, logn, &smem, &threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  ntt_inv_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const int32_t*>(row_limb), static_cast<const uint32_t*>(qs),
      static_cast<const uint32_t*>(itw), static_cast<const uint32_t*>(itws),
      static_cast<const uint32_t*>(ninv), static_cast<const uint32_t*>(ninv_s),
      logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
