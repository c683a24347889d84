// K3: fused RNS digit fold + fast base conversion (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of the JAX package's ops/basecvt.py
// (entry `base_convert`), which splits the folded operand into int8 digit
// planes for the TPU's matrix unit.  For every digit j (a group of alpha
// source limbs), target prime p and coefficient c:
//
//   y[j, b, p, c] = sum_{t in group j} (x[b, t, c] * fold[t] mod q_t)
//                   * conv[t, p]  mod p
//
// (with prefolded != 0 the fold is skipped: the mod-down hands in the
// already-folded w).  Both versions return canonical residues, so the
// outputs are bit-identical; the TPU's convp/bias/sh1/p16 planes have no
// counterpart here.
//
// What bounds it on the H100: at the decomposition's shape (59 source rows,
// nd x tgt = 3 x 79 output rows) each coefficient moves 59 + 237 words
// (1184 bytes) and needs 59 x 79 32x32->64-bit products, about 8 32-bit
// multiplies per byte against the card's ~10 (33.5e12 multiplies/s over
// 3.35 TB/s): the two nearly balance and memory sets the floor, so the
// kernel must read and write every residue exactly once, keep the
// products out of device memory, and not waste issue slots on division.
// Design: one thread per coefficient
// column, the grid over (N / 256, batch) so loads and stores coalesce along
// N; the thread folds its alpha source residues of one digit into registers
// once (read once from device memory), then for each target prime sums the
// alpha products in a 64-bit accumulator, reducing (64-bit Barrett by
// floor(2^64/p)) at least every 15 terms since 15 * 2^60 < 2^64.  The
// conversion matrix (G x tgt) and the target primes sit in shared memory,
// read as warp-wide broadcasts.
//
// C interface (loaded with ctypes): pointers to int32 / int64 tensors
// reinterpreted as unsigned; returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t hi = __umulhi(a, ws);
  const uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

// x mod p for any 64-bit x, with m = floor(2^64 / p): the quotient
// estimate undershoots by at most 1, so one conditional subtract is enough.
__device__ __forceinline__ uint64_t reduce64(uint64_t x, uint32_t p,
                                             uint64_t m) {
  uint64_t r = x - __umul64hi(x, m) * p;
  return r >= p ? r - p : r;
}

__global__ void __launch_bounds__(kThreads)
base_convert_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ fold,
                    const uint32_t* __restrict__ fold_s,
                    const uint32_t* __restrict__ gq,
                    const uint32_t* __restrict__ conv,
                    const uint32_t* __restrict__ qt,
                    const uint64_t* __restrict__ qt_inv, int batch,
                    int g_valid, int nd, int alpha, int tgt, int n,
                    int prefolded) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_m = smem;                                   // (tgt,)
  uint32_t* s_q = reinterpret_cast<uint32_t*>(s_m + tgt);  // (tgt,)
  uint32_t* s_conv = s_q + tgt;                           // (G, tgt)
  const int G = nd * alpha;
  for (int i = threadIdx.x; i < G * tgt; i += blockDim.x) s_conv[i] = conv[i];
  for (int i = threadIdx.x; i < tgt; i += blockDim.x) {
    s_q[i] = qt[i];
    s_m[i] = qt_inv[i];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= n) return;
  const uint32_t* xb = x + static_cast<size_t>(b) * g_valid * n + c;
  for (int j = 0; j < nd; ++j) {
    uint32_t w[kMaxAlpha];
#pragma unroll
    for (int t = 0; t < kMaxAlpha; ++t) {
      const int g = j * alpha + t;
      uint32_t v = 0;
      if (t < alpha && g < g_valid) {           // rows past g_valid are zero
        v = xb[static_cast<size_t>(g) * n];
        if (!prefolded) v = shoup_mul(v, fold[g], fold_s[g], gq[g]);
      }
      w[t] = v;
    }
    const uint32_t* cj = s_conv + static_cast<size_t>(j) * alpha * tgt;
    uint32_t* yj = y + (static_cast<size_t>(j) * batch + b) * tgt * n + c;
    for (int p = 0; p < tgt; ++p) {
      const uint32_t qp = s_q[p];
      const uint64_t mp = s_m[p];
      uint64_t acc = 0;
#pragma unroll
      for (int t = 0; t < kMaxAlpha; ++t) {
        if (t < alpha) {
          acc += static_cast<uint64_t>(w[t]) * cj[t * tgt + p];
          if (t % 15 == 14) acc = reduce64(acc, qp, mp);
        }
      }
      yj[static_cast<size_t>(p) * n] = static_cast<uint32_t>(reduce64(acc, qp, mp));
    }
  }
}

}  // namespace

extern "C" {

int base_convert(const void* x, void* y, const void* fold, const void* fold_s,
                 const void* gq, const void* conv, const void* qt,
                 const void* qt_inv, int batch, int g_valid, int nd,
                 int alpha, int tgt, int n, int prefolded, void* stream) {
  if (alpha > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tgt) * (sizeof(uint64_t) + sizeof(uint32_t)) +
                      static_cast<size_t>(nd) * alpha * tgt * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      base_convert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  base_convert_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(fold), static_cast<const uint32_t*>(fold_s),
      static_cast<const uint32_t*>(gq), static_cast<const uint32_t*>(conv),
      static_cast<const uint32_t*>(qt), static_cast<const uint64_t*>(qt_inv),
      batch, g_valid, nd, alpha, tgt, n, prefolded);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
