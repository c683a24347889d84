// K1 / K2: negacyclic NTT and inverse NTT of RNS residue rows (sm_90a).
//
// Replaces the Pallas kernels `_fwd_kernel` and `_inv_kernel` of the JAX
// package's ops/ntt_pallas.py (entries `fwd` and `inv`), which run
// the transform as a four-step pair of int8 digit-plane matmuls on the TPU's
// matrix unit.  This first Hopper version is a radix-2 butterfly network
// instead: an exact NTT with the same psi and output order is unique, so
// the results are bit-identical.
//
// What bounds it on the H100: a 2^15 row is 128 KB read and 128 KB written,
// against 15 stages x 2^14 Shoup butterflies (3 32-bit multiplies each), so
// at the key switch's shape the card's memory rate bounds it, provided no
// intermediate leaves the SM.  Design: one thread block per (batch, limb)
// row, the whole row held in dynamic shared memory across all log2(n)
// stages, so device memory sees the row once in and once out; only the
// twiddles (bit-reversed psi powers, one table row per prime, mostly L2
// hits) are read per stage.  The bit-reversal is folded into the store
// (forward) or the load (inverse), so the forward writes the natural order
// X[k] = x(psi^(2k+1)) and the inverse writes coefficient order; n^-1 is
// applied at the inverse's store.  Every value stays canonical (< q).
// Rows longer than 2^15 (256 KB) exceed a block's 227 KB of shared memory;
// the Python wrapper refuses them.  The int8 tensor-core four-step is later
// speed work.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as uint32; each entry returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t hi = __umulhi(a, ws);
  const uint32_t r = a * w - hi * q;       // in [0, 2q), exact mod 2^32
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t r = a + b;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

__device__ __forceinline__ int bitrev(int k, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logn));
}

// Cooley-Tukey, natural-order input, bit-reversed order in shared memory,
// natural-order evaluations out.
__global__ void __launch_bounds__(1024)
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               const int32_t* __restrict__ row_limb,
               const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tws, int logn) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = row_limb[row];
  const uint32_t q = qs[limb];
  const uint32_t* w = tw + static_cast<size_t>(limb) * n;
  const uint32_t* ws = tws + static_cast<size_t>(limb) * n;
  const uint32_t* src = x + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = src[i];
  __syncthreads();
  for (int logt = logn - 1; logt >= 0; --logt) {
    const int t = 1 << logt;
    const int m = half >> logt;              // butterfly groups this stage
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> logt;
      const int idx = (i << (logt + 1)) + (k & (t - 1));
      const uint32_t u = a[idx];
      const uint32_t v = shoup_mul(a[idx + t], w[m + i], ws[m + i], q);
      a[idx] = add_mod(u, v, q);
      a[idx + t] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
  uint32_t* dst = y + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = a[bitrev(k, logn)];
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

int ntt_forward(const void* x, void* y, const void* row_limb, int rows,
                int logn, const void* qs, const void* tw, const void* tws,
                void* stream) {
  size_t smem;
  int threads;
  cudaError_t e = prepare(ntt_fwd_kernel, logn, &smem, &threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  ntt_fwd_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const int32_t*>(row_limb), static_cast<const uint32_t*>(qs),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      logn);
  return static_cast<int>(cudaGetLastError());
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
