// K5: the key switch's mod-down passes between K2, K3 and K1 (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these passes to XLA's
// fused int64 elementwise code, which the port first ran as chains of
// plain torch ops (casts, int64 products, int64 remainders, the overflow's
// partial sums, compares and selects, about thirty launches a mod-down).
// The mod-down divides x over Q_l * P by P, rounded:
//
//   vp = INTT(x's k special rows)                          (K2)
//   md_fold:   w_t = vp_t * (P/p_t)^-1 mod p_t, and the overflow
//              v = round(sum_t w_t / p_t) in the fixed point below
//   y = sum_t w_t * (P/p_t) mod q_i                        (K3, prefolded)
//   md_lift:   y_i = y_i - v * [P]_{q_i} mod q_i, in place
//   y_e = NTT(y)                                           (K1)
//   md_finish: out_i = (x_i - y_e_i) * [P^-1]_{q_i} mod q_i (+ an addend)
//
// on canonical residues (every value below its prime, each prime < 2^30),
// with csrc/modarith.cuh's Shoup multiplies by per-prime constants: no
// 64-bit division is left.
//
// The overflow v equals the plain version's (`ops/moddown.md_overflow`)
// bit for bit.  With m_t = round(2^40 / p_t) < 2^16 and a_t = (w_t mod
// 2^16) m_t < 2^32, the exact integer sums al = sum_t (a_t mod 2^16) (below
// k 2^16 < 2^24) and ahbb = sum_t floor(a_t / 2^16) + floor(w_t / 2^16) m_t
// (below k 2^30, about 2^35) are converted to float32 with round to nearest
// (al exactly, ahbb rounded), scaled by 2^-40 and 2^-24, added once and
// rounded half to even.  Both scalings are by powers of two far from the
// float32 range's ends, so both products are exact: a fused multiply-add of
// either product into the sum rounds the same exact value once, as the
// separate add does, so contraction could not change v (the source spells
// the add as __fadd_rn all the same).
//
// What bounds it on the H100: bytes.  Per coefficient column and ciphertext
// half, md_fold reads k rows and writes k + 1, md_lift reads 1 + nl and
// writes nl, md_finish reads 2 nl (3 nl with an addend) and writes nl, all
// 4 bytes a residue: 164 + 20 nl bytes at k = 20 (fold 164, lift 8 nl + 4,
// finish 12 nl), against 2-5 32-bit multiplies per residue, far below the
// card's integer rate at 3.35 TB/s.  The torch chain moved about 15 times
// those bytes through int64 temporaries.
//
// Design: a thread owns 4 neighbouring coefficients of one ciphertext
// half, loaded and stored as 16-byte vectors (coalesced, streaming: each
// residue is touched once).  md_fold's threads walk the k special rows,
// keeping the two partial sums in registers, and write w and v; md_lift
// and md_finish give each row its own blocks, reading the per-row
// constants once a thread.  md_finish reads x's Q rows in place through
// their entry stride (a limb slice of the extended tensor), and the
// optional addend of each half (the c0 or d0 / d1 term the caller adds to
// the mod-down's output) in the same pass.  Batch entries beyond the grid's
// z extent are walked in a loop.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as unsigned; each entry point returns cudaGetLastError() after its
// launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec;       // coefficients per block
constexpr int kMaxZ = 65535;                 // grid z extent

__device__ __forceinline__ void load4(const uint32_t* p, uint32_t v[kVec]) {
  const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t v[kVec]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
}

// vp, w: (batch, k, n); v: (batch, 1, n).  Block (x, b): 512 columns of
// entry b.
__global__ void __launch_bounds__(kThreads)
md_fold_kernel(const uint32_t* __restrict__ vp, uint32_t* __restrict__ w,
               uint32_t* __restrict__ v, const uint32_t* __restrict__ p,
               const uint32_t* __restrict__ pf,
               const uint32_t* __restrict__ pf_s,
               const long long* __restrict__ mdq40, int batch, int k,
               int n) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const size_t base = static_cast<size_t>(b) * k * n + c;
    uint32_t al[kVec] = {0, 0, 0, 0};
    unsigned long long ah[kVec] = {0, 0, 0, 0};
#pragma unroll 4
    for (int t = 0; t < k; ++t) {
      const uint32_t pt = p[t], f = pf[t], fs = pf_s[t];
      const uint32_t m = static_cast<uint32_t>(mdq40[t]);
      uint32_t x[kVec], wt[kVec];
      load4(vp + base + static_cast<size_t>(t) * n, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        wt[e] = shoup_mul(x[e], f, fs, pt);
        const uint32_t a = (wt[e] & 0xFFFFu) * m;          // < 2^32
        al[e] += a & 0xFFFFu;
        ah[e] += (a >> 16) +
                 static_cast<unsigned long long>(wt[e] >> 16) * m;
      }
      store4(w + base + static_cast<size_t>(t) * n, wt);
    }
    uint32_t out[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float s = __fadd_rn(
          __fmul_rn(__ll2float_rn(static_cast<long long>(al[e])), 0x1p-40f),
          __fmul_rn(__ll2float_rn(static_cast<long long>(ah[e])), 0x1p-24f));
      out[e] = static_cast<uint32_t>(rintf(s));
    }
    store4(v + static_cast<size_t>(b) * n + c, out);
  }
}

// y: (batch, nl, n) in place; v: (batch, 1, n).  Block (x, i, b): 512
// columns of row i of entry b.
__global__ void __launch_bounds__(kThreads)
md_lift_kernel(uint32_t* __restrict__ y, const uint32_t* __restrict__ v,
               const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ pm,
               const uint32_t* __restrict__ pm_s, int batch, int nl,
               int n) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  const int i = blockIdx.y;
  const uint32_t qi = q[i], m = pm[i], ms = pm_s[i];
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    uint32_t vv[kVec], yv[kVec];
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(
        v + static_cast<size_t>(b) * n + c));     // re-read by nl rows: L2
    vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
    uint32_t* yr = y + (static_cast<size_t>(b) * nl + i) * n + c;
    load4(yr, yv);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      yv[e] = sub_mod(yv[e], shoup_mul(vv[e], m, ms, qi), qi);
    store4(yr, yv);
  }
}

// x: entries x_es apart, rows n apart (its first nl rows are read); ye:
// (batch, nl, n); out: entries out_es apart.  Entry b is (o, h, j) of an
// (outer, 2, inner) split of the batch: half h adds addend h's entry
// o * inner + j (entries add_es[h] apart) when that addend is given.
__global__ void __launch_bounds__(kThreads)
md_finish_kernel(const uint32_t* __restrict__ x, long long x_es,
                 const uint32_t* __restrict__ ye, uint32_t* __restrict__ out,
                 long long out_es, const uint32_t* __restrict__ add0,
                 const uint32_t* __restrict__ add1, long long add_es0,
                 long long add_es1, long long inner,
                 const uint32_t* __restrict__ q,
                 const uint32_t* __restrict__ pinv,
                 const uint32_t* __restrict__ pinv_s, int batch, int nl,
                 int n) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  const int i = blockIdx.y;
  const uint32_t qi = q[i], pi = pinv[i], pis = pinv_s[i];
  const size_t row = static_cast<size_t>(i) * n + c;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    uint32_t xv[kVec], yv[kVec];
    load4(x + b * x_es + row, xv);
    load4(ye + static_cast<size_t>(b) * nl * n + row, yv);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      xv[e] = shoup_mul(sub_mod(xv[e], yv[e], qi), pi, pis, qi);
    const long long h = (b / inner) & 1;
    const uint32_t* add = h ? add1 : add0;
    if (add != nullptr) {
      const long long a = (b / (2 * inner)) * inner + b % inner;
      uint32_t av[kVec];
      load4(add + a * (h ? add_es1 : add_es0) + row, av);
#pragma unroll
      for (int e = 0; e < kVec; ++e) xv[e] = add_mod(av[e], xv[e], qi);
    }
    store4(out + b * out_es + row, xv);
  }
}

dim3 grid(int n, int rows, int batch) {
  return dim3((n + kTile - 1) / kTile, rows, batch < kMaxZ ? batch : kMaxZ);
}

}  // namespace

extern "C" {

// Every pointer 16-byte aligned, n and every entry stride multiples of 4;
// per-prime constants as (rows,) int32 arrays (mdq40 int64).
int md_fold(const void* vp, void* w, void* v, const void* p, const void* pf,
            const void* pf_s, const void* mdq40, int batch, int k, int n,
            void* stream) {
  if (batch < 1 || k < 1 || k > 256 || n % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g((n + kTile - 1) / kTile, batch < kMaxZ ? batch : kMaxZ);
  md_fold_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vp), static_cast<uint32_t*>(w),
      static_cast<uint32_t*>(v), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(pf), static_cast<const uint32_t*>(pf_s),
      static_cast<const long long*>(mdq40), batch, k, n);
  return static_cast<int>(cudaGetLastError());
}

int md_lift(void* y, const void* v, const void* q, const void* pm,
            const void* pm_s, int batch, int nl, int n, void* stream) {
  if (batch < 1 || nl < 1 || nl > 65535 || n % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  md_lift_kernel<<<grid(n, nl, batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(y), static_cast<const uint32_t*>(v),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(pm),
      static_cast<const uint32_t*>(pm_s), batch, nl, n);
  return static_cast<int>(cudaGetLastError());
}

int md_finish(const void* x, long long x_es, const void* ye, void* out,
              long long out_es, const void* add0, const void* add1,
              long long add_es0, long long add_es1, long long inner,
              const void* q, const void* pinv, const void* pinv_s, int batch,
              int nl, int n, void* stream) {
  if (batch < 1 || nl < 1 || nl > 65535 || n % kVec != 0 || inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  md_finish_kernel<<<grid(n, nl, batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), x_es,
      static_cast<const uint32_t*>(ye), static_cast<uint32_t*>(out), out_es,
      static_cast<const uint32_t*>(add0), static_cast<const uint32_t*>(add1),
      add_es0, add_es1, inner, static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(pinv),
      static_cast<const uint32_t*>(pinv_s), batch, nl, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
