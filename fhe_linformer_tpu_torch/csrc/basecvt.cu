// K3: fused RNS digit fold + fast base conversion on the int8 tensor cores
// (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of the JAX package's ops/basecvt.py
// (entry `base_convert`) and keeps its arithmetic.  For every digit j (a
// group of alpha source limbs), target prime p and coefficient c:
//
//   y[j, b, p, c] = sum_{t < alpha} w[b, j alpha + t, c]
//                                   * conv[j alpha + t, p]  mod p,
//   w = x * fold mod q_t (skipped when prefolded)
//
// Each folded w < 2^30 splits into four balanced base-256 digits
// w = d0 + 2^8 d1 + 2^16 d2 + 2^24 d3 with d0..d2 in [-128, 128) and
// 0 <= d3 <= 64; the four bytes of (w + 0x808080) ^ 0x808080 are exactly
// those digits as s8.  The conversion matrix is expanded on the host to
// C[p, t, e2] = conv[t, p] 2^(8 e2) mod p and split the same way into four s8
// planes C_e (`plane_fragments` in ops/basecvt.py, `BCTables.planes`).  Then
//   P_e[p, c] = sum_{t, e2} C_e[p, t, e2] d_e2(w[t, c])
// is an s8 x s8 -> s32 product with contraction 4 alpha, exact since
// |P_e| <= 128^2 4 alpha < 2^22, and y = P0 + 2^8 P1 + 2^16 P2 + 2^24 P3
// mod p.  The epilogue pairs the planes (p01 = P0 + 256 P1 and p23 =
// P2 + 256 P3, |p01| < 2^30 for alpha <= 63), adds bias (the least
// multiple of p >= 2^30, so the sum is a positive u32), and reduces:
//   y = (p01 + bias) mod p  +  (p23 + bias) 2^16 mod p   (two Shoup steps).
// Unlike the JAX matrix (block-diagonal over all G = nd alpha sources, two
// thirds zeros at nd = 3), each digit is its own product over its alpha
// sources.
//
// What bounds it on the H100: at the decomposition's main shape (B = 4,
// 59 sources, 3 x 79 outputs per coefficient) it moves 4 (59 + 237) bytes
// per coefficient.  Its products are 2 (4 x 79)(4 x 20) int8 operations per
// coefficient and digit, about 0.010 ms at 1,979e12/s against 0.046 ms for
// the bytes at 3.35 TB/s, so memory bounds it once the products leave the
// CUDA cores, whose 64 integer multiplies per clock per SM could not do the
// 32-bit version in under 0.075 ms.
//
// Design: mma.sync.m16n8k32 s8 x s8 -> s32.  One block per (tile of 256
// coefficients, digit j, batch row b); 8 warps, each 32 coefficients (four
// n-tiles of 8).  The digit's A fragments, laid out on the host in the exact
// register order of the instruction (`BCTables.planes`: row block of 8
// targets, plane pair, k-step, lane, 4 words), are copied to shared memory
// once per block and read as one 16-byte load per lane.  An m-tile's 16
// rows are 8 targets of plane 2h (rows 0-7) and of plane 2h + 1 (rows 8-15),
// so each thread's accumulator registers hold P_2h and P_2h+1 of the same
// target and coefficients, and the epilogue needs no exchange.  K is
// ordered t * 4 + e2: a B fragment register is the four digits of one w,
// loaded (coalesced, 32 bytes per source row per 8 lanes), folded and split
// in registers, so w never leaves the registers.  Outputs go out as 8-byte
// stores, every 32-byte sector whole.  A block walks several tiles when
// the grid would otherwise exceed four waves.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as unsigned; returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;                       // n-tiles of 8 per warp
constexpr int kTile = kWarps * kNT * 8;      // coefficients per block tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// KS = ceil(alpha / 8) k-steps of 32 (8 sources x 4 digits each).
template <int KS>
__global__ void __launch_bounds__(kThreads)
base_convert_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                    const uint4* __restrict__ planes,
                    const uint32_t* __restrict__ rowc,
                    const uint32_t* __restrict__ fold,
                    const uint32_t* __restrict__ fold_s,
                    const uint32_t* __restrict__ gq, int batch, int g_valid,
                    int alpha, int tgt, int n, int tiles_per_block,
                    int prefolded) {
  extern __shared__ uint4 s_planes[];        // (RB, 2, KS, 32) fragments
  const int rbs = (tgt + 7) / 8;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int nfrag = rbs * 2 * KS * 32;
  const uint4* src = planes + static_cast<size_t>(j) * nfrag;
  for (int i = threadIdx.x; i < nfrag; i += kThreads) s_planes[i] = src[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;                 // B column / C row of the lane
  const int tig = lane & 3;
  const uint32_t* xb = x + static_cast<size_t>(b) * g_valid * n;
  uint32_t* yb = y + (static_cast<size_t>(j) * batch + b) * tgt * n;

  for (int it = 0; it < tiles_per_block; ++it) {
    const int tile = (blockIdx.x * tiles_per_block + it) * kTile;
    if (tile >= n) break;
    const int c0 = tile + warp * (kNT * 8);

    // B fragments: register (s, h) of n-tile nt holds the four digits of
    // w[j alpha + 8s + 4h + tig] at coefficient c0 + 8 nt + gid
    uint32_t bf[KS][2][kNT];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 8 * s + 4 * h + tig;
        const int g = j * alpha + t;
        const bool live = t < alpha && g < g_valid;
        const uint32_t* xs = xb + static_cast<size_t>(g) * n + c0 + gid;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          bf[s][h][nt] = live ? __ldcs(xs + 8 * nt) : 0u;
        if (live && !prefolded) {
          const uint32_t f = fold[g], fs = fold_s[g], qg = gq[g];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            bf[s][h][nt] = shoup_mul(bf[s][h][nt], f, fs, qg);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          bf[s][h][nt] = (bf[s][h][nt] + 0x808080u) ^ 0x808080u;
      }
    }

    for (int rb = 0; rb < rbs; ++rb) {
      int acc[2][kNT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][nt][i] = 0;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 af = s_planes[((rb * 2 + h) * KS + s) * 32 + lane];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma_s8(acc[h][nt], af, bf[s][0][nt], bf[s][1][nt]);
        }
      }
      const int p = rb * 8 + gid;
      if (p >= tgt) continue;
      const uint32_t q = rowc[p];
      const uint32_t bias = rowc[tgt + p];
      const uint32_t sh1 = rowc[2 * tgt + p];
      const uint32_t p16 = rowc[3 * tgt + p];
      const uint32_t p16s = rowc[4 * tgt + p];
      uint32_t* yp = yb + static_cast<size_t>(p) * n + c0 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p01 = acc[0][nt][e] + 256 * acc[0][nt][2 + e];
          const int p23 = acc[1][nt][e] + 256 * acc[1][nt][2 + e];
          const uint32_t x01 = static_cast<uint32_t>(p01) + bias;
          const uint32_t x23 = static_cast<uint32_t>(p23) + bias;
          out[e] = add_mod(shoup_mul(x01, 1u, sh1, q),
                           shoup_mul(x23, p16, p16s, q), q);
        }
        __stcs(reinterpret_cast<uint2*>(yp + 8 * nt),
               make_uint2(out[0], out[1]));
      }
    }
  }
}

template <int KS>
cudaError_t launch(const void* x, void* y, const void* planes,
                   const void* rowc, const void* fold, const void* fold_s,
                   const void* gq, int batch, int g_valid, int nd, int alpha,
                   int tgt, int n, int prefolded, cudaStream_t stream) {
  static int sms = 0;
  static int smem_set = 0;
  const int smem =
      ((tgt + 7) / 8) * 2 * KS * 32 * static_cast<int>(sizeof(uint4));
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(base_convert_kernel<KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (sms == 0) {
    int dev;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int per_sm;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, base_convert_kernel<KS>, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorLaunchOutOfResources;
  const int tiles = n / kTile;
  const long long jobs = static_cast<long long>(tiles) * nd * batch;
  long long per = jobs / (4LL * sms * per_sm);
  const int tpb = per < 1 ? 1 : (per > tiles ? tiles : static_cast<int>(per));
  const dim3 grid((tiles + tpb - 1) / tpb, nd, batch);
  base_convert_kernel<KS><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint4*>(planes), static_cast<const uint32_t*>(rowc),
      static_cast<const uint32_t*>(fold), static_cast<const uint32_t*>(fold_s),
      static_cast<const uint32_t*>(gq), batch, g_valid, alpha, tgt, n, tpb,
      prefolded);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (batch, g_valid, n); y: (nd, batch, tgt, n); planes: (nd, ceil(tgt/8),
// 2, ceil(alpha/8), 32, 4) words; rowc: (5, tgt) q, bias, sh1, p16, p16_s.
int base_convert(const void* x, void* y, const void* planes, const void* rowc,
                 const void* fold, const void* fold_s, const void* gq,
                 int batch, int g_valid, int nd, int alpha, int tgt, int n,
                 int prefolded, void* stream) {
  if (n % kTile != 0 || alpha < 1 || alpha > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define BC_CASE(K)                                                          \
  case K:                                                                   \
    return static_cast<int>(launch<K>(x, y, planes, rowc, fold, fold_s, gq, \
                                      batch, g_valid, nd, alpha, tgt, n,    \
                                      prefolded, s));
  switch ((alpha + 7) / 8) {
    BC_CASE(1)
    BC_CASE(2)
    BC_CASE(3)
    BC_CASE(4)
    BC_CASE(5)
    BC_CASE(6)
    BC_CASE(7)
    BC_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BC_CASE
}

}  // extern "C"
