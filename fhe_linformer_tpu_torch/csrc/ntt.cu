// K1 / K2: negacyclic NTT and inverse NTT of RNS residue rows (sm_90a).
//
// Replace the Pallas kernels `_fwd_kernel` and `_inv_kernel` of the JAX
// package's ops/ntt_pallas.py (entries `fwd` and `inv`), which run the
// transform as a four-step pair of int8 digit-plane matmuls on the TPU's
// matrix unit.  Here both are butterfly networks on the CUDA cores: an exact
// NTT with the same psi and output order is unique, so the results are
// bit-identical.  Forward: Cooley-Tukey from natural order, the natural-order
// evaluations X[k] = x(psi^(2k+1)) out.  Inverse: Gentleman-Sande from the
// bit-reversed order, coefficient order out, times n^-1.  Every value stays
// canonical (< q).
//
// What bounds them on the H100: a 2^15 row is 128 KB in and 128 KB out,
// against 15 x 2^14 Shoup butterflies (3 32-bit multiplies each).  At the
// card's 64 integer multiplies per clock per SM that is under half the
// time the bytes take, so memory bounds both, provided no intermediate
// leaves the SM and the SM never sits waiting on a load.  Both kernels
// therefore keep a row on chip from load to store, in registers between
// two shared-memory exchanges, and run two blocks per SM so that one
// computes while the other waits.
//
// Shared shape: a row's two halves (H = n/2 points) go to two 512-thread
// blocks (at 2^15; n/64 threads in general).  Thread tid holds 32
// elements of its block's half in registers, and the half's log2(n) - 1
// stages run as three phases, each a radix-32 (or smaller) network in
// registers with no barrier:
//   phase 1  elements tid + (n/64)k: log2(n) - 11 stages (distances H/2 ..
//            1024),
//   phase 2  elements 1024 warp + lane + 32k: 5 stages (512 .. 32),
//   phase 3  elements 32g + k with g = bitrev(tid): 5 stages (16 .. 1).
// In the half's own terms, stage group i of a stage with m groups takes the
// table's twiddle (2 + c) m + i.  The exchanges between the phases go
// through shared memory at address p + ((p >> 5) >> (log2 n - 11)) for
// element p: a skew of up to 31 words that is the same across a warp in
// phases 1 and 2 (consecutive words) and differs across a warp in phase 3,
// so no exchange has a bank conflict; each address is a per-thread base
// plus a constant, so none holds a register (an XOR swizzle would need
// 32).  A phase-2 warp reads and writes only its own 1024 elements, so
// between the phase-2 exchange's read and its write a __syncwarp is
// enough.  Giving phase 3 the group g = bitrev(tid) makes the row's bit
// reversal a global access with neighbouring lanes on neighbouring
// words: element 32g + k of half c is word 2 (bitrev5(k) n/64 + tid) + c of
// the natural-order evaluations.  The phase 1-2 twiddles (n/64 entries,
// 4 KB at 2^15) sit in shared memory and are read as warp-wide broadcasts;
// each thread loads its own 31 phase-3 twiddles once, as 16-byte vectors,
// a few at a time (32 of the 64 registers hold data).
//
// K1 (`ntt_fwd_kernel`).  After the first stage (pairs at distance n/2)
// the two halves are independent, so block c computes stage 1 for its
// half straight from the loads (it reads both halves of the row; its
// partner's read of the same row hits L2), then phases 1, 2 and 3, and
// stores the evaluations of parity c.  Three block barriers.
//
// K2 (`ntt_inv_kernel`), the transpose.  Gentleman-Sande from the
// bit-reversed order keeps the even evaluations in half 0 and the odd
// ones in half 1 until the last stage, so block c loads the evaluations
// of parity c (the pattern K1 stores) and runs phases 3, 2, 1 with the
// inverse butterflies; only the last stage (distance n/2) pairs the
// halves.  The row's two blocks are a thread block cluster of 2: each
// writes the 16 elements per thread that its partner finishes into its
// own shared memory (at addresses the same thread read, so no barrier
// first), `cluster.sync()`, and reads the partner's words through
// distributed shared memory.  Block c then writes outputs p of its quarter
// and p + n/2:  y[p] = (u + v) n^-1,  y[p + n/2] = (u - v) w1 n^-1, with
// n^-1 and w1 n^-1 as per-prime Shoup constants (w1 the last stage's
// twiddle).  A second `cluster.sync()` keeps a block's shared memory alive
// until its partner has read it.  Two block barriers, two cluster
// barriers.  The source rows may be strided: `entry_stride` elements
// between the (L, n) entries of the leading axis, so a limb slice such as
// the rescale's top limb is read in place.
//
// Overlap: a block takes 512 threads x 64 registers at 2^15, half the
// register file, so two blocks (two half rows) run on each SM.  At 2^16
// (1024 threads, phase 1 five stages, skew 5, 139 KB of shared memory) a
// block takes the whole register file: one block per SM, whose loads
// nothing else hides.  Blocks go prime by prime (`RowMap`), so the rows of
// one prime share its twiddle table in L2.
//
// Rows: a limb map (D, L) names the basis index of each row of the limb
// axis, per entry of the leading axis, so the D digits of a key-switch
// decomposition go in one launch; a negative entry skips its rows (their
// output rows are left unwritten).  y must not alias x: both blocks of a
// row read it.
//
// Rings below 2^11 (the test-scale presets, 2^8) are too short for that
// layout (n/64 threads, at least one warp): `ntt_fwd_kernel_small` and
// `ntt_inv_kernel_small` take one block of n/2 threads per row, the row in
// shared memory, one radix-2 stage per barrier -- the plain versions'
// stages exactly, with the same row map and strided K2 sources.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as uint32; each entry returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int bitrev(int k, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logn));
}

__host__ __device__ constexpr int brev5(int k) {
  return ((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) |
         ((k & 16) >> 4);
}

// Cooley-Tukey (INV false): x, y = x + w y, x - w y.
// Gentleman-Sande (INV true): x, y = x + y, (x - y) w.
template <bool INV>
__device__ __forceinline__ void butterfly(uint32_t& x, uint32_t& y,
                                          uint32_t w, uint32_t ws,
                                          uint32_t q) {
  const uint32_t u = x;
  if constexpr (INV) {
    const uint32_t v = y;
    x = add_mod(u, v, q);
    y = shoup_mul(u + q - v, w, ws, q);   // a lazy input below 2q
  } else {
    const uint32_t v = shoup_mul(y, w, ws, q);
    x = add_mod(u, v, q);
    y = sub_mod(u, v, q);
  }
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
template <int S, bool INV>
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
      butterfly<INV>(a[2 * HK * j + kk], a[2 * HK * j + kk + HK], wj, sj, q);
  }
}

// The same stage with the thread's own 2^S twiddles, contiguous in device
// memory, loaded once (16-byte vectors from S = 2 on).
template <int S, bool INV>
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
        butterfly<INV>(a[2 * HK * j + kk], a[2 * HK * j + kk + HK], wj, sj,
                       q);
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
          butterfly<INV>(a[2 * HK * j + kk], a[2 * HK * j + kk + HK], wv[jj],
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

  __device__ int entry(int i) const { return i % (D * M); }
  __device__ int pos(int i) const { return i / (D * M); }
  __device__ int row(int i) const { return entry(i) * L + pos(i); }
  __device__ int limb(int i) const {
    return limbs[entry(i) / M * L + pos(i)];
  }
};

// The pieces of the block layout both kernels share (see the header).
template <int LOGN>
struct Half {
  static constexpr int N = 1 << LOGN;
  static constexpr int H = N / 2;          // the block's half row
  static constexpr int T = H / 32;         // threads
  static constexpr int S1 = LOGN - 11;     // stages of phase 1
  static constexpr int SKEW = LOGN - 11;   // line >> SKEW: the line's skew
  static constexpr int M3 = H / 32;        // groups at phase 3's first stage
  // buf (H + 32 words), then the phase 1-2 twiddles s_w, s_ws (T each)
  static constexpr int SMEM = static_cast<int>(sizeof(uint32_t)) *
                              (H + 32 + 2 * T);

  // Word of element 1024 warp + lane + 32 k (phase 2; line 32 warp + k at
  // 32 line + lane + (line >> SKEW)) as a per-warp base plus a constant:
  // 32 warp is a multiple of 2^SKEW.  Written this way, the compiler need
  // not keep 32 addresses live from an exchange's read across phase 2 to
  // the write at the same words.
  static __device__ int line_base(int warp, int lane) {
    return 1024 * warp + lane + (warp << (5 - SKEW));
  }
  static __host__ __device__ constexpr int line_off(int k) {
    return 32 * k + (k >> SKEW);
  }

  // s_w[m + i] = w[(2 + c) m + i] for the m < T groups of phases 1-2
  static __device__ void load_twiddles(uint32_t* s_w, uint32_t* s_ws,
                                       const uint32_t* w, const uint32_t* ws,
                                       int c, int tid) {
    if (tid > 0) {
      const int m = 1 << (31 - __clz(tid));
      s_w[tid] = __ldg(w + tid + (1 + c) * m);
      s_ws[tid] = __ldg(ws + tid + (1 + c) * m);
    }
  }
};

template <int LOGN>
__global__ void __launch_bounds__((1 << LOGN) / 64, 1024 / ((1 << LOGN) / 64))
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               RowMap map, const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tws) {
  using B = Half<LOGN>;
  constexpr int N = B::N, H = B::H, T = B::T, S1 = B::S1, SKEW = B::SKEW;
  extern __shared__ uint32_t smem[];
  uint32_t* buf = smem;
  uint32_t* s_w = smem + H + 32;
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
  B::load_twiddles(s_w, s_ws, w, ws, c, tid);

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
  if constexpr (S1 > 0) stage_shared<0, false>(a, s_w + 1, s_ws + 1, q);
  if constexpr (S1 > 1) stage_shared<1, false>(a, s_w + 2, s_ws + 2, q);
  if constexpr (S1 > 2) stage_shared<2, false>(a, s_w + 4, s_ws + 4, q);
  if constexpr (S1 > 3) stage_shared<3, false>(a, s_w + 8, s_ws + 8, q);
  if constexpr (S1 > 4) stage_shared<4, false>(a, s_w + 16, s_ws + 16, q);

  // exchange 1: element tid + T k (line warp + (T / 32) k, skew k) to its
  // warp of phase 2
#pragma unroll
  for (int k = 0; k < 32; ++k) buf[tid + (T + 1) * k] = a[k];
  __syncthreads();                                       // barrier 2
  const int l2 = B::line_base(warp, lane);
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = buf[l2 + B::line_off(k)];

  // phase 2
  stage_shared<0, false>(a, s_w + (1 << S1) + warp, s_ws + (1 << S1) + warp,
                         q);
  stage_shared<1, false>(a, s_w + (2 << S1) + (warp << 1),
                         s_ws + (2 << S1) + (warp << 1), q);
  stage_shared<2, false>(a, s_w + (4 << S1) + (warp << 2),
                         s_ws + (4 << S1) + (warp << 2), q);
  stage_shared<3, false>(a, s_w + (8 << S1) + (warp << 3),
                         s_ws + (8 << S1) + (warp << 3), q);
  stage_shared<4, false>(a, s_w + (16 << S1) + (warp << 4),
                         s_ws + (16 << S1) + (warp << 4), q);

  // exchange 2: back to the words this warp read, then to phase 3
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 32; ++k) buf[l2 + B::line_off(k)] = a[k];
  __syncthreads();                                       // barrier 3
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = buf[32 * g + (g >> SKEW) + k];

  // phase 3
  const int b3 = (2 + c) * B::M3 + g;  // stage s: twiddles (b3 << s) + j
  stage_global<0, false>(a, w + b3, ws + b3, q);
  stage_global<1, false>(a, w + (b3 << 1), ws + (b3 << 1), q);
  stage_global<2, false>(a, w + (b3 << 2), ws + (b3 << 2), q);
  stage_global<3, false>(a, w + (b3 << 3), ws + (b3 << 3), q);
  stage_global<4, false>(a, w + (b3 << 4), ws + (b3 << 4), q);

  uint32_t* dst = y + static_cast<size_t>(map.row(item)) * N + c;
#pragma unroll
  for (int k = 0; k < 32; ++k) dst[2 * (brev5(k) * T + tid)] = a[k];
}

// K2's hand-over before the last stage: block C keeps elements tid + T k
// for k in [16 C, 16 C + 16) and gives the other 16 to its partner, each
// at the address this thread read it from in exchange 2 (k < 16 there).
template <int C, int T>
__device__ __forceinline__ void give(const uint32_t (&a)[32], uint32_t* buf,
                                     int tid) {
#pragma unroll
  for (int k = 0; k < 16; ++k) buf[tid + (T + 1) * k] = a[16 * (1 - C) + k];
}

// The last stage for block C's positions p = tid + T k, k in [16 C,
// 16 C + 16): u from half 0, v from half 1 (the partner's words `peer`).
template <int C, int T>
__device__ __forceinline__ void last_stage(const uint32_t (&a)[32],
                                           const uint32_t* peer,
                                           uint32_t* dst, int tid,
                                           uint32_t s0, uint32_t s0s,
                                           uint32_t s1, uint32_t s1s,
                                           uint32_t q) {
  constexpr int H = 32 * T;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t own = a[16 * C + k];
    const uint32_t other = peer[tid + (T + 1) * k];
    const uint32_t u = C ? other : own;
    const uint32_t v = C ? own : other;
    const int p = tid + T * (16 * C + k);
    dst[p] = shoup_mul(u + v, s0, s0s, q);              // lazy: below 2q
    dst[p + H] = shoup_mul(u + q - v, s1, s1s, q);
  }
}

template <int LOGN>
__global__ void __cluster_dims__(2, 1, 1)
__launch_bounds__((1 << LOGN) / 64, 1024 / ((1 << LOGN) / 64))
ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               RowMap map, long long entry_stride,
               const uint32_t* __restrict__ qs,
               const uint32_t* __restrict__ itw,
               const uint32_t* __restrict__ itws,
               const uint32_t* __restrict__ ninv,
               const uint32_t* __restrict__ ninv_s,
               const uint32_t* __restrict__ ninv_w,
               const uint32_t* __restrict__ ninv_ws) {
  using B = Half<LOGN>;
  constexpr int N = B::N, H = B::H, T = B::T, S1 = B::S1, SKEW = B::SKEW;
  extern __shared__ uint32_t smem[];
  uint32_t* buf = smem;
  uint32_t* s_w = smem + H + 32;
  uint32_t* s_ws = s_w + T;
  const int c = blockIdx.x & 1;        // the block's rank in its cluster
  const int item = blockIdx.x >> 1;
  const int limb_i = map.limb(item);
  if (limb_i < 0) return;              // both blocks of the cluster
  const size_t limb = static_cast<size_t>(limb_i);
  const uint32_t q = qs[limb];
  const uint32_t* w = itw + limb * N;
  const uint32_t* ws = itws + limb * N;
  const uint32_t* src = x + map.entry(item) * entry_stride +
                        static_cast<long long>(map.pos(item)) * N + c;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = bitrev(tid, LOGN - 6);
  const int l2 = B::line_base(warp, lane);
  B::load_twiddles(s_w, s_ws, w, ws, c, tid);

  // the evaluations of parity c: element 32g + k of the half
  uint32_t a[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = __ldcs(src + 2 * (brev5(k) * T + tid));

  // phase 3 (distances 1 .. 16)
  const int b3 = (2 + c) * B::M3 + g;
  stage_global<4, true>(a, w + (b3 << 4), ws + (b3 << 4), q);
  stage_global<3, true>(a, w + (b3 << 3), ws + (b3 << 3), q);
  stage_global<2, true>(a, w + (b3 << 2), ws + (b3 << 2), q);
  stage_global<1, true>(a, w + (b3 << 1), ws + (b3 << 1), q);
  stage_global<0, true>(a, w + b3, ws + b3, q);

  // exchange 1: to 1024-element blocks, one per warp
#pragma unroll
  for (int k = 0; k < 32; ++k) buf[32 * g + (g >> SKEW) + k] = a[k];
  __syncthreads();                                       // barrier 1
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = buf[l2 + B::line_off(k)];

  // phase 2 (distances 32 .. 512)
  stage_shared<4, true>(a, s_w + (16 << S1) + (warp << 4),
                        s_ws + (16 << S1) + (warp << 4), q);
  stage_shared<3, true>(a, s_w + (8 << S1) + (warp << 3),
                        s_ws + (8 << S1) + (warp << 3), q);
  stage_shared<2, true>(a, s_w + (4 << S1) + (warp << 2),
                        s_ws + (4 << S1) + (warp << 2), q);
  stage_shared<1, true>(a, s_w + (2 << S1) + (warp << 1),
                        s_ws + (2 << S1) + (warp << 1), q);
  stage_shared<0, true>(a, s_w + (1 << S1) + warp, s_ws + (1 << S1) + warp,
                        q);

  // exchange 2: back to the words this warp read, then element tid + T k
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 32; ++k) buf[l2 + B::line_off(k)] = a[k];
  __syncthreads();                                       // barrier 2
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = buf[tid + (T + 1) * k];

  // phase 1 (distances 1024 .. n/4)
  if constexpr (S1 > 4) stage_shared<4, true>(a, s_w + 16, s_ws + 16, q);
  if constexpr (S1 > 3) stage_shared<3, true>(a, s_w + 8, s_ws + 8, q);
  if constexpr (S1 > 2) stage_shared<2, true>(a, s_w + 4, s_ws + 4, q);
  if constexpr (S1 > 1) stage_shared<1, true>(a, s_w + 2, s_ws + 2, q);
  if constexpr (S1 > 0) stage_shared<0, true>(a, s_w + 1, s_ws + 1, q);

  // the last stage, across the cluster
  cg::cluster_group cluster = cg::this_cluster();
  if (c) give<1, T>(a, buf, tid); else give<0, T>(a, buf, tid);
  cluster.sync();
  const uint32_t* peer = cluster.map_shared_rank(buf, c ^ 1);
  uint32_t* dst = y + static_cast<size_t>(map.row(item)) * N;
  const uint32_t s0 = ninv[limb], s0s = ninv_s[limb];
  const uint32_t s1 = ninv_w[limb], s1s = ninv_ws[limb];
  if (c)
    last_stage<1, T>(a, peer, dst, tid, s0, s0s, s1, s1s, q);
  else
    last_stage<0, T>(a, peer, dst, tid, s0, s0s, s1, s1s, q);
  cluster.sync();                      // the partner is done with buf
}

// One block of n/2 threads per row (n <= 2^10): thread t runs butterfly t
// of every stage on the row in shared memory.
__global__ void __launch_bounds__(512)
ntt_fwd_kernel_small(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ y, RowMap map, int logn,
                     const uint32_t* __restrict__ qs,
                     const uint32_t* __restrict__ tw,
                     const uint32_t* __restrict__ tws) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn, h0 = n >> 1, t = threadIdx.x;
  const int limb_i = map.limb(blockIdx.x);
  if (limb_i < 0) return;
  const size_t limb = static_cast<size_t>(limb_i);
  const uint32_t q = qs[limb];
  const uint32_t* w = tw + limb * n;
  const uint32_t* ws = tws + limb * n;
  const size_t row = static_cast<size_t>(map.row(blockIdx.x)) * n;
  a[t] = x[row + t];
  a[t + h0] = x[row + t + h0];
  __syncthreads();
  // Cooley-Tukey: m groups of pairs at distance h, group j's twiddle m + j
  for (int m = 1, lh = logn - 1; lh >= 0; m <<= 1, --lh) {
    const int j = t >> lh, p = (j << (lh + 1)) + (t & ((1 << lh) - 1));
    butterfly<false>(a[p], a[p + (1 << lh)], __ldg(w + m + j),
                     __ldg(ws + m + j), q);
    __syncthreads();
  }
  y[row + t] = a[bitrev(t, logn)];
  y[row + t + h0] = a[bitrev(t + h0, logn)];
}

__global__ void __launch_bounds__(512)
ntt_inv_kernel_small(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ y, RowMap map,
                     long long entry_stride, int logn,
                     const uint32_t* __restrict__ qs,
                     const uint32_t* __restrict__ itw,
                     const uint32_t* __restrict__ itws,
                     const uint32_t* __restrict__ ninv,
                     const uint32_t* __restrict__ ninv_s) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn, h0 = n >> 1, t = threadIdx.x;
  const int limb_i = map.limb(blockIdx.x);
  if (limb_i < 0) return;
  const size_t limb = static_cast<size_t>(limb_i);
  const uint32_t q = qs[limb];
  const uint32_t* w = itw + limb * n;
  const uint32_t* ws = itws + limb * n;
  const uint32_t* src = x + map.entry(blockIdx.x) * entry_stride +
                        static_cast<long long>(map.pos(blockIdx.x)) * n;
  a[t] = src[bitrev(t, logn)];
  a[t + h0] = src[bitrev(t + h0, logn)];
  __syncthreads();
  // Gentleman-Sande from the bit-reversed load: m = n/2 .. 1 groups
  for (int m = h0, lh = 0; m >= 1; m >>= 1, ++lh) {
    const int j = t >> lh, p = (j << (lh + 1)) + (t & ((1 << lh) - 1));
    butterfly<true>(a[p], a[p + (1 << lh)], __ldg(w + m + j),
                    __ldg(ws + m + j), q);
    __syncthreads();
  }
  const size_t row = static_cast<size_t>(map.row(blockIdx.x)) * n;
  y[row + t] = shoup_mul(a[t], ninv[limb], ninv_s[limb], q);
  y[row + t + h0] = shoup_mul(a[t + h0], ninv[limb], ninv_s[limb], q);
}

// The dynamic shared memory above 48 KB is allowed once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) ready = true;
  return e;
}

template <int LOGN>
cudaError_t launch_fwd(const uint32_t* x, uint32_t* y, const RowMap& map,
                       const uint32_t* qs, const uint32_t* tw,
                       const uint32_t* tws, cudaStream_t stream) {
  using B = Half<LOGN>;
  static bool ready = false;
  const cudaError_t e = allow_smem(ntt_fwd_kernel<LOGN>, B::SMEM, ready);
  if (e != cudaSuccess) return e;
  ntt_fwd_kernel<LOGN><<<2 * map.work, B::T, B::SMEM, stream>>>(x, y, map, qs,
                                                                tw, tws);
  return cudaGetLastError();
}

template <int LOGN>
cudaError_t launch_inv(const uint32_t* x, uint32_t* y, const RowMap& map,
                       long long entry_stride, const uint32_t* qs,
                       const uint32_t* itw, const uint32_t* itws,
                       const uint32_t* ninv, const uint32_t* ninv_s,
                       const uint32_t* ninv_w, const uint32_t* ninv_ws,
                       cudaStream_t stream) {
  using B = Half<LOGN>;
  static bool ready = false;
  const cudaError_t e = allow_smem(ntt_inv_kernel<LOGN>, B::SMEM, ready);
  if (e != cudaSuccess) return e;
  ntt_inv_kernel<LOGN><<<2 * map.work, B::T, B::SMEM, stream>>>(
      x, y, map, entry_stride, qs, itw, itws, ninv, ninv_s, ninv_w, ninv_ws);
  return cudaGetLastError();
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
    case 16: return static_cast<int>(launch_fwd<16>(xi, yo, map, q, w, ws, s));
    default:
      if (logn < 1 || logn > 10) return static_cast<int>(cudaErrorInvalidValue);
      ntt_fwd_kernel_small<<<map.work, 1 << (logn - 1),
                             sizeof(uint32_t) << logn, s>>>(xi, yo, map, logn,
                                                            q, w, ws);
      return static_cast<int>(cudaGetLastError());
  }
}

// x: D * M entries of (L, 2^logn) rows, entry_stride elements apart, each
// entry's rows 2^logn apart; y: (D, M, L, 2^logn) contiguous.  limb_map as
// for ntt_forward.
int ntt_inverse(const void* x, void* y, const void* limb_map, int D, int M,
                int L, long long entry_stride, int logn, const void* qs,
                const void* itw, const void* itws, const void* ninv,
                const void* ninv_s, const void* ninv_w, const void* ninv_ws,
                void* stream) {
  const RowMap map{static_cast<const int32_t*>(limb_map), D, M, L, D * M * L};
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* yo = static_cast<uint32_t*>(y);
  const auto* q = static_cast<const uint32_t*>(qs);
  const auto* w = static_cast<const uint32_t*>(itw);
  const auto* ws = static_cast<const uint32_t*>(itws);
  const auto* n0 = static_cast<const uint32_t*>(ninv);
  const auto* n0s = static_cast<const uint32_t*>(ninv_s);
  const auto* n1 = static_cast<const uint32_t*>(ninv_w);
  const auto* n1s = static_cast<const uint32_t*>(ninv_ws);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long es = entry_stride;
  switch (logn) {
    case 11: return static_cast<int>(
        launch_inv<11>(xi, yo, map, es, q, w, ws, n0, n0s, n1, n1s, s));
    case 12: return static_cast<int>(
        launch_inv<12>(xi, yo, map, es, q, w, ws, n0, n0s, n1, n1s, s));
    case 13: return static_cast<int>(
        launch_inv<13>(xi, yo, map, es, q, w, ws, n0, n0s, n1, n1s, s));
    case 14: return static_cast<int>(
        launch_inv<14>(xi, yo, map, es, q, w, ws, n0, n0s, n1, n1s, s));
    case 15: return static_cast<int>(
        launch_inv<15>(xi, yo, map, es, q, w, ws, n0, n0s, n1, n1s, s));
    case 16: return static_cast<int>(
        launch_inv<16>(xi, yo, map, es, q, w, ws, n0, n0s, n1, n1s, s));
    default:
      if (logn < 1 || logn > 10) return static_cast<int>(cudaErrorInvalidValue);
      ntt_inv_kernel_small<<<map.work, 1 << (logn - 1),
                             sizeof(uint32_t) << logn, s>>>(
          xi, yo, map, es, logn, q, w, ws, n0, n0s);
      return static_cast<int>(cudaGetLastError());
  }
}

}  // extern "C"
