// K4: the key switch's modular multiply-accumulate over the extended basis
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the key-digit inner
// products and the rotation combo's plaintext sums to XLA's fused int64
// elementwise code, which the port first ran as chains of plain torch ops
// (a cast, a broadcast product, a remainder, a digit sum, a remainder and a
// cast back per row block and key half, then a concatenation).  For
// canonical residues (every value below its prime q_r < 2^30) it computes
//
//   out[h, b, r, c] = sum_{j < J} a[sel_j, b, r, perm(c)]
//                                 * w_h[j, row(r), c]  mod q_r
//
// with h < H the output half (H = 2: the key's b and a halves; H = 1: one
// plaintext sum), b the flattened batch, j the key digits or a rotation
// combo's baby rows (sel_j picks a's entry; the identity without sel),
// perm an optional Galois gather of the coefficient axis read in place,
// and row(r) = r below `split`, r + w_off from it, so a key's active rows
// and its specials block are read where they lie.
//
// What bounds it on the H100: bytes.  Each residue of a is read once (4 B)
// and takes part in H products; the weights are read once a launch and
// reused over the batch; each output is written once: 4 + 4H/J + 4H/B
// bytes per residue of a.  At the per-token key switch's shape (J = 2
// digits at level 22, batch 8, 42 rows, n = 2^15, H = 2) that is 9 bytes
// against 2 products (a 32 x 32 -> 64-bit multiply-add each), several
// times below the card's integer rate at 3.35 TB/s.  The plain torch chain
// it replaces moved over ten times the bytes, through int64 temporaries.
//
// Design: a block owns a tile of 512 coefficients of one row and all batch
// entries of the launch; each of its 128 threads owns 4 neighbouring
// coefficients, loaded and stored as 16-byte vectors (coalesced; a Galois
// gather reads 4 words at perm(c), the same indices for every digit and
// batch entry).  Blocks of one row are neighbours in the grid, so a gather
// finds the other words of its 32-byte sectors in L2.  The sum runs in
// unsigned 64-bit registers (one wide multiply-add a product); each product
// is below 2^60, so at most 8 are added before one exact Barrett reduction
// by floor((2^64 - 1) / q_r), computed once a block for its row.  A block
// walks the batch inside: its weight tile (J H 2 KB) is loaded from device
// memory once and re-read from L1.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as unsigned; returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec;       // coefficients per block
constexpr int kLazy = 8;                     // products per reduction
constexpr int kMaxJ = 64;                    // digits or baby rows a launch

struct Sel {
  int v[kMaxJ];                              // a's entry of each j
};

template <int H, bool PERM>
__global__ void __launch_bounds__(kThreads)
ks_mac_kernel(const uint32_t* __restrict__ a, long long a_js,
              const uint32_t* __restrict__ w0,
              const uint32_t* __restrict__ w1, long long w_js,
              const uint32_t* __restrict__ q,
              const long long* __restrict__ perm,
              uint32_t* __restrict__ out, long long out_hs, const Sel sel,
              int J, int batch, int rows, int n, int split, int w_off) {
  const int r = blockIdx.y;
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  const uint32_t qr = q[r];
  const uint64_t mu = ~0ull / qr;
  const size_t row_off = static_cast<size_t>(r) * n;
  const size_t entry = static_cast<size_t>(rows) * n;   // a batch entry
  const size_t w_row =
      static_cast<size_t>(r < split ? r : r + w_off) * n + c;
  const uint32_t* wh[2] = {w0 + w_row, H > 1 ? w1 + w_row : w0 + w_row};
  int idx[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    idx[v] = PERM ? static_cast<int>(perm[c + v]) : c + v;

  for (int b = 0; b < batch; ++b) {
    const uint32_t* ab = a + b * entry + row_off;
    uint64_t acc[H][kVec];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[h][v] = 0;
    for (int j0 = 0; j0 < J; j0 += kLazy) {
      const int j1 = min(J, j0 + kLazy);
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const uint32_t* aj = ab + sel.v[j] * a_js;
        uint32_t av[kVec];
        if (PERM) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) av[v] = __ldg(aj + idx[v]);
        } else {
          const uint4 t = __ldcs(reinterpret_cast<const uint4*>(aj + c));
          av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
        }
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const uint4 t =
              __ldg(reinterpret_cast<const uint4*>(wh[h] + j * w_js));
          acc[h][0] += static_cast<uint64_t>(av[0]) * t.x;
          acc[h][1] += static_cast<uint64_t>(av[1]) * t.y;
          acc[h][2] += static_cast<uint64_t>(av[2]) * t.z;
          acc[h][3] += static_cast<uint64_t>(av[3]) * t.w;
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          acc[h][v] = barrett_reduce64(acc[h][v], mu, qr);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      uint32_t* o = out + h * out_hs + b * entry + row_off + c;
      __stcs(reinterpret_cast<uint4*>(o),
             make_uint4(static_cast<uint32_t>(acc[h][0]),
                        static_cast<uint32_t>(acc[h][1]),
                        static_cast<uint32_t>(acc[h][2]),
                        static_cast<uint32_t>(acc[h][3])));
    }
  }
}

template <int H, bool PERM>
cudaError_t launch(const void* a, long long a_js, const void* w0,
                   const void* w1, long long w_js, const void* q,
                   const void* perm, void* out, long long out_hs,
                   const Sel& sel, int J, int batch, int rows, int n,
                   int split, int w_off, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, rows);
  ks_mac_kernel<H, PERM><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(a), a_js,
      static_cast<const uint32_t*>(w0), static_cast<const uint32_t*>(w1),
      w_js, static_cast<const uint32_t*>(q),
      static_cast<const long long*>(perm), static_cast<uint32_t*>(out),
      out_hs, sel, J, batch, rows, n, split, w_off);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: J_a entries of (batch, rows, n), a_js elements apart; w0, w1: the
// halves' (J_w, rows_w, n) rows, digit j at j * w_js; q: (rows,) moduli;
// perm: (n,) int64 gather or null; out: H entries of (batch, rows, n),
// out_hs elements apart; sel: J entries of a (null: 0 .. J - 1).  n, a_js,
// w_js and out_hs are multiples of 4 and every pointer 16-byte aligned.
int ks_mac(const void* a, long long a_js, const void* w0, const void* w1,
           long long w_js, const void* q, const void* perm, void* out,
           long long out_hs, const int* sel, int J, int H, int batch,
           int rows, int n, int split, int w_off, void* stream) {
  if (J < 1 || J > kMaxJ || H < 1 || H > 2 || n % kVec != 0 || rows < 1 ||
      rows > 65535 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Sel s;
  for (int j = 0; j < J; ++j) s.v[j] = sel ? sel[j] : j;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool p = perm != nullptr;
  if (H == 2)
    return static_cast<int>(
        p ? launch<2, true>(a, a_js, w0, w1, w_js, q, perm, out, out_hs, s,
                            J, batch, rows, n, split, w_off, st)
          : launch<2, false>(a, a_js, w0, w1, w_js, q, perm, out, out_hs, s,
                             J, batch, rows, n, split, w_off, st));
  return static_cast<int>(
      p ? launch<1, true>(a, a_js, w0, w1, w_js, q, perm, out, out_hs, s, J,
                          batch, rows, n, split, w_off, st)
        : launch<1, false>(a, a_js, w0, w1, w_js, q, perm, out, out_hs, s,
                           J, batch, rows, n, split, w_off, st));
}

}  // extern "C"
