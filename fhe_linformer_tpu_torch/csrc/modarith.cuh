// Modular arithmetic on canonical 32-bit residues (every prime < 2^30),
// shared by the kernels of csrc/.  `ops/cuda_build.py` hashes this header
// with each source, so an edit here rebuilds every kernel.

#pragma once

#include <cstdint>

// a * w mod q for a constant w < q with ws = floor(w * 2^32 / q); a may be
// lazy (any value below 2^32).  Result canonical.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t hi = __umulhi(a, ws);
  const uint32_t r = a * w - hi * q;       // in [0, 2q), exact mod 2^32
  return r >= q ? r - q : r;
}

// x mod q for any 64-bit x, by Barrett reduction with mu = floor((2^64 - 1)
// / q) (= floor(2^64 / q), q odd): the quotient estimate undershoots by at
// most 1, so x - estimate * q lies in [0, 2q) and one subtract finishes.
__device__ __forceinline__ uint32_t barrett_reduce64(uint64_t x, uint64_t mu,
                                                     uint32_t q) {
  const uint64_t t = __umul64hi(x, mu);
  const uint32_t r = static_cast<uint32_t>(x - t * q);
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
