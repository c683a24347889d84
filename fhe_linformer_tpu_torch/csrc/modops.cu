// K6: the evaluator's residue arithmetic outside the key switch (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these passes to XLA,
// which fuses each chain into one elementwise pass; the port first ran them
// as chains of plain torch ops (for a product an int64 cast, an int64
// multiply, an int64 remainder by the broadcast moduli and a cast back; for
// a sum an add, a compare, a subtract and a select; about eighteen launches
// a rescale).  Three entry points, on canonical residues (every value below
// its prime, each prime below 2^30):
//
//   mod_ew:    out = a b, a + b, a - b, -a, a b + c or a b + c d  mod q_i
//   rs_lift:   the rescale's centred lift of the dropped limb's coefficients
//              v (K2's output) onto the nl - 1 remaining limbs,
//              v <= qd / 2 ? v mod q_i : (v mod q_i - qd mod q_i) mod q_i
//   rs_finish: r_i = (x_i f_i - lift_e_i) qd^-1 mod q_i, then r + a or
//              a - r for an addend a of each ciphertext half; the factor f
//              and the addends optional
//
// so a rescale is K2 on the top limb, rs_lift, K1 and rs_finish.  Products
// of two residues go through 64 bits and csrc/modarith.cuh's
// barrett_reduce64, with mu = floor(2^64 / q_i) made in the kernel from a
// double quotient corrected to the exact integer (so any moduli tensor is
// taken, with no table); products by the per-row constants qd^-1 and 1
// (the lift's v mod q_i) by Shoup.  Every result is canonical, so each
// entry point equals the int64 torch expressions bit for bit.  The lift's
// compare is exact integer arithmetic, so a tie v == qd / 2 takes the
// JAX package's branch.
//
// What bounds it on the H100: bytes.  mod_ew reads each operand's residue
// once and writes one, 12 bytes a residue for a product or sum of two
// ciphertext halves (a plaintext broadcast over the batch is re-read from
// L2); rs_lift reads 4 bytes a column and writes 4 a residue; rs_finish
// reads x and lift_e and writes out, 12 bytes a residue (16 with the
// factor's or an addend's rows), against 3 to 8 32-bit multiplies a
// residue, far below the card's integer rate at 3.35 TB/s.  The torch
// chains moved 34 to 60 bytes a residue through int64 temporaries.
//
// Design: as K5, a thread owns 4 neighbouring coefficients of one row of
// one batch entry, loaded and stored as 16-byte vectors; block (x, i, b)
// covers 512 columns of row i of entry b, so the per-row constants are
// read once a thread.  Every operand comes with its own strides (a row
// stride, a column stride of 1, or 0 for an (L, 1) constant, and up to four
// leading strides, 0 on a broadcast axis), so plaintexts broadcast over the
// batch, (L, 1) constants, limb slices and digit slices of larger tensors
// are read and written in place; the wrapper (ops/modops.py) merges the
// leading axes and checks alignment.  Batch entries beyond the grid's z
// extent are walked in a loop.
//
// C interface (loaded with ctypes): pointers to int32 tensors reinterpreted
// as unsigned; mod_ew and rs_finish take their operands as a descriptor of
// 64-bit words (below); each entry point returns cudaGetLastError() after
// its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec;       // coefficients per block
constexpr int kMaxZ = 65535;                 // grid z extent
constexpr int kDims = 4;                     // leading axes of an operand
constexpr int kWords = 3 + kDims;            // an operand's descriptor words

enum Op { kMul = 0, kAdd = 1, kSub = 2, kNeg = 3, kFma = 4, kDot = 5 };

// One tensor broadcast to the launch's shape (elements, not bytes).
struct Operand {
  const uint32_t* p;                         // nullptr when absent
  long long rs;                              // row stride
  long long cs;                              // column stride: 1, or 0
  long long bs[kDims];                       // leading strides, innermost first
};

// The leading axes, innermost first: nd of them, unused sizes 1.
struct Lead {
  unsigned size[kDims];
  int nd;
};

struct EwArgs {
  Operand out, in[4];
  Lead lead;
  const uint32_t* q;
  int batch, rows, n;
};

struct RsArgs {
  Operand x[2], f, add[2];
  Lead lead;
  const uint32_t* lift;                      // (2, batch, rows, n)
  uint32_t* out;                             // (2, batch, rows, n)
  const uint32_t* q;
  const uint32_t* inv;
  const uint32_t* inv_s;
  int batch, rows, n, mode;                  // mode: r + a, a - r
};

// floor(2^64 / q) for an odd q > 2 (barrett_reduce64's mu, which equals
// floor((2^64 - 1) / q)): the double quotient is within 2^11 / q of it, so
// within one for the primes here; the loops make it exact for any q.
__device__ __forceinline__ uint64_t barrett_mu(uint32_t q) {
  uint64_t m = static_cast<uint64_t>(0x1p64 / static_cast<double>(q));
  while (__umul64hi(m, q) != 0) --m;           // now m q < 2^64
  while (0ull - m * q >= q) ++m;               // (m + 1) q <= 2^64
  return m;
}

// entry b's index on each leading axis
__device__ __forceinline__ void split(unsigned b, const Lead& l,
                                      unsigned e[kDims]) {
#pragma unroll
  for (int d = 0; d < kDims; ++d) e[d] = 0;
  for (int d = 0; d < l.nd - 1; ++d) {
    e[d] = b % l.size[d];
    b /= l.size[d];
  }
  e[l.nd - 1] = b;
}

// the start of row i of entry e
__device__ __forceinline__ const uint32_t* row(const Operand& o,
                                               const unsigned e[kDims],
                                               int i) {
  long long off = static_cast<long long>(i) * o.rs;
#pragma unroll
  for (int d = 0; d < kDims; ++d) off += e[d] * o.bs[d];
  return o.p + off;
}

__device__ __forceinline__ void load4(const uint32_t* r, long long cs, int c,
                                      uint32_t v[kVec]) {
  if (cs) {
    const uint4 t = *reinterpret_cast<const uint4*>(r + c);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const uint32_t s = *r;                   // an (L, 1) constant's row
    v[0] = s; v[1] = s; v[2] = s; v[3] = s;
  }
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t v[kVec]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

template <int kOp>
__global__ void __launch_bounds__(kThreads) mod_ew_kernel(const EwArgs a) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= a.n) return;
  const int i = blockIdx.y;
  const uint32_t qi = a.q[i];
  constexpr bool kProduct = kOp == kMul || kOp == kFma || kOp == kDot;
  const uint64_t mu = kProduct ? barrett_mu(qi) : 0;
  for (int b = blockIdx.z; b < a.batch; b += gridDim.z) {
    unsigned e[kDims];
    split(b, a.lead, e);
    uint32_t x[kVec], y[kVec], z[kVec], w[kVec], r[kVec];
    load4(row(a.in[0], e, i), a.in[0].cs, c, x);
    if (kOp != kNeg) load4(row(a.in[1], e, i), a.in[1].cs, c, y);
    if (kOp == kFma || kOp == kDot) load4(row(a.in[2], e, i), a.in[2].cs, c, z);
    if (kOp == kDot) load4(row(a.in[3], e, i), a.in[3].cs, c, w);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint64_t p = static_cast<uint64_t>(x[k]) * y[k];
      if (kOp == kMul) r[k] = barrett_reduce64(p, mu, qi);
      if (kOp == kAdd) r[k] = add_mod(x[k], y[k], qi);
      if (kOp == kSub) r[k] = sub_mod(x[k], y[k], qi);
      if (kOp == kNeg) r[k] = x[k] ? qi - x[k] : 0u;
      if (kOp == kFma) r[k] = barrett_reduce64(p + z[k], mu, qi);
      if (kOp == kDot)
        r[k] = barrett_reduce64(p + static_cast<uint64_t>(z[k]) * w[k], mu,
                                qi);
    }
    store4(const_cast<uint32_t*>(row(a.out, e, i)) + c, r);
  }
}

// v: (batch, 1, n); out: (batch, rows, n).  Block (x, i, b): 512 columns of
// row i of entry b.
__global__ void __launch_bounds__(kThreads)
rs_lift_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ qdm,
               const uint32_t* __restrict__ one_s, uint32_t half, int batch,
               int rows, int n) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  const int i = blockIdx.y;
  const uint32_t qi = q[i], m = qdm[i], s = one_s[i];
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    uint32_t vv[kVec], r[kVec];
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(
        v + static_cast<size_t>(b) * n + c));     // re-read by each row: L2
    vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint32_t vm = shoup_mul(vv[k], 1u, s, qi);
      r[k] = vv[k] <= half ? vm : sub_mod(vm, m, qi);
    }
    store4(out + (static_cast<size_t>(b) * rows + i) * n + c, r);
  }
}

// Entry b of 2 * batch is half b / batch, entry b % batch of the leading
// axes; lift and out are contiguous (2, batch, rows, n).
__global__ void __launch_bounds__(kThreads) rs_finish_kernel(const RsArgs a) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c >= a.n) return;
  const int i = blockIdx.y;
  const uint32_t qi = a.q[i], w = a.inv[i], ws = a.inv_s[i];
  const bool factor = a.f.p != nullptr;
  const uint64_t mu = factor ? barrett_mu(qi) : 0;
  for (int b = blockIdx.z; b < 2 * a.batch; b += gridDim.z) {
    const int h = b >= a.batch;
    unsigned e[kDims];
    split(b - h * a.batch, a.lead, e);
    const size_t at = (static_cast<size_t>(b) * a.rows + i) * a.n + c;
    uint32_t x[kVec], l[kVec], r[kVec];
    load4(row(a.x[h], e, i), a.x[h].cs, c, x);
    load4(a.lift + at, 1, 0, l);
    if (factor) {
      uint32_t f[kVec];
      load4(row(a.f, e, i), a.f.cs, c, f);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        x[k] = barrett_reduce64(static_cast<uint64_t>(x[k]) * f[k], mu, qi);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      r[k] = shoup_mul(sub_mod(x[k], l[k], qi), w, ws, qi);
    const Operand& ad = a.add[h];
    if (ad.p != nullptr) {
      uint32_t v[kVec];
      load4(row(ad, e, i), ad.cs, c, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        r[k] = a.mode ? sub_mod(v[k], r[k], qi) : add_mod(r[k], v[k], qi);
    }
    store4(a.out + at, r);
  }
}

Operand operand(const long long* w) {
  Operand o;
  o.p = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(w[0]));
  o.rs = w[1];
  o.cs = w[2];
  for (int d = 0; d < kDims; ++d) o.bs[d] = w[3 + d];
  return o;
}

// nd, then kDims sizes; false unless 1 <= nd <= kDims and the sizes are
// positive 32-bit numbers whose product is `batch`
bool lead(const long long* w, int batch, Lead* l) {
  l->nd = static_cast<int>(w[0]);
  if (l->nd < 1 || l->nd > kDims) return false;
  long long prod = 1;
  for (int d = 0; d < kDims; ++d) {
    if (w[1 + d] < 1 || w[1 + d] > 0x7FFFFFFF) return false;
    l->size[d] = static_cast<unsigned>(w[1 + d]);
    prod *= w[1 + d];
  }
  return prod == batch;
}

dim3 grid(int n, int rows, int batch) {
  return dim3((n + kTile - 1) / kTile, rows, batch < kMaxZ ? batch : kMaxZ);
}

bool bad_shape(int batch, int rows, int n) {
  return batch < 1 || rows < 1 || rows > 65535 || n < kVec || n % kVec != 0;
}

}  // namespace

extern "C" {

// d: op, batch, rows, n, q, the leading axes (nd and kDims sizes), then the
// operands out, a, b, c, d (kWords each: pointer, row stride, column
// stride, kDims leading strides; a null pointer for an absent one).  Every
// vector operand 16-byte aligned with strides that are multiples of 4.
int mod_ew(const long long* d, void* stream) {
  EwArgs a;
  const int op = static_cast<int>(d[0]);
  a.batch = static_cast<int>(d[1]);
  a.rows = static_cast<int>(d[2]);
  a.n = static_cast<int>(d[3]);
  a.q = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(d[4]));
  if (op < kMul || op > kDot || bad_shape(a.batch, a.rows, a.n) ||
      !lead(d + 5, a.batch, &a.lead))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* w = d + 6 + kDims;
  a.out = operand(w);
  for (int k = 0; k < 4; ++k) a.in[k] = operand(w + kWords * (k + 1));
  const dim3 g = grid(a.n, a.rows, a.batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMul: mod_ew_kernel<kMul><<<g, kThreads, 0, s>>>(a); break;
    case kAdd: mod_ew_kernel<kAdd><<<g, kThreads, 0, s>>>(a); break;
    case kSub: mod_ew_kernel<kSub><<<g, kThreads, 0, s>>>(a); break;
    case kNeg: mod_ew_kernel<kNeg><<<g, kThreads, 0, s>>>(a); break;
    case kFma: mod_ew_kernel<kFma><<<g, kThreads, 0, s>>>(a); break;
    default: mod_ew_kernel<kDot><<<g, kThreads, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int rs_lift(const void* v, void* out, const void* q, const void* qdm,
            const void* one_s, long long half, int batch, int rows, int n,
            void* stream) {
  if (bad_shape(batch, rows, n) || half < 0 || half > 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  rs_lift_kernel<<<grid(n, rows, batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qdm),
      static_cast<const uint32_t*>(one_s), static_cast<uint32_t>(half),
      batch, rows, n);
  return static_cast<int>(cudaGetLastError());
}

// d: batch (entries a half), rows, n, mode, q, inv, inv_s, lift, out,
// the leading axes (nd and kDims sizes), then the operands x0, x1, f,
// add0, add1 (kWords each, as for mod_ew).
int rs_finish(const long long* d, void* stream) {
  RsArgs a;
  a.batch = static_cast<int>(d[0]);
  a.rows = static_cast<int>(d[1]);
  a.n = static_cast<int>(d[2]);
  a.mode = static_cast<int>(d[3]);
  const auto ptr = [&](int k) {
    return reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(d[k]));
  };
  a.q = ptr(4);
  a.inv = ptr(5);
  a.inv_s = ptr(6);
  a.lift = ptr(7);
  a.out = ptr(8);
  if (bad_shape(2 * a.batch, a.rows, a.n) || a.batch > 0x3FFFFFFF ||
      a.mode < 0 || a.mode > 1 ||
      !lead(d + 9, a.batch, &a.lead))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* w = d + 10 + kDims;
  a.x[0] = operand(w);
  a.x[1] = operand(w + kWords);
  a.f = operand(w + 2 * kWords);
  a.add[0] = operand(w + 3 * kWords);
  a.add[1] = operand(w + 4 * kWords);
  rs_finish_kernel<<<grid(a.n, a.rows, 2 * a.batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
