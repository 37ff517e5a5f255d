// Shared device functions of the field kernels: one field element per
// thread, held as L x 32-bit limbs in registers (least significant first).
// L is a template parameter; every kernel is instantiated for L = 8 (BN254
// Fr and Fq, BLS12-381 Fr; R = 2^256) and L = 12 (BLS12-381 Fq; R = 2^384),
// and its C entry point takes the limb count and dispatches.
//
// Arrays are limb-axis-first, (L, n): limb i of element j lives at
// base[i * n + j], so the 32 threads of a warp read 32 neighbouring words
// for each limb (coalesced 128-byte transactions).
//
// The modulus p, -p^-1 mod 2^32 and the curve constant 3b (Montgomery form)
// arrive as one by-value kernel argument (constant bank): every field of a
// limb count uses the same kernels.  All arithmetic is written with 64-bit
// intermediates (a*b + c + d never overflows 64 bits for 32-bit a, b, c, d),
// which the compiler lowers to IMAD.WIDE and carry-propagating adds.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace cc {

template <int L>
struct FieldConst {
  uint32_t p[L];
  uint32_t n0inv;   // -p^-1 mod 2^32
  uint32_t b3[L];   // 3b in Montgomery form (curve kernels only)
  uint32_t b3i[L];  // imaginary part of 3b for curves over Fq2 (G2 kernel only)
};

template <int L>
struct Fe {
  uint32_t v[L];
};

// Host side: the wrappers pass 3L+1 words [p | n0inv | b3 | b3i].
template <int L>
inline FieldConst<L> make_consts(const void* consts) {
  const uint32_t* words = (const uint32_t*)consts;
  FieldConst<L> f;
  for (int i = 0; i < L; ++i) f.p[i] = words[i];
  f.n0inv = words[L];
  for (int i = 0; i < L; ++i) f.b3[i] = words[L + 1 + i];
  for (int i = 0; i < L; ++i) f.b3i[i] = words[2 * L + 1 + i];
  return f;
}

template <int L>
__device__ __forceinline__ Fe<L> fe_load(const uint32_t* base, long long stride, long long j) {
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = base[i * stride + j];
  return r;
}

template <int L>
__device__ __forceinline__ void fe_store(uint32_t* base, long long stride, long long j,
                                         const Fe<L>& a) {
#pragma unroll
  for (int i = 0; i < L; ++i) base[i * stride + j] = a.v[i];
}

template <int L>
__device__ __forceinline__ Fe<L> fe_const(const uint32_t (&w)[L]) {
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = w[i];
  return r;
}

template <int L>
__device__ __forceinline__ Fe<L> fe_zero() {
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = 0u;
  return r;
}

// One element-major row of NC coordinates (NC * L contiguous words, a
// multiple of 16 bytes for L = 8 and L = 12) read as 16-byte loads.
template <int L, int NC>
__device__ __forceinline__ void row_load(const uint32_t* row, Fe<L> (&out)[NC]) {
  static_assert((NC * L) % 4 == 0, "a row must be whole 16-byte words");
  const uint4* r = reinterpret_cast<const uint4*>(row);
  uint32_t w[NC * L];
#pragma unroll
  for (int i = 0; i < NC * L / 4; ++i) {
    const uint4 q = r[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < L; ++i) out[c].v[i] = w[c * L + i];
}

template <int L>
__device__ __forceinline__ bool fe_is_zero(const Fe<L>& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) acc |= a.v[i];
  return acc == 0u;
}

template <int L>
__device__ __forceinline__ Fe<L> fe_select(bool take_a, const Fe<L>& a, const Fe<L>& b) {
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = take_a ? a.v[i] : b.v[i];
  return r;
}

// x (with an extra carry word `top`, value < 2p) -> x mod p.
template <int L>
__device__ __forceinline__ Fe<L> cond_sub_p(const Fe<L>& a, uint32_t top, const FieldConst<L>& F) {
  Fe<L> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)a.v[i] - (uint64_t)F.p[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  const bool take_d = (top != 0u) || (borrow == 0);
  return fe_select(take_d, d, a);
}

template <int L>
__device__ __forceinline__ Fe<L> add_mod(const Fe<L>& a, const Fe<L>& b, const FieldConst<L>& F) {
  Fe<L> s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)a.v[i] + (uint64_t)b.v[i] + carry;
    s.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return cond_sub_p(s, (uint32_t)carry, F);
}

// (a - b) mod p for canonical a, b; in particular 0 - 0 = 0, not p.
template <int L>
__device__ __forceinline__ Fe<L> sub_mod(const Fe<L>& a, const Fe<L>& b, const FieldConst<L>& F) {
  Fe<L> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)a.v[i] - (uint64_t)b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  Fe<L> e;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)d.v[i] + (uint64_t)F.p[i] + carry;
    e.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return fe_select(borrow != 0, e, d);
}

// Montgomery product a*b*R^-1 mod p, R = 2^(32 L): coarsely integrated
// operand scanning (CIOS), one reduction step per limb of b, then one
// conditional subtraction.  Valid whenever a*b < R*p (so one operand may
// be any L-limb value if the other is below p); the result is canonical.
template <int L>
__device__ __forceinline__ Fe<L> mont_mul(const Fe<L>& a, const Fe<L>& b, const FieldConst<L>& F) {
  uint32_t t[L + 2];
#pragma unroll
  for (int i = 0; i < L + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint64_t s = (uint64_t)a.v[j] * (uint64_t)b.v[i] + (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * F.n0inv;
    s = (uint64_t)m * (uint64_t)F.p[0] + (uint64_t)t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = (uint64_t)m * (uint64_t)F.p[j] + (uint64_t)t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = t[i];
  return cond_sub_p(r, t[L], F);
}

inline int launch_status() { return (int)cudaGetLastError(); }

// What a C entry point returns for a limb count it has no instantiation of.
inline int bad_limbs() { return (int)cudaErrorInvalidValue; }

// Grid of `threads`-wide blocks over n lanes, capped at `per_sm` blocks for
// each of the card's 132 SMs (the kernels stride over what is left).
inline unsigned grid_for(long long n, int threads, int per_sm) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * per_sm) blocks = 132LL * per_sm;
  return (unsigned)blocks;
}

}  // namespace cc
