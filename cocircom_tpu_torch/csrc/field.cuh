// Shared device functions for the BN254 kernels: one field element per
// thread, held as 8 x 32-bit limbs in registers (least significant first).
//
// Arrays are limb-axis-first, (8, n): limb i of element j lives at
// base[i * n + j], so the 32 threads of a warp read 32 neighbouring words
// for each limb (coalesced 128-byte transactions).
//
// The modulus p, -p^-1 mod 2^32 and the curve constant 3b (Montgomery form)
// arrive as one by-value kernel argument (constant bank): Fr and Fq use the
// same kernels.  All arithmetic is written with 64-bit intermediates
// (a*b + c + d never overflows 64 bits for 32-bit a, b, c, d), which the
// compiler lowers to IMAD.WIDE and carry-propagating adds.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace cc {

constexpr int L = 8;

struct FieldConst {
  uint32_t p[L];
  uint32_t n0inv;   // -p^-1 mod 2^32
  uint32_t b3[L];   // 3b in Montgomery form (curve kernels only)
  uint32_t b3i[L];  // imaginary part of 3b for curves over Fq2 (G2 kernel only)
};

struct Fe {
  uint32_t v[L];
};

// Host side: the wrappers pass 3L+1 words [p | n0inv | b3 | b3i].
inline FieldConst make_consts(const uint32_t* words) {
  FieldConst f;
  for (int i = 0; i < L; ++i) f.p[i] = words[i];
  f.n0inv = words[L];
  for (int i = 0; i < L; ++i) f.b3[i] = words[L + 1 + i];
  for (int i = 0; i < L; ++i) f.b3i[i] = words[2 * L + 1 + i];
  return f;
}

__device__ __forceinline__ Fe fe_load(const uint32_t* base, long long stride, long long j) {
  Fe r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = base[i * stride + j];
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* base, long long stride, long long j, const Fe& a) {
#pragma unroll
  for (int i = 0; i < L; ++i) base[i * stride + j] = a.v[i];
}

__device__ __forceinline__ Fe fe_const(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = w[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) acc |= a.v[i];
  return acc == 0u;
}

__device__ __forceinline__ Fe fe_select(bool take_a, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = take_a ? a.v[i] : b.v[i];
  return r;
}

// x (with an extra carry word `top`, value < 2p) -> x mod p.
__device__ __forceinline__ Fe cond_sub_p(const Fe& a, uint32_t top, const FieldConst& F) {
  Fe d;
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

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b, const FieldConst& F) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)a.v[i] + (uint64_t)b.v[i] + carry;
    s.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return cond_sub_p(s, (uint32_t)carry, F);
}

__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b, const FieldConst& F) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)a.v[i] - (uint64_t)b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  Fe e;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t t = (uint64_t)d.v[i] + (uint64_t)F.p[i] + carry;
    e.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return fe_select(borrow != 0, e, d);
}

// Montgomery product a*b*R^-1 mod p, R = 2^256: coarsely integrated
// operand scanning (CIOS), one reduction step per limb of b, then one
// conditional subtraction.  Valid whenever a*b < R*p (so one operand may
// be any 256-bit value if the other is below p); the result is canonical.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b, const FieldConst& F) {
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
  Fe r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = t[i];
  return cond_sub_p(r, t[L], F);
}

inline int launch_status() { return (int)cudaGetLastError(); }

}  // namespace cc
