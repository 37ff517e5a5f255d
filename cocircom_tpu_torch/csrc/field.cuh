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
// limb count uses the same kernels.
//
// Two forms of the arithmetic live here.  The first (mont_mul, add_mod,
// sub_mod, cond_sub_p) is written with 64-bit intermediates (a*b + c + d
// never overflows 64 bits for 32-bit a, b, c, d), which the compiler lowers
// to IMAD.WIDE and carry-propagating adds; the field kernels K1-K3 use it,
// and so does the sweep's yardstick of the old curve kernels
// (cocircom_tpu_torch/tools/ec_add_one_lane.cu).  The second (the *_cc
// functions below) is written in PTX carry-flag instructions (mad.lo.cc,
// madc.hi.cc, addc.cc, subc.cc); every curve kernel uses it: K4 ec_add, K5
// ec_madd, K6 ec_wave_add and the G2 kernels.
//
// CC_HOST_MODEL: defined only by the host model of the carry-chain code
// (cocircom_tpu_torch/tools/carry_model.cpp), which compiles these
// functions with g++ and emulates each PTX instruction, carry flag included.
#pragma once
#include <cstdint>
#ifndef CC_HOST_MODEL
#include <cuda_runtime.h>
#endif

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

// ===================================================== carry-chain arithmetic
// One wrapper per PTX instruction.  A chain is a run of these in which
// nothing between two links writes the carry flag: ordinary C arithmetic
// compiles to instructions that neither read nor write it.  `volatile`
// keeps the front end from merging or reordering the links; ptxas still
// interleaves independent chains, each with its own carry predicate.
// For subtraction the flag is the borrow.
namespace ptx {
#ifndef CC_HOST_MODEL
#define CC_ASM2(op)                                                               \
  __device__ __forceinline__ uint32_t op##_(uint32_t a, uint32_t b) {              \
    uint32_t r;                                                                    \
    asm volatile(CC_OP_##op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    return r;                                                                      \
  }
#define CC_ASM3(op)                                                               \
  __device__ __forceinline__ uint32_t op##_(uint32_t a, uint32_t b, uint32_t c) {  \
    uint32_t r;                                                                    \
    asm volatile(CC_OP_##op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                                      \
  }
#define CC_OP_add_cc "add.cc.u32"
#define CC_OP_addc_cc "addc.cc.u32"
#define CC_OP_addc "addc.u32"
#define CC_OP_sub_cc "sub.cc.u32"
#define CC_OP_subc_cc "subc.cc.u32"
#define CC_OP_subc "subc.u32"
#define CC_OP_mad_lo_cc "mad.lo.cc.u32"
#define CC_OP_madc_lo_cc "madc.lo.cc.u32"
#define CC_OP_madc_hi_cc "madc.hi.cc.u32"
#define CC_OP_madc_hi "madc.hi.u32"
CC_ASM2(add_cc)
CC_ASM2(addc_cc)
CC_ASM2(addc)
CC_ASM2(sub_cc)
CC_ASM2(subc_cc)
CC_ASM2(subc)
CC_ASM3(mad_lo_cc)
CC_ASM3(madc_lo_cc)
CC_ASM3(madc_hi_cc)
CC_ASM3(madc_hi)
#undef CC_ASM2
#undef CC_ASM3
#else
// The host model: the same instructions over a per-thread carry flag.
extern thread_local uint32_t model_cf;
inline uint32_t wr(uint64_t s) { model_cf = (uint32_t)(s >> 32); return (uint32_t)s; }
inline uint32_t br(uint64_t d) { model_cf = (uint32_t)(d >> 63); return (uint32_t)d; }
inline uint32_t lo(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a * b); }
inline uint32_t hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t add_cc_(uint32_t a, uint32_t b) { return wr((uint64_t)a + b); }
inline uint32_t addc_cc_(uint32_t a, uint32_t b) { return wr((uint64_t)a + b + model_cf); }
inline uint32_t addc_(uint32_t a, uint32_t b) { return a + b + model_cf; }
inline uint32_t sub_cc_(uint32_t a, uint32_t b) { return br((uint64_t)a - b); }
inline uint32_t subc_cc_(uint32_t a, uint32_t b) { return br((uint64_t)a - b - model_cf); }
inline uint32_t subc_(uint32_t a, uint32_t b) { return a - b - model_cf; }
inline uint32_t mad_lo_cc_(uint32_t a, uint32_t b, uint32_t c) { return wr((uint64_t)lo(a, b) + c); }
inline uint32_t madc_lo_cc_(uint32_t a, uint32_t b, uint32_t c) {
  return wr((uint64_t)lo(a, b) + c + model_cf);
}
inline uint32_t madc_hi_cc_(uint32_t a, uint32_t b, uint32_t c) {
  return wr((uint64_t)hi(a, b) + c + model_cf);
}
inline uint32_t madc_hi_(uint32_t a, uint32_t b, uint32_t c) { return hi(a, b) + c + model_cf; }
#endif
}  // namespace ptx

// acc[0..L-1] += the products a[0] bi, a[2] bi, ..., a[L-2] bi, each as its
// (lo, hi) word pair at acc[j], acc[j+1]: one carry chain over L words that
// starts without a carry-in and leaves its carry-out in the flag.  Called
// with a + 1 it takes the odd limbs a[1], a[3], ....
template <int L>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  acc[0] = ptx::mad_lo_cc_(a[0], bi, acc[0]);
  acc[1] = ptx::madc_hi_cc_(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < L; j += 2) {
    acc[j] = ptx::madc_lo_cc_(a[j], bi, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc_(a[j], bi, acc[j + 1]);
  }
}

// acc[j], acc[j+1] = the (lo, hi) pair of a[j] bi for even j; no chain.
template <int L>
__device__ __forceinline__ void mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < L; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = __umulhi(a[j], bi);
  }
}

// odd <- (odd shifted down two words) + the pairs of a[0] bi, a[2] bi, ...,
// continuing the chain of the caller's last link (carry-in from the flag).
template <int L>
__device__ __forceinline__ void madc_n_rshift(uint32_t* odd, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < L - 2; j += 2) {
    odd[j] = ptx::madc_lo_cc_(a[j], bi, odd[j + 2]);
    odd[j + 1] = ptx::madc_hi_cc_(a[j], bi, odd[j + 3]);
  }
  odd[L - 2] = ptx::madc_lo_cc_(a[L - 2], bi, 0u);
  odd[L - 1] = ptx::madc_hi_(a[L - 2], bi, 0u);
}

// One row of the even/odd CIOS product.  The running value is
//     sum_k even[k] 2^(32k) + sum_k odd[k] 2^(32(k+1)):
// the products of the even limbs of a land on whole columns of `even`, those
// of the odd limbs on `odd`, so the two carry chains of a row do not depend
// on each other.  The row adds a * bi and m p with m chosen to clear column
// 0, and divides by 2^32 by swapping the roles of the two arrays: the caller
// passes (odd, even) for the next row.  The column that the swap leaves
// behind is folded in by the first link of the next row.  Needs
// p < 2^(32L - 1) (both fields here have two or more spare bits): then no
// chain carries out of its top word.
template <int L, bool first>
__device__ __forceinline__ void mad_n_redc(uint32_t* even, uint32_t* odd, const uint32_t* a,
                                           uint32_t bi, const FieldConst<L>& F) {
  if (first) {
    mul_n<L>(odd, a + 1, bi);
    mul_n<L>(even, a, bi);
  } else {
    even[0] = ptx::add_cc_(even[0], odd[1]);
    madc_n_rshift<L>(odd, a + 1, bi);
    cmad_n<L>(even, a, bi);
    odd[L - 1] = ptx::addc_(odd[L - 1], 0u);
  }
  const uint32_t m = even[0] * F.n0inv;
  cmad_n<L>(odd, F.p + 1, m);
  cmad_n<L>(even, F.p, m);
  odd[L - 1] = ptx::addc_(odd[L - 1], 0u);
}

// (even, odd) after the last (odd-numbered) row -> the L-word value
// sum_k (even[k] + odd[k+1]) 2^(32k).
template <int L>
__device__ __forceinline__ Fe<L> merge_rows(const uint32_t* even, const uint32_t* odd) {
  Fe<L> r;
  r.v[0] = ptx::add_cc_(even[0], odd[1]);
#pragma unroll
  for (int i = 1; i < L - 1; ++i) r.v[i] = ptx::addc_cc_(even[i], odd[i + 1]);
  r.v[L - 1] = ptx::addc_(even[L - 1], 0u);
  return r;
}

// x (< 2p, and 2p < 2^(32L)) -> x mod p.
template <int L>
__device__ __forceinline__ Fe<L> cond_sub_p_cc(const Fe<L>& a, const FieldConst<L>& F) {
  Fe<L> d;
  d.v[0] = ptx::sub_cc_(a.v[0], F.p[0]);
#pragma unroll
  for (int i = 1; i < L; ++i) d.v[i] = ptx::subc_cc_(a.v[i], F.p[i]);
  const uint32_t borrow = ptx::subc_(0u, 0u);
  return fe_select(borrow != 0u, a, d);
}

template <int L>
__device__ __forceinline__ Fe<L> add_mod_cc(const Fe<L>& a, const Fe<L>& b,
                                            const FieldConst<L>& F) {
  Fe<L> s;   // a + b < 2p < 2^(32L): no carry out
  s.v[0] = ptx::add_cc_(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < L - 1; ++i) s.v[i] = ptx::addc_cc_(a.v[i], b.v[i]);
  s.v[L - 1] = ptx::addc_(a.v[L - 1], b.v[L - 1]);
  return cond_sub_p_cc(s, F);
}

// (a - b) mod p for canonical a, b: a - b, plus p where that borrowed.
template <int L>
__device__ __forceinline__ Fe<L> sub_mod_cc(const Fe<L>& a, const Fe<L>& b,
                                            const FieldConst<L>& F) {
  Fe<L> d;
  d.v[0] = ptx::sub_cc_(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < L; ++i) d.v[i] = ptx::subc_cc_(a.v[i], b.v[i]);
  const uint32_t mask = ptx::subc_(0u, 0u);   // all ones where a < b
  d.v[0] = ptx::add_cc_(d.v[0], F.p[0] & mask);
#pragma unroll
  for (int i = 1; i < L - 1; ++i) d.v[i] = ptx::addc_cc_(d.v[i], F.p[i] & mask);
  d.v[L - 1] = ptx::addc_(d.v[L - 1], F.p[L - 1] & mask);
  return d;
}

// p - b as an L-word integer (p for b = 0): the Fq2 product's stand-in for
// -b that keeps a sum of products non-negative.
template <int L>
__device__ __forceinline__ Fe<L> p_minus(const Fe<L>& b, const FieldConst<L>& F) {
  Fe<L> d;
  d.v[0] = ptx::sub_cc_(F.p[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < L - 1; ++i) d.v[i] = ptx::subc_cc_(F.p[i], b.v[i]);
  d.v[L - 1] = ptx::subc_(F.p[L - 1], b.v[L - 1]);
  return d;
}

// Montgomery product a b R^-1 mod p of canonical a, b, canonical result:
// CIOS with the even and odd columns in separate carry chains, the two
// arrays merged once at the end (the usual shape of 32-bit-limb Montgomery
// multiplication on NVIDIA cards).  About 2L^2 + L multiply-adds, each one
// mad.lo or mad.hi link.
template <int L>
__device__ __forceinline__ Fe<L> mont_mul_cc(const Fe<L>& a, const Fe<L>& b,
                                             const FieldConst<L>& F) {
  static_assert(L % 2 == 0, "the even/odd split takes an even limb count");
  uint32_t even[L], odd[L];
  mad_n_redc<L, true>(even, odd, a.v, b.v[0], F);
  mad_n_redc<L, false>(odd, even, a.v, b.v[1], F);
#pragma unroll
  for (int i = 2; i < L; i += 2) {
    mad_n_redc<L, false>(even, odd, a.v, b.v[i], F);
    mad_n_redc<L, false>(odd, even, a.v, b.v[i + 1], F);
  }
  return cond_sub_p_cc(merge_rows<L>(even, odd), F);
}

// (a b + c d) R^-1 mod p, canonical, for a, b, c < p and d <= p: the CIOS
// rows of mont_mul_cc with both products added in each row before its
// reduction step, on the same 2L accumulator words (one reduction for the
// sum, where two products would take two).  The running value stays below
// 3p + 1 and a row's sum below 3p (1 + 2^32) + 1, which is below
// 2^(32(L+1)) when p < 2^(32L - 2): then no chain carries out of the top
// word.  That holds for BN254 Fq (p < 2^254) and BLS12-381 Fq (p < 2^381),
// the fields of the G2 kernels, not for BLS12-381 Fr (p < 2^255).  The
// result (a b + c d + m p) / R is below 2p because a b + c d < 2p^2 and
// 2p < R.
template <int L>
__device__ __forceinline__ Fe<L> mont_sum2_cc(const Fe<L>& a, const Fe<L>& b, const Fe<L>& c,
                                              const Fe<L>& d, const FieldConst<L>& F) {
  uint32_t even[L], odd[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint32_t* e = (i & 1) ? odd : even;   // the arrays swap roles each row
    uint32_t* o = (i & 1) ? even : odd;
    if (i == 0) {
      mul_n<L>(o, a.v + 1, b.v[0]);
      mul_n<L>(e, a.v, b.v[0]);
    } else {
      e[0] = ptx::add_cc_(e[0], o[1]);
      madc_n_rshift<L>(o, a.v + 1, b.v[i]);
      cmad_n<L>(e, a.v, b.v[i]);
      o[L - 1] = ptx::addc_(o[L - 1], 0u);
    }
    cmad_n<L>(o, c.v + 1, d.v[i]);
    cmad_n<L>(e, c.v, d.v[i]);
    o[L - 1] = ptx::addc_(o[L - 1], 0u);
    const uint32_t m = e[0] * F.n0inv;
    cmad_n<L>(o, F.p + 1, m);
    cmad_n<L>(e, F.p, m);
    o[L - 1] = ptx::addc_(o[L - 1], 0u);
  }
  return cond_sub_p_cc(merge_rows<L>(even, odd), F);
}

#ifndef CC_HOST_MODEL
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

// The cooperative kernels' grid: blocks of `threads` (fewer when the lanes
// do not fill one) serving `per_warp` lanes a warp; at most 64 blocks an
// SM, the rest by striding.
struct Shape {
  unsigned blocks;
  int threads;
};

inline Shape shape_for(long long n, int threads, int per_warp) {
  const long long warps = (n + per_warp - 1) / per_warp;
  if (warps * 32 < threads) threads = (int)(warps * 32);
  const long long per_block = (long long)(threads / 32) * per_warp;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return {(unsigned)blocks, threads};
}
#endif

}  // namespace cc
