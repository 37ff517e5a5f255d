// The complete projective addition of the curve kernels: Renes-Costello-
// Batina 2016 Algorithm 7 on y^2 = x^3 + b (a = 0), valid for every input:
// identity (0 : 1 : 0), doubling, inverse points.  Three forms of it:
// ec_add_core, one lane a thread over a field-operations class (K6
// ec_wave_add over FqOps); ec_add_pair, a pair of threads a lane over
// Fq2 = Fq[u]/(u^2 + 1) (the G2 add and the G2 wave; the non-residue is
// u^2 = -1 for BN254 and for BLS12-381); ec_add_team, a team of threads a
// lane over Fq (K4 ec_add).
#pragma once
#include "field.cuh"

namespace cc {

// ------------------------------------------------------------- base field
template <int L>
struct FqOps {
  typedef Fe<L> El;
  const FieldConst<L>& F;
  __device__ explicit FqOps(const FieldConst<L>& f) : F(f) {}
  __device__ __forceinline__ El add(const El& a, const El& b) const { return add_mod(a, b, F); }
  __device__ __forceinline__ El sub(const El& a, const El& b) const { return sub_mod(a, b, F); }
  __device__ __forceinline__ El mul(const El& a, const El& b) const { return mont_mul(a, b, F); }
  __device__ __forceinline__ El b3() const { return fe_const(F.b3); }
};

// --------------------------------------------------------------- formula
template <class K>
__device__ __forceinline__ void ec_add_core(const K& k, const typename K::El& x1,
                                            const typename K::El& y1, const typename K::El& z1,
                                            const typename K::El& x2, const typename K::El& y2,
                                            const typename K::El& z2, typename K::El& X3,
                                            typename K::El& Y3, typename K::El& Z3) {
  typedef typename K::El El;
  const El b3 = k.b3();
  const El m_xx = k.mul(x1, x2);
  const El m_yy = k.mul(y1, y2);
  const El m_zz = k.mul(z1, z2);
  const El t3 = k.sub(k.sub(k.mul(k.add(x1, y1), k.add(x2, y2)), m_xx), m_yy);  // X1Y2+X2Y1
  const El t4 = k.sub(k.sub(k.mul(k.add(y1, z1), k.add(y2, z2)), m_yy), m_zz);  // Y1Z2+Y2Z1
  const El xz = k.sub(k.sub(k.mul(k.add(x1, z1), k.add(x2, z2)), m_xx), m_zz);  // X1Z2+X2Z1
  const El t0 = k.add(k.add(m_xx, m_xx), m_xx);                                  // 3 X1X2
  const El t2 = k.mul(m_zz, b3);                                                 // b3 Z1Z2
  const El z3p = k.add(m_yy, t2);
  const El t1 = k.sub(m_yy, t2);
  const El y3 = k.mul(xz, b3);                                                   // b3 (X1Z2+X2Z1)
  X3 = k.sub(k.mul(t3, t1), k.mul(t4, y3));
  Y3 = k.add(k.mul(t1, z3p), k.mul(y3, t0));
  Z3 = k.add(k.mul(z3p, t4), k.mul(t0, t3));
}

// ================================================= cooperative designs
// The formula above, split over threads that exchange operands through
// warp shuffles, on the carry-chain arithmetic of field.cuh.  Every thread
// of a warp must reach every shuffle: callers run lanes past the end and
// masked lanes on a clamped lane and skip only their stores.

constexpr unsigned kFullMask = 0xffffffffu;

template <int L>
__device__ __forceinline__ Fe<L> shfl_idx(const Fe<L>& a, int src) {
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = __shfl_sync(kFullMask, a.v[i], src);
  return r;
}

template <int L>
__device__ __forceinline__ Fe<L> shfl_partner(const Fe<L>& a) {
  Fe<L> r;
#pragma unroll
  for (int i = 0; i < L; ++i) r.v[i] = __shfl_xor_sync(kFullMask, a.v[i], 1);
  return r;
}

// ---------------------------------------------------- G2: a pair a lane
// Thread c (0 or 1) of a pair holds component c of every Fq2 value; adds
// and subtracts are its own.  A product needs the partner's components:
//   c = 0:  REDC(a0 b0 + a1 (p - b1)) = (a0 b0 - a1 b1) R^-1 mod p
//   c = 1:  REDC(a1 b0 + a0 b1)       = (a0 b1 + a1 b0) R^-1 mod p
// one sum of two products and one Montgomery reduction each (lazy
// reduction), where Karatsuba on one thread takes three full products.
// p - b1 stands in for -b1 so that the sum stays non-negative.  Both sums
// are below 2p^2 for canonical operands (p - b1 <= p), and 2p^2 < pR since
// 2p < R: for BN254 p < 2^254, R = 2^256; for BLS12-381 Fq p < 2^381,
// R = 2^384.  So REDC's input is below pR and its output canonical.
// The sum and its reduction run as one set of CIOS rows (field.cuh
// `mont_sum2_cc`, 2L accumulator words).
template <int L>
__device__ __forceinline__ Fe<L> fq2_mul_half(const Fe<L>& a, const Fe<L>& b, const Fe<L>& ao,
                                              const Fe<L>& bo, bool c1, const FieldConst<L>& F) {
  const Fe<L> y = fe_select(c1, bo, b);
  const Fe<L> w = fe_select(c1, b, p_minus(bo, F));
  return mont_sum2_cc(a, y, ao, w, F);
}

template <int L>
struct Fq2PairOps {
  typedef Fe<L> El;
  const FieldConst<L>& F;
  const bool c1;   // this thread holds the imaginary parts
  __device__ Fq2PairOps(const FieldConst<L>& f, bool c) : F(f), c1(c) {}
  __device__ __forceinline__ El add(const El& a, const El& b) const { return add_mod_cc(a, b, F); }
  __device__ __forceinline__ El sub(const El& a, const El& b) const { return sub_mod_cc(a, b, F); }
  __device__ __forceinline__ El mul(const El& a, const El& b) const {
    return fq2_mul_half<L>(a, b, shfl_partner(a), shfl_partner(b), c1, F);
  }
  // a * 3b: both components of the constant are at hand, no exchange for them
  __device__ __forceinline__ El mul_b3(const El& a) const {
    const El own = fe_select(c1, fe_const(F.b3i), fe_const(F.b3));
    const El other = fe_select(c1, fe_const(F.b3), fe_const(F.b3i));
    return fq2_mul_half<L>(a, own, shfl_partner(a), other, c1, F);
  }
};

// The complete addition over a pair: every argument and result is this
// thread's component of an Fq2 coordinate.
template <int L>
__device__ __forceinline__ void ec_add_pair(const Fq2PairOps<L>& k, const Fe<L>& x1,
                                            const Fe<L>& y1, const Fe<L>& z1, const Fe<L>& x2,
                                            const Fe<L>& y2, const Fe<L>& z2, Fe<L>& X3,
                                            Fe<L>& Y3, Fe<L>& Z3) {
  typedef Fe<L> El;
  const El m_xx = k.mul(x1, x2);
  const El m_yy = k.mul(y1, y2);
  const El m_zz = k.mul(z1, z2);
  const El t3 = k.sub(k.sub(k.mul(k.add(x1, y1), k.add(x2, y2)), m_xx), m_yy);  // X1Y2+X2Y1
  const El t4 = k.sub(k.sub(k.mul(k.add(y1, z1), k.add(y2, z2)), m_yy), m_zz);  // Y1Z2+Y2Z1
  const El xz = k.sub(k.sub(k.mul(k.add(x1, z1), k.add(x2, z2)), m_xx), m_zz);  // X1Z2+X2Z1
  const El t0 = k.add(k.add(m_xx, m_xx), m_xx);                                  // 3 X1X2
  const El t2 = k.mul_b3(m_zz);                                                  // b3 Z1Z2
  const El z3p = k.add(m_yy, t2);
  const El t1 = k.sub(m_yy, t2);
  const El y3 = k.mul_b3(xz);                                                    // b3 (X1Z2+X2Z1)
  X3 = k.sub(k.mul(t3, t1), k.mul(t4, y3));
  Y3 = k.add(k.mul(t1, z3p), k.mul(y3, t0));
  Z3 = k.add(k.mul(z3p, t4), k.mul(t0, t3));
}

// ------------------------------------------------ G1: a team of S a lane
// The formula has three stages of independent products: six (the squares
// and cross products of the inputs), two (the products by 3b), six (the
// output products).  A team of S threads (S = 1 or 3) holds the inputs
// in every member; in each stage member u takes products u, u + S, ... and
// the results go to every member by shuffles; the add/subtract glue between
// stages runs in every member.  Output product pairs (2q, 2q + 1) make
// coordinate q; member q mod S stores it.
//
// The P products of one stage, all returned to every member.  Operand
// pair k comes from ops(k, a, b), called with constant k (the loops unroll),
// so an operand that is a sum is formed where it is used.  `base` is the
// warp lane of member 0.
template <int L, int S, int P, class Ops>
__device__ __forceinline__ void team_products(const Ops& ops, Fe<L> (&out)[P], int u, int base,
                                              const FieldConst<L>& F) {
  constexpr int rounds = (P + S - 1) / S;
#pragma unroll
  for (int r = 0; r < rounds; ++r) {
    Fe<L> a, b;
    ops(r * S, a, b);
#pragma unroll
    for (int v = 1; v < S; ++v) {
      Fe<L> av, bv;
      ops((r * S + v < P) ? r * S + v : P - 1, av, bv);
      a = fe_select(u == v, av, a);
      b = fe_select(u == v, bv, b);
    }
    const Fe<L> m = mont_mul_cc(a, b, F);
    if (S == 1) {
      out[r] = m;
    } else {
#pragma unroll
      for (int v = 0; v < S; ++v)
        if (r * S + v < P) out[r * S + v] = shfl_idx(m, base + v);
    }
  }
}

// Stage 1: x1 x2, y1 y2, z1 z2, (x1 + y1)(x2 + y2), (y1 + z1)(y2 + z2),
// (x1 + z1)(x2 + z2).
template <int L>
struct Stage1 {
  const Fe<L> &x1, &y1, &z1, &x2, &y2, &z2;
  const FieldConst<L>& F;
  __device__ __forceinline__ void operator()(int k, Fe<L>& a, Fe<L>& b) const {
    switch (k) {
      case 0: a = x1; b = x2; break;
      case 1: a = y1; b = y2; break;
      case 2: a = z1; b = z2; break;
      case 3: a = add_mod_cc(x1, y1, F); b = add_mod_cc(x2, y2, F); break;
      case 4: a = add_mod_cc(y1, z1, F); b = add_mod_cc(y2, z2, F); break;
      default: a = add_mod_cc(x1, z1, F); b = add_mod_cc(x2, z2, F); break;
    }
  }
};

// Stage 2: z1z2 3b and (x1z2 + x2z1) 3b.
template <int L>
struct Stage2 {
  const Fe<L> &m_zz, &xz;
  const FieldConst<L>& F;
  __device__ __forceinline__ void operator()(int k, Fe<L>& a, Fe<L>& b) const {
    a = (k == 0) ? m_zz : xz;
    b = fe_const(F.b3);
  }
};

// Stage 3: X3 = t3 t1 - t4 y3, Y3 = t1 z3p + y3 t0, Z3 = z3p t4 + t0 t3 as
// the product pairs (0, 1), (2, 3), (4, 5).
template <int L>
struct Stage3 {
  const Fe<L> &t3, &t4, &t1, &y3, &z3p, &t0;
  __device__ __forceinline__ void operator()(int k, Fe<L>& a, Fe<L>& b) const {
    switch (k) {
      case 0: a = t3; b = t1; break;
      case 1: a = t4; b = y3; break;
      case 2: a = t1; b = z3p; break;
      case 3: a = y3; b = t0; break;
      case 4: a = z3p; b = t4; break;
      default: a = t0; b = t3; break;
    }
  }
};

// One complete G1 add by a team; out[q] is coordinate q (X3, Y3, Z3),
// meaningful in member q mod S.
template <int L, int S>
__device__ __forceinline__ void ec_add_team(const FieldConst<L>& F, int u, int base,
                                            const Fe<L>& x1, const Fe<L>& y1, const Fe<L>& z1,
                                            const Fe<L>& x2, const Fe<L>& y2, const Fe<L>& z2,
                                            Fe<L> (&out)[3]) {
  static_assert(S == 1 || S == 3, "teams of 1 or 3 threads");
  typedef Fe<L> El;
  El w1[6];
  team_products<L, S, 6>(Stage1<L>{x1, y1, z1, x2, y2, z2, F}, w1, u, base, F);
  const El& m_xx = w1[0];
  const El& m_yy = w1[1];
  const El& m_zz = w1[2];
  const El t3 = sub_mod_cc(sub_mod_cc(w1[3], m_xx, F), m_yy, F);   // X1Y2+X2Y1
  const El t4 = sub_mod_cc(sub_mod_cc(w1[4], m_yy, F), m_zz, F);   // Y1Z2+Y2Z1
  const El xz = sub_mod_cc(sub_mod_cc(w1[5], m_xx, F), m_zz, F);   // X1Z2+X2Z1
  const El t0 = add_mod_cc(add_mod_cc(m_xx, m_xx, F), m_xx, F);    // 3 X1X2
  El w2[2];
  team_products<L, S, 2>(Stage2<L>{m_zz, xz, F}, w2, u, base, F);
  const El& t2 = w2[0];                                            // b3 Z1Z2
  const El& y3 = w2[1];                                            // b3 (X1Z2+X2Z1)
  const El z3p = add_mod_cc(m_yy, t2, F);
  const El t1 = sub_mod_cc(m_yy, t2, F);
  const Stage3<L> s3{t3, t4, t1, y3, z3p, t0};
  if (S == 1) {
    El w3[6];
    team_products<L, 1, 6>(s3, w3, u, base, F);
    out[0] = sub_mod_cc(w3[0], w3[1], F);
    out[1] = add_mod_cc(w3[2], w3[3], F);
    out[2] = add_mod_cc(w3[4], w3[5], F);
  } else {
    // member u takes both products of coordinate u: no exchange
    El e, eb, o, ob;
    s3(0, e, eb);
    s3(1, o, ob);
#pragma unroll
    for (int v = 1; v < 3; ++v) {
      El ev, ebv, ov, obv;
      s3(2 * v, ev, ebv);
      s3(2 * v + 1, ov, obv);
      e = fe_select(u == v, ev, e);
      eb = fe_select(u == v, ebv, eb);
      o = fe_select(u == v, ov, o);
      ob = fe_select(u == v, obv, ob);
    }
    const El pe = mont_mul_cc(e, eb, F);
    const El po = mont_mul_cc(o, ob, F);
    const El res = fe_select(u == 0, sub_mod_cc(pe, po, F), add_mod_cc(pe, po, F));
    out[0] = res;
    out[1] = res;
    out[2] = res;
  }
}

}  // namespace cc
