// The complete projective addition shared by the curve kernels (K4 ec_add,
// the G2 add and K6 ec_wave_add): Renes-Costello-Batina 2016 Algorithm 7 on
// y^2 = x^3 + b (a = 0), written once over a field-operations class K, with
// one class for the base field Fq and one for Fq2 = Fq[u]/(u^2 + 1) (the
// non-residue is u^2 = -1 for BN254 and for BLS12-381).  Valid for every
// input: identity (0 : 1 : 0), doubling, inverse points.
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

// ------------------------------------------------- quadratic extension
template <int L>
struct Fe2 {
  Fe<L> c0, c1;
};

template <int L>
struct Fq2Ops {
  typedef Fe2<L> El;
  const FieldConst<L>& F;
  __device__ explicit Fq2Ops(const FieldConst<L>& f) : F(f) {}
  __device__ __forceinline__ El add(const El& a, const El& b) const {
    El r;
    r.c0 = add_mod(a.c0, b.c0, F);
    r.c1 = add_mod(a.c1, b.c1, F);
    return r;
  }
  __device__ __forceinline__ El sub(const El& a, const El& b) const {
    El r;
    r.c0 = sub_mod(a.c0, b.c0, F);
    r.c1 = sub_mod(a.c1, b.c1, F);
    return r;
  }
  // Karatsuba over u^2 = -1: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
  __device__ __noinline__ El mul(const El& a, const El& b) const {
    const Fe<L> v0 = mont_mul(a.c0, b.c0, F);
    const Fe<L> v1 = mont_mul(a.c1, b.c1, F);
    const Fe<L> t = mont_mul(add_mod(a.c0, a.c1, F), add_mod(b.c0, b.c1, F), F);
    El r;
    r.c0 = sub_mod(v0, v1, F);
    r.c1 = sub_mod(sub_mod(t, v0, F), v1, F);
    return r;
  }
  __device__ __forceinline__ El b3() const {
    El r;
    r.c0 = fe_const(F.b3);
    r.c1 = fe_const(F.b3i);
    return r;
  }
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

}  // namespace cc
