// K4  ec_add: complete projective addition on y^2 = x^3 + b (a = 0),
// Renes-Costello-Batina 2016 Algorithm 7, one lane per thread.  Either
// operand may be one point broadcast to all lanes.  Valid for every input:
// identity (0 : 1 : 0), doubling, inverse points.
//
// Two instantiations of one formula:
//   cc_ec_add     G1, coordinates in Fq:  3 x (8, n) arrays per point.
//                 Replaces the TPU kernel `ec_add_pallas`
//                 (cocircom_tpu/ops/pallas_curve.py, `_ec_add_core`), which
//                 serves G1 scalar multiplication, suffix sums, bucket
//                 reduction, Horner and the prover's endgame adds.
//   cc_ec_add_g2  G2, coordinates in Fq2 = Fq[u]/(u^2 + 1): 6 x (8, n)
//                 arrays per point (real and imaginary part of x, y, z).
//                 The JAX package has no TPU kernel here: it composes three
//                 stacked field-multiply calls with XLA add/sub ops
//                 (cocircom_tpu/ops/curve.py, `CurveOps.add`).  On this card
//                 that composition is some 800 small launches per add, which
//                 the prover's G2 scalar multiplication and MSM Horner issue
//                 one lane at a time; one fused launch replaces them.
//
// Bound on an H100 (G1): 14 Montgomery products (about 1,900 multiply-adds)
// and some twenty add/sub chains for 288 bytes of traffic (six coordinates
// read, three written): about 7 multiply-adds per byte, so the kernel is
// bound by the integer ALUs.  G2: 14 Fq2 products by Karatsuba = 42 base
// products for 576 bytes, about 10 multiply-adds per byte, the same side.
// Running the whole formula on registers in one launch is what the design
// does about it: no intermediate ever reaches device memory.
#include "field.cuh"

using namespace cc;

// ------------------------------------------------------------- base field
struct FqOps {
  typedef Fe El;
  const FieldConst& F;
  __device__ explicit FqOps(const FieldConst& f) : F(f) {}
  __device__ __forceinline__ El add(const El& a, const El& b) const { return add_mod(a, b, F); }
  __device__ __forceinline__ El sub(const El& a, const El& b) const { return sub_mod(a, b, F); }
  __device__ __forceinline__ El mul(const El& a, const El& b) const { return mont_mul(a, b, F); }
  __device__ __forceinline__ El b3() const { return fe_const(F.b3); }
};

// ------------------------------------------------- quadratic extension
struct Fe2 {
  Fe c0, c1;
};

struct Fq2Ops {
  typedef Fe2 El;
  const FieldConst& F;
  __device__ explicit Fq2Ops(const FieldConst& f) : F(f) {}
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
    const Fe v0 = mont_mul(a.c0, b.c0, F);
    const Fe v1 = mont_mul(a.c1, b.c1, F);
    const Fe t = mont_mul(add_mod(a.c0, a.c1, F), add_mod(b.c0, b.c1, F), F);
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

// -------------------------------------------------------------------- G1
__global__ void ec_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                              uint32_t* __restrict__ oz, long long n, int p_bcast, int q_bcast,
                              FieldConst F) {
  const FqOps k(F);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sp = p_bcast ? 1 : n;
  const long long sq = q_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const long long jp = p_bcast ? 0 : j;
    const long long jq = q_bcast ? 0 : j;
    Fe X3, Y3, Z3;
    ec_add_core(k, fe_load(x1, sp, jp), fe_load(y1, sp, jp), fe_load(z1, sp, jp),
                fe_load(x2, sq, jq), fe_load(y2, sq, jq), fe_load(z2, sq, jq), X3, Y3, Z3);
    fe_store(ox, n, j, X3);
    fe_store(oy, n, j, Y3);
    fe_store(oz, n, j, Z3);
  }
}

extern "C" int cc_ec_add(const void* x1, const void* y1, const void* z1, const void* x2,
                         const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                         int p_bcast, int q_bcast, const void* consts, void* stream) {
  const FieldConst F = make_consts((const uint32_t*)consts);
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  ec_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      p_bcast, q_bcast, F);
  return launch_status();
}

// -------------------------------------------------------------------- G2
// Pointer tables: in[0..5] = P's (x0, x1, y0, y1, z0, z1), in[6..11] = Q's,
// out[0..5] likewise.
struct G2Ptrs {
  const uint32_t* in[12];
  uint32_t* out[6];
};

__device__ __forceinline__ Fe2 fe2_load(const uint32_t* c0, const uint32_t* c1, long long stride,
                                        long long j) {
  Fe2 r;
  r.c0 = fe_load(c0, stride, j);
  r.c1 = fe_load(c1, stride, j);
  return r;
}

__global__ void ec_add_g2_kernel(G2Ptrs ptrs, long long n, int p_bcast, int q_bcast,
                                 FieldConst F) {
  const Fq2Ops k(F);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sp = p_bcast ? 1 : n;
  const long long sq = q_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const long long jp = p_bcast ? 0 : j;
    const long long jq = q_bcast ? 0 : j;
    Fe2 X3, Y3, Z3;
    ec_add_core(k, fe2_load(ptrs.in[0], ptrs.in[1], sp, jp), fe2_load(ptrs.in[2], ptrs.in[3], sp, jp),
                fe2_load(ptrs.in[4], ptrs.in[5], sp, jp), fe2_load(ptrs.in[6], ptrs.in[7], sq, jq),
                fe2_load(ptrs.in[8], ptrs.in[9], sq, jq), fe2_load(ptrs.in[10], ptrs.in[11], sq, jq),
                X3, Y3, Z3);
    fe_store(ptrs.out[0], n, j, X3.c0);
    fe_store(ptrs.out[1], n, j, X3.c1);
    fe_store(ptrs.out[2], n, j, Y3.c0);
    fe_store(ptrs.out[3], n, j, Y3.c1);
    fe_store(ptrs.out[4], n, j, Z3.c0);
    fe_store(ptrs.out[5], n, j, Z3.c1);
  }
}

// in: 12 device pointers, out: 6 device pointers (host arrays of pointers).
extern "C" int cc_ec_add_g2(const void* const* in, void* const* out, long long n, int p_bcast,
                            int q_bcast, const void* consts, void* stream) {
  const FieldConst F = make_consts((const uint32_t*)consts);
  G2Ptrs ptrs;
  for (int i = 0; i < 12; ++i) ptrs.in[i] = (const uint32_t*)in[i];
  for (int i = 0; i < 6; ++i) ptrs.out[i] = (uint32_t*)out[i];
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  ec_add_g2_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(ptrs, n, p_bcast,
                                                                          q_bcast, F);
  return launch_status();
}
