// K4  ec_add: complete projective addition on y^2 = x^3 + b (a = 0),
// Renes-Costello-Batina 2016 Algorithm 7, one lane per thread.  Either
// operand may be one point broadcast to all lanes.  Valid for every input:
// identity (0 : 1 : 0), doubling, inverse points.
//
// Two instantiations of one formula (csrc/curve.cuh), each for L = 8 (BN254)
// and L = 12 (BLS12-381):
//   cc_ec_add     G1, coordinates in Fq:  3 x (L, n) arrays per point.
//                 Replaces the TPU kernel `ec_add_pallas`
//                 (cocircom_tpu/ops/pallas_curve.py, `_ec_add_core`), which
//                 serves G1 scalar multiplication, suffix sums, bucket
//                 reduction, Horner and the prover's endgame adds.
//   cc_ec_add_g2  G2, coordinates in Fq2 = Fq[u]/(u^2 + 1): 6 x (L, n)
//                 arrays per point (real and imaginary part of x, y, z).
//                 The JAX package has no TPU kernel here: it composes three
//                 stacked field-multiply calls with XLA add/sub ops
//                 (cocircom_tpu/ops/curve.py, `CurveOps.add`).  On this card
//                 that composition is some 800 small launches per add, which
//                 the prover's G2 scalar multiplication and MSM Horner issue
//                 one lane at a time; one fused launch replaces them.
//
// Bound on an H100 (G1, L = 8): 14 Montgomery products (about 1,900 multiply-adds)
// and some twenty add/sub chains for 288 bytes of traffic (six coordinates
// read, three written): about 7 multiply-adds per byte, so the kernel is
// bound by the integer ALUs.  G2: 14 Fq2 products by Karatsuba = 42 base
// products for 576 bytes, about 10 multiply-adds per byte, the same side.
// Running the whole formula on registers in one launch is what the design
// does about it: no intermediate ever reaches device memory.  At L = 12 a
// product is 300 multiply-adds for 1.5 times the bytes: further on the same
// side, and the live state (six inputs of 12 words, twice that over Fq2)
// no longer fits the register file of a thread, so the compiler spills.
#include "curve.cuh"

using namespace cc;

// -------------------------------------------------------------------- G1
template <int L>
__global__ void ec_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                              uint32_t* __restrict__ oz, long long n, int p_bcast, int q_bcast,
                              FieldConst<L> F) {
  const FqOps<L> k(F);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sp = p_bcast ? 1 : n;
  const long long sq = q_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const long long jp = p_bcast ? 0 : j;
    const long long jq = q_bcast ? 0 : j;
    Fe<L> X3, Y3, Z3;
    ec_add_core(k, fe_load<L>(x1, sp, jp), fe_load<L>(y1, sp, jp), fe_load<L>(z1, sp, jp),
                fe_load<L>(x2, sq, jq), fe_load<L>(y2, sq, jq), fe_load<L>(z2, sq, jq), X3, Y3,
                Z3);
    fe_store(ox, n, j, X3);
    fe_store(oy, n, j, Y3);
    fe_store(oz, n, j, Z3);
  }
}

template <int L>
static int launch_g1(const void* x1, const void* y1, const void* z1, const void* x2,
                     const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                     int p_bcast, int q_bcast, const void* consts, void* stream) {
  const int threads = 128;
  ec_add_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      p_bcast, q_bcast, make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ec_add(const void* x1, const void* y1, const void* z1, const void* x2,
                         const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                         int p_bcast, int q_bcast, int limbs, const void* consts, void* stream) {
  if (limbs == 8)
    return launch_g1<8>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, p_bcast, q_bcast, consts, stream);
  if (limbs == 12)
    return launch_g1<12>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, p_bcast, q_bcast, consts, stream);
  return bad_limbs();
}

// -------------------------------------------------------------------- G2
// Pointer tables: in[0..5] = P's (x0, x1, y0, y1, z0, z1), in[6..11] = Q's,
// out[0..5] likewise.
struct G2Ptrs {
  const uint32_t* in[12];
  uint32_t* out[6];
};

template <int L>
__device__ __forceinline__ Fe2<L> fe2_load(const uint32_t* c0, const uint32_t* c1,
                                           long long stride, long long j) {
  Fe2<L> r;
  r.c0 = fe_load<L>(c0, stride, j);
  r.c1 = fe_load<L>(c1, stride, j);
  return r;
}

template <int L>
__global__ void ec_add_g2_kernel(G2Ptrs ptrs, long long n, int p_bcast, int q_bcast,
                                 FieldConst<L> F) {
  const Fq2Ops<L> k(F);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sp = p_bcast ? 1 : n;
  const long long sq = q_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const long long jp = p_bcast ? 0 : j;
    const long long jq = q_bcast ? 0 : j;
    Fe2<L> X3, Y3, Z3;
    ec_add_core(k, fe2_load<L>(ptrs.in[0], ptrs.in[1], sp, jp),
                fe2_load<L>(ptrs.in[2], ptrs.in[3], sp, jp),
                fe2_load<L>(ptrs.in[4], ptrs.in[5], sp, jp),
                fe2_load<L>(ptrs.in[6], ptrs.in[7], sq, jq),
                fe2_load<L>(ptrs.in[8], ptrs.in[9], sq, jq),
                fe2_load<L>(ptrs.in[10], ptrs.in[11], sq, jq), X3, Y3, Z3);
    fe_store(ptrs.out[0], n, j, X3.c0);
    fe_store(ptrs.out[1], n, j, X3.c1);
    fe_store(ptrs.out[2], n, j, Y3.c0);
    fe_store(ptrs.out[3], n, j, Y3.c1);
    fe_store(ptrs.out[4], n, j, Z3.c0);
    fe_store(ptrs.out[5], n, j, Z3.c1);
  }
}

template <int L>
static int launch_g2(const G2Ptrs& ptrs, long long n, int p_bcast, int q_bcast,
                     const void* consts, void* stream) {
  const int threads = 128;
  ec_add_g2_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      ptrs, n, p_bcast, q_bcast, make_consts<L>(consts));
  return launch_status();
}

// in: 12 device pointers, out: 6 device pointers (host arrays of pointers).
extern "C" int cc_ec_add_g2(const void* const* in, void* const* out, long long n, int p_bcast,
                            int q_bcast, int limbs, const void* consts, void* stream) {
  G2Ptrs ptrs;
  for (int i = 0; i < 12; ++i) ptrs.in[i] = (const uint32_t*)in[i];
  for (int i = 0; i < 6; ++i) ptrs.out[i] = (uint32_t*)out[i];
  if (limbs == 8) return launch_g2<8>(ptrs, n, p_bcast, q_bcast, consts, stream);
  if (limbs == 12) return launch_g2<12>(ptrs, n, p_bcast, q_bcast, consts, stream);
  return bad_limbs();
}
