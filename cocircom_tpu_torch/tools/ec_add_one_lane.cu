// The one-lane-a-thread design of the G1 and G2 adds that csrc/ec_add.cu,
// csrc/ec_add_g2.cu and csrc/ec_wave_add_g2.cu replaced, kept as the
// yardstick of the launch sweep (cocircom_tpu_torch/tools/launch_variants.py
// builds this file; no path runs it): one lane a thread, the 64-bit CIOS
// product (field.cuh `mont_mul`), blocks of 128, and the G2 add over
// `Fq2Ops` below, whose product is not inlined.  cc_ec_wave_add_g2 is the G2
// wave in the same design (K6's shape over Fq2Ops).  Same C entry points and
// arguments as those three sources.
#include "curve.cuh"

using namespace cc;

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

// --------------------------------------------------------------- G2 wave
struct G2Acc {
  uint32_t* a[6];
};

template <int L>
__global__ void ec_wave_add_g2_kernel(G2Acc acc, const uint32_t* __restrict__ rows,
                                      const uint8_t* __restrict__ neg,
                                      const uint8_t* __restrict__ valid, long long n,
                                      FieldConst<L> F) {
  const Fq2Ops<L> k(F);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    if (valid[j] == 0) continue;
    Fe<L> pt[6];
    row_load<L, 6>(rows + j * (6 * L), pt);
    Fe2<L> y2;
    y2.c0 = pt[2];
    y2.c1 = pt[3];
    if (neg[j] != 0) {
      y2.c0 = sub_mod(fe_zero<L>(), y2.c0, F);
      y2.c1 = sub_mod(fe_zero<L>(), y2.c1, F);
    }
    Fe2<L> x2, z2;
    x2.c0 = pt[0];
    x2.c1 = pt[1];
    z2.c0 = pt[4];
    z2.c1 = pt[5];
    Fe2<L> X3, Y3, Z3;
    ec_add_core(k, fe2_load<L>(acc.a[0], acc.a[1], n, j), fe2_load<L>(acc.a[2], acc.a[3], n, j),
                fe2_load<L>(acc.a[4], acc.a[5], n, j), x2, y2, z2, X3, Y3, Z3);
    fe_store(acc.a[0], n, j, X3.c0);
    fe_store(acc.a[1], n, j, X3.c1);
    fe_store(acc.a[2], n, j, Y3.c0);
    fe_store(acc.a[3], n, j, Y3.c1);
    fe_store(acc.a[4], n, j, Z3.c0);
    fe_store(acc.a[5], n, j, Z3.c1);
  }
}

template <int L>
static int launch_wave_g2(const G2Acc& acc, const void* rows, const void* neg, const void* valid,
                          long long n, const void* consts, void* stream) {
  const int threads = 128;
  ec_wave_add_g2_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      acc, (const uint32_t*)rows, (const uint8_t*)neg, (const uint8_t*)valid, n,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ec_wave_add_g2(void* const* acc, const void* rows, const void* neg,
                                 const void* valid, long long n, int limbs, const void* consts,
                                 void* stream) {
  G2Acc a;
  for (int i = 0; i < 6; ++i) a.a[i] = (uint32_t*)acc[i];
  if (limbs == 8) return launch_wave_g2<8>(a, rows, neg, valid, n, consts, stream);
  if (limbs == 12) return launch_wave_g2<12>(a, rows, neg, valid, n, consts, stream);
  return bad_limbs();
}
