// The one-lane-a-thread design of the curve kernels that csrc/ec_add.cu,
// csrc/ec_add_g2.cu, csrc/ec_wave_add_g2.cu, csrc/ec_madd.cu and
// csrc/ec_wave_add.cu replaced, kept as the yardstick of the launch sweep
// (cocircom_tpu_torch/tools/launch_variants.py builds this file; no path
// runs it): one lane a thread, the 64-bit CIOS product (field.cuh
// `mont_mul`), and the G2 add over `Fq2Ops` below, whose product is not
// inlined.  cc_ec_add, cc_ec_add_g2 and cc_ec_wave_add_g2 take the same
// arguments as the committed sources (cc_ec_wave_add_g2 is K6's old shape
// over Fq2Ops).  cc_ec_madd and cc_ec_wave_add are K5 and K6 as they were
// before they read their wave's rows themselves: they take rows that the
// wave's gather already wrote, one per lane, and per-lane masks, with
// their old launch shapes (K5 blocks of 128; K6 blocks of 64 held to 128
// registers at 8 limbs, blocks of 128 at 12).
#include "curve.cuh"

using namespace cc;

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

// ------------------------------------------- K5 and K6 on gathered rows
// K5: acc += row (madd-2007-bl; (0, 0) = identity) where valid; rows (n, 2L).
template <int L>
__global__ void ec_madd_kernel(uint32_t* __restrict__ ax, uint32_t* __restrict__ ay,
                               uint32_t* __restrict__ az, const uint32_t* __restrict__ rows,
                               const uint8_t* __restrict__ valid, long long n, FieldConst<L> F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    if (valid[j] == 0) continue;
    Fe<L> pt[2];
    row_load<L, 2>(rows + j * (2 * L), pt);
    const Fe<L>& x2 = pt[0];
    const Fe<L>& y2 = pt[1];
    if (fe_is_zero(x2) && fe_is_zero(y2)) continue;
    const Fe<L> X1 = fe_load<L>(ax, n, j);
    const Fe<L> Y1 = fe_load<L>(ay, n, j);
    const Fe<L> Z1 = fe_load<L>(az, n, j);
    const Fe<L> z1z1 = mont_mul(Z1, Z1, F);
    const Fe<L> u2 = mont_mul(x2, z1z1, F);
    const Fe<L> s2 = mont_mul(y2, mont_mul(Z1, z1z1, F), F);
    const Fe<L> h = sub_mod(u2, X1, F);
    const Fe<L> hh = mont_mul(h, h, F);
    const Fe<L> hh2 = add_mod(hh, hh, F);
    const Fe<L> i4 = add_mod(hh2, hh2, F);
    const Fe<L> jj = mont_mul(h, i4, F);
    Fe<L> rr = sub_mod(s2, Y1, F);
    rr = add_mod(rr, rr, F);
    const Fe<L> v = mont_mul(X1, i4, F);
    const Fe<L> x3 = sub_mod(sub_mod(mont_mul(rr, rr, F), jj, F), add_mod(v, v, F), F);
    const Fe<L> y1j = mont_mul(Y1, jj, F);
    const Fe<L> y3 = sub_mod(mont_mul(rr, sub_mod(v, x3, F), F), add_mod(y1j, y1j, F), F);
    const Fe<L> zh = add_mod(Z1, h, F);
    const Fe<L> z3 = sub_mod(sub_mod(mont_mul(zh, zh, F), z1z1, F), hh, F);
    fe_store(ax, n, j, x3);
    fe_store(ay, n, j, y3);
    fe_store(az, n, j, z3);
  }
}

template <int L>
static int launch_madd(void* ax, void* ay, void* az, const void* rows, const void* valid,
                       long long n, const void* consts, void* stream) {
  const int threads = 128;
  ec_madd_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)rows, (const uint8_t*)valid, n,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ec_madd(void* ax, void* ay, void* az, const void* rows, const void* valid,
                          long long n, int limbs, const void* consts, void* stream) {
  if (limbs == 8) return launch_madd<8>(ax, ay, az, rows, valid, n, consts, stream);
  if (limbs == 12) return launch_madd<12>(ax, ay, az, rows, valid, n, consts, stream);
  return bad_limbs();
}

// K6: acc <- valid ? acc + (neg ? -row : row) : acc; rows (n, 3L).
template <int L>
struct OldWaveLaunch {
  static constexpr int threads = (L == 8) ? 64 : 128;
  static constexpr int min_blocks = (L == 8) ? 8 : 1;
};

template <int L>
__global__ void __launch_bounds__(OldWaveLaunch<L>::threads, OldWaveLaunch<L>::min_blocks)
ec_wave_add_kernel(uint32_t* __restrict__ ax, uint32_t* __restrict__ ay, uint32_t* __restrict__ az,
                   const uint32_t* __restrict__ rows, const uint8_t* __restrict__ neg,
                   const uint8_t* __restrict__ valid, long long n, FieldConst<L> F) {
  const FqOps<L> k(F);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    if (valid[j] == 0) continue;
    Fe<L> pt[3];
    row_load<L, 3>(rows + j * (3 * L), pt);
    if (neg[j] != 0) pt[1] = sub_mod(fe_zero<L>(), pt[1], F);
    Fe<L> X3, Y3, Z3;
    ec_add_core(k, fe_load<L>(ax, n, j), fe_load<L>(ay, n, j), fe_load<L>(az, n, j), pt[0], pt[1],
                pt[2], X3, Y3, Z3);
    fe_store(ax, n, j, X3);
    fe_store(ay, n, j, Y3);
    fe_store(az, n, j, Z3);
  }
}

template <int L>
static int launch_wave(void* ax, void* ay, void* az, const void* rows, const void* neg,
                       const void* valid, long long n, const void* consts, void* stream) {
  const int threads = OldWaveLaunch<L>::threads;
  ec_wave_add_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)rows, (const uint8_t*)neg,
      (const uint8_t*)valid, n, make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ec_wave_add(void* ax, void* ay, void* az, const void* rows, const void* neg,
                              const void* valid, long long n, int limbs, const void* consts,
                              void* stream) {
  if (limbs == 8) return launch_wave<8>(ax, ay, az, rows, neg, valid, n, consts, stream);
  if (limbs == 12) return launch_wave<12>(ax, ay, az, rows, neg, valid, n, consts, stream);
  return bad_limbs();
}
