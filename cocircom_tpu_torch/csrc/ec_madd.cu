// K5  ec_madd: the MSM wave update.  Every lane holds a Jacobian
// accumulator (X, Y, Z) in 3 x (L, n) arrays (L = 8 or 12) and receives one
// affine point from `rows` ((n, 2L) words, row j = [x limbs | y limbs], already gathered
// and already carrying its sign): acc += point by madd-2007-bl (11
// Montgomery products).  A row of (0, 0) is the identity and a lane with
// valid == 0 takes no point: both leave the lane untouched.  The formula is
// incomplete (no doubling, no identity accumulator); the MSM makes that
// unreachable by starting every lane at a salted point.
//
// Replaces the TPU kernel `ec_madd_pallas` (cocircom_tpu/ops/pallas_curve.py,
// `packed=True, has_neg=False`).  The accumulator is updated IN PLACE: a
// lane that takes no point is neither recomputed nor rewritten.  The TPU
// kernel's split-halves packing of limb pairs is a work-around for that
// chip and is not kept: a row is 8L contiguous bytes (64 or 96), read by its
// thread as 16-byte loads.
//
// Bound on an H100 (L = 8): about 1,500 multiply-adds for 257 bytes a live lane
// (three coordinates read and written, one row, one flag): about 6
// multiply-adds per byte, bound by the integer ALUs.
#include "field.cuh"

using namespace cc;

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
static int launch(void* ax, void* ay, void* az, const void* rows, const void* valid, long long n,
                  const void* consts, void* stream) {
  const int threads = 128;
  ec_madd_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)rows, (const uint8_t*)valid, n,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ec_madd(void* ax, void* ay, void* az, const void* rows, const void* valid,
                          long long n, int limbs, const void* consts, void* stream) {
  if (limbs == 8) return launch<8>(ax, ay, az, rows, valid, n, consts, stream);
  if (limbs == 12) return launch<12>(ax, ay, az, rows, valid, n, consts, stream);
  return bad_limbs();
}
