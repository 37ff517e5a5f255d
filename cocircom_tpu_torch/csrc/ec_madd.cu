// K5  ec_madd: the MSM wave update.  Every lane holds a Jacobian
// accumulator (X, Y, Z) in 3 x (8, n) arrays and receives one affine point
// from `rows` ((n, 16) words, row j = [x limbs | y limbs], already gathered
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
// chip and is not kept: a row is 64 contiguous bytes, read by its thread
// as four 16-byte loads.
//
// Bound on an H100: about 1,500 multiply-adds for 257 bytes a live lane
// (three coordinates read and written, one row, one flag): about 6
// multiply-adds per byte, bound by the integer ALUs.
#include "field.cuh"

using namespace cc;

__global__ void ec_madd_kernel(uint32_t* __restrict__ ax, uint32_t* __restrict__ ay,
                               uint32_t* __restrict__ az, const uint32_t* __restrict__ rows,
                               const uint8_t* __restrict__ valid, long long n, FieldConst F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    if (valid[j] == 0) continue;
    const uint4* r = reinterpret_cast<const uint4*>(rows + j * (2 * L));
    const uint4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3];
    Fe x2, y2;
    x2.v[0] = r0.x; x2.v[1] = r0.y; x2.v[2] = r0.z; x2.v[3] = r0.w;
    x2.v[4] = r1.x; x2.v[5] = r1.y; x2.v[6] = r1.z; x2.v[7] = r1.w;
    y2.v[0] = r2.x; y2.v[1] = r2.y; y2.v[2] = r2.z; y2.v[3] = r2.w;
    y2.v[4] = r3.x; y2.v[5] = r3.y; y2.v[6] = r3.z; y2.v[7] = r3.w;
    if (fe_is_zero(x2) && fe_is_zero(y2)) continue;

    const Fe X1 = fe_load(ax, n, j);
    const Fe Y1 = fe_load(ay, n, j);
    const Fe Z1 = fe_load(az, n, j);
    const Fe z1z1 = mont_mul(Z1, Z1, F);
    const Fe u2 = mont_mul(x2, z1z1, F);
    const Fe s2 = mont_mul(y2, mont_mul(Z1, z1z1, F), F);
    const Fe h = sub_mod(u2, X1, F);
    const Fe hh = mont_mul(h, h, F);
    const Fe hh2 = add_mod(hh, hh, F);
    const Fe i4 = add_mod(hh2, hh2, F);
    const Fe jj = mont_mul(h, i4, F);
    Fe rr = sub_mod(s2, Y1, F);
    rr = add_mod(rr, rr, F);
    const Fe v = mont_mul(X1, i4, F);
    const Fe x3 = sub_mod(sub_mod(mont_mul(rr, rr, F), jj, F), add_mod(v, v, F), F);
    const Fe y1j = mont_mul(Y1, jj, F);
    const Fe y3 = sub_mod(mont_mul(rr, sub_mod(v, x3, F), F), add_mod(y1j, y1j, F), F);
    const Fe zh = add_mod(Z1, h, F);
    const Fe z3 = sub_mod(sub_mod(mont_mul(zh, zh, F), z1z1, F), hh, F);
    fe_store(ax, n, j, x3);
    fe_store(ay, n, j, y3);
    fe_store(az, n, j, z3);
  }
}

extern "C" int cc_ec_madd(void* ax, void* ay, void* az, const void* rows, const void* valid,
                          long long n, const void* consts, void* stream) {
  const FieldConst F = make_consts((const uint32_t*)consts);
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  ec_madd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)rows, (const uint8_t*)valid, n,
      F);
  return launch_status();
}
