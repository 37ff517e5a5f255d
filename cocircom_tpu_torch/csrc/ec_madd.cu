// K5  ec_madd: one G1 wave of the mixed-add MSM path, the whole wave in one
// launch.  The accumulator is Jacobian (X, Y, Z) in 3 x (L, lanes) arrays
// (L = 8 or 12), lanes = nw x (K+1) x T: lane j = (window, bucket b, rank r).
// The MSM's prepare lays every window's sorted runs out in a run-aligned,
// signed table of affine rows ((nw M_tab, 2L) words, row = [x | y limbs],
// the sign already applied; every run starts at a multiple of T), so wave w
// gives lane j the row
//     pos   = astart[window, b] + wT + r
//     valid = pos < aend[window, b]  and  b > 0
//     acc  <- valid ? acc + table[window M_tab + pos] : acc
// by madd-2007-bl (7 products and 4 squarings, run as 11 products).  A row of (0, 0) is the identity
// and leaves the lane untouched.  The formula is incomplete (no doubling, no
// identity accumulator); the MSM makes that unreachable by starting every
// lane at a salted point (cocircom_tpu_torch/ops/msm.py).
//
// Replaces the TPU kernel `ec_madd_pallas` (cocircom_tpu/ops/pallas_curve.py:507,
// `packed=True, has_neg=False`), whose split-halves packing of limb pairs is
// a work-around for that chip and is not kept: a row is 8L contiguous bytes
// (64 or 96), read as 16-byte loads.
//
// Bound on an H100 (L = 8): 7 Montgomery products and 4 squarings (1,384
// multiply-adds) a live lane, for 256 bytes (three coordinates read and
// written, one 64-byte row) and 16 bytes of run bounds a bucket: about 5.4
// multiply-adds a byte, above the card's ratio of 5, so bound by the
// integer ALUs.
//
// What held the old design back (kept as the sweep's yardstick in
// cocircom_tpu_torch/tools/ec_add_one_lane.cu): the 64-bit-intermediate CIOS
// product (1.8 IMAD and 1.9 IADD3 a counted multiply-add in SASS, against
// 1.0 and 0.5 on carry chains); 162 registers at 8 limbs, 3 blocks of 128 an
// SM; and around it, each wave, a few small PyTorch launches for the
// positions and the mask and a gather of T-row blocks that wrote the wave's
// rows to device memory (23 MB at the path's shape) for the kernel to read
// back.  This one runs the same formula in the same order on carry chains
// (field.cuh `mont_mul_cc`, `add_mod_cc`, `sub_mod_cc`: canonical results,
// so the same bits), derives its lane's row from the run bounds and reads it
// from the table only when the lane is valid.  One launch a wave, nothing
// else.
//
// Launch shape (block size, register cap) from the sweep
// (cocircom_tpu_torch/tools/launch_variants.py --only ec_madd; PERF.md).
#include "field.cuh"

using namespace cc;

// One line each: the sweep tool rewrites these lines in copies of the file.
// Left alone the compiler takes 192 registers (8 limbs) and 243 (12); held
// to 4 blocks of 128 an SM (128 registers, 76 bytes spilled) the 8-limb
// kernel takes 22% less time over a chunk's waves, held to 3 (168 registers,
// 216 bytes spilled) the 12-limb one 12% less (sweep, PERF.md).
template <int L> struct MaddLaunch;
template <> struct MaddLaunch<8> { static constexpr int threads = 128, min_blocks = 4; };
template <> struct MaddLaunch<12> { static constexpr int threads = 128, min_blocks = 3; };

// The wave's own inputs: the run bounds of the MSM's prepare (int64,
// row-major) and the wave's geometry.
struct MaddIdx {
  const long long* astart;   // (nw, kp1) aligned run start in the window's table
  const long long* aend;     // (nw, kp1) run end
  long long m_tab;           // table rows a window
  int kp1, t, lanes;         // K + 1, ranks a wave (T), nw kp1 T
  long long wt;              // w T
};

template <int L>
__global__ void __launch_bounds__(MaddLaunch<L>::threads, MaddLaunch<L>::min_blocks)
ec_madd_kernel(uint32_t* __restrict__ ax, uint32_t* __restrict__ ay, uint32_t* __restrict__ az,
               const uint32_t* __restrict__ table, MaddIdx q, FieldConst<L> F) {
  const int step = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < q.lanes; j += step) {
    const int wb = j / q.t;                 // window (K + 1) + b
    const int b = wb % q.kp1;
    const long long pos = q.astart[wb] + q.wt + (j - wb * q.t);
    if (b == 0 || pos >= q.aend[wb]) continue;
    Fe<L> pt[2];
    row_load<L, 2>(table + ((long long)(wb / q.kp1) * q.m_tab + pos) * (2 * L), pt);
    const Fe<L>& x2 = pt[0];
    const Fe<L>& y2 = pt[1];
    if (fe_is_zero(x2) && fe_is_zero(y2)) continue;

    const Fe<L> X1 = fe_load<L>(ax, q.lanes, j);
    const Fe<L> Y1 = fe_load<L>(ay, q.lanes, j);
    const Fe<L> Z1 = fe_load<L>(az, q.lanes, j);
    const Fe<L> z1z1 = mont_mul_cc(Z1, Z1, F);
    const Fe<L> u2 = mont_mul_cc(x2, z1z1, F);
    const Fe<L> s2 = mont_mul_cc(y2, mont_mul_cc(Z1, z1z1, F), F);
    const Fe<L> h = sub_mod_cc(u2, X1, F);
    const Fe<L> hh = mont_mul_cc(h, h, F);
    const Fe<L> hh2 = add_mod_cc(hh, hh, F);
    const Fe<L> i4 = add_mod_cc(hh2, hh2, F);
    const Fe<L> jj = mont_mul_cc(h, i4, F);
    Fe<L> rr = sub_mod_cc(s2, Y1, F);
    rr = add_mod_cc(rr, rr, F);
    const Fe<L> v = mont_mul_cc(X1, i4, F);
    const Fe<L> x3 = sub_mod_cc(sub_mod_cc(mont_mul_cc(rr, rr, F), jj, F), add_mod_cc(v, v, F), F);
    const Fe<L> y1j = mont_mul_cc(Y1, jj, F);
    const Fe<L> y3 = sub_mod_cc(mont_mul_cc(rr, sub_mod_cc(v, x3, F), F), add_mod_cc(y1j, y1j, F), F);
    const Fe<L> zh = add_mod_cc(Z1, h, F);
    const Fe<L> z3 = sub_mod_cc(sub_mod_cc(mont_mul_cc(zh, zh, F), z1z1, F), hh, F);
    fe_store(ax, q.lanes, j, x3);
    fe_store(ay, q.lanes, j, y3);
    fe_store(az, q.lanes, j, z3);
  }
}

#ifndef CC_HOST_MODEL
template <int L>
static int launch_madd(void* ax, void* ay, void* az, const void* table, const MaddIdx& q,
                       const void* consts, void* stream) {
  const Shape s = shape_for(q.lanes, MaddLaunch<L>::threads, 32);
  ec_madd_kernel<L><<<s.blocks, s.threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)table, q,
      make_consts<L>(consts));
  return launch_status();
}

// ax, ay, az: (L, nw kp1 t) accumulator, updated in place; table (nw m_tab,
// 2L); astart, aend (nw, kp1), int64.
extern "C" int cc_ec_madd(void* ax, void* ay, void* az, const void* table, const void* astart,
                          const void* aend, long long m_tab, int nw, int kp1, int t,
                          long long wt, int limbs, const void* consts, void* stream) {
  const MaddIdx q{(const long long*)astart, (const long long*)aend, m_tab, kp1, t, nw * kp1 * t,
                  wt};
  if (limbs == 8) return launch_madd<8>(ax, ay, az, table, q, consts, stream);
  if (limbs == 12) return launch_madd<12>(ax, ay, az, table, q, consts, stream);
  return bad_limbs();
}
#endif
