// K6  ec_wave_add: one G1 wave of the complete-add MSM path, the whole wave
// in one launch.  The accumulator is (X, Y, Z) in 3 x (L, lanes) arrays
// (L = 8 or 12), lanes = nw x (K+1) x T: lane j = (window, bucket b, rank r).
// Wave w adds rank wT + r of bucket b's sorted run into that lane:
//     pos   = bucket_start[window, b] + wT + r
//     valid = pos < n  and  sortedb[window, pos] == b  and  b > 0
//     src   = order[window, pos]            (pos clamped to n - 1)
//     neg   = digits[window, src] < 0
//     acc  <- valid ? acc + (neg ? -pts[src] : pts[src]) : acc
// pts is the chunk's element-major point table ((n, 3L) words, row i =
// [x | y | z limbs] of point i); order, sortedb, digits (nw, n) and
// bucket_start (nw, K+1) are the MSM's prepare (int64); -pt = (x : p - y :
// z), 0 staying 0.  The complete addition (RCB16 Alg. 7) is curve.cuh's
// `ec_add_team` with a team of one thread, the code K4 runs at its
// reduction shape: valid for the identity accumulator every lane starts at,
// for doubling and for inverse points.
//
// Replaces the TPU kernel `ec_wave_add_pallas` (cocircom_tpu/ops/pallas_curve.py:256,
// `_make_ec_wave_kernel`), which `MSM._wave_step` takes for G1 on the path
// every shard of the device-sharded prover runs (`MSM._msm_fused`).  That
// kernel takes three gathered and transposed (L, lanes) coordinate arrays.
//
// Bound on an H100 (L = 8): 12 Montgomery products (1,632 multiply-adds;
// the two by b3 = 9 are a few modular adds) a live lane, for about 320
// bytes (three coordinates read and written, one 96-byte row, three 8-byte
// indices): about 5.1 multiply-adds a byte, just above the card's ratio of
// 5, so the kernel is bound by the integer ALUs.
//
// What held the old design back (kept as the sweep's yardstick in
// cocircom_tpu_torch/tools/ec_add_one_lane.cu):
//   - the 64-bit-intermediate CIOS product: 1.8 IMAD and 1.9 IADD3 a
//     counted multiply-add in SASS, against 1.0 and 0.5 on carry chains;
//   - at 188 registers it left 2 blocks an SM, and held to 128 it spilled
//     148 bytes a thread (the 12-limb build spilled at 255);
//   - around it each wave was about ten small PyTorch launches (positions,
//     clamps, three index gathers, compares) and an `index_select` that wrote
//     the wave's rows to device memory (35 MB at the path's shape) for the
//     kernel to read back.
// What this one does: the products run on the carry flag (field.cuh
// `mont_mul_cc`), and the wave's index arithmetic runs in the kernel, which
// reads each live lane's row from the point table itself (16-byte loads; the
// chunk's table, 2^17 x 96 bytes, fits the 50 MB L2).  One launch a wave,
// nothing else; one thread a lane, and a masked lane stops after its
// indices.  A team of 3 threads a lane (K4's form where lanes are few) took
// 1.3-1.4x the time at 8 limbs and 1.1x at 12 over a chunk's waves: this
// wave has 360,624 lanes, the card is full without it.
//
// Launch shape (block size, register cap) from the sweep
// (cocircom_tpu_torch/tools/launch_variants.py --only ec_wave_add; PERF.md).
#include "curve.cuh"

using namespace cc;

// One line each: the sweep tool rewrites these lines in copies of the file.
// Left alone the compiler takes 206 registers (8 limbs) and 255 (12): 2 and
// 1 blocks of 128 an SM.  Held to 4 blocks (128 registers, 100 bytes
// spilled) the 8-limb kernel takes 18% less time over a chunk's waves, held
// to 3 (168 registers, 216 bytes spilled) the 12-limb one 10% less (sweep,
// PERF.md).
template <int L> struct WaveLaunch;
template <> struct WaveLaunch<8> { static constexpr int threads = 128, min_blocks = 4; };
template <> struct WaveLaunch<12> { static constexpr int threads = 128, min_blocks = 3; };

// The wave's own inputs: the MSM prepare's index arrays (int64, row-major)
// and the wave's geometry.
struct WaveIdx {
  const long long* order;          // (nw, n) point index by sorted position
  const long long* sortedb;        // (nw, n) bucket lane by sorted position
  const long long* digits;         // (nw, n) signed digit by point index
  const long long* bucket_start;   // (nw, kp1) first sorted position of a bucket
  long long n;                     // points in the chunk
  int kp1, t, lanes;               // K + 1, ranks a wave (T), nw kp1 T
  long long wt;                    // w T
};

template <int L>
__global__ void __launch_bounds__(WaveLaunch<L>::threads, WaveLaunch<L>::min_blocks)
ec_wave_add_kernel(uint32_t* __restrict__ ax, uint32_t* __restrict__ ay,
                   uint32_t* __restrict__ az, const uint32_t* __restrict__ pts, WaveIdx q,
                   FieldConst<L> F) {
  const int step = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < q.lanes; j += step) {
    const int wb = j / q.t;                  // window (K + 1) + b
    const int b = wb % q.kp1;
    const long long row0 = (long long)(wb / q.kp1) * q.n;
    const long long pos = q.bucket_start[wb] + q.wt + (j - wb * q.t);
    if (b == 0 || pos >= q.n) continue;
    if (q.sortedb[row0 + pos] != b) continue;   // past the end of bucket b's run
    const long long src = q.order[row0 + pos];
    Fe<L> pt[3];
    row_load<L, 3>(pts + src * (3 * L), pt);
    if (q.digits[row0 + src] < 0) pt[1] = sub_mod_cc(fe_zero<L>(), pt[1], F);   // 0 stays 0
    Fe<L> out[3];
    ec_add_team<L, 1>(F, 0, 0, fe_load<L>(ax, q.lanes, j), fe_load<L>(ay, q.lanes, j),
                      fe_load<L>(az, q.lanes, j), pt[0], pt[1], pt[2], out);
    fe_store(ax, q.lanes, j, out[0]);
    fe_store(ay, q.lanes, j, out[1]);
    fe_store(az, q.lanes, j, out[2]);
  }
}

#ifndef CC_HOST_MODEL
template <int L>
static int launch_wave(void* ax, void* ay, void* az, const void* pts, const WaveIdx& q,
                       const void* consts, void* stream) {
  const Shape s = shape_for(q.lanes, WaveLaunch<L>::threads, 32);
  ec_wave_add_kernel<L><<<s.blocks, s.threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)pts, q,
      make_consts<L>(consts));
  return launch_status();
}

// ax, ay, az: (L, nw kp1 t) accumulator, updated in place; pts (n, 3L);
// order, sortedb, digits (nw, n) and bucket_start (nw, kp1), int64.
extern "C" int cc_ec_wave_add(void* ax, void* ay, void* az, const void* pts, const void* order,
                              const void* sortedb, const void* digits, const void* bucket_start,
                              long long n, int nw, int kp1, int t, long long wt, int limbs,
                              const void* consts, void* stream) {
  const WaveIdx q{(const long long*)order, (const long long*)sortedb, (const long long*)digits,
                  (const long long*)bucket_start, n, kp1, t, nw * kp1 * t, wt};
  if (limbs == 8) return launch_wave<8>(ax, ay, az, pts, q, consts, stream);
  if (limbs == 12) return launch_wave<12>(ax, ay, az, pts, q, consts, stream);
  return bad_limbs();
}
#endif
