// K6  ec_wave_add: the wave update of the complete-add MSM path.  Every lane
// holds a projective accumulator (X, Y, Z) in 3 x (L, n) arrays (L = 8 or
// 12) and receives one projective point from `rows` ((n, 3L) words, row j =
// [x limbs | y limbs | z limbs], the element-major row of the point table as
// the wave's gather returns it):
//     acc <- valid ? acc + (neg ? -pt : pt) : acc
// with the complete addition of csrc/curve.cuh (valid for the identity
// accumulator every lane starts at, for doubling and for inverse points) and
// -pt = (x : p - y : z), 0 staying 0.
//
// Replaces the TPU kernel `ec_wave_add_pallas` (cocircom_tpu/ops/pallas_curve.py,
// `_make_ec_wave_kernel`), which `MSM._wave_step` takes for G1 on the path
// every shard of the device-sharded prover runs (`MSM._msm_fused`).  That
// kernel takes three gathered and transposed (L, lanes) coordinate arrays and
// returns three new ones, because a gather plus a transpose is the cheap form
// on that chip.  Here the transpose would be a second pass over memory and a
// launch of its own, so each thread reads its lane's row where the gather
// left it (12L contiguous bytes as 16-byte loads) and the accumulator is
// updated IN PLACE: a lane with valid == 0 returns after reading one byte.
// Its row is whatever the clamped index found and never reaches the
// accumulator.
//
// Bound on an H100 (L = 8): 14 Montgomery products (about 1,900
// multiply-adds) for 290 bytes a live lane (three coordinates read and
// written, one row, two flags): about 6.6 multiply-adds per byte, above the
// card's ratio of 5, so the kernel is bound by the integer ALUs, as K4 is.
// The whole formula runs on registers in one launch.
//
// Launch shape.  Left to itself the compiler gives the 8-limb kernel 188
// registers a thread, which leaves an SM two blocks of 128 threads.  Held to
// 128 registers (blocks of 64 threads, eight to an SM) it spills 148 bytes a
// thread and runs 1.6 times as fast: more warps in flight hide the row loads
// and the multiply latency.  The 12-limb kernel is the other way round: any
// cap below 255 registers makes it spill hundreds of bytes and run 1.5 times
// slower, so it keeps blocks of 128 threads and no cap
// (cocircom_tpu_torch/tools/k6_launch_variants.py times the variants).
#include "curve.cuh"

using namespace cc;

template <int L>
struct WaveLaunch {
  static constexpr int threads = (L == 8) ? 64 : 128;
  static constexpr int min_blocks = (L == 8) ? 8 : 1;
};

template <int L>
__global__ void __launch_bounds__(WaveLaunch<L>::threads, WaveLaunch<L>::min_blocks)
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
static int launch(void* ax, void* ay, void* az, const void* rows, const void* neg,
                  const void* valid, long long n, const void* consts, void* stream) {
  const int threads = WaveLaunch<L>::threads;
  ec_wave_add_kernel<L><<<grid_for(n, threads, 32), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ax, (uint32_t*)ay, (uint32_t*)az, (const uint32_t*)rows, (const uint8_t*)neg,
      (const uint8_t*)valid, n, make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ec_wave_add(void* ax, void* ay, void* az, const void* rows, const void* neg,
                              const void* valid, long long n, int limbs, const void* consts,
                              void* stream) {
  if (limbs == 8) return launch<8>(ax, ay, az, rows, neg, valid, n, consts, stream);
  if (limbs == 12) return launch<12>(ax, ay, az, rows, neg, valid, n, consts, stream);
  return bad_limbs();
}
