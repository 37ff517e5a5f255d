// The G2 wave of the complete-add MSM, in place on six (L, n) accumulator
// arrays (x0, x1, y0, y1, z0, z1):
//     acc <- valid ? acc + (neg ? -pt : pt) : acc
// with lane j's point read from row j of the gathered element-major (n, 6L)
// rows [x0 | x1 | y0 | y1 | z0 | z1].  The G2 form of K6
// (csrc/ec_wave_add.cu) on the pair body of the G2 add (curve.cuh
// `ec_add_pair`; design at the head of csrc/ec_add.cu).  Built for L = 8
// (BN254) and L = 12 (BLS12-381).  The JAX package's counterpart is an XLA
// composition: the G2 add plus a negate and two selects
// (cocircom_tpu/ops/msm.py, `MSM._wave_step`).
#include "curve.cuh"

using namespace cc;

// One line each: the sweep tool rewrites these lines in copies of the file.
// min_blocks = 1 leaves the register count to the compiler.
template <int L> struct G2WaveLaunch;
template <> struct G2WaveLaunch<8> { static constexpr int threads = 64, min_blocks = 1; };
template <> struct G2WaveLaunch<12> { static constexpr int threads = 64, min_blocks = 1; };

struct G2Acc {
  uint32_t* a[6];   // x0, x1, y0, y1, z0, z1
};

template <int L>
__global__ void __launch_bounds__(G2WaveLaunch<L>::threads, G2WaveLaunch<L>::min_blocks)
ec_wave_add_g2_kernel(G2Acc acc, const uint32_t* __restrict__ rows,
                      const uint8_t* __restrict__ neg, const uint8_t* __restrict__ valid,
                      long long n, FieldConst<L> F) {
  const bool c1 = threadIdx.x & 1;
  const int c = c1 ? 1 : 0;
  const Fq2PairOps<L> k(F, c1);
  const int pair = (threadIdx.x & 31) >> 1;
  const long long warps = blockDim.x >> 5;
  uint32_t* a[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] = c1 ? acc.a[2 * i + 1] : acc.a[2 * i];
  for (long long w0 = (long long)blockIdx.x * warps; w0 * 16 < n;
       w0 += (long long)gridDim.x * warps) {
    const long long first = (w0 + (threadIdx.x >> 5)) * 16;
    if (first >= n) continue;
    const long long j = first + pair;
    const bool live = j < n;
    const long long jc = live ? j : n - 1;
    const bool take = live && valid[jc] != 0;
    if (!__any_sync(kFullMask, take)) continue;   // every lane of the warp masked
    // this thread's component of the point: words (2i + c) L of the row
    const uint32_t* row = rows + jc * (6 * L);
    Fe<L> pt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Fe<L> one[1];
      row_load<L, 1>(row + (2 * i + c) * L, one);
      pt[i] = one[0];
    }
    if (neg[jc] != 0) pt[1] = sub_mod_cc(fe_zero<L>(), pt[1], F);   // 0 stays 0
    Fe<L> X3, Y3, Z3;
    ec_add_pair(k, fe_load<L>(a[0], n, jc), fe_load<L>(a[1], n, jc), fe_load<L>(a[2], n, jc),
                pt[0], pt[1], pt[2], X3, Y3, Z3);
    if (take) {
      fe_store(a[0], n, j, X3);
      fe_store(a[1], n, j, Y3);
      fe_store(a[2], n, j, Z3);
    }
  }
}

#ifndef CC_HOST_MODEL
template <int L>
static int launch_wave_g2(const G2Acc& acc, const void* rows, const void* neg, const void* valid,
                          long long n, const void* consts, void* stream) {
  const Shape s = shape_for(n, G2WaveLaunch<L>::threads, 16);
  ec_wave_add_g2_kernel<L><<<s.blocks, s.threads, 0, (cudaStream_t)stream>>>(
      acc, (const uint32_t*)rows, (const uint8_t*)neg, (const uint8_t*)valid, n,
      make_consts<L>(consts));
  return launch_status();
}

// acc: 6 device pointers (host array), updated in place.
extern "C" int cc_ec_wave_add_g2(void* const* acc, const void* rows, const void* neg,
                                 const void* valid, long long n, int limbs, const void* consts,
                                 void* stream) {
  G2Acc a;
  for (int i = 0; i < 6; ++i) a.a[i] = (uint32_t*)acc[i];
  if (limbs == 8) return launch_wave_g2<8>(a, rows, neg, valid, n, consts, stream);
  if (limbs == 12) return launch_wave_g2<12>(a, rows, neg, valid, n, consts, stream);
  return bad_limbs();
}
#endif
