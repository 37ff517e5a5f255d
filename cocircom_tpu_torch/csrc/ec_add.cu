// K4  ec_add, and the design of the three cooperative curve kernels: K4 in
// this file, the G2 add (csrc/ec_add_g2.cu) and the G2 wave
// (csrc/ec_wave_add_g2.cu).  Complete projective addition on y^2 = x^3 + b
// (a = 0), Renes-Costello-Batina 2016 Algorithm 7.  Valid for every input:
// identity (0 : 1 : 0), doubling, inverse points.  Each kernel is built for
// L = 8 (BN254) and L = 12 (BLS12-381) limbs of 32 bits; each source is
// compiled by an nvcc of its own, so the three build in parallel.
//   cc_ec_add          G1, coordinates in Fq: 3 x (L, n) arrays a point;
//                      either operand may be one point broadcast to all
//                      lanes.  Replaces the TPU kernel `ec_add_pallas`
//                      (cocircom_tpu/ops/pallas_curve.py, `_ec_add_core`),
//                      which serves G1 scalar multiplication, suffix sums,
//                      bucket reduction, Horner and the prover's endgame.
//   cc_ec_add_g2       G2, coordinates in Fq2 = Fq[u]/(u^2 + 1): 6 x (L, n)
//                      arrays a point (real and imaginary part of x, y, z),
//                      broadcast as above.  The JAX package has no TPU
//                      kernel here: it composes stacked field-multiply calls
//                      with XLA add/sub ops (cocircom_tpu/ops/curve.py,
//                      `CurveOps.add`).
//   cc_ec_wave_add_g2  the G2 wave of the complete-add MSM, in place on six
//                      (L, n) accumulator arrays:
//                          acc <- valid ? acc + (neg ? -pt : pt) : acc
//                      with lane j's point read from row j of the gathered
//                      element-major (n, 6L) rows [x0 | x1 | y0 | y1 | z0 |
//                      z1].  The JAX package's counterpart is the same XLA
//                      composition plus a negate and two selects
//                      (cocircom_tpu/ops/msm.py, `MSM._wave_step`); this is
//                      the G2 form of K6 (csrc/ec_wave_add.cu).
//
// Bound on an H100.  G1 (L = 8): 14 Montgomery products (about 1,900
// multiply-adds) for 288 bytes (six coordinates read, three written): about
// 7 multiply-adds a byte, bound by the integer ALUs.  G2: 42 base products'
// worth for 576 bytes, about 10 a byte, the same side.  In the carry-chain
// product ptxas makes each counted multiply-add one IMAD (a mad.lo and a
// madc.hi link become one wide IMAD) and about half an IADD3; the 64-bit
// CIOS it replaced took 1.8 IMAD and 1.9 IADD3 (static counts, SASS).
//
// What held the one-lane-a-thread design back, and what this one does:
//   - Each product was CIOS with 64-bit intermediates, which the compiler
//     turns into IMAD.WIDE and 64-bit adds.  Now every product runs on the
//     carry flag (mont_mul_cc, mont_sum2_cc in field.cuh: mad.lo.cc /
//     madc.hi.cc, the even and odd columns in separate chains).
//   - G2: Fq2Ops::mul was __noinline__ (a 1,448-byte stack frame, four
//     elements passed and two returned through local memory for each of 14
//     calls), and at 248 registers an SM held 8 warps.  Now a PAIR of
//     threads serves one lane: thread c holds component c of every Fq2
//     value, so a thread's state is half as large, nothing is called, and
//     the pair swaps operands with __shfl_xor_sync.  Each Fq2 product is
//     two sums of products with one Montgomery reduction each (lazy
//     reduction, curve.cuh `fq2_mul_half`): c0 = REDC(a0 b0 + a1 (p - b1)),
//     c1 = REDC(a0 b1 + a1 b0), thread c computing c_c.  Both sums are below
//     2p^2, and 2p^2 < pR because 2p < R (BN254: p < 2^254, R = 2^256;
//     BLS12-381 Fq: p < 2^381, R = 2^384), so one reduction and one
//     conditional subtraction give the canonical result: the same bits as
//     the Karatsuba composition `ec_add_g2_plain`.  A thread runs one sum of
//     two products and its reduction as one set of CIOS rows
//     (`mont_sum2_cc`) where it ran three full products.
//   - G2 wave: the transpose, negate, add and three selects that surrounded
//     the G2 add in each wave are one launch; masked lanes are not stored
//     and a warp whose lanes are all masked skips the work.
//   - K4: one lane a thread gave the (8, 22, 2048) reduction shape 1,408
//     warps for 528 schedulers and each lane one chain of 14 dependent
//     products; at the 1-2 lanes of Horner and the endgame that chain is
//     all the time there is.  A TEAM of 3 threads now serves a lane where
//     lanes are few: the formula's three stages of independent products
//     (6, 2, 6) are dealt out over the team and the results shared by
//     __shfl_sync, so a lane's chain is 5 rounds of products instead of 14.
//     Where lanes are many the carry-chain product alone, one lane a
//     thread, is faster (the card is full there, and a team repeats the
//     glue between stages in each member).  The launcher picks by lane
//     count, at the crossover the sweep measured.
// Shuffles need every thread of the warp: lanes past n and masked lanes
// compute on a clamped lane and skip only their stores.
//
// Launch shapes (block size, register cap, team size) were chosen by timing
// variants on the card (cocircom_tpu_torch/tools/launch_variants.py; numbers
// in PERF.md).
#include "curve.cuh"

using namespace cc;

// One line each: the sweep tool rewrites these lines in copies of the file.
// K4 takes a team of `team_small` threads a lane at `small_lanes` lanes or
// fewer (Horner, the endgame's scalar multiplications, small reductions) and
// of `team` above: the largest lane count at which the sweep timed a team of
// 3 ahead of one lane a thread.  min_blocks = 1 leaves the register count to
// the compiler.
template <int L> struct AddLaunch;
template <> struct AddLaunch<8> { static constexpr int team = 1, team_small = 3, small_lanes = 8192, threads = 128, min_blocks = 1; };
template <> struct AddLaunch<12> { static constexpr int team = 1, team_small = 3, small_lanes = 11264, threads = 128, min_blocks = 3; };

template <int L, int S>
__global__ void __launch_bounds__(AddLaunch<L>::threads, AddLaunch<L>::min_blocks)
ec_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
              long long n, int p_bcast, int q_bcast, FieldConst<L> F) {
  constexpr int per_warp = 32 / S;   // lanes a warp serves (S = 3: lanes 30, 31 idle)
  const int team = (threadIdx.x & 31) / S;
  const int u = (threadIdx.x & 31) - team * S;
  const long long warps = blockDim.x >> 5;
  const long long sp = p_bcast ? 1 : n;
  const long long sq = q_bcast ? 1 : n;
  for (long long w0 = (long long)blockIdx.x * warps; w0 * per_warp < n;
       w0 += (long long)gridDim.x * warps) {
    const long long first = (w0 + (threadIdx.x >> 5)) * per_warp;
    if (first >= n) continue;   // the whole warp is past the end
    const long long j = first + team;
    const bool live = team < per_warp && j < n;
    const long long jc = live ? j : n - 1;
    const long long jp = p_bcast ? 0 : jc;
    const long long jq = q_bcast ? 0 : jc;
    Fe<L> out[3];
    ec_add_team<L, S>(F, u, team * S, fe_load<L>(x1, sp, jp), fe_load<L>(y1, sp, jp),
                      fe_load<L>(z1, sp, jp), fe_load<L>(x2, sq, jq), fe_load<L>(y2, sq, jq),
                      fe_load<L>(z2, sq, jq), out);
    if (live) {
      if (u == 0 % S) fe_store(ox, n, j, out[0]);
      if (u == 1 % S) fe_store(oy, n, j, out[1]);
      if (u == 2 % S) fe_store(oz, n, j, out[2]);
    }
  }
}

#ifndef CC_HOST_MODEL
template <int L, int S>
static int launch_g1(const void* x1, const void* y1, const void* z1, const void* x2,
                     const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                     int p_bcast, int q_bcast, const void* consts, void* stream) {
  const Shape s = shape_for(n, AddLaunch<L>::threads, 32 / S);
  ec_add_kernel<L, S><<<s.blocks, s.threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      p_bcast, q_bcast, make_consts<L>(consts));
  return launch_status();
}

template <int L>
static int launch_g1_by_lanes(const void* x1, const void* y1, const void* z1, const void* x2,
                              const void* y2, const void* z2, void* ox, void* oy, void* oz,
                              long long n, int p_bcast, int q_bcast, const void* consts,
                              void* stream) {
  if (n <= AddLaunch<L>::small_lanes)
    return launch_g1<L, AddLaunch<L>::team_small>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, p_bcast,
                                                  q_bcast, consts, stream);
  return launch_g1<L, AddLaunch<L>::team>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, p_bcast,
                                          q_bcast, consts, stream);
}

extern "C" int cc_ec_add(const void* x1, const void* y1, const void* z1, const void* x2,
                         const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                         int p_bcast, int q_bcast, int limbs, const void* consts, void* stream) {
  if (limbs == 8)
    return launch_g1_by_lanes<8>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, p_bcast, q_bcast, consts,
                                 stream);
  if (limbs == 12)
    return launch_g1_by_lanes<12>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, p_bcast, q_bcast, consts,
                                  stream);
  return bad_limbs();
}
#endif
