// The G2 add: complete projective addition on the G2 curve over
// Fq2 = Fq[u]/(u^2 + 1), a pair of threads a lane (curve.cuh `ec_add_pair`;
// the design and the lazy-reduction bound 2p^2 < pR are set out at the head
// of csrc/ec_add.cu).  Coordinates are 6 x (L, n) arrays a point (real and
// imaginary part of x, y, z); either operand may be one point broadcast to
// all lanes.  Built for L = 8 (BN254) and L = 12 (BLS12-381).  The JAX
// package has no TPU kernel here: it composes stacked field-multiply calls
// with XLA add/sub ops (cocircom_tpu/ops/curve.py, `CurveOps.add`).
#include "curve.cuh"

using namespace cc;

// One line each: the sweep tool rewrites these lines in copies of the file.
// min_blocks = 1 leaves the register count to the compiler.  The 8-limb
// kernel stays uncapped: a cap at 168 registers ran 7-8% faster but spilled,
// and it is held to no stack frame.
template <int L> struct G2Launch;
template <> struct G2Launch<8> { static constexpr int threads = 64, min_blocks = 1; };
template <> struct G2Launch<12> { static constexpr int threads = 64, min_blocks = 1; };

// Pointer tables: in[0..5] = P's (x0, x1, y0, y1, z0, z1), in[6..11] = Q's,
// out[0..5] likewise.
struct G2Ptrs {
  const uint32_t* in[12];
  uint32_t* out[6];
};

template <int L>
__global__ void __launch_bounds__(G2Launch<L>::threads, G2Launch<L>::min_blocks)
ec_add_g2_kernel(G2Ptrs ptrs, long long n, int p_bcast, int q_bcast, FieldConst<L> F) {
  const bool c1 = threadIdx.x & 1;
  const Fq2PairOps<L> k(F, c1);
  const int pair = (threadIdx.x & 31) >> 1;
  const long long warps = blockDim.x >> 5;
  const long long sp = p_bcast ? 1 : n;
  const long long sq = q_bcast ? 1 : n;
  // this thread's component of each coordinate (a select, not an index
  // into the parameter table, which would go through local memory)
  const uint32_t* in[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) in[i] = c1 ? ptrs.in[2 * i + 1] : ptrs.in[2 * i];
  uint32_t* out[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = c1 ? ptrs.out[2 * i + 1] : ptrs.out[2 * i];
  for (long long w0 = (long long)blockIdx.x * warps; w0 * 16 < n;
       w0 += (long long)gridDim.x * warps) {
    const long long first = (w0 + (threadIdx.x >> 5)) * 16;
    if (first >= n) continue;
    const long long j = first + pair;
    const bool live = j < n;
    const long long jc = live ? j : n - 1;
    const long long jp = p_bcast ? 0 : jc;
    const long long jq = q_bcast ? 0 : jc;
    Fe<L> X3, Y3, Z3;
    ec_add_pair(k, fe_load<L>(in[0], sp, jp), fe_load<L>(in[1], sp, jp),
                fe_load<L>(in[2], sp, jp), fe_load<L>(in[3], sq, jq), fe_load<L>(in[4], sq, jq),
                fe_load<L>(in[5], sq, jq), X3, Y3, Z3);
    if (live) {
      fe_store(out[0], n, j, X3);
      fe_store(out[1], n, j, Y3);
      fe_store(out[2], n, j, Z3);
    }
  }
}

#ifndef CC_HOST_MODEL
template <int L>
static int launch_g2(const G2Ptrs& ptrs, long long n, int p_bcast, int q_bcast,
                     const void* consts, void* stream) {
  const Shape s = shape_for(n, G2Launch<L>::threads, 16);
  ec_add_g2_kernel<L><<<s.blocks, s.threads, 0, (cudaStream_t)stream>>>(
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
#endif
