// K1  mont_mul: out[j] = a[j] * b[j] * R^-1 mod p over (L, n) limb arrays,
// L = 8 or 12.
//
// Replaces the TPU kernel `mont_mul_pallas` (cocircom_tpu/ops/pallas_field.py)
// and serves every field multiply of the prover, for Fr and for Fq.
//
// Bound on an H100: a product is 2*L*L + L 32-bit multiply-adds (136 at
// L = 8, 300 at L = 12) for 12*L bytes of traffic (two operands read, one
// result written), i.e. 1.4 to 2.1 multiply-adds per byte, below the card's
// ratio of integer rate to memory rate (5): the kernel is bound by bytes
// moved.  The design therefore
// keeps the element in registers, touches each input word once, reads and
// writes coalesced along the batch axis (limb-axis-first layout), and reads
// a broadcast operand (a size-1 batch) once per thread from one cached line
// instead of from an expanded copy.
#include "field.cuh"

using namespace cc;

template <int L>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, int a_bcast, int b_bcast,
                                FieldConst<L> F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sa = a_bcast ? 1 : n;
  const long long sb = b_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const Fe<L> x = fe_load<L>(a, sa, a_bcast ? 0 : j);
    const Fe<L> y = fe_load<L>(b, sb, b_bcast ? 0 : j);
    fe_store(out, n, j, mont_mul(x, y, F));
  }
}

template <int L>
static int launch(const void* a, const void* b, void* out, long long n, int a_bcast, int b_bcast,
                  const void* consts, void* stream) {
  const int threads = 256;
  mont_mul_kernel<L><<<grid_for(n, threads, 16), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_bcast, b_bcast,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_mont_mul(const void* a, const void* b, void* out, long long n, int a_bcast,
                           int b_bcast, int limbs, const void* consts, void* stream) {
  if (limbs == 8) return launch<8>(a, b, out, n, a_bcast, b_bcast, consts, stream);
  if (limbs == 12) return launch<12>(a, b, out, n, a_bcast, b_bcast, consts, stream);
  return bad_limbs();
}
