// K1  mont_mul: out[j] = a[j] * b[j] * R^-1 mod p over (8, n) limb arrays.
//
// Replaces the TPU kernel `mont_mul_pallas` (cocircom_tpu/ops/pallas_field.py)
// and serves every field multiply of the prover, for Fr and for Fq.
//
// Bound on an H100: a BN254 product is 2*8*8 + 8 = 136 32-bit multiply-adds
// for 96 bytes of traffic (two operands read, one result written), i.e.
// about 1.4 multiply-adds per byte, below the card's ratio of integer rate
// to memory rate: the kernel is bound by bytes moved.  The design therefore
// keeps the element in registers, touches each input word once, reads and
// writes coalesced along the batch axis (limb-axis-first layout), and reads
// a broadcast operand (a size-1 batch) once per thread from one cached line
// instead of from an expanded copy.
#include "field.cuh"

using namespace cc;

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long n, int a_bcast, int b_bcast,
                                FieldConst F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sa = a_bcast ? 1 : n;
  const long long sb = b_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const Fe x = fe_load(a, sa, a_bcast ? 0 : j);
    const Fe y = fe_load(b, sb, b_bcast ? 0 : j);
    fe_store(out, n, j, mont_mul(x, y, F));
  }
}

extern "C" int cc_mont_mul(const void* a, const void* b, void* out, long long n, int a_bcast,
                           int b_bcast, const void* consts, void* stream) {
  const FieldConst F = make_consts((const uint32_t*)consts);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_bcast, b_bcast, F);
  return launch_status();
}
