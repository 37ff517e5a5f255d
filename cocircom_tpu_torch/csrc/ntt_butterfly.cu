// K2  ntt_butterfly: one radix-2 stage, out_e = e + o*w, out_o = e - o*w
// (mod p) over (8, n) limb arrays, out of place.
//
// Replaces the TPU kernel `butterfly_pallas` (cocircom_tpu/ops/pallas_field.py),
// the per-stage engine of transforms below 2^12 points.
//
// Bound on an H100: 136 multiply-adds plus two modular add/sub chains for
// 160 bytes of traffic (three inputs, two outputs): bound by bytes moved.
// Fusing the multiply with the add and the subtract keeps the product in
// registers, so a stage moves 5 element-sized arrays instead of the 9 that
// separate multiply, add and subtract passes would.
#include "field.cuh"

using namespace cc;

__global__ void ntt_butterfly_kernel(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                                     const uint32_t* __restrict__ w, uint32_t* __restrict__ oe,
                                     uint32_t* __restrict__ oo, long long n, FieldConst F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const Fe ev = fe_load(e, n, j);
    const Fe t = mont_mul(fe_load(o, n, j), fe_load(w, n, j), F);
    fe_store(oe, n, j, add_mod(ev, t, F));
    fe_store(oo, n, j, sub_mod(ev, t, F));
  }
}

extern "C" int cc_ntt_butterfly(const void* e, const void* o, const void* w, void* oe, void* oo,
                                long long n, const void* consts, void* stream) {
  const FieldConst F = make_consts((const uint32_t*)consts);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  ntt_butterfly_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)e, (const uint32_t*)o, (const uint32_t*)w, (uint32_t*)oe, (uint32_t*)oo, n,
      F);
  return launch_status();
}
