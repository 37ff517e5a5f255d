// K2  ntt_butterfly: one radix-2 stage, out_e = e + o*w, out_o = e - o*w
// (mod p) over (L, n) limb arrays (L = 8 or 12), out of place.
//
// Replaces the TPU kernel `butterfly_pallas` (cocircom_tpu/ops/pallas_field.py),
// the per-stage engine of transforms below 2^12 points.
//
// Bound on an H100: one product (136 multiply-adds at L = 8) plus two
// modular add/sub chains for 20*L bytes of traffic (three inputs, two
// outputs): bound by bytes moved.  Both curves' Fr has 8 limbs, so the
// prover's transforms run the L = 8 build; the L = 12 build exists like
// every other kernel's and is held against the plain version.
// Fusing the multiply with the add and the subtract keeps the product in
// registers, so a stage moves 5 element-sized arrays instead of the 9 that
// separate multiply, add and subtract passes would.
#include "field.cuh"

using namespace cc;

template <int L>
__global__ void ntt_butterfly_kernel(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                                     const uint32_t* __restrict__ w, uint32_t* __restrict__ oe,
                                     uint32_t* __restrict__ oo, long long n, FieldConst<L> F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const Fe<L> ev = fe_load<L>(e, n, j);
    const Fe<L> t = mont_mul(fe_load<L>(o, n, j), fe_load<L>(w, n, j), F);
    fe_store(oe, n, j, add_mod(ev, t, F));
    fe_store(oo, n, j, sub_mod(ev, t, F));
  }
}

template <int L>
static int launch(const void* e, const void* o, const void* w, void* oe, void* oo, long long n,
                  const void* consts, void* stream) {
  const int threads = 256;
  ntt_butterfly_kernel<L><<<grid_for(n, threads, 16), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)e, (const uint32_t*)o, (const uint32_t*)w, (uint32_t*)oe, (uint32_t*)oo, n,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ntt_butterfly(const void* e, const void* o, const void* w, void* oe, void* oo,
                                long long n, int limbs, const void* consts, void* stream) {
  if (limbs == 8) return launch<8>(e, o, w, oe, oo, n, consts, stream);
  if (limbs == 12) return launch<12>(e, o, w, oe, oo, n, consts, stream);
  return bad_limbs();
}
