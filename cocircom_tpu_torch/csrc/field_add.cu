// field_add: out[j] = a[j] + b[j] mod p, or a[j] - b[j] mod p, over (L, n)
// limb arrays, L = 8 or 12.
//
// No TPU kernel stands behind it: the JAX package adds field elements by an
// XLA composition, and the port's plain version (ops/field.py `_add`,
// `_sub`: int64 limb sums and a carry-vector normalisation) is about thirty
// PyTorch operations a call.  The co-UltraHonk prover makes a few thousand
// field additions a sumcheck round, most of them on small tensors, so on the
// card it was bound by the host's launches, not by the bytes; one launch a
// call removes that.
//
// Bound on an H100: 12*L bytes an element (two operands read, one result
// written) for about 2*L integer adds: bound by bytes moved.  The design is
// K1's: the element in registers, each input word touched once, coalesced
// along the batch axis, and a broadcast operand (a size-1 batch) read once
// per thread from one cached line instead of from an expanded copy.
#include "field.cuh"

using namespace cc;

template <int L>
__global__ void field_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, long long n, int a_bcast,
                                 int b_bcast, int sub, FieldConst<L> F) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long sa = a_bcast ? 1 : n;
  const long long sb = b_bcast ? 1 : n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const Fe<L> x = fe_load<L>(a, sa, a_bcast ? 0 : j);
    const Fe<L> y = fe_load<L>(b, sb, b_bcast ? 0 : j);
    fe_store(out, n, j, sub ? sub_mod(x, y, F) : add_mod(x, y, F));
  }
}

template <int L>
static int launch(const void* a, const void* b, void* out, long long n, int a_bcast, int b_bcast,
                  int sub, const void* consts, void* stream) {
  const int threads = 256;
  field_add_kernel<L><<<grid_for(n, threads, 16), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_bcast, b_bcast, sub,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_field_add(const void* a, const void* b, void* out, long long n, int a_bcast,
                            int b_bcast, int sub, int limbs, const void* consts, void* stream) {
  if (limbs == 8) return launch<8>(a, b, out, n, a_bcast, b_bcast, sub, consts, stream);
  if (limbs == 12) return launch<12>(a, b, out, n, a_bcast, b_bcast, sub, consts, stream);
  return bad_limbs();
}
