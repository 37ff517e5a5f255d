// K3  ntt_columns: a 2^m-point NTT (1 <= m <= 10) along axis 1 of an
// (L, M, B) limb array (L = 8 or 12), every column b independently, natural
// order in and out.  tw is (L, M/2): the powers w^0 .. w^(M/2-1) of the M-th root.
//
// Replaces the TPU kernel behind `fourstep_ntt` (cocircom_tpu/ops/pallas_ntt.py,
// `_col_ntt` / `_make_ntt_kernel`).  That kernel keeps a column tile in the
// TPU's on-chip memory through all m stages; here a block keeps a tile of
// `cb` neighbouring columns in shared memory (L * M * cb * 4 bytes, up to
// 128 KB, hence the dynamic shared-memory attribute), loads it once with the
// bit-reversal folded into the load, runs m radix-2 decimation-in-time
// stages with __syncthreads() between them, and stores it once.  The
// four-step recursion, the transposes and the w^(k1 v) multiplies stay in
// ops/ntt.py.  The Pease geometry and the bit-reversed output of the TPU
// kernel exist for that chip's sublane rules and are not kept; the result
// is the same canonical residues.
//
// Bound on an H100 (L = 8): m * M/2 * 136 multiply-adds for 2 * 32 * M bytes per
// column (the small twiddle table stays in L2): at m = 10 about 10 integer
// multiply-adds per byte, so the kernel is bound by operations.  Threads
// along x walk neighbouring columns (neighbouring global addresses), and
// each thread owns whole field elements so a butterfly needs no exchange
// beyond the barrier.  Both curves' Fr has 8 limbs, so the prover's
// transforms run the L = 8 build; the L = 12 build is held against the plain
// version like every other kernel's.
#include "field.cuh"

using namespace cc;

extern __shared__ uint32_t smem[];

template <int L>
__global__ void ntt_columns_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                                   uint32_t* __restrict__ out, int logm, long long B, int cb,
                                   FieldConst<L> F) {
  const int M = 1 << logm;
  const int H = M >> 1;
  const int c = threadIdx.x % cb;
  const int ty = threadIdx.x / cb;
  const int TY = blockDim.x / cb;
  const long long col = (long long)blockIdx.x * cb + c;
  const bool live = col < B;
  const long long LS = (long long)M * B;  // limb stride in global memory

  for (int m = ty; m < M; m += TY) {
    const int r = (int)(__brev((unsigned)m) >> (32 - logm));
#pragma unroll
    for (int l = 0; l < L; ++l)
      smem[(l * M + r) * cb + c] = live ? x[l * LS + (long long)m * B + col] : 0u;
  }
  __syncthreads();

  for (int s = 1; s <= logm; ++s) {
    const int half = 1 << (s - 1);
    const int stride = M >> s;
    for (int j = ty; j < H; j += TY) {
      const int k = j & (half - 1);
      const int i0 = ((j >> (s - 1)) << s) + k;
      const int i1 = i0 + half;
      Fe<L> e, o, w;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        e.v[l] = smem[(l * M + i0) * cb + c];
        o.v[l] = smem[(l * M + i1) * cb + c];
        w.v[l] = tw[l * H + k * stride];
      }
      const Fe<L> t = mont_mul(o, w, F);
      const Fe<L> u = add_mod(e, t, F);
      const Fe<L> v = sub_mod(e, t, F);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        smem[(l * M + i0) * cb + c] = u.v[l];
        smem[(l * M + i1) * cb + c] = v.v[l];
      }
    }
    __syncthreads();
  }

  if (live) {
    for (int m = ty; m < M; m += TY) {
#pragma unroll
      for (int l = 0; l < L; ++l)
        out[l * LS + (long long)m * B + col] = smem[(l * M + m) * cb + c];
    }
  }
}

template <int L>
static int launch(const void* x, const void* tw, void* out, int logm, long long B, int cb,
                  const void* consts, void* stream) {
  const int M = 1 << logm;
  const size_t bytes = (size_t)L * M * cb * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(ntt_columns_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int threads = 256;
  while (threads / cb > M / 2 && threads > cb) threads >>= 1;
  if (threads < 32) threads = 32;
  const long long blocks = (B + cb - 1) / cb;
  ntt_columns_kernel<L><<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)out, logm, B, cb,
      make_consts<L>(consts));
  return launch_status();
}

extern "C" int cc_ntt_columns(const void* x, const void* tw, void* out, int logm, long long B,
                              int cb, int limbs, const void* consts, void* stream) {
  if (limbs == 8) return launch<8>(x, tw, out, logm, B, cb, consts, stream);
  if (limbs == 12) return launch<12>(x, tw, out, logm, B, cb, consts, stream);
  return bad_limbs();
}
