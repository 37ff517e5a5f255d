// Host model of the carry-chain arithmetic and of the cooperative curve
// kernels of cocircom_tpu_torch/csrc: the device sources compiled with g++,
// each PTX carry instruction emulated (field.cuh, CC_HOST_MODEL), each warp
// run as 32 fibers on one host thread that meet at every shuffle and vote.
// Driven by tests/test_torch_carry_model.py, which builds it with g++
// (-I cocircom_tpu_torch/csrc).
//
// stdin: the limb count L, then the 3L + 1 words of the kernels' constant
// block (p, -p^-1 mod 2^32, 3b, 3b's imaginary part), then one operation a
// line: a name and its operands as L-word hexadecimal integers, least
// significant word first.  stdout: one result a line, the same format.
//   mul a b          mont_mul_cc(a, b)
//   sum2 a b c d     mont_sum2_cc(a, b, c, d)
//   add a b          add_mod_cc(a, b)
//   sub a b          sub_mod_cc(a, b)
//   pminus b         p_minus(b)
// and the kernels of ec_add.cu, ec_add_g2.cu and ec_wave_add_g2.cu, run on a grid of `blocks` blocks of
// `threads` threads; arrays are (L, lanes) limb-major words, a broadcast
// operand has one lane, masks one word a lane:
//   g1add S n pb qb blocks threads  x1 y1 z1 x2 y2 z2  -> X3 Y3 Z3
//   g2add n pb qb blocks threads    12 arrays          -> 6 arrays
//   g2wave n blocks threads         6 acc, rows (n x 6L), neg, valid -> 6 acc
#define CC_HOST_MODEL
#define __device__
#define __forceinline__ inline
#include <cstdint>
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
#define __global__
#define __launch_bounds__(...)

#include <ucontext.h>

#include <functional>
#include <vector>

// ---- one warp at a time: 32 fibers, switched at every warp collective
struct Dim {
  unsigned x = 0, y = 1, z = 1;
};
Dim threadIdx, blockIdx, blockDim, gridDim;
static int cur_lane = 0;

static uint32_t exchange(uint32_t v, int src);
static bool vote_any(bool p);
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) { return exchange(v, src); }
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int mask) {
  return exchange(v, cur_lane ^ mask);
}
inline bool __any_sync(unsigned, bool p) { return vote_any(p); }

#include <cstdio>
#include <cstring>
#include <iostream>
#include <string>
#include <vector>

#include "field.cuh"
#include "ec_add.cu"
#include "ec_add_g2.cu"
#include "ec_wave_add_g2.cu"

thread_local uint32_t cc::ptx::model_cf = 0;

// Every lane of a warp reaches every collective (the kernels keep their
// control flow warp-uniform), so the fibers run in lockstep rounds: each
// runs to its next collective and yields; in one round all lanes write
// their value, in the next all read.  A lane's carry flag is its own.
static ucontext_t sched_ctx, lane_ctx[32];
static uint32_t slot[32], lane_cf[32];
static bool lane_done[32];
static std::function<void()> lane_fn;

static void yield_lane() {
  lane_cf[cur_lane] = cc::ptx::model_cf;
  swapcontext(&lane_ctx[cur_lane], &sched_ctx);
  cc::ptx::model_cf = lane_cf[cur_lane];
}

static uint32_t exchange(uint32_t v, int src) {
  slot[cur_lane] = v;
  yield_lane();
  const uint32_t r = slot[src & 31];
  yield_lane();
  return r;
}

static bool vote_any(bool p) {
  slot[cur_lane] = p ? 1u : 0u;
  yield_lane();
  bool any = false;
  for (int i = 0; i < 32; ++i) any = any || slot[i] != 0u;
  yield_lane();
  return any;
}

static void lane_main() {
  lane_fn();
  lane_done[cur_lane] = true;   // returns to sched_ctx through uc_link
}

using namespace cc;

static std::vector<uint32_t> read_words(int n) {
  std::vector<uint32_t> w(n);
  for (int i = 0; i < n; ++i) {
    std::string s;
    std::cin >> s;
    w[i] = (uint32_t)std::stoul(s, nullptr, 16);
  }
  return w;
}

template <int L>
static Fe<L> read_fe() {
  Fe<L> r;
  std::vector<uint32_t> w = read_words(L);
  for (int i = 0; i < L; ++i) r.v[i] = w[i];
  return r;
}

template <int L>
static void print_fe(const Fe<L>& a) {
  for (int i = 0; i < L; ++i) std::printf("%08x%c", a.v[i], i + 1 < L ? ' ' : '\n');
}

// Runs fn() as every thread of a grid, one warp at a time.
template <class Fn>
static void run_grid(unsigned blocks, unsigned threads, Fn fn) {
  constexpr size_t kStack = 256 * 1024;
  static std::vector<char> stacks(32 * kStack);
  gridDim.x = blocks;
  blockDim.x = threads;
  lane_fn = fn;
  for (unsigned b = 0; b < blocks; ++b)
    for (unsigned w = 0; w < threads / 32; ++w) {
      for (int l = 0; l < 32; ++l) {
        getcontext(&lane_ctx[l]);
        lane_ctx[l].uc_stack.ss_sp = &stacks[l * kStack];
        lane_ctx[l].uc_stack.ss_size = kStack;
        lane_ctx[l].uc_link = &sched_ctx;
        makecontext(&lane_ctx[l], lane_main, 0);
        lane_done[l] = false;
        lane_cf[l] = 0;
      }
      for (bool live = true; live;) {
        live = false;
        for (int l = 0; l < 32; ++l) {
          if (lane_done[l]) continue;
          live = true;
          cur_lane = l;
          blockIdx.x = b;
          threadIdx.x = w * 32 + l;
          cc::ptx::model_cf = lane_cf[l];
          swapcontext(&sched_ctx, &lane_ctx[l]);
        }
      }
    }
}

static void print_words(const std::vector<uint32_t>& w) {
  for (size_t i = 0; i < w.size(); ++i) std::printf("%08x%c", w[i], i + 1 < w.size() ? ' ' : '\n');
}

template <int L>
static int run() {
  const std::vector<uint32_t> words = read_words(3 * L + 1);
  const FieldConst<L> F = make_consts<L>(words.data());
  std::string op;
  while (std::cin >> op) {
    if (op == "g1add") {
      int S, pb, qb;
      long long n;
      unsigned blocks, threads;
      std::cin >> S >> n >> pb >> qb >> blocks >> threads;
      std::vector<std::vector<uint32_t>> in;
      for (int i = 0; i < 6; ++i) in.push_back(read_words(L * ((i < 3 ? pb : qb) ? 1 : n)));
      std::vector<std::vector<uint32_t>> out(3, std::vector<uint32_t>(L * n));
      auto call = [&] {
        const uint32_t* a[6];
        for (int i = 0; i < 6; ++i) a[i] = in[i].data();
        if (S == 1)
          ec_add_kernel<L, 1>(a[0], a[1], a[2], a[3], a[4], a[5], out[0].data(), out[1].data(),
                              out[2].data(), n, pb, qb, F);
        else
          ec_add_kernel<L, 3>(a[0], a[1], a[2], a[3], a[4], a[5], out[0].data(), out[1].data(),
                              out[2].data(), n, pb, qb, F);
      };
      run_grid(blocks, threads, call);
      for (auto& o : out) print_words(o);
    } else if (op == "g2add") {
      int pb, qb;
      long long n;
      unsigned blocks, threads;
      std::cin >> n >> pb >> qb >> blocks >> threads;
      std::vector<std::vector<uint32_t>> in;
      for (int i = 0; i < 12; ++i) in.push_back(read_words(L * ((i < 6 ? pb : qb) ? 1 : n)));
      std::vector<std::vector<uint32_t>> out(6, std::vector<uint32_t>(L * n));
      G2Ptrs ptrs;
      for (int i = 0; i < 12; ++i) ptrs.in[i] = in[i].data();
      for (int i = 0; i < 6; ++i) ptrs.out[i] = out[i].data();
      run_grid(blocks, threads, [&] { ec_add_g2_kernel<L>(ptrs, n, pb, qb, F); });
      for (auto& o : out) print_words(o);
    } else if (op == "g2wave") {
      long long n;
      unsigned blocks, threads;
      std::cin >> n >> blocks >> threads;
      std::vector<std::vector<uint32_t>> acc;
      for (int i = 0; i < 6; ++i) acc.push_back(read_words(L * n));
      std::vector<uint32_t> rows = read_words(6 * L * n);
      std::vector<uint32_t> nw = read_words(n), vw = read_words(n);
      std::vector<uint8_t> neg(nw.begin(), nw.end()), valid(vw.begin(), vw.end());
      G2Acc a;
      for (int i = 0; i < 6; ++i) a.a[i] = acc[i].data();
      run_grid(blocks, threads, [&] {
        ec_wave_add_g2_kernel<L>(a, rows.data(), neg.data(), valid.data(), n, F);
      });
      for (auto& o : acc) print_words(o);
    } else if (op == "mul") {
      Fe<L> a = read_fe<L>(), b = read_fe<L>();
      print_fe(mont_mul_cc(a, b, F));
    } else if (op == "sum2") {
      Fe<L> a = read_fe<L>(), b = read_fe<L>(), c = read_fe<L>(), d = read_fe<L>();
      print_fe(mont_sum2_cc(a, b, c, d, F));
    } else if (op == "add") {
      Fe<L> a = read_fe<L>(), b = read_fe<L>();
      print_fe(add_mod_cc(a, b, F));
    } else if (op == "sub") {
      Fe<L> a = read_fe<L>(), b = read_fe<L>();
      print_fe(sub_mod_cc(a, b, F));
    } else if (op == "pminus") {
      Fe<L> b = read_fe<L>();
      print_fe(p_minus(b, F));
    } else {
      std::fprintf(stderr, "unknown operation %s\n", op.c_str());
      return 1;
    }
  }
  return 0;
}

int main() {
  std::ios::sync_with_stdio(false);
  int limbs = 0;
  std::cin >> limbs;
  if (limbs == 8) return run<8>();
  if (limbs == 12) return run<12>();
  std::fprintf(stderr, "no instantiation for %d limbs\n", limbs);
  return 1;
}
