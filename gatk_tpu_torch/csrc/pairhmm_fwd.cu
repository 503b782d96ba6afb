// PairHMM forward kernel for NVIDIA Hopper (sm_90a).
//
// Replaces gatk_tpu/ops/pairhmm_tpu.py:_pairhmm_kernel_v6 (called through
// _pairhmm_call_v6 from _pairhmm_pool_scan and _pairhmm_cartesian_v6): per
// (read, haplotype) pair, log10 P(read | hap) by GATK's logless 3-state forward
// recurrence (LoglessPairHMM.java:48-70) in f32, initial deletion row
// 2^100 / hlen, final-row M + I summed in linear f32, result
// (log(acc) - 100 ln2) / ln10, or NEG_INF where acc <= 0. Two instances of one
// template: the default scores an N in the read or the haplotype as a match
// (the host f64 rule, pairhmm_model.py:82); the hap-N-mismatch instance scores
// a haplotype N as a mismatch unless the read base is N, as v6 itself does
// (pairhmm_tpu.py:792-795, :814) and v2, v4, v5 and v7 do. The same kernel
// also stands for those (ops/pairhmm.PAIR_VARIANTS).
//
// Inputs are the device-resident uint8 pools of ops/pairhmm.py (gatk_tpu's
// packed layout): read tables (rp, NR) with read base k in row k+1, lengths
// rlen (NR,), haplotypes reversed in e (He, NH), He = hmax + 2*rp + 16, stored
// haplotype-major, so the kernel reads it as (NH, He), hlen (NH,), the pair list ri, hi
// (n,), and int32 scratch for the plan (ops/_kernels.plan_scratch). Each
// pair's read rows and haplotype are gathered inside the kernel's loads.
//
// What bounds it: FP32 arithmetic outside the tensor cores. A cell costs 11
// FP32 operations (8 FMA-pipe instructions with contraction) and reads only
// registers; the bytes moved per pair (a few hundred) are negligible next to
// rlen * hlen cells. PairHMM has no matrix product, so the tensor cores do not
// apply. What held the one-warp-per-pair design (commit 0487e99) back was not
// that bound but idle lanes and issue slots: a pair took a whole warp of 32
// lanes x 5 rows for hlen + 31 steps, so the HaplotypeCaller launch's short
// reads (median 67 rows) left 61 % of its lane-slots computing nothing, and a
// step issued 134 instructions for 25 cells (a per-row test for the final row
// among them).
// Every launch ran at ~1.1e12 lane-slots/s whatever its shape.
//
// What the design does about it (the sweep and the plan are in
// csrc/pairhmm_sweep.cuh, shared with the cartesian kernel
// csrc/pairhmm_matrix.cu):
//   * Lane groups by read length. A pair whose read fits in 5G rows is swept
//     by a group of G = 4, 8, 16 or 32 lanes, so a warp sweeps 32/G pairs at
//     once; __shfl_up_sync of width G keeps each wavefront in its group. Reads
//     of more than 160 rows use the whole warp and run as 160-row stripes.
//   * A plan puts like pairs in one warp: before the sweep the launcher sorts
//     the pairs on the card by group width, then hlen, then lanes used (a
//     counting sort in three small kernels), and a warp runs its groups for
//     the longest group's hlen + nl - 1 steps. Each result is written at its
//     pair's index, in the caller's order.
//   * One launch of resident blocks (the card filled once) whose warps take
//     warp tasks from a counter, longest first; each task is a compile-time
//     width, so the sweep has one instance per width and N rule (4 x 2).
//   * Rows aligned to the bottom of the group, so the final-row sum is one add
//     per step instead of a per-row test; the steps in which every lane of
//     the warp is inside its haplotype run without a guard, two to a loop
//     iteration. Such a step issues 66 instructions (42 of them FP32), a
//     guarded one 84; one warp per pair issued 134 (cuobjdump -sass of the
//     sm_90a build).
//   * Lanes read haplotype bases straight from device memory, from e's
//     haplotype-major rows: a group's lanes read neighbouring bytes, which hit
//     L1, so no group stages its haplotype before it can start.
// The arithmetic of a cell and each pair's order of summation over the final
// row are those of the one-warp-per-pair kernel, so a pair's result does not
// depend on the pairs it shares a warp with.
// ptxas -v (sm_90a, CUDA 12.8): 96 registers for each N-rule instance at 5
// blocks of 4 warps an SM, no spills; the plan kernels 23, 32 and 22.

#include "pairhmm_sweep.cuh"

namespace {

using namespace pairhmm;

constexpr int kWarpsPerBlock = 4;
// Blocks of 4 warps that __launch_bounds__ asks each SM to hold (it caps the
// registers a thread may use). Timed on an H100 80GB HBM3 at 700 W, as a
// share of the one-warp-per-pair kernel's time at the HaplotypeCaller launch
// and the bench workload: 4 blocks (110-112 registers) 0.516 and 0.803; 5
// (96, no spill) 0.467 and 0.769; 6 (80 and a 16-byte stack) 0.531 and 0.825.
constexpr int kMinBlocks = 5;

struct Args {
  ReadPools reads;
  const int32_t* rlen;
  const uint8_t* et;  // haplotypes (NH, He): the pools' e, haplotype-major
  const int32_t* hlen;
  const int32_t *ri, *hi;
  Plan plan;
  float* out;
  int rp, nh, he, hmax;
  int multi_stripe;      // rp - 1 > kStripe: stripe row buffers are present
  size_t smem_per_warp;  // bytes: [2][3][hmax + 1] floats if multi_stripe, else none
};

// One warp task of class G: the 32/G pairs at plan positions first .. first +
// 32/G - 1 (those below end), one per group.
template <int G, bool kHapNMismatch>
__device__ __forceinline__ void fwd_task(const Args& a, int first, int end, int lane,
                                         unsigned char* wsm) {
  const int g = lane / G;
  const int gl = lane % G;
  const float nan = __int_as_float(0x7fc00000);
  const int H1 = a.hmax + 1;
  float* bnd = reinterpret_cast<float*>(wsm);  // [2][3][H1], multi-stripe tasks only
  // a group that does not sweep reads haplotype 0's row (see sweep_stripe)
  const uint8_t* hap = a.et + kEOff + a.rp - 2 + a.hmax;
  int pair = -1, r = 0, L = 0, H = 0;
  float result = nan;  // written by lane 0 of a group that does not sweep
  if (first + g < end) {
    pair = (int)a.plan.perm[first + g];
    r = a.ri[pair];
    const int h = a.hi[pair];
    if (r >= 0 && r < a.reads.nr && h >= 0 && h < a.nh) {
      L = a.rlen[r];
      H = a.hlen[h];
      if (L < 0 || L > a.rp - 1 || H < 0 || H > a.hmax || (G < kWarp && L > G * kRows)) {
        L = H = 0;
      } else if (L == 0 || H == 0) {  // no read rows or no free-deletion mass: acc == 0
        result = kNegInf;
        L = H = 0;
      }
    }
    // haplotype base k sits at column kEOff + rp - 1 + hmax - 1 - k of et
    if (H > 0) hap = a.et + (size_t)h * a.he + kEOff + a.rp - 2 + a.hmax;
  }
  const bool sweep = H > 0;
  // lanes with rows, stripes, and boundary rows on top of the first stripe
  const int n_stripes = G == kWarp ? (L + kStripe - 1) / kStripe : 1;
  const int nl = n_stripes > 1 ? kWarp : (L + kRows - 1) / kRows;
  const int pad = (n_stripes > 1 ? n_stripes * kStripe : nl * kRows) - L;
  const int steps = __reduce_max_sync(kFull, sweep ? H + nl - 1 : 0);
  const int h_min = __reduce_min_sync(kFull, sweep ? H : INT_MAX);
  const float y0 = sweep ? kInit / (float)H : 0.f;
  float acc = 0.f;
  for (int s = 0; s < n_stripes; ++s) {  // one group when n_stripes > 1: warp-uniform
    Tables T;
    build_tables(T, a.reads, r, s * kStripe + gl * kRows + 1 - pad, L);
    acc = 0.f;
    sweep_stripe<G, kHapNMismatch>(acc, T, hap, H, H1, y0, steps, h_min, gl, s == 0, pad,
                                   bnd + (s & 1) * 3 * H1,        // the previous stripe's bottom
                                   bnd + ((s + 1) & 1) * 3 * H1,  // this stripe's, for the next
                                   s + 1 < n_stripes && gl == kWarp - 1);
    __syncwarp();  // the next stripe reads this stripe's bottom row
  }
  if (sweep) {
    if (gl == nl - 1) a.out[pair] = finish(acc);
  } else if (gl == 0 && pair >= 0) {
    a.out[pair] = result;
  }
}

template <bool kHapNMismatch>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
pairhmm_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  unsigned char* wsm = smem + warp * a.smem_per_warp;
  int base[kClasses + 1];
  const int tasks = warp_tasks(a.plan, base);
  for (long long q; (q = next_task(a.plan, tasks, lane)) >= 0;) {  // warp-uniform
    int first;
    const int c = task_class(a.plan, base, (int)q, first);
    const int end = a.plan.seg[c + 1];
    switch (c) {
      case 0: fwd_task<4, kHapNMismatch>(a, first, end, lane, wsm); break;
      case 1: fwd_task<8, kHapNMismatch>(a, first, end, lane, wsm); break;
      case 2: fwd_task<16, kHapNMismatch>(a, first, end, lane, wsm); break;
      default: fwd_task<32, kHapNMismatch>(a, first, end, lane, wsm); break;
    }
    __syncwarp();  // the next task overwrites the stripe rows
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// hap_n_mismatch selects the template instance (0: N matches, 1: haplotype N mismatches).
extern "C" int pairhmm_fwd(const void* rbase, const void* rq, const void* iq, const void* dq,
                           const void* gcp, const void* rlen, const void* et, const void* hlen,
                           const void* ri, const void* hi, void* scratch, void* out, int n,
                           int rp, int nr, int he, int nh, int hap_n_mismatch, void* stream) {
  Args a;
  a.reads.rbase = static_cast<const uint8_t*>(rbase);
  a.reads.rq = static_cast<const uint8_t*>(rq);
  a.reads.iq = static_cast<const uint8_t*>(iq);
  a.reads.dq = static_cast<const uint8_t*>(dq);
  a.reads.gcp = static_cast<const uint8_t*>(gcp);
  a.reads.nr = nr;
  a.rlen = static_cast<const int32_t*>(rlen);
  a.et = static_cast<const uint8_t*>(et);
  a.hlen = static_cast<const int32_t*>(hlen);
  a.ri = static_cast<const int32_t*>(ri);
  a.hi = static_cast<const int32_t*>(hi);
  a.out = static_cast<float*>(out);
  a.rp = rp;
  a.nh = nh;
  a.he = he;
  a.hmax = he - 2 * rp - kEOff;
  if (n <= 0) return 0;
  if (rp < 2 || a.hmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.multi_stripe = rp - 1 > kStripe;
  a.smem_per_warp = a.multi_stripe ? 6 * (size_t)(a.hmax + 1) * sizeof(float) : 0;
  if (a.smem_per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * a.smem_per_warp > kMaxSmem) --wpb;
  const size_t smem = wpb * a.smem_per_warp;
  void (*kernel)(Args) =
      hap_n_mismatch ? &pairhmm_fwd_kernel<true> : &pairhmm_fwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_plan(a.ri, a.hi, a.rlen, a.hlen, n, nr, nh,
                                std::min(a.hmax, kMaxKeyLen), scratch, st, a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;  // at most one warp a pair
  err = resident_blocks(kernel, wpb * kWarp, smem, (n + wpb - 1) / wpb, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, wpb * kWarp, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The plan alone, for its test against ops/_kernels.plan_groups: of the pairs
// (ri, hi) when ri is given, else of the nr reads; writes it into scratch.
extern "C" int pairhmm_plan(const void* ri, const void* hi, const void* rlen, const void* hlen,
                            void* scratch, int n, int nr, int nh, int kmax, void* stream) {
  if (n <= 0) return 0;
  Plan plan;
  return static_cast<int>(launch_plan(
      static_cast<const int32_t*>(ri), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(rlen), static_cast<const int32_t*>(hlen), n, nr, nh, kmax,
      scratch, static_cast<cudaStream_t>(stream), plan));
}
