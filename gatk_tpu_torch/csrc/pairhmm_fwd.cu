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
// rlen (NR,), haplotypes reversed in e (He, NH), He = hmax + 2*rp + 16, hlen
// (NH,), and the pair list ri, hi (n,). Each pair's read rows and haplotype are
// gathered inside the kernel's loads, so no pair-expanded copy is ever written
// to device memory.
//
// What bounds it: FP32 arithmetic outside the tensor cores. A cell costs 11
// FP32 operations (8 FMA-pipe instructions with contraction) and reads only
// registers; the bytes moved per pair (a few hundred) are negligible next to
// rlen * hlen cells. PairHMM has no matrix product, so the tensor cores do not
// apply.
//
// What the design does about it (the sweep itself is csrc/pairhmm_sweep.cuh,
// shared with the cartesian kernel csrc/pairhmm_matrix.cu):
//   * One warp per pair. Lane l owns kRows = 5 consecutive read rows, so a
//     warp covers a 160-row stripe, all of a 151 bp read. The lane keeps its
//     rows' 8 transition/prior values and its M, X, Y state in registers.
//   * Lanes sweep haplotype columns skewed by one step per lane: at step t lane
//     l computes column j = t - l for its rows, top to bottom. Every dependency
//     is then in registers: the row above at columns j and j-1 comes from lane
//     l-1 by __shfl_up_sync (3 shuffles per 5 cells), the left neighbour is the
//     lane's own previous column. No state touches shared or device memory.
//   * The sweep is bounded per pair: rlen rows (the sum is read at row rlen,
//     which is exactly where gatk_tpu's padded rows would carry it) and hlen
//     columns, plus a 31-step fill/drain, instead of v6's rp x (block max hlen).
//   * The haplotype (hlen bytes) is staged in shared memory once per pair.
//   * Reads longer than 160 rows run as several stripes; the bottom row of a
//     stripe is handed to the next through two shared-memory row buffers.
// Left for later: sorting pairs by length so warps of a block finish
// together, several pairs per warp for short reads, packed half2 arithmetic.

#include "pairhmm_sweep.cuh"

namespace {

using namespace pairhmm;

constexpr int kWarpsPerBlock = 4;

struct Args {
  ReadPools reads;
  const int32_t* rlen;
  const uint8_t* e;
  const int32_t* hlen;
  const int32_t *ri, *hi;
  float* out;
  int n, rp, nh, hmax;
  int multi_stripe;      // rp - 1 > kStripe: stripe row buffers are present
  size_t smem_per_warp;  // bytes: [2][3][hmax + 1] floats if multi_stripe, then hmax bytes
};

template <bool kHapNMismatch>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pairhmm_fwd_kernel(Args a, int warps_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long pair = (long long)blockIdx.x * warps_per_block + warp;
  if (pair >= a.n) return;  // warp-uniform

  const int r = a.ri[pair];
  const int h = a.hi[pair];
  if (r < 0 || r >= a.reads.nr || h < 0 || h >= a.nh) {
    if (lane == 0) a.out[pair] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const int L = a.rlen[r];
  const int H = a.hlen[h];
  if (L < 0 || L > a.rp - 1 || H < 0 || H > a.hmax) {
    if (lane == 0) a.out[pair] = __int_as_float(0x7fc00000);
    return;
  }
  if (L == 0 || H == 0) {  // no read rows or no free-deletion mass: acc == 0
    if (lane == 0) a.out[pair] = kNegInf;
    return;
  }

  unsigned char* wsm = smem + warp * a.smem_per_warp;
  const int H1 = a.hmax + 1;
  float* bnd = reinterpret_cast<float*>(wsm);  // [2][3][H1], multi-stripe only
  unsigned char* hs = wsm + (a.multi_stripe ? 6 * (size_t)H1 * sizeof(float) : 0);

  // haplotype base k sits at row kEOff + rp - 1 + hmax - 1 - k of e
  const size_t hrow0 = (size_t)(kEOff + a.rp - 2 + a.hmax);
  for (int k = lane; k < H; k += kWarp) hs[k] = a.e[(hrow0 - k) * a.nh + h];
  __syncwarp();

  const float y0 = kInit / (float)H;
  const int n_stripes = (L + kStripe - 1) / kStripe;
  const int lastL = (L - 1) % kStripe;  // row L within its stripe (0-based)
  float acc = 0.f;

  for (int s = 0; s < n_stripes; ++s) {
    const int s0 = s * kStripe;  // rows s0+1 .. s0+kStripe
    const int nl = (min(kStripe, L - s0) + kRows - 1) / kRows;  // lanes with rows
    const int kL = (s == n_stripes - 1 && lane == lastL / kRows) ? lastL % kRows : -1;
    Tables T;
    build_tables(T, a.reads, r, s0 + lane * kRows + 1, L);
    sweep_stripe<kHapNMismatch>(
        acc, T, hs, H, H1, y0, s, nl, kL, lane,
        bnd + (s & 1) * 3 * H1,          // row s0 from the previous stripe
        bnd + ((s + 1) & 1) * 3 * H1,    // row s0 + kStripe for the next
        s + 1 < n_stripes && lane == kWarp - 1);
    __syncwarp();  // the next stripe reads this stripe's bottom row
  }

  if (lane == lastL / kRows) a.out[pair] = finish(acc);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// hap_n_mismatch selects the template instance (0: N matches, 1: haplotype N mismatches).
extern "C" int pairhmm_fwd(const void* rbase, const void* rq, const void* iq, const void* dq,
                           const void* gcp, const void* rlen, const void* e, const void* hlen,
                           const void* ri, const void* hi, void* out, int n, int rp, int nr,
                           int he, int nh, int hap_n_mismatch, void* stream) {
  Args a;
  a.reads.rbase = static_cast<const uint8_t*>(rbase);
  a.reads.rq = static_cast<const uint8_t*>(rq);
  a.reads.iq = static_cast<const uint8_t*>(iq);
  a.reads.dq = static_cast<const uint8_t*>(dq);
  a.reads.gcp = static_cast<const uint8_t*>(gcp);
  a.reads.nr = nr;
  a.rlen = static_cast<const int32_t*>(rlen);
  a.e = static_cast<const uint8_t*>(e);
  a.hlen = static_cast<const int32_t*>(hlen);
  a.ri = static_cast<const int32_t*>(ri);
  a.hi = static_cast<const int32_t*>(hi);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.rp = rp;
  a.nh = nh;
  a.hmax = he - 2 * rp - kEOff;
  if (n <= 0) return 0;
  if (rp < 2 || a.hmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.multi_stripe = rp - 1 > kStripe;
  const size_t floats = a.multi_stripe ? 6 * (size_t)(a.hmax + 1) * sizeof(float) : 0;
  a.smem_per_warp = (floats + (size_t)a.hmax + 15) / 16 * 16;
  if (a.smem_per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * a.smem_per_warp > kMaxSmem) --wpb;
  const size_t smem = wpb * a.smem_per_warp;
  void (*kernel)(Args, int) =
      hap_n_mismatch ? &pairhmm_fwd_kernel<true> : &pairhmm_fwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((n + wpb - 1) / wpb);
  kernel<<<grid, wpb * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(a, wpb);
  return static_cast<int>(cudaGetLastError());
}
