// PairHMM forward kernel for NVIDIA Hopper (sm_90a).
//
// Replaces gatk_tpu/ops/pairhmm_tpu.py:_pairhmm_kernel_v6 (called through
// _pairhmm_call_v6 from _pairhmm_pool_scan and _pairhmm_cartesian_v6): per
// (read, haplotype) pair, log10 P(read | hap) by GATK's logless 3-state forward
// recurrence (LoglessPairHMM.java:48-70) in f32, initial deletion row
// 2^100 / hlen, final-row M + I summed in linear f32, result
// (log(acc) - 100 ln2) / ln10, or NEG_INF where acc <= 0. An N in the read or
// the haplotype scores as a match (the host f64 rule, pairhmm_model.py:82; v6
// itself scores a haplotype N as a mismatch).
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
// What the design does about it:
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 5;                 // read rows per lane
constexpr int kStripe = kWarp * kRows;   // read rows per warp sweep
constexpr int kEOff = 16;                // E_OFF of the packed haplotype layout
constexpr int kWarpsPerBlock = 4;
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory one block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegLn10Over10 = -0.23025850929940458f;
constexpr float kInit = 1267650600228229401496703205376.0f;  // 2^100
constexpr float kInitLn = 69.31471805599453f;                // 100 ln 2
constexpr float kInvLn10 = 0.4342944819032518f;
constexpr float kNegInf = -1e30f;
constexpr int kN = 'N';

struct Args {
  const uint8_t *rbase, *rq, *iq, *dq, *gcp;
  const int32_t* rlen;
  const uint8_t* e;
  const int32_t* hlen;
  const int32_t *ri, *hi;
  float* out;
  int n, rp, nr, nh, hmax;
  int multi_stripe;      // rp - 1 > kStripe: stripe row buffers are present
  size_t smem_per_warp;  // bytes: [2][3][hmax + 1] floats if multi_stripe, then hmax bytes
};

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pairhmm_fwd_kernel(Args a, int warps_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long pair = (long long)blockIdx.x * warps_per_block + warp;
  if (pair >= a.n) return;  // warp-uniform

  const int r = a.ri[pair];
  const int h = a.hi[pair];
  if (r < 0 || r >= a.nr || h < 0 || h >= a.nh) {
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
    const int s0 = s * kStripe;                // rows s0+1 .. s0+kStripe
    const int row0 = s0 + lane * kRows + 1;    // this lane's first row
    const int nl = (min(kStripe, L - s0) + kRows - 1) / kRows;  // lanes with rows
    const int kL = (s == n_stripes - 1 && lane == lastL / kRows) ? lastL % kRows : -1;

    float tmm[kRows], tim[kRows], tmi[kRows], tii[kRows], tmd[kRows], tdd[kRows];
    float peq[kRows], pne[kRows], M[kRows], X[kRows], Y[kRows];
    int rb[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = row0 + k;
      M[k] = X[k] = Y[k] = 0.f;  // column 0
      if (i <= L) {
        const size_t idx = (size_t)i * a.nr + r;
        const float e_ins = expf((float)a.iq[idx] * kNegLn10Over10);
        const float e_del = expf((float)a.dq[idx] * kNegLn10Over10);
        const float e_gcp = expf((float)a.gcp[idx] * kNegLn10Over10);
        const float e_base = expf((float)a.rq[idx] * kNegLn10Over10);
        tmm[k] = 1.f - fminf(1.f, e_ins + e_del);
        tim[k] = 1.f - e_gcp;
        tmi[k] = e_ins;
        tii[k] = e_gcp;
        tmd[k] = e_del;
        tdd[k] = e_gcp;
        peq[k] = 1.f - e_base;
        rb[k] = a.rbase[idx];
        pne[k] = rb[k] == kN ? peq[k] : e_base * (1.0f / 3.0f);
      } else {  // below the read: never feeds a row <= L
        tmm[k] = tim[k] = tmi[k] = tii[k] = tmd[k] = tdd[k] = peq[k] = pne[k] = 0.f;
        rb[k] = -1;
      }
    }

    // the row above this lane's rows at column j-1 (starts at column 0, where
    // only row 0 is nonzero: Y = y0)
    float upM = 0.f, upX = 0.f, upY = (s == 0 && lane == 0) ? y0 : 0.f;
    float pubM = 0.f, pubX = 0.f, pubY = 0.f;  // this lane's bottom row, its last column
    const float* rd = bnd + (s & 1) * 3 * H1;      // row s0 from the previous stripe
    float* wr = bnd + ((s + 1) & 1) * 3 * H1;      // row s0 + kStripe for the next
    const bool write_bnd = s + 1 < n_stripes && lane == kWarp - 1;

    const int T = H + nl - 1;
    for (int t = 1; t <= T; ++t) {
      const int j = t - lane;
      // the row above at column j: lane-1's bottom row, computed last step
      float inM = __shfl_up_sync(kFull, pubM, 1);
      float inX = __shfl_up_sync(kFull, pubX, 1);
      float inY = __shfl_up_sync(kFull, pubY, 1);
      if (lane == 0) {
        if (s == 0) {
          inM = 0.f; inX = 0.f; inY = y0;
        } else if (j <= H) {
          inM = rd[j]; inX = rd[H1 + j]; inY = rd[2 * H1 + j];
        }
      }
      if (j >= 1 && j <= H && lane < nl) {
        const int hb = hs[j - 1];
        const bool hN = hb == kN;
        float dM = upM, dX = upX, dY = upY;  // row above, column j-1
        float aM = inM, aX = inX;            // row above, column j
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float prior = (rb[k] == hb || hN) ? peq[k] : pne[k];
          const float m_new = prior * (tmm[k] * dM + tim[k] * (dX + dY));
          const float x_new = tmi[k] * aM + tii[k] * aX;
          const float y_new = tmd[k] * M[k] + tdd[k] * Y[k];
          dM = M[k]; dX = X[k]; dY = Y[k];
          aM = m_new; aX = x_new;
          M[k] = m_new; X[k] = x_new; Y[k] = y_new;
          if (k == kL) acc += m_new + x_new;
        }
        upM = inM; upX = inX; upY = inY;
        pubM = M[kRows - 1]; pubX = X[kRows - 1]; pubY = Y[kRows - 1];
        if (write_bnd) {
          wr[j] = pubM; wr[H1 + j] = pubX; wr[2 * H1 + j] = pubY;
        }
      }
    }
    __syncwarp();  // the next stripe reads this stripe's bottom row
  }

  if (lane == lastL / kRows) {
    a.out[pair] = acc > 0.f ? (logf(fmaxf(acc, 1e-44f)) - kInitLn) * kInvLn10 : kNegInf;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pairhmm_fwd(const void* rbase, const void* rq, const void* iq, const void* dq,
                           const void* gcp, const void* rlen, const void* e, const void* hlen,
                           const void* ri, const void* hi, void* out, int n, int rp, int nr,
                           int he, int nh, void* stream) {
  Args a;
  a.rbase = static_cast<const uint8_t*>(rbase);
  a.rq = static_cast<const uint8_t*>(rq);
  a.iq = static_cast<const uint8_t*>(iq);
  a.dq = static_cast<const uint8_t*>(dq);
  a.gcp = static_cast<const uint8_t*>(gcp);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.e = static_cast<const uint8_t*>(e);
  a.hlen = static_cast<const int32_t*>(hlen);
  a.ri = static_cast<const int32_t*>(ri);
  a.hi = static_cast<const int32_t*>(hi);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.rp = rp;
  a.nr = nr;
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
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pairhmm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((n + wpb - 1) / wpb);
  pairhmm_fwd_kernel<<<grid, wpb * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(a, wpb);
  return static_cast<int>(cudaGetLastError());
}
