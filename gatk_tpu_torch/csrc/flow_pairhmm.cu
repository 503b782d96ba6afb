// Flow-space PairHMM for NVIDIA Hopper (sm_90a).
//
// Computes what gatk_tpu/ops/flow_pairhmm.py:flow_pairhmm_batch_jax (:116-194)
// computes under lax.scan: for each of B (read, haplotype) pairs the float32
// log10 likelihood of the read's flow keys given the haplotype's, by
// FlowBasedPairHMM's recurrence over read flow rows k (DP row k + 5) and
// haplotype flow columns j:
//   m_k[j] = prior[k][j] * (m_{k-1}[j-1] * MM + (i_{k-1}[j-1] + d_{k-1}[j-1]) * IM)
//   i_k[j] = m_{k-4}[j] * MI + i_{k-4}[j] * II
//   d_k[j] = m_k[j-4] * MD + d_k[j-4] * DD
// with each row renormalised by c = max(m_k, i_k, d_k) (1 where c <= 0) and
// log10(c) added to a float32 offset; the result is log10 of row
// kf = clip(rlen - 1, 0, Rp - 1)'s M + I sum plus the offset before it, -inf
// where that sum is <= 0. gatk_tpu has no Pallas kernel here; its device
// program is the scan. ops/flow_pairhmm.flow_pairhmm_batch_plain is the plain
// version of this kernel, step for step.
//
// Inputs: prior (B, Rp, W) f32, already masked to the pair's coset (gathered
// on the card, ops/flow_pairhmm.flow_prior), trans (B, Rp, 6) f32, rlen and
// hlen (B,) int32. Output: (B,) f32.
//
// What bounds it: per row a pair needs its W prior values and about 14 FP32
// operations a column (the recurrence's 11 and the row maximum), but every row
// depends on the one before, and each row's D is a scan along the columns:
// the kernel is bound by the latency of the row loop (Rp rows, each a few
// block barriers), not by the bytes or the operations. The batch's pairs run
// in parallel, one block each.
//
// Design (simple first): one block of four warps per pair, all rows in a loop
// that stops at the pair's own kf. Shared memory holds the carried state:
// a ring of the last four M and I rows and the previous D row, 9 x Wp floats
// (Wp = W rounded up to a multiple of 4; 27 KB at W = 755). A row is
//   1. M and I elementwise, each thread over columns j = tid + 128 n; the new
//      row overwrites the ring's slot of row k - 4, which only I at the same
//      column reads;
//   2. D's four stride-4 chains, warp p scanning the columns j = 4 g + p: an
//      inclusive scan of the affine maps (DD, m[j-4] * MD) over 32 groups at a
//      time by warp shuffles (Hillis-Steele), carried from one 32-group chunk
//      to the next;
//   3. a block max of M, I and D for c (and at kf the M and I sums), then
//      every carried row scaled by 1 / c.
// Every column of the batch's W (and its padding) is computed, the three
// off-coset columns of every four included, as the plain version does, so the
// row maxima are the same; skipping them (3/4 of the work), wgmma and TMA are
// left for later. The order of the D scan's sums differs from the plain
// version's doubling scan, so the two agree to float32 rounding (held to 1e-4
// in log10 by chip_smoke.py and tests/test_torch_kernel_cuda.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFlow = 4;        // FLOW_SIZE: the flow-order cycle
constexpr int kThreads = 128;   // four warps: warp p scans deletion chain p
constexpr unsigned kFull = 0xffffffffu;
// ops/pairhmm_model.py's transition columns
constexpr int kMM = 0, kIM = 1, kMI = 2, kII = 3, kMD = 4, kDD = 5;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flow_pairhmm_kernel(const float* __restrict__ prior, const float* __restrict__ trans,
                    const int* __restrict__ rlen, const int* __restrict__ hlen,
                    float* __restrict__ out, int Rp, int W, int Wp) {
  extern __shared__ float smem[];
  float* M = smem;             // 4 x Wp: row k in slot k & 3
  float* I = M + 4 * Wp;       // 4 x Wp
  float* D = I + 4 * Wp;       // Wp: the previous (then the current) D row
  __shared__ float red_max[kThreads / 32];
  __shared__ float red_m[kThreads / 32];
  __shared__ float red_i[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* P = prior + static_cast<size_t>(b) * Rp * W;
  const float* T = trans + static_cast<size_t>(b) * Rp * 6;
  const int kf = min(max(rlen[b] - 1, 0), Rp - 1);
  const float init = 1.0f / fmaxf(static_cast<float>(hlen[b]), 1.0f);
  const int Wg = Wp / kFlow;

  for (int j = tid; j < Wp; j += kThreads) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      M[s * Wp + j] = 0.0f;
      I[s * Wp + j] = 0.0f;
    }
    D[j] = j < W ? init : 0.0f;
  }
  __syncthreads();

  float acc = 0.0f;
  for (int k = 0;; ++k) {
    const int s = k & 3, s1 = (k + 3) & 3;
    const float* t = T + k * 6;
    const float mm = t[kMM], im = t[kIM], mi = t[kMI], ii = t[kII], md = t[kMD], dd = t[kDD];
    const float* pk = P + static_cast<size_t>(k) * W;
    float mx = 0.0f, sum_m = 0.0f, sum_i = 0.0f;
    // 1. M and I of row k
    for (int j = tid; j < Wp; j += kThreads) {
      const float pr = j < W ? pk[j] : 0.0f;
      float m_new = 0.0f;
      if (j > 0)
        m_new = pr * (M[s1 * Wp + j - 1] * mm + (I[s1 * Wp + j - 1] + D[j - 1]) * im);
      const float i_new = M[s * Wp + j] * mi + I[s * Wp + j] * ii;
      M[s * Wp + j] = m_new;
      I[s * Wp + j] = i_new;
      mx = fmaxf(mx, fmaxf(m_new, i_new));
      sum_m += m_new;
      sum_i += i_new;
    }
    __syncthreads();
    // 2. D of row k: warp p scans d[g] = a[g] + dd * d[g - 1] over the
    //    columns 4 g + p, a[g] = m_k[4 (g - 1) + p] * md, from d[-1] = 0
    {
      const float* Ms = M + s * Wp;
      float carry = 0.0f;
      for (int g0 = 0; g0 < Wg; g0 += 32) {
        const int g = g0 + lane;
        const int j = kFlow * g + warp;
        float a = (g >= 1 && g < Wg) ? Ms[j - kFlow] * md : 0.0f;
        float A = dd;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float a_up = __shfl_up_sync(kFull, a, o);
          const float A_up = __shfl_up_sync(kFull, A, o);
          if (lane >= o) {
            a = a + A * a_up;
            A = A * A_up;
          }
        }
        const float d = a + A * carry;
        if (g < Wg) {
          D[j] = d;
          mx = fmaxf(mx, d);
        }
        carry = __shfl_sync(kFull, d, 31);
      }
    }
    // 3. the row's maximum (and at kf its sums)
    mx = warp_max(mx);
    if (k == kf) {
      sum_m = warp_sum(sum_m);
      sum_i = warp_sum(sum_i);
    }
    if (lane == 0) {
      red_max[warp] = mx;
      red_m[warp] = sum_m;
      red_i[warp] = sum_i;
    }
    __syncthreads();
    if (k == kf) {
      if (tid == 0) {
        float tm = 0.0f, ti = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) {
          tm += red_m[w];
          ti += red_i[w];
        }
        const float total = tm + ti;
        out[b] = total > 0.0f ? log10f(fmaxf(total, 1e-38f)) + acc : -INFINITY;
      }
      return;
    }
    float c = red_max[0];
    for (int w = 1; w < kThreads / 32; ++w) c = fmaxf(c, red_max[w]);
    c = c > 0.0f ? c : 1.0f;
    const float inv = 1.0f / c;
    acc += log10f(c);
    for (int j = tid; j < Wp; j += kThreads) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        M[q * Wp + j] *= inv;
        I[q * Wp + j] *= inv;
      }
      D[j] *= inv;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block needs at width W.
extern "C" long long flow_pairhmm_smem(int W) {
  const long long Wp = (W + kFlow - 1) / kFlow * kFlow;
  return 9 * Wp * static_cast<long long>(sizeof(float));
}

// Launches one block per pair on `stream`; returns cudaGetLastError().
extern "C" int flow_pairhmm(const void* prior, const void* trans, const void* rlen,
                            const void* hlen, void* out, int B, int Rp, int W, void* stream) {
  if (B <= 0 || Rp <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Wp = (W + kFlow - 1) / kFlow * kFlow;
  const size_t smem = static_cast<size_t>(flow_pairhmm_smem(W));
  cudaError_t err = cudaFuncSetAttribute(flow_pairhmm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flow_pairhmm_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prior), static_cast<const float*>(trans),
      static_cast<const int*>(rlen), static_cast<const int*>(hlen), static_cast<float*>(out),
      Rp, W, Wp);
  return static_cast<int>(cudaGetLastError());
}
