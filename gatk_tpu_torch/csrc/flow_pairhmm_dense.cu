// Flow-space PairHMM for NVIDIA Hopper (sm_90a), dense route: one block a
// (read, haplotype) pair over every DP column of the haplotype width, its
// prior gathered from the packed tables inside the kernel.
//
// The entry (ops/flow_pairhmm.flow_pairhmm_pairs) launches it on the pairs
// whose read or haplotype breaks the coset rule of csrc/flow_pairhmm.cu: flow
// bases that do not repeat with period 4 over four distinct bases (an order
// such as TGCATGAC). For such a pair the cells with a nonzero prior lie on
// more than one (column - row) mod 4 coset, and gatk_tpu's dense scan
// (gatk_tpu/ops/flow_pairhmm.py:flow_pairhmm_batch_jax, :116-194, under
// lax.scan; not a Pallas kernel) sums them all. This kernel computes what
// that scan computes, step for step:
//   m_k[c] = prior_k[c] * (m_{k-1}[c-1] * MM + (i_{k-1}[c-1] + d_{k-1}[c-1]) * IM)
//   i_k[c] = m_{k-4}[c] * MI + i_{k-4}[c] * II
//   d_k[c] = m_k[c-4] * MD + d_k[c-4] * DD
// over read flows k and the W = Hp + 5 columns of the tables' haplotype width
// (padded to Wp, a multiple of 4), from m = i = 0 and d_{-1} = 1 / max(hlen, 1)
// in the W columns; each row divided by c = max(M, I, D) of the row (1 where
// c <= 0) and log10(c) added to a float32 offset; the result is log10 of row
// kf = clip(rlen - 1, 0, Rp - 1)'s M + I sum plus the offset before that row,
// -inf where the sum is <= 0. prior_k[c] = P(true hmer = hkey[c - 5] | flow k),
// the read's table row at the haplotype's key, where read flow k and
// haplotype flow c - 5 < hlen read one base, else 0: what
// ops/flow_pairhmm.flow_prior gathers for the plain version,
// ops/flow_pairhmm.flow_pairhmm_batch_plain. The D scan sums in another order
// than the plain version's doubling scan, so the two agree to float32
// rounding (held to 1e-4 in log10 by tests/test_torch_kernel_cuda.py and
// chip_smoke.py).
//
// Inputs are those of csrc/flow_pairhmm.cu (ops/flow_pairhmm.pack_flow_tables):
// tables (NR, Rp, T1) f32; rfo (NR, Rp) u8; trans (NR, Rp, 6) f32; rlen (NR,)
// i32; hkey (NH, Hp) i32; hfo (NH, Hp) u8; hlen (NH,) i32; the pairs ri, hi
// (B,) i32. Output (B,) f32, NaN for a pair whose indices or lengths are out
// of range.
//
// What bounds it: 14 FP32 operations a dense cell (the recurrence's 11 and the
// row maximum of M, I and D), Wp cells a row; the inputs are small, so the
// bound is the operations. But each row depends on the one before and its D is
// a scan along the columns, so the time is the latency of the row loop: a few
// block barriers a row.
//
// Design (simple first): a block of four warps a pair. The carried state, a
// ring of the last four M and I rows and the previous D row, 9 x Wp floats,
// lives in dynamic shared memory behind the block's 12 floats of reductions
// where both fit (Wp <= 6,452, Hp <= 6,447) and otherwise in a slice of global
// scratch a block, the blocks then walking the pairs with a stride of the
// grid. The kernel holds no static shared memory. A row is
//   1. M and I elementwise, each thread over columns c = tid + 128 n, its prior
//      gathered from the read's table row at the haplotype's key; the new row
//      overwrites the ring's slot of row k - 4, which only I at the same
//      column reads;
//   2. D's four stride-4 chains, warp p scanning the columns c = 4 g + p: an
//      inclusive scan of the affine maps (DD, m[c - 4] * MD) over 32 groups
//      at a time by warp shuffles, carried from one 32-group chunk to the next;
//   3. a block maximum of M, I and D for c (and at kf the M and I sums), then
//      every carried row scaled by 1 / c.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFlow = 4;       // FLOW_SIZE: the flow-order cycle
constexpr int kThreads = 128;  // four warps: warp p scans deletion chain p
constexpr int kWarps = kThreads / 32;
constexpr int kStateRows = 9;  // M 0-3, I 0-3, D
constexpr int kReduce = 3 * kWarps;  // the row maximum and the M and I sums of each warp
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTrans = 6;
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
flow_pairhmm_dense_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ rfo,
                          const float* __restrict__ trans, const int* __restrict__ rlen,
                          const int* __restrict__ hkey, const unsigned char* __restrict__ hfo,
                          const int* __restrict__ hlen, const int* __restrict__ ri_,
                          const int* __restrict__ hi_, float* __restrict__ out,
                          float* __restrict__ scratch, int B, int NR, int Rp, int T1, int NH,
                          int Hp, int W, int Wp) {
  extern __shared__ float smem[];
  float* red_max = smem;  // kWarps floats each, ahead of the state
  float* red_m = smem + kWarps;
  float* red_i = smem + 2 * kWarps;
  float* M = scratch ? scratch + static_cast<size_t>(blockIdx.x) * kStateRows * Wp
                     : smem + kReduce;
  float* I = M + 4 * Wp;  // 4 x Wp: row k in slot k & 3, as M
  float* D = I + 4 * Wp;  // Wp: the previous (then the current) D row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Wg = Wp / kFlow;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int ri = ri_[b], hi = hi_[b];
    const bool idx_ok = ri >= 0 && ri < NR && hi >= 0 && hi < NH;
    const int R = idx_ok ? rlen[ri] : -1, H = idx_ok ? hlen[hi] : -1;
    if (!idx_ok || R < 0 || R > Rp || H < 0 || H > Hp) {
      if (tid == 0) out[b] = NAN;
      continue;
    }
    const float* tab = tables + static_cast<size_t>(ri) * Rp * T1;
    const float* tr = trans + static_cast<size_t>(ri) * Rp * kTrans;
    const unsigned char* rf = rfo + static_cast<size_t>(ri) * Rp;
    const int* hk = hkey + static_cast<size_t>(hi) * Hp;
    const unsigned char* hf = hfo + static_cast<size_t>(hi) * Hp;
    const int kf = min(max(R - 1, 0), Rp - 1);
    const float init = 1.0f / fmaxf(static_cast<float>(H), 1.0f);

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
      const float* t = tr + static_cast<size_t>(k) * kTrans;
      const float mm = t[kMM], im = t[kIM], mi = t[kMI], ii = t[kII], md = t[kMD], dd = t[kDD];
      const float* trow = tab + static_cast<size_t>(k) * T1;
      const unsigned char base = rf[k];
      float mx = 0.0f, sum_m = 0.0f, sum_i = 0.0f;
      // 1. M and I of row k, the prior gathered at each column
      for (int j = tid; j < Wp; j += kThreads) {
        const int f = j - kFlow - 1;  // the haplotype flow of column j
        float pr = 0.0f;
        if (f >= 0 && f < H && hf[f] == base) {
          const unsigned key = static_cast<unsigned>(hk[f]);
          pr = key < static_cast<unsigned>(T1) ? trow[key] : 0.0f;
        }
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
          for (int w = 0; w < kWarps; ++w) {
            tm += red_m[w];
            ti += red_i[w];
          }
          const float total = tm + ti;
          out[b] = total > 0.0f ? log10f(fmaxf(total, 1e-38f)) + acc : -INFINITY;
        }
        break;
      }
      float c = red_max[0];
      for (int w = 1; w < kWarps; ++w) c = fmaxf(c, red_max[w]);
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
    __syncthreads();  // the reductions and the state are read before the next pair's
  }
}

int padded_width(int Hp) { return (Hp + kFlow + 1 + kFlow - 1) / kFlow * kFlow; }

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of a pair's carried state for tables of Hp haplotype flows: kept in
// shared memory when flow_pairhmm_dense_smem(Hp) <= 232,448 bytes, else in
// `scratch` of this many floats a block.
extern "C" long long flow_pairhmm_dense_state(int Hp) {
  return static_cast<long long>(kStateRows) * padded_width(Hp);
}

// Bytes of shared memory a block needs to keep that state there: the state
// and the reductions, all the kernel's shared memory.
extern "C" long long flow_pairhmm_dense_smem(int Hp) {
  return (flow_pairhmm_dense_state(Hp) + kReduce) * 4;
}

// Launches `grid` blocks of 128 threads on `stream`, each walking the pairs
// with a stride of the grid; scratch is null when the state fits shared
// memory, else grid * flow_pairhmm_dense_state(Hp) floats. Returns
// cudaGetLastError().
extern "C" int flow_pairhmm_dense(const void* tables, const void* rfo, const void* trans,
                                  const void* rlen, const void* hkey, const void* hfo,
                                  const void* hlen, const void* ri, const void* hi, void* out,
                                  void* scratch, int B, int NR, int Rp, int T1, int NH, int Hp,
                                  int grid, void* stream) {
  if (B <= 0 || Rp <= 0 || T1 <= 0 || Hp < 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Wp = padded_width(Hp);
  const long long smem_bytes = flow_pairhmm_dense_smem(Hp);
  if (!scratch && smem_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = scratch ? kReduce * 4 : static_cast<int>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(flow_pairhmm_dense_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flow_pairhmm_dense_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<const unsigned char*>(rfo),
      static_cast<const float*>(trans), static_cast<const int*>(rlen),
      static_cast<const int*>(hkey), static_cast<const unsigned char*>(hfo),
      static_cast<const int*>(hlen), static_cast<const int*>(ri), static_cast<const int*>(hi),
      static_cast<float*>(out), static_cast<float*>(scratch), B, NR, Rp, T1, NH, Hp,
      Hp + kFlow + 1, Wp);
  return static_cast<int>(cudaGetLastError());
}
