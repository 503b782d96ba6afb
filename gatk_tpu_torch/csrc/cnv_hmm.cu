// Copy-number HMM forward-backward pass for NVIDIA Hopper (sm_90a).
//
// Computes what gatk_tpu/cnv/denoising.py:_hmm_forward_backward (:42-67)
// computes under lax.scan, with the transitions that
// GermlineDenoisingModel._posteriors (:140-149) builds, for S samples in one
// launch: the log posteriors out (S, T, C) of copy-number state c at interval
// t, given log emissions log_em (S, T, C), log priors log_pi (S, T, C) and the
// stay probabilities stay (T - 1,) that all samples share. The transition out
// of interval t is
//   tr_t(c, c') = log(stay[t] * [c == c'] + (1 - stay[t]) * exp(log_pi[t + 1][c'])).
// gatk_tpu has no Pallas kernel here: this kernel takes the place of an eager
// PyTorch loop of T dependent steps a direction, each several kernel launches.
//
// What bounds it: the T dependent steps of each direction. The bytes (log_em
// and log_pi read once, the posteriors written once) take microseconds at
// 3.35 TB/s, and the operations (about 4 C^2 a step and sample) less; a step's
// latency (2 C shuffles, C + 1 expf, three logf, C dependent adds) times T is
// the floor of one launch, however many samples it holds.
//
// Design: one block of eight warps per sample. Warp 0 runs the forward
// recursion while warp 1 runs the backward one; lane c holds state c
// (C <= 32; lanes c >= C take part in the shuffles only). A lane forms its
// column (forward) or its share of a row (backward) of tr_t from stay[t] and
// log_pi in registers, so the (S, T - 1, C, C) transition tensor is never
// stored. Each of the two warps loads its inputs kPrefetch steps ahead into
// registers, so a step does not wait on device memory. alpha goes to `out`,
// beta to the scratch `beta`; after a __syncthreads all eight warps normalise
// the intervals in place, four of a warp's at once, so that their loads
// overlap.
//
// Arithmetic: operation for operation that of the plain version
// (ops/cnv_hmm.hmm_forward_backward_reference), in float32, with no product
// contracted into an FMA (__fmul_rn, __fadd_rn): a log-sum-exp takes the max
// of its C terms (0 where that is not finite), sums the terms' exps from 0 in
// order c = 0, 1, ..., C - 1 and adds the log of the sum to the max. The
// kernel and the plain version therefore agree to the last bit wherever expf
// and logf do, which matters here: a log joint of 10,000 intervals reaches
// |4e4|, where one rounding step of a float32 is 0.004.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPrefetch = 8;  // steps a warp's loads run ahead of its recursion
constexpr int kMaxStates = 32;
constexpr int kWarps = 8;  // a block: the two recursions, then all eight normalise
constexpr int kNormUnroll = 4;  // intervals a warp normalises at once

__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.0f; }

// log-transitions into this lane's state at a step with stay probability
// `stay` and log prior `lp` of this state: from another state (off) and from
// itself (dia); stay * 0 + b is b and stay * 1 is stay, as in the plain version.
__device__ __forceinline__ void transition(float stay, float lp, float& off, float& dia) {
  const float b = __fmul_rn(__fsub_rn(1.0f, stay), expf(lp));
  off = logf(b);
  dia = logf(__fadd_rn(stay, b));
}

__device__ __forceinline__ float shfl(float v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

__global__ void __launch_bounds__(kWarps * 32) cnv_hmm_kernel(const float* __restrict__ log_em,
                                                     const float* __restrict__ log_pi,
                                                     const float* __restrict__ stay,
                                                     float* __restrict__ out,
                                                     float* __restrict__ beta, int T, int C) {
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool on = lane < C;
  const size_t base = static_cast<size_t>(s) * T * C;
  const float* em = log_em + base;
  const float* lp = log_pi + base;
  float* al = out + base;
  float* be = beta + base;

  float pem[kPrefetch] = {}, plp[kPrefetch] = {}, pst[kPrefetch] = {};
  if (warp == 0) {
    // forward: alpha_0 = lp_0 + em_0;
    // alpha_t(c') = lse_c(alpha_{t-1}(c) + tr_{t-1}(c, c')) + em_t(c')
    float alpha = on ? __fadd_rn(lp[lane], em[lane]) : -INFINITY;
    if (on) al[lane] = alpha;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int t = 1 + k;
      if (t < T && on) {
        pem[k] = em[t * C + lane];
        plp[k] = lp[t * C + lane];
        pst[k] = stay[t - 1];
      }
    }
    for (int t0 = 1; t0 < T; t0 += kPrefetch) {
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int t = t0 + k;
        if (t >= T) break;
        const float e_t = pem[k], lp_t = plp[k], st = pst[k];
        const int tn = t + kPrefetch;
        if (tn < T && on) {
          pem[k] = em[tn * C + lane];
          plp[k] = lp[tn * C + lane];
          pst[k] = stay[tn - 1];
        }
        float off = 0.0f, dia = 0.0f;
        if (on) transition(st, lp_t, off, dia);
        float m = -INFINITY;
        for (int c = 0; c < C; ++c) {
          const float x = __fadd_rn(shfl(alpha, c), c == lane ? dia : off);
          m = fmaxf(m, x);
        }
        m = finite_or_zero(m);
        float sum = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float x = __fadd_rn(shfl(alpha, c), c == lane ? dia : off);
          const float e = expf(__fsub_rn(x, m));
          sum = __fadd_rn(sum, e);
        }
        alpha = on ? __fadd_rn(__fadd_rn(logf(sum), m), e_t) : -INFINITY;
        if (on) al[t * C + lane] = alpha;
      }
    }
  } else if (warp == 1) {
    // backward: beta_{T-1} = 0;
    // beta_t(c) = lse_c'(tr_t(c, c') + (em_{t+1}(c') + beta_{t+1}(c')))
    float b = 0.0f;
    if (on) be[(T - 1) * C + lane] = b;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int t = T - 2 - k;
      if (t >= 0 && on) {
        pem[k] = em[(t + 1) * C + lane];
        plp[k] = lp[(t + 1) * C + lane];
        pst[k] = stay[t];
      }
    }
    for (int t0 = T - 2; t0 >= 0; t0 -= kPrefetch) {
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int t = t0 - k;
        if (t < 0) break;
        const float e_n = pem[k], lp_n = plp[k], st = pst[k];
        const int tn = t - kPrefetch;
        if (tn >= 0 && on) {
          pem[k] = em[(tn + 1) * C + lane];
          plp[k] = lp[(tn + 1) * C + lane];
          pst[k] = stay[tn];
        }
        float off = 0.0f, dia = 0.0f;
        if (on) transition(st, lp_n, off, dia);
        const float v = __fadd_rn(e_n, b);  // em_{t+1} + beta_{t+1} of this lane's state
        float m = -INFINITY;
        for (int c = 0; c < C; ++c) {
          const float o = shfl(off, c), w = shfl(v, c);
          m = fmaxf(m, __fadd_rn(c == lane ? dia : o, w));
        }
        m = finite_or_zero(m);
        float sum = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float o = shfl(off, c), w = shfl(v, c);
          const float e = expf(__fsub_rn(__fadd_rn(c == lane ? dia : o, w), m));
          sum = __fadd_rn(sum, e);
        }
        b = on ? __fadd_rn(logf(sum), m) : 0.0f;
        if (on) be[t * C + lane] = b;
      }
    }
  }
  __syncthreads();

  // log posterior = (alpha + beta) - lse_c(alpha + beta), every warp of the
  // block on its own intervals, kNormUnroll of them loaded at once
  for (int t0 = warp; t0 < T; t0 += kWarps * kNormUnroll) {
    float x[kNormUnroll];
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const int t = t0 + u * kWarps;
      x[u] = on && t < T ? __fadd_rn(al[t * C + lane], be[t * C + lane]) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const int t = t0 + u * kWarps;
      if (t >= T) break;
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) m = fmaxf(m, shfl(x[u], c));
      m = finite_or_zero(m);
      const float e = expf(__fsub_rn(x[u], m));
      float sum = 0.0f;
      for (int c = 0; c < C; ++c) sum = __fadd_rn(sum, shfl(e, c));
      if (on) al[t * C + lane] = __fsub_rn(x[u], __fadd_rn(logf(sum), m));
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). log_em,
// log_pi, out and beta are (S, T, C) f32, contiguous; stay is (T - 1,) f32.
extern "C" int cnv_hmm(const void* log_em, const void* log_pi, const void* stay, void* out,
                       void* beta, int S, int T, int C, void* stream) {
  if (S <= 0 || T <= 0 || C <= 0 || C > kMaxStates) return static_cast<int>(cudaErrorInvalidValue);
  cnv_hmm_kernel<<<S, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_em), static_cast<const float*>(log_pi),
      static_cast<const float*>(stay), static_cast<float*>(out), static_cast<float*>(beta), T, C);
  return static_cast<int>(cudaGetLastError());
}
