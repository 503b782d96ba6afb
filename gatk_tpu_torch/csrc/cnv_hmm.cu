// Copy-number HMM forward-backward pass for NVIDIA Hopper (sm_90a).
//
// Computes what gatk_tpu/cnv/denoising.py:_hmm_forward_backward (:42-67)
// computes under lax.scan, with the transitions that
// GermlineDenoisingModel._posteriors (:140-149) builds, for S samples in one
// pass: the log posteriors out (S, T, C) of copy-number state c at interval
// t, given log emissions log_em (S, T, C), log priors log_pi (S, T, C) and
// the stay probabilities stay (T - 1,) that all samples share. The transition
// out of interval t is
//   tr_t(c, c') = log(stay[t] * [c == c'] + (1 - stay[t]) * exp(log_pi[t + 1][c'])),
// a diagonal plus a rank-one matrix. gatk_tpu has no Pallas kernel here: the
// pass takes the place of an eager PyTorch loop of T dependent steps a
// direction, each several kernel launches.
//
// What bounds it: not the bytes (log_em and log_pi read once, the posteriors
// written once: microseconds at 3.35 TB/s) but the chain of dependent steps.
// A sequential pass has T of them a direction; this one cuts the intervals
// into chunks of L steps (the caller's `chunk`, 128 by a sweep on the card)
// and has 2 L + P a direction, P = ceil((T - 1) / L) chunks.
//
// Design: after log_stay_kernel (the logs of stay and 1 - stay, once for
// every step), three kernels on one stream:
//   A (transfer_kernel) for each sample, chunk, direction and state i, one
//     lane runs the chunk's L steps from the one-hot start e_i, holding the
//     whole vector over the states in registers: row i of the chunk's C x C
//     transfer in the log semiring, and its log-scale. A is C times the
//     sequential pass's work and bound by its throughput, so a lane does a
//     step's log-sum-exps in its own registers, with no shuffle and no idle
//     lane; C lanes of a warp share a chunk, so their loads are broadcasts.
//   B (starts_kernel) for each sample and direction, a group of W lanes
//     (lane c holds state c; W = 8 for C <= 8, else 32) scans the P transfers
//     in order for every chunk's start vector.
//   C (posterior_kernel) for each sample and chunk, a group of W lanes of
//     warp 0 reruns the chunk's forward steps from its true start, and a
//     group of warp 1 its backward steps, into shared memory; then the
//     block normalises y + em + beta over the states and writes each
//     posterior once. C is bound by the latency of its L steps, and a step
//     spread over W lanes (group log-sum-exps of log2 W shuffles) is shorter
//     than one in a lane's registers (A's layout took 3 times as long for
//     C on an H100).
// The step is O(C), not O(C^2). The forward recursion carries
// y_t = alpha_t - em_t (y_0 = log_pi_0); with u = y_{p-1} + em_{p-1}
// normalised,
//   y_p(c') = logaddexp(log stay + u(c'), log(1 - stay) + log_pi_p(c')),
// and with v = em_p + beta_p normalised,
//   beta_{p-1}(c) = logaddexp(log stay + v(c), log(1 - stay) + lse_c'(log_pi_p(c') + v(c'))):
// one or two log-sum-exps and a logaddexp a state. W (8 or 32) is a template
// parameter, so every loop over the states is unrolled.
//
// More than 32 states: the same three phases, with a warp (32 lanes) in each
// of A's recursions as well as in B and C, and K = ceil(C / 32) states a lane
// (state c in lane c mod 32), the loops over a lane's states running at run
// time. The vectors are held in the global scratch, each lane touching only
// its own states (B's start vector, which every lane reads whole, is written
// before a __syncwarp): A's recursion runs in place in its row of the
// transfer, C's in its rows of a (L + 1) x CW buffer a direction, CW = 32 K,
// so that neither registers nor shared memory bound C. The arithmetic is the
// groups' (the same maxima, sums and logaddexps a state), in other orders of
// summation.
//
// Arithmetic: every vector is normalised (less its log-sum-exp over the
// states; a start vector less its max) at every step, and a transfer's rows
// keep their log-scales apart, applied relative to their largest in B: one
// common scale per matrix, which keeps the start states' relative weights
// (a scale per row would lose them). A per-interval constant cancels in
// the posterior, em_t + (y_t + beta_t - lse(y_t + em_t + beta_t)), so no log
// joint of |4e4| is formed; and the emission, which reaches -1e3 or less on
// a fitted shard for states far from the data, is added last, so such a log
// posterior takes one float32 rounding at its size and not three. The order
// of operations is not the sequential plain version's: on a 32 x 10,000 x 6
// shard the kernel is held to 1e-3 of the float64 sequential pass (the
// float32 one is ~0.01-0.03 off it) and to 1e-4 (plus two float32 rounding
// steps of the value) of ops/cnv_hmm.hmm_forward_backward_chunked_reference,
// the plain version of this association. A log-sum-exp takes the max, 0
// where that is not finite, so an all -inf vector stays -inf and no NaN
// appears.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroupStates = 32;  // the most states of the group instances (a lane a state)
constexpr int kPrefetch = 8;       // steps a group's loads run ahead of its recursion (C)
constexpr int kThreads = 128;      // threads of an A or B block
constexpr int kPostThreads = 64;   // a C block: the forward warp and the backward warp


__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.0f; }

// The recursion's exps and logs take the hardware's approximations (ex2 and
// lg2, a few ulp): the step is a chain of them, and phase A runs C of its
// recursions for every one of the sequential pass's.
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ float flog(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.6931471805599453f;
}

// log(e^a + e^b) without a branch: where both are -inf, fminf - fmaxf is NaN,
// which fmaxf turns into -1e30, whose exp is 0.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + flog(1.0f + fexp(fmaxf(fminf(a, b) - m, -1e30f)));
}

// ---- phase A's recursion: a lane holds a whole vector over the states

// log-sum-exp of a lane's vector v[0 .. C-1] (kMax slots).
template <int kMax>
__device__ __forceinline__ float vec_lse(const float (&v)[kMax], int C) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMax; ++c)
    if (c < C) m = fmaxf(m, v[c]);
  m = finite_or_zero(m);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kMax; ++c)
    if (c < C) s += fexp(v[c] - m);
  return flog(s) + m;
}

// One step at position p of a lane's vector x (em: interval p - 1's row
// forward, p's backward; lp: interval p's row; ls, lb: log stay and
// log(1 - stay) of transition p - 1 -> p); adds the log-scale taken off the
// old vector to acc. Backward, lse(lp + u0) - n stands for lse(lp + u0 - n).
template <bool kFwd, int kMax>
__device__ __forceinline__ void row_step(float (&x)[kMax], const float (&em)[kMax],
                                         const float (&lp)[kMax], float ls, float lb, int C,
                                         float& acc) {
  float u[kMax], v[kMax];
#pragma unroll
  for (int c = 0; c < kMax; ++c) {
    u[c] = x[c] + em[c];
    v[c] = lp[c] + u[c];
  }
  const float n = finite_or_zero(vec_lse<kMax>(u, C));
  const float w = kFwd ? 0.0f : vec_lse<kMax>(v, C) - n;
  acc += n;
#pragma unroll
  for (int c = 0; c < kMax; ++c)
    if (c < C) x[c] = logaddexp(ls + (u[c] - n), lb + (kFwd ? lp[c] : w));
}

template <int kMax>
__device__ __forceinline__ void load_row(float (&dst)[kMax], const float* __restrict__ src, int C,
                                         float pad) {
#pragma unroll
  for (int c = 0; c < kMax; ++c) dst[c] = c < C ? src[c] : pad;
}

// n steps of x at positions p0, p0 + 1, ... (forward) or p0, p0 - 1, ...
// (backward) of one sample's em, lp (T, C).
template <bool kFwd, int kMax>
__device__ void row_run(float (&x)[kMax], const float* __restrict__ em,
                        const float* __restrict__ lp, const float* __restrict__ log_stay,
                        const float* __restrict__ log_move, int C, int p0, int n, float& acc) {
  const int dp = kFwd ? 1 : -1;
  for (int j = 0; j < n; ++j) {
    const int p = p0 + j * dp;
    float e[kMax], l[kMax];
    load_row<kMax>(e, em + (kFwd ? p - 1 : p) * C, C, 0.0f);
    load_row<kMax>(l, lp + p * C, C, -INFINITY);
    row_step<kFwd, kMax>(x, e, l, log_stay[p - 1], log_move[p - 1], C, acc);
  }
}

// ---- phase C's recursion: a group of W lanes holds a vector, lane c state c

// A group of W lanes (W a power of two <= 32) aligned within its warp.
template <int W>
struct Group {
  unsigned mask;
  __device__ explicit Group(int lane_in_warp)
      : mask(W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane_in_warp & ~(W - 1))) {}
  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(mask, v, o, W));
    return v;
  }
  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, W);
    return v;
  }
  __device__ __forceinline__ float lse(float v) const {
    const float m = finite_or_zero(max(v));
    return flog(sum(fexp(v - m))) + m;
  }
  // lse of a and of b, their reductions interleaved
  __device__ __forceinline__ void lse2(float a, float b, float& la, float& lb) const {
    float ma = a, mb = b;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(mask, ma, o, W));
      mb = fmaxf(mb, __shfl_xor_sync(mask, mb, o, W));
    }
    ma = finite_or_zero(ma);
    mb = finite_or_zero(mb);
    float sa = fexp(a - ma), sb = fexp(b - mb);
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(mask, sa, o, W);
      sb += __shfl_xor_sync(mask, sb, o, W);
    }
    la = flog(sa) + ma;
    lb = flog(sb) + mb;
  }
  __device__ __forceinline__ float get(float v, int lane) const {
    return __shfl_sync(mask, v, lane, W);
  }
};

// One step at position p (em of interval p - 1 forward, p backward; lp of
// interval p; ls, lb = log stay and log(1 - stay) of transition p - 1 -> p)
// of this lane's state; adds the
// log-scale taken off the old vector to acc. Backward, lse(lp + u0) - n
// stands for lse(lp + u0 - n), so that both reductions run at once.
template <bool kFwd, int W>
__device__ __forceinline__ float group_step(const Group<W>& g, bool on, float x, float em,
                                            float lp, float ls, float lb, float& acc) {
  const float u0 = x + em;
  float n, w;
  if (kFwd) {
    n = finite_or_zero(g.lse(u0));
    w = lp;
  } else {
    float lw;
    g.lse2(u0, lp + u0, n, lw);
    n = finite_or_zero(n);
    w = lw - n;
  }
  acc += n;
  const float y = logaddexp(ls + (u0 - n), lb + w);
  return on ? y : -INFINITY;
}

// n steps from x at positions p0, p0 + 1, ... (forward) or p0, p0 - 1, ...
// (backward) of one sample's em, lp (T, C); with kStore, step j's vector goes
// to store[j * sstride + lane].
template <bool kFwd, bool kStore, int W>
__device__ float group_run(const Group<W>& g, int lane, int C, float x,
                           const float* __restrict__ em, const float* __restrict__ lp,
                           const float* __restrict__ log_stay, const float* __restrict__ log_move,
                           int p0, int n, float& acc, float* store, int sstride) {
  const bool on = lane < C;
  const int dp = kFwd ? 1 : -1;
  float pem[kPrefetch], plp[kPrefetch], pls[kPrefetch], plb[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int p = p0 + k * dp;
    const bool ld = k < n;
    pem[k] = ld && on ? em[(kFwd ? p - 1 : p) * C + lane] : 0.0f;
    plp[k] = ld && on ? lp[p * C + lane] : -INFINITY;
    pls[k] = ld ? log_stay[p - 1] : 0.0f;
    plb[k] = ld ? log_move[p - 1] : 0.0f;
  }
  for (int j0 = 0; j0 < n; j0 += kPrefetch) {
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int j = j0 + k;
      if (j >= n) break;
      const float e = pem[k], l = plp[k], ls = pls[k], lb = plb[k];
      const int jn = j + kPrefetch;
      if (jn < n) {
        const int p = p0 + jn * dp;
        if (on) {
          pem[k] = em[(kFwd ? p - 1 : p) * C + lane];
          plp[k] = lp[p * C + lane];
        }
        pls[k] = log_stay[p - 1];
        plb[k] = log_move[p - 1];
      }
      x = group_step<kFwd, W>(g, on, x, e, l, ls, lb, acc);
      if (kStore) store[j * sstride + lane] = x;
    }
  }
  return x;
}

__host__ __device__ inline int num_chunks(int T, int L) { return T <= 1 ? 1 : (T - 2) / L + 1; }

// Floats a vector over the states takes in the scratch: the group's W (8 or
// 32) up to 32 states, 32 K above.
__host__ __device__ inline int state_width(int C) {
  return C <= 8 ? 8 : C <= kGroupStates ? 32 : (C + 31) / 32 * 32;
}

// Scratch layout, floats: rows [2][S][P][C][W], acc [2][S][P][C],
// starts [2][S][P][W], log stay [T - 1], log(1 - stay) [T - 1]; W is
// state_width(C). Past 32 states WideScratch's buffers follow.
struct Scratch {
  float* rows;
  float* acc;
  float* starts;
  float* log_stay;
  float* log_move;
  __host__ __device__ Scratch(float* base, int S, int T, int P, int C, int W)
      : rows(base),
        acc(base + static_cast<size_t>(2) * S * P * C * W),
        starts(base + static_cast<size_t>(2) * S * P * C * (W + 1)),
        log_stay(starts + static_cast<size_t>(2) * S * P * W),
        log_move(log_stay + (T > 1 ? T - 1 : 0)) {}
};

__host__ __device__ inline long long scratch_floats(int S, int T, int C, int P, int W) {
  return 2LL * S * P * (static_cast<long long>(C) * (W + 1) + W) + 2LL * (T > 1 ? T - 1 : 0);
}

// log stay and log(1 - stay) of every transition, once for all the steps.
__global__ void log_stay_kernel(const float* __restrict__ stay, float* log_stay, float* log_move,
                                int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    log_stay[t] = logf(stay[t]);
    log_move[t] = log1pf(-stay[t]);
  }
}

// A: rows of the forward transfers of chunks 0 .. P-2 and of the backward
// transfers of chunks 1 .. P-1 (the ones B uses), a lane a row.
template <int W>
__global__ void __launch_bounds__(kThreads)
    transfer_kernel(const float* __restrict__ log_em, const float* __restrict__ log_pi,
                    float* scratch, int S, int T, int C, int L, int P) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int per_dir = S * (P - 1) * C;
  if (g >= 2 * per_dir) return;
  const int dir = g / per_dir;
  int r = g - dir * per_dir;
  const int i = r % C;
  r /= C;
  const int kk = r % (P - 1);
  const int s = r / (P - 1);
  const int k = dir == 0 ? kk : kk + 1;
  const int begin = k * L, end = min(begin + L, T - 1);
  const Scratch sc(scratch, S, T, P, C, W);
  const size_t base = static_cast<size_t>(s) * T * C;
  float acc = 0.0f;
  float x[W];
#pragma unroll
  for (int c = 0; c < W; ++c) x[c] = c == i ? 0.0f : -INFINITY;
  if (dir == 0)
    row_run<true, W>(x, log_em + base, log_pi + base, sc.log_stay, sc.log_move, C, begin + 1,
                     end - begin, acc);
  else
    row_run<false, W>(x, log_em + base, log_pi + base, sc.log_stay, sc.log_move, C, end,
                      end - begin, acc);
  const size_t m = (static_cast<size_t>(dir) * S + s) * P + k;
  float* row = sc.rows + (m * C + i) * W;
#pragma unroll
  for (int c = 0; c < W; ++c) row[c] = x[c];
  sc.acc[m * C + i] = acc;
}

// B: each chunk's start vector, less its max: the forward one (y) at interval
// begin_k (y_0 = log_pi_0 first), the backward one at end_k
// (beta_{T-1} = 0 first), each from the one before through its transfer:
//   x'(j) = lse_i(x(i) + acc(i) - max acc + rows[i](j)).
template <int W>
__global__ void __launch_bounds__(kThreads)
    starts_kernel(const float* __restrict__ log_pi, float* scratch, int S, int T, int C, int P) {
  const int g = (blockIdx.x * kThreads + threadIdx.x) / W;
  const int lane = threadIdx.x & (W - 1);
  if (g >= 2 * S) return;
  const int dir = g / S, s = g - dir * S;
  const bool on = lane < C;
  const Group<W> grp(threadIdx.x & 31);
  const Scratch sc(scratch, S, T, P, C, W);
  const size_t ds = static_cast<size_t>(dir) * S + s;
  const size_t base = static_cast<size_t>(s) * T * C;
  float x = on ? (dir == 0 ? log_pi[base + lane] : 0.0f) : -INFINITY;
  x -= finite_or_zero(grp.max(x));
  int k = dir == 0 ? 0 : P - 1;
  const int dk = dir == 0 ? 1 : -1;
  sc.starts[(ds * P + k) * W + lane] = x;
  // the transfer used at step q (rows: row i's entry of this lane's state;
  // acc: this lane's row scale), loaded kAhead steps ahead of its use
  constexpr int kAhead = W == 8 ? 4 : 2;
  float rbuf[kAhead][W], abuf[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    const int q = 1 + a;
    const size_t m = ds * P + (dir == 0 ? q - 1 : P - q);
#pragma unroll
    for (int i = 0; i < W; ++i)
      rbuf[a][i] = q < P && i < C ? sc.rows[(m * C + i) * W + lane] : -INFINITY;
    abuf[a] = q < P && on ? sc.acc[m * C + lane] : -INFINITY;
  }
  for (int q0 = 1; q0 < P; q0 += kAhead) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int q = q0 + a;
      if (q >= P) break;
      float rows[W];
#pragma unroll
      for (int i = 0; i < W; ++i) rows[i] = rbuf[a][i];
      const float acc = abuf[a];
      const int qn = q + kAhead;
      if (qn < P) {
        const size_t m = ds * P + (dir == 0 ? qn - 1 : P - qn);
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (i < C) rbuf[a][i] = sc.rows[(m * C + i) * W + lane];
        if (on) abuf[a] = sc.acc[m * C + lane];
      }
      const float xs = x + (acc - grp.max(acc));
      float terms[W], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        terms[i] = i < C ? grp.get(xs, i) + rows[i] : -INFINITY;
        mx = fmaxf(mx, terms[i]);
      }
      mx = finite_or_zero(mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < W; ++i) sum += fexp(terms[i] - mx);
      x = on ? flog(sum) + mx : -INFINITY;
      x -= finite_or_zero(grp.max(x));
      k += dk;
      sc.starts[(ds * P + k) * W + lane] = x;
    }
  }
}

// C: chunk k of sample s holds intervals begin_k .. end_k - 1 (the last
// chunk also T - 1). A block takes G = 32 / W chunks: in warp 0 each group
// runs a chunk's y (alpha less the emission) from its start, in warp 1 its
// beta, into shared memory; then every group of W threads normalises
// y + em + beta of one interval at a time.
template <int W>
__global__ void __launch_bounds__(kPostThreads)
    posterior_kernel(const float* __restrict__ log_em, const float* __restrict__ log_pi,
                     float* scratch, float* __restrict__ out, int S, int T, int C, int L, int P) {
  constexpr int G = 32 / W;
  extern __shared__ float sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Scratch sc(scratch, S, T, P, C, W);
  {
    const int gi = lane / W, lw = lane & (W - 1);
    const int idx = blockIdx.x * G + gi;
    if (idx < S * P) {
      const int s = idx / P, k = idx - s * P;
      const int begin = k * L, end = min(begin + L, T - 1);
      const bool last = k == P - 1;
      const size_t base = static_cast<size_t>(s) * T * C;
      float* alpha = sh + gi * 2 * (L + 1) * W;  // y
      float* beta = alpha + (L + 1) * W;
      const Group<W> grp(lane);
      float acc = 0.0f;
      if (warp == 0) {
        const float x = sc.starts[(static_cast<size_t>(s) * P + k) * W + lw];
        alpha[lw] = x;
        group_run<true, true, W>(grp, lw, C, x, log_em + base, log_pi + base, sc.log_stay,
                                 sc.log_move, begin + 1, end - begin - (last ? 0 : 1), acc,
                                 alpha + W, W);
      } else {
        const float x = sc.starts[((static_cast<size_t>(S) + s) * P + k) * W + lw];
        if (last) beta[(end - begin) * W + lw] = x;
        group_run<false, true, W>(grp, lw, C, x, log_em + base, log_pi + base, sc.log_stay,
                                  sc.log_move, end, end - begin, acc,
                                  beta + (end - begin - 1) * W, -W);
      }
    }
  }
  __syncthreads();
  const Group<W> grp(lane);
  const int lw = threadIdx.x & (W - 1);
  for (int gi = 0; gi < G; ++gi) {
    const int idx = blockIdx.x * G + gi;
    if (idx >= S * P) break;
    const int s = idx / P, k = idx - s * P;
    const int begin = k * L, end = min(begin + L, T - 1);
    const int nt = end - begin + (k == P - 1 ? 1 : 0);
    const float* alpha = sh + gi * 2 * (L + 1) * W;
    const float* beta = alpha + (L + 1) * W;
    const size_t at = (static_cast<size_t>(s) * T + begin) * C;
    for (int u = threadIdx.x / W; u < nt; u += kPostThreads / W) {
      const float e = lw < C ? log_em[at + u * C + lw] : 0.0f;
      const float z = lw < C ? alpha[u * W + lw] + beta[u * W + lw] : -INFINITY;
      const float l = grp.lse(z + e);
      if (lw < C) out[at + u * C + lw] = e + (z - l);
    }
  }
}

template <int W>
int launch(const float* em, const float* lp, const float* st, float* out, float* scratch, int S,
           int T, int C, int L, cudaStream_t stream, int* launched) {
  const int P = num_chunks(T, L);
  const Scratch sc(scratch, S, T, P, C, W);
  cudaError_t err;
  if (T > 1) {
    log_stay_kernel<<<(T - 1 + 255) / 256, 256, 0, stream>>>(st, sc.log_stay, sc.log_move, T - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (P > 1) {
    const long long threads = 2LL * S * (P - 1) * C;
    transfer_kernel<W><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(em, lp, scratch, S, T, C, L, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  starts_kernel<W><<<(2 * S * W + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      lp, scratch, S, T, C, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  const size_t shmem = static_cast<size_t>(2) * (L + 1) * 32 * sizeof(float);
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(posterior_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  posterior_kernel<W><<<static_cast<unsigned>((S * P + 32 / W - 1) / (32 / W)), kPostThreads, shmem,
                        stream>>>(
      em, lp, scratch, out, S, T, C, L, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}

// ---- more than 32 states: a warp (a Group<32>) holds a vector, lane l the
// states l, l + 32, ...

// group_step for a vector x over C states in memory, in place (em: the
// emission row, lp: interval p's row of log priors); the lane updates its own
// states only.
template <bool kFwd>
__device__ void wide_step(float* x, const float* __restrict__ em, const float* __restrict__ lp,
                          float ls, float lb, int C, int lane, float& acc) {
  const Group<32> grp(lane);
  float mu = -INFINITY, mv = -INFINITY;
  for (int c = lane; c < C; c += 32) {
    const float u = x[c] + em[c];
    x[c] = u;
    mu = fmaxf(mu, u);
    if (!kFwd) mv = fmaxf(mv, lp[c] + u);
  }
  mu = finite_or_zero(grp.max(mu));
  if (!kFwd) mv = finite_or_zero(grp.max(mv));
  float su = 0.0f, sv = 0.0f;
  for (int c = lane; c < C; c += 32) {
    su += fexp(x[c] - mu);
    if (!kFwd) sv += fexp(lp[c] + x[c] - mv);
  }
  const float n = finite_or_zero(flog(grp.sum(su)) + mu);
  const float w = kFwd ? 0.0f : flog(grp.sum(sv)) + mv - n;
  acc += n;
  for (int c = lane; c < C; c += 32)
    x[c] = logaddexp(ls + (x[c] - n), lb + (kFwd ? lp[c] : w));
}

// Scratch beyond Scratch's, floats: B's scaled vectors xs [2][S][CW], then
// C's rows [S][P][2][L + 1][CW].
struct WideScratch {
  float* xs;
  float* vals;
  __host__ __device__ WideScratch(float* base, int S, int T, int P, int C, int CW)
      : xs(base + scratch_floats(S, T, C, P, CW)),
        vals(xs + static_cast<size_t>(2) * S * CW) {}
};

__host__ __device__ inline long long wide_scratch_floats(int S, int T, int C, int P, int L) {
  const int CW = state_width(C);
  return scratch_floats(S, T, C, P, CW) + 2LL * S * CW + 2LL * S * P * (L + 1) * CW;
}

// A, a warp a row (the layout of transfer_kernel's rows, CW wide).
__global__ void __launch_bounds__(kThreads)
    transfer_wide_kernel(const float* __restrict__ log_em, const float* __restrict__ log_pi,
                         float* scratch, int S, int T, int C, int L, int P) {
  const long long g = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long per_dir = static_cast<long long>(S) * (P - 1) * C;
  if (g >= 2 * per_dir) return;
  const int dir = static_cast<int>(g / per_dir);
  long long r = g - dir * per_dir;
  const int i = static_cast<int>(r % C);
  r /= C;
  const int kk = static_cast<int>(r % (P - 1));
  const int s = static_cast<int>(r / (P - 1));
  const int k = dir == 0 ? kk : kk + 1;
  const int begin = k * L, end = min(begin + L, T - 1);
  const int CW = state_width(C);
  const Scratch sc(scratch, S, T, P, C, CW);
  const size_t base = static_cast<size_t>(s) * T * C;
  const float* em = log_em + base;
  const float* lp = log_pi + base;
  const size_t m = (static_cast<size_t>(dir) * S + s) * P + k;
  float* x = sc.rows + (m * C + i) * CW;
  for (int c = lane; c < C; c += 32) x[c] = c == i ? 0.0f : -INFINITY;
  float acc = 0.0f;
  if (dir == 0) {
    for (int p = begin + 1; p <= end; ++p)
      wide_step<true>(x, em + (p - 1) * C, lp + p * C, sc.log_stay[p - 1], sc.log_move[p - 1], C,
                      lane, acc);
  } else {
    for (int p = end; p > begin; --p)
      wide_step<false>(x, em + p * C, lp + p * C, sc.log_stay[p - 1], sc.log_move[p - 1], C, lane,
                       acc);
  }
  if (lane == 0) sc.acc[m * C + i] = acc;
}

// B, a warp a sample and direction: starts_kernel's scan, each lane taking
// the states j = lane, lane + 32, ... of the new vector, every lane reading
// the whole scaled vector xs.
__global__ void __launch_bounds__(kThreads)
    starts_wide_kernel(const float* __restrict__ log_pi, float* scratch, int S, int T, int C, int L,
                       int P) {
  const int g = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (g >= 2 * S) return;
  const int dir = g / S, s = g - dir * S;
  const int CW = state_width(C);
  const Scratch sc(scratch, S, T, P, C, CW);
  const WideScratch wc(scratch, S, T, P, C, CW);
  const size_t ds = static_cast<size_t>(dir) * S + s;
  const size_t base = static_cast<size_t>(s) * T * C;
  float* xs = wc.xs + ds * CW;
  const Group<32> grp(lane);
  int k = dir == 0 ? 0 : P - 1;
  const int dk = dir == 0 ? 1 : -1;
  float* x = sc.starts + (ds * P + k) * CW;
  float mx = -INFINITY;
  for (int c = lane; c < C; c += 32) {
    x[c] = dir == 0 ? log_pi[base + c] : 0.0f;
    mx = fmaxf(mx, x[c]);
  }
  mx = finite_or_zero(grp.max(mx));
  for (int c = lane; c < C; c += 32) x[c] -= mx;
  for (int q = 1; q < P; ++q) {
    const size_t m = ds * P + (dir == 0 ? q - 1 : P - q);
    const float* acc = sc.acc + m * C;
    const float* rows = sc.rows + m * C * CW;
    float am = -INFINITY;
    for (int c = lane; c < C; c += 32) am = fmaxf(am, acc[c]);
    am = grp.max(am);
    for (int c = lane; c < C; c += 32) xs[c] = x[c] + (acc[c] - am);
    __syncwarp();
    k += dk;
    x = sc.starts + (ds * P + k) * CW;
    float xm = -INFINITY;
    for (int j = lane; j < C; j += 32) {
      float tm = -INFINITY;
      for (int i = 0; i < C; ++i) tm = fmaxf(tm, xs[i] + rows[static_cast<size_t>(i) * CW + j]);
      tm = finite_or_zero(tm);
      float sum = 0.0f;
      for (int i = 0; i < C; ++i) sum += fexp(xs[i] + rows[static_cast<size_t>(i) * CW + j] - tm);
      x[j] = flog(sum) + tm;
      xm = fmaxf(xm, x[j]);
    }
    xm = finite_or_zero(grp.max(xm));
    for (int j = lane; j < C; j += 32) x[j] -= xm;
    __syncwarp();  // every lane has read xs before it is written again
  }
}

// C, a block of two warps a chunk: posterior_kernel's recursions into the
// chunk's rows of the scratch, then its normalisation, a warp an interval.
__global__ void __launch_bounds__(kPostThreads)
    posterior_wide_kernel(const float* __restrict__ log_em, const float* __restrict__ log_pi,
                          float* scratch, float* __restrict__ out, int S, int T, int C, int L,
                          int P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int idx = blockIdx.x;
  const int s = idx / P, k = idx - s * P;
  const int begin = k * L, end = min(begin + L, T - 1);
  const bool last = k == P - 1;
  const int CW = state_width(C);
  const Scratch sc(scratch, S, T, P, C, CW);
  const WideScratch wc(scratch, S, T, P, C, CW);
  const size_t base = static_cast<size_t>(s) * T * C;
  const float* em = log_em + base;
  const float* lp = log_pi + base;
  float* alpha = wc.vals + static_cast<size_t>(idx) * 2 * (L + 1) * CW;  // y
  const Group<32> grp(lane);
  float* beta = alpha + static_cast<size_t>(L + 1) * CW;
  float acc = 0.0f;
  if (warp == 0) {
    const float* x = sc.starts + (static_cast<size_t>(s) * P + k) * CW;
    for (int c = lane; c < C; c += 32) alpha[c] = x[c];
    const int n = end - begin - (last ? 0 : 1);
    for (int j = 0; j < n; ++j) {
      const int p = begin + 1 + j;
      float* y = alpha + static_cast<size_t>(j + 1) * CW;
      for (int c = lane; c < C; c += 32) y[c] = y[c - CW];
      wide_step<true>(y, em + (p - 1) * C, lp + p * C, sc.log_stay[p - 1], sc.log_move[p - 1], C,
                      lane, acc);
    }
  } else {
    const float* x = sc.starts + ((static_cast<size_t>(S) + s) * P + k) * CW;
    if (last) {
      float* b = beta + static_cast<size_t>(end - begin) * CW;
      for (int c = lane; c < C; c += 32) b[c] = x[c];
    }
    for (int j = 0; j < end - begin; ++j) {
      const int p = end - j;
      float* b = beta + static_cast<size_t>(end - begin - 1 - j) * CW;
      for (int c = lane; c < C; c += 32) b[c] = x[c];
      wide_step<false>(b, em + p * C, lp + p * C, sc.log_stay[p - 1], sc.log_move[p - 1], C, lane,
                       acc);
      x = b;
    }
  }
  __syncthreads();
  const int nt = end - begin + (last ? 1 : 0);
  const size_t at = (static_cast<size_t>(s) * T + begin) * C;
  for (int u = warp; u < nt; u += kPostThreads / 32) {
    const float* a = alpha + static_cast<size_t>(u) * CW;
    const float* b = beta + static_cast<size_t>(u) * CW;
    const float* e = log_em + at + static_cast<size_t>(u) * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, a[c] + b[c] + e[c]);
    m = finite_or_zero(grp.max(m));
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += fexp(a[c] + b[c] + e[c] - m);
    const float l = flog(grp.sum(sum)) + m;
    for (int c = lane; c < C; c += 32) out[at + static_cast<size_t>(u) * C + c] = e[c] + (a[c] + b[c] - l);
  }
}

int launch_wide(const float* em, const float* lp, const float* st, float* out, float* scratch,
                int S, int T, int C, int L, cudaStream_t stream, int* launched) {
  const int P = num_chunks(T, L);
  const Scratch sc(scratch, S, T, P, C, state_width(C));
  cudaError_t err;
  if (T > 1) {
    log_stay_kernel<<<(T - 1 + 255) / 256, 256, 0, stream>>>(st, sc.log_stay, sc.log_move, T - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  if (P > 1) {
    const long long threads = 2LL * S * (P - 1) * C * 32;
    transfer_wide_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(em, lp, scratch, S, T, C, L, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  starts_wide_kernel<<<(2 * S * 32 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      lp, scratch, S, T, C, L, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  posterior_wide_kernel<<<static_cast<unsigned>(S * P), kPostThreads, 0, stream>>>(
      em, lp, scratch, out, S, T, C, L, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch the pass needs (S, T, C as for cnv_hmm; L the chunk).
extern "C" long long cnv_hmm_scratch(int S, int T, int C, int L) {
  const int P = num_chunks(T, L);
  return C <= kGroupStates ? scratch_floats(S, T, C, P, state_width(C))
                           : wide_scratch_floats(S, T, C, P, L);
}

// Launches the pass's kernels on `stream` (log_stay when T > 1, transfer
// when T > L + 1, starts, posterior) and sets *launched to the number of them
// launched; returns the first cudaGetLastError() that is not 0, else 0.
// log_em, log_pi and out are (S, T, C) f32, contiguous; stay is (T - 1,) f32;
// scratch holds cnv_hmm_scratch(S, T, C, L) floats; L is the chunk's steps.
extern "C" int cnv_hmm(const void* log_em, const void* log_pi, const void* stay, void* out,
                       void* scratch, int S, int T, int C, int L, void* stream, int* launched) {
  *launched = 0;
  if (S <= 0 || T <= 0 || C <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* em = static_cast<const float*>(log_em);
  const auto* lp = static_cast<const float*>(log_pi);
  const auto* st = static_cast<const float*>(stay);
  auto* o = static_cast<float*>(out);
  auto* sc = static_cast<float*>(scratch);
  auto strm = static_cast<cudaStream_t>(stream);
  if (C <= 8) return launch<8>(em, lp, st, o, sc, S, T, C, L, strm, launched);
  if (C <= kGroupStates) return launch<32>(em, lp, st, o, sc, S, T, C, L, strm, launched);
  return launch_wide(em, lp, st, o, sc, S, T, C, L, strm, launched);
}
