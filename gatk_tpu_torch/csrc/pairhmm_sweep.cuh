// The PairHMM sweep shared by csrc/pairhmm_fwd.cu (pairs) and
// csrc/pairhmm_matrix.cu (every read x every haplotype of a region).
//
// GATK's logless 3-state forward recurrence (LoglessPairHMM.java:48-70) in f32,
// laid out for a lane group: G lanes of a warp (G = 4, 8, 16 or 32), lane l of
// the group owning kRows = 5 consecutive read rows, so a group covers 5G rows
// (20, 40, 80, 160) and a warp sweeps 32/G reads at once. A lane keeps its rows'
// transition/prior tables and M, X, Y state in registers. Lanes sweep
// haplotype columns skewed by one step per lane (at step t lane l computes
// column j = t - l), so the row above at columns j and j-1 comes from lane l-1
// by __shfl_up_sync of width G (a group's wavefront stays inside the group) and
// no DP state touches memory. Reads longer than 160 rows use G = 32 and run as
// several 160-row stripes; the bottom row of a stripe is handed to the next
// through two shared-memory row buffers.
//
// Rows are aligned to the bottom: a read of L rows in a group of nl lanes
// (5 nl >= L, or 160 x stripes for long reads) starts with pad = 5 nl - L
// boundary rows, so read row L is always the last row of lane nl - 1 and the
// final-row sum needs no per-row test. A boundary row has every coefficient 0
// but tdd = 1 and starts with Y = y0 at column 0, so it gives (M, X, Y) =
// (0, 0, y0) at every column: exactly GATK's row 0. The arithmetic of a real
// row, and the order of each pair's final-row sum (j = 1..H, one lane), are
// those of the one-warp-per-pair sweep this replaces.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace pairhmm {

constexpr int kWarp = 32;
constexpr int kRows = 5;                 // read rows per lane
constexpr int kStripe = kWarp * kRows;   // read rows per warp sweep
constexpr int kClasses = 4;              // group widths 4 << c, c = 0..3
constexpr int kMaxKeyLen = 4095;         // haplotype lengths the plan tells apart
constexpr int kEOff = 16;                // E_OFF of the packed haplotype layout
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory one block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegLn10Over10 = -0.23025850929940458f;
constexpr float kInit = 1267650600228229401496703205376.0f;  // 2^100
constexpr float kInitLn = 69.31471805599453f;                // 100 ln 2
constexpr float kInvLn10 = 0.4342944819032518f;
constexpr float kNegInf = -1e30f;
constexpr int kN = 'N';
constexpr int kTables = 9;  // tmm, tim, tmi, tii, tmd, tdd, peq, pne, read base

// The read pools of ops/pairhmm.py: (rp, NR) uint8 tables, read base k in row k+1.
struct ReadPools {
  const uint8_t *rbase, *rq, *iq, *dq, *gcp;
  int nr;
};

// ---------------------------------------------------------------- the plan
//
// Items (pairs, or the reads of a region) ordered by group class (group width
// 4 << c lanes, the narrowest whose 5 (4 << c) rows hold the read; reads over
// 160 rows take the 32-lane class), then by haplotype length (pairs), then by
// lanes used: the order of ops/_kernels.plan_groups, its plain version, up to
// the order of items with equal keys. A counting sort in three small kernels
// (plan_count, plan_scan, plan_scatter) that the launchers run before the
// sweep, so that building it costs the host three launches and no torch ops.
//
// Scratch (int32, laid out by ops/_kernels.plan_scratch): perm [n], key [n],
// seg [kClasses + 1], the task counter, 2 spare, count [kClasses (kmax + 1) 32].
struct Plan {
  const int32_t* perm;  // plan position p stands for item perm[p]
  const int32_t* seg;   // class c holds plan positions seg[c] .. seg[c+1] - 1
  int32_t* next_task;   // tasks taken so far (zeroed before the sweep)
};

struct PlanScratch {
  int32_t *perm, *key, *seg, *count;
  int nbins;
};

inline PlanScratch plan_scratch(void* scratch, int n, int kmax) {
  int32_t* s = static_cast<int32_t*>(scratch);
  return PlanScratch{s, s + n, s + 2 * (size_t)n, s + 2 * (size_t)n + 8,
                     kClasses * (kmax + 1) * kWarp};
}

// Group class and lanes used of a read of L rows.
__device__ __forceinline__ int read_class(int L) {
  return (L > 4 * kRows) + (L > 8 * kRows) + (L > 16 * kRows);
}
__device__ __forceinline__ int read_lanes(int L) {
  return min(max((L + kRows - 1) / kRows, 1), kWarp);
}

// Key of item p: (class, sub, lanes). Pairs (ri != nullptr): sub is the
// haplotype's length, out-of-range indices count as length 0 (the sweep writes
// NaN for them). Reads: sub is 0.
__global__ void plan_count(const int32_t* ri, const int32_t* hi, const int32_t* rlen,
                           const int32_t* hlen, int n, int nr, int nh, int kmax,
                           PlanScratch ps) {
  for (int p0 = blockIdx.x * blockDim.x; p0 < n; p0 += gridDim.x * blockDim.x) {
    const int p = p0 + threadIdx.x;
    int key = -1;
    if (p < n) {
      int L = 0, sub = 0;
      if (ri == nullptr) {
        L = rlen[p];
      } else {
        const int r = ri[p], h = hi[p];
        if (r >= 0 && r < nr && h >= 0 && h < nh) {
          L = rlen[r];
          sub = min(max(hlen[h], 0), kmax);
        }
      }
      key = (read_class(L) * (kmax + 1) + sub) * kWarp + read_lanes(L) - 1;
      ps.key[p] = key;
    }
    // one atomic per distinct key of the warp
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && (threadIdx.x % kWarp) == __ffs(peers) - 1)
      atomicAdd(ps.count + key, __popc(peers));
  }
}

// One block of 1024 threads: count -> exclusive offsets in place, and the
// class segments. Thread t takes a run of bins; runs are scanned by warp
// shuffles.
__global__ void plan_scan(int n, int kmax, PlanScratch ps) {
  __shared__ int warp_sum[kWarp];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int per = (ps.nbins + blockDim.x - 1) / blockDim.x;
  const int b0 = min(ps.nbins, (int)threadIdx.x * per), b1 = min(ps.nbins, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += ps.count[b];
  int incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == kWarp - 1) warp_sum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int v = lane < (int)blockDim.x / kWarp ? warp_sum[lane] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += u;
    }
    warp_sum[lane] = x - v;  // exclusive
  }
  __syncthreads();
  int run = warp_sum[w] + incl - sum;
  for (int b = b0; b < b1; ++b) {
    const int v = ps.count[b];
    ps.count[b] = run;
    run += v;
  }
  __syncthreads();
  const int per_class = (kmax + 1) * kWarp;
  if (threadIdx.x < kClasses) ps.seg[threadIdx.x] = ps.count[threadIdx.x * per_class];
  if (threadIdx.x == kClasses) ps.seg[kClasses] = n;
}

__global__ void plan_scatter(int n, PlanScratch ps) {
  for (int p0 = blockIdx.x * blockDim.x; p0 < n; p0 += gridDim.x * blockDim.x) {
    const int p = p0 + threadIdx.x;
    const int key = p < n ? ps.key[p] : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int lane = threadIdx.x % kWarp;
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (key >= 0 && lane == leader) base = atomicAdd(ps.count + key, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    if (key >= 0) ps.perm[base + __popc(peers & ((1u << lane) - 1))] = p;
  }
}

// Runs the plan of n items on `stream`; returns the Plan the sweep reads.
inline cudaError_t launch_plan(const int32_t* ri, const int32_t* hi, const int32_t* rlen,
                               const int32_t* hlen, int n, int nr, int nh, int kmax,
                               void* scratch, cudaStream_t stream, Plan& plan) {
  const PlanScratch ps = plan_scratch(scratch, n, kmax);
  cudaError_t err = cudaMemsetAsync(ps.seg, 0, (8 + (size_t)ps.nbins) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const unsigned blocks = (unsigned)std::min(1024, std::max(1, (n + threads - 1) / threads));
  plan_count<<<blocks, threads, 0, stream>>>(ri, hi, rlen, hlen, n, nr, nh, kmax, ps);
  plan_scan<<<1, 1024, 0, stream>>>(n, kmax, ps);
  plan_scatter<<<blocks, threads, 0, stream>>>(n, ps);
  plan = Plan{ps.perm, ps.seg, ps.seg + kClasses + 1};
  return cudaGetLastError();
}

// Warp tasks: a task of class c takes 8 >> c consecutive plan positions (one
// per group). base[c] .. base[c+1] - 1 are class c's tasks; returns their total.
__device__ __forceinline__ int warp_tasks(const Plan& plan, int (&base)[kClasses + 1]) {
  base[0] = 0;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    const int items = plan.seg[c + 1] - plan.seg[c];
    base[c + 1] = base[c] + ((items + (8 >> c) - 1) >> (3 - c));
  }
  return base[kClasses];
}

// The class of warp task q, and its first plan position.
__device__ __forceinline__ int task_class(const Plan& plan, const int (&base)[kClasses + 1], int q,
                                          int& first) {
  int c = 0, b = 0;  // unrolled, so base stays in registers
#pragma unroll
  for (int k = 1; k < kClasses; ++k) {
    if (q >= base[k]) {
      c = k;
      b = base[k];
    }
  }
  first = plan.seg[c] + ((q - b) << (3 - c));
  return c;
}

// The next task of this warp, largest first (the plan orders tasks by class
// and length, so the last are the longest): one atomic per task, taken by
// lane 0. Returns -1 when none is left.
__device__ __forceinline__ long long next_task(const Plan& plan, long long tasks, int lane) {
  long long q = 0;
  if (lane == 0) q = atomicAdd(reinterpret_cast<unsigned*>(plan.next_task), 1u);
  q = __shfl_sync(kFull, q, 0);
  return q < tasks ? tasks - 1 - q : -1;
}

// One lane's rows of one stripe: transition and prior tables and read bases.
struct Tables {
  float tmm[kRows], tim[kRows], tmi[kRows], tii[kRows], tmd[kRows], tdd[kRows];
  float peq[kRows], pne[kRows];
  int rb[kRows];
};

// Rows i0 .. i0 + kRows - 1 of read r (length L): read rows for 1 <= i <= L,
// boundary rows (see above) for i <= 0, zero rows below the read (never feed a
// row <= L). A read N scores as a match (pne = peq).
__device__ __forceinline__ void build_tables(Tables& T, const ReadPools& p, int r, int i0,
                                             int L) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = i0 + k;
    if (i >= 1 && i <= L) {
      const size_t idx = (size_t)i * p.nr + r;
      const float e_ins = expf((float)p.iq[idx] * kNegLn10Over10);
      const float e_del = expf((float)p.dq[idx] * kNegLn10Over10);
      const float e_gcp = expf((float)p.gcp[idx] * kNegLn10Over10);
      const float e_base = expf((float)p.rq[idx] * kNegLn10Over10);
      T.tmm[k] = 1.f - fminf(1.f, e_ins + e_del);
      T.tim[k] = 1.f - e_gcp;
      T.tmi[k] = e_ins;
      T.tii[k] = e_gcp;
      T.tmd[k] = e_del;
      T.tdd[k] = e_gcp;
      T.peq[k] = 1.f - e_base;
      T.rb[k] = p.rbase[idx];
      T.pne[k] = T.rb[k] == kN ? T.peq[k] : e_base * (1.0f / 3.0f);
    } else {
      T.tmm[k] = T.tim[k] = T.tmi[k] = T.tii[k] = T.tmd[k] = 0.f;
      T.tdd[k] = i <= 0 ? 1.f : 0.f;
      T.peq[k] = T.pne[k] = 0.f;
      T.rb[k] = -1;
    }
  }
}

// Shared-memory copy of a lane's tables: [kTables][kStripe] floats per stripe,
// the lane's rows at lane * kRows (stride 5 floats across lanes: no bank conflicts).
__device__ __forceinline__ void store_tables(const Tables& T, float* st, int lane) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int o = lane * kRows + k;
    st[0 * kStripe + o] = T.tmm[k];
    st[1 * kStripe + o] = T.tim[k];
    st[2 * kStripe + o] = T.tmi[k];
    st[3 * kStripe + o] = T.tii[k];
    st[4 * kStripe + o] = T.tmd[k];
    st[5 * kStripe + o] = T.tdd[k];
    st[6 * kStripe + o] = T.peq[k];
    st[7 * kStripe + o] = T.pne[k];
    st[8 * kStripe + o] = __int_as_float(T.rb[k]);
  }
}

__device__ __forceinline__ void load_tables(Tables& T, const float* st, int lane) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int o = lane * kRows + k;
    T.tmm[k] = st[0 * kStripe + o];
    T.tim[k] = st[1 * kStripe + o];
    T.tmi[k] = st[2 * kStripe + o];
    T.tii[k] = st[3 * kStripe + o];
    T.tmd[k] = st[4 * kStripe + o];
    T.tdd[k] = st[5 * kStripe + o];
    T.peq[k] = st[6 * kStripe + o];
    T.pne[k] = st[7 * kStripe + o];
    T.rb[k] = __float_as_int(st[8 * kStripe + o]);
  }
}

// One stripe of one group's (read, haplotype) pair; every lane of the warp
// calls it with the same `steps` (the warp's longest group, H + nl - 1) and
// `h_min` (the shortest haplotype a group of the warp sweeps). A group that
// does not sweep has zero tables, which keep its state at 0, and a `hap` it
// may read up to h_min bases of.
// hap: the haplotype in device memory, reversed (base k at hap[-k]); a
// group's lanes read neighbouring bytes, so after the first lane the reads
// hit L1. gl: the lane within its group.
// first: the stripe that holds row 1, whose top `pad` rows are boundary rows;
// later stripes take the row above from rd ([3][H1] floats: M, X, Y of the
// previous stripe's bottom row), and write_bnd lanes write their bottom row to
// wr for the next. Adds this lane's bottom row's M + X over j = 1..H to acc;
// only the lane that holds read row L keeps a sum the caller uses.
//
// kHapNMismatch: false scores an N on either side as a match (the host f64
// rule, pairhmm_model.py:82); true scores a haplotype N as a mismatch unless
// the read base is N too (gatk_tpu's kernels v2, v4-v7, whose tables force
// only a read N to match).
template <int G, bool kHapNMismatch>
__device__ __forceinline__ void sweep_stripe(float& acc, const Tables& T,
                                             const uint8_t* hap, int H, int H1, float y0,
                                             int steps, int h_min, int gl, bool first, int pad,
                                             const float* rd, float* wr, bool write_bnd) {
  // rows of this lane above which (and including which) the boundary reaches
  const int rel = first ? pad - gl * kRows : -1;
  float M[kRows], X[kRows], Y[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {  // column 0
    M[k] = X[k] = 0.f;
    Y[k] = k < rel ? y0 : 0.f;
  }
  // the row above this lane's rows at column j-1 (starts at column 0)
  float upM = 0.f, upX = 0.f, upY = rel >= 0 ? y0 : 0.f;
  float pubM = 0.f, pubX = 0.f, pubY = 0.f;  // this lane's bottom row, its last column

  // step t: this lane computes column j = t - gl, if live
  auto step = [&](int t, bool live) {
    const int j = t - gl;
    const int hb = live ? __ldg(hap + 1 - j) : 0;  // issued before the shuffles
    // the row above at column j: lane gl-1's bottom row, computed last step
    float inM = __shfl_up_sync(kFull, pubM, 1, G);
    float inX = __shfl_up_sync(kFull, pubX, 1, G);
    float inY = __shfl_up_sync(kFull, pubY, 1, G);
    if (gl == 0) {
      if (first) {
        inM = 0.f; inX = 0.f; inY = y0;
      } else if (j <= H) {
        inM = rd[j]; inX = rd[H1 + j]; inY = rd[2 * H1 + j];
      }
    }
    if (live) {
      const bool hN = !kHapNMismatch && hb == kN;
      float dM = upM, dX = upX, dY = upY;  // row above, column j-1
      float aM = inM, aX = inX;            // row above, column j
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float prior = (T.rb[k] == hb || hN) ? T.peq[k] : T.pne[k];
        const float m_new = prior * (T.tmm[k] * dM + T.tim[k] * (dX + dY));
        const float x_new = T.tmi[k] * aM + T.tii[k] * aX;
        const float y_new = T.tmd[k] * M[k] + T.tdd[k] * Y[k];
        dM = M[k]; dX = X[k]; dY = Y[k];
        aM = m_new; aX = x_new;
        M[k] = m_new; X[k] = x_new; Y[k] = y_new;
      }
      acc += M[kRows - 1] + X[kRows - 1];
      upM = inM; upX = inX; upY = inY;
      pubM = M[kRows - 1]; pubX = X[kRows - 1]; pubY = Y[kRows - 1];
      if (write_bnd) {
        wr[j] = pubM; wr[H1 + j] = pubX; wr[2 * H1 + j] = pubY;
      }
    }
  };
  // Fill (not every lane of a group has started), steady (every lane of every
  // group is inside its haplotype: no guard), drain.
  const int fill_end = min(G - 1, steps), steady_end = min(h_min, steps);
  int t = 1;
  for (; t <= fill_end; ++t) step(t, t - gl >= 1 && t - gl <= H);
#pragma unroll 2
  for (; t <= steady_end; ++t) step(t, true);
  for (; t <= steps; ++t) step(t, t - gl >= 1 && t - gl <= H);
}

// log10 of the final-row sum, or NEG_INF where it is zero.
__device__ __forceinline__ float finish(float acc) {
  return acc > 0.f ? (logf(fmaxf(acc, 1e-44f)) - kInitLn) * kInvLn10 : kNegInf;
}

// Blocks of `threads` threads that fill the card once (at most `cap`): the
// kernels loop over their warp tasks inside this grid.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, long long cap,
                                   unsigned& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  long long b = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (b > cap) b = cap;
  blocks = static_cast<unsigned>(b > 0 ? b : 1);
  return cudaSuccess;
}

}  // namespace pairhmm

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
