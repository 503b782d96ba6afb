// Flow-space PairHMM for NVIDIA Hopper (sm_90a), dense route: gatk_tpu's
// dense scan as the sum of its live coset lattices, one warp a (pair,
// lattice) task, its prior gathered from the packed tables inside the kernel.
//
// Computes what gatk_tpu's dense scan computes
// (gatk_tpu/ops/flow_pairhmm.py:flow_pairhmm_batch_jax, :116-194, under
// lax.scan; not a Pallas kernel), whose plain version is
// ops/flow_pairhmm.flow_pairhmm_dense_plain: for each pair the float32 log10
// likelihood of the read's flow keys given the haplotype's by
//   m_k[c] = prior_k[c] * (m_{k-1}[c-1] * MM + (i_{k-1}[c-1] + d_{k-1}[c-1]) * IM)
//   i_k[c] = m_{k-4}[c] * MI + i_{k-4}[c] * II
//   d_k[c] = m_k[c-4] * MD + d_k[c-4] * DD
// over read flows k and DP columns c, from m = i = 0 and d_{-1} = 1 / max(hlen,
// 1); prior_k[c] = P(true hmer = hkey[c - 5] | flow k), the read's table row
// at the haplotype's key, where read flow k and haplotype flow c - 5 < hlen
// read one base, else 0; the result is log10 of row kf = clip(rlen - 1, 0,
// Rp - 1)'s M + I sum, -inf where it is 0. The entry
// (ops/flow_pairhmm.flow_pairhmm_pairs) launches it on the pairs whose read or
// haplotype breaks the coset rule of csrc/flow_pairhmm.cu (an order such as
// TGCATGAC), and on every pair of a call whose haplotype width is past the
// coset kernel's shared memory (about 21,000 flows).
//
// The lattices. The recurrence never crosses (c - k) mod 4: M pulls
// (k - 1, c - 1), I (k - 4, c), D (k, c - 4), row 0's M the initial D at
// (-1, c - 1). So the dense scan is the sum of four independent lattices of
// the shape csrc/flow_pairhmm.cu walks, cell g of row k at column 4 g + r_k,
// r_k = (5 + k + s) mod 4, g < G = ceil((hlen + 5) / 4); they share only the
// row scale, which cancels, and the final sum. A lattice is nonzero only where
// row 0 seeds it: residue s of a haplotype flow f < hlen that reads the read's
// first flow base with a nonzero table value, over all of the haplotype's
// flows (in TGCATGAC, C reads at flows 2 and 7). All other lattices are
// exactly 0. A pair has 1 or 2 live lattices in the orders tested, not 4; for
// a pair that keeps the coset rule its one live lattice is the coset kernel's.
// ops/flow_pairhmm.flow_pairhmm_live_plain is the plain version of this
// decomposition, flow_pairhmm_lattice_plain of one task.
//
// Inputs are those of csrc/flow_pairhmm.cu (ops/flow_pairhmm.pack_flow_tables):
// tables (NR, Rp, T1) f32; rfo (NR, Rp) u8; trans (NR, Rp, 6) f32; rlen (NR,)
// i32; hkey (NH, Hp) i32; hfo (NH, Hp) u8; hlen (NH,) i32; the pairs ri, hi
// (B,) i32. Output (B,) f32, NaN for a pair whose indices or lengths are out
// of range.
//
// What bounds it: 13 FP32 operations a live cell (M 5, I 3, D 3, the row
// maximum of M and I 2), and the inputs are small, so the bound is the
// operations; but each row depends on the one before, so the time is the
// latency of a task's rows. There are no tensor-core instructions.
//
// Design. Four kernels a launch, no torch ops:
//   1. live_count, a warp a pair: the pair's live residues (a 4-bit mask),
//      its four lattice results set to -inf; a flag for a pair out of range;
//   2. live_tasks, one block: an exclusive scan of the masks' bit counts, and
//      the (pair, s) tasks written in pair order;
//   3. lattice_kernel, a warp a task (a grid-stride loop over the tasks), no
//      block barrier. Lane l owns the contiguous cells [l n, l n + n) of every
//      row, n = ceil(G / 32) of its own pair. A row: M and I of each cell from
//      the lane's history (the M pull of the lane's first cell by a shuffle
//      where r_k = 0), the prior gated by comparing the read's flow base at k
//      with the haplotype's at the cell's flow (the coset rule no longer
//      guarantees it), read from the warp's copy of the table row, which
//      cp.async brought with the row's six transitions during the row
//      before; D by per-lane segments, each lane running its cells' chain
//      from 0 and one 5-step warp scan of the segments' affine maps
//      (dd^n, d) joining them; the row's scale c = max(M, I) of the task (1
//      where c <= 0) by shuffles beside the scan. No carried value is
//      rescaled: the next row folds 1 / c into its transitions, the pull of
//      row k - 1 by its 1 / c and that of row k - 4 by the product of the
//      last four. A lane loads its cells' keys and flow bases once a task:
//      cell g holds those of flows 4 g - 5 .. 4 g - 2, one for each residue
//      a row can have, ordered by the row mod 4 that reads it, two 16-bit
//      keys a word and four bases in a third; a key past the haplotype's
//      flows or not below T1 points at a 0 after the table row;
//   4. combine_lattices, a thread a pair: out = A + log10 sum_s 10^(out_s - A),
//      A = max_s out_s; -inf where no lattice is live, NaN where flagged.
// The carried state, 4 rows of M and I, one of D, and the keys and bases, 12
// words a cell, lives by the width Hp of the launch's tables
// (flow_pairhmm_dense_route): in registers up to kRegCells cells a lane
// (Hp <= 891), the most that ptxas holds without spill in the 168 registers
// of 3 blocks an SM; in the warp's slice of shared memory while it
// fits; past 232,448 bytes a warp, in device scratch that the wrapper
// allocates, one warp a block on a grid of `slots` warps (4 an SM): each row
// reads and writes a task's whole state, and the row's latency, not the
// bytes, bounds this route.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;        // tasks a block, at most
constexpr int kRegCells = 7;     // cells a lane in registers, at most
constexpr int kCellWords = 12;   // carried words a cell: M 4, I 4, D 1, keys 2, bases 1
constexpr int kMaxSmem = 232448; // bytes of shared memory a block may use
constexpr int kCountWarps = 8;   // pairs a block of live_count
constexpr int kScanThreads = 1024;
constexpr int kDead = 16;        // plan flag: the pair's indices or lengths are out of range
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyMask = 0xffffu;  // a key is 16 bits
constexpr int kTrans = 6;
constexpr int kRowTail = 1 + kTrans;  // after a table row: a 0, then the transitions
// ops/pairhmm_model.py's transition columns
constexpr int kMM = 0, kIM = 1, kMI = 2, kII = 3, kMD = 4, kDD = 5;
enum Route { kRegisters = 0, kShared = 1, kDevice = 2 };

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The carried state in registers: N cells a lane.
template <int N>
struct RegState {
  float m[4][N], i[4][N], d[N];
  unsigned key[2][N];  // the keys of rows 0, 1 (word 0) and 2, 3 (word 1) mod 4
  unsigned base[N];    // the flow bases of rows 0-3 mod 4, byte t of row t
  __device__ static constexpr int cells() { return N; }
  __device__ float& M(int s, int c) { return m[s][c]; }
  __device__ float& I(int s, int c) { return i[s][c]; }
  __device__ float& D(int c) { return d[c]; }
  __device__ unsigned& K(int w, int c) { return key[w][c]; }
  __device__ unsigned& Bases(int c) { return base[c]; }
};

// The carried state in the warp's slice of shared memory or of device
// scratch: n cells a lane, cell c of lane l at [c * 32 + l] of each of 9 float
// rows (M 0-3, I 0-3, D) and 3 word rows (keys 0-1, bases).
struct MemState {
  float* f;     // this lane's first float
  unsigned* k;  // this lane's first key word
  int n;
  __device__ int cells() const { return n; }
  __device__ float& M(int s, int c) const { return f[(s * n + c) * 32]; }
  __device__ float& I(int s, int c) const { return f[((4 + s) * n + c) * 32]; }
  __device__ float& D(int c) const { return f[(8 * n + c) * 32]; }
  __device__ unsigned& K(int w, int c) const { return k[(w * n + c) * 32]; }
  __device__ unsigned& Bases(int c) const { return k[(2 * n + c) * 32]; }
};

struct Task {
  const float* tab;          // the read's table rows, T1 floats each
  const float* trans;        // the read's transition rows, 6 floats each
  const unsigned char* rf;   // the read's flow bases
  float* buf;                // the warp's two row buffers of RB = T1 + kRowTail floats
  int T1, RB, kf, nv, lane, s;  // nv: this lane's cells below G
  unsigned rbase;            // the read's flow base at the row being computed
  float inv[4];              // 1 / c of the last four rows, row j at j & 3
  float acc;                 // log10 of the scale so far
};

// Row k's table and transitions into buffer k & 1, by cp.async.
__device__ __forceinline__ void fetch_row(const Task& p, int k) {
  float* dst = p.buf + (k & 1) * p.RB;
  const float* tr = p.tab + static_cast<size_t>(k) * p.T1;
  const float* tt = p.trans + static_cast<size_t>(k) * kTrans;
  for (int e = p.lane; e < p.T1 + kTrans; e += 32) {
    const float* src = e < p.T1 ? tr + e : tt + (e - p.T1);
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + e + (e >= p.T1)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(__cvta_generic_to_global(src))
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fetch_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Row k, k & 3 == T (the ring slot of rows k and k - 4). True after row kf,
// whose result it has written.
template <int T, class S>
__device__ __forceinline__ bool row_step(S& st, Task& p, int k, float* out) {
  constexpr int cur = T, prev = (T + 3) & 3;
  unsigned next_base = 0;
  if (k < p.kf) {
    fetch_row(p, k + 1);
    next_base = p.rf[k + 1];
  }
  const float* row = p.buf + (k & 1) * p.RB;
  const float* t = row + p.T1 + 1;
  // the transitions with the scales of the rows they pull folded in
  const float q_scale = p.inv[prev];
  const float i_scale = p.inv[0] * p.inv[1] * p.inv[2] * p.inv[3];
  const float mm = t[kMM] * q_scale, im = t[kIM] * q_scale;
  const float mi = t[kMI] * i_scale, ii = t[kII] * i_scale;
  const float md = t[kMD], dd = t[kDD];
  const int n = st.cells();

  // 1. M and I; M pulls cell g of row k - 1, or g - 1 where the row's
  //    cells are the columns 4 g; the prior where the flow bases agree
  const bool shift = ((1 + T + p.s) & 3) == 0;
  float q_left = __shfl_up_sync(
      kFull, st.M(prev, n - 1) * mm + (st.I(prev, n - 1) + st.D(n - 1)) * im, 1);
  if (p.lane == 0) q_left = 0.0f;
  float mx = 0.0f;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const float q = st.M(prev, c) * mm + (st.I(prev, c) + st.D(c)) * im;
    unsigned w = st.K(T >> 1, c), bases = st.Bases(c);
    // unpacked anew each row: hoisted out of the row loop, the keys and bases
    // of the four residues would take 8 registers more a cell
    asm volatile("" : "+r"(w), "+r"(bases));
    const bool same = ((bases >> (8 * T)) & 0xffu) == p.rbase;
    const float pr = same ? row[(T & 1) ? w >> 16 : w & kKeyMask] : 0.0f;
    const float m_new = pr * (shift ? q_left : q);
    q_left = q;
    const float i_new = st.M(cur, c) * mi + st.I(cur, c) * ii;
    st.M(cur, c) = m_new;
    st.I(cur, c) = i_new;
    mx = fmaxf(mx, fmaxf(m_new, i_new));
  }
  mx = warp_max(mx);  // the row's scale, beside the D scan

  // 2. D: d[g] = m[g - 1] md + dd d[g - 1] from d[0] = 0; the lane's segment
  //    from 0, then the segments joined by a scan of their affine maps
  float a = __shfl_up_sync(kFull, st.M(cur, n - 1), 1);
  if (p.lane == 0) a = 0.0f;
  float loc = 0.0f;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    loc = a * md + dd * loc;
    a = st.M(cur, c);
    st.D(c) = loc;
  }
  float A = dd;  // dd^n
#pragma unroll
  for (int c = 1; c < n; ++c) A *= dd;
  float x = loc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (p.lane >= o) x += A * y;
    A *= A;
  }
  float carry = __shfl_up_sync(kFull, x, 1);  // d of the lane before's last cell
  if (p.lane == 0) carry = 0.0f;
  float pw = dd;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const float dv = c < p.nv ? st.D(c) + pw * carry : 0.0f;
    pw *= dd;
    st.D(c) = dv;
  }

  // 3. at kf the row's sum; else the next row folds in 1 / c
  if (k == p.kf) {
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < n; ++c) sum += st.M(cur, c) + st.I(cur, c);
    sum = warp_sum(sum);
    if (p.lane == 0) *out = sum > 0.0f ? log10f(fmaxf(sum, 1e-38f)) + p.acc : -INFINITY;
    return true;
  }
  const float c_row = mx > 0.0f ? mx : 1.0f;
  p.inv[cur] = __frcp_rn(c_row);
  p.acc += log10f(c_row);
  p.rbase = next_base;
  fetch_wait();
  return false;
}

template <class S>
__device__ __forceinline__ void run_task(S& st, Task& p, const int* hk, const unsigned char* hf,
                                         int H, float* out) {
  const int n = st.cells();
  const float init = 1.0f / fmaxf(static_cast<float>(H), 1.0f);
  const unsigned zero = static_cast<unsigned>(p.T1);  // the 0 after the table row
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const int j0 = 4 * (p.lane * n + c) - 5;  // the haplotype flow of column 4 g
    unsigned key[4], bases = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // row t mod 4 reads column 4 g + ((1 + t + s) & 3)
      const int j = j0 + ((1 + t + p.s) & 3);
      const bool in = j >= 0 && j < H;
      key[t] = in ? min(static_cast<unsigned>(hk[j]), zero) : zero;
      bases |= static_cast<unsigned>(in ? hf[j] : 0) << (8 * t);
    }
    st.K(0, c) = key[0] | key[1] << 16;
    st.K(1, c) = key[2] | key[3] << 16;
    st.Bases(c) = bases;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      st.M(s, c) = 0.0f;
      st.I(s, c) = 0.0f;
    }
    st.D(c) = init;
  }
  if (p.lane == 0) p.buf[p.T1] = p.buf[p.RB + p.T1] = 0.0f;
  fetch_row(p, 0);
  fetch_wait();
  for (int k = 0;; k += 4) {
    if (row_step<0>(st, p, k, out)) return;
    if (row_step<1>(st, p, k + 1, out)) return;
    if (row_step<2>(st, p, k + 2, out)) return;
    if (row_step<3>(st, p, k + 3, out)) return;
  }
}

// The task in registers, with the least N >= n of N..NMAX.
template <int N, int NMAX>
__device__ __forceinline__ void run_in_registers(Task& p, int n, const int* hk,
                                                 const unsigned char* hf, int H, float* out) {
  if constexpr (N < NMAX) {
    if (n > N) {
      run_in_registers<N + 1, NMAX>(p, n, hk, hf, H, out);
      return;
    }
  }
  RegState<N> st;
  run_task(st, p, hk, hf, H, out);
}

// 1. A warp a pair: bits 0-3 of live[b] the residues s of the haplotype flows
//    f < hlen that read the read's first flow base with a nonzero table value
//    (row 0 seeds those lattices), kDead where the pair is out of range; its
//    four lattice results -inf.
__global__ void __launch_bounds__(kCountWarps * 32)
live_count(const float* __restrict__ tables, const unsigned char* __restrict__ rfo,
           const int* __restrict__ rlen, const int* __restrict__ hkey,
           const unsigned char* __restrict__ hfo, const int* __restrict__ hlen,
           const int* __restrict__ ri_, const int* __restrict__ hi_, int* __restrict__ live,
           float* __restrict__ res, int B, int NR, int Rp, int T1, int NH, int Hp) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kCountWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  if (lane < 4) res[4 * b + lane] = -INFINITY;
  const int ri = ri_[b], hi = hi_[b];
  const bool idx_ok = ri >= 0 && ri < NR && hi >= 0 && hi < NH;
  const int R = idx_ok ? rlen[ri] : -1, H = idx_ok ? hlen[hi] : -1;
  if (!idx_ok || R < 0 || R > Rp || H < 0 || H > Hp) {
    if (lane == 0) live[b] = kDead;
    return;
  }
  const float* row0 = tables + static_cast<size_t>(ri) * Rp * T1;
  const unsigned char first = rfo[static_cast<size_t>(ri) * Rp];
  const int* hk = hkey + static_cast<size_t>(hi) * Hp;
  const unsigned char* hf = hfo + static_cast<size_t>(hi) * Hp;
  unsigned bits = 0;
  for (int f = lane; f < H; f += 32) {
    if (hf[f] != first) continue;
    const unsigned key = static_cast<unsigned>(hk[f]);
    if (key < static_cast<unsigned>(T1) && row0[key] > 0.0f) bits |= 1u << (f & 3);
  }
  bits = __reduce_or_sync(kFull, bits);
  if (lane == 0) live[b] = static_cast<int>(bits);
}

// 2. One block: the tasks b * 4 + s of the live residues, in pair order, by an
//    exclusive scan of the masks' bit counts over contiguous chunks of pairs;
//    *ntasks their number.
__global__ void __launch_bounds__(kScanThreads)
live_tasks(const int* __restrict__ live, int* __restrict__ tasks, int* __restrict__ ntasks, int B) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per = (B + blockDim.x - 1) / blockDim.x;
  const int b0 = min(B, static_cast<int>(threadIdx.x) * per), b1 = min(B, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += __popc(live[b] & 15);
  int incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int v = lane < static_cast<int>(blockDim.x) / 32 ? warp_sum[lane] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += u;
    }
    warp_sum[lane] = x - v;  // exclusive
  }
  __syncthreads();
  int run = warp_sum[w] + incl - sum;
  for (int b = b0; b < b1; ++b) {
    const int m = live[b] & 15;
    for (int s = 0; s < 4; ++s)
      if ((m >> s) & 1) tasks[run++] = 4 * b + s;
  }
  if (threadIdx.x == blockDim.x - 1) *ntasks = run;
}

// 3. A warp a task (pair b = task / 4, lattice s = task % 4), over the tasks
//    by a grid-stride loop; its result into res[task]. kRoute kRegisters keeps
//    the state in registers (at most kRegCells cells a lane), kShared in the
//    warp's slice of shared memory, kDevice in the warp's slice of `state`,
//    nmem cells a lane in either.
template <int kRoute>
__global__ void __launch_bounds__(kWarps * 32, kRoute == kRegisters ? 3 : 1)
lattice_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ rfo,
               const float* __restrict__ trans, const int* __restrict__ rlen,
               const int* __restrict__ hkey, const unsigned char* __restrict__ hfo,
               const int* __restrict__ hlen, const int* __restrict__ ri_,
               const int* __restrict__ hi_, const int* __restrict__ tasks,
               const int* __restrict__ ntasks, float* __restrict__ res,
               float* __restrict__ state, int Rp, int T1, int Hp, int RB, int nmem) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int slot = blockIdx.x * warps + warp;
  const int slice = kCellWords * 32 * nmem;  // words of a warp's carried state
  float* wbuf = smem + static_cast<size_t>(warp) * (2 * RB + (kRoute == kShared ? slice : 0));
  const int count = *ntasks;
  for (int t = slot; t < count; t += gridDim.x * warps) {
    const int task = tasks[t];
    const int b = task >> 2;
    const int ri = ri_[b], hi = hi_[b];  // in range: live_count made no task of a pair out of it
    const int H = hlen[hi];
    const int G = (H + 8) / 4;  // ceil((hlen + 5) / 4)
    const int n = (G + 31) / 32;
    Task p{tables + static_cast<size_t>(ri) * Rp * T1,
           trans + static_cast<size_t>(ri) * Rp * kTrans,
           rfo + static_cast<size_t>(ri) * Rp,
           wbuf,
           T1,
           RB,
           min(max(rlen[ri] - 1, 0), Rp - 1),
           G - lane * n,
           lane,
           task & 3,
           rfo[static_cast<size_t>(ri) * Rp],
           {1.0f, 1.0f, 1.0f, 1.0f},
           0.0f};
    const int* hk = hkey + static_cast<size_t>(hi) * Hp;
    const unsigned char* hf = hfo + static_cast<size_t>(hi) * Hp;
    __syncwarp();  // the last task's reads of the row buffers are done
    if constexpr (kRoute == kRegisters) {
      run_in_registers<1, kRegCells>(p, n, hk, hf, H, res + task);
    } else {
      float* f = kRoute == kShared ? wbuf + 2 * RB : state + static_cast<size_t>(slot) * slice;
      MemState st{f + lane, reinterpret_cast<unsigned*>(f + 9 * 32 * n) + lane, n};
      run_task(st, p, hk, hf, H, res + task);
    }
  }
}

// 4. A thread a pair: the live lattices' results summed in the linear domain.
__global__ void combine_lattices(const int* __restrict__ live, const float* __restrict__ res,
                                 float* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (live[b] & kDead) {
    out[b] = NAN;
    return;
  }
  float x[4], top = -INFINITY;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    x[s] = res[4 * b + s];
    top = fmaxf(top, x[s]);
  }
  if (top == -INFINITY) {
    out[b] = -INFINITY;
    return;
  }
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) sum += exp10f(x[s] - top);
  out[b] = top + log10f(sum);
}

int cells_per_lane(int Hp) { return ((Hp + 8) / 4 + 31) / 32; }

// The route for tables of Hp haplotype flows and T1 table columns, the tasks
// a block and the bytes of dynamic shared memory a block.
int route_of(int Hp, int T1, int* warps, long long* smem) {
  const int n = cells_per_lane(Hp);
  const long long bufs = 4LL * 2 * (T1 + kRowTail);
  const long long state = 4LL * kCellWords * 32 * n;
  int route = n <= kRegCells ? kRegisters : bufs + state <= kMaxSmem ? kShared : kDevice;
  const long long per_warp = route == kShared ? bufs + state : bufs;
  *warps = route == kDevice                    ? 1
           : per_warp > kMaxSmem / kWarps ? static_cast<int>(kMaxSmem / per_warp)
                                          : kWarps;
  if (*warps < 1) *warps = 1;
  *smem = per_warp * *warps;
  return route;
}

long long align32(long long words) { return (words + 31) / 32 * 32; }

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The state route of a launch on tables of Hp haplotype flows and T1 table
// columns: 0 registers, 1 the warp's shared memory, 2 device scratch; *warps
// the tasks a block and *smem the bytes of dynamic shared memory a block (the
// launch is refused where that passes 232,448: T1 past 29,049).
extern "C" int flow_pairhmm_dense_route(int Hp, int T1, int* warps, long long* smem) {
  return route_of(Hp, T1, warps, smem);
}

// Bytes of one task's carried state for tables of Hp haplotype flows: what a
// slot of the device route holds.
extern "C" long long flow_pairhmm_dense_state(int Hp) {
  return 4LL * kCellWords * 32 * cells_per_lane(Hp);
}

// int32 words of scratch a launch of B pairs needs: the plan (B live masks,
// 4 B tasks, the task count) and the 4 B lattice results, and on the device
// route `slots` tasks' state.
extern "C" long long flow_pairhmm_dense_scratch(int B, int Hp, int T1, int slots) {
  int warps = 0;
  long long smem = 0;
  const bool device = route_of(Hp, T1, &warps, &smem) == kDevice;
  return align32(9LL * B + 1) + (device ? static_cast<long long>(slots) * kCellWords * 32 *
                                              cells_per_lane(Hp)
                                        : 0);
}

// Launches the four kernels on `stream`; returns the first launch error, else
// cudaGetLastError(). scratch holds flow_pairhmm_dense_scratch(B, Hp, T1,
// slots) int32 words; slots (the warps of the device route's grid) is read on
// that route only.
extern "C" int flow_pairhmm_dense(const void* tables, const void* rfo, const void* trans,
                                  const void* rlen, const void* hkey, const void* hfo,
                                  const void* hlen, const void* ri, const void* hi, void* out,
                                  void* scratch, int B, int NR, int Rp, int T1, int NH, int Hp,
                                  int slots, void* stream) {
  if (B <= 0 || B >= (1 << 29) || Rp <= 0 || T1 <= 0 || T1 >= static_cast<int>(kKeyMask) ||
      Hp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = 0;
  long long smem = 0;
  const int route = route_of(Hp, T1, &warps, &smem);
  if (smem > kMaxSmem || (route == kDevice && slots <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* live = static_cast<int*>(scratch);
  int* tasks = live + B;
  float* res = reinterpret_cast<float*>(tasks + 4LL * B);
  int* ntasks = reinterpret_cast<int*>(res + 4LL * B);
  float* state = reinterpret_cast<float*>(live + align32(9LL * B + 1));
  const auto* tb = static_cast<const float*>(tables);
  const auto* rf = static_cast<const unsigned char*>(rfo);
  const auto* tr = static_cast<const float*>(trans);
  const auto* rl = static_cast<const int*>(rlen);
  const auto* hk = static_cast<const int*>(hkey);
  const auto* hf = static_cast<const unsigned char*>(hfo);
  const auto* hl = static_cast<const int*>(hlen);
  const auto* r = static_cast<const int*>(ri);
  const auto* h = static_cast<const int*>(hi);

  live_count<<<(B + kCountWarps - 1) / kCountWarps, kCountWarps * 32, 0, st>>>(
      tb, rf, rl, hk, hf, hl, r, h, live, res, B, NR, Rp, T1, NH, Hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  live_tasks<<<1, kScanThreads, 0, st>>>(live, tasks, ntasks, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n = cells_per_lane(Hp);
  auto kernel = route == kDevice   ? lattice_kernel<kDevice>
                : route == kShared ? lattice_kernel<kShared>
                                   : lattice_kernel<kRegisters>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = route == kDevice ? slots : (4LL * B + warps - 1) / warps;
  kernel<<<static_cast<int>(grid), warps * 32, smem, st>>>(
      tb, rf, tr, rl, hk, hf, hl, r, h, tasks, ntasks, res, state, Rp, T1, Hp, T1 + kRowTail,
      route == kRegisters ? 0 : n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_lattices<<<(B + 255) / 256, 256, 0, st>>>(live, res, static_cast<float*>(out), B);
  return static_cast<int>(cudaGetLastError());
}
