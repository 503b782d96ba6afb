// Flow-space PairHMM for NVIDIA Hopper (sm_90a): one warp a (read,
// haplotype) pair, over the DP's coset cells only, its prior gathered from
// the read's probability table inside the kernel.
//
// Computes what gatk_tpu/ops/flow_pairhmm.py:flow_pairhmm_batch_jax (:116-194)
// computes under lax.scan: for each pair the float32 log10 likelihood of the
// read's flow keys given the haplotype's, by FlowBasedPairHMM's recurrence
// (FlowBasedPairHMM.java:167-241) over read flows k (DP row k + 5) and DP
// columns c (haplotype flow c - 5):
//   m_k[c] = prior_k[c] * (m_{k-1}[c-1] * MM + (i_{k-1}[c-1] + d_{k-1}[c-1]) * IM)
//   i_k[c] = m_{k-4}[c] * MI + i_{k-4}[c] * II
//   d_k[c] = m_k[c-4] * MD + d_k[c-4] * DD
// from m = i = 0 and d_{-1} = 1 / max(hlen, 1), each row divided by a scale c
// (1 where c <= 0) and log10(c) added to a float32 offset; the result is
// log10 of row kf = clip(rlen - 1, 0, Rp - 1)'s M + I sum plus the offset
// before that row, -inf where the sum is <= 0. gatk_tpu's c is the row's
// maximum of M, I and D; this kernel's is the maximum of M and I, so that it
// need not wait for the D scan. The row's D comes from its own M and stays
// below max(M) md / (1 - dd), so either c keeps every value in range, and the
// log10 likelihood is the same up to rounding.
// ops/flow_pairhmm.flow_pairhmm_pairs_plain is the plain version, on the same
// lattice.
//
// The coset lattice. prior_k[c] = P(true hmer = hkey[c - 5] | flow k) where
// read flow k and haplotype flow c - 5 read one base, else 0. For flow bases
// that repeat with period 4 over four distinct bases (TGCA) that is one coset
// of each row, c = 4 g + r_k with r_k = (5 + k + s) mod 4, s the first
// haplotype flow that reads the read's first base (_starting_point). M, I and
// D are exactly 0 off it, so GATK loops over it alone, and so does this
// kernel: cell g of row k is column 4 g + r_k, g < G = ceil((hlen + 5) / 4).
// In that index I pulls cell g of row k - 4, D cell g - 1 of its own row (one
// affine chain a row), and M cell g of row k - 1, or g - 1 where r_k = 0.
// gatk_tpu's dense scan computes every column of the batch's width: its
// off-coset cells are 0 and its D past the pair's last cell feeds only the
// row maximum, so both give the same log10 likelihood; the maxima and the sums
// round otherwise (held to 1e-4 in log10 against both plain versions by
// tests/test_torch_kernel_cuda.py and chip_smoke.py). Each warp checks the
// rule on its read's and haplotype's flow bases and flags a read or haplotype
// that breaks it in `bad` (1 + its index, the largest such); the entry
// (ops/flow_pairhmm.flow_pairhmm_pairs) then scores the pairs that hold such
// a read or haplotype again with the dense kernel, csrc/flow_pairhmm_dense.cu.
//
// Inputs (ops/flow_pairhmm.pack_flow_tables): tables (NR, Rp, T1) f32, row k of
// read r holding P(true hmer = h | flow k) for h < T1; rfo (NR, Rp) u8 flow
// bases; trans (NR, Rp, 6) f32; rlen (NR,) i32; hkey (NH, Hp) i32; hfo (NH, Hp)
// u8; hlen (NH,) i32; the pairs ri, hi (B,) i32. Output (B,) f32, NaN for a
// pair whose indices or lengths are out of range.
//
// What bounds it: 13 FP32 operations a coset cell (M 5, I 3, D 3, the row
// maximum of M and I 2), and the inputs are
// small (a read's rows of T1 + 6 floats, a haplotype's keys), so the bound is
// the operations; but every row depends on the one before, so the time is the
// latency of a pair's rows. There are no tensor-core instructions: the
// recurrence holds no matrix product.
//
// Design: a warp a pair, up to four pairs a block, no block barrier. Lane l
// owns the contiguous cells [l n, l n + n) of every row, n = ceil(G / 32). A
// row:
//   1. M and I of each cell from the lane's own history; where r_k = 0 the M
//      pull of the lane's first cell comes from the lane before by a shuffle.
//      The prior is the read's table row at the cell's key, read from the
//      warp's shared memory, where cp.async brought it (with the row's six
//      transitions) during the row before;
//   2. D: each lane runs its segment's chain from 0; a 5-step warp scan of the
//      segments' affine maps (dd^n, d) joins them, and each cell adds the
//      incoming d times dd^(i + 1);
//   3. the row's scale c, the maximum of M and I, by warp shuffles beside
//      the D scan (and at kf the M + I sum).
// No carried value is rescaled: each row is kept in its own scale, and the
// next row folds 1 / c into its transitions, the pull of row k - 1 by its
// 1 / c and the pull of row k - 4 by the product of the last four.
// The carried state, 4 rows of M and I and one of D, n cells each, lives in
// registers for n <= 4 (hlen <= 507 flows; each warp runs its own pair's n of
// 1..4; the instance is held to 80 registers, 24 warps an SM: the rows are
// latency-bound, so more warps in flight beat the few values that spill) and
// in the warp's slice of shared memory above (a second instance). A lane loads its cells' keys once: cell g
// holds those of flows 4 g - 5 .. 4 g - 2, one for each coset a row can have,
// ordered by the row mod 4 that reads it; a key past the haplotype's flows,
// or on a row whose read base the coset's haplotype flows do not read, points
// at a 0 after the table row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;             // pairs a block, at most
constexpr int kRegCells = 4;          // cells a lane holds in registers, at most
constexpr int kMaxSmem = 232448;      // bytes of shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyMask = 0xffffu;  // a key is 16 bits
constexpr int kTrans = 6;
constexpr int kRowTail = 1 + kTrans;  // after a table row: a 0, then the transitions
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

// The carried state in registers: N cells a lane.
template <int N>
struct RegState {
  float m[4][N], i[4][N], d[N];
  unsigned key[2][N];  // the keys of rows 0, 1 (word 0) and 2, 3 (word 1) mod 4
  __device__ static constexpr int cells() { return N; }
  __device__ float& M(int s, int c) { return m[s][c]; }
  __device__ float& I(int s, int c) { return i[s][c]; }
  __device__ float& D(int c) { return d[c]; }
  __device__ unsigned& K(int w, int c) { return key[w][c]; }
};

// The carried state in the warp's shared memory: n cells a lane, cell c of
// lane l at [c * 32 + l] of each of 9 float rows (M 0-3, I 0-3, D) and 2 key
// rows.
struct SmemState {
  float* f;     // this lane's first float
  unsigned* k;  // this lane's first key word
  int n;
  __device__ int cells() const { return n; }
  __device__ float& M(int s, int c) const { return f[(s * n + c) * 32]; }
  __device__ float& I(int s, int c) const { return f[((4 + s) * n + c) * 32]; }
  __device__ float& D(int c) const { return f[(8 * n + c) * 32]; }
  __device__ unsigned& K(int w, int c) const { return k[(w * n + c) * 32]; }
};

struct Pair {
  const float* tab;    // the read's table rows, T1 floats each
  const float* trans;  // the read's transition rows, 6 floats each
  float* buf;          // the warp's two row buffers of RB = T1 + kRowTail floats
  int T1, RB, kf, nv, lane, s;  // nv: this lane's cells below G
  float inv[4];                 // 1 / c of the last four rows, row j at j & 3
  float acc;                    // log10 of the scale so far
};

// Row k's table and transitions into buffer k & 1, by cp.async.
__device__ __forceinline__ void fetch_row(const Pair& p, int k) {
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
__device__ __forceinline__ bool row_step(S& st, Pair& p, int k, float* out) {
  constexpr int cur = T, prev = (T + 3) & 3;
  if (k < p.kf) fetch_row(p, k + 1);
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
  //    cells are the columns 4 g
  const bool shift = ((1 + T + p.s) & 3) == 0;
  float q_left = __shfl_up_sync(
      kFull, st.M(prev, n - 1) * mm + (st.I(prev, n - 1) + st.D(n - 1)) * im, 1);
  if (p.lane == 0) q_left = 0.0f;
  float mx = 0.0f;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const float q = st.M(prev, c) * mm + (st.I(prev, c) + st.D(c)) * im;
    const unsigned w = st.K(T >> 1, c);
    const float pr = row[(T & 1) ? w >> 16 : w & kKeyMask];
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
  fetch_wait();
  return false;
}

// ok bit t: read flow t reads the base of the haplotype flows of row t's
// coset (rows t + 4 m read the same ones).
template <class S>
__device__ __forceinline__ void run_pair(S& st, Pair& p, const int* hk, int H, unsigned ok,
                                         float* out) {
  const int n = st.cells();
  const float init = 1.0f / fmaxf(static_cast<float>(H), 1.0f);
  const unsigned zero = static_cast<unsigned>(p.T1);  // the 0 after the table row
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const int j0 = 4 * (p.lane * n + c) - 5;  // the haplotype flow of column 4 g
    unsigned key[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // row t mod 4 reads column 4 g + ((1 + t + s) & 3)
      const int j = j0 + ((1 + t + p.s) & 3);
      key[t] = ((ok >> t) & 1u) && j >= 0 && j < H ? min(static_cast<unsigned>(hk[j]), zero)
                                                   : zero;
    }
    st.K(0, c) = key[0] | key[1] << 16;
    st.K(1, c) = key[2] | key[3] << 16;
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

// The pair in registers, with the least N >= n of N..NMAX.
template <int N, int NMAX>
__device__ __forceinline__ void run_in_registers(Pair& p, int n, const int* hk, int H,
                                                 unsigned ok, float* out) {
  if constexpr (N < NMAX) {
    if (n > N) {
      run_in_registers<N + 1, NMAX>(p, n, hk, H, ok, out);
      return;
    }
  }
  RegState<N> st;
  run_pair(st, p, hk, H, ok, out);
}

// Whether flow f breaks the coset rule: the bases repeat with period 4 over
// four distinct bases.
__device__ __forceinline__ bool breaks_rule(const unsigned char* fo, int f) {
  const unsigned char x = fo[f];
  if (f >= 4) return x != fo[f & 3];
  for (int j = 0; j < f; ++j)
    if (fo[j] == x) return true;
  return false;
}

// kRegs: the state in registers, kRegCells cells a lane at most (6 blocks an
// SM, 80 registers a thread); else in shared memory, nsm cells a lane.
template <bool kRegs>
__global__ void __launch_bounds__(kWarps * 32, kRegs ? 6 : 1)
flow_pairhmm_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ rfo,
                    const float* __restrict__ trans, const int* __restrict__ rlen,
                    const int* __restrict__ hkey, const unsigned char* __restrict__ hfo,
                    const int* __restrict__ hlen, const int* __restrict__ ri_,
                    const int* __restrict__ hi_, float* __restrict__ out, int* __restrict__ bad,
                    int B, int NR, int Rp, int T1, int NH, int Hp, int RB, int nsm) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int ri = ri_[b], hi = hi_[b];
  if (ri < 0 || ri >= NR || hi < 0 || hi >= NH) {
    if (lane == 0) out[b] = NAN;
    return;
  }
  const int R = rlen[ri], H = hlen[hi];
  if (R < 0 || R > Rp || H < 0 || H > Hp) {
    if (lane == 0) out[b] = NAN;
    return;
  }
  const unsigned char* rf = rfo + static_cast<size_t>(ri) * Rp;
  const unsigned char* hf = hfo + static_cast<size_t>(hi) * Hp;
  bool br = false, bh = false;
  for (int f = lane; f < R; f += 32) br |= breaks_rule(rf, f);
  for (int f = lane; f < H; f += 32) bh |= breaks_rule(hf, f);
  br = __any_sync(kFull, br);
  bh = __any_sync(kFull, bh);
  if (lane == 0 && br) atomicMax(bad, ri + 1);
  if (lane == 0 && bh) atomicMax(bad + 1, hi + 1);

  int s = 0;  // _starting_point: the first haplotype flow reading the read's first base
  for (int j = min(H, 4) - 1; j >= 0; --j)
    if (hf[j] == rf[0]) s = j;
  unsigned ok = 0;
  for (int t = 0; t < 4; ++t) {
    const int j = (t + s) & 3;
    if (t < R && j < H && rf[t] == hf[j]) ok |= 1u << t;
  }
  const int G = (H + 8) / 4;  // ceil((hlen + 5) / 4)
  const int n = (G + 31) / 32;
  float* wbuf = smem + static_cast<size_t>(warp) * (2 * RB + 11 * 32 * nsm);
  Pair p{tables + static_cast<size_t>(ri) * Rp * T1,
         trans + static_cast<size_t>(ri) * Rp * kTrans,
         wbuf,
         T1,
         RB,
         min(max(R - 1, 0), Rp - 1),
         G - lane * n,
         lane,
         s,
         {1.0f, 1.0f, 1.0f, 1.0f},
         0.0f};
  const int* hk = hkey + static_cast<size_t>(hi) * Hp;
  if constexpr (kRegs) {
    run_in_registers<1, kRegCells>(p, n, hk, H, ok, out + b);
  } else {
    float* f = wbuf + 2 * RB;
    SmemState st{f + lane, reinterpret_cast<unsigned*>(f + 9 * 32 * n) + lane, n};
    run_pair(st, p, hk, H, ok, out + b);
  }
}

int cells_per_lane(int Hp) { return ((Hp + 8) / 4 + 31) / 32; }

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block needs for tables of Hp haplotype
// flows and T1 table columns, and in *warps the pairs a block: two row buffers
// a warp, and above kRegCells cells a lane the carried state.
extern "C" long long flow_pairhmm_smem(int Hp, int T1, int* warps) {
  const int n = cells_per_lane(Hp);
  const long long per_warp =
      4LL * (2LL * (T1 + kRowTail) + (n > kRegCells ? 11LL * 32 * n : 0));
  *warps = static_cast<int>(per_warp > kMaxSmem / kWarps ? kMaxSmem / per_warp : kWarps);
  if (*warps < 1) *warps = 1;
  return per_warp * *warps;
}

// Launches a warp a pair on `stream`; returns cudaGetLastError(). bad (2,)
// int32 must hold 0 before the launch.
extern "C" int flow_pairhmm(const void* tables, const void* rfo, const void* trans,
                            const void* rlen, const void* hkey, const void* hfo,
                            const void* hlen, const void* ri, const void* hi, void* out,
                            void* bad, int B, int NR, int Rp, int T1, int NH, int Hp,
                            void* stream) {
  if (B <= 0 || Rp <= 0 || T1 <= 0 || T1 > static_cast<int>(kKeyMask) || Hp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = 0;
  const long long smem = flow_pairhmm_smem(Hp, T1, &warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int n = cells_per_lane(Hp);
  const int nsm = n > kRegCells ? n : 0;
  auto kernel = n <= kRegCells ? flow_pairhmm_kernel<true> : flow_pairhmm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>((static_cast<long long>(B) + warps - 1) / warps);
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tables), static_cast<const unsigned char*>(rfo),
      static_cast<const float*>(trans), static_cast<const int*>(rlen),
      static_cast<const int*>(hkey), static_cast<const unsigned char*>(hfo),
      static_cast<const int*>(hlen), static_cast<const int*>(ri), static_cast<const int*>(hi),
      static_cast<float*>(out), static_cast<int*>(bad), B, NR, Rp, T1, NH, Hp, T1 + kRowTail,
      nsm);
  return static_cast<int>(cudaGetLastError());
}
