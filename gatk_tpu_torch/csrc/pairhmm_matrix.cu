// PairHMM cartesian kernel for NVIDIA Hopper (sm_90a).
//
// Replaces gatk_tpu/ops/pairhmm_tpu.py:_pairhmm_matrix_kernel (called through
// _pairhmm_matrix_call, :262-295): log10 P(read | hap) for every read x every
// haplotype of one region, as an (NH, NR) f32 matrix, hap-major. The
// recurrence, the f32 floor and the N rule (an N on either side scores as a
// match, :228) are those of csrc/pairhmm_fwd.cu, whose sweep it shares
// (csrc/pairhmm_sweep.cuh). A haplotype of length 0 gives NEG_INF without a
// sweep (:208-259).
//
// Inputs are the device-resident uint8 pools of ops/pairhmm.py: read tables
// (rp, NR) with read base k in row k+1, rlen (NR,), haplotypes reversed in e
// (He, NH), He = hmax + 2*rp + 16, stored haplotype-major, so the kernel reads
// it as (NH, He), hlen (NH,), and int32 scratch for the plan of the reads
// (ops/_kernels.plan_scratch). Pair (h, r) is written to out[h * NR + r].
//
// What bounds it: FP32 arithmetic outside the tensor cores, as for
// pairhmm_fwd.cu (11 FP32 operations per cell, state in registers); the bytes
// (the pools once, the output once) are negligible next to NR x NH x rlen x
// hlen cells. The one-warp-per-read design (commit 0487e99) left 42-45 % of
// its lane-slots idle on the -ERC GVCF regions (a read of 14 rows took 32
// lanes x 5 rows), and its grid of (read blocks, haplotype chunks) ended each
// launch on a partial wave.
//
// What the design does about it:
//   * Lane groups by read length, as in pairhmm_fwd.cu: a read of at most 5G
//     rows takes a group of G = 4, 8, 16 or 32 lanes, so a warp holds 32/G
//     reads of one width class (the launcher's plan sorts the reads on the
//     card by class, then lanes used). A warp's groups loop over the same
//     haplotypes, so hlen is uniform across the warp and no group waits on
//     another's haplotype; a haplotype takes hlen + (the warp's most lanes) - 1
//     steps.
//   * A warp builds its reads' transition and prior tables once (4 expf per
//     row) for a chunk of the region's haplotypes. Tasks are (warp of reads,
//     haplotype chunk) pairs; the kernel cuts the haplotypes into as few chunks
//     as still give kTasksPerWarp tasks to each resident warp, counted in
//     warps of reads (from the plan), not in reads.
//   * One launch of resident blocks whose warps take the tasks from a counter,
//     so no warp waits at the end for a wave it has no share in.
//   * Reads of up to 160 rows keep their tables in registers across the whole
//     haplotype loop. Longer reads (rp 320 and beyond) build each stripe's
//     tables once into the warp's shared memory and load them into registers
//     at the start of that stripe's sweep, for every haplotype.
//   * Lanes read haplotype bases straight from device memory, from e's
//     haplotype-major rows, so a warp's reads of one step fall in one 32-byte
//     sector.
// The arithmetic of a cell and the order of each pair's final-row sum are
// those of pairhmm_fwd.cu; an unguarded step issues 68.5 instructions (42 of
// them FP32), where one warp per read issued 135.
// ptxas -v (sm_90a, CUDA 12.8): 123 registers at 4 blocks of 4 warps an SM,
// no spills (at 5 blocks, 96 registers with spills timed slower).

#include "pairhmm_sweep.cuh"

namespace {

using namespace pairhmm;

constexpr int kWarpsPerBlock = 4;
// Blocks of 4 warps that __launch_bounds__ asks each SM to hold (it caps the
// registers a thread may use). Timed on an H100 80GB HBM3 at 700 W, as a
// share of the one-warp-per-read kernel's time at the -ERC GVCF launch: 3
// blocks (125 registers) 0.594; 4 (123) 0.601; 5 (96 and an 80-byte stack)
// 0.628. 3 and 4 are within the spread between runs.
constexpr int kMinBlocks = 4;
constexpr int kTasksPerWarp = 8;   // (warp of reads, haplotype chunk) tasks per resident warp

struct Args {
  ReadPools reads;
  const int32_t* rlen;
  const uint8_t* et;  // haplotypes (NH, He): the pools' e, haplotype-major
  const int32_t* hlen;
  Plan plan;
  float* out;
  int rp, nh, he, hmax;
  int max_stripes;       // stripes of the longest read the layout allows (rp - 1 rows)
  size_t smem_per_warp;  // bytes: if max_stripes > 1, [2][3][hmax + 1] floats of stripe
                         // rows and [max_stripes][kTables][kStripe] floats of tables
};

// One task of class G: the reads at plan positions first .. first + 32/G - 1
// (those below end), one per group, with haplotypes h0 .. h1 - 1.
template <int G>
__device__ __forceinline__ void matrix_task(const Args& a, int first, int end, int h0, int h1,
                                            int lane, unsigned char* wsm) {
  const int g = lane / G;
  const int gl = lane % G;
  const int nr = a.reads.nr;
  const int H1 = a.hmax + 1;
  const bool multi = G == kWarp && a.max_stripes > 1;
  float* bnd = reinterpret_cast<float*>(wsm);  // [2][3][H1], multi-stripe layouts only
  float* tab = bnd + (multi ? 6 * H1 : 0);     // [max_stripes][kTables][kStripe]

  const int r = first + g < end ? (int)a.plan.perm[first + g] : -1;
  int L = r >= 0 ? a.rlen[r] : 0;
  const bool bad = r >= 0 && (L < 0 || L > a.rp - 1 || (G < kWarp && L > G * kRows));
  if (bad) L = 0;
  float* out = a.out + (r >= 0 ? r : 0);  // out[h * nr]
  const int n_stripes = G == kWarp ? (L + kStripe - 1) / kStripe : 1;
  const int nl = n_stripes > 1 ? kWarp : (L + kRows - 1) / kRows;
  const int pad = (n_stripes > 1 ? n_stripes * kStripe : nl * kRows) - L;
  const int lanes = __reduce_max_sync(kFull, nl);  // the warp's most lanes with rows
  Tables T;
  if (n_stripes > 1) {  // one group: warp-uniform
    for (int s = 0; s < n_stripes; ++s) {
      build_tables(T, a.reads, r, s * kStripe + gl * kRows + 1 - pad, L);
      store_tables(T, tab + s * kTables * kStripe, gl);
    }
    __syncwarp();
  } else {
    build_tables(T, a.reads, r, gl * kRows + 1 - pad, L);
  }

  for (int h = h0; h < h1; ++h) {
    const int H = a.hlen[h];
    if (H <= 0 || H > a.hmax || L == 0) {  // warp-uniform but for L
      // NaN for a length out of range, NEG_INF for no read rows or no
      // free-deletion mass (acc == 0)
      if (r >= 0 && gl == 0)
        out[(size_t)h * nr] = bad || H < 0 || H > a.hmax ? __int_as_float(0x7fc00000) : kNegInf;
      if (H <= 0 || H > a.hmax) continue;
    }
    // haplotype base k sits at column kEOff + rp - 1 + hmax - 1 - k of et
    const uint8_t* hap = a.et + (size_t)h * a.he + kEOff + a.rp - 2 + a.hmax;
    const float y0 = kInit / (float)H;
    float acc = 0.f;
    for (int s = 0; s < n_stripes; ++s) {
      if (n_stripes > 1) load_tables(T, tab + s * kTables * kStripe, gl);
      acc = 0.f;
      sweep_stripe<G, false>(acc, T, hap, H, H1, y0, H + lanes - 1, H, gl, s == 0, pad,
                             bnd + (s & 1) * 3 * H1,        // the previous stripe's bottom row
                             bnd + ((s + 1) & 1) * 3 * H1,  // this stripe's, for the next
                             s + 1 < n_stripes && gl == kWarp - 1);
      __syncwarp();  // the next stripe reads this stripe's bottom row
    }
    if (L > 0 && gl == nl - 1) out[(size_t)h * nr] = finish(acc);
  }
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
pairhmm_matrix_kernel(Args a, int warps_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  unsigned char* wsm = smem + warp * a.smem_per_warp;
  int base[kClasses + 1];
  const int warps = warp_tasks(a.plan, base);  // warps of reads
  const int resident = gridDim.x * warps_per_block;
  // as few haplotype chunks as still give kTasksPerWarp tasks to each resident warp
  const long long want = ((long long)kTasksPerWarp * resident + warps - 1) / max(warps, 1);
  const int hap_chunk = (int)((a.nh + want - 1) / want);
  const int chunks = (a.nh + hap_chunk - 1) / hap_chunk;
  const long long tasks = (long long)warps * chunks;
  for (long long q; (q = next_task(a.plan, tasks, lane)) >= 0;) {  // warp-uniform
    int first;
    const int c = task_class(a.plan, base, (int)(q / chunks), first);
    const int end = a.plan.seg[c + 1];
    const int h0 = (int)(q % chunks) * hap_chunk;
    const int h1 = min(a.nh, h0 + hap_chunk);
    switch (c) {
      case 0: matrix_task<4>(a, first, end, h0, h1, lane, wsm); break;
      case 1: matrix_task<8>(a, first, end, h0, h1, lane, wsm); break;
      case 2: matrix_task<16>(a, first, end, h0, h1, lane, wsm); break;
      default: matrix_task<32>(a, first, end, h0, h1, lane, wsm); break;
    }
    __syncwarp();  // the next task overwrites the tables and stripe rows
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). out: (nh, nr) f32.
extern "C" int pairhmm_matrix(const void* rbase, const void* rq, const void* iq, const void* dq,
                              const void* gcp, const void* rlen, const void* et, const void* hlen,
                              void* scratch, void* out, int rp, int nr, int he, int nh,
                              void* stream) {
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
  a.out = static_cast<float*>(out);
  a.rp = rp;
  a.nh = nh;
  a.he = he;
  a.hmax = he - 2 * rp - kEOff;
  if (nr <= 0 || nh <= 0) return 0;
  if (rp < 2 || a.hmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.max_stripes = (rp - 1 + kStripe - 1) / kStripe;
  const size_t floats = a.max_stripes > 1
      ? (6 * (size_t)(a.hmax + 1) + (size_t)a.max_stripes * kTables * kStripe) * sizeof(float)
      : 0;
  a.smem_per_warp = floats;
  if (a.smem_per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * a.smem_per_warp > kMaxSmem) --wpb;
  const size_t smem = wpb * a.smem_per_warp;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pairhmm_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_plan(nullptr, nullptr, a.rlen, nullptr, nr, nr, nh, 0, scratch, st,
                                a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;  // at most one warp a (read, haplotype) pair
  err = resident_blocks(pairhmm_matrix_kernel, wpb * kWarp, smem,
                        ((long long)nr * nh + wpb - 1) / wpb, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairhmm_matrix_kernel<<<grid, wpb * kWarp, smem, st>>>(a, wpb);
  return static_cast<int>(cudaGetLastError());
}
