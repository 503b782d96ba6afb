// PairHMM cartesian kernel for NVIDIA Hopper (sm_90a).
//
// Replaces gatk_tpu/ops/pairhmm_tpu.py:_pairhmm_matrix_kernel (called through
// _pairhmm_matrix_call, :262-295): log10 P(read | hap) for every read x every
// haplotype of one region, as an (NH, NR) f32 matrix, hap-major. The
// recurrence, the f32 floor and the N rule (an N on either side scores as a
// match, :228) are those of csrc/pairhmm_fwd.cu, whose stripe sweep it shares
// (csrc/pairhmm_sweep.cuh). A haplotype of length 0 gives NEG_INF without a
// sweep (:208-259).
//
// Inputs are the device-resident uint8 pools of ops/pairhmm.py: read tables
// (rp, NR) with read base k in row k+1, rlen (NR,), haplotypes reversed in e
// (He, NH), He = hmax + 2*rp + 16, hlen (NH,). There is no pair list: pair
// (h, r) is computed by the warp of read r and written to out[h * NR + r].
//
// What bounds it: FP32 arithmetic outside the tensor cores, as for
// pairhmm_fwd.cu (11 FP32 operations per cell, state in registers); the bytes
// (the pools once, the output once) are negligible next to NR x NH x rlen x
// hlen cells.
//
// What the design does about it:
//   * One warp per read, four reads (warps) per block. A warp builds its read's
//     transition and prior tables once (4 expf per row) and then loops over a
//     chunk of the region's haplotypes, so the tables are not rebuilt for every
//     pair as in the pair kernel.
//   * The grid is (read blocks, haplotype chunks). The launcher cuts the
//     haplotypes into as few chunks as still put kMinWarpTasks warps' work in
//     flight: a region with thousands of reads loops over all its haplotypes
//     in one chunk, a small one still fills the 132 SMs.
//   * Reads of up to 160 rows keep their tables in registers across the whole
//     haplotype loop. Longer reads (rp 320 and beyond) build each stripe's
//     tables once into the warp's shared memory and load them into registers
//     at the start of that stripe's sweep, for every haplotype.
//   * Each haplotype (hlen bytes) is staged in the warp's shared memory; warps
//     of a block do not wait for each other.
// Left for later: sorting reads by length so a block's warps finish together,
// several short reads per warp, a block-wide haplotype stage.

#include <algorithm>

#include "pairhmm_sweep.cuh"

namespace {

using namespace pairhmm;

constexpr int kWarpsPerBlock = 4;
constexpr long long kMinWarpTasks = 4096;  // (read, haplotype chunk) tasks to aim for

struct Args {
  ReadPools reads;
  const int32_t* rlen;
  const uint8_t* e;
  const int32_t* hlen;
  float* out;
  int rp, nh, hmax, hap_chunk;
  int max_stripes;       // stripes of the longest read the layout allows (rp - 1 rows)
  size_t smem_per_warp;  // bytes: if max_stripes > 1, [2][3][hmax + 1] floats of stripe
                         // rows and [max_stripes][kTables][kStripe] floats of tables;
                         // then hmax bytes of haplotype
};

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pairhmm_matrix_kernel(Args a, int warps_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * warps_per_block + warp;
  if (r >= a.reads.nr) return;  // warp-uniform
  const int nr = a.reads.nr;
  const int h0 = blockIdx.y * a.hap_chunk;
  const int h1 = min(a.nh, h0 + a.hap_chunk);
  float* out = a.out + r;  // out[h * nr]

  const int L = a.rlen[r];
  if (L < 0 || L > a.rp - 1) {
    for (int h = h0 + lane; h < h1; h += kWarp) out[(size_t)h * nr] = __int_as_float(0x7fc00000);
    return;
  }

  unsigned char* wsm = smem + warp * a.smem_per_warp;
  const int H1 = a.hmax + 1;
  const bool multi = a.max_stripes > 1;
  float* bnd = reinterpret_cast<float*>(wsm);  // [2][3][H1], multi-stripe layouts only
  float* tab = bnd + (multi ? 6 * H1 : 0);     // [max_stripes][kTables][kStripe]
  unsigned char* hs =
      reinterpret_cast<unsigned char*>(tab + (multi ? a.max_stripes * kTables * kStripe : 0));

  const int n_stripes = (L + kStripe - 1) / kStripe;
  const int lastL = L > 0 ? (L - 1) % kStripe : 0;  // row L within its stripe (0-based)
  Tables T;
  if (n_stripes > 1) {
    for (int s = 0; s < n_stripes; ++s) {
      build_tables(T, a.reads, r, s * kStripe + lane * kRows + 1, L);
      store_tables(T, tab + s * kTables * kStripe, lane);
    }
    __syncwarp();
  } else {
    build_tables(T, a.reads, r, lane * kRows + 1, L);
  }

  // haplotype base k sits at row kEOff + rp - 1 + hmax - 1 - k of e
  const size_t hrow0 = (size_t)(kEOff + a.rp - 2 + a.hmax);
  for (int h = h0; h < h1; ++h) {
    const int H = a.hlen[h];
    if (H < 0 || H > a.hmax) {
      if (lane == 0) out[(size_t)h * nr] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    if (L == 0 || H == 0) {  // no read rows or no free-deletion mass: acc == 0
      if (lane == 0) out[(size_t)h * nr] = kNegInf;
      continue;
    }
    __syncwarp();  // every lane is done with the previous haplotype
    for (int k = lane; k < H; k += kWarp) hs[k] = a.e[(hrow0 - k) * a.nh + h];
    __syncwarp();

    const float y0 = kInit / (float)H;
    float acc = 0.f;
    for (int s = 0; s < n_stripes; ++s) {
      const int s0 = s * kStripe;
      const int nl = (min(kStripe, L - s0) + kRows - 1) / kRows;  // lanes with rows
      const int kL = (s == n_stripes - 1 && lane == lastL / kRows) ? lastL % kRows : -1;
      if (n_stripes > 1) load_tables(T, tab + s * kTables * kStripe, lane);
      sweep_stripe<false>(acc, T, hs, H, H1, y0, s, nl, kL, lane,
                          bnd + (s & 1) * 3 * H1,        // row s0 from the previous stripe
                          bnd + ((s + 1) & 1) * 3 * H1,  // row s0 + kStripe for the next
                          s + 1 < n_stripes && lane == kWarp - 1);
      __syncwarp();  // the next stripe reads this stripe's bottom row
    }
    if (lane == lastL / kRows) out[(size_t)h * nr] = finish(acc);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). out: (nh, nr) f32.
extern "C" int pairhmm_matrix(const void* rbase, const void* rq, const void* iq, const void* dq,
                              const void* gcp, const void* rlen, const void* e, const void* hlen,
                              void* out, int rp, int nr, int he, int nh, void* stream) {
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
  a.out = static_cast<float*>(out);
  a.rp = rp;
  a.nh = nh;
  a.hmax = he - 2 * rp - kEOff;
  if (nr <= 0 || nh <= 0) return 0;
  if (rp < 2 || a.hmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.max_stripes = (rp - 1 + kStripe - 1) / kStripe;
  const size_t floats = a.max_stripes > 1
      ? (6 * (size_t)(a.hmax + 1) + (size_t)a.max_stripes * kTables * kStripe) * sizeof(float)
      : 0;
  a.smem_per_warp = (floats + (size_t)a.hmax + 15) / 16 * 16;
  if (a.smem_per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * a.smem_per_warp > kMaxSmem) --wpb;
  const size_t smem = wpb * a.smem_per_warp;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pairhmm_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // as few haplotype chunks as still give kMinWarpTasks (read, chunk) tasks
  const long long chunks =
      std::max(1LL, std::min((long long)nh, (kMinWarpTasks + nr - 1) / nr));
  a.hap_chunk = static_cast<int>((nh + chunks - 1) / chunks);
  const dim3 grid(static_cast<unsigned>((nr + wpb - 1) / wpb),
                  static_cast<unsigned>((nh + a.hap_chunk - 1) / a.hap_chunk));
  pairhmm_matrix_kernel<<<grid, wpb * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(a, wpb);
  return static_cast<int>(cudaGetLastError());
}
