// The PairHMM stripe sweep shared by csrc/pairhmm_fwd.cu (one warp per pair)
// and csrc/pairhmm_matrix.cu (one warp per read, looping over haplotypes).
//
// GATK's logless 3-state forward recurrence (LoglessPairHMM.java:48-70) in f32,
// laid out for one warp: lane l owns kRows = 5 consecutive read rows of a
// 160-row stripe and keeps their transition/prior tables and M, X, Y state in
// registers. Lanes sweep haplotype columns skewed by one step per lane (at step
// t lane l computes column j = t - l), so the row above at columns j and j-1
// comes from lane l-1 by __shfl_up_sync and no DP state touches memory. Reads
// longer than one stripe run as several stripes; the bottom row of a stripe is
// handed to the next through two shared-memory row buffers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pairhmm {

constexpr int kWarp = 32;
constexpr int kRows = 5;                 // read rows per lane
constexpr int kStripe = kWarp * kRows;   // read rows per warp sweep
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

// One lane's rows of one stripe: transition and prior tables and read bases.
struct Tables {
  float tmm[kRows], tim[kRows], tmi[kRows], tii[kRows], tmd[kRows], tdd[kRows];
  float peq[kRows], pne[kRows];
  int rb[kRows];
};

// Rows row0 .. row0 + kRows - 1 of read r (length L). A read N scores as a
// match (pne = peq); rows below the read are zero and never feed a row <= L.
__device__ __forceinline__ void build_tables(Tables& T, const ReadPools& p, int r, int row0,
                                             int L) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = row0 + k;
    if (i <= L) {
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
      T.tmm[k] = T.tim[k] = T.tmi[k] = T.tii[k] = T.tmd[k] = T.tdd[k] = 0.f;
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

// One stripe of one (read, haplotype) pair. hs: the haplotype's H bases in
// shared memory. Stripe s of n_stripes covers read rows s*kStripe+1 ..; nl
// lanes hold rows of it; kL is the row L within this lane's rows on the last
// stripe (-1 elsewhere). rd/wr: the bottom-row buffers ([3][H1] floats: M, X,
// Y) read from the previous stripe and written for the next (write_bnd).
// Adds this lane's part of the final-row sum of M + X over j = 1..H to acc
// (by reference: returning a per-stripe partial sum timed slower on the card).
//
// kHapNMismatch: false scores an N on either side as a match (the host f64
// rule, pairhmm_model.py:82); true scores a haplotype N as a mismatch unless
// the read base is N too (gatk_tpu's kernels v2, v4-v7, whose tables force
// only a read N to match).
template <bool kHapNMismatch>
__device__ __forceinline__ void sweep_stripe(float& acc, const Tables& T,
                                             const unsigned char* hs, int H, int H1, float y0,
                                             int s, int nl, int kL, int lane, const float* rd,
                                             float* wr, bool write_bnd) {
  float M[kRows], X[kRows], Y[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) M[k] = X[k] = Y[k] = 0.f;  // column 0
  // the row above this lane's rows at column j-1 (starts at column 0, where
  // only row 0 is nonzero: Y = y0)
  float upM = 0.f, upX = 0.f, upY = (s == 0 && lane == 0) ? y0 : 0.f;
  float pubM = 0.f, pubX = 0.f, pubY = 0.f;  // this lane's bottom row, its last column
  const int steps = H + nl - 1;
  for (int t = 1; t <= steps; ++t) {
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
        if (k == kL) acc += m_new + x_new;
      }
      upM = inM; upX = inX; upY = inY;
      pubM = M[kRows - 1]; pubX = X[kRows - 1]; pubY = Y[kRows - 1];
      if (write_bnd) {
        wr[j] = pubM; wr[H1 + j] = pubX; wr[2 * H1 + j] = pubY;
      }
    }
  }
}

// log10 of the final-row sum, or NEG_INF where it is zero.
__device__ __forceinline__ float finish(float acc) {
  return acc > 0.f ? (logf(fmaxf(acc, 1e-44f)) - kInitLn) * kInvLn10 : kNegInf;
}

}  // namespace pairhmm

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
