// Device helpers shared by the two counting-scan kernels (fused_scan.cu and
// cea_scan.cu): the wide row update for packs past 32 states, and the
// per-query sums read back from the updated rows.
//
// The narrow builds (8, 16 and 32 states) keep a slot's whole row in
// registers (cin[MAXS], cout[MAXS]).  Past 32 states that no longer fits, so
// the wide build (up to kMaxStates, the reference's MAX_DET_STATES) first
// copies the old row's non-zero run counts into a per-thread list (local
// memory), then computes the new row in tiles of kTileS output states held in
// registers and stores each tile straight into the row: every tile reads the
// old row from the list, never from the row it overwrites.  M_all[class] is
// read from global memory (L2-resident), since a 512-state matrix (1 MB)
// cannot be staged in shared memory.
//
// Queries are emitted in groups of kQG: one register set of partial sums
// per group, so a pack of any size takes the same registers.
#pragma once

#include <climits>

namespace {

constexpr int kQG = 8;             // queries per emission group
constexpr int kMaxStates = 512;    // the wide build's bound (MAX_DET_STATES)
constexpr int kTileS = 32;         // output states per register tile

// The seed of state s: the multi-hot mask, or one-hot at init_state.
__device__ __forceinline__ float seed_value(const float* init, int init_state,
                                            int s) {
  return init ? __ldg(init + s) : (s == init_state ? 1.f : 0.f);
}

// C[w] <- ((clear ? 0 : C[w]) + seed.init) . M in place, for S > 32.  `Mg` is
// M_all[class] (S, S) row-major, or null for the zero matrix (an id outside
// the class table).  A row that stays zero is not rewritten.
__device__ __forceinline__ void wide_row_step(float* cw, int S, bool clear,
                                              bool seed, const float* init,
                                              int init_state,
                                              const float* __restrict__ Mg) {
  int nzs[kMaxStates];
  float nzv[kMaxStates];
  int nnz = 0;
  for (int s = 0; s < S; ++s) {
    float v = clear ? 0.f : cw[s];
    if (seed) v += seed_value(init, init_state, s);
    if (v != 0.f) {
      nzs[nnz] = s;
      nzv[nnz] = v;
      ++nnz;
    }
  }
  if (nnz == 0 && !clear) return;  // zero before, zero after
  if (Mg == nullptr) nnz = 0;
  for (int u0 = 0; u0 < S; u0 += kTileS) {
    const int lim = S - u0;
    float cout[kTileS];
#pragma unroll
    for (int u = 0; u < kTileS; ++u) cout[u] = 0.f;
    for (int i = 0; i < nnz; ++i) {
      const float v = nzv[i];
      const float* mr = Mg + static_cast<size_t>(nzs[i]) * S + u0;
#pragma unroll
      for (int u = 0; u < kTileS; ++u)
        if (u < lim) cout[u] += v * __ldg(mr + u);
    }
#pragma unroll
    for (int u = 0; u < kTileS; ++u)
      if (u < lim) cw[u0 + u] = cout[u];
  }
}

// Sums of queries [q0, q0 + nq) over this thread's slots wl = tid, tid + nth,
// ... < n of a ring (row stride rs), read back from the updated rows, with
// finals (NQ, S) in global memory.  With kLast, also the youngest slot with
// a positive count per query: ages (jm - w) mod W of global slots w0 + wl.
template <bool kLast>
__device__ __forceinline__ void group_sums(const float* ring, int rs, int n,
                                           int tid, int nth, int S,
                                           const float* __restrict__ finals,
                                           int q0, int nq, int jm, int w0,
                                           int W, float* psum, float* pval,
                                           int* page) {
#pragma unroll
  for (int q = 0; q < kQG; ++q) {
    psum[q] = 0.f;
    if (kLast) {
      pval[q] = 0.f;
      page[q] = INT_MAX;
    }
  }
  for (int wl = tid; wl < n; wl += nth) {
    const float* cw = ring + static_cast<size_t>(wl) * rs;
    float v[kQG];
#pragma unroll
    for (int q = 0; q < kQG; ++q) v[q] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float c = cw[s];
      if (c != 0.f) {
#pragma unroll
        for (int q = 0; q < kQG; ++q)
          if (q < nq)
            v[q] += c * __ldg(finals + static_cast<size_t>(q0 + q) * S + s);
      }
    }
    int age = 0;
    if (kLast) {
      age = jm - (w0 + wl);
      if (age < 0) age += W;
    }
#pragma unroll
    for (int q = 0; q < kQG; ++q) {
      if (q < nq) {
        psum[q] += v[q];
        if (kLast && v[q] > 0.f && age < page[q]) {
          page[q] = age;
          pval[q] = v[q];
        }
      }
    }
  }
}

}  // namespace
