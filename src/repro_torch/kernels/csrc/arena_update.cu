// Block tECS builder step for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/arena_update.py:
// arena_update_pallas (body _arena_update_kernel, step function
// src/repro/kernels/ref.py:arena_block_step).  For each event of a lane it
// clears and seeds the ring slot j mod W (or applies the precomputed time
// eviction mask), folds the K tabulated predecessor edges of every target
// state through the union gadgets (Fig. 5a-d), writes the event's node
// records on virtual ids, builds one enumeration root per query at hits
// (same-slot final folds, then the Fig. 5e right-chain over E = eps+1 slots
// in decreasing start order) and applies the CONSUME clear after the roots.
// The plain PyTorch version is repro_torch/kernels/ref.py:arena_build_ref;
// the two agree bit for bit (int32 ids only).
//
// What bounds it on this card: the output contract is a dense (B', steps, M)
// int32 record row for each of valid/left/right, so the bytes that must be
// written (3.B'.steps.M.4) dwarf the integer work, which is a few operations
// per (slot, state, predecessor edge): the floor is the memory rate.
// What the design does about it: the record rows are filled once with their
// canonical empty value by the wrapper (valid 0, left/right NULL) and the
// kernel writes only the entries of nodes that are allocated, a small share
// of M.  One block per (segmented) lane loops over the steps, as the TPU's
// sequential grid axis did.  Each thread owns ring slots w = tid,
// tid + blockDim, ...: seed, expire, the folds, the same-slot root folds and
// the CONSUME clear of cell (w, s) read only cells of slot w, so they need no
// synchronisation.  The cell table (4.W.S int32 a lane, 359 KB at W=3208,
// S=7) exceeds shared memory, so it stays in global memory (L2-resident),
// double-buffered: a step reads the pre-fold table and writes the other
// buffer.  The only cross-slot work is the right-chain at hit steps: one
// warp per query scans the chain with warp shuffles (count of valid slots
// and last valid position).  Dead steps and steps without a hit skip their
// work, uniformly per block, which is exact because the rows are canonical.
//
// Build: see repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, linked with the other kernels into one
// library).  The C entry point returns a cudaError_t value (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = kThreads / 32;  // one warp per query for the chain
constexpr int kNull = -1;

struct Args {
  int* cells[4];        // (B', W, S) id / is-union / left / right, in+out
  int* alt[4];          // (B', W, S) second buffer of the cell table
  int* sa;              // (B', W, Q) same-slot root id per (slot, query)
  const int* cls;       // (steps, B')
  const int* hit;       // (steps, B', Q)
  const int* j;         // (steps, B')
  const int* live;      // (steps, B')
  const int* vb;        // (steps, B') virtual id of layout slot 0
  const int* expire;    // (steps, B', W) or null
  const int* consume;   // (steps, B', S) or null
  const int* ptab;      // (C, S, K, 3) source, marking, valid
  const int* tabs;      // layout tables, see the offsets below
  int* valid;           // (B', steps, M)
  int* left;            // (B', steps, M)
  int* right;           // (B', steps, M)
  int* roots;           // (B', steps, Q)
  int Bn, steps, W, S, K, Q, M, epsilon, off_bottom, off_chain, ntab;
};

struct Cell {
  int id, u, l, r;
};

// Python's sign rule: the result lies in [0, W) for negative x too.
__device__ __forceinline__ int pymod(long long x, int W) {
  long long r = x % W;
  return static_cast<int>(r < 0 ? r + W : r);
}

__device__ __forceinline__ void put(const Args& a, size_t rec, int slot,
                                    int l, int r) {
  a.valid[rec + slot] = 1;
  a.left[rec + slot] = l;
  a.right[rec + slot] = r;
}

// acc <- union(acc, c) for a participating contributor c: the gadget's
// slots are base, base+1, base+2 of the record row, with virtual ids
// v0, v0+1, v0+2 (ref.py:_union_gadget).
__device__ __forceinline__ void gadget(Cell& acc, const Cell& c, int v0,
                                       const Args& a, size_t rec, int base) {
  if (acc.id == kNull) {
    acc = c;
    return;
  }
  if (acc.u > 0 && c.u > 0) {  // (c)/(d): union x union splice
    put(a, rec, base, acc.r, c.r);
    put(a, rec, base + 1, c.l, v0);
    put(a, rec, base + 2, acc.l, v0 + 1);
    acc = Cell{v0 + 2, 1, acc.l, v0 + 1};
  } else {  // (a): acc non-union -> left = acc; (b): left = contrib
    const bool case_a = acc.u == 0;
    const int l1 = case_a ? acc.id : c.id;
    const int r1 = case_a ? c.id : acc.id;
    put(a, rec, base, l1, r1);
    acc = Cell{v0, 1, l1, r1};
  }
}

__global__ void __launch_bounds__(kThreads)
arena_update_kernel(const Args a) {
  extern __shared__ int smem[];
  const int S = a.S, K = a.K, Q = a.Q, W = a.W, Bn = a.Bn;
  // layout tables (built by the wrapper from ArenaBlockLayout)
  int* sTab = smem;
  const int* rank_ext = sTab;              // (K, S), -1 where absent
  const int* rank_uni = rank_ext + K * S;  // (K, S)
  const int* off_ext = rank_uni + K * S;   // (K,)
  const int* off_uni = off_ext + K;        // (K,)
  const int* n_ext = off_uni + K;          // (K,)
  const int* n_uni = n_ext + K;            // (K,)
  const int* fs_off = n_uni + K;           // (S,) -2 / -1 / region offset
  const int* init = fs_off + S;            // (S,) 0/1 seed targets
  const int* finals = init + S;            // (S, Q) 0/1
  int* sPt = sTab + a.ntab;                // (S, K, 3) this step's class
  int* sCon = sPt + S * K * 3;             // (S,) this step's clear mask
  int* sHit = sCon + S;                    // (Q,)

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < a.ntab; i += nth) sTab[i] = a.tabs[i];

  const size_t lane_cells = static_cast<size_t>(b) * W * S;
  int* cur[4];
  int* nxt[4];
  for (int f = 0; f < 4; ++f) {
    cur[f] = a.cells[f] + lane_cells;
    nxt[f] = a.alt[f] + lane_cells;
  }
  int* sa = a.sa + static_cast<size_t>(b) * W * Q;
  bool flipped = false;

  for (int t = 0; t < a.steps; ++t) {
    const size_t tb = static_cast<size_t>(t) * Bn + b;
    if (a.live[tb] == 0) continue;  // dead step: rows stay canonical
    const int cls = a.cls[tb];
    const long long jj = a.j[tb];
    const int vb = a.vb[tb];
    __syncthreads();  // every read of the previous step's tables is done
    const int* pt = a.ptab + static_cast<size_t>(cls) * S * K * 3;
    for (int i = tid; i < S * K * 3; i += nth) sPt[i] = pt[i];
    for (int i = tid; i < S; i += nth)
      sCon[i] = a.consume ? a.consume[tb * S + i] : 0;
    for (int i = tid; i < Q; i += nth) sHit[i] = a.hit[tb * Q + i];
    __syncthreads();
    bool any_hit = false;
    for (int q = 0; q < Q; ++q) any_hit |= sHit[q] > 0;

    const size_t rec = (static_cast<size_t>(b) * a.steps + t) * a.M;
    if (tid == 0) a.valid[rec + a.off_bottom] = 1;  // new_bottom(j)
    const int jm = pymod(jj, W);
    const int em = pymod(jj - a.epsilon - 1, W);

    for (int w = tid; w < W; w += nth) {
      const bool seed = w == jm;
      const bool expire =
          a.expire ? a.expire[tb * W + w] > 0 : w == em;
      const bool clear = seed || expire;
      const size_t row = static_cast<size_t>(w) * S;

      // -- predecessor folds, reading the pre-fold (cleared, seeded) slot --
      for (int s = 0; s < S; ++s) {
        Cell acc{kNull, 0, kNull, kNull};
        for (int k = 0; k < K; ++k) {
          const int* p3 = sPt + (s * K + k) * 3;
          if (p3[2] <= 0) continue;
          const int p = min(max(p3[0], 0), S - 1);
          Cell src{clear ? kNull : cur[0][row + p], cur[1][row + p],
                   cur[2][row + p], cur[3][row + p]};
          if (seed && init[p]) {
            src.id = vb + a.off_bottom;
            src.u = 0;
          }
          if (src.id == kNull) continue;
          Cell c = src;
          if (p3[1] > 0) {  // marking edge: extend
            const int slot = off_ext[k] + w * n_ext[k] + rank_ext[k * S + s];
            a.valid[rec + slot] = 1;
            a.left[rec + slot] = src.id;
            c = Cell{vb + slot, 0, src.l, src.r};
          }
          const int base =
              off_uni[k] + 3 * (w * n_uni[k] + rank_uni[k * S + s]);
          gadget(acc, c, vb + base, a, rec, base);
        }
        nxt[0][row + s] = acc.id;
        nxt[1][row + s] = acc.u;
        nxt[2][row + s] = acc.l;
        nxt[3][row + s] = acc.r;
      }

      // -- same-slot root folds over the post-fold cells ----------------
      if (any_hit) {
        for (int q = 0; q < Q; ++q) {
          Cell acc{kNull, 0, kNull, kNull};
          if (sHit[q] > 0) {
            for (int s = 0; s < S; ++s) {
              const int fo = fs_off[s];
              if (fo == -2 || !finals[s * Q + q]) continue;
              const Cell c{nxt[0][row + s], nxt[1][row + s], nxt[2][row + s],
                           nxt[3][row + s]};
              if (c.id == kNull) continue;
              const int base = fo + 3 * (w * Q + q);
              gadget(acc, c, vb + base, a, rec, base);
            }
          }
          sa[static_cast<size_t>(w) * Q + q] = acc.id;
        }
      }

      // -- CONSUME BY ANY: clear the flagged states' ids after the roots --
      for (int s = 0; s < S; ++s)
        if (sCon[s] > 0) nxt[0][row + s] = kNull;
    }
    for (int f = 0; f < 4; ++f) {
      int* tmp = cur[f];
      cur[f] = nxt[f];
      nxt[f] = tmp;
    }
    flipped = !flipped;
    if (!any_hit) continue;

    // -- right-chain: one warp per query, oldest start first ---------------
    __syncthreads();  // every slot's same-slot root is in sa
    if (warp < Q && sHit[warp] > 0) {
      const int q = warp;
      const int E = a.epsilon + 1;
      const int seg = (E + 31) / 32;
      const int lo = min(E, lane * seg), hi = min(E, lo + seg);
      auto mid = [&](int e) {
        return sa[static_cast<size_t>(pymod(jj - (a.epsilon - e), W)) * Q + q];
      };
      auto vchain = [&](int e) { return a.off_chain + e * Q + q; };
      int cnt = 0, last = -1;
      for (int e = lo; e < hi; ++e)
        if (mid(e) != kNull) {
          ++cnt;
          last = e;
        }
      int inc = cnt, mx = last;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, off);
        const int z = __shfl_up_sync(0xffffffffu, mx, off);
        if (lane >= off) {
          inc += y;
          mx = max(mx, z);
        }
      }
      int before = __shfl_up_sync(0xffffffffu, mx, 1);
      if (lane == 0) before = -1;
      int rank = inc - cnt;
      // element of the last valid slot before this lane's segment
      int prev = before < 0 ? kNull
                            : (rank == 1 ? mid(before) : vb + vchain(before));
      for (int e = lo; e < hi; ++e) {
        const int m = mid(e);
        if (m == kNull) continue;
        if (++rank >= 2) {
          put(a, rec, vchain(e), m, prev);
          prev = vb + vchain(e);
        } else {
          prev = m;
        }
      }
      const int total = __shfl_sync(0xffffffffu, inc, 31);
      const int last_all = __shfl_sync(0xffffffffu, mx, 31);
      if (lane == 0 && last_all >= 0)
        a.roots[(static_cast<size_t>(b) * a.steps + t) * Q + q] =
            total == 1 ? mid(last_all) : vb + vchain(last_all);
    }
  }

  if (flipped) {  // the final table is in the second buffer: copy it back
    for (int w = tid; w < W; w += nth)
      for (int s = 0; s < S; ++s)
        for (int f = 0; f < 4; ++f)
          nxt[f][static_cast<size_t>(w) * S + s] =
              cur[f][static_cast<size_t>(w) * S + s];
  }
}

}  // namespace

extern "C" {

int arena_update_launch(int* cid, int* cu, int* cl, int* cr, int* aid,
                        int* au, int* al, int* ar, int* sa, const int* cls,
                        const int* hit, const int* j, const int* live,
                        const int* vb, const int* expire, const int* consume,
                        const int* ptab, const int* tabs, int ntab,
                        int* valid, int* left, int* right, int* roots, int Bn,
                        int steps, int W, int S, int K, int Q, int M,
                        int epsilon, int off_bottom, int off_chain,
                        void* stream) {
  if (Bn < 1 || steps < 0 || W < 1 || S < 1 || K < 1 || Q < 1 ||
      Q > kMaxQ || M < 1 || epsilon < 0)
    return cudaErrorInvalidValue;
  Args a{{cid, cu, cl, cr}, {aid, au, al, ar}, sa, cls, hit, j, live, vb,
         expire, consume, ptab, tabs, valid, left, right, roots,
         Bn, steps, W, S, K, Q, M, epsilon, off_bottom, off_chain, ntab};
  const size_t smem =
      static_cast<size_t>(ntab + S * K * 3 + S + Q) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      arena_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  arena_update_kernel<<<Bn, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
