// Fused windowed counting scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_scan.py:fused_scan_pallas
// (body _fused_scan_kernel).  Per event of a lane it evaluates the k
// predicates on the event's attribute row, folds the bits into a symbol class
// through class_of, takes M = M_all[class], evicts and seeds the (W, S) ring
// of run counts (count rule, or the timestamp-ring mask with the ovf latch),
// advances C <- C.M, reduces per-query counts over the ring (LAST: the
// count at the youngest slot with a positive count) and, for CONSUME BY ANY,
// clears the consuming query's states after it emits.  Steps t >= valid[b]
// leave the lane's state untouched and emit 0.
//
// What bounds it on this card: per event the work is W.S.S multiply-adds in
// dense form (at most W.S.2 useful ones, since a column of M_all[c] of a
// packed Fig. 8 table has at most two non-zeros) against only A + NQ floats
// of device-memory traffic; the (W, S) state itself need cross device memory
// only once per chunk.  So the floor is the f32 arithmetic (about 67
// TFLOP/s), not the 3.35 TB/s memory, as long as the ring stays on chip;
// what the dense form pays for, though, is shared-memory instructions, one
// load of M a multiply-add.
// What the design does about it: the TPU's sequential grid axis becomes a
// loop over the chunk's T events inside a block.  A lane's ring is cut into
// n_split contiguous segments of L = ceil(W / n_split) slots (the last may
// be shorter), one block each (grid (B, n_split)).  Ring slots are
// independent of each other: seeding, count-window and time-window expiry
// are per slot (tested against global slot indices, with Python's sign rule
// via pymod) and the ovf latch is an OR, so a block owns its segment
// outright.  Each block stages its share, W/n_split.(S|1) floats plus the
// ts share of a time window, into shared memory for the whole chunk, and
// writes it back once at the end; the wrapper (plan_ring in fused_scan.py)
// picks the smallest n_split whose share fits.  The per-query count of an
// event is the one thing the segments share: each block reduces its partial
// sum (warp shuffles, then one value per warp), and with n_split > 1
// thread 0 adds it to the zeroed output with atomicAdd.  LAST and CONSUME
// BY ANY need a lane-wide decision per event (the youngest positive slot;
// clearing states after any query emits), so they run with n_split = 1:
// their ring in shared memory when it fits, else in global memory
// (L2-resident), read and written per event.  Within a block each thread
// owns slots w = tid, tid + blockDim.x, ..., so slot updates need no
// synchronisation.  Before its events the block evaluates the predicates of
// a tile of up to kTile events, one event per thread, into a shared class
// table (segment 0 also writes the trace).  The class lookup is a direct
// gather (the TPU kernel's one-hot matmuls avoided gathers).
//
// The step.  Rows of up to 32 states take the narrow builds (8, 16 and 32
// states).  In the 32-state build a table whose columns and finals have at
// most kMaxDeg non-zeros, all 1, takes the sparse step (its own
// instantiation, kSparse): the wrapper builds, once per table
// (packed_lists in fused_scan.py), one 32-bit word per class and output
// state u holding u's sources as bytes, ascending, 0xFF past its
// in-degree, and one word per query of its final states.  Per event the
// block stages the class's words and every thread keeps them in registers;
// per slot it gathers cout[u] = sum of C[w][src] over u's bytes from the
// row where it lives (shared memory, or global memory on the LAST/CONSUME
// route), each gather predicated on its byte, so an empty column costs no
// load.  kSlots rows go through at once, their gathers independent, and
// nothing branches on u or q: the loads issue back to back.  cout stays in
// registers with static indices until it is stored, then each query of the
// first group reads its final states from the stored row.  Clear and seed
// are applied to the row before the gather.  The terms come in the dense
// product's order, so every result equals the plain PyTorch version bit
// for bit.  What bounds the sparse step is instructions: about five a
// gather (the byte, the predicate, the address, the load, the add), issued
// by 8 warps an SM whose loads wait on shared memory.  Other tables, and
// the 8- and 16-state builds, whose short rows make the dense product as
// fast, keep it: M_all[class] staged in shared memory, a kRow x kRow
// product that skips zero run counts, and a kRow-long dot per query.  The
// words live in the dense matrix's shared array, so neither instantiation
// takes more static shared memory than the dense one that plan_ring is
// given.  Wider packs, up to 512 states, take the wide build of
// scan_row.cuh (tiles of 32 output states, M_all read from L2).  Queries
// are emitted in groups of 8, so a pack of any size takes the same
// registers; the first group of a narrow build reads the row just written,
// the others read the updated rows back, and LAST's arg-min and CONSUME's
// clear mask are taken group by group; one thread a query merges the
// warps' partial counts.  Counts are f32 integers, exact below 2^24
// whatever the order of summation.  wgmma, TMA and thread-block clusters
// are left for later work.
//
// Build: see repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, linked with the other kernels into one
// library).  The C entry points return cudaError_t values (0 = success).

#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"
#include "scan_row.cuh"

namespace {

// predicates per call (2^16 class_of rows): a query compiles to at most
// 14, and a fleet bucket pads 13 or 14 live ones to 16 dead-padded
constexpr int kMaxBits = 16;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTile = 256;      // events whose classes are tabled at once
constexpr int kMaxSplit = 65535;  // grid y
// the longest column or finals list of the sparse step (fused_scan.py
// SPARSE_CAP): kMaxDeg one-byte sources fill a state's 32-bit word
constexpr int kMaxDeg = 4;
constexpr int kNone = 0xFF;  // a list's empty byte
constexpr int kSparseRow = 32;  // the build that takes the sparse step
// ring slots a thread steps at once in the sparse step: their gathers
// overlap, and they share the decoding of each list byte
constexpr int kSlots = 4;

struct Specs {
  int k;
  int col[kMaxBits];
  int op[kMaxBits];
  float thr[kMaxBits];
};

struct Args {
  const float* attrs;       // (T, B, A)
  const int* class_of;      // (2^k,)
  const float* m_all;       // (C, S, S)
  const float* finals;      // (NQ, S)
  const int* trans;         // (C, S) packed column lists, or null
  const int* flist;         // (NQ,) packed final-state lists
  const float* init;        // (S,)
  const float* latest;      // (NQ,) or null
  const float* consume;     // (NQ, S) or null
  float* c;                 // (B, W, S), updated in place
  float* ts_ring;           // (B, W), updated in place (time windows)
  unsigned char* ovf;       // (B,), latched in place (time windows)
  const float* event_ts;    // (T, B) (time windows)
  const int* start;         // (B,)
  const int* valid;         // (B,)
  float* matches;           // (T, B, NQ); zeroed by the caller if n_split > 1
  int* trace;               // (T, B) or null
  int T, B, A, S, NQ, W, epsilon;
  float time_size;
  int timed;
  int use_smem;
  int n_split;              // blocks per lane (grid y)
  int deg;                  // sources a state (bytes a word); 0: dense
  int fdeg;                 // final states a query (bytes a word)
};

// kSlots slots' sparse step, in place: each live row cw[r] <- ((clear ?
// 0 : cw[r]) + seed.init) . M, M[class] given by its column lists: lst[u]
// holds the sources of output state u as bytes, ascending, kNone past its
// in-degree (and for the padding states u >= S); every weight is 1.  Then
// fv[r][q] = the first query group's counts, from the final-state lists
// fl[q] (kNone for q >= NQ).  Nothing branches on u or q: the gathers of
// all rows and states issue back to back, each predicated on its byte, so
// an empty column costs no shared-memory access.  A dead slot (live[r]
// false) reads row 0 and writes nothing.  The terms are added in the dense
// product's order (ascending source), so the sums are the same.
template <int kRow, int kSlots>
__device__ __forceinline__ void sparse_rows_step(
    float* const* cw, const bool* live, int S, const int* lst, int deg,
    const int* fl, int fdeg, float (*fv)[kQG]) {
  float cout[kSlots][kRow];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
#pragma unroll
    for (int u = 0; u < kRow; ++u) cout[r][u] = 0.f;
  // sources two at a time: each pair's loads issue before their adds
  for (int k = 0; k < deg; k += 2) {
#pragma unroll
    for (int u = 0; u < kRow; ++u) {
      const int word = lst[u] >> (8 * k);
      const int s0 = word & 0xFF, s1 = (word >> 8) & 0xFF;
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const float x0 = s0 != kNone ? cw[r][s0] : 0.f;
        const float x1 = s1 != kNone ? cw[r][s1] : 0.f;
        cout[r][u] += x0;
        cout[r][u] += x1;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (live[r])
#pragma unroll
      for (int u = 0; u < kRow; ++u)
        if (u < S) cw[r][u] = cout[r][u];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
#pragma unroll
    for (int q = 0; q < kQG; ++q) fv[r][q] = 0.f;
  for (int k = 0; k < fdeg; ++k) {
#pragma unroll
    for (int q = 0; q < kQG; ++q) {
      const int f = (fl[q] >> (8 * k)) & 0xFF;
#pragma unroll
      for (int r = 0; r < kSlots; ++r)
        fv[r][q] += f != kNone ? cw[r][f] : 0.f;
    }
  }
}

// MAXS is the state bucket: 8, 16 and 32 keep a slot's row in registers;
// kMaxStates is the wide build (scan_row.cuh).  kMany: more than kQG
// queries, emitted group by group (always so in the wide build).  Packs of
// up to kQG queries take a narrow build without the group loop, which
// would cost registers in the slot loop (8 states: 80 -> 101 a thread).
// kSparse: the sparse step (narrow builds, a table the wrapper gave lists
// for); its own instantiation, so neither step's registers constrain the
// other's.
template <int MAXS, bool kMany, bool kSparse>
__global__ void __launch_bounds__(kMaxThreads)
fused_scan_kernel(const Args a, const Specs sp) {
  constexpr bool kWide = MAXS > 32;
  static_assert(!kSparse || MAXS == kSparseRow,
                "only the 32-state build has the sparse step");
  constexpr int kRow = kWide ? 1 : MAXS;  // staged row width (narrow only)
  extern __shared__ float ring_smem[];
  // M_all[class] zero-padded, or its column lists (one word a state,
  // loaded as vectors)
  __shared__ __align__(16) float sM[kRow * kRow];
  __shared__ float sF[kQG * kRow];      // finals of the first query group
  __shared__ float sInit[kRow];
  __shared__ float sClr[MAXS];          // CONSUME: states to clear
  __shared__ float rSum[kMaxWarps][kQG];
  __shared__ int rAge[kMaxWarps][kQG];
  __shared__ float rVal[kMaxWarps][kQG];
  __shared__ int sCls[kTile];           // the tile's classes
  __shared__ float sTs[kTile];          // the tile's timestamps

  const int b = blockIdx.x, seg = blockIdx.y;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int S = a.S, W = a.W, NQ = a.NQ, B = a.B;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const bool split = a.n_split > 1;
  // this block's segment of the lane's ring: global slots [w0, w0 + n)
  const int L = (W + a.n_split - 1) / a.n_split;
  const int w0 = seg * L;
  const int n = min(L, W - w0);
  int* sL = reinterpret_cast<int*>(sM);
  // the first query group's final-state lists, for the whole launch
  int fl[kQG];
#pragma unroll
  for (int q = 0; q < kQG; ++q) fl[q] = kSparse && q < NQ ? a.flist[q] : -1;

  if (!kSparse && !kWide) {
    for (int i = tid; i < kRow * kRow; i += nth) sM[i] = 0.f;
    for (int i = tid; i < kQG * kRow; i += nth) {
      const int q = i / kRow, s = i % kRow;
      sF[i] = (q < NQ && s < S) ? a.finals[q * S + s] : 0.f;
    }
  }
  if (!kWide)
    for (int i = tid; i < kRow; i += nth) sInit[i] = i < S ? a.init[i] : 0.f;

  // The segment: staged into shared memory, or used in place.
  float* cg = a.c + (static_cast<size_t>(b) * W + w0) * S;
  float* tsg =
      a.timed ? a.ts_ring + static_cast<size_t>(b) * W + w0 : nullptr;
  float* ring = cg;
  float* tsr = tsg;
  int rs = S;  // ring row stride in floats
  if (a.use_smem) {
    rs = S | 1;  // odd stride: neighbouring slots hit different banks
    ring = ring_smem;
    tsr = a.timed ? ring_smem + static_cast<size_t>(n) * rs : nullptr;
    for (int i = tid; i < n * S; i += nth) ring[(i / S) * rs + i % S] = cg[i];
    if (tsr)
      for (int w = tid; w < n; w += nth) tsr[w] = tsg[w];
  }

  const int start = a.start[b];
  const int valid = a.valid[b];
  for (int t0 = 0; t0 < a.T; t0 += kTile) {
    const int tn = min(kTile, a.T - t0);
    __syncthreads();  // staging done; the previous tile's table is read
    // the tile's predicates and classes, one event per thread
    for (int i = tid; i < tn; i += nth) {
      const size_t tb = static_cast<size_t>(t0 + i) * B + b;
      const float* row = a.attrs + tb * a.A;
      int bits = 0;
      for (int j = 0; j < sp.k; ++j)
        bits |= static_cast<int>(compare(sp.op[j], row[sp.col[j]], sp.thr[j]))
                << j;
      const int cls = a.class_of[bits];
      sCls[i] = cls;
      if (seg == 0 && a.trace) a.trace[tb] = cls;
      if (a.timed) sTs[i] = a.event_ts[tb];
    }
    __syncthreads();  // table ready

    for (int i = 0; i < tn; ++i) {
      const int t = t0 + i;
      const size_t tb = static_cast<size_t>(t) * B + b;
      if (t >= valid) {  // dead step: state untouched, zero counts
        if (!split)
          for (int q = tid; q < NQ; q += nth) a.matches[tb * NQ + q] = 0.f;
        continue;
      }
      const float* Mg = a.m_all + static_cast<size_t>(sCls[i]) * S * S;
      if constexpr (kSparse) {  // padding states u >= S: empty lists
        // by the last threads: thread 0's warp merges the counts
        const int* Lg = a.trans + static_cast<size_t>(sCls[i]) * S;
        for (int u = nth - 1 - tid; u < kRow; u += nth)
          sL[u] = u < S ? __ldg(Lg + u) : -1;
      } else if (!kWide) {
        for (int x = tid; x < S * S; x += nth)
          sM[(x / S) * kRow + x % S] = Mg[x];
      }
      float ts_t = 0.f, bound = 0.f;
      if (a.timed) {
        ts_t = sTs[i];
        bound = ts_t - a.time_size;  // f32, as the plain version computes it
      }
      const long long j = static_cast<long long>(start) + t;
      const int jm = pymod(j, W);
      const int em = pymod(j - a.epsilon - 1, W);
      __syncthreads();  // sM (or the lists) ready

      // per-query partials of the current group of kQG queries
      float psum[kQG], pval[kQG];
      int page[kQG];
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        psum[q] = 0.f;
        pval[q] = 0.f;
        page[q] = INT_MAX;
      }
      bool over = false;
      if constexpr (kSparse) {
        // slot wl's window rule: seeded at jm, cleared when seeded or
        // expired; a time window stamps the seed and may latch ovf
        auto slot_flags = [&](int wl, bool& seed, bool& clear) {
          const int w = w0 + wl;
          seed = w == jm;
          if (a.timed) {
            const bool expire = tsr[wl] < bound;
            over |= seed && !expire;
            clear = seed || expire;
            if (seed) tsr[wl] = ts_t;
          } else {
            clear = seed || w == em;
          }
        };
        // the first query group's counts at global slot w: its sums and,
        // for LAST, the youngest positive slot
        auto add_counts = [&](int w, const float* fv) {
          int age = jm - w;
          if (age < 0) age += W;
#pragma unroll
          for (int q = 0; q < kQG; ++q) {
            if (q < NQ) {
              const float v = fv[q];
              psum[q] += v;
              if (v > 0.f && age < page[q]) {
                page[q] = age;
                pval[q] = v;
              }
            }
          }
        };
        int lst[kRow];  // the event's column lists, in registers
#pragma unroll
        for (int u = 0; u < kRow; ++u) lst[u] = sL[u];
        // rows at base + wl * stride: called with the shared ring or the
        // global one, so the compiler sees which space it gathers from
        auto step = [&](float* base, int stride) {
          for (int wl0 = tid; wl0 < n; wl0 += kSlots * nth) {
            float* cw[kSlots];
            bool live[kSlots];
#pragma unroll
            for (int r = 0; r < kSlots; ++r) {
              const int wl = wl0 + r * nth;
              live[r] = wl < n;
              cw[r] = base + static_cast<size_t>(live[r] ? wl : wl0) * stride;
              if (live[r]) {
                bool seed, clear;
                slot_flags(wl, seed, clear);
                if (clear || seed)
                  for (int s = 0; s < S; ++s)
                    cw[r][s] = (clear ? 0.f : cw[r][s]) +
                               (seed ? sInit[s] : 0.f);
              }
            }
            float fv[kSlots][kQG];
            sparse_rows_step<kRow, kSlots>(cw, live, S, lst, a.deg, fl,
                                           a.fdeg, fv);
#pragma unroll
            for (int r = 0; r < kSlots; ++r)
              if (live[r]) add_counts(w0 + wl0 + r * nth, fv[r]);
          }
        };
        if (a.use_smem)
          step(ring_smem, rs);
        else
          step(cg, S);
      } else {
        for (int wl = tid; wl < n; wl += nth) {
          const int w = w0 + wl;
          float* cw = ring + static_cast<size_t>(wl) * rs;
          const bool seed = w == jm;
          bool clear;
          if (a.timed) {
            const bool expire = tsr[wl] < bound;
            over |= seed && !expire;
            clear = seed || expire;
            if (seed) tsr[wl] = ts_t;
          } else {
            clear = seed || w == em;
          }
          if (kWide) {
            wide_row_step(cw, S, clear, seed, a.init, 0, Mg);
            continue;  // every query group reads the rows back below
          }
          float cin[kRow], cout[kRow];
#pragma unroll
          for (int s = 0; s < kRow; ++s) {
            cin[s] = (s < S && !clear) ? cw[s] : 0.f;
            if (seed) cin[s] += sInit[s];
            cout[s] = 0.f;
          }
#pragma unroll
          for (int s = 0; s < kRow; ++s) {
            const float v = cin[s];
            if (v != 0.f) {
#pragma unroll
              for (int u = 0; u < kRow; ++u) cout[u] += v * sM[s * kRow + u];
            }
          }
#pragma unroll
          for (int s = 0; s < kRow; ++s)
            if (s < S) cw[s] = cout[s];
          int age = jm - w;
          if (age < 0) age += W;
          // the first query group, from the row still in registers
#pragma unroll
          for (int q = 0; q < kQG; ++q) {
            if (q < NQ) {
              float v = 0.f;
#pragma unroll
              for (int u = 0; u < kRow; ++u) v += cout[u] * sF[q * kRow + u];
              psum[q] += v;
              if (v > 0.f && age < page[q]) {
                page[q] = age;
                pval[q] = v;
              }
            }
          }
        }
      }
      if (over) a.ovf[b] = 1;  // any segment may latch it

      // emission, kQG queries at a time
      const int q_end = (kWide || kMany) ? NQ : 1;
      for (int q0 = 0; q0 < q_end; q0 += kQG) {
        const int nq = min(kQG, NQ - q0);
        if (kWide || q0 > 0) {
          group_sums<true>(ring, rs, n, tid, nth, S, a.finals, q0, nq, jm,
                           w0, W, psum, pval, page);
          if (q0 > 0) __syncthreads();  // the previous group's partials read
        }
#pragma unroll
        for (int q = 0; q < kQG; ++q) {
          if (q < nq) {
            float sum = psum[q], val = pval[q];
            int age = page[q];
            for (int off = 16; off > 0; off >>= 1) {
              sum += __shfl_down_sync(0xffffffffu, sum, off);
              if (a.latest) {
                const int age2 = __shfl_down_sync(0xffffffffu, age, off);
                const float val2 = __shfl_down_sync(0xffffffffu, val, off);
                if (age2 < age) {
                  age = age2;
                  val = val2;
                }
              }
            }
            if (lane == 0) {
              rSum[warp][q] = sum;
              rAge[warp][q] = age;
              rVal[warp][q] = val;
            }
          }
        }
        __syncthreads();  // per-warp partials ready; every read of sM is done

        {  // one thread a query; CONSUME's clear mask adds up in order
          const int qa = a.consume ? 0 : tid;
          const int qb = a.consume ? (tid == 0 ? nq : 0) : min(tid + 1, nq);
          for (int q = qa; q < qb; ++q) {
            float sum = 0.f, val = 0.f;
            int age = INT_MAX;
            for (int wp = 0; wp < nwarps; ++wp) {
              sum += rSum[wp][q];
              if (rAge[wp][q] < age) {
                age = rAge[wp][q];
                val = rVal[wp][q];
              }
            }
            const int qq = q0 + q;
            if (split) {  // this segment's share of a sum; no LAST here
              if (sum != 0.f) atomicAdd(&a.matches[tb * NQ + qq], sum);
              continue;
            }
            const float m =
                (a.latest && a.latest[qq] > 0.f) ? (age < INT_MAX ? val : 0.f)
                                                 : sum;
            a.matches[tb * NQ + qq] = m;
            if (a.consume) {  // sClr[s] > 0: a triggered query owns s
              const float trig = m > 0.f ? 1.f : 0.f;
              const float* cr = a.consume + static_cast<size_t>(qq) * S;
              for (int s = 0; s < S; ++s)
                sClr[s] = (qq == 0 ? 0.f : sClr[s]) + trig * cr[s];
            }
          }
        }
      }
      if (a.consume) {
        __syncthreads();  // sClr ready: counts of all slots were reduced first
        for (int wl = tid; wl < n; wl += nth) {
          float* cw = ring + static_cast<size_t>(wl) * rs;
          for (int s = 0; s < S; ++s)
            if (sClr[s] > 0.f) cw[s] = 0.f;
        }
      }
    }
  }

  if (a.use_smem) {
    __syncthreads();
    for (int i = tid; i < n * S; i += nth) cg[i] = ring[(i / S) * rs + i % S];
    if (tsr)
      for (int w = tid; w < n; w += nth) tsg[w] = tsr[w];
  }
}

template <int MAXS>
cudaError_t max_dynamic_smem(int* out) {
  // both kMany flags take the same static smem; the sparse step's takes
  // less (it keeps no finals row), so this limit holds for it too
  constexpr bool kWide = MAXS > 32;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fused_scan_kernel<MAXS, kWide, false>);
  if (e != cudaSuccess) return e;
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

template <int MAXS, bool kMany, bool kSparse>
cudaError_t run(const Args& a, const Specs& sp, int threads, size_t smem,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_scan_kernel<MAXS, kMany, kSparse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B, a.n_split);
  fused_scan_kernel<MAXS, kMany, kSparse>
      <<<grid, threads, smem, stream>>>(a, sp);
  return cudaGetLastError();
}

template <int MAXS, bool kMany>
cudaError_t run_step(const Args& a, const Specs& sp, int threads,
                     size_t smem, cudaStream_t stream) {
  if constexpr (MAXS == kSparseRow)
    if (a.deg > 0) return run<MAXS, kMany, true>(a, sp, threads, smem, stream);
  return run<MAXS, kMany, false>(a, sp, threads, smem, stream);
}

template <int MAXS>
cudaError_t launch(const Args& a, const Specs& sp, int threads, size_t smem,
                   cudaStream_t stream) {
  if constexpr (MAXS > 32) {
    return run<MAXS, true, false>(a, sp, threads, smem, stream);
  } else {
    if (a.NQ > kQG) return run_step<MAXS, true>(a, sp, threads, smem, stream);
    return run_step<MAXS, false>(a, sp, threads, smem, stream);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory (bytes) a block of the instantiation for
// `max_s` states may take on the current device.
int fused_scan_max_dynamic_smem(int max_s, int* out) {
  if (max_s == 8) return max_dynamic_smem<8>(out);
  if (max_s == 16) return max_dynamic_smem<16>(out);
  if (max_s == 32) return max_dynamic_smem<32>(out);
  if (max_s == kMaxStates) return max_dynamic_smem<kMaxStates>(out);
  return cudaErrorInvalidValue;
}

// One chunk over grid (B, n_split).  With n_split > 1, `matches` must be
// zeroed and the call may take neither LAST nor CONSUME.  `trans` (C, S) and
// `flist` (NQ,) are the packed column and final-state lists of the sparse
// step (the 32-state build only; up to `deg` and `fdeg` one-byte sources a
// word), or null for the dense product.
int fused_scan_launch(const float* attrs, const int* spec_col,
                      const int* spec_op, const float* spec_thr, int k,
                      const int* class_of, const float* m_all,
                      const float* finals, const int* trans,
                      const int* flist, const float* init,
                      const float* latest, const float* consume, float* c,
                      float* ts_ring, unsigned char* ovf,
                      const float* event_ts, const int* start,
                      const int* valid, float* matches, int* trace, int T,
                      int B, int A, int S, int NQ, int W, int epsilon,
                      float time_size, int timed, int max_s, int threads,
                      int use_smem, int n_split, int deg, int fdeg,
                      void* stream) {
  if (k < 0 || k > kMaxBits || NQ < 1 || S < 1 || S > max_s ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || B < 1 ||
      W < 1 || n_split < 1 || n_split > W || n_split > kMaxSplit ||
      (n_split > 1 && (latest || consume)))
    return cudaErrorInvalidValue;
  if (trans && (max_s != kSparseRow || !flist || deg < 1 ||
                deg > kMaxDeg || fdeg < 1 || fdeg > kMaxDeg))
    return cudaErrorInvalidValue;
  if (!trans) deg = fdeg = 0;
  Specs sp;
  sp.k = k;
  for (int i = 0; i < k; ++i) {
    sp.col[i] = spec_col[i];
    sp.op[i] = spec_op[i];
    sp.thr[i] = spec_thr[i];
  }
  Args a{attrs, class_of, m_all, finals, trans, flist, init, latest,
         consume, c, ts_ring, ovf, event_ts, start, valid, matches, trace, T,
         B, A, S, NQ, W, epsilon, time_size, timed, use_smem, n_split, deg,
         fdeg};
  const size_t L = (static_cast<size_t>(W) + n_split - 1) / n_split;
  const size_t smem =
      use_smem ? (L * (S | 1) + (timed ? L : 0)) * sizeof(float) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_s == 8) return launch<8>(a, sp, threads, smem, st);
  if (max_s == 16) return launch<16>(a, sp, threads, smem, st);
  if (max_s == 32) return launch<32>(a, sp, threads, smem, st);
  if (max_s == kMaxStates)
    return launch<kMaxStates>(a, sp, threads, smem, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
