// Block tECS builder for Hopper (sm_90a), in two routes that share one fold.
//
// Replaces the TPU kernel src/repro/kernels/arena_update.py:
// arena_update_pallas (body _arena_update_kernel, step function
// src/repro/kernels/ref.py:arena_block_step).  For each event of a lane it
// clears and seeds the ring slot j mod W (or applies the precomputed time
// eviction mask), folds the K tabulated predecessor edges of every target
// state through the union gadgets (Fig. 5a-d), builds one enumeration root
// per query at hits (same-slot final folds, then the Fig. 5e right-chain
// over E = eps+1 slots in decreasing start order) and applies the CONSUME
// clear after the roots.  What it emits depends on the route:
//
//   * store (arena_store_launch, the engines' route): the kernel allocates
//     node ids itself and writes the node store (kind, pos, maxs, left,
//     right) directly, with the cell table, pointer, overflow latch and
//     roots in real ids.  Plain version: ref.py:arena_store_ref.
//   * dense (arena_update_launch, segmented chunks): the TPU kernel's
//     contract, (B', steps, M) valid/left/right records on virtual ids,
//     which the caller translates.  Plain version: ref.py:arena_build_ref.
//
// Both agree with their plain versions bit for bit (int32 ids only).
//
// Ids.  The reference assigns store ids with one chunk-level cumsum over the
// records' validity in (step, layout slot) order, so an id is the lane's
// running pointer plus the rank of the slot among the slots its step
// allocates.  Which slots a step allocates depends only on which cells are
// NULL and on their union flags (gadget (c)/(d) allocates 3 nodes, (a)/(b)
// one), never on id values.  So each live step of the store route folds
// twice over the same pre-fold buffer: a count pass sets bit m of an M-bit
// bitmap in shared memory for every slot m it would write (ids are a
// non-NULL dummy there), a block-wide exclusive scan of the words'
// popcounts ranks them, and an emit pass folds again with the id of slot m
// = ptr + rank(m), read from the bitmap, and writes each node to the store
// at that id.  A reference past capacity clamps to the sink id cap, and
// only the node whose id is exactly cap is written there, as the
// reference's translation does.  maxs comes from a (W,) table of slot
// starts in shared memory, set to the event's position at the seed slot.
//
// What bounds it on this card: the store route moves the bytes of the
// nodes it allocates (5 int32 fields each), the cell table read and written
// once and the step operands; its integer work is a few operations per live
// (slot, state, predecessor edge), twice.  Both are far below a
// millisecond per chunk at the main path's shapes: what bounds it in
// practice is the latency of one block's sequential steps, as on the TPU's
// sequential grid axis: each step is a chain of dependent shared-memory
// operations through a slot's K.S predecessor edges, twice, between seven
// barriers (eight at hit steps).  What the design does about it:
//   * one block per lane loops over the steps; warp 0 lists the step's
//     candidate slots (occupied, from a per-buffer occupancy bitmap, or
//     seeded) and the threads share the list evenly, so a step's cost
//     follows the live cells, not W.S, and no thread holds two slots while
//     another idles;
//   * a folded slot's pre-fold row is loaded in one burst into the
//     thread's column of shared memory (up to 12 states), not edge by edge;
//   * the right-chain walks the set bits of the folded-slot bitmap, one
//     warp per query (warp q % 8 with more than 8 queries), with warp
//     shuffles for the count of valid slots and the last valid position;
//   * the step's scalar operands are loaded one step ahead;
//   * a slot that went empty is written back to its canonical empty form
//     once (a dirty bitmap per buffer), so the dense route's cell tables
//     equal its plain version's bit for bit.
// The cell table (4.W.S int32 a lane) stays in global memory,
// double-buffered: a step reads the pre-fold table and writes the other.
// The layout tables, one step's predecessor table, the bitmaps, the list
// and the start table sit in dynamic shared memory; the wrapper checks them
// against the card's limit.  The dense route writes 3.B'.steps.M int32
// records, which bound it by bytes; the wrapper fills them first.
//
// Build: see repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, linked with the other kernels into one
// library).  The C entry points return a cudaError_t value (0 = success).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // warp q % kWarps builds q's chain
constexpr int kNull = -1;
constexpr int kBottom = 0, kOutput = 1, kUnion = 2;  // core/tecs.py kinds

struct Args {
  int* cells[4];        // (B', W, S) id / is-union / left / right, in+out
  int* alt[4];          // (B', W, S) second buffer of the cell table
  int* sa;              // (B', W, Q) same-slot root id per (slot, query)
  const int* cls;       // (steps, B')
  const int* hit;       // (steps, B', Q)
  const int* j;         // (steps, B')
  const int* live;      // (steps, B')
  const int* vb;        // (steps, B') dense: virtual id of layout slot 0
  const int* expire;    // (steps, B', W) or null
  const int* consume;   // (steps, B', S) or null
  const int* ptab;      // (C, S, K, 3) source, marking, valid
  const int* tabs;      // layout tables, see the offsets below
  int* roots;           // (B', steps, Q)
  int* valid;           // dense: (B', steps, M)
  int* left;            // dense: (B', steps, M)
  int* right;           // dense: (B', steps, M)
  const int* gpos;      // store: (steps, B') event positions
  const int* sstart0;   // store: (B', W) chunk-start slot starts
  int* store[5];        // store: kind, pos, maxs, left, right (B', cap+1)
  int* ptr;             // store: (B',) bump pointer, in+out
  unsigned char* ovf;   // store: (B',) overflow latch, in+out
  int Bn, steps, W, S, K, Q, M, epsilon, off_bottom, off_chain, ntab, cap;
};

struct Cell {
  int id, u, l, r;
};

__device__ __forceinline__ bool test_bit(const unsigned* m, int i) {
  return (m[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(unsigned* m, int i) {
  atomicOr(m + (i >> 5), 1u << (i & 31));
}

__device__ __forceinline__ void clear_bit(unsigned* m, int i) {
  atomicAnd(m + (i >> 5), ~(1u << (i & 31)));
}

// The dense route: records on virtual ids, the TPU kernel's contract.
struct DenseEmit {
  static constexpr bool kEmit = true;
  int* valid;
  int* left;
  int* right;  // this step's record rows
  int vb;
  __device__ int id(int slot) const { return vb + slot; }
  __device__ void put(int slot, int, int, int l, int r) const {
    valid[slot] = 1;
    left[slot] = l;
    right[slot] = r;
  }
};

// The store route's count pass: marks the slots the step allocates.  Its
// ids are a non-NULL dummy: the fold reads ids only for NULL tests.
struct CountEmit {
  static constexpr bool kEmit = false;
  unsigned* bits;
  __device__ int id(int) const { return 0; }
  __device__ void put(int slot, int, int, int, int) const {
    set_bit(bits, slot);
  }
};

// The store route's emit pass: slot m gets real id ptr + rank(m) (clamped
// to the sink cap in references) and its node lands in the store when its
// id is at most cap.
struct StoreEmit {
  static constexpr bool kEmit = true;
  const unsigned* bits;
  const int* pre;    // exclusive prefix of the bitmap words' popcounts
  const int* start;  // (W,) slot starts
  int* kind;
  int* pos;
  int* maxs;
  int* left;
  int* right;  // this lane's store rows
  long long base;
  int cap, gp;
  __device__ long long real(int slot) const {
    const unsigned below = bits[slot >> 5] & ((1u << (slot & 31)) - 1u);
    return base + pre[slot >> 5] + __popc(below);
  }
  __device__ int id(int slot) const {
    const long long r = real(slot);
    return r < cap ? static_cast<int>(r) : cap;
  }
  __device__ void put(int slot, int k, int w, int l, int r) const {
    const long long x = real(slot);
    if (x > cap) return;
    kind[x] = k;
    pos[x] = k == kUnion ? kNull : gp;
    maxs[x] = k == kBottom ? gp : start[w];
    left[x] = l;
    right[x] = r;
  }
};

// acc <- union(acc, c) for a participating contributor c: the gadget's
// slots are base, base+1, base+2 of the step's layout (ref.py:_union_gadget).
template <class Em>
__device__ __forceinline__ void gadget(Cell& acc, const Cell& c,
                                       const Em& em, int base, int w) {
  if (acc.id == kNull) {
    acc = c;
    return;
  }
  if (acc.u > 0 && c.u > 0) {  // (c)/(d): union x union splice
    em.put(base, kUnion, w, acc.r, c.r);
    em.put(base + 1, kUnion, w, c.l, em.id(base));
    em.put(base + 2, kUnion, w, acc.l, em.id(base + 1));
    acc = Cell{em.id(base + 2), 1, acc.l, em.id(base + 1)};
  } else {  // (a): acc non-union -> left = acc; (b): left = contrib
    const bool case_a = acc.u == 0;
    const int l1 = case_a ? acc.id : c.id;
    const int r1 = case_a ? c.id : acc.id;
    em.put(base, kUnion, w, l1, r1);
    acc = Cell{em.id(base), 1, l1, r1};
  }
}

__host__ __device__ __forceinline__ int words(int n) {
  return (n + 31) / 32;
}

// Lanes of up to kStageStates states stage each folded slot's pre-fold row
// in shared memory (4.S ints a thread, 28 KB a block at S = 7).
constexpr int kStageStates = 12;
__host__ __device__ __forceinline__ int stage_ints(int S) {
  return S <= kStageStates ? 4 * S * kThreads : 0;
}

// Shared memory of one block (offsets into the dynamic buffer).
struct Smem {
  const int* rank_ext;  // (K, S), -1 where absent
  const int* rank_uni;  // (K, S)
  const int* off_ext;   // (K,)
  const int* off_uni;   // (K,)
  const int* n_ext;     // (K,)
  const int* n_uni;     // (K,)
  const int* fs_off;    // (S,) -2 / -1 / region offset
  const int* init;      // (S,) 0/1 seed targets
  const int* finals;    // (S, Q) 0/1
  int* pt;              // (S, K, 3) this step's class
  int* con;             // (S,) this step's clear mask
  int* hit;             // (Q,)
  unsigned* occ[2];     // (W bits) buffer holds a non-NULL id at slot w
  unsigned* dirty[2];   // (W bits) buffer's slot w may not be canonical
  unsigned* post;       // (W bits) slot w was folded this step
  unsigned* cand;       // (W bits) slots this step may fold
  int* list;            // (W,) this step's candidate slots, ascending
  int* scan;            // (kWarps + 1) warp totals of a block scan; the
                        // last entry holds the list's length
  int* stage;           // (4, S, kThreads) pre-fold rows, or null
  int* start;           // store: (W,) slot starts
  unsigned* bits;       // store: (M bits) slots this step allocates
  int* pre;             // store: (M / 32 words) exclusive prefix
};

// Writes the canonical empty slot (NULL, 0, NULL, NULL) into a buffer.
__device__ __forceinline__ void canonical(int* const buf[4], size_t row,
                                          int S) {
  for (int s = 0; s < S; ++s) {
    buf[0][row + s] = kNull;
    buf[1][row + s] = 0;
    buf[2][row + s] = kNull;
    buf[3][row + s] = kNull;
  }
}

// The per-slot work of one step: ring maintenance, the predecessor folds
// into nxt, the same-slot root folds into sa at hit steps and (in an
// emitting pass) the CONSUME clear and the occupancy of nxt.  Only the
// step's candidate slots (occupied or seeded) are visited, spread evenly
// over the threads (list[i] for i = tid, tid + blockDim, ...).  A slot that
// is not seeded and holds no surviving cell folds to the canonical empty
// slot: an emitting pass writes it into nxt only if nxt's copy is not
// canonical yet (the dirty bitmap), for the candidates that expire here and
// for every other slot in one sweep over the bitmap's words.
template <class Em>
__device__ __forceinline__ void slot_pass(
    const Args& a, const Smem& sm, const Em& em, int* const cur[4],
    int* const nxt[4], int* sa, int n_list, unsigned* occ_nxt,
    unsigned* dirty_nxt, size_t tb, int jm, int em_slot, bool any_hit) {
  const int S = a.S, K = a.K, Q = a.Q, W = a.W;
  const int bottom = em.id(a.off_bottom);
  for (int i = threadIdx.x; i < n_list; i += kThreads) {
    const int w = sm.list[i];
    const bool seed = w == jm;
    const bool expire =
        a.expire ? __ldg(a.expire + tb * W + w) > 0 : w == em_slot;
    const size_t row = static_cast<size_t>(w) * S;
    if (!seed && expire) {
      if (Em::kEmit && test_bit(dirty_nxt, w)) {
        canonical(nxt, row, S);
        clear_bit(dirty_nxt, w);
      }
      continue;
    }
    const bool clear = seed || expire;
    set_bit(sm.post, w);

    // -- the slot's pre-fold row: with few states staged into this
    // thread's column of shared memory, its loads issued together --------
    constexpr int kFields = Em::kEmit ? 4 : 2;  // the count pass: id, is-union
    if (sm.stage) {
      for (int s0 = 0; s0 < S; s0 += 8) {
        int v[kFields][8];
#pragma unroll
        for (int f = 0; f < kFields; ++f)
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (s0 + u < S) v[f][u] = cur[f][row + s0 + u];
#pragma unroll
        for (int f = 0; f < kFields; ++f)
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (s0 + u < S)
              sm.stage[(f * S + s0 + u) * kThreads + threadIdx.x] = v[f][u];
      }
    }
    auto pre_fold = [&](int f, int p) {
      return sm.stage ? sm.stage[(f * S + p) * kThreads + threadIdx.x]
                      : cur[f][row + p];
    };

    // -- predecessor folds, reading the pre-fold (cleared, seeded) slot ----
    bool keeps = false;  // a cell survives the fold and the CONSUME clear
    for (int s = 0; s < S; ++s) {
      Cell acc{kNull, 0, kNull, kNull};
      for (int k = 0; k < K; ++k) {
        const int* p3 = sm.pt + (s * K + k) * 3;
        if (p3[2] <= 0) continue;
        const int p = min(max(p3[0], 0), S - 1);
        Cell src{clear ? kNull : pre_fold(0, p), pre_fold(1, p), kNull,
                 kNull};
        if (Em::kEmit) {
          src.l = pre_fold(2, p);
          src.r = pre_fold(3, p);
        }
        if (seed && sm.init[p]) {
          src.id = bottom;
          src.u = 0;
        }
        if (src.id == kNull) continue;
        Cell c = src;
        if (p3[1] > 0) {  // marking edge: extend
          const int slot =
              sm.off_ext[k] + w * sm.n_ext[k] + sm.rank_ext[k * S + s];
          em.put(slot, kOutput, w, src.id, kNull);
          c = Cell{em.id(slot), 0, src.l, src.r};
        }
        gadget(acc, c, em,
               sm.off_uni[k] + 3 * (w * sm.n_uni[k] + sm.rank_uni[k * S + s]),
               w);
      }
      nxt[0][row + s] = acc.id;
      nxt[1][row + s] = acc.u;
      if (Em::kEmit) {
        nxt[2][row + s] = acc.l;
        nxt[3][row + s] = acc.r;
      }
      keeps |= acc.id != kNull && sm.con[s] <= 0;
    }

    // -- same-slot root folds over the post-fold cells ------------------
    if (any_hit) {
      for (int q = 0; q < Q; ++q) {
        Cell acc{kNull, 0, kNull, kNull};
        if (sm.hit[q] > 0) {
          for (int s = 0; s < S; ++s) {
            const int fo = sm.fs_off[s];
            if (fo == -2 || !sm.finals[s * Q + q]) continue;
            const Cell c{nxt[0][row + s], nxt[1][row + s], nxt[2][row + s],
                         nxt[3][row + s]};
            if (c.id == kNull) continue;
            gadget(acc, c, em, fo + 3 * (w * Q + q), w);
          }
        }
        sa[static_cast<size_t>(w) * Q + q] = acc.id;
      }
    }

    if (Em::kEmit) {
      // -- CONSUME BY ANY: clear the flagged states' ids after the roots --
      for (int s = 0; s < S; ++s)
        if (sm.con[s] > 0) nxt[0][row + s] = kNull;
      if (keeps) set_bit(occ_nxt, w);
      set_bit(dirty_nxt, w);
    }
  }
  if (Em::kEmit) {  // slots that hold no cell: back to canonical, once
    for (int i = threadIdx.x; i < words(W); i += kThreads) {
      for (unsigned m = dirty_nxt[i] & ~sm.cand[i]; m; m &= m - 1)
        canonical(nxt, static_cast<size_t>(i * 32 + __ffs(m) - 1) * S, S);
      atomicAnd(dirty_nxt + i, sm.cand[i]);
    }
  }
}

// Calls f(e, w) for each chain position e in [lo, hi) whose ring slot w =
// (slot0 + e) mod W was folded this step (sm.post), in increasing e.  The
// chain spans E = eps + 1 <= W positions, so the range wraps at most once.
template <class F>
__device__ __forceinline__ void for_folded(const unsigned* post, int slot0,
                                           int lo, int hi, int W, F f) {
  for (int e = lo; e < hi;) {
    const int w = slot0 + e < W ? slot0 + e : slot0 + e - W;
    const int run = min(hi - e, W - w);  // slots w .. w + run - 1
    for (int x = w; x < w + run;) {
      const int take = min(32 - (x & 31), w + run - x);
      unsigned m = post[x >> 5] >> (x & 31);
      if (take < 32) m &= (1u << take) - 1u;
      for (; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        f(e + (x - w) + k, x + k);
      }
      x += take;
    }
    e += run;
  }
}

// The right-chain at a hit step: warp q % kWarps per query, oldest start
// first, each lane over a contiguous share of the E positions.  Only slots
// folded this step can hold a same-slot root, so each lane walks the set
// bits of sm.post in its share.  An emitting pass writes the query's root.
template <class Em>
__device__ __forceinline__ void chain_pass(const Args& a, const Smem& sm,
                                           const Em& em, const int* sa,
                                           long long jj, int* roots) {
  const int Q = a.Q, W = a.W, E = a.epsilon + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = pymod(jj - a.epsilon, W);  // slot of e = 0
  for (int q = warp; q < Q; q += kWarps) {
    if (sm.hit[q] <= 0) continue;
    const int seg = (E + 31) / 32;
    const int lo = min(E, lane * seg), hi = min(E, lo + seg);
    auto root_at = [&](int w) { return sa[static_cast<size_t>(w) * Q + q]; };
    auto slot_of = [&](int e) { return (slot0 + e) % W; };
    auto vchain = [&](int e) { return a.off_chain + e * Q + q; };
    int cnt = 0, last = -1;
    for_folded(sm.post, slot0, lo, hi, W, [&](int e, int w) {
      if (root_at(w) != kNull) {
        ++cnt;
        last = e;
      }
    });
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
    // element of the last valid slot before this lane's share
    int prev = before < 0 ? kNull
                          : (rank == 1 ? root_at(slot_of(before))
                                       : em.id(vchain(before)));
    for_folded(sm.post, slot0, lo, hi, W, [&](int e, int w) {
      const int m = root_at(w);
      if (m == kNull) return;
      if (++rank >= 2) {
        em.put(vchain(e), kUnion, w, m, prev);
        prev = em.id(vchain(e));
      } else {
        prev = m;
      }
    });
    const int total = __shfl_sync(0xffffffffu, inc, 31);
    const int last_all = __shfl_sync(0xffffffffu, mx, 31);
    if (Em::kEmit && lane == 0 && last_all >= 0)
      roots[q] = total == 1 ? root_at(slot_of(last_all))
                            : em.id(vchain(last_all));
  }
}

// Block-wide exclusive scan of the popcounts of n bitmap words into pre;
// returns the total (every thread).  Callers synchronise before reading pre.
__device__ __forceinline__ int scan_words(const unsigned* bits, int* pre,
                                          int n, int* scan) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += __popc(bits[i]);
  int inc = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) scan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? scan[lane] : 0;
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane < kWarps) scan[lane] = v;
  }
  __syncthreads();
  int excl = inc - sum + (warp > 0 ? scan[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    pre[i] = excl;
    excl += __popc(bits[i]);
  }
  return scan[kWarps - 1];
}

template <bool kStore>
__global__ void __launch_bounds__(kThreads) arena_kernel(const Args a) {
  extern __shared__ int smem[];
  const int S = a.S, K = a.K, Q = a.Q, W = a.W, Bn = a.Bn;
  const int wb = words(W), mb = words(a.M);
  Smem sm;
  int* sTab = smem;
  sm.rank_ext = sTab;
  sm.rank_uni = sm.rank_ext + K * S;
  sm.off_ext = sm.rank_uni + K * S;
  sm.off_uni = sm.off_ext + K;
  sm.n_ext = sm.off_uni + K;
  sm.n_uni = sm.n_ext + K;
  sm.fs_off = sm.n_uni + K;
  sm.init = sm.fs_off + S;
  sm.finals = sm.init + S;
  sm.pt = sTab + a.ntab;
  sm.con = sm.pt + S * K * 3;
  sm.hit = sm.con + S;
  unsigned* bitmaps = reinterpret_cast<unsigned*>(sm.hit + Q);
  sm.occ[0] = bitmaps;
  sm.occ[1] = sm.occ[0] + wb;
  sm.dirty[0] = sm.occ[1] + wb;
  sm.dirty[1] = sm.dirty[0] + wb;
  sm.post = sm.dirty[1] + wb;
  sm.cand = sm.post + wb;
  sm.list = reinterpret_cast<int*>(sm.cand + wb);
  sm.scan = sm.list + W;
  sm.stage = S <= kStageStates ? sm.scan + kWarps + 1 : nullptr;
  sm.start = sm.scan + kWarps + 1 + stage_ints(S);
  sm.bits = reinterpret_cast<unsigned*>(sm.start + W);
  sm.pre = reinterpret_cast<int*>(sm.bits + mb);

  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < a.ntab; i += kThreads) sTab[i] = __ldg(a.tabs + i);

  const size_t lane_cells = static_cast<size_t>(b) * W * S;
  int* cur[4];
  int* nxt[4];
  for (int f = 0; f < 4; ++f) {
    cur[f] = a.cells[f] + lane_cells;
    nxt[f] = a.alt[f] + lane_cells;
  }
  int* sa = a.sa + static_cast<size_t>(b) * W * Q;
  int c = 0;  // index of the buffer cur points to
  for (int i = tid; i < wb; i += kThreads) {
    // both buffers' contents are unknown: every slot (none past W) dirty
    const unsigned in_ring =
        i < W / 32 ? ~0u : (1u << (W & 31)) - 1u;
    sm.occ[0][i] = 0u;
    sm.dirty[0][i] = in_ring;
    sm.dirty[1][i] = in_ring;
  }
  const size_t srow = static_cast<size_t>(b) * (a.cap + 1);
  long long base = 0;  // the lane's running bump pointer
  if (kStore) {
    for (int w = tid; w < W; w += kThreads)
      sm.start[w] = __ldg(a.sstart0 + static_cast<size_t>(b) * W + w);
    base = a.ptr[b];
  }
  __syncthreads();
  for (int w = tid; w < W; w += kThreads) {
    bool any = false;
    for (int s = 0; s < S; ++s)
      any |= cur[0][static_cast<size_t>(w) * S + s] != kNull;
    if (any) set_bit(sm.occ[0], w);
  }

  // the step's scalar operands, loaded one step ahead
  int live_n = 0, cls_n = 0, j_n = 0, vb_n = 0, gp_n = 0;
  auto fetch = [&](int t) {
    const size_t tb = static_cast<size_t>(t) * Bn + b;
    live_n = __ldg(a.live + tb);
    cls_n = __ldg(a.cls + tb);
    j_n = __ldg(a.j + tb);
    vb_n = kStore ? 0 : __ldg(a.vb + tb);
    gp_n = kStore ? __ldg(a.gpos + tb) : 0;
  };
  if (a.steps > 0) fetch(0);
  for (int t = 0; t < a.steps; ++t) {
    const size_t tb = static_cast<size_t>(t) * Bn + b;
    const int live = live_n, cls = cls_n, vb = vb_n, gp = gp_n;
    const long long jj = j_n;
    if (t + 1 < a.steps) fetch(t + 1);
    if (live == 0) continue;  // dead step: nothing changes
    const int jm = pymod(jj, W);
    const int em_slot = pymod(jj - a.epsilon - 1, W);
    __syncthreads();  // every read of the previous step's tables is done
    const int* pt = a.ptab + static_cast<size_t>(cls) * S * K * 3;
    for (int i = tid; i < S * K * 3; i += kThreads) sm.pt[i] = __ldg(pt + i);
    for (int i = tid; i < S; i += kThreads)
      sm.con[i] = a.consume ? __ldg(a.consume + tb * S + i) : 0;
    for (int i = tid; i < Q; i += kThreads)
      sm.hit[i] = __ldg(a.hit + tb * Q + i);
    for (int i = tid; i < wb; i += kThreads) {
      sm.post[i] = 0u;
      sm.occ[c ^ 1][i] = 0u;
    }
    if (kStore) {
      for (int i = tid; i < mb; i += kThreads) sm.bits[i] = 0u;
      if (tid == 0) sm.start[jm] = gp;  // seeding starts the slot
    }
    if (tid < 32) {
      // -- warp 0 lists the step's candidates (occupied or seeded slots)
      // in ascending order, so the threads share them evenly -------------
      const int lane = tid, per = (wb + 31) / 32;
      const int lo = min(wb, lane * per), hi = min(wb, lo + per);
      int cnt = 0;
      for (int i = lo; i < hi; ++i) {
        const unsigned m =
            sm.occ[c][i] | (i == jm >> 5 ? 1u << (jm & 31) : 0u);
        sm.cand[i] = m;
        cnt += __popc(m);
      }
      int inc = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
      }
      int k = inc - cnt;
      for (int i = lo; i < hi; ++i)
        for (unsigned m = sm.cand[i]; m; m &= m - 1)
          sm.list[k++] = i * 32 + __ffs(m) - 1;
      if (lane == 31) sm.scan[kWarps] = inc;
    }
    __syncthreads();
    const int n_list = sm.scan[kWarps];
    bool any_hit = false;
    for (int q = 0; q < Q; ++q) any_hit |= sm.hit[q] > 0;
    unsigned* occ_nxt = sm.occ[c ^ 1];
    unsigned* dirty_nxt = sm.dirty[c ^ 1];
    int* roots = a.roots + (static_cast<size_t>(b) * a.steps + t) * Q;

    if (kStore) {
      // -- count pass: the bitmap of the slots this step allocates ------
      const CountEmit ce{sm.bits};
      if (tid == 0) ce.put(a.off_bottom, kBottom, 0, kNull, kNull);
      slot_pass(a, sm, ce, cur, nxt, sa, n_list, occ_nxt, dirty_nxt, tb,
                jm, em_slot, any_hit);
      __syncthreads();
      if (any_hit) {
        chain_pass(a, sm, ce, sa, jj, roots);
        __syncthreads();
      }
      const int total = scan_words(sm.bits, sm.pre, mb, sm.scan);
      __syncthreads();
      // -- emit pass: real ids ptr + rank, nodes straight into the store -
      const StoreEmit se{sm.bits, sm.pre, sm.start,
                         a.store[0] + srow, a.store[1] + srow,
                         a.store[2] + srow, a.store[3] + srow,
                         a.store[4] + srow, base, a.cap, gp};
      if (tid == 0) se.put(a.off_bottom, kBottom, 0, kNull, kNull);
      slot_pass(a, sm, se, cur, nxt, sa, n_list, occ_nxt, dirty_nxt, tb,
                jm, em_slot, any_hit);
      __syncthreads();  // every slot's same-slot root is in sa
      if (any_hit) chain_pass(a, sm, se, sa, jj, roots);
      base += total;
    } else {
      const size_t rec = (static_cast<size_t>(b) * a.steps + t) * a.M;
      const DenseEmit de{a.valid + rec, a.left + rec, a.right + rec, vb};
      if (tid == 0) de.put(a.off_bottom, kBottom, 0, kNull, kNull);
      slot_pass(a, sm, de, cur, nxt, sa, n_list, occ_nxt, dirty_nxt, tb,
                jm, em_slot, any_hit);
      __syncthreads();  // every slot's same-slot root is in sa
      if (any_hit) chain_pass(a, sm, de, sa, jj, roots);
    }
    for (int f = 0; f < 4; ++f) {
      int* tmp = cur[f];
      cur[f] = nxt[f];
      nxt[f] = tmp;
    }
    c ^= 1;
  }

  __syncthreads();
  if (c == 1) {  // the final table is in the second buffer: copy it back
    for (int w = tid; w < W; w += kThreads) {
      if (!test_bit(sm.dirty[0], w) && !test_bit(sm.dirty[1], w))
        continue;  // both copies canonical
      const size_t row = static_cast<size_t>(w) * S;
      for (int s = 0; s < S; ++s)
        for (int f = 0; f < (kStore ? 1 : 4); ++f)
          nxt[f][row + s] = cur[f][row + s];
    }
  }
  if (kStore && tid == 0) {
    a.ptr[b] = base > a.cap ? a.cap : static_cast<int>(base);
    if (base > a.cap) a.ovf[b] = 1;
  }
}

size_t smem_ints(int ntab, int W, int S, int K, int Q, int M, bool store) {
  size_t n = static_cast<size_t>(ntab) + S * K * 3 + S + Q + 6 * words(W) +
             W + kWarps + 1 + stage_ints(S);
  if (store) n += W + 2 * words(M);
  return n;
}

template <bool kStore>
cudaError_t launch(const Args& a, void* stream) {
  const size_t smem =
      smem_ints(a.ntab, a.W, a.S, a.K, a.Q, a.M, kStore) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      arena_kernel<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  arena_kernel<kStore><<<a.Bn, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory (bytes) a block may take on the current
// device: the layout tables, one step's predecessor table, the bitmaps and
// (store route) the start table must fit.
int arena_update_max_dynamic_smem(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// The dense route: records on virtual ids (the TPU kernel's contract).
int arena_update_launch(int* cid, int* cu, int* cl, int* cr, int* aid,
                        int* au, int* al, int* ar, int* sa, const int* cls,
                        const int* hit, const int* j, const int* live,
                        const int* vb, const int* expire, const int* consume,
                        const int* ptab, const int* tabs, int ntab,
                        int* valid, int* left, int* right, int* roots, int Bn,
                        int steps, int W, int S, int K, int Q, int M,
                        int epsilon, int off_bottom, int off_chain,
                        void* stream) {
  if (Bn < 1 || steps < 0 || W < 1 || S < 1 || K < 1 || Q < 1 || M < 1 ||
      epsilon < 0)
    return cudaErrorInvalidValue;
  Args a{};
  int* cells[4] = {cid, cu, cl, cr};
  int* alt[4] = {aid, au, al, ar};
  for (int f = 0; f < 4; ++f) {
    a.cells[f] = cells[f];
    a.alt[f] = alt[f];
  }
  a.sa = sa;
  a.cls = cls;
  a.hit = hit;
  a.j = j;
  a.live = live;
  a.vb = vb;
  a.expire = expire;
  a.consume = consume;
  a.ptab = ptab;
  a.tabs = tabs;
  a.roots = roots;
  a.valid = valid;
  a.left = left;
  a.right = right;
  a.Bn = Bn;
  a.steps = steps;
  a.W = W;
  a.S = S;
  a.K = K;
  a.Q = Q;
  a.M = M;
  a.epsilon = epsilon;
  a.off_bottom = off_bottom;
  a.off_chain = off_chain;
  a.ntab = ntab;
  a.cap = 0;
  return launch<false>(a, stream);
}

// The store route: ids allocated in the kernel, nodes written to the store.
int arena_store_launch(int* cid, int* cu, int* cl, int* cr, int* aid,
                       int* au, int* al, int* ar, int* sa, const int* cls,
                       const int* hit, const int* j, const int* live,
                       const int* expire, const int* consume,
                       const int* ptab, const int* tabs, int ntab,
                       const int* gpos, const int* sstart0, int* kind,
                       int* pos, int* maxs, int* left, int* right, int* ptr,
                       unsigned char* ovf, int* roots, int Bn, int steps,
                       int W, int S, int K, int Q, int M, int epsilon,
                       int off_bottom, int off_chain, int cap, void* stream) {
  if (Bn < 1 || steps < 0 || W < 1 || S < 1 || K < 1 || Q < 1 || M < 1 ||
      epsilon < 0 || cap < 0)
    return cudaErrorInvalidValue;
  Args a{};
  int* cells[4] = {cid, cu, cl, cr};
  int* alt[4] = {aid, au, al, ar};
  for (int f = 0; f < 4; ++f) {
    a.cells[f] = cells[f];
    a.alt[f] = alt[f];
  }
  int* store[5] = {kind, pos, maxs, left, right};
  for (int f = 0; f < 5; ++f) a.store[f] = store[f];
  a.sa = sa;
  a.cls = cls;
  a.hit = hit;
  a.j = j;
  a.live = live;
  a.expire = expire;
  a.consume = consume;
  a.ptab = ptab;
  a.tabs = tabs;
  a.roots = roots;
  a.gpos = gpos;
  a.sstart0 = sstart0;
  a.ptr = ptr;
  a.ovf = ovf;
  a.Bn = Bn;
  a.steps = steps;
  a.W = W;
  a.S = S;
  a.K = K;
  a.Q = Q;
  a.M = M;
  a.epsilon = epsilon;
  a.off_bottom = off_bottom;
  a.off_chain = off_chain;
  a.ntab = ntab;
  a.cap = cap;
  return launch<true>(a, stream);
}

}  // extern "C"
