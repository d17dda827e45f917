// Lane router of the partitioned streaming engine, for Hopper (sm_90a).
//
// Replaces the lane assignment of src/repro/vector/partitioned.py
// (_part_step_impl, `assign`, :182): a jax.lax.scan over a chunk's partition
// key hashes against the (L,) lane-ownership table, not a Pallas kernel.  Per
// event it gives the lane (L: not routed), the NULL flag and the event's rank
// among the chunk's earlier events of its lane; per lane the new key table,
// lane_last, the eviction flags and the fill min(events, cap).  The scan's
// rules: a key takes the lowest lane holding it; a new key takes the lowest
// empty lane, else (LRU) the owned lane with no event yet this chunk whose
// lane_last is least (lowest lane on ties), else it spills; NULL and raw
// EMPTY_LANE keys are dropped.
//
// What bounds it on this card: bytes, a few per event (keys in; lane, rank
// and the NULL flag out), so the floor is microseconds and a handful of
// launches and the serial part below set the time.  What the design does
// about it: one serial step per event (the scan as written) would cost
// T steps of a block-wide reduction, tens of ms at 262 144 events.  Three
// invariants of the scan make a mostly parallel route exact:
//   (a) a lane is evictable only while no event of the chunk has reached it,
//       so a lane that an event has reached keeps its key to the chunk's end;
//   (b) the empty and evictable sets only shrink within a chunk, so once a
//       new key finds no lane every later new key spills too;
//   (c) hence a key's fate is set by its first occurrence in the chunk: every
//       later event of the key goes where the first went (or spills).
// The route:
//   1. probe_kernel: a hash table (open addressing, at most half full) of the
//      lane table's keys (lowest lane per key) and the chunk's keys (each
//      event's slot, and per key its first event by atomicMin);
//   2. tile_rank / scan / compact: the first occurrences in time order (a
//      stable count per tile of 1024 events, then offsets over tiles);
//   3. walk_kernel: one block.  Up to the first occurrence of a key that is
//      not resident, no lane has changed owner, so those keys keep their
//      lanes (in parallel).  From there one warp walks the first occurrences
//      in time order: a key whose resident lane still holds it costs one
//      check; any other key takes the scan's decision (the lowest free lane
//      by a ballot over a moving pointer; the LRU victim by a warp arg-min
//      over the lanes not reached yet), and an eviction marks the victim's
//      lane so that its old key decides anew at its own first occurrence.
//      In the steady state every key is resident and nothing is walked;
//   4. tile_rank / scan / finalize: each event takes its key's lane, and the
//      rank is a stable per-lane count (warp match within a warp, warps of a
//      tile in order over per-lane counters, tile offsets by a column scan);
//      the lane totals give fill and lane_last.
// All of it is integer work, so kernel and plain version
// (ref.lane_route_ref) agree exactly.
//
// Build: see repro_torch/kernels/build.py.  The C entry point returns a
// cudaError_t value (0 = success).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNullKey = 0xffffffffu;    // NULL_KEY_HASH; a free slot
constexpr unsigned kEmptyLane = 0xfffffffeu;  // EMPTY_LANE
constexpr unsigned kNone = 0xffffffffu;       // no lane / no event yet
constexpr int kThreads = 256;
constexpr int kTile = 1024;                   // events per rank tile
constexpr int kSmemLimit = 48 * 1024;         // dynamic smem, no opt-in
constexpr size_t kAlign = 256;

struct Table {
  unsigned* key;    // (H,) the key of a slot, kNullKey while free
  unsigned* res;    // (H,) lowest lane holding the key at chunk start
  unsigned* first;  // (H,) the key's first event in the chunk
  int* decided;     // (H,) where the first occurrence went (L: spilled)
  unsigned mask;    // H - 1
};

__device__ __forceinline__ unsigned mix(unsigned h) {  // murmur3 finaliser
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// The slot of key k, inserted if absent (linear probing).
__device__ unsigned insert(const Table& tb, unsigned k) {
  unsigned h = mix(k) & tb.mask;
  while (true) {
    const unsigned cur = *reinterpret_cast<volatile unsigned*>(tb.key + h);
    if (cur == k) return h;
    if (cur == kNullKey) {
      const unsigned prev = atomicCAS(tb.key + h, kNullKey, k);
      if (prev == kNullKey || prev == k) return h;
    }
    h = (h + 1) & tb.mask;
  }
}

// Threads [0, L) insert the lane table's keys, threads [L, L + T) the
// chunk's events.
__global__ void __launch_bounds__(kThreads)
probe_kernel(const unsigned* __restrict__ keys,
             const unsigned* __restrict__ lane_keys0, Table tb,
             int* __restrict__ slot_of, unsigned char* __restrict__ null_out,
             int T, int L) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int slot = -1;
  if (i < L) {
    const unsigned k = lane_keys0[i];
    if (k != kEmptyLane && k != kNullKey)
      atomicMin(tb.res + insert(tb, k), static_cast<unsigned>(i));
  } else if (i < static_cast<long long>(L) + T) {
    const int t = static_cast<int>(i - L);
    const unsigned k = keys[t];
    const bool is_null = k == kNullKey || k == kEmptyLane;
    null_out[t] = is_null;
    if (!is_null) slot = static_cast<int>(insert(tb, k));
    slot_of[t] = slot;
  }
  // a warp's events are in time order: the lowest thread of each group of
  // equal slots holds the group's earliest event
  const unsigned peers = __match_any_sync(kFull, slot);
  if (slot >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicMin(tb.first + slot, static_cast<unsigned>(i - L));
}

enum Mode { kFirst = 0, kLane = 1 };

// Stable rank of each event within its tile and group, and the tile's count
// per group into counts (n_tiles, G).  kFirst: one group, the first
// occurrences.  kLane: the group is the event's lane (also written to
// lane_out).  The running counters live in shared memory when G ints fit,
// else in the tile's (zeroed) row of counts.
template <int kMode>
__global__ void __launch_bounds__(kTile)
tile_rank_kernel(const int* __restrict__ slot_of, Table tb,
                 int* __restrict__ lane_out, int* __restrict__ rank_tmp,
                 int* __restrict__ counts, int T, int L, int G,
                 int cnt_in_smem) {
  extern __shared__ int smem_cnt[];
  const int tile = blockIdx.x;
  const int t = tile * kTile + threadIdx.x;
  int g = -1;
  if (t < T) {
    const int s = slot_of[t];
    if (kMode == kFirst) {
      if (s >= 0 && tb.first[s] == static_cast<unsigned>(t)) g = 0;
    } else {
      const int lane = s < 0 ? L : tb.decided[s];
      lane_out[t] = lane;
      if (lane < L) g = lane;
    }
  }
  int* cnt = cnt_in_smem ? smem_cnt : counts + static_cast<size_t>(tile) * G;
  if (cnt_in_smem)
    for (int x = threadIdx.x; x < G; x += blockDim.x) cnt[x] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(kFull, g);
  const int lid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int below = __popc(peers & ((1u << lid) - 1u));
  int base = 0;
  for (int w = 0; w < kTile / 32; ++w) {
    if (warp == w && g >= 0) base = cnt[g];
    __syncwarp();
    if (warp == w && g >= 0 && below == 0) cnt[g] = base + __popc(peers);
    __syncthreads();
  }
  if (t < T) rank_tmp[t] = g >= 0 ? base + below : -1;
  if (cnt_in_smem)
    for (int x = threadIdx.x; x < G; x += blockDim.x)
      counts[static_cast<size_t>(tile) * G + x] = cnt[x];
}

// Exclusive offsets over tiles, per group, in place: blocks of (32, 32)
// threads, x the group and y a segment of tiles.  totals (G,) gets each
// group's count; with fill set (lanes), also fill = min(total, cap) and
// lane_last = chunk_idx where the lane took an event.
__global__ void __launch_bounds__(1024)
scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int n_tiles,
            int G, int cap, int chunk_idx, const int* __restrict__ lane_last0,
            int* __restrict__ lane_last, int* __restrict__ fill) {
  __shared__ int part[32][33];
  const int g = blockIdx.x * 32 + threadIdx.x;
  const int y = threadIdx.y;
  const int seg = (n_tiles + 31) / 32;
  const int lo = min(n_tiles, y * seg);
  const int hi = min(n_tiles, lo + seg);
  int sum = 0;
  if (g < G)
    for (int tl = lo; tl < hi; ++tl)
      sum += counts[static_cast<size_t>(tl) * G + g];
  part[y][threadIdx.x] = sum;
  __syncthreads();
  if (y == 0) {
    int run = 0;
    for (int j = 0; j < 32; ++j) {
      const int v = part[j][threadIdx.x];
      part[j][threadIdx.x] = run;
      run += v;
    }
    if (g < G) {
      totals[g] = run;
      if (fill != nullptr) {
        fill[g] = min(run, cap);
        lane_last[g] = run > 0 ? chunk_idx : lane_last0[g];
      }
    }
  }
  __syncthreads();
  if (g < G) {
    int run = part[y][threadIdx.x];
    for (int tl = lo; tl < hi; ++tl) {
      const size_t o = static_cast<size_t>(tl) * G + g;
      const int v = counts[o];
      counts[o] = run;
      run += v;
    }
  }
}

// The first occurrences, in time order.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ rank_tmp,
               const int* __restrict__ offsets, int* __restrict__ items,
               int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int r = rank_tmp[t];
  if (r >= 0) items[offsets[t / kTile] + r] = t;
}

struct Walk {
  const unsigned* lane_keys0;
  const int* lane_last0;
  unsigned* lane_keys;
  unsigned char* evicted;
  const int* items;
  const int* n_items;
  const int* slot_of;
  Table tb;
  unsigned char* gflags;  // (2L,) zeroed: used when the flags miss smem
  int L;
  int lru;
  int flags_in_smem;
};

__global__ void __launch_bounds__(1024) walk_kernel(Walk a) {
  extern __shared__ unsigned char smem_flags[];
  __shared__ int s_u0;
  const int L = a.L;
  // touched: an event reached the lane this chunk; changed: it was evicted
  volatile unsigned char* touched = a.flags_in_smem ? smem_flags : a.gflags;
  volatile unsigned char* changed = touched + L;
  const int U = *a.n_items;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    a.lane_keys[l] = a.lane_keys0[l];
    a.evicted[l] = 0;
    if (a.flags_in_smem) {
      touched[l] = 0;
      changed[l] = 0;
    }
  }
  if (threadIdx.x == 0) s_u0 = U;
  __syncthreads();
  // the first occurrence of a key that is not resident
  for (int i = threadIdx.x; i < U; i += blockDim.x)
    if (a.tb.res[a.slot_of[a.items[i]]] == kNone) {
      atomicMin(&s_u0, i);
      break;
    }
  __syncthreads();
  const int u0 = s_u0;
  // before it no lane has changed owner: resident keys keep their lanes
  for (int i = threadIdx.x; i < u0; i += blockDim.x) {
    const int s = a.slot_of[a.items[i]];
    const int r = static_cast<int>(a.tb.res[s]);
    a.tb.decided[s] = r;
    touched[r] = 1;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // one warp walks the rest in time order; every value below is uniform
  // over the warp, and lane 0 writes
  const int lid = threadIdx.x;
  int pe = 0;  // no free lane lies below pe
  for (int b0 = u0; b0 < U; b0 += 32) {
    int my_s = 0, my_r = -1;
    unsigned my_k = 0;
    if (b0 + lid < U) {
      my_s = a.slot_of[a.items[b0 + lid]];
      my_k = a.tb.key[my_s];
      const unsigned r = a.tb.res[my_s];
      my_r = r == kNone ? -1 : static_cast<int>(r);
    }
    const int n = min(32, U - b0);
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const unsigned k = __shfl_sync(kFull, my_k, j);
      const int r = __shfl_sync(kFull, my_r, j);
      int lane = -1;
      if (r >= 0 && !changed[r]) {
        lane = r;
      } else {
        if (r >= 0) {  // its lowest lane was evicted: a later holder, if any
          int cand = L;
          for (int l = lid; l < L; l += 32)
            if (a.lane_keys0[l] == k && !changed[l]) {
              cand = l;
              break;
            }
          cand = __reduce_min_sync(kFull, cand);
          if (cand < L) lane = cand;
        }
        if (lane < 0) {
          while (pe < L) {  // the lowest empty lane
            const int l = pe + lid;
            const bool free_lane =
                l < L && a.lane_keys0[l] == kEmptyLane && !touched[l];
            const unsigned m = __ballot_sync(kFull, free_lane);
            if (m) {
              pe += __ffs(m) - 1;
              break;
            }
            pe += 32;
          }
          if (pe < L) {
            lane = pe;
            if (lid == 0) a.lane_keys[lane] = k;
          } else if (a.lru) {  // the least recently used lane not reached
            unsigned long long best = ULLONG_MAX;
            for (int l = lid; l < L; l += 32)
              if (a.lane_keys0[l] != kEmptyLane && !touched[l]) {
                const unsigned long long v =
                    (static_cast<unsigned long long>(
                         static_cast<unsigned>(a.lane_last0[l]) ^ 0x80000000u)
                     << 32) |
                    static_cast<unsigned>(l);
                best = v < best ? v : best;
              }
            for (int off = 16; off > 0; off >>= 1) {
              const unsigned long long o = __shfl_xor_sync(kFull, best, off);
              best = o < best ? o : best;
            }
            if (best != ULLONG_MAX) {
              lane = static_cast<int>(best & 0xffffffffu);
              if (lid == 0) {
                changed[lane] = 1;
                a.evicted[lane] = 1;
                a.lane_keys[lane] = k;
              }
            }
          }
        }
      }
      if (lid == 0) {
        a.tb.decided[s] = lane < 0 ? L : lane;
        if (lane >= 0) touched[lane] = 1;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const int* __restrict__ lane, int* __restrict__ rank,
                const int* __restrict__ offsets, int T, int L) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int l = lane[t];
  rank[t] = l < L ? offsets[static_cast<size_t>(t / kTile) * L + l] + rank[t]
                  : -1;
}

size_t align_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

// Scratch layout: hash table (key, res, first contiguous, then decided),
// each event's slot, the first occurrences, tile counts and totals of both
// rank passes, and the walk's flags.
struct Layout {
  size_t H, n_tiles;
  size_t table, decided, slot_of, items, counts1, totals1, counts_l,
      totals_l, gflags, bytes;
  Layout(long long T, long long L) {
    H = 64;
    while (H < static_cast<size_t>(2 * (T + L))) H <<= 1;
    n_tiles = (T + kTile - 1) / kTile;
    size_t o = 0;
    table = o;
    o = align_up(o + 3 * H * 4);
    decided = o;
    o = align_up(o + H * 4);
    slot_of = o;
    o = align_up(o + T * 4);
    items = o;
    o = align_up(o + T * 4);
    counts1 = o;
    o = align_up(o + n_tiles * 4);
    totals1 = o;
    o = align_up(o + 4);
    counts_l = o;
    o = align_up(o + n_tiles * L * 4);
    totals_l = o;
    o = align_up(o + L * 4);
    gflags = o;
    o = align_up(o + 2 * L);
    bytes = o;
  }
};

}  // namespace

extern "C" {

long long lane_route_scratch_bytes(int T, int L) {
  if (T < 1 || L < 1) return -1;
  return static_cast<long long>(Layout(T, L).bytes);
}

// One chunk: keys (T,) and lane_keys0 (L,) as 32-bit key patterns,
// lane_last0 (L,).  Outputs: lane, rank (T,), null_out (T,) bytes,
// lane_keys, lane_last, fill (L,), evicted (L,) bytes.  scratch holds
// lane_route_scratch_bytes(T, L) bytes.
int lane_route_launch(const int* keys, const int* lane_keys0,
                      const int* lane_last0, int chunk_idx, int cap, int lru,
                      int* lane, int* rank, unsigned char* null_out,
                      int* lane_keys, int* lane_last, unsigned char* evicted,
                      int* fill, void* scratch, long long scratch_bytes,
                      int T, int L, void* stream) {
  if (T < 1 || L < 1 || cap < 1) return cudaErrorInvalidValue;
  const Layout lay(T, L);
  if (scratch_bytes < static_cast<long long>(lay.bytes))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  Table tb;
  tb.key = reinterpret_cast<unsigned*>(base + lay.table);
  tb.res = tb.key + lay.H;
  tb.first = tb.res + lay.H;
  tb.decided = reinterpret_cast<int*>(base + lay.decided);
  tb.mask = static_cast<unsigned>(lay.H - 1);
  int* slot_of = reinterpret_cast<int*>(base + lay.slot_of);
  int* items = reinterpret_cast<int*>(base + lay.items);
  int* counts1 = reinterpret_cast<int*>(base + lay.counts1);
  int* totals1 = reinterpret_cast<int*>(base + lay.totals1);
  int* counts_l = reinterpret_cast<int*>(base + lay.counts_l);
  int* totals_l = reinterpret_cast<int*>(base + lay.totals_l);
  unsigned char* gflags =
      reinterpret_cast<unsigned char*>(base + lay.gflags);
  const unsigned* ukeys = reinterpret_cast<const unsigned*>(keys);
  const unsigned* ulk0 = reinterpret_cast<const unsigned*>(lane_keys0);
  const int n_tiles = static_cast<int>(lay.n_tiles);
  const int ev_blocks = (T + kThreads - 1) / kThreads;
  cudaError_t err;
#define LR_CHECK()                                   \
  do {                                               \
    if ((err = cudaGetLastError()) != cudaSuccess) return err; \
  } while (0)

  if ((err = cudaMemsetAsync(tb.key, 0xff, 3 * lay.H * 4, st)) != cudaSuccess)
    return err;
  probe_kernel<<<static_cast<unsigned>((static_cast<long long>(T) + L +
                                        kThreads - 1) / kThreads),
                 kThreads, 0, st>>>(ukeys, ulk0, tb, slot_of, null_out, T,
                                    L);
  LR_CHECK();
  // the first occurrences in time order
  tile_rank_kernel<kFirst><<<n_tiles, kTile, sizeof(int), st>>>(
      slot_of, tb, lane, rank, counts1, T, L, 1, 1);
  LR_CHECK();
  scan_kernel<<<1, dim3(32, 32), 0, st>>>(counts1, totals1, n_tiles, 1, cap,
                                          chunk_idx, nullptr, nullptr,
                                          nullptr);
  LR_CHECK();
  compact_kernel<<<ev_blocks, kThreads, 0, st>>>(rank, counts1, items, T);
  LR_CHECK();
  // the decisions
  Walk w{ulk0, lane_last0, reinterpret_cast<unsigned*>(lane_keys), evicted,
         items, totals1, slot_of, tb, gflags, L, lru, 0};
  const size_t flag_bytes = 2 * static_cast<size_t>(L);
  w.flags_in_smem = flag_bytes + 64 <= static_cast<size_t>(kSmemLimit);
  if (!w.flags_in_smem &&
      (err = cudaMemsetAsync(gflags, 0, flag_bytes, st)) != cudaSuccess)
    return err;
  walk_kernel<<<1, 1024, w.flags_in_smem ? flag_bytes : 0, st>>>(w);
  LR_CHECK();
  // every event's lane, and its stable rank within the lane
  const size_t cnt_bytes = static_cast<size_t>(L) * 4;
  const int cnt_in_smem = cnt_bytes <= static_cast<size_t>(kSmemLimit);
  if (!cnt_in_smem &&
      (err = cudaMemsetAsync(counts_l, 0, lay.n_tiles * cnt_bytes, st)) !=
          cudaSuccess)
    return err;
  tile_rank_kernel<kLane><<<n_tiles, kTile, cnt_in_smem ? cnt_bytes : 0,
                            st>>>(slot_of, tb, lane, rank, counts_l, T, L, L,
                                  cnt_in_smem);
  LR_CHECK();
  scan_kernel<<<(L + 31) / 32, dim3(32, 32), 0, st>>>(
      counts_l, totals_l, n_tiles, L, cap, chunk_idx, lane_last0, lane_last,
      fill);
  LR_CHECK();
  finalize_kernel<<<ev_blocks, kThreads, 0, st>>>(lane, rank, counts_l, T,
                                                  L);
  LR_CHECK();
#undef LR_CHECK
  return cudaSuccess;
}

}  // extern "C"
