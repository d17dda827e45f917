// Windowed counting scans over precomputed symbol classes for Hopper
// (sm_90a): the scan half of the unfused three-kernel pipeline.
//
// Replaces two TPU kernels of src/repro/kernels/cea_scan.py:
//   * cea_scan_multi_pallas (body _cea_scan_multi_kernel), the packed
//     multi-query scan: multi-hot seeding and per-query finals;
//   * cea_scan_pallas (body _cea_scan_kernel), its single-query form: a
//     one-hot seed at init_state and one finals row.
// Both entries below launch the one kernel; the single-query entry passes
// NQ = 1 and no init mask, so the kernel seeds the one-hot init_state.
//
// Per event of a lane: read the class id, take M = M_all[class], clear the
// seed slot j mod W and the expiring slot (j - eps - 1) mod W (Python's sign
// rule), seed the init mask at the seed slot, advance C <- C.M over the
// (W, S) ring and emit, per query q, sum_w C[w].finals[q].  Count windows,
// ANY semantics, one scalar start for every lane (what the TPU kernels take).
//
// What bounds it on this card: the f32 arithmetic, as in fused_scan.cu: per
// event W.S.S multiply-adds in dense form, of which only the non-zeros of
// M_all[class] (at most two per row for one query, entries of 2 included)
// are useful, against T.B.4 bytes of class ids and T.B.NQ.4 bytes of
// matches.  What the design does about it, as in fused_scan.cu: the TPU's
// sequential grid axis becomes a loop over the chunk's T events inside a
// block, and a lane's ring is cut into n_split contiguous segments of
// L = ceil(W / n_split) slots, one block each (grid (B, n_split)).  Seeding
// and expiry are per slot, tested against global slot indices, so a block
// owns its segment outright; it stages its share (rows of S | 1 floats, an
// odd stride that spreads neighbouring slots over the banks) into shared
// memory for the whole chunk and writes it back once at the end.  The
// wrapper picks the smallest n_split whose share fits (plan_ring in
// fused_scan.py); a forced share too large stays in global memory.  Each
// thread owns slots w = tid, tid + blockDim.x, ..., so slot updates need no
// synchronisation; only M_all[class] is staged per event (a packed table of
// 512 classes is too large to stage whole); products skip zero run counts.
// The per-query count of an event is the one thing the segments share: a
// block reduction per group of 8 queries, and with n_split > 1 the partial
// sums are added with atomicAdd into matches the wrapper zeroes.  Rows of up
// to 32 states live in registers; wider packs, up to 512 states, take the
// wide build of scan_row.cuh.  The TPU kernel's padding of S to 128 and W to
// 8 and its one-hot MXU gather are TPU devices and are dropped: any ring
// W >= eps + 1 is taken.  Counts are f32 integers, exact below 2^24 in any
// order of summation, so results equal the plain PyTorch version bit for
// bit.
//
// Build: see repro_torch/kernels/build.py.  The C entry points return
// cudaError_t values (0 = success).

#include <cuda_runtime.h>

#include "common.cuh"
#include "scan_row.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSplit = 65535;  // grid y

struct Args {
  const int* class_ids;  // (T, B)
  const float* m_all;    // (NC, S, S)
  const float* finals;   // (NQ, S)
  const float* init;     // (S,) multi-hot seed, or null: one-hot init_state
  float* c;              // (B, W, S), updated in place
  float* matches;        // (T, B, NQ); zeroed by the caller if n_split > 1
  long long start;       // stream position of the chunk's first event
  int T, B, S, NQ, NC, W, epsilon, init_state, use_smem;
  int n_split;           // blocks per lane (grid y)
};

// MAXS is the state bucket: 8, 16 and 32 keep a slot's row in registers;
// kMaxStates is the wide build (scan_row.cuh).  kMany: more than kQG
// queries, emitted group by group (always so in the wide build).  Packs of
// up to kQG queries take a narrow build without the group loop, with which
// the 8-state build spills (as fused_scan.cu's grows from 80 to 101
// registers).
template <int MAXS, bool kMany>
__global__ void __launch_bounds__(kMaxThreads)
cea_scan_kernel(const Args a) {
  constexpr bool kWide = MAXS > 32;
  constexpr int kRow = kWide ? 1 : MAXS;  // staged row width (narrow only)
  extern __shared__ float ring_smem[];
  __shared__ float sM[kRow * kRow];  // M_all[class], zero-padded
  __shared__ float sF[kQG * kRow];   // finals of the first query group
  __shared__ float sInit[kRow];
  __shared__ float rSum[kMaxWarps][kQG];

  const int b = blockIdx.x, seg = blockIdx.y;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int S = a.S, W = a.W, NQ = a.NQ, B = a.B;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const bool split = a.n_split > 1;
  // this block's segment of the lane's ring: global slots [w0, w0 + n)
  const int L = (W + a.n_split - 1) / a.n_split;
  const int w0 = seg * L;
  const int n = min(L, W - w0);

  if (!kWide) {
    for (int i = tid; i < kRow * kRow; i += nth) sM[i] = 0.f;
    for (int i = tid; i < kQG * kRow; i += nth) {
      const int q = i / kRow, s = i % kRow;
      sF[i] = (q < NQ && s < S) ? a.finals[q * S + s] : 0.f;
    }
    for (int i = tid; i < kRow; i += nth)
      sInit[i] = i < S ? seed_value(a.init, a.init_state, i) : 0.f;
  }

  // The segment: staged into shared memory, or used in place.
  float* cg = a.c + (static_cast<size_t>(b) * W + w0) * S;
  float* ring = cg;
  int rs = S;  // ring row stride in floats
  if (a.use_smem) {
    rs = S | 1;  // odd stride: neighbouring slots hit different banks
    ring = ring_smem;
    for (int i = tid; i < n * S; i += nth) ring[(i / S) * rs + i % S] = cg[i];
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t tb = static_cast<size_t>(t) * B + b;
    const int cls = a.class_ids[tb];
    // an id outside [0, NC) selects the zero matrix, as the TPU kernel's
    // one-hot gather does
    const bool known = cls >= 0 && cls < a.NC;
    const float* Mg =
        known ? a.m_all + static_cast<size_t>(cls) * S * S : nullptr;
    if (!kWide)
      for (int i = tid; i < S * S; i += nth)
        sM[(i / S) * kRow + i % S] = known ? Mg[i] : 0.f;
    const long long j = a.start + t;
    const int jm = pymod(j, W);
    const int em = pymod(j - a.epsilon - 1, W);
    __syncthreads();  // sM ready

    float psum[kQG];
#pragma unroll
    for (int q = 0; q < kQG; ++q) psum[q] = 0.f;
    for (int wl = tid; wl < n; wl += nth) {
      const int w = w0 + wl;
      float* cw = ring + static_cast<size_t>(wl) * rs;
      const bool seed = w == jm;
      const bool clear = seed || w == em;
      if (kWide) {
        wide_row_step(cw, S, clear, seed, a.init, a.init_state, Mg);
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
      // the first query group, from the row still in registers
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        if (q < NQ) {
          float v = 0.f;
#pragma unroll
          for (int u = 0; u < kRow; ++u) v += cout[u] * sF[q * kRow + u];
          psum[q] += v;
        }
      }
    }

    // emission, kQG queries at a time
    const int q_end = (kWide || kMany) ? NQ : 1;
    for (int q0 = 0; q0 < q_end; q0 += kQG) {
      const int nq = min(kQG, NQ - q0);
      if (kWide || q0 > 0) {
        group_sums<false>(ring, rs, n, tid, nth, S, a.finals, q0, nq, jm,
                          w0, W, psum, nullptr, nullptr);
        if (q0 > 0) __syncthreads();  // the previous group's partials read
      }
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        if (q < nq) {
          float sum = psum[q];
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_down_sync(0xffffffffu, sum, off);
          if (lane == 0) rSum[warp][q] = sum;
        }
      }
      __syncthreads();  // per-warp partials ready; every read of sM is done

      if (tid < nq) {
        float sum = 0.f;
        for (int wp = 0; wp < nwarps; ++wp) sum += rSum[wp][tid];
        float* out = a.matches + tb * NQ + q0 + tid;
        if (!split)
          *out = sum;
        else if (sum != 0.f)  // this segment's share of the sum
          atomicAdd(out, sum);
      }
    }
  }

  if (a.use_smem) {
    __syncthreads();
    for (int i = tid; i < n * S; i += nth) cg[i] = ring[(i / S) * rs + i % S];
  }
}

template <int MAXS>
cudaError_t max_dynamic_smem(int* out) {
  constexpr bool kWide = MAXS > 32;  // both flags take the same static smem
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, cea_scan_kernel<MAXS, kWide>);
  if (e != cudaSuccess) return e;
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

template <int MAXS, bool kMany>
cudaError_t run(const Args& a, int threads, size_t smem,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cea_scan_kernel<MAXS, kMany>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B, a.n_split);
  cea_scan_kernel<MAXS, kMany><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MAXS>
cudaError_t launch(const Args& a, int threads, size_t smem,
                   cudaStream_t stream) {
  if constexpr (MAXS > 32) {
    return run<MAXS, true>(a, threads, smem, stream);
  } else {
    if (a.NQ > kQG) return run<MAXS, true>(a, threads, smem, stream);
    return run<MAXS, false>(a, threads, smem, stream);
  }
}

int dispatch(const Args& a, int max_s, int threads, void* stream) {
  if (a.NQ < 1 || a.S < 1 || a.S > max_s || a.NC < 1 ||
      a.W < a.epsilon + 1 || a.epsilon < 0 || a.T < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || a.B < 0 ||
      a.n_split < 1 || a.n_split > a.W || a.n_split > kMaxSplit)
    return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  const size_t L = (static_cast<size_t>(a.W) + a.n_split - 1) / a.n_split;
  const size_t smem = a.use_smem ? L * (a.S | 1) * sizeof(float) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_s == 8) return launch<8>(a, threads, smem, st);
  if (max_s == 16) return launch<16>(a, threads, smem, st);
  if (max_s == 32) return launch<32>(a, threads, smem, st);
  if (max_s == kMaxStates) return launch<kMaxStates>(a, threads, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory (bytes) a block of the instantiation for
// `max_s` states may take on the current device.
int cea_scan_max_dynamic_smem(int max_s, int* out) {
  if (max_s == 8) return max_dynamic_smem<8>(out);
  if (max_s == 16) return max_dynamic_smem<16>(out);
  if (max_s == 32) return max_dynamic_smem<32>(out);
  if (max_s == kMaxStates) return max_dynamic_smem<kMaxStates>(out);
  return cudaErrorInvalidValue;
}

// Packed multi-query scan over grid (B, n_split): init (S,) multi-hot,
// finals (NQ, S), matches (T, B, NQ), zeroed by the caller if n_split > 1.
int cea_scan_multi_launch(const int* class_ids, const float* m_all,
                          const float* finals, const float* init, float* c,
                          float* matches, long long start, int T, int B,
                          int S, int NQ, int NC, int W, int epsilon,
                          int max_s, int threads, int use_smem, int n_split,
                          void* stream) {
  if (init == nullptr) return cudaErrorInvalidValue;
  const Args a{class_ids, m_all, finals, init, c, matches, start, T, B, S,
               NQ, NC, W, epsilon, 0, use_smem, n_split};
  return dispatch(a, max_s, threads, stream);
}

// Single-query scan over grid (B, n_split): one-hot seed at init_state,
// finals (S,), matches (T, B), zeroed by the caller if n_split > 1.
int cea_scan_launch(const int* class_ids, const float* m_all,
                    const float* finals, int init_state, float* c,
                    float* matches, long long start, int T, int B, int S,
                    int NC, int W, int epsilon, int max_s, int threads,
                    int use_smem, int n_split, void* stream) {
  const Args a{class_ids, m_all, finals, nullptr, c, matches, start, T, B,
               S, 1, NC, W, epsilon, init_state, use_smem, n_split};
  return dispatch(a, max_s, threads, stream);
}

}  // extern "C"
