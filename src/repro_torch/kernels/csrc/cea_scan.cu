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
// matches.  What the design does about it: one block per lane walks the
// chunk's T events in order (the TPU's sequential grid axis becomes a loop
// inside the block).  Each thread owns ring slots w = tid, tid + blockDim.x,
// ..., so slot updates need no synchronisation; the ring is staged into
// shared memory when W.S.4 bytes fit, else used in place in global memory;
// only M_all[class] is staged per event (a packed table of 512 classes is
// too large to stage whole); products skip zero run counts; a block
// reduction combines the per-query sums.  The TPU kernel's padding of S to
// 128 and W to 8 and its one-hot MXU gather are TPU devices and are dropped:
// any ring W >= eps + 1 is taken.  Counts are f32 integers, exact below 2^24
// in any order of summation, so results equal the plain PyTorch version bit
// for bit.
//
// Build: see repro_torch/kernels/build.py.  The C entry points return
// cudaError_t values (0 = success).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxQ = 8;  // queries per launch
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Args {
  const int* class_ids;  // (T, B)
  const float* m_all;    // (NC, S, S)
  const float* finals;   // (NQ, S)
  const float* init;     // (S,) multi-hot seed, or null: one-hot init_state
  float* c;              // (B, W, S), updated in place
  float* matches;        // (T, B, NQ)
  long long start;       // stream position of the chunk's first event
  int T, B, S, NQ, NC, W, epsilon, init_state, use_smem;
};

template <int MAXS>
__global__ void __launch_bounds__(kMaxThreads)
cea_scan_kernel(const Args a) {
  extern __shared__ float ring_smem[];
  __shared__ float sM[MAXS * MAXS];   // M_all[class], zero-padded
  __shared__ float sF[kMaxQ * MAXS];  // finals
  __shared__ float sInit[MAXS];
  __shared__ float rSum[kMaxWarps][kMaxQ];

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int S = a.S, W = a.W, NQ = a.NQ, B = a.B;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;

  for (int i = tid; i < MAXS * MAXS; i += nth) sM[i] = 0.f;
  for (int i = tid; i < kMaxQ * MAXS; i += nth) {
    const int q = i / MAXS, s = i % MAXS;
    sF[i] = (q < NQ && s < S) ? a.finals[q * S + s] : 0.f;
  }
  for (int i = tid; i < MAXS; i += nth) {
    float v = 0.f;
    if (i < S) v = a.init ? a.init[i] : (i == a.init_state ? 1.f : 0.f);
    sInit[i] = v;
  }

  // The lane's ring: staged into shared memory, or used in place.
  float* cg = a.c + static_cast<size_t>(b) * W * S;
  float* ring = cg;
  int rs = S;  // ring row stride in floats
  if (a.use_smem) {
    rs = S | 1;  // odd stride: neighbouring slots hit different banks
    ring = ring_smem;
    for (int i = tid; i < W * S; i += nth) ring[(i / S) * rs + i % S] = cg[i];
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const size_t tb = static_cast<size_t>(t) * B + b;
    const int cls = a.class_ids[tb];
    // an id outside [0, NC) selects the zero matrix, as the TPU kernel's
    // one-hot gather does
    if (cls >= 0 && cls < a.NC) {
      const float* Mg = a.m_all + static_cast<size_t>(cls) * S * S;
      for (int i = tid; i < S * S; i += nth)
        sM[(i / S) * MAXS + i % S] = Mg[i];
    } else {
      for (int i = tid; i < S * S; i += nth) sM[(i / S) * MAXS + i % S] = 0.f;
    }
    const long long j = a.start + t;
    const int jm = pymod(j, W);
    const int em = pymod(j - a.epsilon - 1, W);
    __syncthreads();  // sM ready

    float psum[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) psum[q] = 0.f;
    for (int w = tid; w < W; w += nth) {
      float* cw = ring + static_cast<size_t>(w) * rs;
      const bool seed = w == jm;
      const bool clear = seed || w == em;
      float cin[MAXS], cout[MAXS];
#pragma unroll
      for (int s = 0; s < MAXS; ++s) {
        cin[s] = (s < S && !clear) ? cw[s] : 0.f;
        if (seed) cin[s] += sInit[s];
        cout[s] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < MAXS; ++s) {
        const float v = cin[s];
        if (v != 0.f) {
#pragma unroll
          for (int u = 0; u < MAXS; ++u) cout[u] += v * sM[s * MAXS + u];
        }
      }
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s < S) cw[s] = cout[s];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (q < NQ) {
          float v = 0.f;
#pragma unroll
          for (int u = 0; u < MAXS; ++u) v += cout[u] * sF[q * MAXS + u];
          psum[q] += v;
        }
      }
    }

#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      if (q < NQ) {
        float sum = psum[q];
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_down_sync(0xffffffffu, sum, off);
        if (lane == 0) rSum[warp][q] = sum;
      }
    }
    __syncthreads();  // per-warp partials ready; every read of sM is done

    if (tid < NQ) {
      float sum = 0.f;
      for (int wp = 0; wp < nwarps; ++wp) sum += rSum[wp][tid];
      a.matches[tb * NQ + tid] = sum;
    }
  }

  if (a.use_smem) {
    __syncthreads();
    for (int i = tid; i < W * S; i += nth) cg[i] = ring[(i / S) * rs + i % S];
  }
}

template <int MAXS>
cudaError_t max_dynamic_smem(int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, cea_scan_kernel<MAXS>);
  if (e != cudaSuccess) return e;
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

template <int MAXS>
cudaError_t launch(const Args& a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cea_scan_kernel<MAXS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cea_scan_kernel<MAXS><<<a.B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

int dispatch(const Args& a, int max_s, int threads, void* stream) {
  if (a.NQ < 1 || a.NQ > kMaxQ || a.S < 1 || a.S > max_s || a.NC < 1 ||
      a.W < a.epsilon + 1 || a.epsilon < 0 || a.T < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || a.B < 0)
    return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  const size_t smem =
      a.use_smem ? static_cast<size_t>(a.W) * (a.S | 1) * sizeof(float) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_s == 8) return launch<8>(a, threads, smem, st);
  if (max_s == 16) return launch<16>(a, threads, smem, st);
  if (max_s == 32) return launch<32>(a, threads, smem, st);
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
  return cudaErrorInvalidValue;
}

// Packed multi-query scan: init (S,) multi-hot, finals (NQ, S), matches
// (T, B, NQ).
int cea_scan_multi_launch(const int* class_ids, const float* m_all,
                          const float* finals, const float* init, float* c,
                          float* matches, long long start, int T, int B,
                          int S, int NQ, int NC, int W, int epsilon,
                          int max_s, int threads, int use_smem,
                          void* stream) {
  if (init == nullptr) return cudaErrorInvalidValue;
  const Args a{class_ids, m_all, finals, init, c, matches, start, T, B, S,
               NQ, NC, W, epsilon, 0, use_smem};
  return dispatch(a, max_s, threads, stream);
}

// Single-query scan: one-hot seed at init_state, finals (S,), matches
// (T, B).
int cea_scan_launch(const int* class_ids, const float* m_all,
                    const float* finals, int init_state, float* c,
                    float* matches, long long start, int T, int B, int S,
                    int NC, int W, int epsilon, int max_s, int threads,
                    int use_smem, void* stream) {
  const Args a{class_ids, m_all, finals, nullptr, c, matches, start, T, B,
               S, 1, NC, W, epsilon, init_state, use_smem};
  return dispatch(a, max_s, threads, stream);
}

}  // extern "C"
