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
// dense form (at most W.S.2 useful ones, since a row of M_all[c] has at most
// two non-zeros) against only A + NQ floats of device-memory traffic; the
// (W, S) state itself need cross device memory only once per chunk.  So the
// floor is the f32 arithmetic (about 67 TFLOP/s), not the 3.35 TB/s memory.
// What the design does about it: one block per lane walks the chunk's T
// events in order (the TPU's sequential grid axis becomes a loop inside the
// block), so the lane's ring stays in shared memory for the whole chunk when
// W.S.4 bytes fit, and in global memory (L2-resident) otherwise.  Each thread
// owns ring slots w = tid, tid + blockDim.x, ..., so slot updates need no
// synchronisation; a block reduction combines the per-query counts.  The
// class lookup is a direct gather (the TPU kernel's one-hot matmuls avoided
// gathers), and products skip zero run counts, which keeps the work near the
// sparse count on real tables.  Counts are f32 integers, exact below 2^24
// whatever the order of summation, so results equal the plain PyTorch
// version bit for bit.  wgmma, TMA and a sparse M are left for later work.
//
// Build: see repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, linked with the other kernels into one
// library).  The C entry points return cudaError_t values (0 = success).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBits = 14;    // predicates per query (2^14 class_of rows)
constexpr int kMaxQ = 8;        // queries per launch
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

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
  const float* init;        // (S,)
  const float* latest;      // (NQ,) or null
  const float* consume;     // (NQ, S) or null
  float* c;                 // (B, W, S), updated in place
  float* ts_ring;           // (B, W), updated in place (time windows)
  unsigned char* ovf;       // (B,), latched in place (time windows)
  const float* event_ts;    // (T, B) (time windows)
  const int* start;         // (B,)
  const int* valid;         // (B,)
  float* matches;           // (T, B, NQ)
  int* trace;               // (T, B) or null
  int T, B, A, S, NQ, W, epsilon;
  float time_size;
  int timed;
  int use_smem;
};

__device__ __forceinline__ bool compare(int op, float v, float thr) {
  switch (op) {
    case 0: return v == thr;
    case 1: return v != thr;
    case 2: return v < thr;
    case 3: return v <= thr;
    case 4: return v > thr;
    default: return v >= thr;
  }
}

// Python's sign rule: the result lies in [0, W) for negative x too.
__device__ __forceinline__ int pymod(long long x, int W) {
  long long r = x % W;
  return static_cast<int>(r < 0 ? r + W : r);
}

template <int MAXS>
__global__ void __launch_bounds__(kMaxThreads)
fused_scan_kernel(const Args a, const Specs sp) {
  extern __shared__ float ring_smem[];
  __shared__ float sM[MAXS * MAXS];     // M_all[class], zero-padded
  __shared__ float sF[kMaxQ * MAXS];    // finals
  __shared__ float sCons[kMaxQ * MAXS]; // consume map
  __shared__ float sInit[MAXS];
  __shared__ float sLatest[kMaxQ];
  __shared__ float sClr[MAXS];
  __shared__ float rSum[kMaxWarps][kMaxQ];
  __shared__ int rAge[kMaxWarps][kMaxQ];
  __shared__ float rVal[kMaxWarps][kMaxQ];

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int S = a.S, W = a.W, NQ = a.NQ, B = a.B;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;

  for (int i = tid; i < MAXS * MAXS; i += nth) sM[i] = 0.f;
  for (int i = tid; i < kMaxQ * MAXS; i += nth) {
    const int q = i / MAXS, s = i % MAXS;
    const bool in = q < NQ && s < S;
    sF[i] = in ? a.finals[q * S + s] : 0.f;
    sCons[i] = (in && a.consume) ? a.consume[q * S + s] : 0.f;
  }
  for (int i = tid; i < MAXS; i += nth) {
    sInit[i] = i < S ? a.init[i] : 0.f;
    sClr[i] = 0.f;
  }
  for (int i = tid; i < kMaxQ; i += nth)
    sLatest[i] = (a.latest && i < NQ) ? a.latest[i] : 0.f;

  // The lane's ring: staged into shared memory, or used in place.
  float* cg = a.c + static_cast<size_t>(b) * W * S;
  float* tsg = a.timed ? a.ts_ring + static_cast<size_t>(b) * W : nullptr;
  float* ring = cg;
  float* tsr = tsg;
  int rs = S;  // ring row stride in floats
  if (a.use_smem) {
    rs = S | 1;  // odd stride: neighbouring slots hit different banks
    ring = ring_smem;
    tsr = a.timed ? ring_smem + static_cast<size_t>(W) * rs : nullptr;
    for (int i = tid; i < W * S; i += nth) ring[(i / S) * rs + i % S] = cg[i];
    if (tsr)
      for (int w = tid; w < W; w += nth) tsr[w] = tsg[w];
  }
  __syncthreads();

  const int start = a.start[b];
  const int valid = a.valid[b];
  for (int t = 0; t < a.T; ++t) {
    const size_t tb = static_cast<size_t>(t) * B + b;
    const float* row = a.attrs + tb * a.A;
    int bits = 0;
    for (int i = 0; i < sp.k; ++i)
      bits |= static_cast<int>(compare(sp.op[i], row[sp.col[i]], sp.thr[i]))
              << i;
    const int cls = a.class_of[bits];
    if (tid == 0 && a.trace) a.trace[tb] = cls;
    if (t >= valid) {  // dead step: state untouched, zero counts
      if (tid < NQ) a.matches[tb * NQ + tid] = 0.f;
      continue;
    }
    const float* Mg = a.m_all + static_cast<size_t>(cls) * S * S;
    for (int i = tid; i < S * S; i += nth) sM[(i / S) * MAXS + i % S] = Mg[i];
    float ts_t = 0.f, bound = 0.f;
    if (a.timed) {
      ts_t = a.event_ts[tb];
      bound = ts_t - a.time_size;  // f32, as the plain version computes it
    }
    const long long j = static_cast<long long>(start) + t;
    const int jm = pymod(j, W);
    const int em = pymod(j - a.epsilon - 1, W);
    __syncthreads();  // sM ready

    float psum[kMaxQ], pval[kMaxQ];
    int page[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      psum[q] = 0.f;
      pval[q] = 0.f;
      page[q] = INT_MAX;
    }
    bool over = false;
    for (int w = tid; w < W; w += nth) {
      float* cw = ring + static_cast<size_t>(w) * rs;
      const bool seed = w == jm;
      bool clear;
      if (a.timed) {
        const bool expire = tsr[w] < bound;
        over |= seed && !expire;
        clear = seed || expire;
        if (seed) tsr[w] = ts_t;
      } else {
        clear = seed || w == em;
      }
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
      int age = jm - w;
      if (age < 0) age += W;
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (q < NQ) {
          float v = 0.f;
#pragma unroll
          for (int u = 0; u < MAXS; ++u) v += cout[u] * sF[q * MAXS + u];
          psum[q] += v;
          if (v > 0.f && age < page[q]) {
            page[q] = age;
            pval[q] = v;
          }
        }
      }
    }
    if (over) a.ovf[b] = 1;

#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      if (q < NQ) {
        float sum = psum[q], val = pval[q];
        int age = page[q];
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_down_sync(0xffffffffu, sum, off);
          const int age2 = __shfl_down_sync(0xffffffffu, age, off);
          const float val2 = __shfl_down_sync(0xffffffffu, val, off);
          if (age2 < age) {
            age = age2;
            val = val2;
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

    if (tid == 0) {
      float trig[kMaxQ];
      for (int q = 0; q < NQ; ++q) {
        float sum = 0.f, val = 0.f;
        int age = INT_MAX;
        for (int wp = 0; wp < nwarps; ++wp) {
          sum += rSum[wp][q];
          if (rAge[wp][q] < age) {
            age = rAge[wp][q];
            val = rVal[wp][q];
          }
        }
        const float m = sLatest[q] > 0.f ? (age < INT_MAX ? val : 0.f) : sum;
        a.matches[tb * NQ + q] = m;
        trig[q] = m > 0.f ? 1.f : 0.f;
      }
      if (a.consume) {
        for (int s = 0; s < S; ++s) {
          float hit = 0.f;
          for (int q = 0; q < NQ; ++q) hit += trig[q] * sCons[q * MAXS + s];
          sClr[s] = hit > 0.f ? 1.f : 0.f;
        }
      }
    }
    if (a.consume) {
      __syncthreads();  // sClr ready: counts of all slots were reduced first
      for (int w = tid; w < W; w += nth) {
        float* cw = ring + static_cast<size_t>(w) * rs;
        for (int s = 0; s < S; ++s)
          if (sClr[s] != 0.f) cw[s] = 0.f;
      }
    }
  }

  if (a.use_smem) {
    __syncthreads();
    for (int i = tid; i < W * S; i += nth) cg[i] = ring[(i / S) * rs + i % S];
    if (tsr)
      for (int w = tid; w < W; w += nth) tsg[w] = tsr[w];
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
  e = cudaFuncGetAttributes(&attr, fused_scan_kernel<MAXS>);
  if (e != cudaSuccess) return e;
  *out = optin - static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

template <int MAXS>
cudaError_t launch(const Args& a, const Specs& sp, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_scan_kernel<MAXS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  fused_scan_kernel<MAXS><<<a.B, threads, smem, stream>>>(a, sp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory (bytes) a block of the instantiation for
// `max_s` states may take on the current device.
int fused_scan_max_dynamic_smem(int max_s, int* out) {
  if (max_s == 8) return max_dynamic_smem<8>(out);
  if (max_s == 16) return max_dynamic_smem<16>(out);
  if (max_s == 32) return max_dynamic_smem<32>(out);
  return cudaErrorInvalidValue;
}

int fused_scan_launch(const float* attrs, const int* spec_col,
                      const int* spec_op, const float* spec_thr, int k,
                      const int* class_of, const float* m_all,
                      const float* finals, const float* init,
                      const float* latest, const float* consume, float* c,
                      float* ts_ring, unsigned char* ovf,
                      const float* event_ts, const int* start,
                      const int* valid, float* matches, int* trace, int T,
                      int B, int A, int S, int NQ, int W, int epsilon,
                      float time_size, int timed, int max_s, int threads,
                      int use_smem, void* stream) {
  if (k < 0 || k > kMaxBits || NQ < 1 || NQ > kMaxQ || S < 1 || S > max_s ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || B < 1)
    return cudaErrorInvalidValue;
  Specs sp;
  sp.k = k;
  for (int i = 0; i < k; ++i) {
    sp.col[i] = spec_col[i];
    sp.op[i] = spec_op[i];
    sp.thr[i] = spec_thr[i];
  }
  Args a{attrs, class_of, m_all, finals, init, latest, consume, c, ts_ring,
         ovf, event_ts, start, valid, matches, trace, T, B, A, S, NQ, W,
         epsilon, time_size, timed, use_smem};
  const size_t smem =
      use_smem ? (static_cast<size_t>(W) * (S | 1) + (timed ? W : 0)) *
                     sizeof(float)
               : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_s == 8) return launch<8>(a, sp, threads, smem, st);
  if (max_s == 16) return launch<16>(a, sp, threads, smem, st);
  if (max_s == 32) return launch<32>(a, sp, threads, smem, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
