// Predicate bit-vector evaluation for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitvector.py:bitvector_pallas
// (body _bitvector_kernel).  Each event row of (N, A) f32 attributes is
// tested against k predicate specs (column, op, f32 threshold) and the
// results are packed into one int32 per event: bit i holds predicate i.
//
// What bounds it on this card: bytes.  Per event it reads A floats and
// writes one int; the k compares are a handful of instructions, so the floor
// is (N.A + N).4 bytes over 3.35 TB/s (and at the streaming engines' chunk
// sizes, a few microseconds of launch overhead set the time).  What the
// design does about it: one thread per event, so a warp's rows lie next to
// each other in memory.  The specs are kernel operands, not template
// constants, so one build serves every query (the TPU kernel was specialised
// per query).  Compares are IEEE f32 (common.cuh): NaN attributes fail every
// op but NE, as in JAX and the plain PyTorch version.
//
// Build: see repro_torch/kernels/build.py.  The C entry point returns a
// cudaError_t value (0 = success).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxBits = 31;  // bits of a non-negative int32
constexpr int kThreads = 256;

struct Specs {
  int k;
  int col[kMaxBits];
  int op[kMaxBits];
  float thr[kMaxBits];
};

__global__ void __launch_bounds__(kThreads)
bitvector_kernel(const float* __restrict__ attrs, int* __restrict__ bits,
                 long long N, int A, const Specs sp) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (n >= N) return;
  const float* row = attrs + n * A;
  int acc = 0;
  for (int i = 0; i < sp.k; ++i)
    acc |= static_cast<int>(compare(sp.op[i], row[sp.col[i]], sp.thr[i]))
           << i;
  bits[n] = acc;
}

// Does nothing: launched back to back, it measures the card's launch floor,
// which sets this kernel's time at the engines' chunk sizes.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// n launches of the empty kernel on `stream`.
int empty_launches(int n, void* stream) {
  for (int i = 0; i < n; ++i)
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

int bitvector_launch(const float* attrs, const int* spec_col,
                     const int* spec_op, const float* spec_thr, int k,
                     int* bits, long long N, int A, void* stream) {
  if (k < 0 || k > kMaxBits || N < 0 || A < 1) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  Specs sp;
  sp.k = k;
  for (int i = 0; i < k; ++i) {
    if (spec_col[i] < 0 || spec_col[i] >= A || spec_op[i] < 0 ||
        spec_op[i] > 5)
      return cudaErrorInvalidValue;
    sp.col[i] = spec_col[i];
    sp.op[i] = spec_op[i];
    sp.thr[i] = spec_thr[i];
  }
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bitvector_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(attrs, bits, N, A,
                                                          sp);
  return cudaGetLastError();
}

}  // extern "C"
