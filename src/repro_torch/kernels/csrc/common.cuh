// Device helpers shared by the port's Hopper kernels.
//
// The predicate compare (op codes of repro_torch/kernels/ref.py: EQ, NE, LT,
// LE, GT, GE) follows IEEE f32: a NaN attribute (a NULL) fails every compare
// but NE.  No kernel is built with --use_fast_math or -ftz, so a denormal
// attribute never compares equal to 0.
#pragma once

namespace {

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

// Python's sign rule: the result lies in [0, W) for negative x too, so early
// negative expire indices wrap onto empty ring slots.
__device__ __forceinline__ int pymod(long long x, int W) {
  long long r = x % W;
  return static_cast<int>(r < 0 ? r + W : r);
}

}  // namespace
