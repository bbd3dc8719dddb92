// Shared arithmetic of the port's kernels.
//
// Every radius, dedup and nearest-neighbour test in the pipeline uses the
// expanded squared distance d2 = (|q|^2 + |p|^2) - 2 q.p, clamped at 0
// (bshot_slam_tpu/ops/keypoints.py:_pair_d2).  At mm-scale coordinates the
// ulp of |p|^2 is ~1e3 mm^2, so a different rounding order moves pairs across
// a 3 m shell.  These helpers reproduce, step for step, the rounding of the
// reference's compiled programs and of the plain PyTorch versions on the CPU:
// every K=3 product, |p|^2 included, is the FMA chain in index order,
// fma(az, bz, fma(ay, by, ax*bx)), and d2 = (qq + pp) - 2 cross.  They use
// the _rn intrinsics so that nvcc contracts nothing else.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bshot {

constexpr float kBig = 3.0e38f;  // "no candidate" distance of the reference

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return dot3(x, y, z, x, y, z);
}

// Clamped at +0 (never -0, so the float bits order like the values).
__device__ __forceinline__ float pair_d2(float qq, float pp, float cross) {
  float d = __fsub_rn(__fadd_rn(qq, pp), __fmul_rn(2.0f, cross));
  return d > 0.0f ? d : 0.0f;
}

// (distance bits << 32) | index: for distances >= 0 an unsigned 64-bit min
// picks the smallest distance and, among equal ones, the lowest index.
__device__ __forceinline__ unsigned long long pack_key(float d, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(idx);
}

}  // namespace bshot
