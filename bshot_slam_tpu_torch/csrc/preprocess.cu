// The ground walk of the sweep preprocess on Hopper (kernel F).
//
// F has no Pallas counterpart: it is the port's form of the `lax.scan` over
// rings in bshot_slam_tpu/ops/preprocess.py:_ground_scan (reference:
// src/preprocess.cpp:73-166).  Each azimuth column of the (R, A) range image
// is walked bottom-up, ring by ring, with five state variables: whether the
// previous cell was ground, whether it was lost, whether a threshold point
// is set, the previous point and the threshold point (of which rule 5 reads
// only z).  Columns are independent, so one thread walks one column with
// its state in registers and the R steps run in one launch, where a loop of
// PyTorch operations over the rings would cost ~30 launches per ring.
//
// Bound: each cell is read once (range 4 bytes, xyz 12) and its class
// written once (4 bytes), against 36 f32 instructions per cell
// (GROUND_WALK_CELL_OPS in kernels/preprocess.py).  At 2176 columns that is
// ~1.4 MB and 2.5 M instructions, far below what one launch takes: the walk
// is bound by latency.  One thread walking its column through the whole
// arithmetic issues ~150 dependent instructions a ring from one warp per
// SM, ~1000 cycles a ring; staging the loads alone does not change that.  So a block of kCols = 32 columns has kWarps = 8 warps: all
// of them stage up to kRings rings of the block's columns in shared memory
// (lanes over azimuth, so every ring's range and xyz rows are coalesced,
// each warp's rings' loads in flight before any is stored; xyz at a stride
// of 3 words, no bank conflict) and compute every staged cell's gradient
// and previous-point norm, which read only loaded points (the walk's
// previous point is every cell's, whatever its class), a ring per warp at a
// time; then one warp walks the rings, its chain the five state variables
// and a few compares.  68 blocks at 2176 columns; a taller image is staged
// kRings rings at a time.
//
// Rounding: the plain version (kernels/preprocess.py:ground_walk_plain)
// runs one PyTorch operation per step, so nothing there is contracted into
// an FMA.  The kernel writes every product, sum, square root and quotient
// with the _rn intrinsics in the plain version's order -- |v| as
// sqrt((x*x + y*y) + z*z), unfused -- so nvcc contracts nothing either, and
// takes the same asinf.  The threshold tests flip on one ulp, so the
// classes must be cell-exact against the plain version.  Never build this
// file with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns per block: a warp's lanes
constexpr int kWarps = 8;   // warps per block that stage and compute cells
constexpr int kRings = 32;  // rings staged in shared memory at a time
constexpr float kEps = 1e-6f;
constexpr float kRad2Deg = 57.29577951308232f;  // float32(180 / pi)
// Class codes of config.py.
constexpr int32_t kKeep = 0;
constexpr int32_t kGround = 1;
constexpr int32_t kSelfcar = 2;

struct Thresholds {
  float grad_th, lowpt, height_th, x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z)));
}

__global__ void __launch_bounds__(kCols * kWarps)
ground_walk_kernel(const float* __restrict__ range, const float* __restrict__ xyz,
                   const float* __restrict__ p0, int R, int A, Thresholds th,
                   int32_t* __restrict__ classes) {
  __shared__ float s_range[kRings][kCols];
  __shared__ float s_xyz[kRings][3 * kCols];
  __shared__ float s_grad[kRings][kCols];       // each cell's gradient, degrees
  __shared__ float s_norm_prev[kRings][kCols];  // |previous point|
  __shared__ float s_below[3 * kCols];          // the point below the stage
  const int t = threadIdx.x, w = threadIdx.y;
  const int a0 = blockIdx.x * kCols;
  const int a = a0 + t;
  const int n = min(kCols, A - a0);
  const bool live = t < n;
  if (w == 0) {
    for (int m = t; m < 3 * n; m += kCols) s_below[m] = p0[3 * a0 + m];
  }
  // The walk's state, in warp 0: the previous point's z, the threshold
  // point's z, and whether the previous cell was ground, lost, or set a
  // threshold point.
  float pz = 0.0f, tz = 0.0f;
  bool pig = true, lost = false, set_th = false;
  for (int r0 = 0; r0 < R; r0 += kRings) {
    const int nr = min(kRings, R - r0);
    // Stage: warp w loads rings w, w + kWarps, ..., all loads first.
    constexpr int kPer = kRings / kWarps;
    float v[kPer][4];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = w + j * kWarps;
      const size_t row = (size_t)(r0 + k) * A + a0;
      v[j][0] = (k < nr && live) ? range[row + t] : 0.0f;
#pragma unroll
      for (int m = 0; m < 3; ++m)
        v[j][1 + m] = (k < nr && t + m * kCols < 3 * n)
                          ? xyz[3 * row + t + m * kCols] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = w + j * kWarps;
      if (k < nr) {
        s_range[k][t] = v[j][0];
#pragma unroll
        for (int m = 0; m < 3; ++m) s_xyz[k][t + m * kCols] = v[j][1 + m];
      }
    }
    __syncthreads();
    // Each cell's arithmetic, from its point and the point below it.
    for (int k = w; live && k < nr; k += kWarps) {
      const float* q = k == 0 ? &s_below[3 * t] : &s_xyz[k - 1][3 * t];
      const float qx = q[0], qy = q[1], qz = q[2];
      const float x = s_xyz[k][3 * t], y = s_xyz[k][3 * t + 1], z = s_xyz[k][3 * t + 2];
      const float dx = __fsub_rn(x, qx), dy = __fsub_rn(y, qy), dz = __fsub_rn(z, qz);
      const float s = __fdiv_rn(dz, __fadd_rn(norm3(dx, dy, dz), kEps));
      s_grad[k][t] = __fmul_rn(asinf(fminf(fmaxf(s, -1.0f), 1.0f)), kRad2Deg);
      s_norm_prev[k][t] = norm3(qx, qy, qz);
    }
    __syncthreads();
    if (w == 0 && live) {
      if (r0 == 0) pz = tz = s_below[3 * t + 2];
#pragma unroll 4
      for (int k = 0; k < nr; ++k) {
        const float d = s_range[k][t];
        const float x = s_xyz[k][3 * t], y = s_xyz[k][3 * t + 1], z = s_xyz[k][3 * t + 2];
        const float grad = s_grad[k][t];
        const float norm_prev = s_norm_prev[k][t];

        // Rule 1: remember a threshold point (reference: preprocess.cpp:99-103).
        if (pig && (grad > th.grad_th || d == 0.0f || d < norm_prev)) {
          set_th = true;
          tz = pz;
        }
        // Rule 2: ground continuation / lower-ground re-attach (:105-127).
        const bool g_keep = pig && grad < th.grad_th && !lost;
        const bool lower = !pig && z < th.lowpt && grad < th.grad_th;
        int32_t c = (g_keep || lower) ? kGround : kKeep;
        pig = g_keep || lower;
        if (lower) set_th = false;
        // Rule 3: lost point (:129-136).
        const bool lost_new = d == 0.0f;
        if (lost_new) {
          c = kGround;
          pig = false;
        }
        // Rule 4: range shortened against the previous point (:138-141).
        if (d < norm_prev && d != 0.0f) {
          c = kKeep;
          pig = false;
        }
        // Rule 5: threshold-point restart (:146-150).
        if (set_th && __fsub_rn(z, tz) < th.height_th && z < pz) {
          set_th = false;
          c = kGround;
          pig = true;
        }
        // Rule 6: self-car crop box (:155-158); lost points (the origin)
        // fall inside it, as in the reference.
        if (x >= th.x0 && x <= th.x1 && y >= th.y0 && y <= th.y1 && z >= th.z0 &&
            z <= th.z1)
          c = kSelfcar;
        classes[(size_t)(r0 + k) * A + a] = c;
        lost = lost_new;
        pz = z;
      }
      // The top staged ring is the next stage's point below.
#pragma unroll
      for (int m = 0; m < 3; ++m) s_below[3 * t + m] = s_xyz[nr - 1][3 * t + m];
    }
    __syncthreads();  // the next stage overwrites this one
  }
}

}  // namespace

extern "C" {

// range (R, A), xyz (R, A, 3), p0 (A, 3) float32; classes (R, A) int32.
int bshot_ground_walk(const float* range, const float* xyz, const float* p0,
                      int R, int A, float grad_th, float lowpt, float height_th,
                      float x0, float x1, float y0, float y1, float z0, float z1,
                      int32_t* classes, void* stream) {
  if (R < 1 || A < 1) return (int)cudaErrorInvalidValue;
  const Thresholds th{grad_th, lowpt, height_th, x0, x1, y0, y1, z0, z1};
  ground_walk_kernel<<<(A + kCols - 1) / kCols, dim3(kCols, kWarps), 0,
                       (cudaStream_t)stream>>>(range, xyz, p0, R, A, th, classes);
  return (int)cudaGetLastError();
}

}  // extern "C"
