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
// (GROUND_WALK_CELL_OPS in kernels/preprocess.py); at 2176 columns the
// walk is one partial wave of 17 blocks, so it sits far above that bound:
// its time is R dependent loads per thread.
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

constexpr int kThreads = 128;
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

__global__ void __launch_bounds__(kThreads)
ground_walk_kernel(const float* __restrict__ range, const float* __restrict__ xyz,
                   const float* __restrict__ p0, int R, int A, Thresholds th,
                   int32_t* __restrict__ classes) {
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= A) return;
  float px = p0[3 * a], py = p0[3 * a + 1], pz = p0[3 * a + 2];
  float tz = pz;  // the threshold point's z
  bool pig = true, lost = false, set_th = false;
  for (int r = 0; r < R; ++r) {
    const size_t i = (size_t)r * A + a;
    const float d = range[i];
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py), dz = __fsub_rn(z, pz);
    const float s = __fdiv_rn(dz, __fadd_rn(norm3(dx, dy, dz), kEps));
    const float grad = __fmul_rn(asinf(fminf(fmaxf(s, -1.0f), 1.0f)), kRad2Deg);
    const float norm_prev = norm3(px, py, pz);

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
    // Rule 6: self-car crop box (:155-158); lost points (the origin) fall
    // inside it, as in the reference.
    if (x >= th.x0 && x <= th.x1 && y >= th.y0 && y <= th.y1 && z >= th.z0 &&
        z <= th.z1)
      c = kSelfcar;
    classes[i] = c;
    lost = lost_new;
    px = x;
    py = y;
    pz = z;
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
  ground_walk_kernel<<<(A + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(range, xyz, p0, R, A, th, classes);
  return (int)cudaGetLastError();
}

}  // extern "C"
