// The closed-form 3x3 symmetric eigendecomposition on Hopper (kernel I).
//
// I replaces no Pallas kernel: it is `geometry/eig3.py:eigh3`, which the
// plain path runs as ~645 elementwise PyTorch operations on (B,)-shaped
// components, one launch each, twice a frame (the normals' covariances of
// every cloud row, and the 600 keypoints' local reference frames).  The
// work per matrix is tiny and independent, so one thread takes one matrix
// through the whole solve in registers: the trigonometric eigenvalues with
// the isotropic guard, the cross-product eigenvectors of the extreme
// eigenvalues with their repeated-eigenvalue and zero fallbacks, one
// Rayleigh polish and re-solve of each, the Rayleigh eigenvalues, v2
// orthogonalised against v0 and the middle vector as their cross product.
//
// Bound: 36 bytes read and 48 written per matrix (EIG3_BYTES in
// kernels/eig3.py); at 131,072 matrices ~11 MB, ~3.3 us at 3.35 TB/s.  The
// arithmetic is the plain version's ~645 elementwise operations a matrix
// (an acosf, two cosf, 28 divisions and 10 square roots among them), a few
// microseconds across the card's 132 SMs: one of the plain path's launches
// costs about as much as the whole solve.  Blocks of 128 threads, a grid
// over the batch, the tail masked.
//
// Rounding: the plain version runs one PyTorch operation per step, so
// nothing there is contracted into an FMA, and ATen's CUDA kernels compute
// a true division by a Python scalar (`/ 3.0`, `/ 6.0`) as a product with
// the float32 reciprocal.  The kernel writes every product, sum, quotient
// and square root with the _rn intrinsics in the plain expression's order
// (`2.0 * p * p * p` is ((2 p) p) p), a clamp as ATen's (a NaN passes,
// else fmaxf / fminf), a `torch.where` as a select (signed zeros and NaNs
// pass through), and the same acosf and cosf, so its outputs equal the
// plain version's on the same CUDA tensors bit for bit.  The clamps at
// 1e-40 are float32 subnormals: never build this file with -ftz=true or
// --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// Python floats become float32 operands; each is rounded from its double.
constexpr float kEps = (float)1e-12;
constexpr float kTiny = (float)1e-40;  // subnormal
constexpr float kIso = (float)1e-10;
constexpr float kN2Min = (float)1e-20;
constexpr float kTwoPiThird = (float)(2.0 * 3.141592653589793 / 3.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi) as ATen's CUDA kernels.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

struct Sym {  // a00, a11, a22, a01, a12, a02
  float a00, a11, a22, a01, a12, a02;
};

struct Vec {
  float x, y, z;
};

// _eigvals_c: (l3 smallest, l1 largest); the plain l2 is not used by eigh3.
__device__ __forceinline__ void eigvals(const Sym& c, float& l3, float& l1) {
  const float third = __fdiv_rn(1.0f, 3.0f), sixth = __fdiv_rn(1.0f, 6.0f);
  const float q = mul(add(add(c.a00, c.a11), c.a22), third);
  const float b00 = sub(c.a00, q), b11 = sub(c.a11, q), b22 = sub(c.a22, q);
  const float off = add(add(mul(c.a01, c.a01), mul(c.a12, c.a12)), mul(c.a02, c.a02));
  const float p2 = mul(add(add(add(mul(b00, b00), mul(b11, b11)), mul(b22, b22)),
                           mul(off, 2.0f)),
                       sixth);
  const float p = __fsqrt_rn(clamp_min(p2, kEps));
  const float detB =
      add(sub(mul(b00, sub(mul(b11, b22), mul(c.a12, c.a12))),
              mul(c.a01, sub(mul(c.a01, b22), mul(c.a12, c.a02)))),
          mul(c.a02, sub(mul(c.a01, c.a12), mul(b11, c.a02))));
  const float r = clamp(div(detB, clamp_min(mul(mul(mul(p, 2.0f), p), p), kEps)),
                        -1.0f, 1.0f);
  const float phi = mul(acosf(r), third);
  const float p_2 = mul(p, 2.0f);
  l1 = add(q, mul(p_2, cosf(phi)));
  l3 = add(q, mul(p_2, cosf(add(phi, kTwoPiThird))));
  const bool iso = p2 < mul(clamp_min(mul(q, q), 1.0f), kIso);
  l1 = iso ? q : l1;
  l3 = iso ? q : l3;
}

// _eigvec_c: the largest cross product of rows of (A - lam I), or a vector
// orthogonal to its largest row, or (1, 0, 0).
__device__ __forceinline__ Vec eigvec(const Sym& c, float lam) {
  const float a01 = c.a01, a12 = c.a12, a02 = c.a02;
  const float m00 = sub(c.a00, lam), m11 = sub(c.a11, lam), m22 = sub(c.a22, lam);
  const float c01x = sub(mul(a01, a12), mul(a02, m11));
  const float c01y = sub(mul(a02, a01), mul(m00, a12));
  const float c01z = sub(mul(m00, m11), mul(a01, a01));
  const float c02x = sub(mul(a01, m22), mul(a02, a12));
  const float c02y = sub(mul(a02, a02), mul(m00, m22));
  const float c02z = sub(mul(m00, a12), mul(a01, a02));
  const float c12x = sub(mul(m11, m22), mul(a12, a12));
  const float c12y = sub(mul(a12, a02), mul(a01, m22));
  const float c12z = sub(mul(a01, a12), mul(m11, a02));
  const float n01 = add(add(mul(c01x, c01x), mul(c01y, c01y)), mul(c01z, c01z));
  const float n02 = add(add(mul(c02x, c02x), mul(c02y, c02y)), mul(c02z, c02z));
  const float n12 = add(add(mul(c12x, c12x), mul(c12y, c12y)), mul(c12z, c12z));
  const bool use02 = n02 > n01;
  float bx = use02 ? c02x : c01x;
  float by = use02 ? c02y : c01y;
  float bz = use02 ? c02z : c01z;
  float bn = use02 ? n02 : n01;
  const bool use12 = n12 > bn;
  bx = use12 ? c12x : bx;
  by = use12 ? c12y : by;
  bz = use12 ? c12z : bz;
  bn = use12 ? n12 : bn;
  // Repeated eigenvalue: a vector orthogonal to the largest row of M.
  const float n0 = add(add(mul(m00, m00), mul(a01, a01)), mul(a02, a02));
  const float n1 = add(add(mul(a01, a01), mul(m11, m11)), mul(a12, a12));
  const float n2 = add(add(mul(a02, a02), mul(a12, a12)), mul(m22, m22));
  float rx = m00, ry = a01, rz = a02, rn = n0;
  const bool take1 = n1 > rn;
  rx = take1 ? a01 : rx;
  ry = take1 ? m11 : ry;
  rz = take1 ? a12 : rz;
  rn = take1 ? n1 : rn;
  const bool take2 = n2 > rn;
  rx = take2 ? a02 : rx;
  ry = take2 ? a12 : ry;
  rz = take2 ? m22 : rz;
  rn = take2 ? n2 : rn;
  // r x x_hat = (0, rz, -ry);  r x y_hat = (-rz, 0, rx): the larger.
  const float na = add(mul(ry, ry), mul(rz, rz));
  const float nb = add(mul(rx, rx), mul(rz, rz));
  const bool use_b = nb > na;
  const float ox = use_b ? -rz : 0.0f;
  const float oy = use_b ? 0.0f : rz;
  const float oz = use_b ? rx : -ry;
  const float on = use_b ? nb : na;

  const float norm = __fsqrt_rn(clamp_min(bn, kTiny));
  const float onorm = __fsqrt_rn(clamp_min(on, kTiny));
  const bool ok = bn > add(mul(mul(rn, kEps), rn), kTiny);
  const bool ok2 = on > kTiny;
  return Vec{ok ? div(bx, norm) : (ok2 ? div(ox, onorm) : 1.0f),
             ok ? div(by, norm) : (ok2 ? div(oy, onorm) : 0.0f),
             ok ? div(bz, norm) : (ok2 ? div(oz, onorm) : 0.0f)};
}

// _rayleigh_c: v . (A v).
__device__ __forceinline__ float rayleigh(const Sym& c, const Vec& v) {
  const float avx = add(add(mul(c.a00, v.x), mul(c.a01, v.y)), mul(c.a02, v.z));
  const float avy = add(add(mul(c.a01, v.x), mul(c.a11, v.y)), mul(c.a12, v.z));
  const float avz = add(add(mul(c.a02, v.x), mul(c.a12, v.y)), mul(c.a22, v.z));
  return add(add(mul(v.x, avx), mul(v.y, avy)), mul(v.z, avz));
}

__global__ void __launch_bounds__(kThreads)
eig3_kernel(const float* __restrict__ A, int B, float* __restrict__ evals,
            float* __restrict__ evecs) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* a = A + (size_t)b * 9;
  const Sym c{a[0], a[4], a[8], a[1], a[5], a[2]};
  float l3, l1;
  eigvals(c, l3, l1);
  Vec v0 = eigvec(c, l3);
  Vec v2 = eigvec(c, l1);
  v0 = eigvec(c, rayleigh(c, v0));
  v2 = eigvec(c, rayleigh(c, v2));
  l3 = rayleigh(c, v0);
  l1 = rayleigh(c, v2);
  const float l2 = sub(sub(add(add(c.a00, c.a11), c.a22), l3), l1);
  // Orthogonalise: v2 against v0, the middle vector as their cross product.
  const float dot = add(add(mul(v0.x, v2.x), mul(v0.y, v2.y)), mul(v0.z, v2.z));
  v2 = Vec{sub(v2.x, mul(dot, v0.x)), sub(v2.y, mul(dot, v0.y)),
           sub(v2.z, mul(dot, v0.z))};
  const float n2 = clamp_min(
      __fsqrt_rn(add(add(mul(v2.x, v2.x), mul(v2.y, v2.y)), mul(v2.z, v2.z))), kN2Min);
  v2 = Vec{div(v2.x, n2), div(v2.y, n2), div(v2.z, n2)};
  const Vec v1{sub(mul(v2.y, v0.z), mul(v2.z, v0.y)),
               sub(mul(v2.z, v0.x), mul(v2.x, v0.z)),
               sub(mul(v2.x, v0.y), mul(v2.y, v0.x))};
  float* lam = evals + (size_t)b * 3;
  lam[0] = l3;
  lam[1] = l2;
  lam[2] = l1;
  float* V = evecs + (size_t)b * 9;  // columns v0, v1, v2
  V[0] = v0.x; V[1] = v1.x; V[2] = v2.x;
  V[3] = v0.y; V[4] = v1.y; V[5] = v2.y;
  V[6] = v0.z; V[7] = v1.z; V[8] = v2.z;
}

}  // namespace

extern "C" {

// A (B, 3, 3) float32 symmetric, contiguous; evals (B, 3) ascending and
// evecs (B, 3, 3) with evecs[b, :, i] pairing evals[b, i], float32.
int bshot_eigh3(const float* A, int B, float* evals, float* evecs, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  eig3_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      A, B, evals, evecs);
  return (int)cudaGetLastError();
}

}  // extern "C"
