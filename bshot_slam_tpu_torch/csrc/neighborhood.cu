// Radius-neighbourhood accumulation on Hopper (kernels A and B).
//
// A replaces bshot_slam_tpu/kernels/neighborhood.py:neighborhood_accumulate
// (_accum_kernel):  out[i] = sum_j [d2(p_i,p_j) <= r2_i] mask_i mask_j feat[j].
// B replaces segratio_accumulate (_segratio_kernel): per query, over its
// in-radius points j, the counts of sign(v_i.p_j - v_i.q_i) and the CVS dot
// sum or the CVSN cosine sum.
//
// Design: one thread per query, 128 queries per block.  The block walks the
// cloud in tiles of 128 candidates staged in shared memory (coordinates,
// |p|^2, mask and, for A, up to 16 feature columns) and accumulates in f32
// registers: no atomics, so results are deterministic.
//
// Work, counted in f32 instructions (kernels/neighborhood.py holds the same
// counts for the bound): a radius test is 8 (dot3: a multiply and 2 FMAs;
// d2: add, multiply, subtract; the clamp; the compare); an in-radius pair
// then costs A one add per feature column and B 10 (dot3, the subtraction,
// two sign tests, two count adds, the d2 > 0 test and the sum's add).  The
// bound counts the radius tests the skips below leave (the pairs of valid
// rows in block-tile pairs that are not separated) at 128 f32 lanes per SM
// per clock.  Two skips cut that work without changing any result:
//   * a tile with no valid row (the dead tail past the cursor among them)
//     has an empty box and is skipped;
//   * a tile whose box lies farther than the radius from the block's query
//     box along some axis is skipped.  The test keeps a margin of 64 ulps of
//     the largest |q|^2 + |p|^2, far above the rounding error of the
//     expanded d2, so a skipped pair could never have passed the radius test.
#include "common.cuh"

namespace {

using namespace bshot;

constexpr int kThreads = 128;
constexpr int kTile = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeat = 16;

// Axis-aligned box (lo[3], hi[3]) and max |p|^2 over the block's valid rows,
// written to box[0..6].  Every thread of the block must call it.
__device__ void block_box(bool ok, float x, float y, float z, float n2,
                          float* red, float* box) {
  float v[7] = {ok ? x : INFINITY, ok ? y : INFINITY, ok ? z : INFINITY,
                ok ? x : -INFINITY, ok ? y : -INFINITY, ok ? z : -INFINITY,
                ok ? n2 : 0.0f};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
#pragma unroll
    for (int k = 3; k < 7; ++k)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 7; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < 7) {
    const int k = threadIdx.x;
    float r = red[k * kWarps];
    for (int w = 1; w < kWarps; ++w)
      r = k < 3 ? fminf(r, red[k * kWarps + w]) : fmaxf(r, red[k * kWarps + w]);
    box[k] = r;
  }
  __syncthreads();
}

// True when no pair between the two boxes can pass d2 <= r2 (see header).
__device__ __forceinline__ bool separated(const float* qb, const float* rb,
                                          float r2) {
  if (!(qb[0] <= qb[3]) || !(rb[0] <= rb[3])) return true;  // an empty box
  const float slack = (qb[6] + rb[6] + r2) * 0x1p-18f;
  const float lim = r2 + slack;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float gap = fmaxf(qb[d] - rb[3 + d], rb[d] - qb[3 + d]);
    if (gap > 0.0f && gap * gap > lim) return true;
  }
  return false;
}

struct Query {
  bool ok;
  float x, y, z, qq, r2;
};

__device__ __forceinline__ Query load_query(const float* pts, const uint8_t* mask,
                                            const float* r2row, float r2, int n,
                                            float* red, float* qbox) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  Query q;
  q.ok = i < n && mask[i];
  q.x = q.ok ? pts[3 * i] : 0.0f;
  q.y = q.ok ? pts[3 * i + 1] : 0.0f;
  q.z = q.ok ? pts[3 * i + 2] : 0.0f;
  q.qq = norm2(q.x, q.y, q.z);
  q.r2 = (q.ok && r2row != nullptr) ? r2row[i] : r2;
  block_box(q.ok, q.x, q.y, q.z, q.qq, red, qbox);
  return q;
}

// Stage candidate tile [t0, t0 + kTile) and its box; returns whether the
// block may skip it.  Every thread of the block must call it.
__device__ __forceinline__ bool stage_tile(const float* pts, const uint8_t* mask,
                                           int n, int t0, float r2, float* sx,
                                           float* sy, float* sz, float* spp,
                                           uint8_t* sok, float* red,
                                           const float* qbox, float* rbox) {
  const int j = t0 + threadIdx.x;
  const bool ok = j < n && mask[j];
  const float x = ok ? pts[3 * j] : 0.0f;
  const float y = ok ? pts[3 * j + 1] : 0.0f;
  const float z = ok ? pts[3 * j + 2] : 0.0f;
  const float pp = norm2(x, y, z);
  sx[threadIdx.x] = x;
  sy[threadIdx.x] = y;
  sz[threadIdx.x] = z;
  spp[threadIdx.x] = pp;
  sok[threadIdx.x] = ok;
  block_box(ok, x, y, z, pp, red, rbox);  // ends with __syncthreads
  return separated(qbox, rbox, r2);
}

__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                  const float* __restrict__ feat, const float* __restrict__ r2row,
                  float* __restrict__ out, int n, int nf, float r2) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], spp[kTile];
  __shared__ uint8_t sok[kTile];
  __shared__ float sfeat[kMaxFeat * kTile];
  __shared__ float red[7 * kWarps], qbox[7], rbox[7];

  const Query q = load_query(pts, mask, r2row, r2, n, red, qbox);
  float acc[kMaxFeat];
#pragma unroll
  for (int f = 0; f < kMaxFeat; ++f) acc[f] = 0.0f;

  if (qbox[0] <= qbox[3]) {  // the block holds a valid query
    for (int t0 = 0; t0 < n; t0 += kTile) {
      // The feature loads are issued before the box test so that their
      // latency overlaps it; a masked row (the dead tail among them) loads
      // nothing.  Staging them only for kept tiles, after the test, measured
      // slower: the loads then wait behind the test's barriers.
      const int j = t0 + threadIdx.x;
      const bool live = j < n && mask[j];
      for (int f = 0; f < nf; ++f)
        sfeat[f * kTile + threadIdx.x] = live ? feat[(size_t)j * nf + f] : 0.0f;
      const bool skip = stage_tile(pts, mask, n, t0, r2, sx, sy, sz, spp, sok,
                                   red, qbox, rbox);
      if (!skip && q.ok) {
        const int tn = min(kTile, n - t0);
        for (int t = 0; t < tn; ++t) {
          if (!sok[t]) continue;
          const float d2 =
              pair_d2(q.qq, spp[t], dot3(q.x, q.y, q.z, sx[t], sy[t], sz[t]));
          if (d2 <= q.r2) {
#pragma unroll
            for (int f = 0; f < kMaxFeat; ++f)
              if (f < nf) acc[f] += sfeat[f * kTile + t];
          }
        }
      }
      __syncthreads();
    }
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
#pragma unroll
    for (int f = 0; f < kMaxFeat; ++f)
      if (f < nf) out[(size_t)i * nf + f] = q.ok ? acc[f] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
segratio_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                const float* __restrict__ ctvec, const float* __restrict__ r2row,
                float* __restrict__ out, int n, int normalized, float r2) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], spp[kTile];
  __shared__ uint8_t sok[kTile];
  __shared__ float red[7 * kWarps], qbox[7], rbox[7];

  const Query q = load_query(pts, mask, r2row, r2, n, red, qbox);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float vx = q.ok ? ctvec[3 * i] : 0.0f;
  const float vy = q.ok ? ctvec[3 * i + 1] : 0.0f;
  const float vz = q.ok ? ctvec[3 * i + 2] : 0.0f;
  const float vq = dot3(vx, vy, vz, q.x, q.y, q.z);
  const float vnorm = sqrtf(norm2(vx, vy, vz));
  float pos = 0.0f, neg = 0.0f, ssum = 0.0f;

  if (qbox[0] <= qbox[3]) {
    for (int t0 = 0; t0 < n; t0 += kTile) {
      const bool skip = stage_tile(pts, mask, n, t0, r2, sx, sy, sz, spp, sok,
                                   red, qbox, rbox);
      if (!skip && q.ok) {
        const int tn = min(kTile, n - t0);
        for (int t = 0; t < tn; ++t) {
          if (!sok[t]) continue;
          const float d2 =
              pair_d2(q.qq, spp[t], dot3(q.x, q.y, q.z, sx[t], sy[t], sz[t]));
          if (!(d2 <= q.r2)) continue;
          const float dots = __fsub_rn(dot3(vx, vy, vz, sx[t], sy[t], sz[t]), vq);
          pos += dots > 0.0f ? 1.0f : 0.0f;
          neg += dots < 0.0f ? 1.0f : 0.0f;
          if (normalized) {
            const float denom = vnorm * sqrtf(d2);
            if (denom > 0.0f) ssum += dots / fmaxf(denom, 1e-12f);
          } else if (d2 > 0.0f) {
            ssum += dots;
          }
        }
      }
      __syncthreads();
    }
  }
  if (i < n) {
    out[3 * i] = q.ok ? pos : 0.0f;
    out[3 * i + 1] = q.ok ? neg : 0.0f;
    out[3 * i + 2] = q.ok ? ssum : 0.0f;
  }
}

}  // namespace

extern "C" {

int bshot_neighborhood_accumulate(const float* pts, const uint8_t* mask,
                                  const float* feat, const float* r2row,
                                  float* out, int n, int nf, float r2,
                                  void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    accumulate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pts, mask, feat, r2row, out, n, nf, r2);
  }
  return (int)cudaGetLastError();
}

int bshot_segratio_accumulate(const float* pts, const uint8_t* mask,
                              const float* ctvec, const float* r2row, float* out,
                              int n, int normalized, float r2, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    segratio_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pts, mask, ctvec, r2row, out, n, normalized, r2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
