// Bounded nearest-neighbour kernels against the map on Hopper (C, D, E).
//
// C replaces bshot_slam_tpu/kernels/mapops.py:hamming_nn_bounded: two-sided
//   Hamming nearest neighbours between ~600 source B-SHOTs and the candidates.
// D replaces euclid_nn_bounded: per query the nearest candidate's clamped d2
//   and its index (the ICP correspondence search, 10 calls per frame).
// E replaces dedup_blocked_bounded: per newcomer, whether a map row in
//   [0, n_valid) blocks it (same voxel block, d2 < r^2, seg_ratio >= its own).
//
// Candidate rows are live when j < n_valid, or j >= tail_start when
// tail_start >= 0 (the previous frame's keypoints ride after the map
// region); other rows are dead.  A row with no live valid candidate reports
// (3e38, index 0), ties go to the lowest index: the reference's semantics.
//
// C and E: the per-query side is one thread per query and a grid over
// candidate chunks of 128 rows staged in shared memory; chunks wholly dead
// exit at once, so work follows the live map, not the buffer.  Each thread
// keeps its running (distance, lowest index) for its chunk and merges it with
// one 64-bit atomicMin on (distance bits << 32 | index): distances are >= 0,
// so the bits order like the values and the lowest index wins ties across
// blocks.  C's per-candidate side is one thread per candidate walking the
// sources in shared-memory tiles.  B-SHOTs stay packed: 11 XOR + __popc per
// pair.
//
// D is one launch per call and is bound by f32 instructions (~1.6e7 pairs of
// ~10 instructions against 0.4 MB of input); the K=3 cross term must round
// like common.cuh's FMA chain, so the tensor cores are of no use (wgmma has
// no IEEE f32 input mode).  At this size a call is a few microseconds of
// arithmetic, so the design removes what surrounded it: two extra launches,
// ~150k contended 64-bit atomics and part-empty blocks.
//   * The grid is (splits of the live rows) x (blocks of 64 queries).  The
//     live rows [0, n_valid) and [tail_start, end) are numbered as one run,
//     which the splits share evenly: dead rows cost nothing whatever n_valid
//     (read on the device) is, and every block has the same work.
//   * A block stages its rows once as float4 (x, y, z, |p|^2), masked rows
//     inert ((0, 0, 0, +inf): d2 = +inf never beats 3e38), so the inner loop
//     reads no mask.  Its 8 warps take the rows in turn; a lane keeps two
//     queries in registers, so one broadcast float4 read feeds two
//     independent chains, and 600 queries fill 9.4 of 10 query blocks.
//   * A thread visits its rows in ascending order and replaces its minimum
//     only by a smaller d2, the warps' results meet in shared memory as
//     (d2 bits << 32 | index) keys, and the block writes one key per query
//     to scratch.  The last block of a query block to finish (a counter
//     behind __threadfence) takes the minimum key over the splits and writes
//     d2 and index: lowest index on ties, in one launch, without atomics on
//     the results.
//
// Work per pair of valid live rows (kernels/mapops.py holds the same counts
// for the bound): C, 11 XOR, 11 adds and a compare (32-bit integer, 64
// lanes per SM per clock) and 11 __popc (16 lanes per SM per clock), so
// popc sets C's bound; the distance of a pair is counted once although the
// two sides each compute it.  D, 8 f32 instructions (dot3: a multiply and 2
// FMAs; d2: add, multiply, subtract; the clamp; the compare).  E, 3 integer
// compares of the block keys and one f32 compare of the seg ratios, plus the
// 8 of a distance test for pairs in the same block.  At a small live map a
// launch costs about its launch overhead.
#include "common.cuh"

namespace {

using namespace bshot;

constexpr int kThreads = 128;
constexpr int kChunk = 128;
constexpr int kWords = 11;

__device__ __forceinline__ bool chunk_dead(int c0, int c1, int n_valid,
                                           int tail_start) {
  return c0 >= n_valid && (tail_start < 0 || c1 <= tail_start);
}

__global__ void init_keys(unsigned long long* key, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) key[i] = pack_key(kBig, 0);
}

__global__ void unpack_keys(const unsigned long long* key, float* dmin,
                            int32_t* darg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = key[i];
    dmin[i] = __uint_as_float(static_cast<unsigned int>(k >> 32));
    darg[i] = static_cast<int32_t>(k & 0xffffffffull);
  }
}

__device__ __forceinline__ int hamming(const int32_t* a, const int32_t* b) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) d += __popc(a[w] ^ b[w]);
  return d;
}

// C, per source: min and lowest argmin over the live valid candidates.
__global__ void __launch_bounds__(kThreads)
hamming_source_kernel(const int32_t* __restrict__ a, const uint8_t* __restrict__ am,
                      const int32_t* __restrict__ b, const uint8_t* __restrict__ bm,
                      const int32_t* __restrict__ nv_ptr, int ka, int cb,
                      int tail_start, unsigned long long* __restrict__ akey) {
  __shared__ int32_t sb[kChunk * kWords];
  __shared__ uint8_t sok[kChunk];
  const int n_valid = *nv_ptr;
  const int c0 = blockIdx.x * kChunk, c1 = min(c0 + kChunk, cb);
  if (chunk_dead(c0, c1, n_valid, tail_start)) return;
  for (int k = threadIdx.x; k < kChunk * kWords; k += kThreads) {
    const int j = c0 + k / kWords;
    sb[k] = j < c1 ? b[(size_t)c0 * kWords + k] : 0;
  }
  const int jt = c0 + threadIdx.x;
  sok[threadIdx.x] = jt < c1 && bm[jt] && live_row(jt, n_valid, tail_start);
  __syncthreads();

  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= ka || !am[i]) return;
  int32_t aw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) aw[w] = a[(size_t)i * kWords + w];
  int best = 1 << 30, arg = 0;
  for (int t = 0; t < c1 - c0; ++t) {
    if (!sok[t]) continue;
    const int d = hamming(aw, sb + t * kWords);
    if (d < best) { best = d; arg = c0 + t; }
  }
  if (best < (1 << 30)) atomicMin(akey + i, pack_key((float)best, arg));
}

// C, per candidate: min and lowest argmin over the valid sources.
__global__ void __launch_bounds__(kThreads)
hamming_candidate_kernel(const int32_t* __restrict__ a, const uint8_t* __restrict__ am,
                         const int32_t* __restrict__ b, const uint8_t* __restrict__ bm,
                         const int32_t* __restrict__ nv_ptr, int ka, int cb,
                         int tail_start, float* __restrict__ bmin,
                         int32_t* __restrict__ barg) {
  __shared__ int32_t sa[kChunk * kWords];
  __shared__ uint8_t sok[kChunk];
  const int n_valid = *nv_ptr;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int c0 = blockIdx.x * kThreads, c1 = min(c0 + kThreads, cb);
  if (chunk_dead(c0, c1, n_valid, tail_start)) {
    if (j < cb) { bmin[j] = kBig; barg[j] = 0; }
    return;
  }
  const bool ok = j < cb && bm[j] && live_row(j, n_valid, tail_start);
  int32_t bw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) bw[w] = ok ? b[(size_t)j * kWords + w] : 0;
  int best = 1 << 30, arg = 0;
  for (int s0 = 0; s0 < ka; s0 += kChunk) {
    const int sn = min(kChunk, ka - s0);
    for (int k = threadIdx.x; k < kChunk * kWords; k += kThreads)
      sa[k] = k < sn * kWords ? a[(size_t)s0 * kWords + k] : 0;
    sok[threadIdx.x] = threadIdx.x < sn && am[s0 + threadIdx.x];
    __syncthreads();
    if (ok) {
      for (int t = 0; t < sn; ++t) {
        if (!sok[t]) continue;
        const int d = hamming(bw, sa + t * kWords);
        if (d < best) { best = d; arg = s0 + t; }
      }
    }
    __syncthreads();
  }
  if (j < cb) {
    bmin[j] = best < (1 << 30) ? (float)best : kBig;
    barg[j] = arg;
  }
}

// ---- Kernel D -------------------------------------------------------------

constexpr int kDThreads = 256;
constexpr int kDWarps = kDThreads / 32;
constexpr int kDPerLane = 2;                // queries a lane keeps in registers
constexpr int kDQueries = 32 * kDPerLane;   // queries per block
constexpr int kDRows = 2048;                // most rows a block stages

// D: per query, min clamped d2 and its lowest index over live valid rows.
// Split blockIdx.x of gridDim.x, query block blockIdx.y (see the header).
__global__ void __launch_bounds__(kDThreads)
euclid_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qm,
              const float* __restrict__ r, const uint8_t* __restrict__ rm,
              const int32_t* __restrict__ nv_ptr, int kq, int cr, int tail_start,
              unsigned long long* __restrict__ part,
              int* __restrict__ counters, float* __restrict__ dmin,
              int32_t* __restrict__ darg) {
  __shared__ __align__(16) float4 sc[kDRows];
  __shared__ unsigned long long skey[kDWarps][kDQueries];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nsplit = gridDim.x;

  // Live rows as one run: v in [0, lo) is row v, v >= lo is row v - lo + t0.
  const int lo = min(max(*nv_ptr, 0), cr);
  const int t0 = tail_start < 0 ? cr : min(max(tail_start, lo), cr);
  const int live = lo + (cr - t0);
  const int per = (live + nsplit - 1) / nsplit;  // <= kDRows: the wrapper picks nsplit so
  const int v0 = min((int)blockIdx.x * per, live);
  const int cnt = min(v0 + per, live) - v0;

  for (int s = tid; s < cnt; s += kDThreads) {
    const int v = v0 + s;
    const size_t j = v < lo ? v : v - lo + t0;
    const bool ok = rm[j];
    const float x = ok ? r[3 * j] : 0.0f;
    const float y = ok ? r[3 * j + 1] : 0.0f;
    const float z = ok ? r[3 * j + 2] : 0.0f;
    sc[s] = make_float4(x, y, z, ok ? norm2(x, y, z) : INFINITY);
  }
  __syncthreads();

  const int i0 = blockIdx.y * kDQueries;
  float qx[kDPerLane], qy[kDPerLane], qz[kDPerLane], qq[kDPerLane], best[kDPerLane];
  int arg[kDPerLane];
  bool okq[kDPerLane];
#pragma unroll
  for (int u = 0; u < kDPerLane; ++u) {
    const int i = i0 + lane + 32 * u;
    okq[u] = i < kq && qm[i];
    qx[u] = okq[u] ? q[3 * i] : 0.0f;
    qy[u] = okq[u] ? q[3 * i + 1] : 0.0f;
    qz[u] = okq[u] ? q[3 * i + 2] : 0.0f;
    qq[u] = norm2(qx[u], qy[u], qz[u]);
    best[u] = kBig;
    arg[u] = 0;
  }
#pragma unroll 4
  for (int t = warp; t < cnt; t += kDWarps) {
    const float4 p = sc[t];
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) {
      const float d2 = pair_d2(qq[u], p.w, dot3(qx[u], qy[u], qz[u], p.x, p.y, p.z));
      if (d2 < best[u]) { best[u] = d2; arg[u] = t; }
    }
  }
#pragma unroll
  for (int u = 0; u < kDPerLane; ++u) {
    const int v = v0 + arg[u];
    const int j = v < lo ? v : v - lo + t0;
    skey[warp][lane + 32 * u] =
        (okq[u] && best[u] < kBig) ? pack_key(best[u], j) : pack_key(kBig, 0);
  }
  __syncthreads();

  const int i = i0 + tid;
  const bool mine = tid < kDQueries && i < kq;
  if (mine) {
    unsigned long long k = skey[0][tid];
#pragma unroll
    for (int w = 1; w < kDWarps; ++w) k = min(k, skey[w][tid]);
    part[(size_t)blockIdx.x * kq + i] = k;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.y], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (mine) {
    unsigned long long k = __ldcg(part + i);
    for (int s = 1; s < nsplit; ++s) k = min(k, __ldcg(part + (size_t)s * kq + i));
    dmin[i] = __uint_as_float(static_cast<unsigned int>(k >> 32));
    darg[i] = static_cast<int32_t>(k & 0xffffffffull);
  }
  if (tid == 0) counters[blockIdx.y] = 0;  // ready for the next call on this stream
}

__global__ void zero_flags(int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 0;
}

// E: per newcomer, does any valid map row in [0, n_valid) block it?
__global__ void __launch_bounds__(kThreads)
dedup_kernel(const float* __restrict__ pos, const int32_t* __restrict__ blk,
             const float* __restrict__ seg, const float* __restrict__ mpos,
             const int32_t* __restrict__ mblk, const float* __restrict__ mseg,
             const uint8_t* __restrict__ mvalid, const int32_t* __restrict__ nv_ptr,
             int k, int c, float r2, int32_t* __restrict__ out) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk], spp[kChunk], sseg[kChunk];
  __shared__ int32_t sb0[kChunk], sb1[kChunk], sb2[kChunk];
  __shared__ uint8_t sok[kChunk];
  const int n_valid = *nv_ptr;
  const int c0 = blockIdx.x * kChunk, c1 = min(c0 + kChunk, c);
  if (chunk_dead(c0, c1, n_valid, -1)) return;
  const int jt = c0 + threadIdx.x;
  const bool okj = jt < c1 && jt < n_valid && mvalid[jt];
  const float x = okj ? mpos[3 * (size_t)jt] : 0.0f;
  const float y = okj ? mpos[3 * (size_t)jt + 1] : 0.0f;
  const float z = okj ? mpos[3 * (size_t)jt + 2] : 0.0f;
  sx[threadIdx.x] = x;
  sy[threadIdx.x] = y;
  sz[threadIdx.x] = z;
  spp[threadIdx.x] = norm2(x, y, z);
  sseg[threadIdx.x] = okj ? mseg[jt] : 0.0f;
  sb0[threadIdx.x] = okj ? mblk[3 * (size_t)jt] : 0;
  sb1[threadIdx.x] = okj ? mblk[3 * (size_t)jt + 1] : 0;
  sb2[threadIdx.x] = okj ? mblk[3 * (size_t)jt + 2] : 0;
  sok[threadIdx.x] = okj;
  __syncthreads();

  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= k) return;
  const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  const float qq = norm2(px, py, pz);
  const int b0 = blk[3 * i], b1 = blk[3 * i + 1], b2 = blk[3 * i + 2];
  const float s = seg[i];
  for (int t = 0; t < c1 - c0; ++t) {
    if (!sok[t] || sb0[t] != b0 || sb1[t] != b1 || sb2[t] != b2 || !(sseg[t] >= s))
      continue;
    const float d2 = pair_d2(qq, spp[t], dot3(px, py, pz, sx[t], sy[t], sz[t]));
    if (d2 < r2) { out[i] = 1; return; }
  }
}

inline int grid1(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int bshot_hamming_nn_bounded(const int32_t* a, const uint8_t* am, const int32_t* b,
                             const uint8_t* bm, const int32_t* nv, int ka, int cb,
                             int tail_start, unsigned long long* akey, float* amin,
                             int32_t* aarg, float* bmin, int32_t* barg,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ka > 0) init_keys<<<grid1(ka), kThreads, 0, st>>>(akey, ka);
  if (ka > 0 && cb > 0) {
    dim3 g((cb + kChunk - 1) / kChunk, grid1(ka));
    hamming_source_kernel<<<g, kThreads, 0, st>>>(a, am, b, bm, nv, ka, cb,
                                                  tail_start, akey);
  }
  if (cb > 0)
    hamming_candidate_kernel<<<grid1(cb), kThreads, 0, st>>>(
        a, am, b, bm, nv, ka, cb, tail_start, bmin, barg);
  if (ka > 0) unpack_keys<<<grid1(ka), kThreads, 0, st>>>(akey, amin, aarg, ka);
  return (int)cudaGetLastError();
}

// Scratch from the caller: part nsplit * kq keys, counters ceil(kq / 64)
// ints, zero before the first call.  nsplit * 2048 >= cr.
int bshot_euclid_nn_bounded(const float* q, const uint8_t* qm, const float* r,
                            const uint8_t* rm, const int32_t* nv, int kq, int cr,
                            int tail_start, int nsplit, unsigned long long* part,
                            int* counters, float* dmin, int32_t* darg,
                            void* stream) {
  if (kq <= 0) return 0;
  if (cr < 0 || nsplit < 1 || (long long)nsplit * kDRows < cr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, (kq + kDQueries - 1) / kDQueries);
  euclid_kernel<<<grid, kDThreads, 0, (cudaStream_t)stream>>>(
      q, qm, r, rm, nv, kq, cr, tail_start, part, counters, dmin, darg);
  return (int)cudaGetLastError();
}

int bshot_dedup_blocked_bounded(const float* pos, const int32_t* blk,
                                const float* seg, const float* mpos,
                                const int32_t* mblk, const float* mseg,
                                const uint8_t* mvalid, const int32_t* nv, int k,
                                int c, float r2, int32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k > 0) zero_flags<<<grid1(k), kThreads, 0, st>>>(out, k);
  if (k > 0 && c > 0) {
    dim3 g((c + kChunk - 1) / kChunk, grid1(k));
    dedup_kernel<<<g, kThreads, 0, st>>>(pos, blk, seg, mpos, mblk, mseg, mvalid,
                                         nv, k, c, r2, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
