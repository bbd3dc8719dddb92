// Radius-neighbourhood accumulation on Hopper (kernels A and B).
//
// A replaces bshot_slam_tpu/kernels/neighborhood.py:neighborhood_accumulate
// (_accum_kernel):  out[i] = sum_j [d2(p_i,p_j) <= r2_i] mask_i mask_j feat[j].
// B replaces segratio_accumulate (_segratio_kernel): per query, over its
// in-radius points j, the counts of sign(v_i.p_j - v_i.q_i) and the CVS dot
// sum or the CVSN cosine sum.
//
// What bounds them.  Both are bound by f32 instructions, not bytes: the
// cloud and its features (under 1 MB) sit in L2, while a frame makes ~2e7
// radius tests of ~10 instructions and, for A, one add per feature column
// for the more than half of them that pass.  The K=3 cross term must round
// like common.cuh's FMA chain, so it cannot go to the tensor cores (wgmma
// has no IEEE f32 input mode, and TF32 moves points across the shell); what
// the card offers these kernels is shared memory, 16-byte loads,
// asynchronous copies and many resident warps.
//
// Kernel A is two launches.
//   1. pack_cloud_kernel, one block per tile of 128 rows, once per call:
//      candidates become float4 (x, y, z, |p|^2) with masked rows inert
//      ((0, 0, 0, +inf): their d2 is +inf, so neither a masked candidate nor
//      a masked query ever passes d2 <= r2 and the main kernel reads no
//      mask); feature rows are padded to a multiple of 4 floats, so a row is
//      16-byte loads, and zeroed for masked rows; every tile's box and
//      largest |p|^2 are computed once.
//   2. accumulate_kernel, grid (query blocks of 128) x (splits).  A block
//      tests its query box against every tile box (one tile per thread, a
//      ballot compacts the kept ones in ascending order) and takes every
//      nsplit-th kept tile; rejected tiles cost no load and no barrier.
//      Kept tiles arrive through a ring of three shared-memory stages filled
//      by 16-byte cp.async copies (a packed tile is contiguous), so the next
//      tiles load while this one is tested, with one barrier per tile.  Each
//      thread keeps one query and its sums in registers and reads every
//      candidate as one broadcast float4; a warp adds a candidate's features
//      only when one of its 32 queries is in radius, and then without a
//      divergent branch: acc = fma(w, feat, acc) with w in {0, 1} rounds
//      exactly like acc + feat.  The splits put several blocks on every one
//      of the 132 SMs; their number is fixed (SPLITS in kernels/
//      neighborhood.py), so a row's sum does not depend on how far the
//      cloud is padded.  Each block writes its partial sums to scratch; the
//      last block of a query block to finish (a counter behind
//      __threadfence) adds the partials in ascending split order and writes
//      the result.  No float atomics: the same inputs give the same bits.
//
// Kernel B has the same shape, without feature rows.
//   1. pack_cloud_kernel with no features: the float4 candidates and the
//      tile boxes only.
//   2. segratio_kernel, grid (query blocks of 128) x (splits): the same list
//      of kept tiles, the same ring (a tile is 2 KB of float4 here), one
//      broadcast float4 per candidate.  A thread keeps its query, ctvec,
//      v.q and (pos, neg, sum) in registers.  57% of the tested pairs are in
//      radius, so the accumulation is predicated arithmetic for every pair
//      (pos += in && dots > 0, and so on), with neither a branch nor a warp
//      vote: the vote A needs to skip its feature loads costs B more than
//      the ten instructions it would skip.  `normalized` is a template
//      parameter: CVS carries no square root and no division (CVSN keeps
//      them behind a vote).  Partial (pos, neg, sum) go to scratch as one
//      float4 per query and split, and the last block of a query block adds
//      them in ascending split order: the counts (below 2^24) stay exact,
//      the sum is deterministic.
//
// Work, counted in f32 instructions (kernels/neighborhood.py holds the same
// counts for the bound): a radius test is 8 (dot3: a multiply and 2 FMAs;
// d2: add, multiply, subtract; the clamp; the compare); an in-radius pair
// then costs A one add per feature column and B 10 (dot3, the subtraction,
// two sign tests, two count adds, the d2 > 0 test and the sum's add).  The
// bound counts the radius tests the skips below leave (the pairs of valid
// rows in pairs of 128-row tiles that are not separated) at 128 f32 lanes
// per SM per clock.  Two skips cut that work without changing any result:
//   * a tile with no valid row (the dead tail past the cursor among them)
//     has an empty box and is skipped;
//   * a tile whose box lies farther than the radius from the block's query
//     box along some axis is skipped.  The test keeps a margin of 64 ulps of
//     the largest |q|^2 + |p|^2, far above the rounding error of the
//     expanded d2, so a skipped pair could never have passed the radius test.
//
// Kernel H, `shot_neighbors`, replaces no TPU kernel: it is the neighbour
// selection of bshot_slam_tpu/ops/shot.py:gather_neighbors, which the
// reference leaves to XLA (a (K, N) distance matrix and lax.top_k) and the
// plain version to a stable sort of that matrix.  Per keypoint it returns
// the rows the stable descending sort of score = ok ? -d2 : -inf takes
// first: the ok rows (valid, 0 < d2 <= r2, the keypoint valid) by ascending
// (d2, row), then the other rows by ascending row, m in all.  The work is
// one radius test per (keypoint, row) pair the tile skips leave and m rows
// out: bound by the reads of the packed cloud from L2, since each
// candidate is tested against one keypoint only and shared memory has
// nothing to serve twice.
//   1. shot_pack_kernel: pack_cloud_kernel's packing without features.
//   2. shot_select_kernel, one block of 256 threads a keypoint.  It lists
//      the tiles within reach of the keypoint (its box is the point), then
//      walks them with kSelUnroll 16-byte loads in flight a thread.  Pass 1
//      counts the ok rows (c), histograms their d2 in 4096 bins linear in d2
//      (monotone, so the bins order the keys as the keys do) and appends
//      their keys (d2 bits, row) to shared memory while they fit (2048).
//      If c <= 2048 every key is there.  Otherwise the bin of the m-th key
//      is found; a second walk collects the keys up to that bin, and where
//      they would still overflow (over 1,000 rows at one distance: repeated
//      points), walks refine the cut by 12-bit digits of the key first.
//      The collected keys are sorted in shared memory (bitonic, padded to a
//      power of two) and the first min(c, m) rows written.  The rest of the
//      row comes from an ordered count of the rows that are not ok, from
//      row 0, in chunks of 256, until m are written.  Integer atomics only
//      (shared-memory counts and appends, whose order the sort removes), so
//      the output is the same bits on every run.
//
// Two forms of each kernel, picked on the host by the cloud's row count
// (a static shape, so a captured graph holds one form).  Up to 131072 rows
// (1024 tiles) the narrow form: A's and B's blocks list up to kMaxTiles
// tiles, and H's key holds the row in kIdxBits = 17 bits, so a key is 31
// bits of d2 and 17 of row, 48 in all, refined in four 12-bit digits.
// Past it, up to 262144 rows (2048 tiles), the wide form, the same code
// under the namespace `wide` (the profiler shows `wide::accumulate_kernel`
// and so on): its lists hold kWideTiles tiles, and H's row takes 18 bits,
// so a key is 49 bits and the refinement starts a fifth digit higher (bits
// 48-59, of which only bit 48 is ever set).  The fifth digit costs a walk
// only where the keys up to the m-th key's histogram bin overflow the 2048
// slots after every digit above it, which repeated points alone cause:
// the cut is the same key, so the rows are the stable sort's either way.
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

// ---- What A and B share: cp.async, the tile list, the pre-pass ---------------

constexpr int kStages = 3;      // shared-memory ring of candidate tiles
constexpr int kMaxTiles = 1024;  // tiles a narrow block can list: n <= 131072 rows
constexpr int kWideTiles = 2048;  // tiles a wide block can list: n <= 262144 rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load_box(const float* boxes, int tile, float* box) {
  *reinterpret_cast<float4*>(box) =
      *reinterpret_cast<const float4*>(boxes + tile * 8);
  *reinterpret_cast<float4*>(box + 4) =
      *reinterpret_cast<const float4*>(boxes + tile * 8 + 4);
}

// The tiles within reach of the block's query box, in ascending order (one
// tile per thread, a ballot compacts the kept ones).  Split blockIdx.y of
// gridDim.y takes every gridDim.y-th of them: they go to `list`, their number
// is returned.  Every thread of the block (THREADS of them) must call it;
// `wcount` holds THREADS / 32 ints.
template <int THREADS = kThreads>
__device__ __forceinline__ int list_kept_tiles(const float* boxes, const float* qbox,
                                               int ntiles, float r2, uint16_t* list,
                                               int* wcount) {
  constexpr int kW = THREADS / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.y, nsplit = gridDim.y;
  int total = 0;
  for (int g0 = 0; g0 < ntiles; g0 += THREADS) {
    const int tile = g0 + tid;
    bool keep = false;
    if (tile < ntiles) {
      float rbox[8];
      load_box(boxes, tile, rbox);
      keep = !separated(qbox, rbox, r2);
    }
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount[warp] = __popc(b);
    __syncthreads();
    int pos = total + __popc(b & ((1u << lane) - 1u));
    for (int w = 0; w < kW; ++w) {
      if (w < warp) pos += wcount[w];
      total += wcount[w];
    }
    if (keep && pos % nsplit == split) list[pos / nsplit] = (uint16_t)tile;
    __syncthreads();
  }
  return total > split ? (total - split + nsplit - 1) / nsplit : 0;
}

// Pre-pass of A, B and H: pack tile blockIdx.x (see the header note).
// `cand` holds gridDim.x * kTile rows, `featp` as many rows of nfp floats (B
// and H have no features: nfp = 0 and the pointers are null), `boxes` 8
// floats per tile: lo[3], hi[3], max |p|^2, 0.  Every thread of the block
// (kThreads of them) must call it.
__device__ __forceinline__ void pack_tile(const float* __restrict__ pts,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ feat,
                                          float4* __restrict__ cand,
                                          float* __restrict__ featp,
                                          float* __restrict__ boxes, int n, int nf,
                                          int nfp) {
  __shared__ float red[7 * kWarps], box[7];
  const int t0 = blockIdx.x * kTile;
  const int j = t0 + threadIdx.x;
  const bool ok = j < n && mask[j];
  const float x = ok ? pts[3 * j] : 0.0f;
  const float y = ok ? pts[3 * j + 1] : 0.0f;
  const float z = ok ? pts[3 * j + 2] : 0.0f;
  const float pp = norm2(x, y, z);
  cand[j] = make_float4(x, y, z, ok ? pp : INFINITY);
  for (int k = threadIdx.x; k < kTile * nfp; k += kThreads) {
    const int row = t0 + k / nfp, col = k % nfp;
    const bool live = row < n && col < nf && mask[row];
    featp[(size_t)t0 * nfp + k] = live ? feat[(size_t)row * nf + col] : 0.0f;
  }
  block_box(ok, x, y, z, pp, red, box);
  if (threadIdx.x < 8)
    boxes[blockIdx.x * 8 + threadIdx.x] = threadIdx.x < 7 ? box[threadIdx.x] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
pack_cloud_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                  const float* __restrict__ feat, float4* __restrict__ cand,
                  float* __restrict__ featp, float* __restrict__ boxes, int n,
                  int nf, int nfp) {
  pack_tile(pts, mask, feat, cand, featp, boxes, n, nf, nfp);
}

// H's pre-pass: the same packing without features, under a name of its own.
__global__ void __launch_bounds__(kThreads)
shot_pack_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                 float4* __restrict__ cand, float* __restrict__ boxes, int n) {
  pack_tile(pts, mask, nullptr, cand, nullptr, boxes, n, 0, 0);
}

namespace wide {  // the same pre-passes under the wide form's names

__global__ void __launch_bounds__(kThreads)
pack_cloud_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                  const float* __restrict__ feat, float4* __restrict__ cand,
                  float* __restrict__ featp, float* __restrict__ boxes, int n,
                  int nf, int nfp) {
  pack_tile(pts, mask, feat, cand, featp, boxes, n, nf, nfp);
}

__global__ void __launch_bounds__(kThreads)
shot_pack_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                 float4* __restrict__ cand, float* __restrict__ boxes, int n) {
  pack_tile(pts, mask, nullptr, cand, nullptr, boxes, n, 0, 0);
}

}  // namespace wide

// ---- Kernel A -------------------------------------------------------------

// A, main kernel: query block blockIdx.x, split blockIdx.y of gridDim.y;
// MAXT tiles at most.
template <int NFP, int MAXT>
__device__ __forceinline__ void
accumulate_body(const float4* __restrict__ cand, const float* __restrict__ featp,
                const float* __restrict__ boxes, const float* __restrict__ r2row,
                float4* __restrict__ part, int* __restrict__ counters,
                float* __restrict__ out, int q0, int q1, int nf, int ntiles,
                float r2) {
  constexpr int kF4 = NFP / 4;  // float4 chunks of a feature row
  __shared__ __align__(16) float4 sc[kStages][kTile];
  __shared__ __align__(16) float4 sf[kStages][kTile * kF4];
  __shared__ uint16_t list[MAXT];
  __shared__ int wcount[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int qb = q0 / kTile + blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int i = qb * kTile + tid;  // the query row; out holds rows [q0, q1)

  float qbox[8];
  load_box(boxes, qb, qbox);
  if (!(qbox[0] <= qbox[3])) {  // no valid query in this block: zeros
    if (split == 0 && i < q1)
      for (int f = 0; f < nf; ++f) out[(size_t)(i - q0) * nf + f] = 0.0f;
    return;
  }
  const int mine = list_kept_tiles(boxes, qbox, ntiles, r2, list, wcount);

  const float4 q = cand[i];  // a masked query is inert too
  const float r2q = (r2row != nullptr && i < q1) ? r2row[i] : r2;
  float acc[NFP];
#pragma unroll
  for (int f = 0; f < NFP; ++f) acc[f] = 0.0f;

  auto fetch = [&](int k) {  // start the copy of my k-th tile into its stage
    if (k < mine) {
      const size_t row0 = (size_t)list[k] * kTile;
      const int buf = k % kStages;
      cp_async16(&sc[buf][tid], cand + row0 + tid);
      const float4* src = reinterpret_cast<const float4*>(featp) + row0 * kF4;
#pragma unroll
      for (int c = 0; c < kF4; ++c)
        cp_async16(&sf[buf][c * kThreads + tid], src + c * kThreads + tid);
    }
    cp_async_commit();  // an empty group keeps the count of groups uniform
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<kStages - 2>();  // my copies of tile k have landed
    __syncthreads();  // everyone's have, and tile k - 1 is done with
    fetch(k + kStages - 1);
    const float4* c4 = sc[k % kStages];
    const float4* f4 = sf[k % kStages];
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float4 p = c4[t];
      const float d2 = pair_d2(q.w, p.w, dot3(q.x, q.y, q.z, p.x, p.y, p.z));
      const bool in = d2 <= r2q;
      if (__any_sync(0xffffffffu, in)) {
        const float w = in ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < kF4; ++c) {
          const float4 v = f4[t * kF4 + c];
          acc[4 * c] = __fmaf_rn(w, v.x, acc[4 * c]);
          acc[4 * c + 1] = __fmaf_rn(w, v.y, acc[4 * c + 1]);
          acc[4 * c + 2] = __fmaf_rn(w, v.z, acc[4 * c + 2]);
          acc[4 * c + 3] = __fmaf_rn(w, v.w, acc[4 * c + 3]);
        }
      }
    }
  }

  // Partial sums to scratch; the last block of this query block adds them
  // in ascending split order.
  const size_t stride = (size_t)gridDim.x * kTile * kF4;  // float4 per split
  const size_t row = (size_t)(i - q0);  // this block's rows in part
  float4* mypart = part + split * stride + row * kF4;
#pragma unroll
  for (int c = 0; c < kF4; ++c)
    mypart[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[qb], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int f = 0; f < NFP; ++f) acc[f] = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
#pragma unroll
    for (int c = 0; c < kF4; ++c) {
      const float4 v = __ldcg(part + s * stride + row * kF4 + c);
      acc[4 * c] += v.x;
      acc[4 * c + 1] += v.y;
      acc[4 * c + 2] += v.z;
      acc[4 * c + 3] += v.w;
    }
  }
  if (i < q1) {
#pragma unroll
    for (int f = 0; f < NFP; ++f)
      if (f < nf) out[row * nf + f] = acc[f];
  }
  if (tid == 0) counters[qb] = 0;  // ready for the next call on this stream
}

#define BSHOT_ACCUMULATE_ARGS                                                  \
  const float4 *__restrict__ cand, const float *__restrict__ featp,            \
      const float *__restrict__ boxes, const float *__restrict__ r2row,        \
      float4 *__restrict__ part, int *__restrict__ counters,                   \
      float *__restrict__ out, int q0, int q1, int nf, int ntiles, float r2
#define BSHOT_ACCUMULATE_PASS \
  cand, featp, boxes, r2row, part, counters, out, q0, q1, nf, ntiles, r2

template <int NFP>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(BSHOT_ACCUMULATE_ARGS) {
  accumulate_body<NFP, kMaxTiles>(BSHOT_ACCUMULATE_PASS);
}

namespace wide {
template <int NFP>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(BSHOT_ACCUMULATE_ARGS) {
  accumulate_body<NFP, kWideTiles>(BSHOT_ACCUMULATE_PASS);
}
}  // namespace wide

// ---- Kernel B -------------------------------------------------------------

// B, main kernel: query block blockIdx.x, split blockIdx.y of gridDim.y;
// MAXT tiles at most.  `part` holds one float4 (pos, neg, sum, 0) per split
// and query.
template <bool NORMALIZED, int MAXT>
__device__ __forceinline__ void
segratio_body(const float4* __restrict__ cand, const float* __restrict__ boxes,
              const float* __restrict__ ctvec, const float* __restrict__ r2row,
              float4* __restrict__ part, int* __restrict__ counters,
              float* __restrict__ out, int q0, int q1, int ntiles, float r2) {
  __shared__ __align__(16) float4 sc[kStages][kTile];
  __shared__ uint16_t list[MAXT];
  __shared__ int wcount[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int qb = q0 / kTile + blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int i = qb * kTile + tid;  // the query row; ctvec and out hold rows [q0, q1)
  const int row = i - q0;

  float qbox[8];
  load_box(boxes, qb, qbox);
  if (!(qbox[0] <= qbox[3])) {  // no valid query in this block: zeros
    if (split == 0 && i < q1)
      out[3 * row] = out[3 * row + 1] = out[3 * row + 2] = 0.0f;
    return;
  }
  const int mine = list_kept_tiles(boxes, qbox, ntiles, r2, list, wcount);

  // A masked query is inert (q.w = +inf): it passes no radius test, so its
  // three sums stay 0 whatever its ctvec holds.
  const float4 q = cand[i];
  const float r2q = (r2row != nullptr && i < q1) ? r2row[i] : r2;
  const float vx = i < q1 ? ctvec[3 * row] : 0.0f;
  const float vy = i < q1 ? ctvec[3 * row + 1] : 0.0f;
  const float vz = i < q1 ? ctvec[3 * row + 2] : 0.0f;
  const float vq = dot3(vx, vy, vz, q.x, q.y, q.z);
  const float vnorm = NORMALIZED ? sqrtf(norm2(vx, vy, vz)) : 0.0f;
  float pos = 0.0f, neg = 0.0f, ssum = 0.0f;

  auto fetch = [&](int k) {  // start the copy of my k-th tile into its stage
    if (k < mine)
      cp_async16(&sc[k % kStages][tid], cand + (size_t)list[k] * kTile + tid);
    cp_async_commit();  // an empty group keeps the count of groups uniform
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<kStages - 2>();  // my copy of tile k has landed
    __syncthreads();  // everyone's has, and tile k - 1 is done with
    fetch(k + kStages - 1);
    const float4* c4 = sc[k % kStages];
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float4 p = c4[t];
      const float d2 = pair_d2(q.w, p.w, dot3(q.x, q.y, q.z, p.x, p.y, p.z));
      const bool in = d2 <= r2q;
      const float dots = __fsub_rn(dot3(vx, vy, vz, p.x, p.y, p.z), vq);
      pos += (in && dots > 0.0f) ? 1.0f : 0.0f;
      neg += (in && dots < 0.0f) ? 1.0f : 0.0f;
      if (!NORMALIZED) {
        ssum += (in && d2 > 0.0f) ? dots : 0.0f;
      } else if (__any_sync(0xffffffffu, in)) {  // the square root and the division
        const float denom = vnorm * sqrtf(d2);
        if (in && denom > 0.0f) ssum += dots / fmaxf(denom, 1e-12f);
      }
    }
  }

  // Partial sums to scratch; the last block of this query block adds them
  // in ascending split order.
  const size_t stride = (size_t)gridDim.x * kTile;  // float4 per split
  part[split * stride + row] = make_float4(pos, neg, ssum, 0.0f);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[qb], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  pos = neg = ssum = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float4 v = __ldcg(part + s * stride + row);
    pos += v.x;
    neg += v.y;
    ssum += v.z;
  }
  if (i < q1) {
    out[3 * row] = pos;
    out[3 * row + 1] = neg;
    out[3 * row + 2] = ssum;
  }
  if (tid == 0) counters[qb] = 0;  // ready for the next call on this stream
}

#define BSHOT_SEGRATIO_ARGS                                                    \
  const float4 *__restrict__ cand, const float *__restrict__ boxes,            \
      const float *__restrict__ ctvec, const float *__restrict__ r2row,        \
      float4 *__restrict__ part, int *__restrict__ counters,                   \
      float *__restrict__ out, int q0, int q1, int ntiles, float r2
#define BSHOT_SEGRATIO_PASS \
  cand, boxes, ctvec, r2row, part, counters, out, q0, q1, ntiles, r2

template <bool NORMALIZED>
__global__ void __launch_bounds__(kThreads) segratio_kernel(BSHOT_SEGRATIO_ARGS) {
  segratio_body<NORMALIZED, kMaxTiles>(BSHOT_SEGRATIO_PASS);
}

namespace wide {
template <bool NORMALIZED>
__global__ void __launch_bounds__(kThreads) segratio_kernel(BSHOT_SEGRATIO_ARGS) {
  segratio_body<NORMALIZED, kWideTiles>(BSHOT_SEGRATIO_PASS);
}
}  // namespace wide

// ---- Kernel H --------------------------------------------------------------

constexpr int kSelThreads = 256;  // H's block: one keypoint
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelBins = 4096;    // the histogram's bins (12-bit digits)
constexpr int kSelCap = 2048;     // keys a block collects and sorts
constexpr int kIdxBits = 17;      // a narrow row index: n <= 131072
constexpr int kWideIdxBits = 18;  // a wide row index: n <= 262144
constexpr int kSelUnroll = 4;     // candidate loads a thread keeps in flight

// pack_key with the row in IDX bits: the same order, 31 + IDX bits in all
// (d2 > 0 has a clear sign bit).
template <int IDX>
__device__ __forceinline__ unsigned long long select_key(float d2, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << IDX) |
         static_cast<unsigned int>(j);
}

// The shift above the refinement's top 12-bit digit: the 31 + IDX bits of
// a key rounded up to whole digits (48 narrow: 4 digits; 60 wide: 5).
template <int IDX>
__host__ __device__ constexpr int key_digits_shift() {
  return 12 * ((31 + IDX + 11) / 12);
}

// (exclusive prefix of v over the block's threads in thread order, total).
// Every thread must call it; `wsum` holds kSelWarps ints.
__device__ __forceinline__ int2 block_scan(int v, int* wsum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kSelWarps; ++w) {
    if (w < warp) before += wsum[w];
    total += wsum[w];
  }
  __syncthreads();  // wsum is free again
  return make_int2(before + incl - v, total);
}

// The bin b of `hist` that holds the need-th key (need >= 1, at most the
// histogram's total) and the keys in the bins below it: (b, below).
__device__ __forceinline__ int2 find_bin(const unsigned* hist, int need, int* wsum,
                                         int2* found) {
  constexpr int kPer = kSelBins / kSelThreads;
  const int b0 = threadIdx.x * kPer;
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) mine += hist[b0 + i];
  const int2 sc = block_scan(mine, wsum);
  if (sc.x < need && need <= sc.x + mine) {  // exactly one thread
    int below = sc.x, b = b0;
    while (below + (int)hist[b] < need) below += hist[b++];
    *found = make_int2(b, below);
  }
  __syncthreads();
  const int2 r = *found;
  __syncthreads();
  return r;
}

// H: keypoint blockIdx.x's neighbour rows, out[k][0..m) (m <= n).  First its
// in-radius rows ("ok": valid, 0 < d2 <= r2, the keypoint valid) by
// ascending (d2, row), at most m of them; then the rows that are not ok by
// ascending row until m are written.  What torch.sort(score, descending,
// stable)[:, :m] of the plain version gives (see the header note).  MAXT
// tiles at most, the row in IDX bits of a key.
template <int MAXT, int IDX>
__device__ __forceinline__ void
select_body(const float* __restrict__ kps, const uint8_t* __restrict__ kmask,
            const float4* __restrict__ cand, const float* __restrict__ boxes,
            long long* __restrict__ out, int n, int ntiles, int m, float r2,
            float scale) {
  __shared__ unsigned hist[kSelBins];
  __shared__ unsigned long long keys[kSelCap];
  __shared__ uint16_t list[MAXT];
  __shared__ int wsum[kSelWarps];
  __shared__ int nkeys;
  __shared__ int2 found;

  const int tid = threadIdx.x, lane = tid % 32;
  const int k = blockIdx.x;
  long long* row = out + (size_t)k * m;
  const bool live = kmask[k] != 0;
  const float qx = kps[3 * k], qy = kps[3 * k + 1], qz = kps[3 * k + 2];
  const float qq = norm2(qx, qy, qz);
  // d2 of candidate row j, as the plain version rounds it; +inf for a
  // masked (inert) row, so the test below fails for it.
  auto d2_of = [&](const float4 p) {
    return pair_d2(qq, p.w, dot3(qx, qy, qz, p.x, p.y, p.z));
  };
  auto is_ok = [&](float d2) { return d2 > 0.0f && d2 <= r2; };
  // The histogram's bin of an ok d2: monotone in d2 (a product rounded to
  // nearest by a positive scale, truncated, clamped), so the bins order the
  // keys as the keys order themselves.
  auto lin_bin = [&](float d2) {
    const float f = __fmul_rn(d2, scale);
    return f >= (float)(kSelBins - 1) ? kSelBins - 1 : __float2int_rz(f);
  };

  int c = 0, nsel = 0;  // block-uniform: ok rows, rows written in sorted order
  if (live) {
    const float qbox[8] = {qx, qy, qz, qx, qy, qz, qq, 0.0f};
    const int mine = list_kept_tiles<kSelThreads>(boxes, qbox, ntiles, r2, list, wsum);
    // Every ok row of the kept tiles passes `visit` (row, d2, key) once, in
    // no set order: a thread takes row tid % 128 of every second tile and
    // keeps kSelUnroll loads in flight.
    auto scan = [&](auto visit) {
      const int half = tid / kTile, r = tid % kTile;
      for (int t0 = half; t0 < mine; t0 += 2 * kSelUnroll) {
        float4 p[kSelUnroll];
        int j[kSelUnroll];
#pragma unroll
        for (int u = 0; u < kSelUnroll; ++u) {
          const int t = t0 + 2 * u;
          j[u] = t < mine ? (int)list[t] * kTile + r : -1;
          p[u] = j[u] >= 0 ? __ldg(cand + j[u]) : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
        }
#pragma unroll
        for (int u = 0; u < kSelUnroll; ++u) {
          const float d2 = d2_of(p[u]);
          visit(is_ok(d2), j[u], d2);
        }
      }
    };
    // Append `key` where `take`: one shared atomic a warp.  The slots past
    // kSelCap are counted and not stored.
    auto append = [&](bool take, unsigned long long key) {
      const unsigned b = __ballot_sync(0xffffffffu, take);
      int base = 0;
      if (lane == 0 && b) base = atomicAdd(&nkeys, __popc(b));
      base = __shfl_sync(0xffffffffu, base, 0);
      const int slot = base + __popc(b & ((1u << lane) - 1u));
      if (take && slot < kSelCap) keys[slot] = key;
    };

    // Pass 1: collect the ok keys while they fit, count them all, and
    // histogram their d2.
    for (int i = tid; i < kSelBins; i += kSelThreads) hist[i] = 0;
    if (tid == 0) nkeys = 0;
    __syncthreads();
    scan([&](bool ok, int j, float d2) {
      if (ok) atomicAdd(&hist[lin_bin(d2)], 1u);
      append(ok, ok ? select_key<IDX>(d2, j) : 0ull);
    });
    __syncthreads();
    c = nkeys;
    int nkept = c;  // keys to sort
    if (c > kSelCap) {
      // Select: the bin b of the m-th key; while the keys up to it overflow
      // the buffer, refine within b by 12-bit digits of the key (d2 bits,
      // then the row) from the top: the keys below the cut are `less`, the
      // cut's digit prefix is `prefix` above bit `shift`.
      const int2 bb = find_bin(hist, m, wsum, &found);
      const int b = bb.x;
      int less = bb.y, cnt = hist[b], shift = key_digits_shift<IDX>();
      unsigned long long prefix = 0;
      while (less + cnt > kSelCap && shift > 0) {
        __syncthreads();  // everyone has read hist
        for (int i = tid; i < kSelBins; i += kSelThreads) hist[i] = 0;
        __syncthreads();
        shift -= 12;
        scan([&](bool ok, int j, float d2) {
          if (!ok || lin_bin(d2) != b) return;
          const unsigned long long key = select_key<IDX>(d2, j);
          if ((key >> (shift + 12)) == prefix)
            atomicAdd(&hist[(unsigned)(key >> shift) & (kSelBins - 1)], 1u);
        });
        __syncthreads();
        const int2 vv = find_bin(hist, m - less, wsum, &found);
        less += vv.y;
        cnt = hist[vv.x];
        prefix = (prefix << 12) | (unsigned long long)vv.x;
      }
      // Collect every key up to the cut: less + cnt <= kSelCap of them.
      if (tid == 0) nkeys = 0;
      __syncthreads();
      scan([&](bool ok, int j, float d2) {
        const unsigned long long key = select_key<IDX>(d2, j);
        int lb = ok ? lin_bin(d2) : kSelBins;
        append(ok && (lb < b || (lb == b && (key >> shift) <= prefix)), key);
      });
      __syncthreads();
      nkept = nkeys;
    }
    // Bitonic sort of the nkept keys, padded to a power of two.
    int np = 1;
    while (np < nkept) np <<= 1;
    for (int i = nkept + tid; i < np; i += kSelThreads) keys[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= np; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < np; i += kSelThreads) {
          const int o = i ^ stride;
          if (o > i) {
            const unsigned long long a = keys[i], e = keys[o];
            if ((a > e) == ((i & size) == 0)) {
              keys[i] = e;
              keys[o] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    nsel = min(c, m);
    for (int i = tid; i < nsel; i += kSelThreads)
      row[i] = (long long)(keys[i] & ((1ull << IDX) - 1ull));
  }

  // The rest: rows that are not ok, by ascending row, from row 0 until m
  // rows are written (an ordered count over chunks of kSelThreads rows).
  const int need = m - nsel;
  for (int j0 = 0, got = 0; got < need && j0 < n; j0 += kSelThreads) {
    const int j = j0 + tid;
    bool take = false;
    if (j < n) take = !live || !is_ok(d2_of(__ldg(cand + j)));
    const int2 sc = block_scan(take ? 1 : 0, wsum);
    if (take && got + sc.x < need) row[nsel + got + sc.x] = j;
    got += sc.y;
  }
}

#define BSHOT_SELECT_ARGS                                                      \
  const float *__restrict__ kps, const uint8_t *__restrict__ kmask,            \
      const float4 *__restrict__ cand, const float *__restrict__ boxes,        \
      long long *__restrict__ out, int n, int ntiles, int m, float r2,         \
      float scale
#define BSHOT_SELECT_PASS kps, kmask, cand, boxes, out, n, ntiles, m, r2, scale

__global__ void __launch_bounds__(kSelThreads) shot_select_kernel(BSHOT_SELECT_ARGS) {
  select_body<kMaxTiles, kIdxBits>(BSHOT_SELECT_PASS);
}

namespace wide {
__global__ void __launch_bounds__(kSelThreads) shot_select_kernel(BSHOT_SELECT_ARGS) {
  select_body<kWideTiles, kWideIdxBits>(BSHOT_SELECT_PASS);
}
}  // namespace wide

// The query rows [q0, q1) of A and B: q0 a multiple of 128, q1 one or n, so
// each query block is the block of the launch over every row and its sums
// come out bit for bit the same; every row stays a candidate.  out holds
// (q1 - q0) rows, and so does B's ctvec.
bool bad_rows(int n, int q0, int q1) {
  return q0 < 0 || q0 > q1 || q1 > n || q0 % kTile != 0 ||
         (q1 % kTile != 0 && q1 != n);
}

}  // namespace

extern "C" {

// A's scratch, allocated by the caller for ntiles = ceil(n / 128) tiles and
// nfp = nf rounded up to a multiple of 4: cand ntiles * 128 float4, featp
// ntiles * 128 * nfp floats, boxes ntiles * 8 floats, part nsplit * ntiles *
// 128 * nfp floats, counters ntiles ints, zero before the first call.  Up to
// kMaxTiles tiles the narrow form runs, past them the wide one.
int bshot_neighborhood_accumulate(const float* pts, const uint8_t* mask,
                                  const float* feat, const float* r2row,
                                  float* out, float* cand, float* featp,
                                  float* boxes, float* part, int* counters,
                                  int n, int nf, int nsplit, float r2, int q0,
                                  int q1, void* stream) {
  if (n <= 0 || q0 == q1) return 0;
  const int ntiles = (n + kTile - 1) / kTile;
  const int nfp = (nf + 3) / 4 * 4;
  if (nf < 1 || nfp > kMaxFeat || ntiles > kWideTiles || nsplit < 1 ||
      nsplit > 65535 || bad_rows(n, q0, q1))
    return (int)cudaErrorInvalidValue;
  const bool wide = ntiles > kMaxTiles;
  cudaStream_t st = (cudaStream_t)stream;
  float4* cand4 = reinterpret_cast<float4*>(cand);
  float4* part4 = reinterpret_cast<float4*>(part);
  if (wide)
    wide::pack_cloud_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, feat, cand4,
                                                         featp, boxes, n, nf, nfp);
  else
    pack_cloud_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, feat, cand4, featp,
                                                   boxes, n, nf, nfp);
  const dim3 grid((q1 - q0 + kTile - 1) / kTile, nsplit);
#define BSHOT_ACCUMULATE(NFP)                                                  \
  if (wide)                                                                    \
    wide::accumulate_kernel<NFP><<<grid, kThreads, 0, st>>>(                  \
        cand4, featp, boxes, r2row, part4, counters, out, q0, q1, nf, ntiles, r2); \
  else                                                                         \
    accumulate_kernel<NFP><<<grid, kThreads, 0, st>>>(                        \
        cand4, featp, boxes, r2row, part4, counters, out, q0, q1, nf, ntiles, r2)
  switch (nfp) {
    case 4: BSHOT_ACCUMULATE(4); break;
    case 8: BSHOT_ACCUMULATE(8); break;
    case 12: BSHOT_ACCUMULATE(12); break;
    default: BSHOT_ACCUMULATE(16); break;
  }
#undef BSHOT_ACCUMULATE
  return (int)cudaGetLastError();
}

// Scratch from the caller, for ntiles = ceil(n / 128) tiles: cand ntiles *
// 128 float4, boxes ntiles * 8 floats, part nsplit * ntiles * 128 float4,
// counters ntiles ints, zero before the first call.  Up to kMaxTiles tiles
// the narrow form runs, past them the wide one.
int bshot_segratio_accumulate(const float* pts, const uint8_t* mask,
                              const float* ctvec, const float* r2row, float* out,
                              float* cand, float* boxes, float* part,
                              int* counters, int n, int normalized, int nsplit,
                              float r2, int q0, int q1, void* stream) {
  if (n <= 0 || q0 == q1) return 0;
  const int ntiles = (n + kTile - 1) / kTile;
  if (ntiles > kWideTiles || nsplit < 1 || nsplit > 65535 || bad_rows(n, q0, q1))
    return (int)cudaErrorInvalidValue;
  const bool wide = ntiles > kMaxTiles;
  cudaStream_t st = (cudaStream_t)stream;
  float4* cand4 = reinterpret_cast<float4*>(cand);
  float4* part4 = reinterpret_cast<float4*>(part);
  if (wide)
    wide::pack_cloud_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, nullptr, cand4,
                                                         nullptr, boxes, n, 0, 0);
  else
    pack_cloud_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, nullptr, cand4,
                                                   nullptr, boxes, n, 0, 0);
  const dim3 grid((q1 - q0 + kTile - 1) / kTile, nsplit);
#define BSHOT_SEGRATIO(NS, NORM)                                               \
  NS segratio_kernel<NORM><<<grid, kThreads, 0, st>>>(                        \
      cand4, boxes, ctvec, r2row, part4, counters, out, q0, q1, ntiles, r2)
  if (wide && normalized)
    BSHOT_SEGRATIO(wide::, true);
  else if (wide)
    BSHOT_SEGRATIO(wide::, false);
  else if (normalized)
    BSHOT_SEGRATIO(, true);
  else
    BSHOT_SEGRATIO(, false);
#undef BSHOT_SEGRATIO
  return (int)cudaGetLastError();
}

// H: the wrapper allocates out (k rows of m int64, m <= n) and the scratch
// for ntiles = ceil(n / 128) tiles: cand ntiles * 128 float4, boxes ntiles *
// 8 floats.  Two launches: the pre-pass packs the cloud, then one block a
// keypoint.  Up to kMaxTiles tiles the narrow form runs, past them the wide
// one.
int bshot_shot_neighbors(const float* kps, const uint8_t* kmask, const float* pts,
                         const uint8_t* mask, long long* out, float* cand,
                         float* boxes, int k, int n, int m, float r2, void* stream) {
  if (k <= 0 || m <= 0) return 0;
  const int ntiles = (n + kTile - 1) / kTile;
  if (n <= 0 || m > n || m > kSelCap / 2 || ntiles > kWideTiles || !(r2 >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const bool wide = ntiles > kMaxTiles;
  cudaStream_t st = (cudaStream_t)stream;
  float4* cand4 = reinterpret_cast<float4*>(cand);
  // r2 > 0: the bins span (0, r2]; r2 = 0: no row is ok and no bin is used.
  const float scale = r2 > 0.0f ? (float)kSelBins / r2 : 0.0f;
  if (wide) {
    wide::shot_pack_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, cand4, boxes, n);
    wide::shot_select_kernel<<<k, kSelThreads, 0, st>>>(kps, kmask, cand4, boxes, out,
                                                         n, ntiles, m, r2, scale);
  } else {
    shot_pack_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, cand4, boxes, n);
    shot_select_kernel<<<k, kSelThreads, 0, st>>>(kps, kmask, cand4, boxes, out, n,
                                                   ntiles, m, r2, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
