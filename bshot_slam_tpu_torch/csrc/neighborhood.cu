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
//      of the 132 SMs.  Each block writes its partial sums to scratch; the
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
constexpr int kMaxTiles = 1024;  // tiles a block can list: n <= 131072 rows

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
// is returned.  Every thread of the block must call it.
__device__ __forceinline__ int list_kept_tiles(const float* boxes, const float* qbox,
                                               int ntiles, float r2, uint16_t* list,
                                               int* wcount) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.y, nsplit = gridDim.y;
  int total = 0;
  for (int g0 = 0; g0 < ntiles; g0 += kThreads) {
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
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += wcount[w];
      total += wcount[w];
    }
    if (keep && pos % nsplit == split) list[pos / nsplit] = (uint16_t)tile;
    __syncthreads();
  }
  return total > split ? (total - split + nsplit - 1) / nsplit : 0;
}

// Pre-pass of A and B: pack tile blockIdx.x (see the header note).  `cand`
// holds gridDim.x * kTile rows, `featp` as many rows of nfp floats (B has no
// features: nfp = 0 and the pointers are null), `boxes` 8 floats per tile:
// lo[3], hi[3], max |p|^2, 0.
__global__ void __launch_bounds__(kThreads)
pack_cloud_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                  const float* __restrict__ feat, float4* __restrict__ cand,
                  float* __restrict__ featp, float* __restrict__ boxes, int n,
                  int nf, int nfp) {
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

// ---- Kernel A -------------------------------------------------------------

// A, main kernel: query block blockIdx.x, split blockIdx.y of gridDim.y.
template <int NFP>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const float4* __restrict__ cand, const float* __restrict__ featp,
                  const float* __restrict__ boxes, const float* __restrict__ r2row,
                  float4* __restrict__ part, int* __restrict__ counters,
                  float* __restrict__ out, int n, int nf, int ntiles, float r2) {
  constexpr int kF4 = NFP / 4;  // float4 chunks of a feature row
  __shared__ __align__(16) float4 sc[kStages][kTile];
  __shared__ __align__(16) float4 sf[kStages][kTile * kF4];
  __shared__ uint16_t list[kMaxTiles];
  __shared__ int wcount[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int qb = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int i = qb * kTile + tid;

  float qbox[8];
  load_box(boxes, qb, qbox);
  if (!(qbox[0] <= qbox[3])) {  // no valid query in this block: zeros
    if (split == 0 && i < n)
      for (int f = 0; f < nf; ++f) out[(size_t)i * nf + f] = 0.0f;
    return;
  }
  const int mine = list_kept_tiles(boxes, qbox, ntiles, r2, list, wcount);

  const float4 q = cand[i];  // a masked query is inert too
  const float r2q = (r2row != nullptr && i < n) ? r2row[i] : r2;
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
  float4* mypart = part + split * stride + (size_t)i * kF4;
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
      const float4 v = __ldcg(part + s * stride + (size_t)i * kF4 + c);
      acc[4 * c] += v.x;
      acc[4 * c + 1] += v.y;
      acc[4 * c + 2] += v.z;
      acc[4 * c + 3] += v.w;
    }
  }
  if (i < n) {
#pragma unroll
    for (int f = 0; f < NFP; ++f)
      if (f < nf) out[(size_t)i * nf + f] = acc[f];
  }
  if (tid == 0) counters[qb] = 0;  // ready for the next call on this stream
}

// ---- Kernel B -------------------------------------------------------------

// B, main kernel: query block blockIdx.x, split blockIdx.y of gridDim.y.
// `part` holds one float4 (pos, neg, sum, 0) per split and query.
template <bool NORMALIZED>
__global__ void __launch_bounds__(kThreads)
segratio_kernel(const float4* __restrict__ cand, const float* __restrict__ boxes,
                const float* __restrict__ ctvec, const float* __restrict__ r2row,
                float4* __restrict__ part, int* __restrict__ counters,
                float* __restrict__ out, int n, int ntiles, float r2) {
  __shared__ __align__(16) float4 sc[kStages][kTile];
  __shared__ uint16_t list[kMaxTiles];
  __shared__ int wcount[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int qb = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int i = qb * kTile + tid;

  float qbox[8];
  load_box(boxes, qb, qbox);
  if (!(qbox[0] <= qbox[3])) {  // no valid query in this block: zeros
    if (split == 0 && i < n) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = 0.0f;
    return;
  }
  const int mine = list_kept_tiles(boxes, qbox, ntiles, r2, list, wcount);

  // A masked query is inert (q.w = +inf): it passes no radius test, so its
  // three sums stay 0 whatever its ctvec holds.
  const float4 q = cand[i];
  const float r2q = (r2row != nullptr && i < n) ? r2row[i] : r2;
  const float vx = i < n ? ctvec[3 * i] : 0.0f;
  const float vy = i < n ? ctvec[3 * i + 1] : 0.0f;
  const float vz = i < n ? ctvec[3 * i + 2] : 0.0f;
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
  part[split * stride + i] = make_float4(pos, neg, ssum, 0.0f);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[qb], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  pos = neg = ssum = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float4 v = __ldcg(part + s * stride + i);
    pos += v.x;
    neg += v.y;
    ssum += v.z;
  }
  if (i < n) {
    out[3 * i] = pos;
    out[3 * i + 1] = neg;
    out[3 * i + 2] = ssum;
  }
  if (tid == 0) counters[qb] = 0;  // ready for the next call on this stream
}

}  // namespace

extern "C" {

// A's scratch, allocated by the caller for ntiles = ceil(n / 128) tiles and
// nfp = nf rounded up to a multiple of 4: cand ntiles * 128 float4, featp
// ntiles * 128 * nfp floats, boxes ntiles * 8 floats, part nsplit * ntiles *
// 128 * nfp floats, counters ntiles ints, zero before the first call.
int bshot_neighborhood_accumulate(const float* pts, const uint8_t* mask,
                                  const float* feat, const float* r2row,
                                  float* out, float* cand, float* featp,
                                  float* boxes, float* part, int* counters,
                                  int n, int nf, int nsplit, float r2,
                                  void* stream) {
  if (n <= 0) return 0;
  const int ntiles = (n + kTile - 1) / kTile;
  const int nfp = (nf + 3) / 4 * 4;
  if (nf < 1 || nfp > kMaxFeat || ntiles > kMaxTiles || nsplit < 1 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float4* cand4 = reinterpret_cast<float4*>(cand);
  float4* part4 = reinterpret_cast<float4*>(part);
  pack_cloud_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, feat, cand4, featp,
                                                 boxes, n, nf, nfp);
  const dim3 grid(ntiles, nsplit);
#define BSHOT_ACCUMULATE(NFP)                                                  \
  accumulate_kernel<NFP><<<grid, kThreads, 0, st>>>(                          \
      cand4, featp, boxes, r2row, part4, counters, out, n, nf, ntiles, r2)
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
// counters ntiles ints, zero before the first call.
int bshot_segratio_accumulate(const float* pts, const uint8_t* mask,
                              const float* ctvec, const float* r2row, float* out,
                              float* cand, float* boxes, float* part,
                              int* counters, int n, int normalized, int nsplit,
                              float r2, void* stream) {
  if (n <= 0) return 0;
  const int ntiles = (n + kTile - 1) / kTile;
  if (ntiles > kMaxTiles || nsplit < 1 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float4* cand4 = reinterpret_cast<float4*>(cand);
  float4* part4 = reinterpret_cast<float4*>(part);
  pack_cloud_kernel<<<ntiles, kThreads, 0, st>>>(pts, mask, nullptr, cand4, nullptr,
                                                 boxes, n, 0, 0);
  const dim3 grid(ntiles, nsplit);
  if (normalized)
    segratio_kernel<true><<<grid, kThreads, 0, st>>>(
        cand4, boxes, ctvec, r2row, part4, counters, out, n, ntiles, r2);
  else
    segratio_kernel<false><<<grid, kThreads, 0, st>>>(
        cand4, boxes, ctvec, r2row, part4, counters, out, n, ntiles, r2);
  return (int)cudaGetLastError();
}

}  // extern "C"
