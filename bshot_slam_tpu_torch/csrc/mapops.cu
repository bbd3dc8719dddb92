// Bounded nearest-neighbour kernels against the map on Hopper (C, D, E),
// and the ICP update that consumes D (G).
//
// C replaces bshot_slam_tpu/kernels/mapops.py:hamming_nn_bounded: two-sided
//   Hamming nearest neighbours between ~600 source B-SHOTs and the candidates.
// D replaces euclid_nn_bounded: per query the nearest candidate's clamped d2
//   and its index (the ICP correspondence search, 10 calls per frame).
// E replaces dedup_blocked_bounded: per newcomer, whether a map row in
//   [0, n_valid) blocks it (same voxel block, d2 < r^2, seg_ratio >= its own).
// G replaces no Pallas kernel: it is an ICP iteration past D's search (the
//   body of bshot_slam_tpu/ops/icp.py's lax.scan), which the plain path runs
//   as ~235 PyTorch operations of 1.5-2 us each.
//
// Candidate rows are live when j < n_valid, or j >= tail_start when
// tail_start >= 0 (the previous frame's keypoints ride after the map
// region; E has no tail); other rows are dead.  A row with no live valid
// candidate reports (3e38, index 0), ties go to the lowest index: the
// reference's semantics.
//
// C is one launch per call and is bound by integer instructions, not bytes
// (~2e7 pairs of 11 words against under 2 MB of input); descriptors stay
// packed.  Done plainly a pair is 11 XOR and 11 __popc, and popc, at 16
// lanes per SM per clock against 64 for logic, would set the pace: the
// kernel trades 7 of the 11 for logic (see `hamming`).  The design computes
// every distance once and feeds both sides from it.
//   * The grid is (splits of the live rows) x (blocks of 64 sources).  The
//     live rows are numbered as one run and shared evenly, as in D, so the
//     work follows n_valid (read on the device) and no block is dead.
//   * A lane keeps two sources (22 words) in registers; a block stages its
//     rows once in shared memory as 12 words, the twelfth a bias of 1024 for
//     a masked row, and its 8 warps take the rows in turn, one broadcast row
//     feeding 64 pairs per warp.  A masked or absent source carries the same
//     bias, so a distance of 1024 or more means "not a pair" and the inner
//     loop reads no mask: d = bias + bias + the differing bits <= 2400.
//   * Both minima are 32-bit keys (d << 20 | index), so an unsigned min
//     picks the smallest distance and the lowest index among equals.  Per
//     source the key stays in a register over the warp's rows; per row the
//     lane's two keys meet the other lanes' in one __reduce_min_sync.
//   * Across blocks: per source, the splits' keys go to scratch and the last
//     block of a source block to finish takes their minimum; per row, the
//     source blocks' keys go to scratch and the last block of a split does
//     the same.  Both write minimum and index directly, (3e38, 0) for a key
//     of 2^30 or more; every block also writes (3e38, 0) to its share of the
//     dead rows, which no block visits.  Integer minima: no order matters.
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
// E is one launch per call that writes the (k,) bools itself (~1.8e7 pairs
// against 0.9 MB of input).  More than 99.9% of pairs at the check's shape
// are in different voxel blocks, so that test is the kernel's work.  It has
// D's shape:
//   * The grid is (splits of the live rows) x (blocks of 64 newcomers); the
//     rows [0, n_valid) (n_valid read on the device) are shared evenly by
//     splits of at most 640 rows, so no block exists only to find its rows
//     dead.  A lane keeps two newcomers in registers.
//   * A block stages its rows once, each as an int4 (block key, seg ratio
//     bits, b0, b1) and a float4 (x, y, z, b2 bits).  The key is a 32-bit
//     hash of the block coordinates: equal blocks have equal keys.  A masked
//     row's seg ratio is NaN, and NaN >= s is false for every s, as the plain
//     rule rejects it, so the loop reads no mask.
//   * Per pair, the fast test is one integer compare of the keys and one
//     f32 compare of the seg ratios.  A warp takes 4 rows at a time and
//     branches once, only when a pair of them passes; there the block
//     coordinates are compared exactly and the distance computed with
//     common.cuh's rounding.  A flag is a bit in a register.
//   * Per block, one ballot per warp and an OR over the warps give two flag
//     words, written to scratch; the last block of a newcomer block to
//     finish (a counter behind __threadfence) ORs them over the splits and
//     writes every bool once.  An OR does not depend on order.
//   Measured (PERF.md): comparing the three coordinates per pair reads
//   32 bytes of shared memory per row and warp and took 1.3x as long; a
//   hash join of the rows against the newcomers' blocks was faster at the
//   check's shape and 4-5x slower in the engine, where the newcomers crowd
//   into a few blocks.
//
// G is one launch of one block of 1024 threads per call.  Its work, ~600
// rows of 57 bytes, is nothing to the card: the latency of its dependent
// steps bounds it, so the design keeps them few and in one block.
//   * Rows are strided over the threads (a loop past 1024 rows).  Pass 1
//     sums the pair count (0/1 weights: exact) and the pairs' d2; pass 2
//     the two weighted means, weights w / (n + eps) as se3.kabsch forms
//     them; pass 3 the nine entries of the centred cross-covariance H.  Each
//     sum is a thread's rows in order, then a fixed tree (__shfl_down_sync in
//     each warp, then warp 0 over the 32 warps): no atomics, so G is
//     bit-identical run to run.
//   * Thread 0 then does what the plain path does to the 4x4 problem: Horn's
//     matrix of H / (|H| + eps), the shift by 2 I, 30 power iterations, the
//     quaternion's rotation, t, the identity below 3 pairs, the composition
//     with the running pose, the rmse.  Element-wise steps use the _rn
//     intrinsics in the plain version's order, as F does, so nvcc contracts
//     nothing; the K=3 and K=4 products are FMA chains in index order.
//   * After a barrier every thread moves its rows of the source under the
//     new pose (R p as the FMA chain, then + t), which D reads next; on the
//     card this equals the plain se3.apply of the same pose bit for bit.
//   The wrapper allocates the pose, the moved source, the rmse and the count
//   at the ICP's start (G's init mode writes the identity and the source);
//   each update writes them in place.  Only the sums' order differs from the
//   plain path's (torch's reductions, cuBLAS's products): a step's rotation
//   agrees to ~1e-8 and its translation to ~1e-3 mm (PERF.md section 6).
//
// Work per pair of valid live rows (kernels/mapops.py holds the same counts
// for the bound): C, in the cheapest form known (`hamming` below), 11 XOR, 14
// logic instructions of 7 carry-save adders, 3 weighted adds and a minimum
// for each side (30 of 32-bit integer, 64 lanes per SM per clock) and 4
// __popc (16 lanes per SM per clock), so the integer pipe sets C's bound; 11
// XOR and 11 __popc would take longer.  D, 8 f32 instructions (dot3: a multiply and 2
// FMAs; d2: add, multiply, subtract; the clamp; the compare).  E, per pair
// of a newcomer and a live row, one integer compare of the block keys and
// one f32 compare of the seg ratios, and for the pairs that pass both, 3
// integer compares of the block coordinates and the 8 of a distance test.
// At a small live map a launch costs about its launch overhead.  G, per
// source row 52 f32 instructions, per call 17 sums through the tree and
// ~934 in the serial part (ICP_ROW_OPS, ICP_CALL_OPS).
#include "common.cuh"

namespace {

using namespace bshot;

constexpr int kWords = 11;

// ---- Kernel C -------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCPerLane = 2;                // sources a lane keeps in registers
constexpr int kCSources = 32 * kCPerLane;   // sources per block
constexpr int kCRows = 512;                 // most rows a block stages
constexpr int kCStride = kWords + 1;        // staged row: 11 words and its bias
constexpr unsigned kCBias = 1024;           // added to d by a masked row or source
constexpr int kCShift = 20;                 // key = d << 20 | index
constexpr unsigned kCNone = kCBias << kCShift;  // keys from here on: no pair
constexpr unsigned kCIndex = (1u << kCShift) - 1u;  // the key's index bits
constexpr int kCParts = kCThreads / kCSources;  // threads per source in the merge

// Carry-save adder: a + b + c = sum + 2 carry, bit by bit.
__device__ __forceinline__ void csa(unsigned a, unsigned b, unsigned c, unsigned& sum,
                                    unsigned& carry) {
  sum = a ^ b ^ c;
  carry = (a & b) | (c & (a ^ b));
}

// Bits in which two descriptors differ.  popc is the slow instruction (16
// lanes per SM per clock against 64 for logic), so seven carry-save adders
// first fold the 11 words into one word of weight 1, one of weight 2 and two
// of weight 4: 4 popc instead of 11.
__device__ __forceinline__ unsigned hamming(const unsigned* a, const unsigned* b) {
  unsigned x[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) x[w] = a[w] ^ b[w];
  unsigned s1, c1, s2, c2, s3, c3, s4, c4, s5, c5, s6, c6, s7, c7;
  csa(x[0], x[1], x[2], s1, c1);
  csa(x[3], x[4], x[5], s2, c2);
  csa(x[6], x[7], x[8], s3, c3);
  csa(s1, s2, s3, s4, c4);
  csa(c1, c2, c3, s5, c5);  // of weight 2 and 4
  csa(x[9], x[10], s4, s6, c6);
  csa(c4, s5, c6, s7, c7);  // all three of weight 2
  return __popc(s6) + 2 * __popc(s7) + 4 * (__popc(c5) + __popc(c7));
}

__device__ __forceinline__ void write_hamming(unsigned key, float* dmin,
                                              int32_t* darg, int at) {
  const bool some = key < kCNone;
  dmin[at] = some ? (float)(key >> kCShift) : kBig;
  darg[at] = some ? (int32_t)(key & kCIndex) : 0;
}

// C: split blockIdx.x of gridDim.x, source block blockIdx.y (see the header).
// apart holds gridDim.x rows of gridDim.y * 64 keys, bpart gridDim.y rows of
// cb keys; acount one counter per source block, bcount one per split.
__global__ void __launch_bounds__(kCThreads)
hamming_kernel(const int32_t* __restrict__ a, const uint8_t* __restrict__ am,
               const int32_t* __restrict__ b, const uint8_t* __restrict__ bm,
               const int32_t* __restrict__ nv_ptr, int ka, int cb, int tail_start,
               unsigned* __restrict__ apart, unsigned* __restrict__ bpart,
               int* __restrict__ acount, int* __restrict__ bcount,
               float* __restrict__ amin, int32_t* __restrict__ aarg,
               float* __restrict__ bmin, int32_t* __restrict__ barg) {
  __shared__ __align__(16) unsigned sb[kCRows * kCStride];
  __shared__ unsigned sbkey[kCRows];
  __shared__ unsigned sakey[kCWarps][kCSources];
  __shared__ int last_a, last_b;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nsplit = gridDim.x, ngroup = gridDim.y;

  // Live rows as one run: v in [0, lo) is row v, v >= lo is row v - lo + t0.
  const int lo = min(max(*nv_ptr, 0), cb);
  const int t0 = tail_start < 0 ? cb : min(max(tail_start, lo), cb);
  const int live = lo + (cb - t0);
  const int per = (live + nsplit - 1) / nsplit;  // <= kCRows: the wrapper picks nsplit so
  const int v0 = min((int)blockIdx.x * per, live);
  const int cnt = min(v0 + per, live) - v0;

  // My share of the dead rows [lo, t0): no candidate.
  const int nblocks = nsplit * ngroup;
  for (long long j = lo + ((long long)blockIdx.y * nsplit + blockIdx.x) * kCThreads + tid;
       j < t0; j += (long long)nblocks * kCThreads) {
    bmin[j] = kBig;
    barg[j] = 0;
  }

  for (int k = tid; k < cnt * kCStride; k += kCThreads) {
    const int s = k / kCStride, w = k - s * kCStride;
    const int v = v0 + s;
    const size_t j = v < lo ? v : v - lo + t0;
    sb[k] = w < kWords ? (unsigned)b[j * kWords + w] : (bm[j] ? 0u : kCBias);
  }

  const int i0 = blockIdx.y * kCSources;
  unsigned aw[kCPerLane][kWords], abias[kCPerLane], bkey[kCPerLane], best[kCPerLane];
#pragma unroll
  for (int u = 0; u < kCPerLane; ++u) {
    const int i = i0 + lane + 32 * u;
    const bool ok = i < ka && am[i];
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      aw[u][w] = ok ? (unsigned)a[(size_t)i * kWords + w] : 0u;
    abias[u] = (ok ? 0u : kCBias) << kCShift;  // added to d << kCShift
    bkey[u] = abias[u] | (unsigned)i;          // ... with the source's index
    best[u] = 0xffffffffu;
  }
  __syncthreads();

  const uint4* sb4 = reinterpret_cast<const uint4*>(sb);
  for (int t = warp; t < cnt; t += kCWarps) {
    const uint4 r0 = sb4[3 * t], r1 = sb4[3 * t + 1], r2 = sb4[3 * t + 2];
    const unsigned row[kWords] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                                  r1.z, r1.w, r2.x, r2.y, r2.z};
    unsigned kb = 0xffffffffu;
#pragma unroll
    for (int u = 0; u < kCPerLane; ++u) {
      const unsigned d = r2.w + hamming(aw[u], row);
      const unsigned dk = d << kCShift;
      kb = min(kb, dk + bkey[u]);
      // The row's number in the run stands for its index until the loop is
      // over: the two ascend together.
      best[u] = min(best[u], dk + abias[u] + (unsigned)(v0 + t));
    }
    kb = __reduce_min_sync(0xffffffffu, kb);
    if (lane == 0) sbkey[t] = kb;
  }
#pragma unroll
  for (int u = 0; u < kCPerLane; ++u) {
    const int v = (int)(best[u] & kCIndex);
    const unsigned j = (unsigned)(v < lo ? v : v - lo + t0);
    sakey[warp][lane + 32 * u] = best[u] < kCNone ? (best[u] & ~kCIndex) | j : 0xffffffffu;
  }
  __syncthreads();

  if (tid < kCSources) {
    unsigned k = sakey[0][tid];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w) k = min(k, sakey[w][tid]);
    apart[(size_t)blockIdx.x * ngroup * kCSources + i0 + tid] = k;
  }
  for (int s = tid; s < cnt; s += kCThreads) {
    const int v = v0 + s;
    const size_t j = v < lo ? v : v - lo + t0;
    bpart[(size_t)blockIdx.y * cb + j] = sbkey[s];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_a = atomicAdd(&acount[blockIdx.y], 1) == nsplit - 1;
    last_b = atomicAdd(&bcount[blockIdx.x], 1) == ngroup - 1;
  }
  __syncthreads();
  if (!last_a && !last_b) return;
  __threadfence();
  if (last_b) {  // per row of this split, the minimum over the source blocks
    for (int s = tid; s < cnt; s += kCThreads) {
      const int v = v0 + s;
      const size_t j = v < lo ? v : v - lo + t0;
      unsigned k = __ldcg(bpart + j);
      for (int g = 1; g < ngroup; ++g) k = min(k, __ldcg(bpart + (size_t)g * cb + j));
      write_hamming(k, bmin, barg, (int)j);
    }
    if (tid == 0) bcount[blockIdx.x] = 0;  // ready for the next call on this stream
  }
  if (last_a) {  // per source of this block, the minimum over the splits
    const int s = tid % kCSources, mypart = tid / kCSources;
    const unsigned* col = apart + i0 + s;
    unsigned k = 0xffffffffu;
#pragma unroll 8
    for (int x = mypart; x < nsplit; x += kCParts)
      k = min(k, __ldcg(col + (size_t)x * ngroup * kCSources));
    sakey[mypart][s] = k;  // free since the barriers above
    __syncthreads();
    if (tid < kCSources && i0 + tid < ka) {
#pragma unroll
      for (int p = 1; p < kCParts; ++p) k = min(k, sakey[p][tid]);
      write_hamming(k, amin, aarg, i0 + tid);
    }
    if (tid == 0) acount[blockIdx.y] = 0;
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

// ---- Kernel E -------------------------------------------------------------

constexpr int kEThreads = 256;
constexpr int kEWarps = kEThreads / 32;
constexpr int kEPerLane = 2;               // newcomers a lane keeps in registers
constexpr int kENew = 32 * kEPerLane;      // newcomers per block
constexpr int kERows = 640;                // most rows a block stages
constexpr int kERun = 4;                   // rows a warp tests per branch
constexpr int kNaNBits = 0x7fc00000;       // seg ratio of a masked row or newcomer

// A 32-bit key of a voxel block: equal blocks give equal keys, so a pair
// whose keys differ is not a blocker; a pair whose keys agree is compared
// exactly.
__device__ __forceinline__ int block_key(int b0, int b1, int b2) {
  return (int)(((unsigned)b0 * 0x9E3779B1u) ^ ((unsigned)b1 * 0x85EBCA77u) ^
               ((unsigned)b2 * 0xC2B2AE3Du));
}

// E: per newcomer, does a valid map row in [0, n_valid) block it?  Split
// blockIdx.x of gridDim.x, newcomer block blockIdx.y (see the header).
// part holds gridDim.y rows of gridDim.x * kEPerLane flag words.
__global__ void __launch_bounds__(kEThreads)
dedup_kernel(const float* __restrict__ pos, const int32_t* __restrict__ blk,
             const float* __restrict__ seg, const float* __restrict__ mpos,
             const int32_t* __restrict__ mblk, const float* __restrict__ mseg,
             const uint8_t* __restrict__ mvalid, const int32_t* __restrict__ nv_ptr,
             int k, int c, float r2, unsigned* __restrict__ part,
             int* __restrict__ counters, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int4 sb[kERows];     // key, seg ratio bits, b0, b1
  __shared__ __align__(16) float4 sp[kERows];   // x, y, z, b2 bits
  __shared__ unsigned sflag[kEWarps][kEPerLane];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nsplit = gridDim.x, g = blockIdx.y;

  // The live rows [0, n_valid), shared evenly by the splits.
  const int live = min(max(*nv_ptr, 0), c);
  const int per = (live + nsplit - 1) / nsplit;  // <= kERows: the wrapper picks nsplit so
  const int j0 = min((int)blockIdx.x * per, live);
  const int cnt = min(j0 + per, live) - j0;

  // Whole runs of kERun rows: the pad rows past cnt are inert.
  for (int s = tid; s < (cnt + kERun - 1) / kERun * kERun; s += kEThreads) {
    if (s < cnt) {
      const size_t j = j0 + s;
      const int b0 = mblk[3 * j], b1 = mblk[3 * j + 1], b2 = mblk[3 * j + 2];
      sb[s] = make_int4(block_key(b0, b1, b2),
                        mvalid[j] ? __float_as_int(mseg[j]) : kNaNBits, b0, b1);
      sp[s] = make_float4(mpos[3 * j], mpos[3 * j + 1], mpos[3 * j + 2], __int_as_float(b2));
    } else {
      sb[s] = make_int4(0, kNaNBits, 0, 0);
      sp[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  const int i0 = g * kENew;
  float qx[kEPerLane], qy[kEPerLane], qz[kEPerLane], qq[kEPerLane], qs[kEPerLane];
  int q0[kEPerLane], q1[kEPerLane], q2[kEPerLane], qk[kEPerLane];
  bool hit[kEPerLane];
#pragma unroll
  for (int u = 0; u < kEPerLane; ++u) {
    const int i = i0 + lane + 32 * u;
    const bool in = i < k;
    qx[u] = in ? pos[3 * i] : 0.0f;
    qy[u] = in ? pos[3 * i + 1] : 0.0f;
    qz[u] = in ? pos[3 * i + 2] : 0.0f;
    qq[u] = norm2(qx[u], qy[u], qz[u]);
    qs[u] = in ? seg[i] : __int_as_float(kNaNBits);
    q0[u] = in ? blk[3 * i] : 0;
    q1[u] = in ? blk[3 * i + 1] : 0;
    q2[u] = in ? blk[3 * i + 2] : 0;
    qk[u] = block_key(q0[u], q1[u], q2[u]);
    hit[u] = false;
  }
  __syncthreads();

  // A warp takes runs of kERun rows in turn.  Per pair the fast test takes
  // the row's key and seg ratio (its first 8 bytes) and is one integer and
  // one f32 compare (NaN >= s is false); a run branches once, only when a
  // pair of it passes, and there the block is compared exactly and the
  // distance computed.  (Holding each row's whole int4 across the branch
  // instead measured 8% slower.)
  const int2* skey = reinterpret_cast<const int2*>(sb);
  for (int t = kERun * warp; t < cnt; t += kERun * kEWarps) {
    bool cand[kERun][kEPerLane];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kERun; ++r) {
      const int2 ks = skey[2 * (t + r)];
#pragma unroll
      for (int u = 0; u < kEPerLane; ++u) {
        cand[r][u] = (ks.x == qk[u]) & (__int_as_float(ks.y) >= qs[u]);
        any |= cand[r][u];
      }
    }
    if (any) {
#pragma unroll
      for (int r = 0; r < kERun; ++r) {
        const int4 b = sb[t + r];
        const float4 p = sp[t + r];
        const float pp = norm2(p.x, p.y, p.z);
#pragma unroll
        for (int u = 0; u < kEPerLane; ++u)
          if (cand[r][u] & (b.z == q0[u]) & (b.w == q1[u]) & (__float_as_int(p.w) == q2[u]))
            hit[u] |= pair_d2(qq[u], pp, dot3(qx[u], qy[u], qz[u], p.x, p.y, p.z)) < r2;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kEPerLane; ++u) {
    const unsigned m = __ballot_sync(0xffffffffu, hit[u]);  // bit l: newcomer i0 + 32u + l
    if (lane == 0) sflag[warp][u] = m;
  }
  __syncthreads();

  if (tid < kEPerLane) {
    unsigned m = 0;
#pragma unroll
    for (int w = 0; w < kEWarps; ++w) m |= sflag[w][tid];
    part[((size_t)g * nsplit + blockIdx.x) * kEPerLane + tid] = m;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[g], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (warp < kEPerLane) {  // warp u ORs word u over the splits
    unsigned m = 0;
    for (int x = lane; x < nsplit; x += 32)
      m |= __ldcg(part + ((size_t)g * nsplit + x) * kEPerLane + warp);
    m = __reduce_or_sync(0xffffffffu, m);
    const int i = i0 + 32 * warp + lane;
    if (i < k) out[i] = (m >> lane) & 1u;
  }
  if (tid == 0) counters[g] = 0;  // ready for the next call on this stream
}

// ---- Kernel G -------------------------------------------------------------

constexpr int kGThreads = 1024;
constexpr int kGWarps = kGThreads / 32;  // 32: one lane per warp in the last stage
constexpr int kGSums = 9;                // most sums a block reduction takes at once
constexpr int kGPower = 30;              // Horn's shifted power iterations
constexpr float kGEps = 1e-8f;           // se3.py's _EPS

// The block's sums of v[0..n) over its threads, in a fixed tree: each warp
// halves by __shfl_down_sync (16, 8, 4, 2, 1), then warp 0 sums the 32
// warps' partials the same way.  Every thread gets the sums.  No atomics:
// the order, and so the bits, are the same on every run.
template <int N>
__device__ __forceinline__ void g_block_sum(float (&v)[N], float (*part)[kGWarps],
                                            float* tot) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) part[k][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float x = part[k][lane];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
      if (lane == 0) tot[k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = tot[k];
  __syncthreads();  // tot and part are free again
}

// Whether source row i and its nearest candidate make a pair (icp.py's
// pair_ok: a valid source, a candidate found, d2 within the distance).
__device__ __forceinline__ bool g_pair(const uint8_t* sm, const float* nn_d2, int i,
                                       float mcd2) {
  const float d2 = nn_d2[i];
  return sm[i] && d2 < 1e30f && d2 <= mcd2;
}

// Row i's normalised weight w / (sum w + eps) and its candidate's position,
// dst row nn[i], or dst row i where nn is null (the candidates gathered
// already), read only for a pair (a row with no candidate has index 0,
// which an empty candidate set does not hold); other rows weigh 0 and take
// (0, 0, 0): like their true position, times a weight of 0, they add zeros
// to every sum.
__device__ __forceinline__ void g_row(const uint8_t* sm, const float* dst,
                                      const float* nn_d2, const int32_t* nn, int i,
                                      float mcd2, float wsum, float& wn, float* p) {
  const bool ok = g_pair(sm, nn_d2, i, mcd2);
  wn = __fdiv_rn(ok ? 1.0f : 0.0f, wsum);
  const size_t j = ok ? (size_t)(nn ? nn[i] : i) : 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = ok ? dst[3 * j + a] : 0.0f;
}

// a[0..3] . b[0..3] as the FMA chain in index order (a K=4 product).
__device__ __forceinline__ float dot4(float a0, float a1, float a2, float a3,
                                      float b0, float b1, float b2, float b3) {
  return __fmaf_rn(a3, b3, __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0))));
}

// se3.kabsch's tail for one problem, given the cross-covariance H (row
// major) and both weighted means: Horn's 4x4 matrix K of H / (|H| + eps),
// shifted by 2 I, 30 power iterations from (1, 1, 1, 1) normalised by
// |q| + eps each, the quaternion's rotation and t = mu_dst - R mu_src.
// Writes the step's top three rows (R | t) to Ts.  Each element-wise step
// is its PyTorch operation's rounding (unfused _rn intrinsics in the
// plain version's order); the K=3 and K=4 products are FMA chains.
__device__ void g_kabsch_tail(const float* H, const float* ms, const float* md,
                              float* Ts) {
  float ss = 0.0f;
#pragma unroll
  for (int e = 0; e < 9; ++e) ss = __fadd_rn(ss, __fmul_rn(H[e], H[e]));
  const float scale = __fadd_rn(__fsqrt_rn(ss), kGEps);
  float S[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) S[e] = __fdiv_rn(H[e], scale);
  const float xx = S[0], xy = S[1], xz = S[2], yx = S[3], yy = S[4], yz = S[5],
              zx = S[6], zy = S[7], zz = S[8];
  const float a = __fsub_rn(yz, zy), b = __fsub_rn(zx, xz), c = __fsub_rn(xy, yx);
  const float d = __fadd_rn(xy, yx), e = __fadd_rn(zx, xz), f = __fadd_rn(yz, zy);
  // K + 2 I; an off-diagonal + 0 changes no value.
  const float K[4][4] = {
      {__fadd_rn(__fadd_rn(__fadd_rn(xx, yy), zz), 2.0f), a, b, c},
      {a, __fadd_rn(__fsub_rn(__fsub_rn(xx, yy), zz), 2.0f), d, e},
      {b, d, __fadd_rn(__fsub_rn(__fadd_rn(-xx, yy), zz), 2.0f), f},
      {c, e, f, __fadd_rn(__fadd_rn(__fsub_rn(-xx, yy), zz), 2.0f)}};
  float q0 = 1.0f, q1 = 1.0f, q2 = 1.0f, q3 = 1.0f;
  for (int it = 0; it < kGPower; ++it) {
    const float p0 = dot4(K[0][0], K[0][1], K[0][2], K[0][3], q0, q1, q2, q3);
    const float p1 = dot4(K[1][0], K[1][1], K[1][2], K[1][3], q0, q1, q2, q3);
    const float p2 = dot4(K[2][0], K[2][1], K[2][2], K[2][3], q0, q1, q2, q3);
    const float p3 = dot4(K[3][0], K[3][1], K[3][2], K[3][3], q0, q1, q2, q3);
    const float den = __fadd_rn(__fsqrt_rn(dot4(p0, p1, p2, p3, p0, p1, p2, p3)), kGEps);
    q0 = __fdiv_rn(p0, den);
    q1 = __fdiv_rn(p1, den);
    q2 = __fdiv_rn(p2, den);
    q3 = __fdiv_rn(p3, den);
  }
  // quat_to_matrix, w = q0: 1 - 2 (y y + z z), 2 (x y - w z), ...
  const float w = q0, x = q1, y = q2, z = q3;
  const float R[9] = {
      __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(y, y), __fmul_rn(z, z)))),
      __fmul_rn(2.0f, __fsub_rn(__fmul_rn(x, y), __fmul_rn(w, z))),
      __fmul_rn(2.0f, __fadd_rn(__fmul_rn(x, z), __fmul_rn(w, y))),
      __fmul_rn(2.0f, __fadd_rn(__fmul_rn(x, y), __fmul_rn(w, z))),
      __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)))),
      __fmul_rn(2.0f, __fsub_rn(__fmul_rn(y, z), __fmul_rn(w, x))),
      __fmul_rn(2.0f, __fsub_rn(__fmul_rn(x, z), __fmul_rn(w, y))),
      __fmul_rn(2.0f, __fadd_rn(__fmul_rn(y, z), __fmul_rn(w, x))),
      __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y))))};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    Ts[4 * r] = R[3 * r];
    Ts[4 * r + 1] = R[3 * r + 1];
    Ts[4 * r + 2] = R[3 * r + 2];
    Ts[4 * r + 3] = __fsub_rn(md[r], dot3(R[3 * r], R[3 * r + 1], R[3 * r + 2],
                                          ms[0], ms[1], ms[2]));
  }
}

// G: one ICP iteration after kernel D, in one block (see the header).
// init: T = I and cur = src under it, rmse = 0, n_pairs = 0, no pairs read.
// Otherwise cur holds the source under T and (nn_d2, nn) its nearest
// candidates (nn null: row i's is dst row i); T becomes the Kabsch step (identity below 3 pairs) composed
// with T, cur the source under it, and rmse and n_pairs this iteration's.
__global__ void __launch_bounds__(kGThreads)
icp_update_kernel(const float* __restrict__ src, const uint8_t* __restrict__ sm,
                  const float* __restrict__ dst, const float* __restrict__ nn_d2,
                  const int32_t* __restrict__ nn, int k, float mcd2, int init,
                  float* __restrict__ T, float* __restrict__ cur,
                  float* __restrict__ rmse, int32_t* __restrict__ n_pairs) {
  __shared__ float part[kGSums][kGWarps];
  __shared__ float tot[kGSums];
  __shared__ float Tn[16];
  const int tid = threadIdx.x;

  if (init) {
    if (tid < 16) Tn[tid] = tid % 5 == 0 ? 1.0f : 0.0f;
    if (tid == 0) {
      *rmse = 0.0f;
      *n_pairs = 0;
    }
  } else {
    // Pass 1: the pair count (sum of 0/1 weights, exact in f32) and the
    // sum of the pairs' d2 for the rmse.
    float s1[2] = {0.0f, 0.0f};
    for (int i = tid; i < k; i += kGThreads) {
      if (g_pair(sm, nn_d2, i, mcd2)) {
        s1[0] = __fadd_rn(s1[0], 1.0f);
        s1[1] = __fadd_rn(s1[1], nn_d2[i]);
      }
    }
    g_block_sum(s1, part, tot);
    const float n = s1[0];
    const float wsum = __fadd_rn(n, kGEps);

    // Pass 2: the weighted means, weights w / (sum w + eps).
    float s2[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < k; i += kGThreads) {
      float wn, p[3];
      g_row(sm, dst, nn_d2, nn, i, mcd2, wsum, wn, p);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s2[a] = __fadd_rn(s2[a], __fmul_rn(cur[3 * i + a], wn));
        s2[3 + a] = __fadd_rn(s2[3 + a], __fmul_rn(p[a], wn));
      }
    }
    g_block_sum(s2, part, tot);

    // Pass 3: the centred cross-covariance H[a][b] = sum w src_c[a] dst_c[b].
    float s3[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < k; i += kGThreads) {
      float wn, p[3], ws[3], dc[3];
      g_row(sm, dst, nn_d2, nn, i, mcd2, wsum, wn, p);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ws[a] = __fmul_rn(wn, __fsub_rn(cur[3 * i + a], s2[a]));
        dc[a] = __fsub_rn(p[a], s2[3 + a]);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) s3[3 * a + b] = __fmaf_rn(ws[a], dc[b], s3[3 * a + b]);
    }
    g_block_sum(s3, part, tot);

    if (tid == 0) {
      float Ts[16];
      if (n >= 3.0f) {
        g_kabsch_tail(s3, s2, s2 + 3, Ts);
      } else {
#pragma unroll
        for (int e = 0; e < 12; ++e) Ts[e] = e % 5 == 0 ? 1.0f : 0.0f;
      }
      Ts[12] = Ts[13] = Ts[14] = 0.0f;
      Ts[15] = 1.0f;
      float Tp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) Tp[e] = T[e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          Tn[4 * r + cc] = dot4(Ts[4 * r], Ts[4 * r + 1], Ts[4 * r + 2], Ts[4 * r + 3],
                                Tp[cc], Tp[4 + cc], Tp[8 + cc], Tp[12 + cc]);
      *rmse = __fsqrt_rn(__fdiv_rn(s1[1], fmaxf(n, 1.0f)));
      *n_pairs = (int32_t)n;
    }
  }
  __syncthreads();
  if (tid < 16) T[tid] = Tn[tid];
  // The source under the new pose: R p + t, R p as the FMA chain.
  for (int i = tid; i < k; i += kGThreads) {
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      cur[3 * i + r] = __fadd_rn(dot3(Tn[4 * r], Tn[4 * r + 1], Tn[4 * r + 2], px, py, pz),
                                 Tn[4 * r + 3]);
  }
}

}  // namespace

extern "C" {

// Scratch from the caller, for ngroup = ceil(ka / 64) source blocks: apart
// nsplit * ngroup * 64 keys, bpart ngroup * cb keys, acount ngroup ints and
// bcount nsplit ints, zero before the first call.  nsplit * 512 >= cb, and
// ka and cb are below 2^20.
int bshot_hamming_nn_bounded(const int32_t* a, const uint8_t* am, const int32_t* b,
                             const uint8_t* bm, const int32_t* nv, int ka, int cb,
                             int tail_start, int nsplit, unsigned* apart,
                             unsigned* bpart, int* acount, int* bcount,
                             float* amin, int32_t* aarg, float* bmin,
                             int32_t* barg, void* stream) {
  if (ka < 1 || cb < 1 || ka >= (1 << kCShift) || cb >= (1 << kCShift) ||
      nsplit < 1 || (long long)nsplit * kCRows < cb)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, (ka + kCSources - 1) / kCSources);
  hamming_kernel<<<grid, kCThreads, 0, (cudaStream_t)stream>>>(
      a, am, b, bm, nv, ka, cb, tail_start, apart, bpart, acount, bcount, amin,
      aarg, bmin, barg);
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

// Scratch from the caller, for ngroup = ceil(k / 64) newcomer blocks: part
// ngroup * nsplit * 2 words, counters ngroup ints, zero before the first
// call.  nsplit * 640 >= c.  out is k bytes, each written 0 or 1.
int bshot_dedup_blocked_bounded(const float* pos, const int32_t* blk,
                                const float* seg, const float* mpos,
                                const int32_t* mblk, const float* mseg,
                                const uint8_t* mvalid, const int32_t* nv, int k,
                                int c, float r2, int nsplit, unsigned* part,
                                int* counters, uint8_t* out, void* stream) {
  if (k < 1 || c < 1 || nsplit < 1 || (long long)nsplit * kERows < c)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, (k + kENew - 1) / kENew);
  dedup_kernel<<<grid, kEThreads, 0, (cudaStream_t)stream>>>(
      pos, blk, seg, mpos, mblk, mseg, mvalid, nv, k, c, r2, part, counters, out);
  return (int)cudaGetLastError();
}

// One block.  init != 0: T = I, cur = src, rmse = 0, n_pairs = 0 (sm, dst,
// nn_d2 and nn unread).  Otherwise one ICP update in place of T (16 floats,
// row major) and cur (k x 3), with the pairs' rmse and count; nn may be
// null, dst then holding each source row's candidate in its row.  k >= 0.
int bshot_icp_update(const float* src, const uint8_t* sm, const float* dst,
                     const float* nn_d2, const int32_t* nn, int k, float mcd2,
                     int init, float* T, float* cur, float* rmse,
                     int32_t* n_pairs, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  icp_update_kernel<<<1, kGThreads, 0, (cudaStream_t)stream>>>(
      src, sm, dst, nn_d2, nn, k, mcd2, init, T, cur, rmse, n_pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
