// Top-C candidate cut over small-range integer scores, with no sort, from
// histograms per segment of kSegLen positions.
//
// Replaces the TPU kernel repro/kernels/bucket_topk/bucket_topk.py
// (_histogram_pallas / _kernel) together with the threshold walk and
// prefix-sum compaction of repro/kernels/bucket_topk/ops.py:bucket_topk.
// The index set and its order equal core/retrieval.py's
// select_candidates_bucket exactly: every index whose score is above the
// threshold, plus the lowest-index ties up to the quota, in ascending
// index order (lax.top_k's lowest-index-first tie rule).
//
// Scores lie in [-1, score_range]; the histograms count score+1 over
// rng = score_range + 2 bins (98 for B=16). seg_hist[row, j, v] counts the
// positions of segment j (positions [j*kSegLen, (j+1)*kSegLen) of the row)
// whose score+1 is v. Stage I (collision_paged.cu) writes them beside its
// scores; callers without them get bucket_hist_kernel first. C = min(c, n)
// by construction (ParisKVConfig.candidate_count), so the histograms sum to
// n >= C and the walk always finds a threshold; the "no bin reaches C"
// branch only mirrors the reference's argmax-of-all-false.
//
// Bound on the H100: bytes. From seg_hist it must read each row's
// histograms, the scores of the segments that hold a taken index (a
// segment with none is never read), and write C int32 indices. At the
// decode path's shapes (48 rows, n=16384, 64 segments, C=1311) that is
// about 2.8 MB, 0.84 us at 3.35 TB/s. The histogram pass reads every score
// once and writes the histograms: 3.1 + 1.2 MB, 1.3 us.
//
// What held the first version (one 1024-thread block per row: shared
// atomics per score, a one-thread walk over the bins, tiles compacted in
// order with two block-wide scans each) back, and what this design does:
//   * 48 blocks on 132 SMs, tiles in order: the grid is now (parts, rows)
//     with one warp per segment to compact (parts = ceil(nseg / warps)),
//     and every segment's output offset and share of the tie quota known
//     up front, so the warps compact in parallel with no look-back,
//     atomics or second launch. The launcher takes the warps per block
//     (the wrapper passes 32: 96 blocks at the decode shapes, still fewer
//     than the SMs). Every block sums the row's histograms itself, so
//     more blocks per row repeat that sum: on the H100 8 and 16 warps a
//     block (384 and 192 blocks) were slower than 32.
//   * Scores read twice (histogram, then compaction), every masked
//     position an atomic on bin 0: the histograms come from Stage I, which
//     counts masked positions in closed form; the cut reads no score to
//     find its threshold, and a segment with nothing to take (every
//     masked tail, every segment past the C-th survivor) is never read.
//   * The serial walk: each block sums the row's histograms with one batch
//     of loads in flight per thread, and one warp finds the threshold and
//     the tie quota with a suffix scan over the bins.
//   * Inside a segment a warp ranks 4 positions per lane with two warp
//     scans (ties, then takes); both chunks of the segment are loaded
//     before either is ranked.
// Tried and dropped on the H100: one cluster of 8 blocks per row that
// exchanged partial histograms through distributed shared memory (the
// cluster launch and barriers cost more than reading the row's 25 KB of
// histograms in every block), keeping those histograms in shared memory
// for step 3 (slower than reading them again), and __match_any_sync to
// aggregate the histogram pass's shared atomics (slower than plain
// atomics there). Also a cut that read the row's histograms as one flat
// int4 array with a shared atomic per nonzero bin, summed the segments
// before its own into a second histogram so that step 3 read nothing
// again, and optionally loaded its scores before the threshold: its best
// grid (32 warps a block) was slower than this cut's, and the early score
// loads made every grid slower.
// bucket_hist_kernel (callers without Stage I's histograms): one warp per
// segment, the segment's scores loaded at once, a per-warp shared
// histogram.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // 32 warps: 32 segments a block at most
constexpr int kBatch = 8;          // histogram loads in flight per thread
constexpr int kChunk = 128;        // positions a warp reads per step
constexpr int kSegChunks = repro::kSegLen / kChunk;
static_assert(repro::kSegLen % kChunk == 0, "whole chunks per segment");

// score+1 of the four positions p..p+3; positions >= hi give -1, which no
// bin counts and which is never above or at a threshold (>= 0).
__device__ __forceinline__ void load4(const int32_t* __restrict__ s, int p,
                                      int hi, bool vec, int* v) {
  if (vec && p + 3 < hi) {
    const int4 x = *reinterpret_cast<const int4*>(s + p);
    v[0] = x.x + 1; v[1] = x.y + 1; v[2] = x.z + 1; v[3] = x.w + 1;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = p + q < hi ? s[p + q] + 1 : -1;
  }
}

// A warp's segment: lane l holds positions lo + c*kChunk + 4l + q, every
// chunk loaded before any is used.
__device__ __forceinline__ void load_segment(const int32_t* __restrict__ s,
                                             int lo, int hi, bool vec,
                                             int (&v)[kSegChunks][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kSegChunks; ++c)
    load4(s, lo + c * kChunk + lane * 4, hi, vec, v[c]);
}

// Exclusive prefix sum of x over the 32 lanes of a full warp; *total
// receives the warp's sum.
__device__ __forceinline__ int warp_exclusive_scan(int x, int* total) {
  const int lane = threadIdx.x & 31;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  *total = __shfl_sync(0xffffffffu, v, 31);
  return v - x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(256)
bucket_hist_kernel(const int32_t* __restrict__ scores,
                   int32_t* __restrict__ seg_hist, int n, int nseg, int rng,
                   int vec) {
  extern __shared__ int sh[];                 // (8 warps, rng)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 8 + warp;
  const int row = blockIdx.y;
  int* h = sh + warp * rng;
  if (j >= nseg) return;                      // the whole warp
  const int lo = j * repro::kSegLen, hi = min(lo + repro::kSegLen, n);
  int v[kSegChunks][4];
  load_segment(scores + (size_t)row * n, lo, hi, vec, v);
  for (int i = lane; i < rng; i += 32) h[i] = 0;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kSegChunks; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (v[c][q] >= 0 && v[c][q] < rng) atomicAdd(&h[v[c][q]], 1);
  __syncwarp();
  int32_t* dst = seg_hist + ((size_t)row * nseg + j) * rng;
  for (int i = lane; i < rng; i += 32) dst[i] = h[i];
}

// One warp per segment to compact, blockDim.x / 32 segments per block
// (grid.x blocks per row); every block reads the row's histograms.
__global__ void __launch_bounds__(kMaxThreads)
bucket_topk_kernel(const int32_t* __restrict__ scores,
                   const int32_t* __restrict__ seg_hist,
                   int32_t* __restrict__ out, int n, int k, int rng, int nseg,
                   int vec) {
  const int W = blockDim.x >> 5, nthr = blockDim.x;
  const int r = blockIdx.x, row = blockIdx.y;
  const int s0 = min(r * W, nseg), s1 = min(s0 + W, nseg);
  extern __shared__ int sh[];
  int* total = sh;                      // rng: the row's histogram
  int* above_ex = total + rng;          // nseg+1: exclusive sums, segments
  int* tie_ex = above_ex + nseg + 1;    // nseg+1
  int* walk = tie_ex + nseg + 1;        // threshold, quota

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* H = seg_hist + (size_t)row * nseg * rng;

  // 1. the row's histogram: thread (g, v) sums bin v of segments g,
  //    g + groups, ..., a batch of loads in flight at once (rng <= nthr)
  for (int i = tid; i < rng; i += nthr) total[i] = 0;
  __syncthreads();
  const int groups = min(nthr / rng, nseg);
  if (tid < groups * rng) {
    const int g = tid / rng, v = tid - g * rng;
    int a = 0;
    for (int j0 = g; j0 < nseg; j0 += groups * kBatch) {
      int x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = j0 + u * groups;
        x[u] = jj < nseg ? H[jj * rng + v] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) a += x[u];
    }
    if (a) atomicAdd(&total[v], a);
  }
  __syncthreads();

  // 2. threshold and tie quota: suffix scan over the bins, one warp
  if (warp == 0) {
    const int D = (rng + 31) / 32;      // descending bins per lane
    const int d0 = min(lane * D, rng), d1 = min(d0 + D, rng);
    int cnt = 0;
    for (int d = d0; d < d1; ++d) cnt += total[rng - 1 - d];
    int all;
    const int ex = warp_exclusive_scan(cnt, &all);
    const unsigned meets = __ballot_sync(0xffffffffu, ex + cnt >= k);
    if (meets == 0) {
      if (lane == 0) {                  // unreachable for k <= n
        walk[0] = rng - 1;
        walk[1] = k - all;
      }
    } else if (lane == __ffs(meets) - 1) {
      int c = ex;
      for (int d = d0; d < d1; ++d) {
        const int t = total[rng - 1 - d];
        if (c + t >= k) {
          walk[0] = rng - 1 - d;
          walk[1] = k - c;
          break;
        }
        c += t;
      }
    }
  }
  __syncthreads();
  const int T = walk[0], quota = walk[1];

  // 3. (above, tie) counts of the segments up to this block's last one
  //    (their histograms read again, now from L1/L2), then their exclusive
  //    sums: each segment's output offset and tie rank
  for (int jj = warp; jj < s1; jj += W) {
    int a = 0;
    for (int v = T + 1 + lane; v < rng; v += 32) a += H[jj * rng + v];
    a = warp_sum(a);
    if (lane == 0) {
      above_ex[jj + 1] = a;
      tie_ex[jj + 1] = H[jj * rng + T];
    }
  }
  __syncthreads();
  if (warp == 0) {
    int ca = 0, ct = 0;
    for (int base = 0; base < s1; base += 32) {
      const int jj = base + lane;
      const int a = jj < s1 ? above_ex[jj + 1] : 0;
      const int t = jj < s1 ? tie_ex[jj + 1] : 0;
      int ta, tt;
      const int ea = warp_exclusive_scan(a, &ta);
      const int et = warp_exclusive_scan(t, &tt);
      if (jj < s1) {
        above_ex[jj + 1] = ca + ea + a;
        tie_ex[jj + 1] = ct + et + t;
      }
      ca += ta;
      ct += tt;
    }
    if (lane == 0) {
      above_ex[0] = 0;
      tie_ex[0] = 0;
    }
  }
  __syncthreads();

  // 4. compaction: one warp per segment of this block, in index order
  const int jj = s0 + warp;
  if (jj >= s1) return;
  const int tie_before = tie_ex[jj];
  const int ties = tie_ex[jj + 1] - tie_before;
  const int want = above_ex[jj + 1] - above_ex[jj] +
                   repro::clampi(quota - tie_before, 0, ties);
  if (want == 0) return;                // nothing here: scores never read
  const int32_t* srow = scores + (size_t)row * n;
  int32_t* orow = out + (size_t)row * k;
  const int lo = jj * repro::kSegLen;
  int v[kSegChunks][4];
  load_segment(srow, lo, min(lo + repro::kSegLen, n), vec, v);
  int rank = tie_before, off = above_ex[jj] + min(tie_before, quota);
#pragma unroll
  for (int c = 0; c < kSegChunks; ++c) {
    int nt = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) nt += v[c][q] == T;
    int tie_tot;
    int rk = rank + warp_exclusive_scan(nt, &tie_tot);
    bool take[4];
    int nk = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool tie = v[c][q] == T;
      take[q] = v[c][q] > T || (tie && rk < quota);
      rk += tie;
      nk += take[q];
    }
    int take_tot;
    int dest = off + warp_exclusive_scan(nk, &take_tot);
    const int p = lo + c * kChunk + lane * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (take[q]) {
        if (dest < k) orow[dest] = p + q;
        ++dest;
      }
    }
    rank += tie_tot;
    off += take_tot;
  }
}

}  // namespace

REPRO_EXPORT int bucket_hist_launch(const void* scores, void* seg_hist,
                                    int rows, int n, int rng, int seg_len,
                                    int vec, cudaStream_t stream) {
  if (seg_len != repro::kSegLen || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const int nseg = (n + repro::kSegLen - 1) / repro::kSegLen;
  dim3 grid((nseg + 7) / 8, rows);
  const size_t smem = (size_t)8 * rng * sizeof(int);
  bucket_hist_kernel<<<grid, 256, smem, stream>>>(
      static_cast<const int32_t*>(scores), static_cast<int32_t*>(seg_hist),
      n, nseg, rng, vec);
  return (int)cudaGetLastError();
}

REPRO_EXPORT int bucket_topk_launch(const void* scores, const void* seg_hist,
                                    void* out, int rows, int n, int k,
                                    int rng, int seg_len, int vec, int warps,
                                    cudaStream_t stream) {
  if (seg_len != repro::kSegLen || rows > 65535 || warps < 1 ||
      warps * 32 > kMaxThreads || rng > warps * 32)
    return (int)cudaErrorInvalidValue;
  const int nseg = (n + repro::kSegLen - 1) / repro::kSegLen;
  const size_t smem = (size_t)(rng + 2 * (nseg + 1) + 2) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((nseg + warps - 1) / warps, rows);
  bucket_topk_kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const int32_t*>(scores),
      static_cast<const int32_t*>(seg_hist), static_cast<int32_t*>(out), n,
      k, rng, nseg, vec);
  return (int)cudaGetLastError();
}
