// Top-C candidate cut over small-range integer scores, with no sort.
//
// Replaces the TPU kernel repro/kernels/bucket_topk/bucket_topk.py
// (_histogram_pallas / _kernel) together with the threshold walk and
// prefix-sum compaction of repro/kernels/bucket_topk/ops.py:bucket_topk.
// The index set and its order equal core/retrieval.py's
// select_candidates_bucket exactly: every index whose score is above the
// threshold, plus the lowest-index ties up to the quota, in ascending
// index order (lax.top_k's lowest-index-first tie rule).
//
// Scores lie in [-1, score_range]; the kernel histograms score+1 over
// rng = score_range + 2 bins (98 for B=16). C = min(c, n) by construction
// (ParisKVConfig.candidate_count), so n < C cannot occur and the walk
// always finds a threshold; the "no bin reaches C" branch only mirrors the
// reference's argmax-of-all-false for completeness.
//
// Bound on the H100: bytes. It must read each row's n int32 scores once
// and write C int32 indices (the compaction stops once C are written, so
// the bytes it reads depend on where the C-th survivor sits). At the
// decode path's shapes (48 rows, n=16384, C=1311) that is about 3.4 MB:
// 1.0 us at the H100's 3.35 TB/s.
//
// Design: one thread block (1024 threads) per (b,g,h) row.
//   1. shared-memory histogram of score+1 (atomicAdd on 98 bins);
//   2. one thread walks the bins from the top: threshold and tie quota;
//   3. tile by tile in index order, two block-wide exclusive scans (warp
//      shuffles + one shared array of warp totals): the tie rank, then the
//      output slot of every taken index, with running counts carried
//      across tiles;
//   4. taken indices are written to out[dest] — ascending by construction.
// Rows run in parallel blocks; a row's tiles run in order inside the block.
#include "common.cuh"

namespace {

// Exclusive block-wide prefix sum of x; *total receives the block sum.
// blockDim.x must be a multiple of 32. wsum holds >= 32 ints of shared
// memory; the leading __syncthreads makes back-to-back calls safe.
__device__ __forceinline__ int block_exclusive_scan(int x, int* wsum,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  __syncthreads();
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  *total = wsum[nw - 1];
  return (warp ? wsum[warp - 1] : 0) + v - x;
}

__global__ void bucket_topk_kernel(const int32_t* __restrict__ scores,
                                   int32_t* __restrict__ out, int n, int k,
                                   int rng) {
  extern __shared__ int sh[];
  int* hist = sh;             // rng bins
  int* wsum = sh + rng;       // 32 warp totals
  int* walk = wsum + 32;      // threshold, quota
  const int32_t* s = scores + (size_t)blockIdx.x * n;
  int32_t* o = out + (size_t)blockIdx.x * k;

  for (int i = threadIdx.x; i < rng; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < k; i += blockDim.x) o[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = s[i] + 1;
    if (v >= 0 && v < rng) atomicAdd(&hist[v], 1);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int cum = 0, above = 0, t_rev = -1;
    for (int t = 0; t < rng; ++t) {
      const int c = hist[rng - 1 - t];
      cum += c;
      if (cum >= k) {
        t_rev = t;
        break;
      }
      above += c;
    }
    if (t_rev < 0) t_rev = 0;  // unreachable for k <= n (see header)
    walk[0] = rng - 1 - t_rev;
    walk[1] = k - above;
  }
  __syncthreads();
  const int thresh = walk[0];
  const int quota = walk[1];

  int carry_tie = 0, carry_take = 0, tot;
  for (int base = 0; base < n && carry_take < k; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? s[i] + 1 : -1;
    const int is_above = i < n && v > thresh;
    const int is_tie = i < n && v == thresh;
    const int tie_rank = carry_tie + block_exclusive_scan(is_tie, wsum, &tot);
    carry_tie += tot;
    const int take = is_above || (is_tie && tie_rank < quota);
    const int dest = carry_take + block_exclusive_scan(take, wsum, &tot);
    carry_take += tot;
    if (take && dest < k) o[dest] = i;
  }
}

}  // namespace

REPRO_EXPORT int bucket_topk_launch(const void* scores, void* out, int rows,
                                    int n, int k, int rng,
                                    cudaStream_t stream) {
  const int threads = 1024;
  const size_t smem = (size_t)(rng + 32 + 2) * sizeof(int);
  bucket_topk_kernel<<<rows, threads, smem, stream>>>(
      static_cast<const int32_t*>(scores), static_cast<int32_t*>(out), n, k,
      rng);
  return (int)cudaGetLastError();
}
