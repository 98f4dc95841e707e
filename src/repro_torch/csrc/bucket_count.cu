// Bucket histogram of a contiguous metadata store's retrieval region: how
// many keys of each (batch row, kv head) fall in each (subspace, centroid)
// bucket, the counts from which Stage I builds its tier-weight table.
//
// Replaces the TPU kernel: none. The reference computes this histogram in
// jnp (repro/core/retrieval.py:bucket_histogram, called from
// collision_scores at :141-146), outside any Pallas kernel; the port wrote
// it as a scatter_add chain (a region mask, a broadcast, a type cast,
// zeros, a transposed int64 copy of the ids and the scatter), the largest
// device item of every contiguous decode path.
//
// Computes, for each batch row b, kv head g, subspace s and centroid c:
//     counts[b,g,s,c] = stride * #{p : p % stride == 0,
//                                  sink <= p < min(enc_end[b], n),
//                                  ids[b,g,p,s] == c}
// ids (b, G, n, B) uint8, enc_end (b,) int32 -> counts (b, G, B, nc)
// int32. With stride 1 that is the exact histogram of [sink, enc_end);
// stride > 1 is the reference's strided sample (hist_sample), scaled back.
// The region comes from enc_end here: no mask tensor is built.
//
// Block-table mode (bt given; the chunked fill's histogram update,
// repro/core/cache.py:paged_fill_hist_update): ids is a pool (nb, G, bs,
// B), bt (b, nblk) maps logical blocks to physical ones, and each row
// counts the logical positions [sink, hi) whose block is allocated
// (bt >= 0, inside the table), stride 1; with accumulate the counts are
// added to the ones in place (the slot's incremental histogram).
//
// Bound on the H100: bytes. It must read each sampled valid key's B ids
// once per kv head and write the counts once (b*G*B*nc*4 bytes); the B
// increments per key are far below the card's integer rate. At the slot
// path's shapes (b=4, G=2, B=16, nc=256, 27,440 valid keys per kv head)
// that is 878,080 + 131,072 bytes: 0.30 us at 3.35 TB/s.
//
// Design: a thread-block cluster per (b, g). Each block of the cluster
// counts a share of the row's sampled keys into its own shared-memory copy
// of the B x nc bins (16 KB at B=16, nc=256) with shared-memory atomics,
// bin s*nc + id; a key's B ids come in one 16-byte load, and each thread
// loads kUnroll keys before it counts any, so several loads are in flight.
// After one cluster barrier every block sums its share of the bins over
// all the cluster's copies through distributed shared memory and writes
// them, scaled by the stride, once: no global atomics, no zeroing launch,
// no second pass. A second barrier keeps each copy alive until the others
// have read it. A row with no valid key writes zeros.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;   // keys a thread loads before counting

template <int B>
__global__ void __launch_bounds__(kMaxThreads)
bucket_count_kernel(const uint8_t* __restrict__ ids,
                    const int32_t* __restrict__ enc_end,
                    const int32_t* __restrict__ bt,
                    int32_t* __restrict__ counts, int G, int n, int nc,
                    int sink, int stride, int nblk, int bs,
                    int accumulate) {
  extern __shared__ int hist[];                        // (B, nc)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int bg = blockIdx.y;                           // (b, g) flattened
  const int T = blockDim.x, tid = threadIdx.x;
  const int bins = B * nc;

  for (int i = tid; i < bins; i += T) hist[i] = 0;
  // the sampled positions p0, p0 + stride, ... below hi (table mode: n is
  // the span's end, stride 1)
  const int hi = bt == nullptr ? min(enc_end[bg / G], n) : n;
  const int p0 = (sink + stride - 1) / stride * stride;
  const int K = hi > p0 ? (hi - p0 + stride - 1) / stride : 0;
  const uint8_t* row = ids + (size_t)bg * n * B;
  const int32_t* bt_row =
      bt == nullptr ? nullptr : bt + (size_t)(bg / G) * nblk;
  const int g = bg % G;
  const int step = csize * T;
  __syncthreads();

  for (int k0 = rank * T + tid; k0 < K; k0 += kUnroll * step) {
    repro::KeyIds<B> key[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * step;
      const int p = p0 + k * stride;
      ok[u] = k < K;
      if (ok[u] && bt_row != nullptr) {
        const int blk = p / bs;
        const int pb = blk < nblk ? bt_row[blk] : -1;
        ok[u] = pb >= 0;
        if (ok[u])
          key[u].load(ids + (((size_t)pb * G + g) * bs + p % bs) * B);
      } else if (ok[u]) {
        key[u].load(row + (size_t)p * B);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int s = 0; s < B; ++s) atomicAdd(&hist[s * nc + key[u][s]], 1);
    }
  }
  cluster.sync();   // every copy complete and visible to the cluster

  int32_t* out = counts + (size_t)bg * bins;
  for (int i = rank * T + tid; i < bins; i += step) {
    int sum = 0;
    for (int r = 0; r < csize; ++r) sum += cluster.map_shared_rank(hist, r)[i];
    out[i] = accumulate ? out[i] + sum * stride : sum * stride;
  }
  cluster.sync();   // no block leaves while another still reads its copy
}

template <int B>
int launch(const void* ids, const void* enc_end, const void* bt,
           void* counts, int b, int G, int n, int nc, int sink, int stride,
           int nblk, int bs, int accumulate, int cluster, int threads,
           cudaStream_t stream) {
  auto kernel = bucket_count_kernel<B>;
  if (cluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)(b * G));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)B * nc * sizeof(int);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(ids),
      static_cast<const int32_t*>(enc_end), static_cast<const int32_t*>(bt),
      static_cast<int32_t*>(counts), G, n, nc, sink, stride, nblk, bs,
      accumulate);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int bucket_count_launch(const void* ids, const void* enc_end,
                                     const void* bt, void* counts, int b,
                                     int G, int n, int B, int nc, int sink,
                                     int stride, int nblk, int bs,
                                     int accumulate, int cluster,
                                     int threads, cudaStream_t stream) {
  if (nc < 1 || nc > 256 || sink < 0 || stride < 1 || n < 1 ||
      (bt != nullptr && (stride != 1 || nblk < 1 || bs < 1)) ||
      (threads != 256 && threads != 512) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 &&
       cluster != 16))
    return (int)cudaErrorInvalidValue;
  if (b * G == 0) return (int)cudaGetLastError();
  if (B == 16)
    return launch<16>(ids, enc_end, bt, counts, b, G, n, nc, sink, stride,
                      nblk, bs, accumulate, cluster, threads, stream);
  if (B == 8)
    return launch<8>(ids, enc_end, bt, counts, b, G, n, nc, sink, stride,
                     nblk, bs, accumulate, cluster, threads, stream);
  return (int)cudaErrorInvalidValue;
}
