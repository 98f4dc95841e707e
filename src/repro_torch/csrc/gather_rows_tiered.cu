// Tiered Stage-II winner gather: staged rows from HBM, missed rows from
// pinned host memory, each distinct missed (row, kv head) read over the
// link once per launch, in one launch.
//
// Replaces the TPU kernel repro/kernels/gather_kv/ops.py
// (gather_kv_tiered_kernel, which composes the host block tables with
// dev_map and then runs _gather_rows_paged_pallas over the staging pool),
// extended to what repro/models/layers.py:attn_decode_pariskv_tiered does
// around it: the staged-winner gather, the host fetch of the misses (a
// jax.pure_callback into numpy there, repro/serving/offload.py:
// _dedup_heads_gather, which deduplicates the (row, head) pairs before it
// touches the host pool) and the blend k_ret = where(resident, k_hit,
// k_miss).
//
//   staging (nd, bs, G, hd) in device memory; host (nb*bs, G, hd) pinned
//   host memory, addressed directly under unified virtual addressing;
//   dev_map (nb,) host block -> staging block (-1 = not staged);
//   rows (b, G, Q, k) flat host rows -> out (b, G, Q, k, hd):
//     rows[r] < 0                       -> zeros (the reference's skipped
//                                          miss: a winner outside the
//                                          retrieval region, not staged)
//     s = dev_map[rows[r] / bs] >= 0    -> staging[s*bs + rows[r] % bs][g]
//     otherwise                         -> host[rows[r]][g]    (over PCIe)
// with g the output row's kv head; K and V together. *count, when given,
// grows by the launch's distinct missed (row, kv head) pairs: the
// reference's unique count, np.unique(row*G + g) over the missed rows.
//
// Deduplication spans the whole launch, as the reference's np.unique
// does: every batch row's entries of one kv head g form one group (b*Q*k
// entries), so a row that two batch rows pick is read once too. That
// happens with prefix sharing (ROADMAP A8), and already today when a free
// slot's frozen regions and -1 table row send its winners to block 0,
// which another slot may own.
//
// Bound on the H100: bytes. The staged rows move at HBM rate, the
// distinct missed ones over the PCIe link (host -> device, far below
// HBM's 3.35 TB/s), so a step's distinct misses set its time. Scattered
// 256-byte host reads reach about half the link's rate for bulk copies.
//
// Design: a cluster of blocks (up to 16) per kv head. The group's entries
// go in tiles of cluster * threads, one entry per thread:
//   1. election: a missed entry claims its (row, head) key in a
//      direct-mapped table in device memory (owner, nb*bs*G int32, all -1
//      between launches) with atomicCAS; the winner is the leader, a
//      loser learns its leader's entry from the value the CAS returns.
//      Each entry's source (staging row, host row, leader or zero) goes
//      to shared memory;
//   2. copy: the block's threads move every 16-byte vector of K and V of
//      its zero, staged and leader entries, kUnroll vectors each loaded
//      before any is stored, so the link sees many reads in flight (host
//      rows with ld.global.cv, __ldcv: no cached copy is trusted, since
//      the engine rewrites host blocks between chunks);
//   3. after a cluster barrier (release/acquire at cluster scope: every
//      leader of the tile is written), followers copy their leader's
//      output row, which sits in HBM/L2, not behind the link.
// A follower may sit in a later tile than its leader, so leaders clear
// their keys only after the last tile's barrier, which follows every
// election of the cluster.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;   // vectors a thread loads before it stores
enum : int { kZero = 0, kStaged = 1, kLeader = 2, kFollower = 3 };

__global__ void __launch_bounds__(kMaxThreads)
gather_rows_tiered_kernel(const uint4* __restrict__ stag_k,
                          const uint4* __restrict__ stag_v,
                          const uint4* host_k, const uint4* host_v,
                          uint4* out_k, uint4* out_v,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ dev_map,
                          int32_t* owner, unsigned long long* count, int nb,
                          int nd, int bs, int G, int b, int qk, int row_vec) {
  __shared__ int kind[kMaxThreads];
  __shared__ int src[kMaxThreads];   // staging/host head row, or leader
  __shared__ int distinct;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int g = blockIdx.y;                          // the kv head
  const int T = blockDim.x, tid = threadIdx.x;
  const int n = b * qk;                              // the group's entries
  const int last_row = nb * bs - 1;
  int32_t* keys = owner + g;
  // entry e of the group: batch row e / qk, position e % qk of its (b, g)
  auto flat = [&](int e) -> size_t {
    return ((size_t)(e / qk) * G + g) * qk + e % qk;
  };
  if (tid == 0) distinct = 0;
  int leaders = 0;

  for (int t0 = 0; t0 < n; t0 += csize * T) {
    const int e0 = t0 + rank * T;        // this block's entries of the tile
    const int cnt = max(0, min(T, n - e0));
    if (tid < cnt) {                     // 1. election
      const int e = e0 + tid;
      const int row = rows[flat(e)];
      int k = kZero, s_row = 0;
      if (row >= 0) {
        const int phys = repro::clampi(row, 0, last_row);
        const int s = dev_map[phys / bs];
        if (s >= 0) {
          k = kStaged;
          s_row = (repro::clampi(s, 0, nd - 1) * bs + phys % bs) * G + g;
        } else {
          const int old = atomicCAS(keys + (size_t)phys * G, -1, e);
          if (old < 0) {
            k = kLeader;
            s_row = phys * G + g;
            ++leaders;
          } else {
            k = kFollower;
            s_row = old;
          }
        }
      }
      kind[tid] = k;
      src[tid] = s_row;
    }
    __syncthreads();
    const int work = cnt * row_vec;
    for (int i0 = tid; i0 < work; i0 += kUnroll * T) {  // 2. zero, staged,
      uint4 a[kUnroll], b[kUnroll];                     //    leader rows
      size_t o[kUnroll];
      bool w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * T;
        const int j = i / row_vec, v = i - j * row_vec;
        const int k = i < work ? kind[j] : kFollower;
        w[u] = k != kFollower;
        o[u] = (w[u] ? flat(e0 + j) : 0) * row_vec + v;
        const size_t s = w[u] ? (size_t)src[j] * row_vec + v : 0;
        a[u] = b[u] = make_uint4(0, 0, 0, 0);
        if (k == kStaged) {
          a[u] = stag_k[s];
          b[u] = stag_v[s];
        } else if (k == kLeader) {
          a[u] = __ldcv(host_k + s);
          b[u] = __ldcv(host_v + s);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!w[u]) continue;
        out_k[o[u]] = a[u];
        out_v[o[u]] = b[u];
      }
    }
    cluster.sync();                      // every leader row of the tile out
    for (int i = tid; i < work; i += T) {  // 3. followers, from HBM/L2
      const int j = i / row_vec, v = i - j * row_vec;
      if (kind[j] != kFollower) continue;
      const size_t o = flat(e0 + j) * row_vec + v;
      const size_t l = flat(src[j]) * row_vec + v;
      out_k[o] = out_k[l];
      out_v[o] = out_v[l];
    }
    __syncthreads();                     // kind/src free for the next tile
  }

  // every election of the cluster is done: leaders clear their keys
  for (int e = rank * T + tid; e < n; e += csize * T) {
    const int row = rows[flat(e)];
    if (row < 0) continue;
    const int phys = repro::clampi(row, 0, last_row);
    if (dev_map[phys / bs] >= 0) continue;
    atomicCAS(keys + (size_t)phys * G, e, -1);
  }
  if (leaders) atomicAdd(&distinct, leaders);
  __syncthreads();
  if (tid == 0 && count != nullptr && distinct)
    atomicAdd(count, (unsigned long long)distinct);
}

}  // namespace

REPRO_EXPORT int gather_rows_tiered_launch(
    const void* stag_k, const void* stag_v, const void* host_k,
    const void* host_v, void* out_k, void* out_v, const void* rows,
    const void* dev_map, void* owner, void* count, int b, int nb, int nd,
    int bs, int G, int qk, int row_vec, int cluster, int threads,
    cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 &&
       cluster != 16) ||
      (long long)b * qk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || G == 0 || qk == 0) return (int)cudaGetLastError();
  if (cluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_tiered_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)G);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gather_rows_tiered_kernel, static_cast<const uint4*>(stag_k),
      static_cast<const uint4*>(stag_v), static_cast<const uint4*>(host_k),
      static_cast<const uint4*>(host_v), static_cast<uint4*>(out_k),
      static_cast<uint4*>(out_v), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(dev_map), static_cast<int32_t*>(owner),
      static_cast<unsigned long long*>(count), nb, nd, bs, G, b, qk,
      row_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
