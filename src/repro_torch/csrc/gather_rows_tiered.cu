// Tiered Stage-II winner gather: staged rows from HBM, missed rows from
// pinned host memory, in one launch.
//
// Replaces the TPU kernel repro/kernels/gather_kv/ops.py
// (gather_kv_tiered_kernel, which composes the host block tables with
// dev_map and then runs _gather_rows_paged_pallas over the staging pool),
// extended to what repro/models/layers.py:attn_decode_pariskv_tiered does
// around it: the staged-winner gather, the host fetch of the misses (a
// jax.pure_callback into numpy there) and the blend
// k_ret = where(resident, k_hit, k_miss).
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
// with g the output row's kv head. On staged rows this is exactly
// gather_kv_tiered_kernel. K and V share one launch (blockIdx.y).
//
// Bound on the H100: bytes. The staged rows move at HBM rate, the missed
// ones over the PCIe link (host -> device at the link's rate, far below
// HBM's 3.35 TB/s), so a step's misses set its time. Each output row is
// read once and written once; the kernel does not deduplicate rows that
// several query heads share.
//
// Design: one warp per output head row, its lanes copying the row's
// 16-byte vectors (a 256-byte bf16 head row is 16 vectors), as
// gather_rows_paged.cu's physical mode does. Host rows are loaded with
// ld.global.cv (__ldcv: no cached copy is trusted), because the engine
// rewrites host blocks between chunks.
#include "common.cuh"

namespace {

__global__ void gather_rows_tiered_kernel(
    const uint4* __restrict__ stag_k, const uint4* __restrict__ stag_v,
    const uint4* host_k, const uint4* host_v, uint4* __restrict__ out_k,
    uint4* __restrict__ out_v, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ dev_map, long long nrows, int nb, int nd,
    int bs, int G, int qk, int row_vec) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= nrows) return;
  uint4* d = (blockIdx.y ? out_v : out_k) + (size_t)r * row_vec;
  const int row = rows[r];
  if (row < 0) {
    for (int v = lane; v < row_vec; v += 32) d[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int g = (int)((r / qk) % G);
  const int phys = repro::clampi(row, 0, nb * bs - 1);
  const int s = dev_map[phys / bs];
  if (s >= 0) {
    const size_t src_row =
        ((size_t)repro::clampi(s, 0, nd - 1) * bs + phys % bs) * G + g;
    const uint4* src = (blockIdx.y ? stag_v : stag_k) + src_row * row_vec;
    for (int v = lane; v < row_vec; v += 32) d[v] = src[v];
  } else {
    const uint4* src =
        (blockIdx.y ? host_v : host_k) + ((size_t)phys * G + g) * row_vec;
    for (int v = lane; v < row_vec; v += 32) d[v] = __ldcv(src + v);
  }
}

}  // namespace

REPRO_EXPORT int gather_rows_tiered_launch(
    const void* stag_k, const void* stag_v, const void* host_k,
    const void* host_v, void* out_k, void* out_v, const void* rows,
    const void* dev_map, long long nrows, int nb, int nd, int bs, int G,
    int qk, int row_vec, int nkv, cudaStream_t stream) {
  if (nrows == 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 rows per block
  const long long blocks = (nrows * 32 + threads - 1) / threads;
  dim3 grid((unsigned)blocks, nkv);
  gather_rows_tiered_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const uint4*>(stag_k), static_cast<const uint4*>(stag_v),
      static_cast<const uint4*>(host_k), static_cast<const uint4*>(host_v),
      static_cast<uint4*>(out_k), static_cast<uint4*>(out_v),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(dev_map),
      nrows, nb, nd, bs, G, qk, row_vec);
  return (int)cudaGetLastError();
}
