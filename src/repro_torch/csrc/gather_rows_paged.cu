// Block-table-indirect K/V row gather from the paged pool.
//
// Replaces the TPU kernel repro/kernels/gather_kv/gather_kv.py
// (_gather_rows_paged_pallas / _paged_kernel, reached through
// repro/kernels/gather_kv/ops.py:gather_kv_paged_kernel), which DMAs one
// (1, 1, d) row per grid step: out[i] = pool[bt[idx[i] // bs], idx[i] % bs].
//
// Two addressing modes serve every K/V gather on the decode path:
//   mode 0 (logical): pool (nb, bs, G, hd), block_tables (b, nblk),
//     idx (b, L) logical positions -> out (b, L, G, hd). Sink and window.
//     Table entries < 0 clip to block 0, as core/cache.py does.
//   mode 1 (physical, per kv head): idx (b, G, Q, k) flat pool rows ->
//     out (b, G, Q, k, hd) with out[i,g,q,j] = pool_row[idx[i,g,q,j]][g].
//     The Stage-II winners.
// K and V share one launch (blockIdx.y picks the tensor); the element type
// does not matter to a copy, so rows move as 16-byte vectors of any dtype.
//
// Bound on the H100: bytes — each output row is read once from the pool
// and written once; the indices and table entries are a few bytes per row.
// One layer's decode step (b=4: 128 sink + 768 window rows of G*hd bf16,
// and 4*2*6*100 winner head rows, K and V) moves about 12.3 MB: 3.7 us at
// the H100's 3.35 TB/s.
//
// Design: one warp per output row; its lanes copy the row's 16-byte
// vectors (a 256-byte bf16 head row is 16 vectors, a 512-byte two-head row
// 32), so each warp issues one coalesced transaction per row. Both the
// indices and the block table are read inside the kernel.
#include "common.cuh"

namespace {

__global__ void gather_rows_paged_kernel(
    const uint4* __restrict__ pool_k, const uint4* __restrict__ pool_v,
    uint4* __restrict__ out_k, uint4* __restrict__ out_v,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ block_tables,
    int mode, long long rows, int L, int nblk, int nb, int bs, int G, int qk,
    int row_vec) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const uint4* src = blockIdx.y ? pool_v : pool_k;
  uint4* dst = blockIdx.y ? out_v : out_k;
  size_t src_row;
  if (mode == 0) {
    const long long bi = r / L;
    const int p = idx[r];
    const int lb = repro::clampi(p / bs, 0, nblk - 1);
    const int blk = repro::clampi(block_tables[bi * nblk + lb], 0, nb - 1);
    src_row = (size_t)blk * bs + p % bs;
  } else {
    const int g = (int)((r / qk) % G);
    const int phys = repro::clampi(idx[r], 0, nb * bs - 1);
    src_row = (size_t)phys * G + g;
  }
  const uint4* s = src + src_row * row_vec;
  uint4* d = dst + (size_t)r * row_vec;
  for (int v = lane; v < row_vec; v += 32) d[v] = s[v];
}

}  // namespace

REPRO_EXPORT int gather_rows_paged_launch(
    const void* pool_k, const void* pool_v, void* out_k, void* out_v,
    const void* idx, const void* block_tables, int mode, long long rows,
    int L, int nblk, int nb, int bs, int G, int qk, int row_vec, int nkv,
    cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 rows per block
  const long long blocks = (rows * 32 + threads - 1) / threads;
  dim3 grid((unsigned)blocks, nkv);
  gather_rows_paged_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const uint4*>(pool_k), static_cast<const uint4*>(pool_v),
      static_cast<uint4*>(out_k), static_cast<uint4*>(out_v),
      static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(block_tables), mode, rows, L, nblk, nb, bs,
      G, qk, row_vec);
  return (int)cudaGetLastError();
}
