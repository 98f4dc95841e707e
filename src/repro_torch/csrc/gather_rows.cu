// K/V row gather from the contiguous per-slot store.
//
// Replaces the TPU kernel repro/kernels/gather_kv/gather_kv.py
// (_gather_rows_pallas / _kernel, reached through
// repro/kernels/gather_kv/ops.py:gather_kv_kernel), which DMAs one selected
// (1, d) row of an (n, d) store per grid step: out[i] = store[idx[i]].
//
// Two addressing modes serve every contiguous K/V gather of a decode step,
// over a store (b, n, G, hd) whose batch row i owns positions [i*n, i*n+n):
//   mode 0 (per kv head): idx (b, G, Q, k) -> out (b, G, Q, k, hd) with
//     out[i,g,q,j] = store[i, idx[i,g,q,j], g]. The Stage-II winners
//     (core/attention.py:sparse_decode_attention; the reference's
//     gather_kv_heads).
//   mode 1 (per row): idx (b, L) -> out (b, L, G, hd) with
//     out[i,l] = store[i, idx[i,l]]. The local window, the promoted key
//     blocks, and the reference's batched contract gather_kv_kernel
//     (store (R, n, d), idx (R, k)) with G = 1.
// Indices clip to [0, n), as the plain version does. K and V share one
// launch (blockIdx.y picks the tensor); the element type does not matter to
// a copy, so rows move as 16-byte vectors of any dtype.
//
// Bound on the H100: bytes. Each output row is read once and written once;
// the indices are 4 bytes per row. One layer's decode step at b=4 (the
// 4*2*6*100 winner head rows of 128 bf16 and a 768-row window of 2*128
// bf16, K and V) moves about 11 MB: 3.4 us at 3.35 TB/s.
//
// Design: one warp per output row; its lanes copy the row's 16-byte vectors
// (16 for a 256-byte head row, 32 for a 512-byte two-head row), so a row is
// one coalesced transaction.
#include "common.cuh"

namespace {

__global__ void gather_rows_kernel(const uint4* __restrict__ store_k,
                                   const uint4* __restrict__ store_v,
                                   uint4* __restrict__ out_k,
                                   uint4* __restrict__ out_v,
                                   const int32_t* __restrict__ idx, int mode,
                                   long long rows, int n, int G, int qk,
                                   int row_vec) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const uint4* src = blockIdx.y ? store_v : store_k;
  uint4* dst = blockIdx.y ? out_v : out_k;
  const int p = repro::clampi(idx[r], 0, n - 1);
  size_t src_row;
  if (mode == 0) {
    const long long bi = r / ((long long)G * qk);
    const int g = (int)((r / qk) % G);
    src_row = ((size_t)bi * n + p) * G + g;
  } else {
    const long long bi = r / qk;
    src_row = (size_t)bi * n + p;
  }
  const uint4* s = src + src_row * row_vec;
  uint4* d = dst + (size_t)r * row_vec;
  for (int v = lane; v < row_vec; v += 32) d[v] = s[v];
}

}  // namespace

REPRO_EXPORT int gather_rows_launch(const void* store_k, const void* store_v,
                                    void* out_k, void* out_v, const void* idx,
                                    int mode, long long rows, int n, int G,
                                    int qk, int row_vec, int nkv,
                                    cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 rows per block
  const long long blocks = (rows * 32 + threads - 1) / threads;
  dim3 grid((unsigned)blocks, nkv);
  gather_rows_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const uint4*>(store_k), static_cast<const uint4*>(store_v),
      static_cast<uint4*>(out_k), static_cast<uint4*>(out_v),
      static_cast<const int32_t*>(idx), mode, rows, n, G, qk, row_vec);
  return (int)cudaGetLastError();
}
