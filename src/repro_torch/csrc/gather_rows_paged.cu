// Block-table-indirect K/V row gather from the paged pool: one launch per
// decode layer-step moves the sink rows, the window rows and the Stage-II
// winners' head rows, K and V together.
//
// Replaces the TPU kernel repro/kernels/gather_kv/gather_kv.py
// (_gather_rows_paged_pallas / _paged_kernel, reached through
// repro/kernels/gather_kv/ops.py:gather_kv_paged_kernel), which DMAs one
// (1, 1, d) row per grid step: out[i] = pool[bt[idx[i] // bs], idx[i] % bs],
// and its contiguous twin (_gather_rows_pallas, through gather_kv_kernel):
// a contiguous store (b, n, G, hd) is a pool of b blocks of size n with the
// block table arange(b)[:, None] (kernels/__init__.py:row_tables), so the
// slot path's decode and promotion gathers run here too. Positions must lie
// in [0, nblk * bs): the contiguous callers clamp their window start.
//
// Two parts, each optional, in one flat index space:
//   dense rows: out (b, L, G, hd) with out[i, l] = pool row of position p
//     through row i's block table (the block clipped to [0, nblk), table
//     entries < 0 to block 0, as core/cache.py does). p is lidx[i, l] when
//     an index array is given (promotion), else computed here from the
//     window start: p = l for l < sink, ws[i] + l - sink after it (decode:
//     the sink rows, then the window rows).
//   winner head rows: phys (b, G, Q, k) flat pool rows -> out
//     (b, G, Q, k, hd) with out[i,g,q,j] = head g of pool row
//     phys[i,g,q,j] (the Stage-II winners).
// K and V share the launch (nkv = 2); the element type does not matter to a
// copy, so rows move as 16-byte vectors of any dtype.
//
// Rank-masked mode (row_count > 0), for one rank of a sequence-sharded
// contiguous cache that holds the global positions [row_base, row_base +
// row_count): every position, dense or winner, is a global logical
// position. A position the rank owns is read at position - row_base through
// the block table (the winners too: phys then holds positions, (b, G, Q,
// k)); one it does not own is written as zeros, in the same launch, so that
// a sum over the ranks yields every row exactly once.
//
// Bound on the H100: bytes - each output row is read once from the pool
// and written once; the indices and table entries are a few bytes per row.
// One layer's decode step (b=4: 128 sink + 768 window rows of G*hd bf16,
// and 4*2*6*100 winner head rows, K and V) moves about 12.3 MB: 3.7 us at
// the H100's 3.35 TB/s.
//
// Design: work is split by 16-byte vectors, not by rows, so a 256-byte head
// row takes 16 lanes and a 512-byte two-head row 32, and no lane idles.
// Each thread takes kVec vectors a grid stride apart (neighbouring threads
// on neighbouring vectors), resolves each one's source through the window
// start or index, the block table or the winner's row, and issues all its
// loads before any store: kVec 16-byte vectors in flight per thread.
#include "common.cuh"

namespace {

constexpr int kVec = 4;
constexpr int kThreads = 256;

// The position a rank-masked vector reads, local to the rank's store, or -1
// when the rank does not own it.
__device__ __forceinline__ int owned(int p, int row_base, int row_count) {
  return p >= row_base && p < row_base + row_count ? p - row_base : -1;
}

// kMasked: the rank-masked mode, an instantiation of its own so that the
// unmasked mode keeps its code.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads) gather_rows_paged_kernel(
    const uint4* __restrict__ pool_k, const uint4* __restrict__ pool_v,
    uint4* __restrict__ dense_k, uint4* __restrict__ dense_v,
    uint4* __restrict__ ret_k, uint4* __restrict__ ret_v,
    const int32_t* __restrict__ lidx, const int32_t* __restrict__ wstart,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ phys, long long n_dense, long long n_ret,
    int L, int sink, int nblk, int nb, int bs, int G, int qk, int head_vec,
    int nkv, int row_base, int row_count) {
  const long long per_kv = n_dense + n_ret;
  const long long total = per_kv * nkv;
  const long long S = (long long)gridDim.x * blockDim.x;
  const long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int row_vec = G * head_vec;
  uint4 val[kVec];
  uint4* dst[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const long long v = v0 + i * S;
    dst[i] = nullptr;
    if (v >= total) continue;
    const bool is_v = v >= per_kv;
    long long w = is_v ? v - per_kv : v;
    const uint4* src = is_v ? pool_v : pool_k;
    size_t at;
    if (w < n_dense) {
      const long long r = w / row_vec;
      const int vi = (int)(w - r * row_vec);
      const int bi = (int)(r / L), l = (int)(r - (long long)bi * L);
      int p = lidx ? lidx[r] : (l < sink ? l : wstart[bi] + l - sink);
      dst[i] = (is_v ? dense_v : dense_k) + w;
      if constexpr (kMasked) {
        p = owned(p, row_base, row_count);
        if (p < 0) {
          val[i] = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
      }
      const int lb = repro::clampi(p / bs, 0, nblk - 1);
      const int blk =
          repro::clampi(block_tables[(size_t)bi * nblk + lb], 0, nb - 1);
      at = ((size_t)blk * bs + p % bs) * row_vec + vi;
    } else {
      w -= n_dense;
      const long long hr = w / head_vec;
      const int vi = (int)(w - hr * head_vec);
      const int g = (int)((hr / qk) % G);
      dst[i] = (is_v ? ret_v : ret_k) + w;
      int row;
      if constexpr (kMasked) {  // a global position through the table
        const int bi = (int)(hr / ((long long)qk * G));
        const int p = owned(phys[hr], row_base, row_count);
        if (p < 0) {
          val[i] = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
        const int lb = repro::clampi(p / bs, 0, nblk - 1);
        row = repro::clampi(block_tables[(size_t)bi * nblk + lb], 0,
                            nb - 1) * bs + p % bs;
      } else {                  // a flat physical pool row
        row = repro::clampi(phys[hr], 0, nb * bs - 1);
      }
      at = ((size_t)row * G + g) * head_vec + vi;
    }
    val[i] = src[at];
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (dst[i]) *dst[i] = val[i];
}

}  // namespace

REPRO_EXPORT int gather_rows_paged_launch(
    const void* pool_k, const void* pool_v, void* dense_k, void* dense_v,
    void* ret_k, void* ret_v, const void* lidx, const void* wstart,
    const void* block_tables, const void* phys, long long n_dense,
    long long n_ret, int L, int sink, int nblk, int nb, int bs, int G,
    int qk, int head_vec, int nkv, int row_base, int row_count,
    cudaStream_t stream) {
  const long long total = (n_dense + n_ret) * nkv;
  if (total == 0) return (int)cudaGetLastError();
  const long long blocks =
      (total + (long long)kThreads * kVec - 1) / ((long long)kThreads * kVec);
  auto kernel = row_count > 0 ? gather_rows_paged_kernel<true>
                               : gather_rows_paged_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(pool_k), static_cast<const uint4*>(pool_v),
      static_cast<uint4*>(dense_k), static_cast<uint4*>(dense_v),
      static_cast<uint4*>(ret_k), static_cast<uint4*>(ret_v),
      static_cast<const int32_t*>(lidx), static_cast<const int32_t*>(wstart),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(phys), n_dense, n_ret, L, sink, nblk, nb,
      bs, G, qk, head_vec, nkv, row_base, row_count);
  return (int)cudaGetLastError();
}
