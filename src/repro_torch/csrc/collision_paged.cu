// Stage-I collision scores over the paged metadata pool.
//
// Replaces the TPU kernel repro/kernels/collision/collision.py
// (_collision_paged_pallas / _paged_kernel, reached through
// repro/kernels/collision/ops.py:collision_scores_paged_kernel).
//
// Computes, for each batch row b, kv head g, query head h and logical
// position p:
//     S[b,g,h,p] = sum_s table[b,g,h,s, ids[bt[b][p/bs], g, p%bs, s]]
// for p in [sink, enc_end[b]), and -1 elsewhere. Block-table entries < 0
// are clipped to block 0 (their positions lie past enc_end and are masked).
//
// Bound on the H100: bytes. Per call the kernel must read each valid key's
// B uint8 ids once and each (b,g,h) tier table (B*2^m int32) once, and
// write the (b,G,Hg,n) int32 scores. At the decode path's shapes (b=4,
// G=2, Hg=6, n=16384, B=16, ~27k valid keys) that is about 4.8 MB, most
// of it the int32 output over the full logical width: 1.4 us at the
// H100's 3.35 TB/s. The ~B integer adds per key and query head are far
// below the card's rate.
//
// Design: one thread block per (b,g,h) row and range of keys_per_block
// logical positions. The block stages its 16 KB tier table in shared
// memory (the TPU's one-hot x row product is not needed: shared memory
// serves the lookups directly), then each thread reads one key's 16 ids
// with a single 16-byte load and sums 16 shared-memory lookups. Masked
// positions read nothing. Sharing one id tile across the Hg query heads
// is later work.
#include "common.cuh"

namespace {

template <int B>
__device__ __forceinline__ int score_key(const uint8_t* __restrict__ ids,
                                         const int32_t* __restrict__ tab,
                                         int nc) {
  uint8_t v[B];
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int c = 0; c < B / 16; ++c) {
      uint4 w = reinterpret_cast<const uint4*>(ids)[c];
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[c * 16 + i] = bytes[i];
    }
  } else if constexpr (B % 8 == 0) {
#pragma unroll
    for (int c = 0; c < B / 8; ++c) {
      uint2 w = reinterpret_cast<const uint2*>(ids)[c];
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[c * 8 + i] = bytes[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) v[i] = ids[i];
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < B; ++i) s += tab[i * nc + v[i]];
  return s;
}

template <int B>
__global__ void collision_paged_kernel(const uint8_t* __restrict__ pool_ids,
                                       const int32_t* __restrict__ block_tables,
                                       const int32_t* __restrict__ tables,
                                       const int32_t* __restrict__ enc_end,
                                       int32_t* __restrict__ out, int nb,
                                       int G, int Hg, int bs, int nblk,
                                       int nc, int sink, int keys_per_block) {
  extern __shared__ int32_t tab[];  // (B, nc)
  const int row = blockIdx.y;       // (b, g, h) flattened
  const int g = (row / Hg) % G;
  const int bi = row / (Hg * G);
  const int n = nblk * bs;

  const int32_t* trow = tables + (size_t)row * B * nc;
  for (int i = threadIdx.x; i < B * nc; i += blockDim.x) tab[i] = trow[i];
  __syncthreads();

  const int e = enc_end[bi];
  const int start = blockIdx.x * keys_per_block;
  const int stop = min(start + keys_per_block, n);
  const int32_t* bt = block_tables + (size_t)bi * nblk;
  int32_t* orow = out + (size_t)row * n;
  for (int p = start + threadIdx.x; p < stop; p += blockDim.x) {
    int s = -1;
    if (p >= sink && p < e) {
      const int blk = repro::clampi(bt[p / bs], 0, nb - 1);
      const uint8_t* ids =
          pool_ids + (((size_t)blk * G + g) * bs + (p % bs)) * B;
      s = score_key<B>(ids, tab, nc);
    }
    orow[p] = s;
  }
}

}  // namespace

REPRO_EXPORT int collision_paged_launch(const void* pool_ids,
                                        const void* block_tables,
                                        const void* tables,
                                        const void* enc_end, void* out,
                                        int nb, int G, int Hg, int bs,
                                        int nblk, int B, int nc, int sink,
                                        int b, cudaStream_t stream) {
  const int threads = 256;
  const int keys_per_block = 2048;
  const int n = nblk * bs;
  dim3 grid((n + keys_per_block - 1) / keys_per_block, b * G * Hg);
  const size_t smem = (size_t)B * nc * sizeof(int32_t);
  auto args = [&](auto kernel) {
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const uint8_t*>(pool_ids),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(enc_end), static_cast<int32_t*>(out),
        nb, G, Hg, bs, nblk, nc, sink, keys_per_block);
  };
  if (B == 16) {
    args(collision_paged_kernel<16>);
  } else if (B == 8) {
    args(collision_paged_kernel<8>);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
