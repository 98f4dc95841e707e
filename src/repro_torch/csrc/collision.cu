// Stage-I collision scores over a contiguous metadata store.
//
// Replaces the TPU kernel repro/kernels/collision/collision.py
// (_collision_pallas / _kernel, reached through
// repro/kernels/collision/ops.py:collision_scores_kernel), which scores one
// (n, B) id stream against one (B, 2^m) tier table, padding n to its block.
//
// Computes the same function for every stream of a batch at once. For row
// r = (b, g) of the contiguous cache's meta_ids (b, G, n, B), query head h
// and position p:
//     S[r,h,p] = sum_s table[r,h,s, ids[r,p,s]]   for p in [sink, enc_end[b])
// and -1 elsewhere, the mask that core/retrieval.py's valid region applies.
// Any n is taken (no padding), B is 8 or 16.
//
// Bound on the H100: bytes. Per call it must read each valid key's B uint8
// ids once and each (r,h) tier table (B*2^m int32) once, and write the
// (b,G,Hg,n) int32 scores. At the decode path's shapes (b=4, G=2, Hg=6,
// n=16384, B=16) that is about 2.1 MB of ids, 0.8 MB of tables and 3.1 MB of
// scores: 1.8 us at 3.35 TB/s. The B integer adds per key and query head are
// far below the card's rate.
//
// Design: one thread block per row r, range of keys_per_block positions and
// group of query heads. The block stages its heads' tier tables in shared
// memory (96 KB for six heads at B=16, 2^m=256), the lookups the TPU kernel
// turns into one-hot products. Each thread reads one key's ids with a single
// 16-byte load (8-byte at B=8) and reuses them for every query head of the
// group, so the ids are read once per kv head. Masked positions read
// nothing, and a block whose range lies wholly outside the region loads no
// table. Consecutive threads write consecutive scores of one head.
#include "common.cuh"

namespace {

template <int B>
__device__ __forceinline__ void load_ids(const uint8_t* __restrict__ ids,
                                         uint8_t (&v)[B]) {
  if constexpr (B == 16) {
    uint4 w = *reinterpret_cast<const uint4*>(ids);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = bytes[i];
  } else {
    uint2 w = *reinterpret_cast<const uint2*>(ids);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = bytes[i];
  }
}

template <int B>
__global__ void collision_kernel(const uint8_t* __restrict__ ids,
                                 const int32_t* __restrict__ tables,
                                 const int32_t* __restrict__ enc_end,
                                 int32_t* __restrict__ out, int G, int Hg,
                                 int n, int nc, int sink, int keys_per_block,
                                 int heads_per_block) {
  extern __shared__ int32_t tab[];  // (heads_per_block, B, nc)
  const int row = blockIdx.y;       // (b, g) flattened
  const int bi = row / G;
  const int h0 = blockIdx.z * heads_per_block;
  const int nh = min(heads_per_block, Hg - h0);
  const int e = min(enc_end[bi], n);
  const int start = blockIdx.x * keys_per_block;
  const int stop = min(start + keys_per_block, n);
  int32_t* orow = out + ((size_t)row * Hg + h0) * n;

  if (stop <= sink || start >= e) {  // wholly masked: no table needed
    for (int p = start + threadIdx.x; p < stop; p += blockDim.x)
      for (int h = 0; h < nh; ++h) orow[(size_t)h * n + p] = -1;
    return;
  }
  // 16-byte loads, several in flight per thread: a one-int loop here is
  // latency-bound (16 KB per head) and dominated the first version's time
  const int4* trow = reinterpret_cast<const int4*>(
      tables + ((size_t)row * Hg + h0) * B * nc);
  int4* tab4 = reinterpret_cast<int4*>(tab);
  const int n4 = nh * B * nc / 4;
#pragma unroll 8
  for (int i = threadIdx.x; i < n4; i += blockDim.x) tab4[i] = trow[i];
  __syncthreads();

  const uint8_t* irow = ids + (size_t)row * n * B;
  for (int p = start + threadIdx.x; p < stop; p += blockDim.x) {
    if (p >= sink && p < e) {
      uint8_t v[B];
      load_ids<B>(irow + (size_t)p * B, v);
      for (int h = 0; h < nh; ++h) {
        const int32_t* t = tab + h * B * nc;
        int s = 0;
#pragma unroll
        for (int i = 0; i < B; ++i) s += t[i * nc + v[i]];
        orow[(size_t)h * n + p] = s;
      }
    } else {
      for (int h = 0; h < nh; ++h) orow[(size_t)h * n + p] = -1;
    }
  }
}

}  // namespace

REPRO_EXPORT int collision_launch(const void* ids, const void* tables,
                                  const void* enc_end, void* out, int rows,
                                  int G, int Hg, int n, int B, int nc,
                                  int sink, cudaStream_t stream) {
  if (n == 0 || rows == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int keys_per_block = 1024;
  const size_t table_bytes = (size_t)B * nc * sizeof(int32_t);
  const size_t smem_cap = 200 * 1024;
  if (table_bytes > smem_cap || nc % 4) return (int)cudaErrorInvalidValue;
  const int fit = (int)(smem_cap / table_bytes);
  const int heads_per_block = Hg < fit ? Hg : fit;
  const size_t smem = table_bytes * heads_per_block;
  dim3 grid((n + keys_per_block - 1) / keys_per_block, rows,
            (Hg + heads_per_block - 1) / heads_per_block);
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const uint8_t*>(ids), static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(enc_end), static_cast<int32_t*>(out), G,
        Hg, n, nc, sink, keys_per_block, heads_per_block);
  };
  if (B == 16) {
    run(collision_kernel<16>);
  } else if (B == 8) {
    run(collision_kernel<8>);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
