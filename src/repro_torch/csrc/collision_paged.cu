// Stage-I collision scores over the paged metadata pool, with the score
// histogram of every segment of kSegLen positions for the top-C cut.
//
// Replaces the TPU kernel repro/kernels/collision/collision.py
// (_collision_paged_pallas / _paged_kernel, reached through
// repro/kernels/collision/ops.py:collision_scores_paged_kernel), and its
// contiguous twin (_collision_pallas, through collision_scores_kernel): a
// contiguous store (b, G, n, B) is a pool of b blocks of size n with the
// block table arange(b)[:, None] (kernels/__init__.py:row_tables).
//
// Computes, for each batch row b, kv head g, query head h and logical
// position p:
//     S[b,g,h,p] = sum_s table[b,g,h,s, ids[bt[b][p/bs], g, p%bs, s]]
// for p in [sink, enc_end[b]), and -1 elsewhere. Block-table entries < 0
// are clipped to block 0 (their positions lie past enc_end and are masked).
// Beside the scores it writes seg_hist[b,g,h,j,v] = #{p in segment j :
// S[b,g,h,p] + 1 == v} for v < rng = score_range + 2: the histograms
// bucket_topk.cu reads instead of the scores to find its threshold.
//
// Bound on the H100: bytes. Per call the kernel must read each valid key's
// B uint8 ids once per kv head, the Hg used bytes of each (b,g) tier
// table's words once (b*G*Hg*B*nc bytes), and the block tables, and write
// the (b,G,Hg,n) int32 scores and the (b,G,Hg,n/kSegLen,rng) int32
// histograms. At the decode path's shapes (b=4, G=2, Hg=6, n=16384, B=16,
// 27,440 valid keys per kv head, rng=98) that is 5,426,704 bytes, most of
// it the scores over the full logical width and the histograms: 1.62 us at
// 3.35 TB/s. The integer work (B adds per key and kv head) is far below
// the card's rate.
//
// What held the first version (one block per (b,g,h) row and 2,048 keys,
// a 16 KB int32 table staged with one 4-byte load per iteration) back, and
// what this design does about it:
//   * Tables staged by latency-bound 4-byte loads, in every block, also in
//     key ranges wholly outside [sink, enc_end): a block now covers one
//     (b, g) and one segment of kSegLen keys for all Hg query heads. A
//     segment with no valid key stages nothing: it writes -1 and its
//     histogram in closed form (all its positions in bin 0). A valid
//     segment copies the (b, g) table into shared memory with 16-byte
//     cp.async copies, 8 in flight per thread, while its threads load
//     their keys' ids (one 16-byte load each).
//   * Ids and block-table entries read once per query head: now once per
//     kv head.
//   * Hg x B random 4-byte shared-memory lookups per key: tier weights lie
//     in {0..6} and B x 6 = 96 < 256, so one 8-byte word per (subspace,
//     centroid) holds the weights of up to 8 query heads, one byte lane
//     each (32 KB for B=16, 2^m=256). One 8-byte lookup per subspace
//     serves every head and plain 64-bit adds sum all heads at once: no
//     lane carries into the next while B x max weight < 256, which the
//     wrapper checks (score_range < 256). The caller emits the table in
//     this layout (kernels/collision/ops.py:lane_packed_table), so staging
//     is a plain copy: packing it here cost a byte transpose per word and
//     16-way bank conflicts on its stores.
//   * The histogram costs no pass over the scores: each valid score is
//     counted where it is computed with a shared-memory atomic; masked
//     positions are counted in closed form and cost none.
// At the decode shapes 222 of the 512 blocks hold valid keys (kSegLen 256
// makes at least 132, one per SM).
#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <int B>
__global__ void __launch_bounds__(repro::kSegLen)
collision_paged_kernel(const uint8_t* __restrict__ pool_ids,
                       const int32_t* __restrict__ block_tables,
                       const uint64_t* __restrict__ tables,
                       const int32_t* __restrict__ enc_end,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ seg_hist, int nb, int G, int Hg,
                       int bs, int nblk, int nc, int sink, int rng) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* tab = reinterpret_cast<uint64_t*>(smem);            // (B, nc)
  int* hist = reinterpret_cast<int*>(tab + B * nc);              // (Hg, rng)

  constexpr int L = repro::kSegLen;
  const int j = blockIdx.x;             // segment
  const int bg = blockIdx.y;            // (b, g) flattened
  const int g = bg % G;
  const int bi = bg / G;
  const int n = nblk * bs;
  const int nseg = gridDim.x;
  const int tid = threadIdx.x;

  const int lo = j * L, hi = min(lo + L, n);
  const int e = enc_end[bi];
  const int vlo = max(lo, sink), vhi = min(hi, e);
  const int nvalid = max(vhi - vlo, 0);
  const int nmasked = (hi - lo) - nvalid;
  int32_t* orow = out + (size_t)bg * Hg * n;                  // head 0's row
  int32_t* hrow = seg_hist + ((size_t)bg * Hg * nseg + j) * rng;
  const size_t hstride = (size_t)nseg * rng;                  // per head

  const int p = lo + tid;
  const int entry = p < hi ? block_tables[(size_t)bi * nblk + p / bs] : 0;
  if (nvalid == 0) {                    // wholly masked: closed form
    if (p < hi)
      for (int h = 0; h < Hg; ++h) orow[(size_t)h * n + p] = -1;
    for (int i = tid; i < Hg * rng; i += L) {
      const int h = i / rng, v = i % rng;
      hrow[h * hstride + v] = v == 0 ? nmasked : 0;
    }
    return;
  }

  // the (b, g) table (B x nc words) into shared memory, 16 bytes a copy,
  // in flight while this thread loads its key's ids
  const uint64_t* tsrc = tables + (size_t)bg * B * nc;
  for (int c = tid; c < B * nc / 2; c += L)
    cp_async16(tab + 2 * c, tsrc + 2 * c);
  const bool valid = p >= vlo && p < vhi;
  repro::KeyIds<B> ids{};
  if (valid) {
    const int blk = repro::clampi(entry, 0, nb - 1);
    ids.load(pool_ids + (((size_t)blk * G + g) * bs + (p % bs)) * B);
  }
  for (int i = tid; i < Hg * rng; i += L) hist[i] = 0;
  cp_async_wait_all();
  __syncthreads();

  uint64_t sum = 0;
  if (valid) {
#pragma unroll
    for (int s = 0; s < B; ++s) sum += tab[s * nc + ids[s]];
  }
  for (int h = 0; h < Hg; ++h) {
    const int sc = valid ? (int)((sum >> (8 * h)) & 0xFFu) : -1;
    if (p < hi) orow[(size_t)h * n + p] = sc;
    // masked positions are counted below in closed form
    if (valid && sc + 1 < rng) atomicAdd(&hist[h * rng + sc + 1], 1);
  }
  __syncthreads();
  for (int i = tid; i < Hg * rng; i += L) {
    const int h = i / rng, v = i % rng;
    hrow[h * hstride + v] = hist[i] + (v == 0 ? nmasked : 0);
  }
}

}  // namespace

REPRO_EXPORT int collision_paged_launch(const void* pool_ids,
                                        const void* block_tables,
                                        const void* tables,
                                        const void* enc_end, void* out,
                                        void* seg_hist, int nb, int G, int Hg,
                                        int bs, int nblk, int B, int nc,
                                        int sink, int b, int rng, int seg_len,
                                        cudaStream_t stream) {
  if (seg_len != repro::kSegLen || Hg < 1 || Hg > 8 || nc % 16 ||
      rng < 2 || rng > 257)
    return (int)cudaErrorInvalidValue;
  const int n = nblk * bs;
  dim3 grid((n + repro::kSegLen - 1) / repro::kSegLen, b * G);
  const size_t smem = (size_t)B * nc * sizeof(uint64_t) +
                      (size_t)Hg * rng * sizeof(int);
  auto run = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, repro::kSegLen, smem, stream>>>(
        static_cast<const uint8_t*>(pool_ids),
        static_cast<const int32_t*>(block_tables),
        static_cast<const uint64_t*>(tables),
        static_cast<const int32_t*>(enc_end), static_cast<int32_t*>(out),
        static_cast<int32_t*>(seg_hist), nb, G, Hg, bs, nblk, nc, sink, rng);
    return (int)cudaGetLastError();
  };
  if (B == 16) return run(collision_paged_kernel<16>);
  if (B == 8) return run(collision_paged_kernel<8>);
  return (int)cudaErrorInvalidValue;
}
