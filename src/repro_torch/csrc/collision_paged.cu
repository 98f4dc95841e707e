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
//     each (32 KB for B=16, 64 KB for B=32, 2^m=256; above 48 KB the
//     launcher opts in, and three blocks of B=32 still fit an SM's 228 KB:
//     3 x (64 KB + Hg x rng ints + 1 KB reserved)). One 8-byte lookup per
//     subspace
//     serves every head and plain 64-bit adds sum all heads at once: no
//     lane carries into the next while B x max weight < 256, which the
//     wrapper checks (score_range < 256; 32 x 6 = 192 at B=32). The caller emits the table in
//     this layout (kernels/collision/ops.py:lane_packed_table), so staging
//     is a plain copy: packing it here cost a byte transpose per word and
//     16-way bank conflicts on its stores.
//   * The histogram costs no pass over the scores: each valid score is
//     counted where it is computed with a shared-memory atomic; masked
//     positions are counted in closed form and cost none.
// At the decode shapes 222 of the 512 blocks hold valid keys (kSegLen 256
// makes at least 132, one per SM).
//
// Wide mode (lanes = 16): more query heads or a larger
// score range than one byte lane per head in one 8-byte word can hold --
// deepseek-v2-lite's MLA, where all Hg = 16 query heads share one latent
// of 576 (B = 128 subspaces, scores up to 6 x 128 = 768). The table lies as
// 16 byte lanes a (subspace, centroid) entry, one 16-byte word (head h in
// byte h, Hg <= 16; kernels/collision/ops.py:lane_packed_table(lanes=16)):
// 512 KB a (b, g) at B = 128, past a block's shared memory. So:
//   * the table is staged kTile = 16 subspaces at a time (64 KB at 2^m =
//     256), double-buffered through cp.async: the next tile's copies are in
//     flight while the current tile is summed;
//   * within a tile the byte lanes sum without carries (16 x 6 = 96 < 256);
//     after each tile each word's 8 lanes spread into 16-bit lanes of two
//     accumulators (16 heads: four 64-bit words), which hold any sum below
//     65,536;
//   * a block covers one segment of kSegLen keys, one key a thread, as in
//     the 8-lane mode, so each block stages the whole table once (512 KB
//     from L2 at B = 128). Blocks covering 2 or 4 segments stage it once
//     for 512 or 1,024 keys, but leave SMs idle: at deepseek's decode
//     shapes they took 0.0343 and 0.0548 ms against one segment's 0.0276
//     (measured on an H100 80GB HBM3 at 700 W);
//   * once the table is no longer read its shared memory holds the
//     segment's (Hg, rng) histogram (49 KB at rng 770), counted with
//     shared-memory atomics.
// Bound at deepseek's decode shapes (b=4, G=1, Hg=16, n=16384, B=128,
// rng=770, 27,440 valid keys): ~3.5 MB of ids, 2 MB of tables, 4.2 MB of
// scores and 12.6 MB of seg_hist (three times the scores at rng 770):
// ~22 MB, ~6.7 us at 3.35 TB/s.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kTile = 16;       // subspaces of a staged table tile (wide)
constexpr int kWideLanes = 16;  // byte lanes of a wide table entry

// The 4 bytes of x in the 16-bit lanes of a 64-bit word, byte i in lane i.
__device__ __forceinline__ uint64_t spread16(uint32_t x) {
  uint64_t v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  return (v | (v << 8)) & 0x00FF00FF00FF00FFull;
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

// Wide mode: see the header. Grid (nseg, b * G), kSegLen threads, one
// key a thread.
__global__ void __launch_bounds__(repro::kSegLen)
collision_paged_kernel_wide(const uint8_t* __restrict__ pool_ids,
                            const int32_t* __restrict__ block_tables,
                            const uint4* __restrict__ tables,
                            const int32_t* __restrict__ enc_end,
                            int32_t* __restrict__ out,
                            int32_t* __restrict__ seg_hist, int nb, int G,
                            int Hg, int bs, int nblk, int B, int nc,
                            int sink, int rng) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tab = reinterpret_cast<uint4*>(smem);   // 2 x (kTile, nc) entries
  int* hist = reinterpret_cast<int*>(smem);      // (Hg, rng), after them

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

  if (nvalid == 0) {                    // wholly masked: closed form
    if (p < hi)
      for (int h = 0; h < Hg; ++h) orow[(size_t)h * n + p] = -1;
    for (int i = tid; i < Hg * rng; i += L) {
      const int h = i / rng, v = i % rng;
      hrow[h * hstride + v] = v == 0 ? nmasked : 0;
    }
    return;
  }

  const int tile_entries = kTile * nc;
  const uint4* tsrc = tables + (size_t)bg * B * nc;
  for (int c = tid; c < tile_entries; c += L) cp_async16(tab + c, tsrc + c);
  cp_async_commit();
  const bool valid = p >= vlo && p < vhi;
  const uint4* key = nullptr;
  if (valid) {
    const int blk = repro::clampi(block_tables[(size_t)bi * nblk + p / bs],
                                  0, nb - 1);
    key = reinterpret_cast<const uint4*>(
        pool_ids + (((size_t)blk * G + g) * bs + (p % bs)) * B);
  }
  uint64_t acc[4] = {0, 0, 0, 0};   // 16 heads in 16-bit lanes, 4 a word

  const int ntiles = B / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const uint4* cur = tab + (t & 1) * tile_entries;
    if (t + 1 < ntiles) {               // the next tile, while this one sums
      uint4* nxt = tab + ((t + 1) & 1) * tile_entries;
      const uint4* src = tsrc + (size_t)(t + 1) * tile_entries;
      for (int c = tid; c < tile_entries; c += L) cp_async16(nxt + c, src + c);
      cp_async_commit();
    }
    const uint4 ids = valid ? key[t] : make_uint4(0u, 0u, 0u, 0u);
    if (t + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                    // tile t staged by every thread
    if (valid) {
      const uint32_t w[4] = {ids.x, ids.y, ids.z, ids.w};
      uint64_t lo8 = 0, hi8 = 0;        // heads 0-7 and 8-15, byte lanes
#pragma unroll
      for (int ss = 0; ss < kTile; ++ss) {
        const uint32_t id = (w[ss >> 2] >> ((ss & 3) * 8)) & 0xFFu;
        const uint4 ent = cur[ss * nc + id];
        lo8 += ((uint64_t)ent.y << 32) | ent.x;
        hi8 += ((uint64_t)ent.w << 32) | ent.z;
      }
      acc[0] += spread16((uint32_t)lo8);
      acc[1] += spread16((uint32_t)(lo8 >> 32));
      acc[2] += spread16((uint32_t)hi8);
      acc[3] += spread16((uint32_t)(hi8 >> 32));
    }
    __syncthreads();                    // tile t's buffer may be refilled
  }

  // the table is no longer read: its memory holds the histogram
  for (int i = tid; i < Hg * rng; i += L) hist[i] = 0;
  __syncthreads();
  if (p < hi) {
#pragma unroll
    for (int h = 0; h < kWideLanes; ++h) {
      if (h >= Hg) break;
      const int sc =
          valid ? (int)((acc[h >> 2] >> (16 * (h & 3))) & 0xFFFFu) : -1;
      orow[(size_t)h * n + p] = sc;
      // masked positions are counted below in closed form
      if (valid && sc + 1 < rng) atomicAdd(&hist[h * rng + sc + 1], 1);
    }
  }
  __syncthreads();
  for (int i = tid; i < Hg * rng; i += L) {
    const int h = i / rng, v = i % rng;
    hrow[h * hstride + v] = hist[i] + (v == 0 ? nmasked : 0);
  }
}

// Wide mode (see the header): tables (b, G, B, nc) 16-byte entries, Hg <=
// 16, B a multiple of kTile, score range + 2 = rng <= 65,537.
int launch_wide(const void* pool_ids, const void* block_tables,
                const void* tables, const void* enc_end, void* out,
                void* seg_hist, int nb, int G, int Hg, int bs, int nblk,
                int B, int nc, int sink, int b, int rng, int seg_len,
                cudaStream_t stream) {
  if (seg_len != repro::kSegLen || Hg < 1 || Hg > kWideLanes || nc < 1 ||
      nc > 256 || B < kTile || B % kTile || rng < 2 || rng > 65537)
    return (int)cudaErrorInvalidValue;
  const int n = nblk * bs;
  dim3 grid((n + repro::kSegLen - 1) / repro::kSegLen, b * G);
  const size_t tiles = (size_t)2 * kTile * nc * sizeof(uint4);
  const size_t hist = (size_t)Hg * rng * sizeof(int);
  const size_t smem = tiles > hist ? tiles : hist;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        collision_paged_kernel_wide,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  collision_paged_kernel_wide<<<grid, repro::kSegLen, smem, stream>>>(
      static_cast<const uint8_t*>(pool_ids),
      static_cast<const int32_t*>(block_tables),
      static_cast<const uint4*>(tables),
      static_cast<const int32_t*>(enc_end), static_cast<int32_t*>(out),
      static_cast<int32_t*>(seg_hist), nb, G, Hg, bs, nblk, B, nc, sink, rng);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int collision_paged_launch(const void* pool_ids,
                                        const void* block_tables,
                                        const void* tables,
                                        const void* enc_end, void* out,
                                        void* seg_hist, int nb, int G, int Hg,
                                        int bs, int nblk, int B, int nc,
                                        int sink, int b, int rng, int seg_len,
                                        int lanes, cudaStream_t stream) {
  if (lanes == kWideLanes)
    return launch_wide(pool_ids, block_tables, tables, enc_end, out,
                       seg_hist, nb, G, Hg, bs, nblk, B, nc, sink, b, rng,
                       seg_len, stream);
  if (lanes != 8 || seg_len != repro::kSegLen || Hg < 1 || Hg > 8 ||
      nc % 16 || rng < 2 || rng > 257)
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
  if (B == 32) return run(collision_paged_kernel<32>);
  if (B == 16) return run(collision_paged_kernel<16>);
  if (B == 8) return run(collision_paged_kernel<8>);
  return (int)cudaErrorInvalidValue;
}
