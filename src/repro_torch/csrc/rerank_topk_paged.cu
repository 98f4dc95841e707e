// Stage-II RSQ-IP rerank of the Stage-I candidates with the final top-k,
// reading codes and weights through the block table inside the kernel.
//
// Replaces the TPU kernel repro/kernels/rerank/rerank.py (_rerank_pallas /
// _kernel, reached through repro/kernels/rerank/ops.py:
// rerank_paged_kernel), the jax.lax.top_k that follows it
// (repro/core/retrieval.py:retrieve_paged_fused and retrieve) and the two
// block-relative translations around it (_block_relative on the candidates
// and on the winners).
//
// For each row (b, g, h) and candidate slot c, with logical position
// p = cand[b,g,h,c] and physical row r = max(bt[b, p / bs], 0) * bs + p % bs:
//     est[c] = |q| * sum_s w[r,g,s] * sum_j v(code[r,g,s])_j * q_sub[b,g,h,s,j]
// where each 32-bit code packs 8 nibbles (bit `bits` = sign, the bits below
// it index a Lloyd-Max level), and est[c] = -1e30 (the JAX package's finite
// NEG_INF) where p is outside [sink, enc_end[b]). Then the top_k largest
// estimates in lax.top_k's order: descending by the float's total order
// (+0.0 above -0.0), ties to the lowest candidate slot. Outputs: est (all
// C), and per winner its estimate, logical position, physical row and
// physical block.
//
// Bound on the H100: bytes. Per valid candidate it must read B int32 codes
// and B float32 weights (128 bytes at B=16) from a random pool row, plus
// the candidate's index and table entry, and write its estimate; the
// winners' four outputs are small. At the decode path's shapes (48 rows of
// C=1311 candidates, all valid) that is about 8.8 MB: 2.6 us at the H100's
// 3.35 TB/s. The reads are random 64-byte pieces, and one SM decodes a
// row's 168K nibbles in thousands of cycles, so a row is split over
// `split` blocks.
//
// Design:
// - A cluster of `split` blocks per row (split = 1: one block). Every block
//   builds the row's decode table in shared memory, lut[s][j][nibble] =
//   +-level * q_sub[s][j] (B*8*16 floats, one load round trip), so a nibble
//   costs one lookup and one add, and the lanes of a warp hit one 16-float
//   segment (no bank conflicts).
// - Each thread owns the slots tid + j*split*T of its block's share. It
//   loads all its candidate indices, then all their block-table entries,
//   then the 16-byte code and weight vectors of two candidates at a time
//   before decoding them: three dependent round trips for C <= 2*split*T.
//   At B = 128 (MLA's latent, 1 KB of codes and weights a candidate) one
//   candidate's vectors come kChunk at a time, decoded before the next;
//   its decode table is 64 KB, the launch ~101 KB at C = 1311. The bound
//   at deepseek's decode shapes counts the distinct (row, position)
//   candidates: the 16 query heads of a row share one latent's metadata.
// - Each block stores its slots' order-preserving keys, physical rows and
//   positions in the leader block's shared memory (distributed shared
//   memory), then one cluster barrier hands them to the leader. The cluster
//   is entered with a split arrive/wait so the start barrier overlaps the
//   loads.
// - The leader histograms the keys' top 12 bits and scans the bins from
//   the top for the bucket where the count reaches k. Every key in or above
//   that bucket is gathered (warp ballots and one block scan give each its
//   place); when they are at most T, groups of threads rank each one by
//   counting the (key, slot) pairs above it, and write it if its rank is
//   below k. More than T keys sharing the threshold's top bits (ties) take
//   a radix select over all keys, 8 bits a pass, with the tie quota filled
//   in slot order, and a rank placement of the k selected. The block table
//   is not read again: the rows were kept.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSlots = 8;      // candidates a thread holds per tile
constexpr int kTopBits = 12;   // the first selection pass's key bits
constexpr int kBins = 1 << kTopBits;

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// A histogram bin's word: one pad word every 8 bins, so the 32 lanes that
// read 8 consecutive bins each hit 32 different banks.
__device__ __forceinline__ int bin_at(int bin) { return bin + (bin >> 3); }

// A (key, slot) pair that sorts descending by key, then ascending by slot.
__device__ __forceinline__ uint64_t pair_of(uint32_t key, int slot) {
  return ((uint64_t)key << 32) | (0xFFFFFFFFu - (uint32_t)slot);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t x,
                                                       int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The exclusive prefix, over the block's warps, of each warp's `total`
// (the same in every lane of a warp); one barrier.
__device__ __forceinline__ uint32_t warp_offset(uint32_t total,
                                                uint32_t* wtot, int lane,
                                                int warp, int nwarps) {
  if (lane == 0) wtot[warp] = total;
  __syncthreads();
  const uint32_t t = lane < nwarps ? wtot[lane] : 0u;
  const uint32_t incl = warp_inclusive_sum(t, lane);
  return __shfl_sync(0xffffffffu, incl - t, warp);
}

// Appends (key, slot) to the selected pairs where `take`, one atomic per
// warp (the tie path). Called by every lane of the warp.
__device__ __forceinline__ void select_pair(uint64_t* sel, uint32_t* count,
                                            bool take, uint32_t key,
                                            int slot, int lane) {
  const unsigned who = __ballot_sync(0xffffffffu, take);
  uint32_t at = 0;
  if (lane == 0 && who) at = atomicAdd(count, (uint32_t)__popc(who));
  at = __shfl_sync(0xffffffffu, at, 0) + __popc(who & ((1u << lane) - 1u));
  if (take) sel[at] = pair_of(key, slot);
}

// NV: 16-byte vectors per pool row (B / 4); PAIR: candidates whose codes
// and weights a thread holds in registers at once. Rows wider than
// kHeld vectors (B = 128, MLA's latent: 32 vectors of codes and 32 of
// weights a candidate, far past 255 registers) load and decode one
// candidate kChunk vectors at a time (4: no spill at 128 registers; 8
// spilled 48 bytes and 16 990, and ran 3 % and 53 % slower, measured on
// an H100 80GB HBM3 at 700 W).
constexpr int kHeld = 8;
constexpr int kChunk = 4;

template <int NV, int PAIR>
__global__ void __launch_bounds__(kMaxThreads) rerank_topk_paged_kernel(
    const int32_t* __restrict__ pool_codes, const float* __restrict__ pool_w,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ cand_idx, const float* __restrict__ q_sub,
    const float* __restrict__ q_norm, const float* __restrict__ levels,
    const int32_t* __restrict__ enc_end, float* __restrict__ est_out,
    float* __restrict__ top_est, int32_t* __restrict__ top_idx,
    int32_t* __restrict__ top_phys, int32_t* __restrict__ top_blk, int nb,
    int nblk, int G, int Hg, int bs, int C, int m, int bits, int sink,
    int top_k, int split) {
  constexpr int B = NV * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* sel = reinterpret_cast<uint64_t*>(smem);  // max(top_k, 512)
  float* lut = reinterpret_cast<float*>(sel + max(top_k, kMaxThreads));
  uint32_t* keys = reinterpret_cast<uint32_t*>(lut + B * 128);  // (C)
  int32_t* rows_s = reinterpret_cast<int32_t*>(keys + C);       // (C)
  int32_t* cand_s = rows_s + C;                                // (C)
  uint32_t* hist = reinterpret_cast<uint32_t*>(cand_s + C);  // (kBins*9/8)
  uint32_t* wtot = hist + kBins / 8 * 9;                       // (32)
  uint32_t* misc = wtot + 32;                                  // (4)

  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int row = blockIdx.x / split, rank = blockIdx.x % split;
  const int g = (row / Hg) % G, bi = row / (Hg * G);
  const size_t rowC = (size_t)row * C;
  const int end = enc_end[bi];
  const int nlev = 1 << bits;
  const int stride = split * T;

  uint32_t* keys_l = keys;
  int32_t* rows_l = rows_s;
  int32_t* cand_l = cand_s;
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    keys_l = cluster.map_shared_rank(keys, 0);
    rows_l = cluster.map_shared_rank(rows_s, 0);
    cand_l = cluster.map_shared_rank(cand_s, 0);
    cluster_arrive();   // matched by the wait before the first remote store
  }
  bool waited = split == 1;
  const float qn = q_norm[row];

  bool first = true;
  for (int tile = rank * T; tile < C; tile += stride * kSlots) {
    int ci[kSlots], pr[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = tile + tid + j * stride;
      ci[j] = s < C ? cand_idx[rowC + s] : 0;
    }
    if (first) {
      // the decode table, while the indices are in flight: each of B*8
      // threads loads one q_sub value and the levels (one round trip) and
      // writes its 16 entries; entries of nibbles j >= m are 0
      for (int sj = tid; sj < B * 8; sj += T) {
        const int j = sj & 7;
        float lv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) lv[i] = i < nlev ? levels[i] : 0.f;
        const float q =
            j < m ? q_sub[(size_t)row * B * m + (sj >> 3) * m + j] : 0.f;
#pragma unroll
        for (int nib = 0; nib < 16; ++nib) {
          const float p = lv[nib & (nlev - 1)] * q;
          lut[sj * 16 + nib] = (nib >> bits) & 1 ? p : -p;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = tile + tid + j * stride;
      pr[j] = 0;
      if (s < C) {
        const int lb = repro::clampi(ci[j] / bs, 0, nblk - 1);
        const int blk = max(block_tables[(size_t)bi * nblk + lb], 0);
        pr[j] = blk * bs + ci[j] % bs;
      }
    }
    if (first) {
      __syncthreads();   // the table is complete (uniform over the block)
      first = false;
    }
    if constexpr (NV > kHeld) {
      // wide rows: one candidate at a time, its codes and weights loaded
      // and decoded kChunk vectors a round
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (tile + j * stride >= C) break;   // uniform over the block
        const int s = tile + tid + j * stride;
        const bool ok = s < C && ci[j] >= sink && ci[j] < end;
        const int r = repro::clampi(pr[j], 0, nb * bs - 1);
        const size_t base = (((size_t)(r / bs) * G + g) * bs + r % bs) * B;
        const int4* c4 = reinterpret_cast<const int4*>(pool_codes + base);
        const float4* w4 = reinterpret_cast<const float4*>(pool_w + base);
        float acc = 0.f;
#pragma unroll 1
        for (int v0 = 0; v0 < NV; v0 += kChunk) {
          int4 cw[kChunk];
          float4 ww[kChunk];
          if (ok) {
#pragma unroll
            for (int v = 0; v < kChunk; ++v) {
              cw[v] = c4[v0 + v];
              ww[v] = w4[v0 + v];
            }
          }
          if (!waited) {
            cluster_wait();
            waited = true;
          }
          if (!ok) continue;
#pragma unroll
          for (int v = 0; v < kChunk; ++v) {
            const int words[4] = {cw[v].x, cw[v].y, cw[v].z, cw[v].w};
            const float wts[4] = {ww[v].x, ww[v].y, ww[v].z, ww[v].w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float* L = lut + ((v0 + v) * 4 + t) * 128;
              const uint32_t w = (uint32_t)words[t];
              float dot = 0.f;
#pragma unroll
              for (int q = 0; q < 8; ++q)
                dot += L[q * 16 + ((w >> (4 * q)) & 15)];
              acc += wts[t] * dot;
            }
          }
        }
        if (s >= C) continue;
        const float est = ok ? qn * acc : repro::kNegInf;
        est_out[rowC + s] = est;
        keys_l[s] = order_key(est);
        rows_l[s] = pr[j];
        cand_l[s] = ci[j];
      }
      continue;
    }
#pragma unroll
    for (int j0 = 0; j0 < kSlots; j0 += PAIR) {
      if (tile + j0 * stride >= C) break;   // uniform over the block
      int4 cw[PAIR][NV];
      float4 ww[PAIR][NV];
      bool ok[PAIR];
#pragma unroll
      for (int u = 0; u < PAIR; ++u) {
        const int j = j0 + u;
        const int s = tile + tid + j * stride;
        ok[u] = s < C && ci[j] >= sink && ci[j] < end;
        if (ok[u]) {
          const int r = repro::clampi(pr[j], 0, nb * bs - 1);
          const size_t base =
              (((size_t)(r / bs) * G + g) * bs + r % bs) * B;
          const int4* c4 = reinterpret_cast<const int4*>(pool_codes + base);
          const float4* w4 = reinterpret_cast<const float4*>(pool_w + base);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            cw[u][v] = c4[v];
            ww[u][v] = w4[v];
          }
        }
      }
      if (!waited) {
        cluster_wait();
        waited = true;
      }
#pragma unroll
      for (int u = 0; u < PAIR; ++u) {
        const int j = j0 + u;
        const int s = tile + tid + j * stride;
        if (s >= C) continue;
        float est = repro::kNegInf;
        if (ok[u]) {
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int words[4] = {cw[u][v].x, cw[u][v].y, cw[u][v].z,
                                  cw[u][v].w};
            const float wts[4] = {ww[u][v].x, ww[u][v].y, ww[u][v].z,
                                  ww[u][v].w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float* L = lut + (v * 4 + t) * 128;
              const uint32_t w = (uint32_t)words[t];
              float dot = 0.f;
#pragma unroll
              for (int q = 0; q < 8; ++q)
                dot += L[q * 16 + ((w >> (4 * q)) & 15)];
              acc += wts[t] * dot;
            }
          }
          est = qn * acc;
        }
        est_out[rowC + s] = est;
        keys_l[s] = order_key(est);
        rows_l[s] = pr[j];
        cand_l[s] = ci[j];
      }
    }
  }
  if (split > 1) {
    if (!waited) cluster_wait();
    cluster_arrive();   // the leader's keys are complete after this barrier
    cluster_wait();
    if (rank != 0) return;
  } else {
    __syncthreads();
  }

  const size_t out0 = (size_t)row * top_k;
  // a selected pair's winner: estimate, position, physical row and block
  auto write_winner = [&](uint64_t c, size_t at) {
    const int s = (int)(0xFFFFFFFFu - (uint32_t)c);
    const int p = rows_s[s];
    top_est[at] = key_value((uint32_t)(c >> 32));
    top_idx[at] = cand_s[s];
    top_phys[at] = p;
    top_blk[at] = p / bs;
  };

  // the threshold bucket: the highest bin of the keys' top kTopBits bits
  // where the count from the top reaches k
  for (int i = tid; i < kBins / 8 * 9; i += T) hist[i] = 0;
  __syncthreads();
  for (int s = tid; s < C; s += T)
    atomicAdd(&hist[bin_at(keys[s] >> (32 - kTopBits))], 1u);
  __syncthreads();
  {
    const int per = kBins / T;   // consecutive bins from the top, <= 16
    uint32_t c[16], sum = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      c[i] = i < per ? hist[bin_at(kBins - 1 - tid * per - i)] : 0u;
      sum += c[i];
    }
    const uint32_t incl = warp_inclusive_sum(sum, lane);
    uint32_t run = incl - sum +
                   warp_offset(__shfl_sync(0xffffffffu, incl, 31), wtot,
                               lane, warp, nwarps);
    if (run < (uint32_t)top_k && run + sum >= (uint32_t)top_k) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (run + c[i] >= (uint32_t)top_k) {
          misc[0] = kBins - 1 - tid * per - i;
          break;
        }
        run += c[i];
      }
    }
    __syncthreads();
  }
  // every key in or above it, each given its place by ballots and a scan
  const uint32_t tb = misc[0];
  uint32_t mine = 0;   // this warp's count
  for (int base = 0; base < C; base += T) {
    const int s = base + tid;
    mine += __popc(__ballot_sync(
        0xffffffffu, s < C && (keys[s] >> (32 - kTopBits)) >= tb));
  }
  const uint32_t at0 = warp_offset(mine, wtot, lane, warp, nwarps);
  if (warp == nwarps - 1 && lane == 0) misc[3] = at0 + mine;
  __syncthreads();
  const uint32_t total = misc[3];
  if (total <= (uint32_t)T) {
    uint32_t at = at0;
    for (int base = 0; base < C; base += T) {
      const int s = base + tid;
      const uint32_t k = s < C ? keys[s] : 0u;
      const bool take = s < C && (k >> (32 - kTopBits)) >= tb;
      const unsigned who = __ballot_sync(0xffffffffu, take);
      if (take) sel[at + __popc(who & ((1u << lane) - 1u))] = pair_of(k, s);
      at += __popc(who);
    }
    __syncthreads();
    // rank each gathered pair: tpe neighbouring threads (a power of two,
    // as many as the block holds) count the pairs above it, a share each
    uint32_t tpe = 1;
    while (tpe < 32 && tpe * 2 * total <= (uint32_t)T) tpe *= 2;
    const uint32_t e = tid / tpe;
    const uint64_t c = e < total ? sel[e] : 0ull;
    uint32_t r = 0;
    if (e < total) {
      uint32_t j = tid % tpe, r1 = 0, r2 = 0, r3 = 0;
      for (; j + 3 * tpe < total; j += 4 * tpe) {   // four loads in flight
        r += sel[j] > c;
        r1 += sel[j + tpe] > c;
        r2 += sel[j + 2 * tpe] > c;
        r3 += sel[j + 3 * tpe] > c;
      }
      for (; j < total; j += tpe) r += sel[j] > c;
      r += r1 + r2 + r3;
    }
    for (uint32_t o = 1; o < tpe; o <<= 1)
      r += __shfl_xor_sync(0xffffffffu, r, o);
    if (e < total && tid % tpe == 0 && r < (uint32_t)top_k)
      write_winner(c, out0 + r);
    return;
  }

  // more than T keys share the threshold's top bits (ties): a radix select
  // of the k-th largest key over all keys, 8 bits a pass from the top
  __syncthreads();   // every thread has read the count
  if (tid == 0) misc[3] = 0;
  uint32_t prefix = 0, mask = 0;
  uint32_t rem = (uint32_t)top_k;
  bool whole = false;   // the threshold's bucket is taken whole
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256 / 8 * 9; i += T) hist[i] = 0;
    __syncthreads();
    for (int s = tid; s < C; s += T) {
      const uint32_t k = keys[s];
      if ((k & mask) == prefix)
        atomicAdd(&hist[bin_at((k >> shift) & 255)], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[bin_at(255 - 8 * lane - i)];
        sum += c[i];
      }
      const uint32_t incl = warp_inclusive_sum(sum, lane);
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= rem);
      if (lane == __ffs(hit) - 1) {
        uint32_t run = incl - sum;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (run + c[i] >= rem) {
            misc[0] = 255 - 8 * lane - i;
            misc[1] = run;
            misc[2] = c[i];
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= misc[0] << shift;
    mask |= 0xFFu << shift;
    rem -= misc[1];
    if (misc[2] == rem) {
      whole = true;
      break;
    }
  }

  // the selected (key, slot) pairs: above the threshold, and its ties in
  // slot order up to the quota
  if (whole) {
    for (int base = 0; base < C; base += T) {
      const int s = base + tid;
      const uint32_t k = s < C ? keys[s] : 0u;
      select_pair(sel, &misc[3], s < C && (k & mask) >= prefix, k, s, lane);
    }
  } else {
    uint32_t run = 0;
    for (int base = 0; base < C; base += T) {
      const int s = base + tid;
      const uint32_t k = s < C ? keys[s] : 0u;
      const bool tie = s < C && k == prefix;
      const unsigned bal = __ballot_sync(0xffffffffu, tie);
      const uint32_t before =
          run + warp_offset(__popc(bal), wtot, lane, warp, nwarps) +
          __popc(bal & ((1u << lane) - 1u));
      select_pair(sel, &misc[3],
                  (s < C && k > prefix) || (tie && before < rem), k, s,
                  lane);
      // the chunk's ties: every warp's count, read before the next chunk
      // writes them
      uint32_t all = 0;
      for (int w = 0; w < nwarps; ++w) all += wtot[w];
      run += all;
      __syncthreads();
    }
  }
  __syncthreads();

  // place each selected pair by its rank and write the winners
  for (int i = tid; i < top_k; i += T) {
    const uint64_t c = sel[i];
    int r = 0;
    for (int j = 0; j < top_k; ++j) r += sel[j] > c;
    write_winner(c, out0 + r);
  }
}

template <int NV, int PAIR>
int launch(const void* pool_codes, const void* pool_w,
           const void* block_tables, const void* cand_idx, const void* q_sub,
           const void* q_norm, const void* levels, const void* enc_end,
           void* est, void* top_est, void* top_idx, void* top_phys,
           void* top_blk, int nb, int nblk, int G, int Hg, int bs, int C,
           int m, int bits, int sink, int top_k, int rows, int split,
           int threads, cudaStream_t stream) {
  auto kernel = rerank_topk_paged_kernel<NV, PAIR>;
  const size_t smem = (size_t)max(top_k, kMaxThreads) * 8 +
                      (size_t)(NV * 4 * 128 + 3 * C + kBins / 8 * 9 + 36) * 4;
  static size_t smem_set = 48 << 10;   // the default limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * split));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int32_t*>(pool_codes),
      static_cast<const float*>(pool_w),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(cand_idx), static_cast<const float*>(q_sub),
      static_cast<const float*>(q_norm), static_cast<const float*>(levels),
      static_cast<const int32_t*>(enc_end), static_cast<float*>(est),
      static_cast<float*>(top_est), static_cast<int32_t*>(top_idx),
      static_cast<int32_t*>(top_phys), static_cast<int32_t*>(top_blk), nb,
      nblk, G, Hg, bs, C, m, bits, sink, top_k, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int rerank_topk_paged_launch(
    const void* pool_codes, const void* pool_w, const void* block_tables,
    const void* cand_idx, const void* q_sub, const void* q_norm,
    const void* levels, const void* enc_end, void* est, void* top_est,
    void* top_idx, void* top_phys, void* top_blk, int nb, int nblk, int G,
    int Hg, int bs, int C, int B, int m, int bits, int sink, int top_k,
    int rows, int split, int threads, cudaStream_t stream) {
  // threads 256 or 512: the bucket scan holds kBins / threads <= 16 bins
  if (m < 1 || m > 8 || bits < 1 || bits > 3 || top_k < 1 || top_k > C ||
      (threads != 256 && threads != 512) ||
      (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  switch (B) {
    case 8:
      return launch<2, 2>(pool_codes, pool_w, block_tables, cand_idx, q_sub,
                       q_norm, levels, enc_end, est, top_est, top_idx,
                       top_phys, top_blk, nb, nblk, G, Hg, bs, C, m, bits,
                       sink, top_k, rows, split, threads, stream);
    case 16:
      return launch<4, 2>(pool_codes, pool_w, block_tables, cand_idx, q_sub,
                       q_norm, levels, enc_end, est, top_est, top_idx,
                       top_phys, top_blk, nb, nblk, G, Hg, bs, C, m, bits,
                       sink, top_k, rows, split, threads, stream);
    case 32:
      return launch<8, 1>(pool_codes, pool_w, block_tables, cand_idx, q_sub,
                       q_norm, levels, enc_end, est, top_est, top_idx,
                       top_phys, top_blk, nb, nblk, G, Hg, bs, C, m, bits,
                       sink, top_k, rows, split, threads, stream);
    case 128:   // MLA's latent: rows decoded kChunk vectors at a time
      return launch<32, 1>(pool_codes, pool_w, block_tables, cand_idx, q_sub,
                        q_norm, levels, enc_end, est, top_est, top_idx,
                        top_phys, top_blk, nb, nblk, G, Hg, bs, C, m, bits,
                        sink, top_k, rows, split, threads, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
