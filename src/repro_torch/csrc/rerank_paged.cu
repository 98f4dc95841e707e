// Stage-II RSQ-IP rerank of the Stage-I candidates, gathered by physical
// pool row inside the kernel (the paper's kernel iii).
//
// Replaces the TPU kernel repro/kernels/rerank/rerank.py (_rerank_pallas /
// _kernel), reached through repro/kernels/rerank/ops.py:
// rerank_paged_kernel, whose wrapper first gathers codes and weights with
// XLA and pads C to 512.
//
// For candidate c of row (b,g,h) at physical pool row r = phys[b,g,h,c]:
//     est = |q| * sum_s w[r,g,s] * sum_j v(code[r,g,s])_j * q_sub[b,g,h,s,j]
// where each 32-bit code packs 8 nibbles (bit 3 = sign, bits 0-2 index a
// Lloyd-Max level), and est = -1e30 where cand[b,g,h,c] is outside
// [sink, enc_end[b]) (the JAX package's finite NEG_INF).
//
// Bound on the H100: bytes. Per valid candidate it must read B int32 codes
// and B float32 weights (128 bytes at B=16) from a random pool row, plus
// the candidate's index and physical row, and write one float. At the
// decode path's shapes (48 rows of C=1311 candidates) that is about
// 8.8 MB: 2.6 us at the H100's 3.35 TB/s. The arithmetic (~2*B*m flops per
// candidate) is far below the card's rate.
//
// Design: one thread per candidate, 128 candidates per block, one block
// row per (b,g,h). The block stages that query's q_sub (B*m floats) and
// the 8 levels in shared memory; each thread reads its row's codes and
// weights with 16-byte vector loads at pool offset ((blk*G+g)*bs+off)*B
// (the pool's (num_blocks, G, block_size, B) layout), unpacks with shifts
// and masks, and accumulates in registers. Invalid candidates read nothing.
#include "common.cuh"

namespace {

__global__ void rerank_paged_kernel(const int32_t* __restrict__ pool_codes,
                                    const float* __restrict__ pool_w,
                                    const int32_t* __restrict__ phys_rows,
                                    const int32_t* __restrict__ cand_idx,
                                    const float* __restrict__ q_sub,
                                    const float* __restrict__ q_norm,
                                    const float* __restrict__ levels,
                                    const int32_t* __restrict__ enc_end,
                                    float* __restrict__ out, int nb, int G,
                                    int Hg, int bs, int C, int B, int m,
                                    int bits, int sink) {
  extern __shared__ float shf[];
  float* q = shf;           // (B, m)
  float* lev = shf + B * m;  // (1 << bits)
  const int row = blockIdx.y;  // (b, g, h) flattened
  const int g = (row / Hg) % G;
  const int bi = row / (Hg * G);
  const int nlev = 1 << bits;
  for (int i = threadIdx.x; i < B * m; i += blockDim.x)
    q[i] = q_sub[(size_t)row * B * m + i];
  for (int i = threadIdx.x; i < nlev; i += blockDim.x) lev[i] = levels[i];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t idx = (size_t)row * C + c;
  const int cand = cand_idx[idx];
  if (cand < sink || cand >= enc_end[bi]) {
    out[idx] = repro::kNegInf;
    return;
  }
  const int phys = repro::clampi(phys_rows[idx], 0, nb * bs - 1);
  const size_t base = (((size_t)(phys / bs) * G + g) * bs + phys % bs) * B;
  const int4* code4 = reinterpret_cast<const int4*>(pool_codes + base);
  const float4* w4 = reinterpret_cast<const float4*>(pool_w + base);
  const int mag_mask = nlev - 1;
  float acc = 0.f;
  for (int s4 = 0; s4 < B / 4; ++s4) {
    const int4 cw = code4[s4];
    const float4 ww = w4[s4];
    const int words[4] = {cw.x, cw.y, cw.z, cw.w};
    const float wts[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* qs = q + (s4 * 4 + t) * m;
      float dot = 0.f;
      for (int j = 0; j < m; ++j) {
        const int nib = (words[t] >> (4 * j)) & 0xF;
        const float mag = lev[nib & mag_mask];
        dot += ((nib >> bits) & 1 ? mag : -mag) * qs[j];
      }
      acc += wts[t] * dot;
    }
  }
  out[idx] = q_norm[row] * acc;
}

}  // namespace

REPRO_EXPORT int rerank_paged_launch(const void* pool_codes,
                                     const void* pool_w,
                                     const void* phys_rows,
                                     const void* cand_idx, const void* q_sub,
                                     const void* q_norm, const void* levels,
                                     const void* enc_end, void* out, int nb,
                                     int G, int Hg, int bs, int C, int B,
                                     int m, int bits, int sink, int b,
                                     cudaStream_t stream) {
  if (B % 4 != 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  dim3 grid((C + threads - 1) / threads, b * G * Hg);
  const size_t smem = (size_t)(B * m + (1 << bits)) * sizeof(float);
  rerank_paged_kernel<<<grid, threads, smem, stream>>>(
      static_cast<const int32_t*>(pool_codes),
      static_cast<const float*>(pool_w),
      static_cast<const int32_t*>(phys_rows),
      static_cast<const int32_t*>(cand_idx),
      static_cast<const float*>(q_sub), static_cast<const float*>(q_norm),
      static_cast<const float*>(levels), static_cast<const int32_t*>(enc_end),
      static_cast<float*>(out), nb, G, Hg, bs, C, B, m, bits, sink);
  return (int)cudaGetLastError();
}
