// Tiered Stage-II winner gather: staged rows from HBM, missed rows from
// pinned host memory, each distinct missed (row, kv head) read over the
// link once per launch, in one launch.
//
// Replaces the TPU kernel repro/kernels/gather_kv/ops.py
// (gather_kv_tiered_kernel, which composes the host block tables with
// dev_map and then runs _gather_rows_paged_pallas over the staging pool),
// extended to what repro/models/layers.py:attn_decode_pariskv_tiered does
// around it: the staged-winner gather, the host fetch of the misses (a
// jax.pure_callback into numpy there, repro/serving/offload.py:
// _dedup_heads_gather, which deduplicates the (row, head) pairs before it
// touches the host pool) and the blend k_ret = where(resident, k_hit,
// k_miss).
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
// with g the output row's kv head; K and V together. *count, when given,
// grows by the launch's distinct missed (row, kv head) pairs: the
// reference's unique count, np.unique(row*G + g) over the missed rows.
//
// Deduplication spans the whole launch, as the reference's np.unique
// does: a row that two batch rows pick is read once too (prefix sharing,
// ROADMAP A8, and a free slot's winners sent to block 0).
//
// Bound on the H100: bytes over the link. Scattered head-row reads from
// pinned host memory cross PCIe at ~28 GB/s against the copy engine's ~49
// GB/s bulk rate, whatever the load instruction (ld.global.cv, cp.async,
// cp.async.bulk), the row width (256 or 512 bytes) or the grid
// (scripts/tiered_load_paths.py), so the distinct missed bytes at that
// rate, plus the launch, set the time; the design spends as little as it
// can around them.
//
// Design: a grid of G x H blocks. Block (g, h) owns
//   * the missed keys (row, g) with phys % H == h: every entry of a key
//     meets in this one block, which elects the key's leader in a
//     direct-mapped table in shared memory (slot phys / H, ceil(nb*bs / H)
//     slots, so it never overflows) and counts its leaders;
//   * the zero and staged entries at positions [E*h/H, E*(h+1)/H) of kv
//     head g's E = b*Q*k entries.
// It walks head g's entries (from L2) in passes of threads * kPass:
//   1. each thread loads kPass rows, then the dev_map entries of those it
//      owns, then claims its missed keys with atomicCAS in the table; the
//      pass's zero, staged and leader entries go to an item list in
//      shared memory, followers (a key claimed in this or an earlier pass)
//      to a second list;
//   2. the block moves every 16-byte vector of K and V of its items,
//      kUnroll vectors a thread loaded before any is stored, the leaders'
//      host rows with ld.global.cv (no cached copy is trusted: the engine
//      rewrites host blocks between launches), the staged ones from HBM;
//   3. after a barrier, followers copy their leader's output row from
//      HBM/L2, not over the link.
// No device table, clear pass, cluster or cross-block barrier: the table
// lives and dies with the block.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPass = 8;     // entries a thread classifies in a pass
constexpr int kUnroll = 4;   // vectors a thread loads before it stores
enum : int { kZero = 0, kStaged = 1, kHost = 2 };

// Division by a launch constant d >= 1 of a dividend in [0, 2^31) as a
// multiply-high and a shift (CUTLASS's FastDivmod): every block divides
// each of its kv head's entries by Q*k, bs and H, so a hardware integer
// division (~20 instructions) would cost more than the scan's loads.
struct FastDiv {
  int d;
  unsigned mul, shr;
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : (int)(__umulhi((unsigned)x, mul) >> shr);
  }
  __device__ __forceinline__ int mod(int x) const { return x - div(x) * d; }
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;                                  // ceil(log2(d))
    while ((1ll << l) < d) ++l;
    f.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    f.shr = (unsigned)(l - 1);
  }
  return f;
}

__global__ void __launch_bounds__(kMaxThreads)
gather_rows_tiered_kernel(const uint4* __restrict__ stag_k,
                          const uint4* __restrict__ stag_v,
                          const uint4* host_k, const uint4* host_v,
                          uint4* out_k, uint4* out_v,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ dev_map,
                          unsigned long long* count, int nb, int nd,
                          FastDiv bs, int G, int b, FastDiv qk, int row_vec,
                          FastDiv H, int slots) {
  extern __shared__ int smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int cap = T * kPass;                  // entries of one pass
  int* kind = smem;                           // items from the front,
  int* src = smem + cap;                      // followers from the back
  int* dst = smem + 2 * cap;
  int* table = smem + 3 * cap;                // leader entry of each slot
  __shared__ int n_items, n_follow, leaders;
  const int h = blockIdx.x, g = blockIdx.y;
  const long long E = (long long)b * qk.d;    // kv head g's entries
  const long long p_lo = E * h / H.d, p_hi = E * (h + 1) / H.d;
  const int last_row = nb * bs.d - 1;
  // entry j of head g: batch row j / qk, position j % qk of its (b, g)
  auto flat = [&](int j) -> int {
    const int bi = qk.div(j);
    return (bi * G + g) * qk.d + (j - bi * qk.d);
  };
  for (int i = tid; i < slots; i += T) table[i] = -1;
  if (tid == 0) leaders = 0;

  for (long long j0 = 0; j0 < E; j0 += cap) {
    if (tid == 0) n_items = n_follow = 0;
    __syncthreads();                          // table, counters ready
    int row[kPass], stg[kPass];               // 1. classify
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const long long j = j0 + (long long)u * T + tid;
      row[u] = j < E ? rows[flat((int)j)] : -1;
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const long long j = j0 + (long long)u * T + tid;
      const int phys = repro::clampi(row[u], 0, last_row);
      const bool mine = j < E && row[u] >= 0 &&
                        ((j >= p_lo && j < p_hi) || H.mod(phys) == h);
      stg[u] = mine ? dev_map[bs.div(phys)] : -1;
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const long long j = j0 + (long long)u * T + tid;
      if (j >= E) continue;
      const bool pos = j >= p_lo && j < p_hi;
      const int phys = repro::clampi(row[u], 0, last_row);
      int k = -1, s = 0;
      if (row[u] < 0) {
        if (pos) k = kZero;
      } else if (stg[u] >= 0) {
        if (pos) {
          k = kStaged;
          s = (repro::clampi(stg[u], 0, nd - 1) * bs.d + bs.mod(phys)) * G
              + g;
        }
      } else if (H.mod(phys) == h) {
        const int old = atomicCAS(table + H.div(phys), -1, (int)j);
        if (old < 0) {
          k = kHost;
          s = phys;
          atomicAdd(&leaders, 1);
        } else {
          const int f = cap - 1 - atomicAdd(&n_follow, 1);
          src[f] = flat(old);
          dst[f] = flat((int)j);
        }
      }
      if (k >= 0) {
        const int i = atomicAdd(&n_items, 1);
        kind[i] = k;
        src[i] = s;
        dst[i] = flat((int)j);
      }
    }
    __syncthreads();
    // the counts, read before the barrier after which tid 0 resets them
    const int items = n_items, follow = n_follow;
    const int work = items * row_vec;         // 2. zero, staged, leaders
    for (int i0 = tid; i0 < work; i0 += kUnroll * T) {
      uint4 a[kUnroll], c[kUnroll];
      size_t o[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * T;
        a[u] = c[u] = make_uint4(0, 0, 0, 0);
        o[u] = 0;
        if (i >= work) continue;
        const int it = i / row_vec, v = i - it * row_vec;
        o[u] = (size_t)dst[it] * row_vec + v;
        if (kind[it] == kStaged) {
          const size_t s = (size_t)src[it] * row_vec + v;
          a[u] = stag_k[s];
          c[u] = stag_v[s];
        } else if (kind[it] == kHost) {
          const size_t s = ((size_t)src[it] * G + g) * row_vec + v;
          a[u] = __ldcv(host_k + s);
          c[u] = __ldcv(host_v + s);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * T >= work) continue;
        out_k[o[u]] = a[u];
        out_v[o[u]] = c[u];
      }
    }
    __syncthreads();                          // every leader row is out
    const int fwork = follow * row_vec;       // 3. followers, from HBM/L2
    for (int i = tid; i < fwork; i += T) {
      const int f = cap - 1 - i / row_vec, v = i % row_vec;
      const size_t o = (size_t)dst[f] * row_vec + v;
      const size_t l = (size_t)src[f] * row_vec + v;
      out_k[o] = out_k[l];
      out_v[o] = out_v[l];
    }
  }
  __syncthreads();
  if (tid == 0 && count != nullptr && leaders)
    atomicAdd(count, (unsigned long long)leaders);
}

}  // namespace

// Dynamic shared memory of one block: the pass's three lists and the
// table (kernels/gather_kv/ops.py:tiered_plan computes the same).
static size_t tiered_smem(int threads, int slots) {
  return ((size_t)3 * threads * kPass + slots) * sizeof(int);
}

REPRO_EXPORT int gather_rows_tiered_launch(
    const void* stag_k, const void* stag_v, const void* host_k,
    const void* host_v, void* out_k, void* out_v, const void* rows,
    const void* dev_map, void* count, int b, int nb, int nd, int bs, int G,
    int qk, int row_vec, int H, int threads, cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || H < 1 ||
      (long long)b * G * qk > 0x7fffffff || (long long)nb * bs > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || G == 0 || qk == 0) return (int)cudaGetLastError();
  const int slots = (int)(((long long)nb * bs + H - 1) / H);
  const size_t smem = tiered_smem(threads, slots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows_tiered_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gather_rows_tiered_kernel<<<dim3((unsigned)H, (unsigned)G),
                              (unsigned)threads, smem, stream>>>(
      static_cast<const uint4*>(stag_k), static_cast<const uint4*>(stag_v),
      static_cast<const uint4*>(host_k), static_cast<const uint4*>(host_v),
      static_cast<uint4*>(out_k), static_cast<uint4*>(out_v),
      static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(dev_map),
      static_cast<unsigned long long*>(count), nb, nd, fast_div(bs), G, b,
      fast_div(qk), row_vec, fast_div(H), slots);
  return (int)cudaGetLastError();
}
