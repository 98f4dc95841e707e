#!/usr/bin/env python3
"""Three ways of reading scattered head rows from a pinned host pool into
device memory on one NVIDIA card, timed side by side: what the tiered
gather's load path (``src/repro_torch/csrc/gather_rows_tiered.cu``) is
chosen from.

    python3 scripts/tiered_load_paths.py

Mode 0 loads 16-byte vectors into registers with ``ld.global.cv`` (the
tiered gather's load before its redesign), ``U`` of them in flight a
thread; mode 1 copies 16-byte vectors into shared memory with
``cp.async``, a tile of ``R`` rows a block; mode 2 copies whole rows into
shared memory with ``cp.async.bulk`` (one thread a row, completion on an
``mbarrier``, a bounded wait so that a copy that never lands cannot hang
the card); mode 3 is an empty launch. Each mode runs in a process of its
own (a faulting copy kills only it) over 1,681, 4,800 and 9,600 distinct
256-byte head rows, K and V (also as half as many 512-byte rows), at
several grids, and as runs of 2, 8 and 64 KB (the contiguous blocks of
a fill's prefix); each output is checked against the host pool. Then each
mode reads rows, the host rewrites them (a CPU write, then a
device-to-host copy on the stream), and the next launch must carry the
new bytes. Prints one ``load_paths`` JSON line a mode (median of 15
launches, the L2 flushed, CUDA events). Fails without a card.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "tiered_load_paths")
LIB = os.path.join(OUT, "libload_paths.so")

CUDA_SOURCE = r"""
// Load-path experiment: scattered pinned-host head rows -> device, three ways.
#include <cuda_runtime.h>
#include <stdint.h>
#define EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(s), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(s), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned phase) {
  unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  unsigned ok;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
               : "=r"(ok) : "r"(s), "r"(phase) : "memory");
  return ok != 0;
}

template <int U>
__global__ void k_ldcv(const uint4* hk, const uint4* hv, uint4* ok, uint4* ov,
                       const int* rows, int n, int rv) {
  const long total = (long)n * rv;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i0 = blockIdx.x * (long)blockDim.x + threadIdx.x; i0 < total; i0 += U * stride) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = i0 + u * stride;
      a[u] = b[u] = make_uint4(0, 0, 0, 0);
      if (i < total) {
        const long j = i / rv;
        const int v = (int)(i - j * rv);
        const long s = (long)rows[j] * rv + v;
        a[u] = __ldcv(hk + s);
        b[u] = __ldcv(hv + s);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = i0 + u * stride;
      if (i < total) { ok[i] = a[u]; ov[i] = b[u]; }
    }
  }
}

__global__ void k_cpasync(const uint4* hk, const uint4* hv, uint4* ok, uint4* ov,
                          const int* rows, int n, int rv, int R) {
  extern __shared__ uint4 sm[];
  const int T = blockDim.x;
  for (long t = blockIdx.x; t * R < n; t += gridDim.x) {
    const long r0 = t * R;
    const int cnt = (int)min((long)R, n - r0);
    const int work = cnt * rv;
    for (int i = threadIdx.x; i < work; i += T) {
      const int j = i / rv, v = i - j * rv;
      const long s = (long)rows[r0 + j] * rv + v;
      cp_async16(sm + i, hk + s);
      cp_async16(sm + work + i, hv + s);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < work; i += T) {
      ok[r0 * rv + i] = sm[i];
      ov[r0 * rv + i] = sm[work + i];
    }
    __syncthreads();
  }
}

__global__ void k_bulk(const char* hk, const char* hv, uint4* ok, uint4* ov,
                       const int* rows, int n, int rv, int R, int* err) {
  extern __shared__ __align__(128) uint4 sm[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int bad;
  const int T = blockDim.x;
  const unsigned rb = rv * 16;
  if (threadIdx.x == 0) { mbar_init(&bar, 1); bad = 0; }
  __syncthreads();
  unsigned phase = 0;
  for (long t = blockIdx.x; t * R < n; t += gridDim.x) {
    const long r0 = t * R;
    const int cnt = (int)min((long)R, n - r0);
    if (threadIdx.x == 0) mbar_expect_tx(&bar, 2u * cnt * rb);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += T) {
      const size_t s = (size_t)rows[r0 + j] * rb;
      bulk_g2s(sm + (size_t)j * rv, hk + s, rb, &bar);
      bulk_g2s(sm + (size_t)(cnt + j) * rv, hv + s, rb, &bar);
    }
    const long long t0 = clock64();
    bool done = false;
    while (!(done = mbar_try_wait(&bar, phase))) {
      if (clock64() - t0 > 4000000000LL) break;
    }
    if (!done) bad = 1;
    __syncthreads();
    if (bad) { if (threadIdx.x == 0) atomicExch(err, 1); return; }
    phase ^= 1;
    const int work = cnt * rv;
    for (int i = threadIdx.x; i < work; i += T) {
      ok[r0 * rv + i] = sm[i];
      ov[r0 * rv + i] = sm[work + i];
    }
    __syncthreads();
  }
}

__global__ void k_empty() {}

EXPORT int exp_launch(int mode, const void* hk, const void* hv, void* ok, void* ov,
                      const void* rows, int n, int rv, int grid, int threads,
                      int knob, void* err, cudaStream_t s) {
  if (mode == 0) {
    if (knob == 4)
      k_ldcv<4><<<grid, threads, 0, s>>>((const uint4*)hk, (const uint4*)hv, (uint4*)ok, (uint4*)ov, (const int*)rows, n, rv);
    else
      k_ldcv<8><<<grid, threads, 0, s>>>((const uint4*)hk, (const uint4*)hv, (uint4*)ok, (uint4*)ov, (const int*)rows, n, rv);
  } else if (mode == 1) {
    const int smem = knob * rv * 2 * 16;
    if (smem > 48 * 1024) cudaFuncSetAttribute(k_cpasync, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k_cpasync<<<grid, threads, smem, s>>>((const uint4*)hk, (const uint4*)hv, (uint4*)ok, (uint4*)ov, (const int*)rows, n, rv, knob);
  } else if (mode == 2) {
    const int smem = knob * rv * 2 * 16;
    if (smem > 48 * 1024) cudaFuncSetAttribute(k_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k_bulk<<<grid, threads, smem, s>>>((const char*)hk, (const char*)hv, (uint4*)ok, (uint4*)ov, (const int*)rows, n, rv, knob, (int*)err);
  } else {
    k_empty<<<grid, threads, 0, s>>>();
  }
  return (int)cudaGetLastError();
}
"""


def build():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.build import _nvcc
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "load_paths.cu")
    with open(src, "w") as f:
        f.write(CUDA_SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", LIB,
                    src], check=True)


def child(mode):
    import torch
    lib = ctypes.CDLL(LIB)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.exp_launch
    fn.argtypes = [I, P, P, P, P, P, I, I, I, I, I, P, P]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    NR = 65536
    hk = torch.randn((NR, 2, 128), generator=g).to(torch.bfloat16).pin_memory()
    hv = torch.randn((NR, 2, 128), generator=g).to(torch.bfloat16).pin_memory()
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = []

    def run(rows, rv, grid, threads, knob, m=mode):
        n = rows.numel()
        ok = torch.empty((n, rv * 8), dtype=torch.bfloat16, device=dev)
        ov = torch.empty_like(ok)
        e = fn(m, hk.data_ptr(), hv.data_ptr(), ok.data_ptr(), ov.data_ptr(), rows.data_ptr(),
               n, rv, grid, threads, knob, err.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if e:
            raise RuntimeError(f"launch error {e}")
        return ok, ov

    def want(rows_cpu, rv):
        fk = hk.view(-1, rv * 8)
        fv = hv.view(-1, rv * 8)
        return fk[rows_cpu.long()], fv[rows_cpu.long()]

    def timeit(fn_, iters=15):
        for _ in range(3):
            fn_()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(20_000_000)
            s = torch.cuda.Event(enable_timing=True); t = torch.cuda.Event(enable_timing=True)
            s.record(); fn_(); t.record(); torch.cuda.synchronize()
            ts.append(s.elapsed_time(t))
        return statistics.median(ts)

    if mode == 3:
        rows = torch.zeros(1, dtype=torch.int32, device=dev)
        out.append(dict(mode=3, ms=timeit(lambda: run(rows, 16, 132, 128, 0))))
        print("load_paths " + json.dumps(out), flush=True)
        return
    for rv in (16, 32, 128, 512, 4096):
        for n_bytes_rows in (1681, 4800, 9600):
            n = n_bytes_rows * 16 // rv
            total = NR * 2 * 16 // rv
            rows_cpu = torch.randperm(total, generator=g)[:n].to(torch.int32)
            rows = rows_cpu.to(dev)
            wk, wv = want(rows_cpu, rv)
            if mode == 0:
                cfgs = [(gr, 256, u) for gr in (32, 132, 264, 528)
                        for u in ((4, 8) if rv <= 32 else (4,))]
                cfgs.append((2112, 128, 4))
            else:
                cfgs = []
                for R in (1, 2, 4, 8, 16, 32):
                    if R * rv * 32 > 200 * 1024 or (rv <= 32 and R == 1):
                        continue
                    for gmax in (132, 264, 1 << 20):
                        gr = min(-(-n // R), gmax)
                        if (gr, 128, R) not in cfgs:
                            cfgs.append((gr, 128, R))
            for gr, th, kn in cfgs:
                got = run(rows, rv, gr, th, kn)
                torch.cuda.synchronize()
                if int(err):
                    raise RuntimeError("bulk wait timed out")
                good = torch.equal(got[0].cpu(), wk) and torch.equal(got[1].cpu(), wv)
                ms = timeit(lambda: run(rows, rv, gr, th, kn))
                out.append(dict(mode=mode, rv=rv, n=n, bytes=2 * n * rv * 16, grid=gr,
                                threads=th, knob=kn, ok=good, ms=ms,
                                gb_s=2 * n * rv * 16 / ms / 1e6))
    # freshness: read rows, rewrite them on the host (CPU write, then a D2H copy), read again
    rows_cpu = torch.arange(0, 2048, 3, dtype=torch.int32)
    rows = rows_cpu.to(dev)
    cfg = {0: (132, 256, 4), 1: (132, 128, 8), 2: (132, 128, 8)}[mode]
    run(rows, 16, *cfg); torch.cuda.synchronize()
    fk = hk.view(-1, 128)
    fk[rows_cpu.long()] = torch.randn((rows_cpu.numel(), 128), generator=g).to(torch.bfloat16)
    got = run(rows, 16, *cfg); torch.cuda.synchronize()
    fresh_cpu = torch.equal(got[0].cpu(), fk[rows_cpu.long()])
    newd = torch.randn((2048, 128), device=dev).to(torch.bfloat16)
    fk[:2048].copy_(newd, non_blocking=True)
    got = run(rows, 16, *cfg); torch.cuda.synchronize()
    fresh_d2h = torch.equal(got[0].cpu(), newd.cpu()[rows_cpu.long()])
    out.append(dict(mode=mode, fresh_cpu_write=fresh_cpu, fresh_d2h_copy=fresh_d2h))
    print("load_paths " + json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(int(sys.argv[1]))
        sys.exit(0)
    import torch
    if not torch.cuda.is_available():
        print("tiered_load_paths: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    build()
    for m in (3, 0, 1, 2):
        try:
            r = subprocess.run([sys.executable, __file__, str(m)], capture_output=True, text=True, timeout=240)
            print(f"mode {m} rc {r.returncode}", flush=True)
            print(r.stdout[-20000:], flush=True)
            print(r.stderr[-3000:], flush=True)
        except subprocess.TimeoutExpired:
            print(f"mode {m} TIMEOUT", flush=True)
