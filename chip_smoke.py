#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds and serves on the GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build    — compile the seven CUDA C++ kernels from the six sources in
              ``src/repro_torch/csrc`` (one nvcc per source, in parallel)
              and print the seconds.
2. device   — the card's name and power limit, as nvidia-smi reports them.
3. kernels  — each kernel against its plain PyTorch version on the same
              inputs on the card, at the decode path's shapes for
              qwen2-1.5b (b=4, G=2, Hg=6, hd=128, B=16, 2^m=256, blocks of
              128, n_max=16384): the largest difference (exact for
              collision, bucket_topk and the gathers; a stated float32
              tolerance for rerank), the median device time over warm calls
              with a cold L2 (and, as call_ms, the time including the host's
              launch gap), the plain version's time, a PyTorch yardstick
              where one call computes the same function, and the bound.
              The tiered winner gather reads half its rows from a pinned
              host pool, each distinct missed (row, kv head) once; its
              distinct count must equal torch.unique's, it is timed at
              every grid it can launch (tiered_grid), and its bound
              prices the distinct missed bytes at the card's pinned
              host-to-device rate, measured here with one 256 MiB copy.
              The chunked fill's kernels are held and timed at the
              12,000-token request's 24th chunk: the prefix read (the
              paged gather's logical mode, and the tiered gather with
              half the blocks staged) and the histogram update
              (bucket_count's block-table mode). Stage I and the top-C cut are also checked on an all-tie
              set and on threshold ties spread over every segment and timed
              back to back as a pair; Stage II with its top-k
              (rerank_topk_paged) is held, at the paged and the contiguous
              shapes and at every grid it can launch (stage2_grid), to the
              plain top-k of its own estimates on the main inputs, on all
              ties and on a row with fewer valid candidates than k; the
              decode gather is held bit-exact with and without winners;
              both are timed beside the chains they replace. At the slot
              engine's shapes (a contiguous cache seen as a pool of one
              block per batch row) the region's bucket histogram
              (bucket_count, at stride 1 and 4, at every grid it can
              launch: count_grid) is held exactly to its plain version and
              timed beside the scatter_add chain it replaced, and Stage I,
              the cut, Stage II and the decode gather (a window start
              clamped to n - W) are held to theirs and timed as the
              contiguous route of the TPU kernels #5 and #6; the ptxas
              report (registers, shared memory, spills) of the five
              kernels designed for Hopper is printed.
4. engine   — the main path: ``PagedServingEngine`` (fused retrieval)
              serving qwen2-1.5b at full width (28 layers, bf16, random
              weights from a seed) to four staggered requests of
              ~3k/6k/9k/12k prompt tokens and 300 new tokens each. Launch
              counters are zeroed just before and read just after; each
              kernel of the path must have launched at least 28 × decode
              steps times (Stage II exactly that, the paged gather at most
              28 more per promotion), every request must promote, and the
              incremental histograms must equal a recompute at every chunk.
   profile  — then one decode chunk of the same engine (four rows) under
              torch.profiler: wall and device-busy time per step, kernel
              launches and host-device copies per step, the top kernels.
              The slot phase ends with the same profile of its engine.
5. slot     — the contiguous ``ServingEngine`` on the same four requests:
              the region's histogram, Stage I, top-C and Stage II each
              launched exactly 28 × steps, the decode gather 28 × steps
              plus at most 28 per promotion, the histogram pass never;
              every request promoted, token agreement with the engine
              phase printed as a rate (bf16 promises no identity).
6. metaview — ``PagedServingEngine(fused=False)`` and the fused engine on
              the first two requests with 32 new tokens: identical tokens
              asserted, Stage I over the view launched exactly 28 × steps.
7. baseline — the slot engine with ParisKV and with full attention
              (``use_pariskv=False``), and ``WaveServingEngine``, on
              requests of 3000/6000 prompt tokens with 32 new each: host-
              bound smoke throughputs, not a benchmark.
8. offload  — ``PagedServingEngine(offload=True)``: (a) the engine phase's
              four requests with the K/V pool in pinned host memory and a
              staging pool of a quarter of its blocks; tokens identical to
              the engine phase's asserted, staging misses and hits > 0,
              the tiered gather launched 28 × steps; tokens/s, TTFT, peak
              device memory, pinned bytes, fetched bytes, miss share and
              prefetch hits printed beside the resident run's, then a
              profile of one chunk; the first two requests (32 new) with
              overlap on and off, identical tokens asserted; the same two
              (16 new) once more, untimed, counting in every tiered-gather
              launch the missed winner head rows, how many repeat a row
              already read in that launch, and asserting that the kernel
              read each distinct one once (``offload_duplicates``). (b)
              one request of 65,536 prompt tokens and 32 new through the
              offloaded engine (staging pool 1/8 of 1024 blocks) and the
              resident paged engine: identical tokens asserted, peak
              memory and TTFT printed.
9. chunked  — chunked prefill (``prefill_budget=512``) at full width on
              the engine phase's four requests: (a) the paged engine,
              (b) the slot engine, (c) the offloaded engine (128 of 512
              blocks staged, every tiered-gather launch checked as in
              ``offload_duplicates``): per request TTFT, the longest gap
              between tokens of the requests already decoding while it
              was admitted, tokens/s and token agreement with the engine
              phase printed; the fill's prefix reads and histogram
              updates counted among the launches; (c)'s tokens asserted
              equal to (a)'s, fill rows read from host memory, and its
              distinct rows equal to the kernel's. (d) 2 layers in
              float32: chunked tokens equal solo tokens on the paged,
              slot and offloaded engines. (e) a profile of eight mixed
              steps (a 12,000-token fill beside three decoding rows): the
              fill's gather_rows_paged and bucket_count launch in every
              layer of every step.
10. parity  — 2 layers at full width in float32: one teacher-forced
              request (2048-token prompt, 64 given tokens) through the
              paged and the contiguous decode step, each on the card
              (kernels) and on the CPU (plain versions); logits must agree
              at every step, within 1e-3 where every winner set agrees and
              within 5 % of the largest logit after a near-tie winner flip.

Pass phase names to run a subset (``python3 chip_smoke.py kernels slot``).
The last two lines are the kernels' JSON summary and the result line.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 20_000_000       # ~10 ms of device spin: longer than any
#                                call's host-side enqueue in this script
RERANK_RTOL, RERANK_ATOL = 1e-4, 1e-3
PROMPTS = (3000, 6000, 9000, 12000)      # the four requests of the engines
GEN = 300
ARRIVALS = (0, 2, 4, 6)                  # chunk before each submission
LENS_AFTER = [p + GEN for p in PROMPTS]  # their lengths at the end
# each path's kernels → their launches per layer and decode step (the
# paged gather moves sink, window and winner rows in one launch; the tiered
# path reads its winners with gather_rows_tiered, so its paged gather moves
# sink and window only). Promotion adds K-only paged gathers. A contiguous
# store (slot path, meta view) runs the paged kernels over one block per
# batch row, after its region's bucket histogram (bucket_count; the paged
# engines also launch it at admission and in their histogram audits).
# Stage I hands the top-C its histograms on every path: the histogram pass
# (bucket_hist) must never launch.
PAGED_KERNELS = {"collision_paged": 1, "bucket_topk": 1,
                 "rerank_topk_paged": 1, "gather_rows_paged": 1}
SLOT_KERNELS = {"bucket_count": 1, **PAGED_KERNELS}
METAVIEW_KERNELS = SLOT_KERNELS
# kernels launched exactly once per layer and decode step where listed
EXACT = ("collision_paged", "bucket_topk", "rerank_topk_paged")
OFFLOAD_KERNELS = {"collision_paged": 1, "bucket_topk": 1,
                   "rerank_topk_paged": 1, "gather_rows_paged": 1,
                   "gather_rows_tiered": 1}
LONG_PROMPT, LONG_GEN = 65536, 32        # the offload phase's long request
OVERLAP_GEN = 32                         # the offload overlap on/off runs
CHUNK_BUDGET = 512                       # the chunked phase's prefill_budget
# card (kernels, cuBLAS) vs CPU (plain versions) in float32. Where every
# (layer, head) winner set agrees, only summation order differs: 1e-3 over
# two layers and 64 appended steps. A near-tie Stage-II estimate can pick
# another winner on one side, and the next layer's queries then differ;
# such steps are held to 5 % of the largest logit.
PARITY_ATOL = 1e-3
PARITY_FLIP_RTOL = 0.05


def _bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, flush, iters: int = 30, primed: bool = True) -> float:
    """Median of per-call CUDA-event times, the L2 flushed before each.
    ``primed``: the device first spins (``torch.cuda._sleep``) while the
    host enqueues the events and the call, so the interval holds device
    time only. Unprimed, it also holds the host's launch gap — what one
    call costs a host-bound caller."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if primed:
            torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
        torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------- kernels ---
def kernel_phase(dev, cfg, seed: int = 0):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.core import centroids
    from repro_torch.core import encode as E
    from repro_torch.core import retrieval as R
    from repro_torch.kernels import SEG_LEN
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.bucket_topk import bucket_topk, segment_histogram
    from repro_torch.kernels.bucket_topk import ops as TO
    from repro_torch.kernels.bucket_topk.ref import (bucket_topk_ref,
                                                     bucket_topk_segments_ref,
                                                     segment_histogram_ref)
    from repro_torch.kernels.collision import (collision_scores_paged_kernel,
                                               lane_packed_table)
    from repro_torch.kernels.collision.ref import collision_paged_ref
    from repro_torch.kernels.gather_kv import gather_decode_paged
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.gather_kv.ref import gather_decode_paged_ref
    from repro_torch.kernels.rerank import ops as RO
    from repro_torch.kernels.rerank import rerank_topk_paged
    from repro_torch.kernels.rerank.ref import (block_relative,
                                                rerank_topk_paged_ref)
    from repro_torch.models.serve import rotation_signs

    pcfg = cfg.pariskv
    b, G, hd = 4, cfg.num_kv_heads, cfg.head_dim
    Hg = cfg.num_heads // G
    B, nc, m = pcfg.num_subspaces(hd), pcfg.num_centroids(), pcfg.m
    bs, n_max, nb = 128, 16384, 512
    nblk, n = n_max // bs, n_max
    C = pcfg.candidate_count(n)
    sink, W, k_top = pcfg.sink_size, CC.window_size(pcfg), pcfg.top_k
    gen = torch.Generator(device=dev).manual_seed(seed)

    # pool: random keys encoded as the decode path encodes them
    pool = CC.init_paged_cache(nb, bs, G, hd, pcfg, torch.bfloat16, dev)
    keys = torch.randn((nb, bs, G, hd), generator=gen, device=dev)
    pool.k.copy_(keys)
    pool.v.copy_(torch.randn((nb, bs, G, hd), generator=gen, device=dev))
    meta = E.encode_keys(keys.transpose(1, 2), pcfg, rotation_signs(cfg, dev))
    pool.meta_ids.copy_(meta.centroid_ids)
    pool.meta_codes.copy_(meta.codes)
    pool.meta_w.copy_(meta.weights)
    # four rows of ~3k..12k prompt + 300 tokens; unallocated tails are -1
    lens = LENS_AFTER
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((b, nblk), -1, dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(lens):
        need = -(-ln // bs)
        bt[i, :need] = perm[used:used + need]
        used += need
    enc_end = torch.tensor([ln - 300 - pcfg.local_size for ln in lens],
                           dtype=torch.int32, device=dev)
    pos = enc_end + pcfg.local_size + 150
    regions = CC.CacheRegions(pos=pos, enc_end=enc_end)
    hist = CC.bucket_hist_from_meta(CC.paged_ids_view(pool, bt), regions,
                                    pcfg)
    q = torch.randn((b, G, Hg, hd), generator=gen, device=dev)
    qt = E.encode_query(q, pcfg, rotation_signs(cfg, dev))
    cs = centroids.centroid_scores(qt.q_sub, m)
    n_valid = (enc_end - sink).clamp_min(0)
    tables = R.tier_weight_table(cs, hist[:, :, None], n_valid[:, None, None],
                                 pcfg, out=lane_packed_table(*cs.shape,
                                                             device=dev))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # what the timing method measures for one launch of a trivial kernel
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    print("event_floor " + json.dumps(dict(
        note="one PyTorch add on one int32: the least device time the "
             "timing method reports for a launch",
        ms=_time_ms(lambda: tiny.add_(1), flush))), flush=True)
    out = {}
    nval = int(n_valid.sum())
    rng_s = R.max_collision_score(pcfg, B)

    # 1. Stage I, with the score histograms per segment
    def stage1():
        return collision_scores_paged_kernel(pool.meta_ids, bt, tables,
                                             enc_end, sink, rng_s)
    coarse, seg_hist = stage1()
    want, want_hist = collision_paged_ref(pool.meta_ids, bt, tables, enc_end,
                                          sink, rng_s)
    err = max(int((coarse - want).abs().max()),
              int((seg_hist - want_hist).abs().max()))
    _check(err == 0, f"collision_paged differs from its plain version ({err})")
    valid_blocks = int(sum(min(-(-int(e) // SEG_LEN), n // SEG_LEN)
                           - sink // SEG_LEN for e in enc_end) * G)
    out["collision_paged"] = dict(
        route="cuda", source="src/repro_torch/csrc/collision_paged.cu",
        replaces="src/repro/kernels/collision/collision.py:146",
        max_abs_err=err, tolerance="exact (scores and seg_hist)",
        blocks=(n // SEG_LEN) * b * G, blocks_with_valid_keys=valid_blocks,
        ms=_time_ms(stage1, flush),
        call_ms=_time_ms(stage1, flush, primed=False),
        plain_ms=_time_ms(lambda: collision_paged_ref(
            pool.meta_ids, bt, tables, enc_end, sink, rng_s), flush),
        library_ms=None,
        bound=_bound(G * nval * B + tables.numel() + bt.numel() * 4
                     + b * 4 + coarse.numel() * 4 + seg_hist.numel() * 4,
                     G * nval * B))

    # 2. bucket top-C from Stage I's histograms, exact on Stage I's scores,
    # on an all-tie set and on threshold ties spread over every segment
    ties = torch.zeros_like(coarse)
    ties[..., :sink] = -1
    spread = torch.randint(-1, 80, coarse.shape, generator=gen, device=dev,
                           dtype=torch.int32)
    spread[..., 5::9] = 90                  # 1,820 ties a row, 64 segments
    cases = {"stage1": (coarse, seg_hist), "all_ties": (ties, None),
             "ties_over_segments": (spread, None)}
    grids = (4, 8, 16, 32)                  # warps (segments) per block

    def cut_at(scores, h, warps):
        """The cut at another grid (launched directly, so not counted)."""
        o = torch.empty(scores.shape[:-1] + (C,), dtype=torch.int32,
                        device=dev)
        KB.launch("bucket_topk", KB.ptr(scores), KB.ptr(h), KB.ptr(o),
                  scores.numel() // n, n, C, rng_s + 2, SEG_LEN,
                  TO._vec(scores), warps)
        return o
    for name, (scores, h) in cases.items():
        h_ref = segment_histogram_ref(scores, rng_s)
        if h is None:
            h = segment_histogram(scores, rng_s)
            _check(torch.equal(h, h_ref),
                   f"bucket_hist differs from its plain version ({name})")
        cand = bucket_topk(scores, C, rng_s, seg_hist=h)
        _check(torch.equal(cand, bucket_topk_ref(scores, C, rng_s))
               and torch.equal(cand, bucket_topk_segments_ref(
                   scores, h_ref, C, rng_s)),
               f"bucket_topk differs from its plain versions ({name})")
        _check(torch.equal(bucket_topk(scores, C, rng_s), cand),
               f"bucket_topk without seg_hist differs ({name})")
        for warps in grids:
            _check(torch.equal(cut_at(scores, h, warps), cand),
                   f"bucket_topk at {warps} warps a block differs ({name})")
        if name == "ties_over_segments":    # every candidate is a tie
            seg_of = cand // SEG_LEN
            _check(bool((seg_of.amax(-1) - seg_of.amin(-1) >= 2).all())
                   and bool((cand[..., -1] < 5 + 9 * 1819).all()),
                   "the taken ties span < 3 segments or the whole quota")
    cand = bucket_topk(coarse, C, rng_s, seg_hist=seg_hist)
    # ties at the threshold: the C-th largest score is shared with others
    kth = coarse.sort(-1, descending=True).values[..., C - 1:C]
    tie_rows = int(((coarse == kth).sum(-1) > 1).sum())
    # the segments the cut must read: those holding a candidate
    seg_read = int(torch.zeros(coarse.shape[:-1] + (n // SEG_LEN,),
                               dtype=torch.int32, device=dev).scatter_(
        -1, (cand // SEG_LEN).long(), 1).sum())
    out["bucket_topk"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_topk.cu",
        replaces="src/repro/kernels/bucket_topk/bucket_topk.py:50",
        max_abs_err=0, tolerance="exact", rows_with_threshold_ties=tie_rows,
        segments_read=seg_read, segments=seg_hist.numel() // (rng_s + 2),
        ms=_time_ms(lambda: bucket_topk(coarse, C, rng_s, seg_hist=seg_hist),
                    flush),
        call_ms=_time_ms(lambda: bucket_topk(coarse, C, rng_s,
                                             seg_hist=seg_hist), flush,
                         primed=False),
        ms_without_seg_hist=_time_ms(lambda: bucket_topk(coarse, C, rng_s),
                                     flush),
        plain_ms=_time_ms(lambda: bucket_topk_ref(coarse, C, rng_s), flush),
        library_ms=_time_ms(lambda: torch.topk(coarse, C, -1, sorted=False),
                            flush),
        bound=_bound(seg_hist.numel() * 4 + seg_read * SEG_LEN * 4
                     + cand.numel() * 4, 0))
    rows = coarse.numel() // n
    print("topk_grid " + json.dumps([dict(
        warps=w, blocks=-(-(n // SEG_LEN) // w) * rows,
        ms=_time_ms(lambda w=w: cut_at(coarse, seg_hist, w), flush))
        for w in grids]), flush=True)
    out["bucket_hist"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_topk.cu",
        replaces="src/repro/kernels/bucket_topk/bucket_topk.py:50",
        max_abs_err=0, tolerance="exact",
        ms=_time_ms(lambda: segment_histogram(coarse, rng_s), flush),
        call_ms=_time_ms(lambda: segment_histogram(coarse, rng_s), flush,
                         primed=False),
        plain_ms=_time_ms(lambda: segment_histogram_ref(coarse, rng_s),
                          flush),
        library_ms=None,
        bound=_bound(coarse.numel() * 4 + seg_hist.numel() * 4,
                     coarse.numel()))

    def pair():
        scores, h = stage1()
        return bucket_topk(scores, C, rng_s, seg_hist=h)
    out["collision_paged"]["pair"] = dict(
        note="Stage I with seg_hist, then the cut from it; one L2 flush "
             "before the pair",
        ms=_time_ms(pair, flush), call_ms=_time_ms(pair, flush, primed=False),
        bound_ms=out["collision_paged"]["bound"][0]
        + out["bucket_topk"]["bound"][0])
    print("kernel_pair " + json.dumps(out["collision_paged"]["pair"]),
          flush=True)

    # 3. Stage II with the top-k, through the block table: the estimates
    # against the plain version, the selection exactly against the plain
    # top-k of the kernel's own estimates, on the main path's inputs, on
    # all ties (|q| = 0: every estimate is +0.0 or -0.0) and on a row with
    # fewer valid candidates than k
    q_sub = qt.q_sub.float().contiguous()
    q_norm = qt.q_norm.float().contiguous()
    args = (pool.meta_codes, pool.meta_w, bt, cand, q_sub, q_norm, enc_end,
            sink, k_top, m, pcfg.magnitude_bits)
    won, err = _stage2_checks(args, bs, "paged")
    rows2 = b * G * Hg
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = RO.default_split(rows2, C, sms)
    grid = []
    for sp in RO.SPLITS:
        for th in (256, 512):
            _stage2_checks(args, bs, f"paged split {sp} threads {th}",
                           grid=(sp, th))
            grid.append(dict(split=sp, threads=th, blocks=rows2 * sp,
                             ms=_time_ms(lambda sp=sp, th=th: RO.launch(
                                 *args, sp, th), flush)))
    print("stage2_grid " + json.dumps(grid), flush=True)

    def chain():
        """The chain this kernel replaced: the candidates' rows, the
        estimates alone (this kernel at top_k 1 stands in for an
        estimates-only kernel), a stable sort, slice, gather and the
        winners' rows."""
        block_relative(cand, bt, bs)
        est1 = rerank_topk_paged(*args[:8], 1, *args[9:]).est
        top = torch.sort(est1, dim=-1, descending=True, stable=True).indices
        return block_relative(cand.gather(-1, top[..., :k_top]), bt, bs)

    def chain_torch():
        """The torch ops of that chain alone, on this run's estimates."""
        block_relative(cand, bt, bs)
        top = torch.sort(won.est, dim=-1, descending=True,
                         stable=True).indices
        return block_relative(cand.gather(-1, top[..., :k_top]), bt, bs)
    n_cand = int(((cand >= sink) & (cand < enc_end[:, None, None, None]))
                 .sum())
    out["rerank_topk_paged"] = dict(
        route="cuda", source="src/repro_torch/csrc/rerank_topk_paged.cu",
        replaces="src/repro/kernels/rerank/rerank.py:78",
        max_abs_err=err,
        tolerance=f"estimates rtol {RERANK_RTOL}, atol {RERANK_ATOL}: "
                  f"float32 sums of B*m products in another order; the "
                  f"selection exact against the plain top-k of the kernel's "
                  f"own estimates",
        split=split, threads=RO.THREADS, valid_candidates=n_cand,
        ms=_time_ms(lambda: rerank_topk_paged(*args), flush),
        call_ms=_time_ms(lambda: rerank_topk_paged(*args), flush,
                         primed=False),
        plain_ms=_time_ms(lambda: rerank_topk_paged_ref(*args), flush),
        library_ms=None,
        chain_ms=_time_ms(chain, flush),
        chain="the chain it replaces: block lookup of the candidates, "
              "estimates, stable sort/slice/gather, block lookup of the "
              "winners",
        chain_torch_ms=_time_ms(chain_torch, flush),
        chain_torch_call_ms=_time_ms(chain_torch, flush, primed=False),
        bound=_bound(n_cand * B * 8 + cand.numel() * 8 + bt.numel() * 4
                     + b * 4 + rows2 * k_top * 16 + q_sub.numel() * 4
                     + q_norm.numel() * 4,
                     n_cand * (2 * B * m + 2 * B)))

    # 4. the decode gather: sink and window rows through the table (from
    # the window start), winners by physical row, K and V, one launch
    ws = (pos + 2 - W).clamp_min(0).to(torch.int32)
    phys = won.phys_rows

    def kern():
        return gather_decode_paged(pool.k, pool.v, bt, ws, sink, W, phys)

    def plain():
        return gather_decode_paged_ref(pool.k, pool.v, bt, ws, sink, W, phys)

    for rows_w in (phys, None):     # with and without winners
        got_g = gather_decode_paged(pool.k, pool.v, bt, ws, sink, W, rows_w)
        want_g = gather_decode_paged_ref(pool.k, pool.v, bt, ws, sink, W,
                                         rows_w)
        _check(all(x is y or torch.equal(x, y)
                   for x, y in zip(got_g, want_g)),
               f"gather_rows_paged differs from its plain version "
               f"(winners {rows_w is not None})")

    def chain_g():
        """The two launches this mode replaced, with their index
        construction: the sink and window positions, then one launch for
        them and one for the winners."""
        lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                          ws[:, None] + torch.arange(W, device=dev)], 1
                         ).to(torch.int32).contiguous()
        return (GO._launch(pool.k, pool.v, bt, b, sink + W, lidx=lidx),
                GO._launch(pool.k, pool.v, bt, b, 0, phys=phys))

    flat_k = pool.k.reshape(nb * bs, G, hd)
    flat_v = pool.v.reshape(nb * bs, G, hd)
    heads = torch.arange(G, device=dev)[None, :, None, None]
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      ws[:, None] + torch.arange(W, device=dev)], 1)
    rows_l = (bt.long().gather(1, (lidx // bs).long()).clamp_min(0) * bs
              + lidx % bs)
    rows_p = phys.long()

    def indexing():
        return (flat_k[rows_l], flat_v[rows_l], flat_k[rows_p, heads],
                flat_v[rows_p, heads])

    dk, dv, wk, wv = kern()
    moved = 2 * (dk.numel() + dv.numel() + wk.numel() + wv.numel()) * 2
    out["gather_rows_paged"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_paged.cu",
        replaces="src/repro/kernels/gather_kv/gather_kv.py:87",
        max_abs_err=0, tolerance="exact",
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        ms_without_winners=_time_ms(
            lambda: gather_decode_paged(pool.k, pool.v, bt, ws, sink, W),
            flush),
        plain_ms=_time_ms(plain, flush),
        library_ms=_time_ms(indexing, flush),
        chain_ms=_time_ms(chain_g, flush),
        chain="the two launches it replaces, with their index "
              "construction",
        bound=_bound(moved + phys.numel() * 4 + b * 4 + bt.numel() * 4, 0))
    _ptxas(B, nc, Hg, rng_s + 2, n, C, k_top)
    _contiguous_kernels(dev, cfg, gen, flush, lens, out)
    tier, link = _tiered_kernel(dev, pool, won.top_idx, phys, enc_end, sink,
                                gen, flush, out)
    _fill_kernels(dev, cfg, pool, bt, tier, link, gen, flush, out)
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        print(f"kernel {name} " + json.dumps(rec), flush=True)
    return out


def _ptxas(B: int, nc: int, Hg: int, rng: int, n: int, C: int,
           k: int) -> None:
    """Registers, shared memory and spills of the five kernels designed for
    Hopper, from nvcc's -Xptxas -v logs, with the dynamic shared memory
    each launch asks for at these shapes (their launchers' formulas)."""
    from repro_torch.kernels import SEG_LEN
    from repro_torch.kernels import build
    from repro_torch.kernels.rerank import ops as RO
    nseg = -(-n // SEG_LEN)
    dyn = {"collision_paged": B * nc * 8 + Hg * rng * 4,
           "bucket_hist": 8 * rng * 4,
           "bucket_topk": (rng + 2 * (nseg + 1) + 2) * 4,
           "rerank_topk_paged": RO.smem_bytes(C, B, k),
           "gather_rows_paged": 0, "bucket_count": B * nc * 4}
    for source in ("collision_paged", "bucket_topk", "rerank_topk_paged",
                   "gather_rows_paged", "bucket_count"):
        rec = {"kernels": build.ptxas_report(source),
               "dynamic_smem_bytes": {k: v for k, v in dyn.items()
                                      if build.SOURCE_OF[k] == source}}
        print(f"ptxas {source} " + json.dumps(rec), flush=True)


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (a float's sign of zero included)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _stage2_checks(args, bs: int, label: str, grid=None):
    """``rerank_topk_paged(*args)`` (or its launch at ``grid`` = (split,
    threads)) against its plain version: the
    estimates within the Stage-II tolerance, and the selection (estimates,
    positions, physical rows and blocks) exactly the plain top-k of the
    kernel's own estimates; then the same on all ties (|q| = 0) and on a
    row with fewer valid candidates than k (batch row 0's region cut to
    50 positions). → (the main inputs' result, the largest estimate
    difference)."""
    import torch
    from repro_torch.kernels.rerank import ops as RO
    from repro_torch.kernels.rerank import rerank_topk_paged
    from repro_torch.kernels.rerank.ref import (block_relative,
                                                rerank_topk_paged_ref,
                                                topk_ref)
    codes, w, bt, cand, q_sub, q_norm, enc_end, sink, k = args[:9]
    short = enc_end.clone()
    short[0] = sink + 50
    cases = {"": args,
             " all ties": args[:5] + (torch.zeros_like(q_norm),) + args[6:],
             " short row": args[:6] + (short,) + args[7:]}
    first, worst = None, 0.0
    for name, a in cases.items():
        won = (rerank_topk_paged(*a) if grid is None
               else RO.launch(*a, *grid))
        plain = rerank_topk_paged_ref(*a)
        err = float((won.est - plain.est).abs().max())
        _check(torch.allclose(won.est, plain.est, rtol=RERANK_RTOL,
                              atol=RERANK_ATOL),
               f"rerank_topk_paged estimates differ from the plain version "
               f"({label}{name}: {err})")
        top_est, top_pos = topk_ref(won.est, k)
        top_idx = cand.gather(-1, top_pos)
        blk, phys = block_relative(top_idx, bt, bs)
        _check(_bits_equal(won.top_est, top_est)
               and torch.equal(won.top_idx, top_idx.to(torch.int32))
               and torch.equal(won.phys_rows, phys.to(torch.int32))
               and torch.equal(won.block_ids, blk.to(torch.int32)),
               f"rerank_topk_paged selection differs from the plain top-k "
               f"of its estimates ({label}{name})")
        if name == " all ties":
            _check(bool((won.top_est == 0).all()), "all-ties case not tied")
        if name == " short row":
            _check(bool((won.top_est[0, ..., 50:] == -1e30).all()),
                   "short row: fewer than k valid not reached")
        if first is None:
            first = won
        worst = max(worst, err)
    return first, worst


def _contiguous_kernels(dev, cfg, gen, flush, lens, out):
    """The slot engine's shapes: a (b, n_max) per-slot cache of the same
    four rows, seen as a pool of one block per batch row (``row_tables``).
    The slot path runs the paged kernels over it after its region's bucket
    histogram (bucket_count, the one kernel of its own); each is held
    against its plain version at these shapes, and the contiguous routes
    of the TPU kernels #5 (Stage I) and #6 (the gather) are timed."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.core import centroids
    from repro_torch.core import encode as E
    from repro_torch.core import retrieval as R
    from repro_torch.kernels import row_tables
    from repro_torch.kernels.bucket_topk import bucket_topk
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision import (bucket_count,
                                               collision_scores_kernel,
                                               lane_packed_table)
    from repro_torch.kernels.collision import ops as CO
    from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                                   collision_paged_ref)
    from repro_torch.kernels.gather_kv import gather_decode_paged
    from repro_torch.kernels.gather_kv.ref import gather_decode_paged_ref
    from repro_torch.models.serve import rotation_signs

    pcfg = cfg.pariskv
    b, G, hd, n = 4, cfg.num_kv_heads, cfg.head_dim, 16384
    Hg = cfg.num_heads // G
    B, m, sink = pcfg.num_subspaces(hd), pcfg.m, pcfg.sink_size
    nc = pcfg.num_centroids()
    C, W = pcfg.candidate_count(n), CC.window_size(pcfg)
    signs = rotation_signs(cfg, dev)
    cache = CC.init_layer_cache(b, n, G, hd, pcfg, torch.bfloat16, dev)
    keys = torch.randn((b, n, G, hd), generator=gen, device=dev)
    cache.k.copy_(keys)
    cache.v.copy_(torch.randn((b, n, G, hd), generator=gen, device=dev))
    meta = E.encode_keys(keys.transpose(1, 2), pcfg, signs)
    for dst, src in zip(cache[2:], meta):
        dst.copy_(src)
    del keys, meta
    enc_end = torch.tensor([ln - 300 - pcfg.local_size for ln in lens],
                           dtype=torch.int32, device=dev)
    pos = enc_end + pcfg.local_size + 150
    q = torch.randn((b, G, Hg, hd), generator=gen, device=dev)
    qt = E.encode_query(q, pcfg, signs)
    nval = int((enc_end - sink).clamp_min(0).sum())
    rows1 = row_tables(b, dev)
    ids = cache.meta_ids

    # 8. the region's bucket histogram: exact at stride 1 (the slot path)
    # and 4 (a hist_sample), at every grid it can launch
    counts = bucket_count(ids, enc_end, sink, nc)
    for stride in (1, 4):
        got = counts if stride == 1 else bucket_count(ids, enc_end, sink, nc,
                                                      stride)
        _check(torch.equal(got, bucket_count_ref(ids, enc_end, sink, nc,
                                                 stride)),
               f"bucket_count differs from its plain version (stride "
               f"{stride})")
    grid = []
    for cl in (1, 2, 4, 8, 16):
        for th in (256, 512):
            def launch(cl=cl, th=th):
                return CO.launch_count(ids, enc_end, sink, nc, 1, cl, th)
            _check(torch.equal(launch(), counts),
                   f"bucket_count at cluster {cl}, {th} threads differs")
            grid.append(dict(cluster=cl, threads=th, blocks=cl * b * G,
                             ms=_time_ms(launch, flush)))
    print("count_grid " + json.dumps(grid), flush=True)
    # the scatter_add_ of the chain it replaced, alone, on its prepared
    # int64 ids and int32 updates
    valid = R.region_mask(n, enc_end, pcfg)[:, None]
    ids_t = ids.transpose(-1, -2).reshape(-1, n).long()
    upd = torch.broadcast_to(valid[..., None, :], (b, G, B, n)).reshape(
        -1, n).to(torch.int32)
    acc = torch.zeros((ids_t.shape[0], nc), dtype=torch.int32, device=dev)
    out["bucket_count"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_count.cu",
        replaces="none: the jnp bucket_histogram of "
                 "src/repro/core/retrieval.py:79 (no TPU kernel)",
        max_abs_err=0, tolerance="exact (stride 1 and 4)",
        cluster=CO.count_cluster(n), threads=CO.COUNT_THREADS,
        ms=_time_ms(lambda: bucket_count(ids, enc_end, sink, nc), flush),
        call_ms=_time_ms(lambda: bucket_count(ids, enc_end, sink, nc), flush,
                         primed=False),
        plain_ms=_time_ms(lambda: bucket_count_ref(ids, enc_end, sink, nc),
                          flush),
        plain="the scatter_add chain the slot path ran: region mask, "
              "broadcast, casts, zeros, transposed int64 ids, scatter_add_",
        plain_call_ms=_time_ms(lambda: bucket_count_ref(ids, enc_end, sink,
                                                        nc), flush,
                               primed=False),
        library_ms=_time_ms(lambda: acc.scatter_add_(1, ids_t, upd), flush),
        library="scatter_add_ alone, on the chain's prepared ids and updates",
        bound=_bound(G * nval * B + b * 4 + counts.numel() * 4,
                     G * nval * B))

    # 5. Stage I over the one-block-per-row table, with seg_hist
    cs = centroids.centroid_scores(qt.q_sub, m)
    n_valid = (enc_end - sink).clamp_min(0)
    tables = R.tier_weight_table(cs, counts[:, :, None],
                                 n_valid[:, None, None], pcfg,
                                 out=lane_packed_table(*cs.shape, device=dev))
    rng_s = R.max_collision_score(pcfg, B)

    def kern():
        return collision_scores_kernel(ids, tables, enc_end, sink, rng_s)

    def plain():
        return collision_paged_ref(ids, rows1, tables, enc_end, sink, rng_s)
    coarse, seg_hist = kern()
    want, want_hist = plain()
    err = max(int((coarse - want).abs().max()),
              int((seg_hist - want_hist).abs().max()))
    _check(err == 0, f"contiguous Stage I differs from its plain version "
           f"({err})")
    out["collision_paged/contiguous"] = dict(
        route="cuda", source="src/repro_torch/csrc/collision_paged.cu",
        replaces="src/repro/kernels/collision/collision.py:83",
        max_abs_err=err, tolerance="exact (scores and seg_hist)",
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        plain_ms=_time_ms(plain, flush), library_ms=None,
        bound=_bound(G * nval * B + tables.numel() + rows1.numel() * 4
                     + b * 4 + coarse.numel() * 4 + seg_hist.numel() * 4,
                     G * nval * B))

    # the slot path's top-C (from seg_hist) and Stage II at these shapes
    cand = bucket_topk(coarse, C, rng_s, seg_hist=seg_hist)
    _check(torch.equal(cand, bucket_topk_ref(coarse, C, rng_s)),
           "bucket_topk differs from its plain version (contiguous)")
    args = (cache.meta_codes, cache.meta_w, rows1, cand,
            qt.q_sub.float().contiguous(), qt.q_norm.float().contiguous(),
            enc_end, sink, pcfg.top_k, m, pcfg.magnitude_bits)
    won, err = _stage2_checks(args, n, "contiguous")
    out["rerank_topk_paged"]["max_abs_err_contiguous"] = err
    phys = won.phys_rows
    _check(torch.equal(phys, won.top_idx + n * rows1[:, :, None, None]),
           "contiguous Stage II rows are not i*n + position")

    # 6. the decode gather over the one-block-per-row table: sink, window
    # and winners in one launch; row 3's window start lies past n - W and
    # clamps, as the slot path clamps it
    ws = (pos + 2 - W).clamp_min(0)
    ws[3] = n - W + 50
    start = ws.clamp(0, n - W).to(torch.int32)

    def kern():
        return gather_decode_paged(cache.k, cache.v, rows1, start, sink, W,
                                   phys)

    def plain():
        return gather_decode_paged_ref(cache.k, cache.v, rows1, start, sink,
                                       W, phys)

    flat_k = cache.k.reshape(b * n, G, hd)
    flat_v = cache.v.reshape(b * n, G, hd)
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      start[:, None] + torch.arange(W, device=dev)], 1)
    rows_d = (rows1.long() * n + lidx)
    rows_h = phys.long()
    heads = torch.arange(G, device=dev)[None, :, None, None]

    def library():
        return (flat_k[rows_d], flat_v[rows_d], flat_k[rows_h, heads],
                flat_v[rows_h, heads])

    got, want = kern(), plain()
    _check(all(torch.equal(x, y) for x, y in zip(got, want))
           and torch.equal(got[0][3, -1], cache.k[3, n - 1]),
           "contiguous decode gather differs from its plain version")
    moved = 2 * sum(t.numel() for t in got) * 2
    out["gather_rows_paged/contiguous"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_paged.cu",
        replaces="src/repro/kernels/gather_kv/gather_kv.py:46",
        max_abs_err=0, tolerance="exact (a window start clamped to n - W)",
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        plain_ms=_time_ms(plain, flush), library_ms=_time_ms(library, flush),
        bound=_bound(moved + phys.numel() * 4 + b * 4 + rows1.numel() * 4, 0))


def _link_rate(dev, nbytes: int = 256 << 20) -> float:
    """The card's pinned host → device copy rate, bytes/s: the median of
    five copies of one ``nbytes`` pinned buffer."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        dst.copy_(src, non_blocking=True)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / 1e3)
    return nbytes / statistics.median(times)


def _tiered_kernel(dev, pool, top_idx, phys, enc_end, sink, gen, flush, out):
    """7. The deduplicating tiered winner gather at the decode shapes: the
    paged pool's rows copied to a pinned host pool, about half of its 512
    blocks staged (the others -1 in dev_map), and every seventh winner a
    -1 row. Output exact, its distinct count over the launch equal to the
    plain version's and to torch.unique's; timed at every grid it can
    launch (tiered_grid). → the tiered setup and link rate, for the fill
    shapes."""
    import torch
    from repro_torch.kernels.gather_kv import gather_heads_tiered
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref)

    nb, bs, G, hd = pool.k.shape
    nd = nb // 2
    host_k = pool.k.reshape(nb * bs, G, hd).cpu().pin_memory()
    host_v = pool.v.reshape(nb * bs, G, hd).cpu().pin_memory()
    staged = torch.randperm(nb, generator=gen, device=dev)[:nd]
    dev_map = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    dev_map[staged] = torch.arange(nd, dtype=torch.int32, device=dev)
    stag_k, stag_v = pool.k[staged].contiguous(), pool.v[staged].contiguous()
    valid = (top_idx >= sink) & (top_idx < enc_end[:, None, None, None])
    valid[..., ::7] = False
    rows = torch.where(valid, phys, -1).to(torch.int32).contiguous()
    tier = (stag_k, stag_v, host_k, host_v, dev_map)
    count = torch.zeros((1,), dtype=torch.int64, device=dev)

    def kern():
        return gather_heads_tiered(*tier, rows, count)

    def plain():
        return gather_heads_tiered_dedup_ref(*tier, rows)

    got, want = kern(), plain()
    _check(all(torch.equal(g, w) for g, w in zip(got, want[:2])),
           "gather_rows_tiered differs from its plain version")
    resident = dev_map[rows.clamp_min(0).long() // bs] >= 0
    missed = ~resident & (rows >= 0)
    heads = torch.arange(G, device=dev)[None, :, None, None]
    n_distinct = int(torch.unique((rows.long() * G + heads)[missed]).numel())
    n_hit = int((resident & (rows >= 0)).sum())
    n_miss = int(missed.sum())
    _check(int(count) == want[2] == n_distinct,
           f"gather_rows_tiered read {int(count)} distinct missed rows, the "
           f"plain version {want[2]}, torch.unique {n_distinct}")
    _check(n_hit > 0 and 0 < n_distinct < n_miss,
           f"{n_hit} staged, {n_miss} missed, {n_distinct} distinct rows")
    grid = []
    for cl in (1, 2, 4, 8, 16):
        for th in (128, 256, 512):
            def launch(cl=cl, th=th):
                return GO.launch_tiered(*tier, rows, None, cl, th)
            _check(all(torch.equal(g, w) for g, w in zip(launch(), want[:2])),
                   f"gather_rows_tiered at cluster {cl}, {th} threads "
                   f"differs")
            grid.append(dict(cluster=cl, threads=th, blocks=cl * G,
                             ms=_time_ms(launch, flush)))
    print("tiered_grid " + json.dumps(grid), flush=True)
    row_b = 2 * hd * pool.k.element_size()          # K and V of a head row
    link = _link_rate(dev)
    hbm_bytes = (n_hit * row_b + rows.numel() * row_b + rows.numel() * 4
                 + nb * 4)
    terms = dict(hbm_ms=hbm_bytes / HBM_BYTES_PER_S * 1e3,
                 link_ms=n_distinct * row_b / link * 1e3)
    out["gather_rows_tiered"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_tiered.cu",
        replaces="src/repro/kernels/gather_kv/ops.py:27",
        max_abs_err=0, tolerance="exact; distinct count exact",
        staged_rows=n_hit, missed_rows=n_miss,
        distinct_missed_rows=n_distinct, zero_rows=int((rows < 0).sum()),
        cluster=GO.tiered_cluster(rows[:, 0].numel()),
        threads=GO.TIERED_THREADS,
        pinned_h2d_gb_per_s=link / 1e9, bound_terms=terms,
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        # the plain version gathers the missed rows on the host: unprimed,
        # so its host work counts
        plain_ms=_time_ms(plain, flush, primed=False), library_ms=None,
        bound=(max(terms.values()), "bytes"))
    return tier, link


def _fill_kernels(dev, cfg, pool, bt, tier, link, gen, flush, out):
    """The chunked fill's kernels at the shapes of the 12,000-token
    request's 24th chunk (frontier 11,776, budget 512) over the kernel
    phase's pool and its table row: the prefix read through the paged
    gather's logical mode, the histogram update (bucket_count's
    block-table mode over the region's 512-position growth), and the
    offloaded engine's prefix read through the tiered gather (about half
    the blocks staged). Each exact against its plain version."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.kernels.collision import bucket_count_span
    from repro_torch.kernels.collision.ref import bucket_count_span_ref
    from repro_torch.kernels.gather_kv import (gather_heads_tiered,
                                               gather_rows_paged)
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref, gather_rows_paged_ref)

    pcfg = cfg.pariskv
    nb, bs, G, hd = pool.k.shape
    B, nc = pool.meta_ids.shape[-1], pcfg.num_centroids()
    start, P = 23 * 512, 512
    row = bt[3:4].contiguous()
    lidx = torch.arange(start, dtype=torch.int32, device=dev)[None]

    def kern():
        return gather_rows_paged(pool.k, pool.v, row, lidx)

    def plain():
        return (gather_rows_paged_ref(pool.k, row, lidx),
                gather_rows_paged_ref(pool.v, row, lidx))
    _check(all(torch.equal(g, w) for g, w in zip(kern(), plain())),
           "gather_rows_paged (fill prefix) differs from its plain version")
    flat_k = pool.k.reshape(nb * bs, G, hd)
    flat_v = pool.v.reshape(nb * bs, G, hd)
    phys = (row.long()[0, lidx[0].long() // bs] * bs + lidx[0] % bs)
    moved = 2 * 2 * start * G * hd * pool.k.element_size()
    out["gather_rows_paged/fill"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_paged.cu",
        replaces="src/repro/kernels/gather_kv/gather_kv.py:87",
        max_abs_err=0, tolerance="exact", rows=start,
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        plain_ms=_time_ms(plain, flush),
        library_ms=_time_ms(lambda: (flat_k[phys], flat_v[phys]), flush),
        library="advanced indexing of the flat pool at the physical rows",
        bound=_bound(moved + start * 4 + row.numel() * 4, 0))

    lo = CC.fill_enc_end(start - P, pcfg)
    hi = CC.fill_enc_end(start, pcfg)
    base = torch.randint(0, 9, (1, G, B, nc), generator=gen, device=dev,
                         dtype=torch.int32)
    got = bucket_count_span(pool.meta_ids, row, lo, hi, nc, base.clone())
    _check(torch.equal(got, base + bucket_count_span_ref(
        pool.meta_ids, row, lo, hi, nc)),
        "bucket_count (fill span) differs from its plain version")
    h = base.clone()
    span_ids = pool.meta_ids.transpose(1, 2).reshape(nb * bs, G, B)[
        row.long()[0, torch.arange(lo, hi, device=dev) // bs] * bs
        + torch.arange(lo, hi, device=dev) % bs]
    ids_t = span_ids.permute(1, 2, 0).reshape(-1, hi - lo).long()
    ones = torch.ones_like(ids_t, dtype=torch.int32)
    acc = torch.zeros((ids_t.shape[0], nc), dtype=torch.int32, device=dev)
    out["bucket_count/fill"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_count.cu",
        replaces="none: the jnp bucket_histogram of "
                 "src/repro/core/cache.py:290 (no TPU kernel)",
        max_abs_err=0, tolerance="exact", span=[lo, hi],
        ms=_time_ms(lambda: bucket_count_span(pool.meta_ids, row, lo, hi, nc,
                                              h), flush),
        plain_ms=_time_ms(lambda: bucket_count_span_ref(pool.meta_ids, row,
                                                        lo, hi, nc), flush),
        library_ms=_time_ms(lambda: acc.scatter_add_(1, ids_t, ones), flush),
        library="scatter_add_ alone, on the span's gathered int64 ids",
        bound=_bound(G * (hi - lo) * B + row.numel() * 4 + 2 * h.numel() * 4,
                     G * (hi - lo) * B))

    stag_k, stag_v, host_k, host_v, dev_map = tier
    idx = lidx[0]
    prow = (row.long()[0, idx.long() // bs] * bs + idx % bs).to(torch.int32)
    rows = prow.view(1, 1, 1, start).expand(1, G, 1, start).contiguous()
    count = torch.zeros((1,), dtype=torch.int64, device=dev)

    def tkern():
        return gather_heads_tiered(*tier, rows, count)

    def tplain():
        return gather_heads_tiered_dedup_ref(*tier, rows)
    want = tplain()
    _check(all(torch.equal(g, w) for g, w in zip(tkern(), want[:2]))
           and int(count) == want[2],
           "gather_rows_tiered (fill prefix) differs from its plain version")
    missed = dev_map[prow.long() // bs] < 0
    n_miss = int(missed.sum())
    row_b = 2 * G * hd * pool.k.element_size()
    terms = dict(hbm_ms=2 * start * row_b / HBM_BYTES_PER_S * 1e3,
                 link_ms=n_miss * row_b / link * 1e3)
    out["gather_rows_tiered/fill"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_tiered.cu",
        replaces="src/repro/kernels/gather_kv/ops.py:27",
        max_abs_err=0, tolerance="exact; distinct count exact", rows=start,
        missed_rows=n_miss, distinct_missed_head_rows=want[2],
        bound_terms=terms,
        ms=_time_ms(tkern, flush),
        plain_ms=_time_ms(tplain, flush, primed=False), library_ms=None,
        bound=(max(terms.values()), "bytes"))


# ---------------------------------------------------------------- engine ---
def _prompts(cfg, seed: int = 0, lens=None):
    """The engines' prompts: random tokens from ``seed``, one per length
    (default: ``PROMPTS``)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in (PROMPTS if lens is None else lens)]


def _check_run(eng, done, n_requests: int, gen: int, launches, kernels,
               cfg, exact=EXACT, fill=None) -> int:
    """Fail unless requests 0 .. n_requests-1 each got ``gen`` tokens, no
    logit was non-finite, and every kernel in ``kernels`` launched at least
    its given count per layer and decode step: those in ``exact`` exactly
    that, the paged gather once plus at most one K-only promotion gather
    per layer and promotion, the histogram pass never. ``fill``: each
    kernel's further launches that a chunked fill needs (its prefix reads
    and histogram updates), added to the counts. → the count of
    non-finite logits (0)."""
    fill = fill or {}
    _check(sorted(done) == list(range(n_requests)), f"served {sorted(done)}")
    for uid, r in done.items():
        _check(len(r.output) == gen, f"request {uid}: {len(r.output)} tokens")
    steps = eng.decode_steps
    for name, per_step in kernels.items():
        need = per_step * cfg.num_layers * steps + fill.get(name, 0)
        _check(launches[name] >= need,
               f"{name}: {launches[name]} launches < {need} "
               f"({per_step} x {cfg.num_layers} layers x {steps} steps)")
    for name in exact:
        if name in kernels:
            need = kernels[name] * cfg.num_layers * steps
            _check(launches[name] == need,
                   f"{name}: {launches[name]} launches, not {kernels[name]} "
                   f"per layer-step ({need})")
    if kernels:
        _check(launches["bucket_hist"] == 0,
               f"bucket_hist launched {launches['bucket_hist']} times: Stage "
               f"I's histograms were not handed to the top-C cut")
    if "gather_rows_paged" in kernels:
        most = cfg.num_layers * (steps + sum(r.promotions
                                             for r in done.values()))
        most += fill.get("gather_rows_paged", 0)
        _check(launches["gather_rows_paged"] <= most,
               f"gather_rows_paged: {launches['gather_rows_paged']} launches "
               f"> {most}: more than one per layer-step and promotion")
    nonfinite = int(eng.nonfinite_logits)
    _check(nonfinite == 0, f"{nonfinite} non-finite logits")
    return nonfinite


def _serve(eng, prompts, gen: int, arrivals, kernels, cfg, audit=False,
           exact=EXACT, fill=None):
    """Serve ``prompts`` (uid = index) submitted before the chunks in
    ``arrivals``, with the launch counters zeroed just before and read just
    after, held to ``_check_run``. → (record, {uid: request})."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import Request

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    eng.decode_steps = 0
    eng.start()
    serve_s, audits, chunk = 0.0, 0, 0
    while chunk <= max(arrivals) or eng.pending():
        for uid, at in enumerate(arrivals):
            if at == chunk:
                eng.submit(Request(uid=uid, prompt=prompts[uid],
                                   max_new_tokens=gen))
        t0 = time.perf_counter()
        eng.step_serve()
        torch.cuda.synchronize()
        serve_s += time.perf_counter() - t0
        if audit:
            eng.verify_hist()
            audits += 1
        chunk += 1
    launches = dict(K.LAUNCHES)
    done = {r.uid: r for r in eng._done}
    steps = eng.decode_steps
    nonfinite = _check_run(eng, done, len(arrivals), gen, launches, kernels,
                           cfg, exact, fill)
    tokens = sum(len(r.output) for r in done.values())
    rec = dict(
        requests=[dict(uid=u, prompt=len(prompts[u]),
                       new_tokens=len(r.output), ttft_s=r.ttft_s,
                       decode_s=r.decode_s, promotions=r.promotions)
                  for u, r in sorted(done.items())],
        admission_gaps_s=_admission_gaps(done),
        decode_steps=steps, serve_s=serve_s, tokens=tokens,
        tokens_per_s=tokens / serve_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        nonfinite_logits=nonfinite, launches=launches)
    if audit:
        rec["hist_checks"] = audits
    return rec, done


def _admission_gaps(done):
    """For each request but the first (by uid): the longest gap between
    two consecutive token stamps of the requests already decoding when it
    was admitted, over the stretch from its admission to its first token.
    A solo prefill stalls them for its whole length; a chunked fill only
    slows their steps."""
    out = []
    for j in sorted(done)[1:]:
        lo, hi = done[j]._t_admit, done[j]._t_first
        gap = 0.0
        for i, r in done.items():
            if i == j or r._t_first > lo:
                continue
            ts = sorted(set(r.token_times))
            gap = max([gap] + [b - a for a, b in zip(ts, ts[1:])
                               if b > lo and a < hi])
        out.append(gap)
    return out


def _warm(eng, cfg, warm: int = 700):
    """One short request (cuBLAS handles, kernel libraries); not measured."""
    from repro_torch.serving import Request
    eng.submit(Request(uid=99, max_new_tokens=4,
                       prompt=_prompts(cfg, seed=99, lens=(warm,))[0]))
    eng.run()


def engine_phase(dev, cfg, params, n_max: int = 16384,
                 num_blocks: int = 512):
    """The main path at full width: four staggered long requests through
    the fused paged engine."""
    from repro_torch.models.model import param_count
    from repro_torch.serving import PagedServingEngine

    eng = PagedServingEngine(cfg, params, n_max=n_max, block_size=128,
                             max_batch=4, num_blocks=num_blocks, chunk_size=8,
                             device=dev)
    _warm(eng, cfg)
    rec, done = _serve(eng, _prompts(cfg), GEN, ARRIVALS, PAGED_KERNELS, cfg,
                       audit=True)
    for uid, r in done.items():
        _check(r.promotions >= 1, f"request {uid} never promoted")
    rec = dict(layers=cfg.num_layers, dtype=cfg.dtype,
               params=param_count(params), **rec)
    print("engine " + json.dumps(rec), flush=True)
    return rec, eng, {u: r.output for u, r in done.items()}


def slot_phase(dev, cfg, params, paged_out, n_max: int = 16384):
    """The contiguous slot engine on the engine phase's four requests."""
    import numpy as np
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, n_max=n_max, max_batch=4, chunk_size=8,
                        device=dev)
    _warm(eng, cfg)
    rec, done = _serve(eng, _prompts(cfg), GEN, ARRIVALS, SLOT_KERNELS, cfg,
                       exact=EXACT + ("bucket_count",))
    for uid, r in done.items():
        _check(r.promotions >= 1, f"request {uid} never promoted")
    if paged_out:
        agree = [float(np.mean(done[u].output == paged_out[u]))
                 for u in sorted(done)]
        rec["token_agreement_with_engine_phase"] = dict(
            per_request=agree, overall=float(np.mean(agree)))
    print("slot " + json.dumps(rec), flush=True)
    return rec, eng


def metaview_phase(dev, cfg, params, n_max: int = 16384, gen: int = 32):
    """The paged meta-view fallback against the fused engine on the first
    two requests: identical tokens asserted."""
    import numpy as np
    from repro_torch.serving import PagedServingEngine

    prompts, arrivals = _prompts(cfg)[:2], ARRIVALS[:2]
    out, recs = {}, {}
    for fused, kernels in ((False, METAVIEW_KERNELS), (True, PAGED_KERNELS)):
        eng = PagedServingEngine(cfg, params, n_max=n_max, block_size=128,
                                 max_batch=4, num_blocks=512, chunk_size=8,
                                 fused=fused, device=dev)
        _warm(eng, cfg)
        recs[fused], done = _serve(eng, prompts, gen, arrivals, kernels, cfg,
                                   audit=True)
        out[fused] = {u: r.output for u, r in done.items()}
        del eng
    same = all(np.array_equal(out[False][u], out[True][u]) for u in out[True])
    rec = dict(metaview=recs[False], fused=recs[True], tokens_identical=same)
    print("metaview " + json.dumps(rec), flush=True)
    _check(same, "meta-view tokens differ from the fused engine's")
    return rec


def _tier_stats(eng, done):
    """The offloaded engine's staging statistics over all requests."""
    import torch
    tot = {k: sum(getattr(r, k) for r in done.values()) for k in (
        "staging_hits", "staging_misses", "fetched_bytes",
        "prefetched_blocks", "prefetch_hits", "fetch_callbacks")}
    hm = tot["staging_hits"] + tot["staging_misses"]
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return dict(tot, miss_share=tot["staging_misses"] / max(hm, 1),
                num_device_blocks=eng.num_device_blocks,
                num_blocks=eng.num_blocks,
                pinned_host_bytes=eng.host.nbytes,
                pinned_host_bytes_held=eng.host.held_bytes,
                host_allocator_bytes=stats.get("allocated_bytes.current"))


def _same_tokens(a, b) -> bool:
    import numpy as np
    return sorted(a) == sorted(b) and all(np.array_equal(a[u], b[u])
                                          for u in a)


def offload_phase(dev, cfg, params, paged_rec, paged_out, n_max: int = 16384):
    """(a) The engine phase's four requests through the offloaded engine
    (staging pool of a quarter of the blocks); (b) one long request
    through the offloaded engine (staging pool 1/8) and the resident
    paged engine."""
    import torch
    from repro_torch.serving import PagedServingEngine

    eng = PagedServingEngine(cfg, params, n_max=n_max, block_size=128,
                             max_batch=4, num_blocks=512,
                             num_device_blocks=128, chunk_size=8,
                             offload=True, device=dev)
    _warm(eng, cfg)
    rec, done = _serve(eng, _prompts(cfg), GEN, ARRIVALS, OFFLOAD_KERNELS,
                       cfg, audit=True)
    tier = _tier_stats(eng, done)
    same = _same_tokens({u: r.output for u, r in done.items()}, paged_out)
    short = dict(rec, **tier, tokens_identical_to_engine_phase=same,
                 resident_engine_phase=dict(
                     tokens_per_s=paged_rec["tokens_per_s"],
                     peak_mem_gb=paged_rec["peak_mem_gb"],
                     ttft_s=[r["ttft_s"] for r in paged_rec["requests"]]))
    print("offload " + json.dumps(short), flush=True)
    _check(same, "offloaded tokens differ from the resident engine's")
    _check(tier["staging_misses"] > 0 and tier["staging_hits"] > 0,
           f"staging hits {tier['staging_hits']}, misses "
           f"{tier['staging_misses']}")
    profile_phase(eng, cfg, "offload")
    del eng
    torch.cuda.empty_cache()

    # overlap on and off (one stream) on the first two requests
    ovl = {}
    for overlap in (True, False):
        eng = PagedServingEngine(cfg, params, n_max=n_max, block_size=128,
                                 max_batch=4, num_blocks=512,
                                 num_device_blocks=128, chunk_size=8,
                                 offload=True, overlap=overlap, device=dev)
        _warm(eng, cfg)
        r, done = _serve(eng, _prompts(cfg)[:2], OVERLAP_GEN, ARRIVALS[:2],
                         OFFLOAD_KERNELS, cfg)
        ovl[overlap] = (r["tokens_per_s"],
                        {u: q.output for u, q in done.items()})
        del eng
    same_ovl = _same_tokens(ovl[True][1], ovl[False][1])
    short["overlap_on_off"] = dict(
        requests=2, new_tokens=OVERLAP_GEN, tokens_identical=same_ovl,
        tokens_per_s={"overlap": ovl[True][0], "one_stream": ovl[False][0]})
    print("offload_overlap " + json.dumps(short["overlap_on_off"]),
          flush=True)
    _check(same_ovl, "overlap=False tokens differ from overlap=True")
    short["miss_duplicates"] = _miss_duplicates(dev, cfg, params, n_max)
    print("offload_duplicates " + json.dumps(short["miss_duplicates"]),
          flush=True)

    # (b): one request past 64k tokens, staging pool 1/8 of the blocks
    n_long = -(-(LONG_PROMPT + LONG_GEN) // 128) * 128
    prompt = _prompts(cfg, seed=5, lens=(LONG_PROMPT,))
    outs, recs = {}, {}
    for name, kw, kernels in (
            ("offloaded", dict(offload=True, num_device_blocks=128),
             OFFLOAD_KERNELS),
            ("resident", {}, PAGED_KERNELS)):
        eng = PagedServingEngine(cfg, params, n_max=n_long, block_size=128,
                                 max_batch=1, num_blocks=1024, chunk_size=8,
                                 device=dev, **kw)
        _warm(eng, cfg)
        recs[name], done = _serve(eng, prompt, LONG_GEN, (0,), kernels, cfg)
        if name == "offloaded":
            recs[name].update(_tier_stats(eng, done))
        outs[name] = {u: r.output for u, r in done.items()}
        del eng
        torch.cuda.empty_cache()
    same = _same_tokens(outs["offloaded"], outs["resident"])
    long_rec = dict(prompt=LONG_PROMPT, new_tokens=LONG_GEN, n_max=n_long,
                    tokens_identical=same, **recs)
    print("offload_long " + json.dumps(long_rec), flush=True)
    _check(same, "long request: offloaded tokens differ from the resident "
           "engine's")
    return short, long_rec


class _TieredTally:
    """While active, every tiered-gather launch (decode winners and fill
    prefixes) is counted on the card before it returns: the missed (row,
    kv head) pairs it was given, how many are distinct (torch.unique),
    and the distinct count the kernel itself reported, which must equal
    torch.unique's at every launch: the kernel read each distinct missed
    row over the link once."""

    def __init__(self):
        self.t = dict(launches=0, fill_launches=0, missed_head_rows=0,
                      distinct_missed_head_rows=0, fill_missed_head_rows=0,
                      fill_distinct_missed_head_rows=0)

    def __enter__(self):
        import torch
        from repro_torch.models import layers as L
        from repro_torch.models import serve as SV
        self._mods = (L, SV)
        real = self._real = L.gather_heads_tiered
        t = self.t

        def counted(stag_k, stag_v, host_k, host_v, dev_map, rows,
                    count=None):
            mine = torch.zeros((1,), dtype=torch.int64, device=rows.device)
            out = real(stag_k, stag_v, host_k, host_v, dev_map, rows, mine)
            if count is not None:
                count += mine
            bs, G = stag_k.shape[1], stag_k.shape[2]
            want = rows.long()
            miss = (want >= 0) & (dev_map.long()[want.clamp_min(0) // bs]
                                  < 0)
            heads = torch.arange(G, device=rows.device)[None, :, None, None]
            key = (want * G + heads)[miss]
            distinct = int(torch.unique(key).numel())
            _check(int(mine) == distinct,
                   f"gather_rows_tiered reported {int(mine)} distinct missed "
                   f"rows, torch.unique {distinct}")
            pre = "fill_" if rows.shape[2] == 1 else ""
            t["launches"] += 1
            t["fill_launches"] += bool(pre)
            t[pre + "missed_head_rows"] += int(key.numel())
            t[pre + "distinct_missed_head_rows"] += distinct
            return out

        for mod in self._mods:
            mod.gather_heads_tiered = counted
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.gather_heads_tiered = self._real


def _miss_duplicates(dev, cfg, params, n_max: int, gen: int = 16):
    """The offload phase's first two requests once more, untimed, under
    ``_TieredTally``: the missed winner head rows, how many repeat one
    already read in the same launch (several query heads of a kv head
    picking the same row), and the check that the kernel read each
    distinct one once and the engine counted exactly those."""
    import torch
    from repro_torch.serving import PagedServingEngine

    eng = PagedServingEngine(cfg, params, n_max=n_max, block_size=128,
                             max_batch=4, num_blocks=512,
                             num_device_blocks=128, chunk_size=8,
                             offload=True, device=dev)
    with _TieredTally() as tally:
        _, done = _serve(eng, _prompts(cfg)[:2], gen, ARRIVALS[:2],
                         OFFLOAD_KERNELS, cfg)
    t = tally.t
    missed = t["missed_head_rows"]
    _check(t["launches"] > 0 and missed > 0,
           f"no missed winner rows counted: {t}")
    _check(eng.host.fetched_unique_head_rows
           == t["distinct_missed_head_rows"],
           f"engine counted {eng.host.fetched_unique_head_rows} distinct "
           f"rows, the launches {t['distinct_missed_head_rows']}")
    head_b = eng.host.bytes_per_head_row(eng._names[0])
    uniq_b = sum(r.fetched_unique_bytes for r in done.values())
    del eng
    torch.cuda.empty_cache()
    return dict(t, requests=2, new_tokens=gen,
                fetched_unique_bytes=uniq_b,
                distinct_bytes=t["distinct_missed_head_rows"] * head_b,
                duplicate_share=1 - t["distinct_missed_head_rows"] / missed)


def baseline_phase(dev, cfg, params, n_max: int = 16384, gen: int = 32):
    """ParisKV slots, full-attention slots and ParisKV waves on two
    requests of 3000/6000 prompt tokens submitted together."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import (Request, ServingEngine,
                                     WaveServingEngine)

    prompts = _prompts(cfg, seed=3, lens=PROMPTS[:2])
    res, outs = {}, {}
    for name, use_pariskv in (("pariskv_slots", True),
                              ("full_attention_slots", False)):
        eng = ServingEngine(cfg, params, n_max=n_max, max_batch=4,
                            chunk_size=8, use_pariskv=use_pariskv,
                            device=dev)
        _warm(eng, cfg)
        kernels = SLOT_KERNELS if use_pariskv else {}
        res[name], done = _serve(eng, prompts, gen, (0, 0), kernels, cfg)
        outs[name] = {u: r.output for u, r in done.items()}
        if not use_pariskv:
            _check(sum(res[name]["launches"].values()) == 0,
                   "the full-attention baseline launched ParisKV kernels")
        del eng
    wave = WaveServingEngine(cfg, params, n_max=n_max, max_batch=4,
                             device=dev)
    for uid, p in enumerate(prompts):
        wave.submit(Request(uid=uid, prompt=p, max_new_tokens=gen))
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    done = {r.uid: r for r in wave.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    _check_run(wave, done, len(prompts), gen, launches, SLOT_KERNELS, cfg)
    outs["pariskv_wave"] = {u: r.output for u, r in done.items()}
    tokens = sum(len(r.output) for r in done.values())
    res["pariskv_wave"] = dict(
        ttft_s=done[0].ttft_s, decode_steps=wave.decode_steps,
        serve_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        launches=launches)
    # per request: the wave's shorter prompt attends to its left pad, so
    # only the longest request is the same computation as in the slots
    agree = {name: [float(np.mean(outs[name][u] == outs["pariskv_slots"][u]))
                    for u in sorted(outs[name])] for name in outs}
    rec = dict(note="host-bound smoke throughputs on a shared host, not a "
               "benchmark", prompts=list(PROMPTS[:2]), new_tokens=gen,
               tokens_per_s={k: v["tokens_per_s"] for k, v in res.items()},
               token_agreement_with_pariskv_slots=agree, runs=res)
    print("baseline " + json.dumps(rec), flush=True)
    return rec


def profile_phase(eng, cfg, path: str, seed: int = 2, prompt: int = 2000,
                  gen: int = 40):
    """Where a decode step's time goes: one chunk of the engine (four
    active rows, same n_max) under torch.profiler, after an unprofiled
    chunk for the wall time (``_profile_chunk``)."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.RandomState(seed)
    for uid in range(4):
        eng.submit(Request(uid=100 + uid, max_new_tokens=gen,
                           prompt=rng.randint(0, cfg.vocab_size, size=(
                               prompt,)).astype(np.int32)))
    eng.start()
    eng.step_serve()                      # admissions + first chunk
    rec = dict(path=path, rows=4, **_profile_chunk(eng))
    while eng.pending():
        eng.step_serve()
    print("profile " + json.dumps(rec), flush=True)
    return rec


def _profile_chunk(eng):
    """One unprofiled chunk for the wall time, then one chunk under
    torch.profiler: wall and device-busy time per step (busy = union of
    the kernels' intervals), kernel launches and host-device copies per
    step, the top kernels, the port's kernels' device time per step, and
    the port's launch counts per step (``LAUNCHES`` over the profiled
    chunk)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_serve()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / eng.chunk_size
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step_serve()
        torch.cuda.synchronize()
    ours_n = {k: v / eng.chunk_size for k, v in K.LAUNCHES.items() if v}
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    avg = prof.key_averages()
    launches = sum(e.count for e in avg if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    copies = sum(e.count for e in avg if e.key == "cudaMemcpyAsync")
    kernels = sorted(((e.key, e.self_device_time_total) for e in avg
                      if e.self_device_time_total > 0 and e.device_type
                      == DeviceType.CUDA), key=lambda kv: -kv[1])[:8]
    # the port's own kernels, by their function names in csrc/
    ours = {name: sum(e.self_device_time_total for e in avg
                      if f"{name}_kernel" in e.key
                      and e.device_type == DeviceType.CUDA) / eng.chunk_size
            for name in K.KERNELS}
    return dict(steps=eng.chunk_size, wall_ms_per_step=wall_ms,
                device_busy_ms_per_step=busy / 1e3 / eng.chunk_size,
                device_idle_share=1 - busy / 1e3 / eng.chunk_size / wall_ms,
                launches_per_step=launches / eng.chunk_size,
                memcpy_per_step=copies / eng.chunk_size,
                top_kernels_us_per_step=[
                    (k[:60], v / eng.chunk_size) for k, v in kernels],
                port_kernels_us_per_step={k: v for k, v in ours.items()
                                          if v},
                port_launches_per_step=ours_n)


# --------------------------------------------------------------- chunked ---
def _fill_counts(cfg, prompts, budget: int):
    """The launches a chunked fill of ``prompts`` adds on a paged pool, all
    layers: prefix reads (every chunk but the first) and histogram
    updates (every chunk whose region growth is not empty)."""
    from repro_torch.core import cache as CC
    pcfg = cfg.pariskv
    reads = spans = 0
    for n in map(len, prompts):
        for f0 in range(0, n, budget):
            f1 = min(n, f0 + budget)
            reads += f0 > 0
            spans += (CC.fill_enc_end(f1, pcfg)
                      > max(CC.fill_enc_end(f0, pcfg), pcfg.sink_size))
    return cfg.num_layers * reads, cfg.num_layers * spans


def _per_request(rec, done, paged_out):
    """TTFT, admission gaps and (when the engine phase ran) token
    agreement with it, per request."""
    import numpy as np
    out = dict(ttft_s=[r["ttft_s"] for r in rec["requests"]],
               admission_gaps_s=rec["admission_gaps_s"],
               tokens_per_s=rec["tokens_per_s"])
    if paged_out:
        out["token_agreement_with_engine_phase"] = [
            float(np.mean(done[u].output == paged_out[u]))
            for u in sorted(done)]
    return out


def chunked_phase(dev, cfg, params, paged_out, paged_rec,
                  n_max: int = 16384, budget: int = CHUNK_BUDGET):
    """Chunked prefill (prefill_budget=512) at full width: (a) the paged
    engine, (b) the slot engine and (c) the offloaded engine on the engine
    phase's four requests, (d) float32 identity of chunked and solo
    tokens on every engine at 2 layers, (e) a profile of mixed steps."""
    import torch
    from repro_torch.serving import PagedServingEngine, ServingEngine

    prompts = _prompts(cfg)
    reads, spans = _fill_counts(cfg, prompts, budget)
    common = dict(n_max=n_max, max_batch=4, chunk_size=8,
                  prefill_budget=budget, device=dev)
    paged_kw = dict(block_size=128, num_blocks=512, **common)
    rec = {}
    # (a) the paged engine
    eng = PagedServingEngine(cfg, params, **paged_kw)
    _warm(eng, cfg)
    r, done = _serve(eng, prompts, GEN, ARRIVALS, PAGED_KERNELS, cfg,
                     fill=dict(gather_rows_paged=reads, bucket_count=spans))
    _check(r["launches"]["bucket_count"] == spans,
           f"bucket_count: {r['launches']['bucket_count']} launches, the "
           f"fill's histogram updates need {spans}")
    paged = {u: q.output for u, q in done.items()}
    rec["paged"] = dict(r, **_per_request(r, done, paged_out))
    if paged_rec:
        rec["paged"]["solo_engine_phase"] = dict(
            ttft_s=[q["ttft_s"] for q in paged_rec["requests"]],
            admission_gaps_s=paged_rec["admission_gaps_s"],
            tokens_per_s=paged_rec["tokens_per_s"])
    print("chunked_paged " + json.dumps(rec["paged"]), flush=True)
    rec["profile"] = _mixed_profile(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    # (b) the slot engine
    eng = ServingEngine(cfg, params, **common)
    _warm(eng, cfg)
    r, done = _serve(eng, prompts, GEN, ARRIVALS, SLOT_KERNELS, cfg,
                     exact=EXACT + ("bucket_count",))
    rec["slot"] = dict(r, **_per_request(r, done, paged_out))
    rec["slot"]["tokens_identical_to_chunked_paged"] = _same_tokens(
        {u: q.output for u, q in done.items()}, paged)
    print("chunked_slot " + json.dumps(rec["slot"]), flush=True)
    del eng
    torch.cuda.empty_cache()
    # (c) the offloaded engine, every tiered gather checked
    eng = PagedServingEngine(cfg, params, offload=True, num_device_blocks=128,
                             **paged_kw)
    _warm(eng, cfg)
    with _TieredTally() as tally:
        r, done = _serve(eng, prompts, GEN, ARRIVALS, OFFLOAD_KERNELS, cfg,
                         fill=dict(gather_rows_tiered=reads,
                                   bucket_count=spans))
    host, t = eng.host, tally.t
    same = _same_tokens({u: q.output for u, q in done.items()}, paged)
    G = cfg.num_kv_heads
    uniq_b = (host.fetched_unique_head_rows
              * host.bytes_per_head_row(eng._names[0])
              + host.fetched_unique_fill_rows
              * host.bytes_per_row(eng._names[0]))
    rec["offload"] = dict(
        r, **_tier_stats(eng, done), **_per_request(r, done, paged_out),
        tokens_identical_to_chunked_paged=same, tally=t,
        fetched_fill_rows=host.fetched_fill_rows,
        fetched_unique_fill_rows=host.fetched_unique_fill_rows,
        fetched_unique_head_rows=host.fetched_unique_head_rows,
        # the requests' share of the distinct bytes; rows of a free slot
        # (frozen regions, table row -1) also read, as in the reference,
        # and their bytes are shared by no request
        fetched_unique_bytes=sum(q.fetched_unique_bytes
                                 for q in done.values()),
        distinct_bytes=uniq_b,
        note="every tiered gather checked on the card (a sync per "
             "launch): tokens/s not comparable")
    print("chunked_offload " + json.dumps(rec["offload"]), flush=True)
    _check(same, "chunked offloaded tokens differ from the chunked paged "
           "engine's")
    _check(host.fetched_fill_rows > 0, "no fill prefix row came from host "
           "memory")
    _check(host.fetched_unique_head_rows == t["distinct_missed_head_rows"]
           and G * host.fetched_unique_fill_rows
           == t["fill_distinct_missed_head_rows"],
           f"the engine's distinct rows ({host.fetched_unique_head_rows}, "
           f"fill {host.fetched_unique_fill_rows}) differ from the "
           f"kernel's distinct reads {t}")
    del eng
    torch.cuda.empty_cache()
    rec["f32_identity"] = _f32_identity(dev, cfg)
    return rec


def _mixed_profile(eng, cfg, gen: int = 64):
    """(e) Mixed steps under the profiler: three 2,000-token requests fill
    and decode, then a 12,000-token request fills; its second chunk of
    fill after the first (eight mixed steps, each reading a prefix and
    updating the histogram beside three decoding rows) is timed, the next
    profiled. Fails unless every layer of every profiled step launched the
    fill's prefix read (gather_rows_paged beside the decode gather) and
    its histogram update (bucket_count)."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.RandomState(8)
    for uid, (n, g) in enumerate(((2000, gen), (2000, gen), (2000, gen),
                                  (12000, 8))):
        eng.submit(Request(uid=200 + uid, max_new_tokens=g,
                           prompt=rng.randint(0, cfg.vocab_size, size=(
                               n,)).astype(np.int32)))
    eng.start()
    while eng.pending() and (eng._filling is None
                             or eng._slots[eng._filling].uid != 203):
        eng.step_serve()                  # ends after its first chunk
    rec = dict(path="chunked paged, mixed steps", rows=4, fill_rows=1,
               **_profile_chunk(eng))
    while eng.pending():
        eng.step_serve()
    per = rec["port_launches_per_step"]
    L = cfg.num_layers
    print("profile " + json.dumps(rec), flush=True)
    _check(per.get("gather_rows_paged", 0) >= 2 * L
           and per.get("bucket_count", 0) == L,
           f"mixed steps launched {per} per step: not the fill's prefix "
           f"read and histogram update in every layer")
    return rec


def _f32_identity(dev, cfg_full, budget: int = 256, gen: int = 16):
    """(d) 2 layers at full width in float32 on the card: chunked and solo
    prefill give identical tokens on the paged, slot and offloaded
    engines (three staggered requests of 1,500/2,500/3,500 tokens, fills
    spanning several chunks and completing mid-chunk; the offloaded
    engine stages 40 of 128 blocks)."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine, ServingEngine

    cfg = dataclasses.replace(cfg_full, num_layers=2, dtype="float32")
    params = init_params(cfg, seed=4, device=dev)
    prompts = _prompts(cfg, seed=6, lens=(1500, 2500, 3500))
    common = dict(n_max=4096, max_batch=4, chunk_size=4, device=dev)
    paged = dict(block_size=128, num_blocks=128, **common)
    engines = (("paged", PagedServingEngine, paged),
               ("slot", ServingEngine, common),
               ("offload", PagedServingEngine,
                dict(offload=True, num_device_blocks=40, **paged)))
    rec = {}
    for name, cls, kw in engines:
        outs = {}
        for b in (0, budget):
            eng = cls(cfg, params, prefill_budget=b, **kw)
            _, done = _serve(eng, prompts, gen, (0, 1, 2), {}, cfg,
                             audit=name != "slot")
            outs[b] = {u: q.output for u, q in done.items()}
            if name == "offload" and b:
                rec["offload_fetched_fill_rows"] = eng.host.fetched_fill_rows
            del eng
        rec[name] = _same_tokens(outs[0], outs[budget])
    torch.cuda.empty_cache()
    print("chunked_f32 " + json.dumps(dict(
        layers=2, dtype="float32", prompts=[1500, 2500, 3500],
        new_tokens=gen, prefill_budget=budget,
        chunked_tokens_identical_to_solo=rec)), flush=True)
    _check(all(rec[n] for n, _, _ in engines),
           f"float32 chunked tokens differ from solo: {rec}")
    _check(rec["offload_fetched_fill_rows"] > 0,
           "float32 offload: no fill prefix row came from host memory")
    return rec


# ---------------------------------------------------------------- parity ---
def _teacher_forced(params, cfg, prompt, forced, device, paged: bool):
    """Prefill + ``len(forced)`` decode steps fed the given tokens, through
    the paged pool (a reversed block table) or a contiguous slot. →
    (logits (steps, vocab) on the CPU, per step and layer the candidate
    and winner index tensors)."""
    import numpy as np
    import torch
    from repro_torch.models import serve as SV

    n_max, bs, nb = 4096, 128, 40
    logits0, st1 = SV.prefill(params, cfg, prompt[None], n_max,
                              lengths=[len(prompt)], device=device)
    bt = None
    if paged:
        state = SV.init_paged_slot_state(cfg, 1, nb, bs, device=device)
        nblk = n_max // bs
        need = -(-(len(prompt) + len(forced)) // bs)
        row = np.full((nblk,), nb, np.int32)
        row[:need] = np.arange(need)[::-1]      # reversed: non-trivial table
        bt = torch.from_numpy(np.where(row < nb, row, -1)[None].astype(
            np.int32)).to(device)
        SV.admit_paged(state, 0, torch.from_numpy(row), st1.caches,
                       st1.regions, int(forced[0]), len(forced), cfg.pariskv)
    else:
        state = SV.init_slot_state(cfg, 1, n_max, device=device)
        SV.admit_slot(state, 0, st1.caches, st1.regions, int(forced[0]),
                      len(forced))
    logits, records = [], []
    ss = SV.ServeState(state.caches, state.regions)
    for t in range(len(forced)):
        rec = []
        tok = torch.tensor([int(forced[t])], dtype=torch.int32, device=device)
        lg, ss = SV.decode_step(params, cfg, tok, ss, bt, record=rec)
        logits.append(lg[0].float().cpu())
        records.append([(r.cand_indices.cpu(), r.indices.cpu()) for r in rec])
    return torch.stack(logits), records


def _parity(name, lg_dev, rec_dev, lg_cpu, rec_cpu, prompt_len):
    import torch
    per_step = (lg_dev - lg_cpu).abs().amax(-1)
    same_c = same_w = total = 0
    agree = []                  # steps where every winner set is identical
    for step_d, step_c in zip(rec_dev, rec_cpu):
        all_w = True
        for (cd, wd), (cc, wc) in zip(step_d, step_c):
            heads_c = (cd == cc).all(-1).flatten()
            heads_w = (wd.sort(-1).values == wc.sort(-1).values
                       ).all(-1).flatten()
            same_c += int(heads_c.sum())
            same_w += int(heads_w.sum())
            total += heads_c.numel()
            all_w &= bool(heads_w.all())
        agree.append(all_w)
    agree = torch.tensor(agree)
    absmax = float(lg_cpu.abs().max())
    flip_tol = PARITY_FLIP_RTOL * absmax
    err_agree = float(per_step[agree].max()) if agree.any() else 0.0
    err_flip = float(per_step[~agree].max()) if (~agree).any() else 0.0
    rec = dict(path=name, layers=2, dtype="float32", prompt=prompt_len,
               steps=len(rec_dev), logit_absmax=absmax,
               steps_all_winners_identical=int(agree.sum()),
               max_abs_logit_err_identical_winners=err_agree,
               atol_identical_winners=PARITY_ATOL,
               max_abs_logit_err_other_steps=err_flip,
               atol_other_steps=flip_tol,
               candidate_sets_identical=f"{same_c}/{total}",
               winner_sets_identical=f"{same_w}/{total}")
    print("parity " + json.dumps(rec), flush=True)
    _check(bool(agree[0]), f"{name}: first decode step already retrieves "
           f"other winners on the card than on the CPU")
    _check(err_agree <= PARITY_ATOL,
           f"{name}: logits differ by {err_agree} > {PARITY_ATOL} at a step "
           f"whose winner sets all agree")
    _check(err_flip <= flip_tol,
           f"{name}: logits differ by {err_flip} > {flip_tol} after a "
           f"winner flip")
    return rec


def parity_phase(dev, cfg_full, seed: int = 1, prompt_len: int = 2048,
                 steps: int = 64):
    import numpy as np
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(cfg_full, num_layers=2, dtype="float32")
    params = init_params(cfg, seed=seed, device="cpu")
    params_dev = {k: ([{n: ({w: t.to(dev) for w, t in v.items()}
                            if isinstance(v, dict) else v.to(dev))
                        for n, v in layer.items()} for layer in val]
                      if k == "layers" else val.to(dev))
                  for k, val in params.items()}
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, size=(prompt_len,)).astype(
        np.int32)
    forced = rng.randint(0, cfg.vocab_size, size=(steps,)).astype(np.int32)
    out = []
    for name, paged in (("paged", True), ("contiguous", False)):
        lg_dev, rec_dev = _teacher_forced(params_dev, cfg, prompt, forced,
                                          dev, paged)
        lg_cpu, rec_cpu = _teacher_forced(params, cfg, prompt, forced, "cpu",
                                          paged)
        out.append(_parity(name, lg_dev, rec_dev, lg_cpu, rec_cpu,
                           prompt_len))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch import configs
        from repro_torch import kernels as K
        from repro_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing ({exc}); run from "
              f"the repository root", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phases = ("kernels", "engine", "slot", "metaview", "baseline", "offload",
              "chunked", "parity")
    only = sys.argv[1:] or list(phases)
    unknown = sorted(set(only) - set(phases))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; known: {phases}",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    build.build_all()
    print("build " + json.dumps({"seconds": time.perf_counter() - t0}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print("kernels " + " ".join(K.KERNELS), flush=True)

    cfg = configs.get("qwen2-1.5b")
    kern = kernel_phase(dev, cfg) if "kernels" in only else {}
    params = None
    if {"engine", "slot", "metaview", "baseline", "offload",
            "chunked"} & set(only):
        from repro_torch.models.model import init_params
        params = init_params(cfg, seed=0, device=dev)
    launches = {}             # kernel → launches on the first path using it
    paged_out = eng = None
    if "engine" in only or "offload" in only:
        eng, engine, paged_out = engine_phase(dev, cfg, params)
        profile_phase(engine, cfg, "paged")
        del engine
        launches.update({k: eng["launches"][k]
                         for k in (*PAGED_KERNELS, "bucket_hist")})
    if "slot" in only:
        slot, engine = slot_phase(dev, cfg, params, paged_out)
        profile_phase(engine, cfg, "slot")
        del engine
        for k in (*SLOT_KERNELS, "bucket_hist"):
            launches.setdefault(k, slot["launches"][k])
        # the contiguous routes of the TPU kernels #5 and #6
        for k in ("collision_paged", "gather_rows_paged"):
            launches[f"{k}/contiguous"] = slot["launches"][k]
    if "metaview" in only:
        metaview_phase(dev, cfg, params)
    if "baseline" in only:
        baseline_phase(dev, cfg, params)
    if "offload" in only:
        off, _ = offload_phase(dev, cfg, params, eng, paged_out)
        launches.setdefault("gather_rows_tiered",
                            off["launches"]["gather_rows_tiered"])
    if "chunked" in only:
        ch = chunked_phase(dev, cfg, params, paged_out, eng)
        # the fill's kernels: their launches in the chunked runs (paged:
        # prefix reads beside the decode gathers, and the histogram updates
        # alone; offloaded: the tiered gathers, fill and decode)
        launches["gather_rows_paged/fill"] = ch["paged"]["launches"][
            "gather_rows_paged"]
        launches["bucket_count/fill"] = ch["paged"]["launches"][
            "bucket_count"]
        launches["gather_rows_tiered/fill"] = ch["offload"]["launches"][
            "gather_rows_tiered"]
    if "parity" in only:
        parity_phase(dev, cfg)
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    summary = [dict(name=name, **{k: ({**rec, "launches": launches.get(
        name)})[k] for k in keys}) for name, rec in kern.items()]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
