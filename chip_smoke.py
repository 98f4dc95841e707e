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
              distinct count must equal torch.unique's, it is timed over
              a sweep of its grid (blocks per kv head × threads:
              tiered_grid), its bound prices the distinct missed bytes at
              the card's pinned host-to-device rate, measured here with
              one 256 MiB copy, and tiered_probe says where its time goes
              (every block staged; every entry missed at four sizes, with
              the link's scattered-read rate fitted; the bulk copy).
              The chunked fill's kernels are held and timed at the
              12,000-token request's 24th chunk: the prefix read (the
              paged gather's logical mode, and the tiered gather with
              half the blocks staged) and the histogram update
              (bucket_count's block-table mode), and a shared-prefix
              admission's histogram rebuild at the share phase's shape
              (the same mode over [sink, 7,680) through a table row of
              64 blocks, -1 past them). Stage I and the top-C cut are also checked on an all-tie
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
              report (registers, shared memory, spills) of the six
              kernels designed for Hopper is printed.
4. engine   — the main path: ``PagedServingEngine`` (fused retrieval)
              serving qwen2-1.5b at full width cut to 8 of its 28 layers
              (the script's time limit; bf16, random weights from a seed;
              every serving phase through 11 uses this model) to four
              staggered requests of ~3k/6k/9k/12k prompt tokens and 264
              new tokens each. Launch counters are zeroed just before and
              read just after; each kernel of the path must have launched
              at least layers × decode steps times (Stage II exactly that,
              the paged gather at most one more per layer and promotion),
              every request must promote, and the
              incremental histograms must equal a recompute at every chunk.
   profile  — then one decode chunk of the same engine (four rows) under
              torch.profiler: wall and device-busy time per step, kernel
              launches and host-device copies per step, the top kernels.
              The slot phase ends with the same profile of its engine.
5. slot     — the contiguous ``ServingEngine`` on the same four requests:
              the region's histogram, Stage I, top-C and Stage II each
              launched exactly layers × steps, the decode gather layers ×
              steps plus at most layers per promotion, the histogram pass
              never;
              every request promoted, token agreement with the engine
              phase printed as a rate (bf16 promises no identity).
6. metaview — ``PagedServingEngine(fused=False)`` and the fused engine on
              the first two requests with 8 new tokens: identical tokens
              asserted, Stage I over the view launched exactly layers ×
              steps.
7. baseline — the slot engine with ParisKV and with full attention
              (``use_pariskv=False``), and ``WaveServingEngine``, on
              requests of 3000/6000 prompt tokens with 8 new each: host-
              bound smoke throughputs, not a benchmark.
8. offload  — ``PagedServingEngine(offload=True)``: (a) the engine phase's
              four requests with the K/V pool in pinned host memory and a
              staging pool of a quarter of its blocks; tokens identical to
              the engine phase's asserted, staging misses and hits > 0,
              the tiered gather launched layers × steps; tokens/s, TTFT, peak
              device memory, pinned bytes, fetched bytes, miss share and
              prefetch hits printed beside the resident run's, then a
              profile of one chunk; the first two requests (8 new) with
              overlap on and off, identical tokens asserted; the same two
              (8 new) once more, untimed, counting in every tiered-gather
              launch the missed winner head rows, how many repeat a row
              already read in that launch, and asserting that the kernel
              read each distinct one once (``offload_duplicates``). (b)
              one request of 16,384 prompt tokens and 16 new through the
              offloaded engine (staging pool 1/8 of 1024 blocks) and the
              resident paged engine: identical tokens asserted, peak
              memory and TTFT printed.
9. chunked  — chunked prefill (``prefill_budget=512``) at full width on
              the engine phase's four requests with 16 new tokens each
              (token agreement with the engine phase over those): (a)
              the paged engine, (b) the slot engine on the first two
              of them, (c) the offloaded engine (128 of 512
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
10. share   — prefix sharing (``share_prefixes=True``, budget 512) at full
              width on four requests with one 8,192-token system prompt
              and suffixes of 256/384/512/200 tokens, 16 new each,
              all submitted at chunk 0: (a) the paged engine with sharing
              on, then off: per request TTFT and mapped blocks, the
              sharers' mean TTFT, blocks drawn from the pool, tokens/s and
              peak memory; each sharer maps 64 blocks (192 hits), sharing
              draws fewer blocks, ``verify_invariants()`` holds at every
              chunk boundary, the pool drains, each shared admission
              launches bucket_count once per layer and the first one's
              rebuilt histograms equal the plain version's in every
              layer. (b) the meta view on the first two requests (16
              new). (c) the offloaded engine with sharing on, then off
              (128 of 512 staged, every tiered gather checked): tokens
              identical to (a)'s run with the same sharing, staging
              drained, miss share and link bytes printed. (d) 2 layers
              in float32 (prefix 2,048, four requests): sharing, chunked
              and solo tokens identical on the fused, meta-view and
              offloaded engines.
11. faults  — fault handling at full width (bf16) on the offloaded engine
              (128 of 512 blocks staged) with the first two requests, 16
              new each: a clean run, then fetch delays, transient
              failures retried, a hung fetch past a 0.25 s deadline with
              the overlap on and off, every fetch failing from the second
              chunk on (degraded attention), ``engine.slot`` failing uid 0
              (quarantine) and staging storms, each audited with
              ``verify_invariants()`` at every chunk; and a chunked run
              (budget 512, four requests, 16 new) whose fill prefix
              reads all exhaust their retries. Tokens equal the
              clean run's where the contract says so (the survivor's
              under quarantine); the degraded runs complete, and every
              degraded tiered launch reads zero host rows; no
              ``kv-fetch*`` thread survives ``close()``. Prints tokens/s
              against the clean run, stall, retries, timeouts, degraded
              steps and storm evictions, and the degraded run's token
              agreement.
12. sharded — head-sharded paged serving: stablelm-1.6b (32 KV heads of
              64) over two ranks on the one card (``launch_local``, gloo:
              NCCL refuses two ranks on one device). First its four
              kernels at a rank's shapes (16 KV heads, Hg 1, B 8), held to
              their plain versions and timed. (a) 24 layers, bf16, seed 0:
              ``PagedServingEngine(mesh_shards=2)`` and the same engine on
              one device (this process) on the engine phase's first two
              requests with 16 new tokens each: each side's tokens/s, each
              rank's pool bytes (asserted half the one-device pool's) and
              the bf16 token agreement; every rank's launches held as the
              engine phase's; at one decode step of all four requests
              admitted together, each rank's Stage I
              scores, top-C set, Stage II winners, estimates and rows and
              its decode gather's K/V rows equal the one-device outputs'
              slice of its heads exactly (SHA-256 per layer and field).
              (b) 2 layers in float32: tokens identical to one device's
              with the fused engine, the meta view, chunked prefill
              (budget 256) and prefix sharing (a 2,048-token prefix).
13. arch    — the architectures beyond qwen2 and stablelm, at full width:
              (d) the four main-path kernels at grok-1's shapes (G 8, Hg
              6, hd 128, B 16), held and timed as in the sharded phase;
              (c) one grok-1 MoE layer in float32 (8 experts of 6144 ×
              32768), card against CPU: a 64-token moe_fwd and a 4-row
              moe_decode, routing equal wherever the top-2 gap exceeds
              1e-5 (flips printed with their gaps), outputs within 1e-4
              + 1e-4 · |out| where routing agrees; (a) grok-1 (bf16, seed
              0) cut to 4 of its 64 layers, what one card holds (~41 GB
              of weights), through the fused paged engine on the engine
              phase's four requests with 264 new tokens: every request
              promotes, launches held as the engine phase's, tokens/s,
              TTFT, pool bytes and peak memory printed; (b) llama3.1-8b
              at full width and depth (32 layers, ~16 GB) on requests of
              6,000 and 12,000 tokens with 16 new, the same reports.
14. gemma   — gemma's local/global layers (sliding-window ring buffers
              beside the paged pool), run it alone with ``python3
              chip_smoke.py gemma``: (a) the four main-path kernels and
              ``bucket_count`` at gemma3-12b's shapes (G 8, Hg 2, hd 256,
              B 32: the first shapes past B = 16), held and timed as in
              the sharded phase, the "g3" rows; (b) gemma3-12b at full
              width cut to 12 of its 48 layers (2 periods: 10 local with a
              1,024-token window, 2 global; qk-norm; bf16, seed 0; the
              script's time limit, not memory) through the fused
              paged engine on requests of 6,000 and 12,000 tokens with
              264 new: pool bytes, ring bytes, peak memory, tokens/s and
              TTFT, launches held per global layer-step, ``bucket_count``
              launched at admission, every request promotes (B = 32
              encodes and histogram adds); (c) gemma2-27b at full width cut to
              8 of its 46 layers (4 local/global periods; full depth's
              54 GB of weights, pool and rings leave no room for a
              16,384-token prefill) on the engine phase's four requests
              with 264 new: every request promotes on its global layers;
              (d) gemma3 at one period (6 layers) in float32: chunked and
              solo tokens identical on the paged, slot and offloaded
              engines for requests of 1,500/2,500/3,500 tokens, which wrap
              the window (the ring fill's prefix read and its wrap).
15. cross   — the cross-attention architectures, run it alone with
              ``python3 chip_smoke.py cross``: (a) the four main-path
              kernels and ``bucket_count`` at whisper-large-v3's shapes (G
              20, the first KV-head count that is not a power of two; Hg
              1, hd 64, B 8), held and timed as in the sharded phase, the
              "w" rows; (b) whisper-large-v3 at full width cut to 8 of its
              32 decoder layers (the time limit), each with a cross
              sublayer, its 32 encoder layers whole over 1,500 stub frames
              a request; bf16, seed 0) through the
              fused paged engine on the engine phase's four requests with
              264 new: every request promotes (B = 8 encodes at G = 20),
              pool and media bytes (the latter exact), peak memory,
              tokens/s and TTFT, launches held as the engine phase's; (c)
              llama-3.2-vision-11b at full width and depth (40 layers, a
              gated cross layer every 5th over 1,600 patch embeddings) on
              requests of 6,000 and 12,000 tokens with 16 new, its cross
              gates seeded non-zero; (d) float32 at full width, card
              against CPU: whisper's encoder at one layer, whisper's
              cross sublayer and a vision cross layer for one decode
              step, each within 1e-4 of the output's largest magnitude.
              Head sharding of these families is held on the CPU only.
16. ssm     — the state-space architectures, run it alone with ``python3
              chip_smoke.py ssm``: (a) the four main-path kernels and
              ``bucket_count`` at hymba-1.5b's shapes (G 5, Hg 5: the
              first odd Hg above 1, 5 of the tier table's 8 byte lanes;
              hd 64, B 8), held and timed as in the sharded phase, the "h"
              rows; (b) hymba-1.5b at full width cut to 8 of its 32
              hybrid layers (the time limit), each 0.5 · (ParisKV
              attention + an SSD mixer of 50 heads of 64 with state 16),
              then an MLP; bf16, seed 0) through the fused paged engine
              on the engine phase's four requests with 264 new: every
              request promotes, launches held as the engine phase's, SSM
              state bytes exactly 4 slots × 8 layers × (50·64·16·4 +
              3·3232·2), pool bytes, peak memory,
              tokens/s and TTFT printed; (c) mamba2-780m at full width and
              depth (48 SSD layers of 48 heads of 64, state 128; no
              attention, no KV cache) through the slot engine on requests
              of 6,000 and 12,000 tokens with 32 new: no ParisKV kernel
              launches, SSM state bytes exactly 4 × 48 × (48·64·128·4 +
              3·3328·2); (d) float32 at full width, card against CPU: one
              hymba layer's prefill over four LEFT-aligned rows of up to
              512 tokens and one decode step after it, one mamba2 mixer's
              ``ssm_prefill`` and ``ssm_decode``, each within 1e-4 of the
              output's largest magnitude. Head sharding of hymba is held
              on the CPU only.
17. mla     — deepseek-v2-lite's multi-head latent attention, run it
              alone with ``python3 chip_smoke.py mla``: (a) the "m"
              rows at its decode shapes (one 576-wide bf16 latent a
              token shared by Hg 16 query heads, G 1, B 128, score range
              768, four slots of 16,384, C 1,311): Stage I in its wide
              mode (a 16-lane tier table staged 16 subspaces at a time),
              the cut over 770 bins, Stage
              II with its top-k at B = 128 (its bound priced on the
              distinct (row, position) candidates, the bound over every
              head's printed beside it), the K-only decode gather and
              ``bucket_count`` at B = 128, each held to its plain version
              and timed beside its library call, and the ptxas report of
              the wide instantiations (``ptxas_wide``); (b)
              deepseek-v2-lite-16b at full width and depth (27 layers:
              layer 0 a dense MLP, 26 with 64 routed experts top-6 and 2
              shared; bf16, seed 0) through the slot engine, 4 slots of
              16,384, on requests of 6,000 and 12,000 tokens with 264
              new: Stage I, the cut, Stage II and ``bucket_count``
              launched exactly 27 × steps, the gather 27 × steps plus at
              most 27 per promotion, every request promoting, the latent
              and metadata bytes exactly 2,038,431,744 each, no pool;
              tokens/s, TTFT and peak memory printed; (c) float32 at full
              width, card against CPU: one MLA layer's prefill of two
              2,048-token prompts and four decode steps retrieving over
              the latent (within 1e-4 of the output's magnitude where
              every winner set agrees), and one 64-expert MoE layer,
              routing flips printed with their top-2 gaps. The paged,
              offloaded and sharded engines refuse deepseek (CPU tests).
18. baselines — the paper's comparison code over one head of 131,072
              keys of 128 (seeded Gaussians) on the card: MagicPIG's
              SimHash tables (L 10, K 10) and PQCache at its defaults (64
              coarse clusters, 16 sub-codebooks of 256, fitted on 32,768
              keys, 8 probed): build and retrieve times at top-k 1,024
              with CUDA events, beside ``exact_topk``'s; each method's
              ``recall_at_k`` against ``exact_topk``; card against CPU on
              the same inputs: signatures, assignments and PQ codes from
              the card's fitted centroids, every method's ids from the same
              tables and book, each equal but at a float near tie within
              1e-5 of its scale (a projection's distance from 0, a
              squared-distance gap, a score gap; printed). No ParisKV
              kernel launches.
19. train   — (a) qwen2-1.5b at full width and depth (28 layers, bf16,
              random weights from seed 0): 8 ``train_step``s (remat,
              AdamW, peak lr 3e-4, warm-up 1) on one fixed batch of 4 ×
              1,024 tokens from ``make_batch``: every loss finite, every
              grad norm > 0, the last loss below the first, no ParisKV
              kernel launched; per-step seconds, tokens/s and peak memory
              printed; (b) float32 at full width cut to 2 layers, batch 2
              × 256, card against CPU from the same params: the loss and
              every gradient (within 5e-5 of its leaf's largest), then 3
              steps at peak lr 1e-3 (loss, grad norm and lr within 1e-5
              relative, params within 1e-5 where the gradient exceeds
              1e-3 of its leaf's largest): the CPU tests' bars; (c) (b)'s
              trained params through ``save_checkpoint`` and
              ``load_checkpoint`` (the reference's npz format), bit for
              bit.
20. dryrun  — the capacity planner (``python -m repro_torch.launch.dryrun``,
              on meta tensors, nothing allocated): (a) one line per
              architecture at full width and depth: a rank's known GB
              (arguments, and gradients for train) and whether they fit
              this card (a lower bound), for every input shape and
              layout (gspmd; seq_shards and head_shards for decode, or
              "refused" where the port refuses them) on one card and on
              (data=1, model=4) and (data=1, model=8); (b) the FLOPs of
              the train phase's step (qwen2-1.5b at full depth, 4 × 1,024
              tokens, remat; ``FlopCounterMode``) and, after the train
              phase, its TFLOP/s from that phase's median step; (c)
              grounding: the engine phase's qwen2-1.5b (8 layers, 4
              slots, n_max 16,384, 512 blocks of 128) built on the card,
              the growth of ``memory_allocated()`` from its params and
              the engine's state within 1 % of the planner's params plus
              state bytes, then one decode step served.
21. parity  — 2 layers at full width in float32: one teacher-forced
              request (2048-token prompt, 64 given tokens) through the
              paged and the contiguous decode step, each on the card
              (kernels) and on the CPU (plain versions); logits must agree
              at every step, within 1e-3 where every winner set agrees and
              within 5 % of the largest logit after a near-tie winner flip.
22. seqshard — the sequence-sharded contiguous decode
              (``decode_step(dist=SeqShardDist)``) of qwen2-1.5b at full
              width and the serving phases' 8 layers, batch 1, over two
              gloo ranks of the one card: one ``prefill`` here of a
              262,144-token prompt (``INPUT_SHAPES["long_500k"]``'s
              524,288 cut to fit the time limit; n_max 262,656), each
              rank handed its shard (``seq_shard_state``: the positions
              [r·n_loc, (r+1)·n_loc) of every ParisKV store, shared from
              this process), then 264 teacher-forced new tokens (one
              promotion at step 256) on the ranks and, from the same state,
              on one device. First the gather's rank-masked mode (row 6
              "q") at layer 0's shapes: equal to its plain version, to the
              unmasked decode gather on each rank's rows and zeros
              elsewhere, summed over the ranks to the whole gather, and
              timed. Checks: the ranks' logits and winners equal bit for
              bit at every step; at every layer of steps 0, 128, 256 and
              263 the ranks' local and merged winners equal the per-shard
              retrieve and merge replayed here on the shards without a
              collective (exact); the ranks launch collision_paged,
              bucket_count, bucket_topk and rerank_topk_paged once a
              layer-step and gather_rows_paged once more a promotion;
              each rank holds half the ParisKV bytes, exactly the
              capacity planner's ``seq_shards`` reckoning. Prints the
              prefill time, bytes per rank and one device's, tokens/s of
              the ranks
              and of one device, each collective's bytes a layer-step
              (``launch.mesh.collective_plan``),
              the share of steps whose greedy token equals one device's,
              the winners' overlap with one device's (layer 0, whose
              query and keys both runs share, apart from the deeper
              layers) and layer 0's recall of the exact top-k for both.

Pass phase names to run a subset (``python3 chip_smoke.py kernels slot``).
Before them, ``phase_seconds`` gives each phase's wall seconds. The last
two lines are the kernels' JSON summary and the result line.
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
# the engines' phases serve qwen2-1.5b at full width cut to 8 of its 28
# layers: the script's time limit (on a slow host the whole script took
# 1,359 s of the 1,200 allowed with all 28, and 1,023 s with 16 before the
# baselines and train phases)
QWEN_LAYERS = 8
PROMPTS = (3000, 6000, 9000, 12000)      # the four requests of the engines
# their new tokens: every request must promote, and its first promotion
# comes at decode step 257 (update_interval + 1)
GEN = 264
ARRIVALS = (0, 2, 4, 6)                  # chunk before each submission
# the kernel phase's rows: the four requests after 300 new tokens, fixed
# so that its shapes stay comparable between runs
KERNEL_NEW = 300
LENS_AFTER = [p + KERNEL_NEW for p in PROMPTS]
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
LONG_PROMPT, LONG_GEN = 16384, 16        # the offload phase's long request
OVERLAP_GEN = 8                          # the offload overlap and
#                                          duplicate-count runs
CHUNK_BUDGET = 512                       # the chunked phase's prefill_budget
CHUNK_GEN = 16                           # and its new tokens
# the share phase's fleet: one system prompt of 64 blocks of 128, then
# distinct suffixes, SHARE_GEN new tokens each, all submitted at chunk 0
SHARE_PREFIX = 8192
SHARE_SUFFIXES = (256, 384, 512, 200)
SHARE_GEN = 16
FAULT_GEN = 16                           # the faults phase's new tokens
FAULT_CHUNKED_GEN = 16                   # and in its chunked run (g)
# the sharded phase: stablelm-1.6b (32 KV heads) over two ranks of one
# card, the engine phase's first two requests with 16 new tokens (the
# retrieval probe admits all four); its float32 part
SHARDS = 2
SHARD_ARCH = "stablelm-1.6b"
SHARD_GEN = 16
SHARD_REQUESTS = 2                       # of the engine phase's, in (a)
SHARD_F32_LENS = (1500, 2500, 3500)
SHARD_F32_GEN = 16
SHARD_F32_BUDGET = 256
SEQ_SHARDS = 2                 # the seqshard phase's gloo ranks on one card
SEQ_CONTEXT = "long_500k"      # its context: INPUT_SHAPES[SEQ_CONTEXT]
SEQ_LEN = 262_144              # cut from 524,288: the time limit (PERF.md §4)
SEQ_HEADROOM = 512             # n_max = SEQ_LEN + this
SEQ_GEN = 264                  # promotes at step 256
SEQ_SAMPLES = (0, 128, 256, 263)   # replayed steps; 256 promotes
# the arch phase: grok-1 at full width cut to the depth one card holds (4 of
# 64 layers, ~41 GB of bf16 weights) on the engine phase's requests, and
# llama3.1-8b at full width and depth on two of them
GROK_ARCH = "grok-1-314b"
GROK_LAYERS = 4
LLAMA_ARCH = "llama3.1-8b"
LLAMA_LENS = (6000, 12000)
LLAMA_GEN = 16
# the gemma phase: gemma3-12b cut to GEMMA3_LAYERS on LLAMA_LENS, gemma2-27b
# cut to 4 of its 23 local/global periods on the engine phase's requests,
# both with the engine phase's GEN new tokens so that every request
# promotes (at gemma3's head_dim 256: B = 32 encodes and histogram adds),
# and gemma3 at one period (its 6 layers) in float32
GEMMA3_ARCH, GEMMA2_ARCH = "gemma3-12b", "gemma2-27b"
GEMMA2_LAYERS = 8
GEMMA3_LAYERS = 12        # 2 of its 8 periods: the time limit, not memory
# the cross phase: whisper-large-v3 at full width, WHISPER_LAYERS decoder and
# 32 encoder layers over 1,500 stub frames, on the engine phase's requests
# with GEN new tokens, every request promoting (G = 20 KV heads, B = 8), and
# llama-3.2-vision-11b at full depth on LLAMA_LENS with LLAMA_GEN, its cross
# gates seeded non-zero (zero at init, tanh(0) = 0, the cross layers would
# add nothing); card against CPU in float32 at full width: one encoder
# layer, one cross decode step of each family, held to CROSS_RTOL of the
# output's largest magnitude
WHISPER_ARCH, VISION_ARCH = "whisper-large-v3", "llama-3.2-vision-11b"
WHISPER_LAYERS = 8        # of 32 decoder layers: the time limit
CROSS_ROWS = 4
CROSS_RTOL = 1e-4
# the ssm phase: hymba-1.5b at full width and HYMBA_LAYERS on the engine
# phase's requests with GEN new tokens, every request promoting (G = 5 KV
# heads, Hg = 5, B = 8), and mamba2-780m at full width and depth through
# the slot engine on LLAMA_LENS with MAMBA_GEN (no KV cache: no ParisKV
# launch);
# card against CPU in float32 at full width: one hymba layer's prefill of
# SSM_F32_LEN tokens (LEFT-aligned rows of SSM_F32_LENS) and one decode
# step, one mamba2 mixer's ssm_prefill and ssm_decode, held to CROSS_RTOL
# of the output's largest magnitude
HYMBA_ARCH, MAMBA_ARCH = "hymba-1.5b", "mamba2-780m"
HYMBA_LAYERS = 8          # of 32: the time limit
MAMBA_GEN = 32
SSM_F32_LEN = 512
SSM_F32_LENS = (512, 448, 384, 320)
# the mla phase: deepseek-v2-lite at full width and depth (27 MLA layers,
# one dense, 26 with 64 routed experts top-6 and 2 shared) through the slot
# engine on MLA_LENS with MLA_GEN new tokens (the least that promotes);
# card against CPU in float32 at full width: one MLA layer's prefill of
# MLA_F32_ROWS prompts of MLA_F32_LEN tokens and MLA_F32_STEPS decode steps
# retrieving over the latent, held to CROSS_RTOL of the output's largest
# magnitude where every winner set agrees, and one 64-expert MoE layer
DEEPSEEK_ARCH = "deepseek-v2-lite-16b"
MLA_LENS = (6000, 12000)
MLA_GEN = 264
MLA_F32_ROWS, MLA_F32_LEN, MLA_F32_STEPS = 2, 2048, 4
# grok-1's MoE layer (the arch phase; deepseek's in the mla phase) in
# float32, card against CPU: a 64-token moe_fwd and a 4-row moe_decode.
# Sums over d_ff = 32,768 reassociate (~1e-5 at outputs of ~5); routing
# may differ only at a top-2 gap within float32 rounding
MOE_TOKENS, MOE_ROWS = 64, 4
MOE_ATOL = MOE_RTOL = 1e-4
MOE_GAP = 1e-5
# the baselines phase: the paper's comparison points over one head of
# BASE_KEYS keys of 128 (seeded Gaussians) on the card, MagicPIG at L = 10
# tables of K = 10 bits, PQCache at its defaults, top-k BASE_TOP_K; card
# against CPU on the same inputs, where an integer output may differ only
# at a float near tie within BASE_NOISE of the values' scale
BASE_KEYS, BASE_DIM, BASE_TOP_K = 131_072, 128, 1024
BASE_NOISE = 1e-5
# the train phase: (a) qwen2-1.5b at full width and depth in its dtype,
# TRAIN_STEPS steps of remat training on one fixed batch of TRAIN_BATCH ×
# TRAIN_SEQ; (b) float32 at full width cut to 2 layers, card against CPU,
# with the CPU tests' bars (tests/test_torch_train.py): loss, grad norm
# and lr within 1e-5 relative, each gradient within TRAIN_GRAD_RTOL of its
# leaf's largest, params within TRAIN_PARAM_ATOL (1 % of the lr) where
# the gradient exceeds TRAIN_GRAD_FLOOR of its leaf's largest
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 1024, 3e-4
# the dryrun phase's GPU meshes: one card, and (data=1, model=m) for these m
PLAN_MODEL_AXES = (1, 4, 8)
TRAIN_F32_BATCH, TRAIN_F32_SEQ, TRAIN_F32_STEPS = 2, 256, 3
TRAIN_F32_LR = 1e-3
TRAIN_RTOL, TRAIN_GRAD_RTOL = 1e-5, 5e-5
TRAIN_PARAM_ATOL, TRAIN_GRAD_FLOOR = 1e-5, 1e-3
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
    # four rows of ~3k..12k prompt + KERNEL_NEW tokens; unallocated tails
    # are -1
    lens = LENS_AFTER
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((b, nblk), -1, dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(lens):
        need = -(-ln // bs)
        bt[i, :need] = perm[used:used + need]
        used += need
    enc_end = torch.tensor([ln - KERNEL_NEW - pcfg.local_size for ln in lens],
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
    _share_kernel(dev, cfg, pool, gen, flush, out)
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        print(f"kernel {name} " + json.dumps(rec), flush=True)
    return out


def _ptxas(B: int, nc: int, Hg: int, rng: int, n: int, C: int,
           k: int) -> None:
    """Registers, shared memory and spills of the six kernels designed for
    Hopper, from nvcc's -Xptxas -v logs, with the dynamic shared memory
    each launch asks for at these shapes (their launchers' formulas; the
    tiered gather's over the kernel phase's 512 blocks of 128 rows, G 2)."""
    import torch
    from repro_torch.kernels import SEG_LEN
    from repro_torch.kernels import build
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.rerank import ops as RO
    nseg = -(-n // SEG_LEN)
    dyn = {"collision_paged": B * nc * 8 + Hg * rng * 4,
           "bucket_hist": 8 * rng * 4,
           "bucket_topk": (rng + 2 * (nseg + 1) + 2) * 4,
           "rerank_topk_paged": RO.smem_bytes(C, B, k),
           "gather_rows_paged": 0, "bucket_count": B * nc * 4,
           "gather_rows_tiered": GO.tiered_plan(
               512 * 128, 2, build.sm_count(torch.device("cuda")))[
               "smem_bytes"]}
    for source in ("collision_paged", "bucket_topk", "rerank_topk_paged",
                   "gather_rows_paged", "bucket_count", "gather_rows_tiered"):
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
    enc_end = torch.tensor([ln - KERNEL_NEW - pcfg.local_size for ln in lens],
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
    plain version's and to torch.unique's; timed over a sweep of its grid
    (tiered_grid) and probed (``_tiered_probe``). → the tiered setup and
    link rate, for the fill shapes."""
    import torch
    from repro_torch.kernels import build as KB
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
    for per_head in (8, 33, 66, 132, 264):
        for th in (256, 512):
            def launch(per_head=per_head, th=th):
                return GO.launch_tiered(*tier, rows, None, per_head, th)
            _check(all(torch.equal(g, w) for g, w in zip(launch(), want[:2])),
                   f"gather_rows_tiered at {per_head} blocks a kv head, "
                   f"{th} threads differs")
            grid.append(dict(blocks_per_head=per_head, threads=th,
                             blocks=per_head * G,
                             ms=_time_ms(launch, flush)))
    print("tiered_grid " + json.dumps(grid), flush=True)
    row_b = 2 * hd * pool.k.element_size()          # K and V of a head row
    link = _link_rate(dev)
    ms = _time_ms(kern, flush)
    _tiered_probe(dev, pool, tier, rows, ms, n_distinct * row_b, link, gen,
                  flush)
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
        plan=GO.tiered_plan(nb * bs, G, KB.sm_count(dev)),
        pinned_h2d_gb_per_s=link / 1e9, bound_terms=terms,
        ms=ms, call_ms=_time_ms(kern, flush, primed=False),
        # the plain version gathers the missed rows on the host: unprimed,
        # so its host work counts
        plain_ms=_time_ms(plain, flush, primed=False), library_ms=None,
        bound=(max(terms.values()), "bytes"))
    return tier, link


def _tiered_probe(dev, pool, tier, rows, row7_ms, link_bytes, link, gen,
                  flush):
    """Where the tiered gather's time goes at row 7's shape, its inputs
    changed and nothing else: (a) every block staged, so no link traffic:
    the fixed cost around the copy; (b) every entry missed, each (row, kv
    head) once, at 1, 2, 4 and 8 batch rows: a line fitted through the
    times gives the rate of scattered head-row reads over the link (its
    slope) and the fixed cost (its intercept); (c) row 7 as it is (its
    time, ``row7_ms``); (d) the pinned bulk copy rate, and one bulk copy
    of (c)'s distinct bytes.
    Prints one ``tiered_probe`` line."""
    import torch
    from repro_torch.kernels.gather_kv import gather_heads_tiered
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref)

    stag_k, stag_v, host_k, host_v, _ = tier
    nb, bs, G, hd = pool.k.shape
    row_b = 2 * hd * pool.k.element_size()
    every = torch.arange(nb, dtype=torch.int32, device=dev)
    probe = dict(a_all_staged_ms=_time_ms(lambda: gather_heads_tiered(
        pool.k, pool.v, host_k, host_v, every, rows), flush))
    none = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    b, _, Q, k = rows.shape
    series = []
    for nrow in (1, 2, 4, 8):
        picks = torch.stack([torch.randperm(nb * bs, generator=gen,
                                            device=dev)[:nrow * Q * k]
                             for _ in range(G)])
        miss = picks.view(G, nrow, Q, k).transpose(0, 1).to(
            torch.int32).contiguous()
        args = (stag_k[:1].contiguous(), stag_v[:1].contiguous(), host_k,
                host_v, none, miss)
        got, want = gather_heads_tiered(*args), \
            gather_heads_tiered_dedup_ref(*args)
        _check(all(torch.equal(g, w) for g, w in zip(got, want[:2])),
               f"gather_rows_tiered (all missed, {nrow} rows) differs")
        series.append(dict(head_rows=miss.numel(),
                           bytes=miss.numel() * row_b,
                           ms=_time_ms(lambda a=args: gather_heads_tiered(*a),
                                       flush)))
    xs = [s["bytes"] for s in series]
    ys = [s["ms"] for s in series]
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    probe.update(b_all_missed=series,
                 b_fit=dict(fixed_ms=my - slope * mx,
                            gb_per_s=1e-6 / slope),
                 c_row7_ms=row7_ms)
    src = torch.empty(link_bytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(link_bytes, dtype=torch.uint8, device=dev)
    probe.update(d_bulk_gb_per_s=link / 1e9, d_copy_bytes=link_bytes,
                 d_copy_ms=_time_ms(lambda: dst.copy_(src, non_blocking=True),
                                    flush))
    print("tiered_probe " + json.dumps(probe), flush=True)


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


def _share_kernel(dev, cfg, pool, gen, flush, out):
    """8s. A shared-prefix admission's histogram rebuild, one layer
    (``core/cache.py:bucket_hist_from_paged_meta``: bucket_count's
    block-table mode into a zeroed row) at the share phase's shape: the
    8,192-token prefix's region [sink, fill_enc_end(8192)) through a
    128-entry table row of 64 random pool blocks, -1 past them. Exact
    against its plain version; timed beside it, beside the span launch
    alone and beside ``scatter_add_`` on the span's gathered ids."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.kernels.collision import bucket_count_span
    from repro_torch.kernels.collision.ref import bucket_count_span_ref

    pcfg = cfg.pariskv
    nb, bs, G, _ = pool.k.shape
    B, nc = pool.meta_ids.shape[-1], pcfg.num_centroids()
    nblk, nshared = 16384 // bs, SHARE_PREFIX // bs
    row = torch.full((nblk,), -1, dtype=torch.int32, device=dev)
    row[:nshared] = torch.randperm(nb, generator=gen, device=dev)[
        :nshared].to(torch.int32)
    lo, hi = pcfg.sink_size, CC.fill_enc_end(SHARE_PREFIX, pcfg)

    def kern():
        return CC.bucket_hist_from_paged_meta(pool, row, hi, pcfg)

    def plain():
        return bucket_count_span_ref(pool.meta_ids, row[None], lo, hi, nc)
    got, want = kern(), plain()[0]
    _check(torch.equal(got, want), "bucket_count (shared-prefix rebuild) "
           "differs from its plain version")
    _check(int(want.sum()) == G * B * (hi - lo), "the rebuild did not count "
           "every position of the shared region")
    h = torch.zeros((1, G, B, nc), dtype=torch.int32, device=dev)
    lidx = torch.arange(lo, hi, device=dev)
    ids_t = pool.meta_ids.transpose(1, 2).reshape(nb * bs, G, B)[
        row.long()[lidx // bs] * bs + lidx % bs].permute(1, 2, 0).reshape(
        -1, hi - lo).long()
    ones = torch.ones_like(ids_t, dtype=torch.int32)
    acc = torch.zeros((ids_t.shape[0], nc), dtype=torch.int32, device=dev)
    out["bucket_count/share"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_count.cu",
        replaces="none: the jnp bucket_histogram of "
                 "src/repro/core/cache.py:656 (bucket_hist_from_paged_meta; "
                 "no TPU kernel)",
        max_abs_err=0, tolerance="exact", span=[lo, hi],
        table_entries=nblk, shared_blocks=nshared,
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        span_launch_ms=_time_ms(lambda: bucket_count_span(
            pool.meta_ids, row[None], lo, hi, nc, h), flush),
        plain_ms=_time_ms(plain, flush),
        library_ms=_time_ms(lambda: acc.scatter_add_(1, ids_t, ones), flush),
        library="scatter_add_ alone, on the span's gathered int64 ids",
        bound=_bound(G * (hi - lo) * B + row.numel() * 4 + want.numel() * 4,
                     G * (hi - lo) * B))


# ---------------------------------------------------------------- engine ---
def _prompts(cfg, seed: int = 0, lens=None):
    """The engines' prompts: random tokens from ``seed``, one per length
    (default: ``PROMPTS``)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in (PROMPTS if lens is None else lens)]


def _check_run(eng, done, n_requests: int, gen: int, launches, kernels,
               cfg, exact=EXACT, fill=None, failed=()) -> int:
    """Fail unless requests 0 .. n_requests-1 each got ``gen`` tokens (those
    in ``failed`` instead were quarantined), no
    logit was non-finite, and every kernel in ``kernels`` launched at least
    its given count per layer and decode step: those in ``exact`` exactly
    that, the paged gather once plus at most one K-only promotion gather
    per layer and promotion, the histogram pass never. ``fill``: each
    kernel's further launches that a chunked fill needs (its prefix reads
    and histogram updates), added to the counts. → the count of
    non-finite logits (0)."""
    fill = fill or {}
    n_layers = _retrieval_layers(cfg)
    _check(sorted(done) == list(range(n_requests)), f"served {sorted(done)}")
    for uid, r in done.items():
        if uid in failed:
            _check(r.failed, f"request {uid} was not quarantined")
            continue
        _check(len(r.output) == gen and not r.failed,
               f"request {uid}: {len(r.output)} tokens, failed={r.failed}")
    steps = eng.decode_steps
    for name, per_step in kernels.items():
        need = per_step * n_layers * steps + fill.get(name, 0)
        _check(launches[name] >= need,
               f"{name}: {launches[name]} launches < {need} "
               f"({per_step} x {n_layers} layers x {steps} steps)")
    for name in exact:
        if name in kernels:
            need = kernels[name] * n_layers * steps
            _check(launches[name] == need,
                   f"{name}: {launches[name]} launches, not {kernels[name]} "
                   f"per layer-step ({need})")
    if kernels:
        _check(launches["bucket_hist"] == 0,
               f"bucket_hist launched {launches['bucket_hist']} times: Stage "
               f"I's histograms were not handed to the top-C cut")
    if "gather_rows_paged" in kernels:
        most = n_layers * (steps + sum(r.promotions for r in done.values()))
        most += fill.get("gather_rows_paged", 0)
        _check(launches["gather_rows_paged"] <= most,
               f"gather_rows_paged: {launches['gather_rows_paged']} launches "
               f"> {most}: more than one per layer-step and promotion")
    nonfinite = int(eng.nonfinite_logits)
    _check(nonfinite == 0, f"{nonfinite} non-finite logits")
    return nonfinite


def _retrieval_layers(cfg) -> int:
    """The layers that run ParisKV retrieval, and so the kernels, in every
    decode step: the pool's layers (all of them but gemma's sliding-window
    local layers, which decode densely over their ring buffers, and
    llama-vision's cross layers, which attend to static media K/V) and
    deepseek's MLA layers, which retrieve over their latent."""
    from repro_torch.models.model import layer_defs
    from repro_torch.models.serve import pool_layers
    return sum(pool_layers(cfg)) + sum(ld.mixer == "mla"
                                       for ld in layer_defs(cfg))


def _serve(eng, prompts, gen: int, arrivals, kernels, cfg, audit=False,
           exact=EXACT, fill=None, failed=(), media=None):
    """Serve ``prompts`` (uid = index) submitted before the chunks in
    ``arrivals``, with the launch counters zeroed just before and read just
    after, held to ``_check_run``. ``audit``: the engine's
    ``verify_invariants()`` (allocator, refcounts, tables, prefix index,
    staging, histograms == recompute) at every chunk boundary; the
    audit's own launches are not counted. ``media``: each request's
    media (the cross-attention architectures). → (record, {uid:
    request})."""
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
                                   max_new_tokens=gen,
                                   media=None if media is None
                                   else media[uid]))
        t0 = time.perf_counter()
        eng.step_serve()
        torch.cuda.synchronize()
        serve_s += time.perf_counter() - t0
        if audit:
            before = dict(K.LAUNCHES)
            eng.verify_invariants()
            K.LAUNCHES.update(before)
            audits += 1
        chunk += 1
    launches = dict(K.LAUNCHES)
    done = {r.uid: r for r in eng._done}
    steps = eng.decode_steps
    nonfinite = _check_run(eng, done, len(arrivals), gen, launches, kernels,
                           cfg, exact, fill, failed)
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
                       prompt=_prompts(cfg, seed=99, lens=(warm,))[0],
                       media=_media(cfg, 1, seed=99)[0]))
    eng.run()


def _media(cfg, n: int, seed: int = 0):
    """``n`` requests' stub media (``data.media_stub``, seed + uid), each
    (T, d) float32, for the cross-attention architectures; Nones for the
    rest."""
    from repro_torch.data import media_stub
    from repro_torch.models.serve import media_len
    T = media_len(cfg)
    return [media_stub(1, T, cfg.d_model, seed=seed + i)[0] if T else None
            for i in range(n)]


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
    rec = dict(layers=cfg.num_layers, full_layers=28, dtype=cfg.dtype,
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


def metaview_phase(dev, cfg, params, n_max: int = 16384, gen: int = 8):
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
    short["miss_duplicates"] = _miss_duplicates(dev, cfg, params, n_max,
                                                OVERLAP_GEN)
    print("offload_duplicates " + json.dumps(short["miss_duplicates"]),
          flush=True)

    # (b): one request past the engine phase's lengths, staging pool 1/8
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
    row over the link once.

    With ``host`` (an offloaded engine's ``HostKVPool``) its fetch policy
    is watched too: a launch after a fetch that gave up is a degraded
    launch, and its distinct missed rows (those it read from host memory)
    are summed apart; they must be 0."""

    def __init__(self, host=None):
        self.t = dict(launches=0, fill_launches=0, missed_head_rows=0,
                      distinct_missed_head_rows=0, fill_missed_head_rows=0,
                      fill_distinct_missed_head_rows=0)
        self._host = host
        self._gave_up = False
        if host is not None:
            self.t.update(failed_fetches=0, degraded_launches=0,
                          degraded_distinct_missed_head_rows=0)

    def __enter__(self):
        import torch
        from repro_torch.models import layers as L
        from repro_torch.models import serve as SV
        self._mods = (L, SV)
        real = self._real = L.gather_heads_tiered
        t = self.t
        if self._host is not None:
            attempt = self._host.fetch_attempt

            def watched(name, kind):
                out = attempt(name, kind)
                # a fill's first chunk reads no prefix: its fetch has no
                # launch, and the next fetch overwrites the flag
                self._gave_up = not out[0]
                t["failed_fetches"] += not out[0]
                return out
            self._host.fetch_attempt = watched

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
            if self._gave_up:
                t["degraded_launches"] += 1
                t["degraded_distinct_missed_head_rows"] += distinct
                self._gave_up = False
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
        if self._host is not None:
            del self._host.fetch_attempt


def _miss_duplicates(dev, cfg, params, n_max: int, gen: int):
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


def baseline_phase(dev, cfg, params, n_max: int = 16384, gen: int = 8):
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
    chunk for the wall time (``_profile_chunk``); the requests are
    cancelled once profiled."""
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
    for r in eng._slots:                 # profiled: the rest is not needed
        if r is not None:
            eng.cancel(r.uid)
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
def _fill_counts(cfg, prompts, budget: int, starts=None):
    """The launches a chunked fill of ``prompts`` adds on a paged pool, all
    layers: prefix reads (every chunk that starts past 0) and histogram
    updates (every chunk whose region growth is not empty). ``starts``:
    each fill's first frontier (a sharer's mapped prefix; default 0)."""
    from repro_torch.core import cache as CC
    pcfg = cfg.pariskv
    reads = spans = 0
    for n, s0 in zip(map(len, prompts), starts or [0] * len(prompts)):
        for f0 in range(s0, n, budget):
            f1 = min(n, f0 + budget)
            reads += f0 > 0
            spans += (CC.fill_enc_end(f1, pcfg)
                      > max(CC.fill_enc_end(f0, pcfg), pcfg.sink_size))
    n_layers = _retrieval_layers(cfg)
    return n_layers * reads, n_layers * spans


def _per_request(rec, done, paged_out):
    """TTFT, admission gaps and (when the engine phase ran) token
    agreement with it, per request."""
    import numpy as np
    out = dict(ttft_s=[r["ttft_s"] for r in rec["requests"]],
               admission_gaps_s=rec["admission_gaps_s"],
               tokens_per_s=rec["tokens_per_s"])
    if paged_out:      # over the tokens both runs emitted
        out["token_agreement_with_engine_phase"] = [
            float(np.mean(done[u].output
                          == paged_out[u][:len(done[u].output)]))
            for u in sorted(done)]
    return out


def chunked_phase(dev, cfg, params, paged_out, paged_rec,
                  n_max: int = 16384, budget: int = CHUNK_BUDGET):
    """Chunked prefill (prefill_budget=512) at full width: (a) the paged
    engine and (c) the offloaded engine on the engine phase's four
    requests, (b) the slot engine on the first two, (d) float32 identity
    of chunked and solo tokens on every engine at 2 layers, (e) a profile
    of mixed steps."""
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
    r, done = _serve(eng, prompts, CHUNK_GEN, ARRIVALS, PAGED_KERNELS, cfg,
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
    # (b) the slot engine, on the first two requests
    eng = ServingEngine(cfg, params, **common)
    _warm(eng, cfg)
    r, done = _serve(eng, prompts[:2], CHUNK_GEN, ARRIVALS[:2], SLOT_KERNELS,
                     cfg, exact=EXACT + ("bucket_count",))
    rec["slot"] = dict(r, **_per_request(r, done, paged_out))
    rec["slot"]["tokens_identical_to_chunked_paged"] = _same_tokens(
        {u: q.output for u, q in done.items()}, {u: paged[u] for u in done})
    print("chunked_slot " + json.dumps(rec["slot"]), flush=True)
    del eng
    torch.cuda.empty_cache()
    # (c) the offloaded engine, every tiered gather checked
    eng = PagedServingEngine(cfg, params, offload=True, num_device_blocks=128,
                             **paged_kw)
    _warm(eng, cfg)
    with _TieredTally() as tally:
        r, done = _serve(eng, prompts, CHUNK_GEN, ARRIVALS, OFFLOAD_KERNELS,
                         cfg,
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
    for r in eng._slots:                 # profiled: the rest is not needed
        if r is not None:
            eng.cancel(r.uid)
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


def _f32_identity(dev, cfg_full, budget: int = 256, gen: int = 16,
                  layers: int = 2):
    """(d) ``layers`` layers at full width in float32 on the card: chunked
    and solo prefill give identical tokens on the paged, slot and
    offloaded engines (three staggered requests of 1,500/2,500/3,500
    tokens, fills spanning several chunks and completing mid-chunk; the
    offloaded engine stages 40 of 128 blocks)."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine, ServingEngine

    cfg = dataclasses.replace(cfg_full, num_layers=layers, dtype="float32")
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
        arch=cfg.name, layers=layers, dtype="float32",
        prompts=[1500, 2500, 3500],
        new_tokens=gen, prefill_budget=budget,
        chunked_tokens_identical_to_solo=rec)), flush=True)
    _check(all(rec[n] for n, _, _ in engines),
           f"float32 chunked tokens differ from solo: {rec}")
    _check(rec["offload_fetched_fill_rows"] > 0,
           "float32 offload: no fill prefix row came from host memory")
    return rec


# ----------------------------------------------------------------- share ---
def _share_prompts(cfg, seed: int = 9, prefix=None, suffixes=None):
    """A fleet with one system prompt: a seeded ``prefix``-token head
    (default ``SHARE_PREFIX``) followed by distinct seeded suffixes of the
    given lengths (default ``SHARE_SUFFIXES``)."""
    import numpy as np
    prefix = SHARE_PREFIX if prefix is None else prefix
    suffixes = SHARE_SUFFIXES if suffixes is None else suffixes
    rng = np.random.RandomState(seed)
    head = rng.randint(0, cfg.vocab_size, size=(prefix,))
    return [np.concatenate([head, rng.randint(0, cfg.vocab_size, size=(n,))]
                           ).astype(np.int32) for n in suffixes]


class _RebuildCheck:
    """While active, every shared admission (``admit_fill`` with a mapped
    prefix) is counted with the bucket_count launches it made, and the
    first one's rebuilt histogram is held, in every layer, exactly to
    bucket_count_span's plain version on the same pool and table row."""

    def __enter__(self):
        import torch
        from repro_torch import kernels as K
        from repro_torch.core import cache as CC
        from repro_torch.kernels.collision.ref import bucket_count_span_ref
        from repro_torch.models import serve as SV
        self._sv = SV
        real = self._real = SV.admit_fill
        self.launches, self.checked_layers = [], 0

        def checked(state, slot, prompt_row, length, max_new, fill_start=None,
                    bt_row=None, pcfg=None):
            before = K.LAUNCHES["bucket_count"]
            out = real(state, slot, prompt_row, length, max_new,
                       fill_start=fill_start, bt_row=bt_row, pcfg=pcfg)
            if not fill_start:
                return out
            self.launches.append(K.LAUNCHES["bucket_count"] - before)
            if not self.checked_layers:
                row = bt_row.to(out.prompt.device)[None]
                hi = CC.fill_enc_end(fill_start, pcfg)
                for li, lc in enumerate(out.caches):
                    want = bucket_count_span_ref(
                        lc["kv"].meta_ids, row, pcfg.sink_size, hi,
                        pcfg.num_centroids())[0]
                    _check(torch.equal(lc["hist"][slot], want),
                           f"layer {li}: the shared admission's rebuilt "
                           f"histogram differs from its plain version")
                self.checked_layers = len(out.caches)
            return out
        SV.admit_fill = checked
        return self

    def __exit__(self, *exc):
        self._sv.admit_fill = self._real


def _drained(eng) -> bool:
    """Every block back on the free list, no refcount, no index entry."""
    return (len(eng._free) == eng.num_blocks and not eng._refcnt
            and not eng._prefix_index and not eng._block_hash)


def _share_run(eng, cfg, prompts, gen: int, kernels, budget: int, share):
    """Serve ``prompts`` (all at chunk 0) through ``eng`` after a warm-up,
    audited at every chunk boundary, with the fill's and (``share``) the
    rebuilds' launches held exactly and every tiered gather checked
    (``_TieredTally``); → (record, outputs by uid)."""
    L, n = cfg.num_layers, len(prompts)
    starts = ([0] + [SHARE_PREFIX] * (n - 1)) if share else None
    reads, spans = _fill_counts(cfg, prompts, budget, starts)
    gather = ("gather_rows_tiered" if "gather_rows_tiered" in kernels
              else "gather_rows_paged")
    _warm(eng, cfg)
    consumed0, hits0 = eng.blocks_consumed, eng.shared_block_hits
    with _RebuildCheck() as rb, _TieredTally() as tt:
        r, done = _serve(eng, prompts, gen, (0,) * n, kernels, cfg,
                         audit=True, fill={gather: reads})
    rebuild = sum(rb.launches)
    _check(rb.launches == ([L] * (n - 1) if share else []),
           f"rebuild launches per shared admission {rb.launches}, not {L}")
    got, need = r["launches"]["bucket_count"], spans + rebuild
    if "bucket_count" in kernels:         # the meta view counts every step
        need += L * eng.decode_steps
    _check(got == need or ("bucket_count" in kernels and got > need),
           f"bucket_count: {got} launches; the fill's updates need {spans}, "
           f"the rebuilds {rebuild}")
    _check(_drained(eng), "blocks, refcounts or index entries outlived the "
           "run")
    ttft = [q.ttft_s for _, q in sorted(done.items())]
    rec = dict(r, share_prefixes=bool(share),
               blocks_consumed=eng.blocks_consumed - consumed0,
               shared_block_hits=eng.shared_block_hits - hits0,
               shared_prefix_blocks=[q.shared_prefix_blocks
                                     for _, q in sorted(done.items())],
               ttft_s=ttft, sharers_mean_ttft_s=sum(ttft[1:]) / (n - 1),
               rebuild_launches=rebuild,
               rebuild_launches_per_admission=rb.launches,
               rebuild_layers_checked=rb.checked_layers)
    if tt.t["launches"]:
        rec["tally"] = tt.t
    return rec, {u: q.output for u, q in done.items()}


def share_phase(dev, cfg, params, n_max: int = 16384,
                budget: int = CHUNK_BUDGET):
    """Prefix sharing at full width on a fleet of four requests with one
    8,192-token system prompt (``SHARE_SUFFIXES`` after it, ``SHARE_GEN``
    new tokens each, all submitted at chunk 0, admissions serialized through the one
    filling slot): (a) the fused paged engine with sharing on, then off;
    (b) the meta view on the first two; (c) the offloaded engine with
    sharing on, then off (128 of 512 blocks staged, every tiered gather
    checked);
    (d) float32 at 2 layers: sharing, chunked and solo tokens identical on
    the fused, meta-view and offloaded engines."""
    import numpy as np
    import torch
    from repro_torch.serving import PagedServingEngine

    prompts = _share_prompts(cfg)
    n, nshared = len(prompts), SHARE_PREFIX // 128
    kw = dict(n_max=n_max, block_size=128, num_blocks=512, max_batch=4,
              chunk_size=8, prefill_budget=budget, device=dev)
    rec, outs = {}, {}
    # (a) sharing on, then off
    for share in (True, False):
        eng = PagedServingEngine(cfg, params, share_prefixes=share, **kw)
        rec[share], outs[share] = _share_run(eng, cfg, prompts, SHARE_GEN,
                                             PAGED_KERNELS, budget, share)
        print(f"share_{'on' if share else 'off'} " + json.dumps(rec[share]),
              flush=True)
        del eng
        torch.cuda.empty_cache()
    on, off = rec[True], rec[False]
    agree = [float(np.mean(outs[True][u] == outs[False][u]))
             for u in sorted(outs[True])]
    summary = dict(
        prefix=SHARE_PREFIX, suffixes=list(SHARE_SUFFIXES),
        new_tokens=SHARE_GEN, prefill_budget=budget,
        blocks_consumed={"on": on["blocks_consumed"],
                         "off": off["blocks_consumed"]},
        block_cost_ratio=on["blocks_consumed"] / off["blocks_consumed"],
        shared_block_hits=on["shared_block_hits"],
        sharers_mean_ttft_s={"on": on["sharers_mean_ttft_s"],
                             "off": off["sharers_mean_ttft_s"]},
        sharers_ttft_ratio=on["sharers_mean_ttft_s"]
        / off["sharers_mean_ttft_s"],
        tokens_per_s={"on": on["tokens_per_s"], "off": off["tokens_per_s"]},
        peak_mem_gb={"on": on["peak_mem_gb"], "off": off["peak_mem_gb"]},
        token_agreement_on_vs_off=dict(per_request=agree,
                                       overall=float(np.mean(agree))),
        note="bf16: the runs put their fills at different steps, so a "
             "mixed and a pure-decode step may round differently")
    print("share " + json.dumps(summary), flush=True)
    _check(on["shared_prefix_blocks"] == [0] + [nshared] * (n - 1),
           f"shared_prefix_blocks {on['shared_prefix_blocks']}")
    _check(on["shared_block_hits"] == nshared * (n - 1),
           f"shared_block_hits {on['shared_block_hits']}")
    _check(off["shared_block_hits"] == 0, "the unshared run mapped blocks")
    _check(on["blocks_consumed"] < off["blocks_consumed"],
           f"sharing drew {on['blocks_consumed']} blocks, not fewer than "
           f"{off['blocks_consumed']}")
    _check(on["rebuild_layers_checked"] == cfg.num_layers,
           "the rebuilt histogram was not checked in every layer")
    # (b) the meta view, first two requests
    eng = PagedServingEngine(cfg, params, share_prefixes=True, fused=False,
                             **kw)
    mv, mv_out = _share_run(eng, cfg, prompts[:2], 16, METAVIEW_KERNELS,
                            budget, True)
    del eng
    torch.cuda.empty_cache()
    mv["token_agreement_with_share_on"] = [
        float(np.mean(mv_out[u] == outs[True][u][:16])) for u in sorted(mv_out)]
    print("share_metaview " + json.dumps(mv), flush=True)
    _check(mv["shared_prefix_blocks"] == [0, nshared],
           f"meta view shared_prefix_blocks {mv['shared_prefix_blocks']}")
    # (c) the offloaded engine, sharing on, then off
    tiered = {}
    for share in (True, False):
        eng = PagedServingEngine(cfg, params, share_prefixes=share,
                                 offload=True, num_device_blocks=128, **kw)
        r, off_out = _share_run(eng, cfg, prompts, SHARE_GEN,
                                OFFLOAD_KERNELS, budget, share)
        done = {q.uid: q for q in eng._done}
        host, t = eng.host, r.get("tally", {})
        r.update(_tier_stats(eng, done),
                 tokens_identical_to_resident=_same_tokens(off_out,
                                                           outs[share]),
                 fetched_fill_rows=host.fetched_fill_rows,
                 fetched_unique_head_rows=host.fetched_unique_head_rows,
                 fetched_unique_fill_rows=host.fetched_unique_fill_rows,
                 fetched_unique_bytes=sum(q.fetched_unique_bytes
                                          for q in done.values()),
                 # every host row the launches read, the free slots' too
                 # (their frozen regions and -1 rows reach block 0)
                 distinct_bytes=host.fetched_unique_head_rows
                 * host.bytes_per_head_row(eng._names[0])
                 + host.fetched_unique_fill_rows
                 * host.bytes_per_row(eng._names[0]),
                 staging_resident_after=eng.staging.resident_count(),
                 note="every tiered gather checked on the card (a sync per "
                      "launch): tokens/s not comparable")
        print(f"share_offload_{'on' if share else 'off'} " + json.dumps(r),
              flush=True)
        _check(r["tokens_identical_to_resident"], "offloaded tokens differ "
               "from the resident run's with the same sharing")
        _check(r["shared_block_hits"] == rec[share]["shared_block_hits"]
               and r["blocks_consumed"] == rec[share]["blocks_consumed"],
               "offloaded block counters differ from the resident run's")
        _check(eng.staging.resident_count() == 0, "staging retained blocks")
        _check(host.fetched_unique_head_rows
               == t.get("distinct_missed_head_rows", 0)
               and cfg.num_kv_heads * host.fetched_unique_fill_rows
               == t.get("fill_distinct_missed_head_rows", 0),
               f"the engine's distinct rows differ from the kernel's "
               f"distinct reads {t}")
        tiered[share] = r
        del eng
        torch.cuda.empty_cache()
    return dict(a=summary, on=on, off=off, metaview=mv, offload=tiered,
                f32_identity=_share_f32_identity(dev, cfg))


def _share_f32_identity(dev, cfg_full, budget: int = 256, gen: int = 16):
    """(d) 2 layers at full width in float32: four requests with one
    2,048-token prefix (16 blocks) through the fused, meta-view and
    offloaded engines (48 of 128 blocks staged), each with sharing, with
    chunked prefill alone, and with solo prefill: identical tokens."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine

    cfg = dataclasses.replace(cfg_full, num_layers=2, dtype="float32")
    params = init_params(cfg, seed=4, device=dev)
    prompts = _share_prompts(cfg, seed=10, prefix=2048,
                             suffixes=(96, 160, 224, 288))
    common = dict(n_max=4096, max_batch=4, chunk_size=4, block_size=128,
                  num_blocks=128, device=dev)
    engines = (("fused", {}), ("metaview", dict(fused=False)),
               ("offload", dict(offload=True, num_device_blocks=48)))
    modes = (("solo", dict(prefill_budget=0)),
             ("chunked", dict(prefill_budget=budget)),
             ("shared", dict(prefill_budget=budget, share_prefixes=True)))
    rec = {}
    for name, kw in engines:
        outs = {}
        for mode, extra in modes:
            eng = PagedServingEngine(cfg, params, **common, **kw, **extra)
            _, done = _serve(eng, prompts, gen, (0,) * len(prompts), {}, cfg,
                             audit=True)
            outs[mode] = {u: q.output for u, q in done.items()}
            if mode == "shared":
                rec[f"{name}_shared_block_hits"] = eng.shared_block_hits
                _check(_drained(eng), f"{name}: blocks outlived the run")
            del eng
        rec[name] = dict(shared_eq_chunked=_same_tokens(outs["shared"],
                                                        outs["chunked"]),
                         chunked_eq_solo=_same_tokens(outs["chunked"],
                                                      outs["solo"]))
    torch.cuda.empty_cache()
    print("share_f32 " + json.dumps(dict(
        layers=2, dtype="float32", prefix=2048, suffixes=[96, 160, 224, 288],
        new_tokens=gen, prefill_budget=budget, identical=rec)), flush=True)
    _check(all(rec[n]["shared_eq_chunked"] and rec[n]["chunked_eq_solo"]
               for n, _ in engines), f"float32 sharing tokens differ: {rec}")
    _check(all(rec[f"{n}_shared_block_hits"] == 3 * 16 for n, _ in engines),
           f"float32 sharing mapped other than 3 x 16 blocks: {rec}")
    return rec


# --------------------------------------------------------------- sharded ---
def _path_kernels(dev, cfg, G: int, tag: str, seed: int = 0):
    """Stage I, the top-C cut, Stage II with its top-k and the decode gather
    at another model's shapes: ``G`` KV heads of ``cfg`` (Hg, hd, B and
    2^m from it, bf16), 512 blocks of 128, four rows at the kernel phase's
    lengths — "shard": one rank's heads in the sharded phase
    (stablelm-1.6b split two ways: G 16, Hg 1, hd 64, B 8); "grok": grok-1
    in the arch phase (G 8, Hg 6, hd 128, B 16). Each is held to its plain
    version as the kernel phase holds it (exact; Stage II's estimates to
    its tolerance and its selection exact) and timed; the records are
    named ``<kernel>/<tag>``."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.core import centroids
    from repro_torch.core import encode as E
    from repro_torch.core import retrieval as R
    from repro_torch.kernels import SEG_LEN
    from repro_torch.kernels.bucket_topk import bucket_topk
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision import (collision_scores_paged_kernel,
                                               lane_packed_table)
    from repro_torch.kernels.collision.ref import collision_paged_ref
    from repro_torch.kernels.gather_kv import gather_decode_paged
    from repro_torch.kernels.gather_kv.ref import gather_decode_paged_ref
    from repro_torch.kernels.rerank import rerank_topk_paged
    from repro_torch.kernels.rerank.ref import rerank_topk_paged_ref
    from repro_torch.models.serve import rotation_signs

    pcfg = cfg.pariskv
    b, hd = 4, cfg.head_dim
    Hg = cfg.num_heads // cfg.num_kv_heads
    B, m = pcfg.num_subspaces(hd), pcfg.m
    bs, n, nb = 128, 16384, 512
    nblk = n // bs
    C, sink = pcfg.candidate_count(n), pcfg.sink_size
    W, k_top = CC.window_size(pcfg), pcfg.top_k
    gen = torch.Generator(device=dev).manual_seed(seed)
    signs = rotation_signs(cfg, dev)
    pool = CC.init_paged_cache(nb, bs, G, hd, pcfg, torch.bfloat16, dev)
    keys = torch.randn((nb, bs, G, hd), generator=gen, device=dev)
    pool.k.copy_(keys)
    pool.v.copy_(torch.randn((nb, bs, G, hd), generator=gen, device=dev))
    meta = E.encode_keys(keys.transpose(1, 2), pcfg, signs)
    for dst, src in zip(pool[2:], meta):
        dst.copy_(src)
    del keys, meta
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((b, nblk), -1, dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(LENS_AFTER):
        need = -(-ln // bs)
        bt[i, :need] = perm[used:used + need]
        used += need
    enc_end = torch.tensor([ln - KERNEL_NEW - pcfg.local_size
                            for ln in LENS_AFTER], dtype=torch.int32,
                           device=dev)
    pos = enc_end + pcfg.local_size + 150
    hist = CC.bucket_hist_from_meta(
        CC.paged_ids_view(pool, bt), CC.CacheRegions(pos, enc_end), pcfg)
    qt = E.encode_query(torch.randn((b, G, Hg, hd), generator=gen,
                                    device=dev), pcfg, signs)
    cs = centroids.centroid_scores(qt.q_sub, m)
    n_valid = (enc_end - sink).clamp_min(0)
    tables = R.tier_weight_table(cs, hist[:, :, None], n_valid[:, None, None],
                                 pcfg, out=lane_packed_table(*cs.shape,
                                                             device=dev))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng_s = R.max_collision_score(pcfg, B)
    nval = int(n_valid.sum())
    shape = dict(G=G, Hg=Hg, hd=hd, B=B, rows=b, block_size=bs,
                 num_blocks=nb, n=n, C=C, top_k=k_top)
    out = {}

    def stage1():
        return collision_scores_paged_kernel(pool.meta_ids, bt, tables,
                                             enc_end, sink, rng_s)
    coarse, seg_hist = stage1()
    want, want_hist = collision_paged_ref(pool.meta_ids, bt, tables, enc_end,
                                          sink, rng_s)
    _check(torch.equal(coarse, want) and torch.equal(seg_hist, want_hist),
           f"collision_paged differs from its plain version ({tag} shapes)")
    out[f"collision_paged/{tag}"] = dict(
        route="cuda", source="src/repro_torch/csrc/collision_paged.cu",
        replaces="src/repro/kernels/collision/collision.py:146",
        max_abs_err=0, tolerance="exact (scores and seg_hist)", **shape,
        ms=_time_ms(stage1, flush),
        plain_ms=_time_ms(lambda: collision_paged_ref(
            pool.meta_ids, bt, tables, enc_end, sink, rng_s), flush),
        library_ms=None,
        bound=_bound(G * nval * B + tables.numel() + bt.numel() * 4 + b * 4
                     + coarse.numel() * 4 + seg_hist.numel() * 4,
                     G * nval * B))

    cand = bucket_topk(coarse, C, rng_s, seg_hist=seg_hist)
    _check(torch.equal(cand, bucket_topk_ref(coarse, C, rng_s)),
           f"bucket_topk differs from its plain version ({tag} shapes)")
    seg_read = int(torch.zeros(coarse.shape[:-1] + (n // SEG_LEN,),
                               dtype=torch.int32, device=dev).scatter_(
        -1, (cand // SEG_LEN).long(), 1).sum())
    out[f"bucket_topk/{tag}"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_topk.cu",
        replaces="src/repro/kernels/bucket_topk/bucket_topk.py:50",
        max_abs_err=0, tolerance="exact", **shape,
        ms=_time_ms(lambda: bucket_topk(coarse, C, rng_s, seg_hist=seg_hist),
                    flush),
        plain_ms=_time_ms(lambda: bucket_topk_ref(coarse, C, rng_s), flush),
        library_ms=_time_ms(lambda: torch.topk(coarse, C, -1, sorted=False),
                            flush),
        bound=_bound(seg_hist.numel() * 4 + seg_read * SEG_LEN * 4
                     + cand.numel() * 4, 0))

    q_sub = qt.q_sub.float().contiguous()
    q_norm = qt.q_norm.float().contiguous()
    args = (pool.meta_codes, pool.meta_w, bt, cand, q_sub, q_norm, enc_end,
            sink, k_top, m, pcfg.magnitude_bits)
    won, err = _stage2_checks(args, bs, f"{tag} shapes")
    n_cand = int(((cand >= sink) & (cand < enc_end[:, None, None, None]))
                 .sum())
    out[f"rerank_topk_paged/{tag}"] = dict(
        route="cuda", source="src/repro_torch/csrc/rerank_topk_paged.cu",
        replaces="src/repro/kernels/rerank/rerank.py:78",
        max_abs_err=err,
        tolerance=f"estimates rtol {RERANK_RTOL}, atol {RERANK_ATOL}; the "
                  f"selection exact against the plain top-k of the "
                  f"kernel's own estimates", **shape,
        ms=_time_ms(lambda: rerank_topk_paged(*args), flush),
        plain_ms=_time_ms(lambda: rerank_topk_paged_ref(*args), flush),
        library_ms=None,
        bound=_bound(n_cand * B * 8 + cand.numel() * 8 + bt.numel() * 4
                     + b * 4 + b * G * Hg * k_top * 16 + q_sub.numel() * 4
                     + q_norm.numel() * 4, n_cand * (2 * B * m + 2 * B)))

    ws = (pos + 2 - W).clamp_min(0).to(torch.int32)
    phys = won.phys_rows

    def kern():
        return gather_decode_paged(pool.k, pool.v, bt, ws, sink, W, phys)
    got = kern()
    _check(all(torch.equal(x, y) for x, y in zip(
        got, gather_decode_paged_ref(pool.k, pool.v, bt, ws, sink, W, phys))),
        f"gather_rows_paged differs from its plain version ({tag} shapes)")
    flat_k = pool.k.reshape(nb * bs, G, hd)
    flat_v = pool.v.reshape(nb * bs, G, hd)
    heads = torch.arange(G, device=dev)[None, :, None, None]
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      ws[:, None] + torch.arange(W, device=dev)], 1)
    rows_l = (bt.long().gather(1, (lidx // bs).long()).clamp_min(0) * bs
              + lidx % bs)
    rows_p = phys.long()
    out[f"gather_rows_paged/{tag}"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_paged.cu",
        replaces="src/repro/kernels/gather_kv/gather_kv.py:87",
        max_abs_err=0, tolerance="exact", **shape,
        ms=_time_ms(kern, flush),
        plain_ms=_time_ms(lambda: gather_decode_paged_ref(
            pool.k, pool.v, bt, ws, sink, W, phys), flush),
        library_ms=_time_ms(lambda: (flat_k[rows_l], flat_v[rows_l],
                                     flat_k[rows_p, heads],
                                     flat_v[rows_p, heads]), flush),
        bound=_bound(2 * sum(t.numel() for t in got) * 2 + phys.numel() * 4
                     + b * 4 + bt.numel() * 4, 0))
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        print(f"kernel {name} " + json.dumps(rec), flush=True)
    return out


def _head_invariance(dev, seed: int = 0):
    """Whether a head slice of the decode and fill attention has the same
    bits as the full call (a rank's heads against one device's), at the
    shard shapes of stablelm-1.6b (G 32 → 16, Hg 1, hd 64) and qwen2-1.5b
    (G 2 → 1, Hg 6, hd 128): four decode rows over sink, 100 winners and
    the window; one 256-token fill chunk over a 3,500-token prefix. →
    {shape: (decode max |diff|, fill max |diff|)}; the decode's must be 0
    (its contractions are products and sums), the fill's GEMMs are
    cuBLAS's, batched over heads."""
    import torch
    from repro_torch.core import attention as A
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    out = {}
    for name, G, Hg, hd in (("stablelm", 32, 1, 64), ("qwen2", 2, 6, 128)):
        b, sink, k, W, P, n = 4, 128, 100, 768, 256, 3500
        h = slice(G // 2, G)
        args = (r(b, G, Hg, hd), r(b, sink, G, hd), r(b, sink, G, hd),
                r(b, G, Hg, k, hd), r(b, G, Hg, k, hd), r(b, W, G, hd),
                r(b, W, G, hd))
        axes = (1, 2, 2, 1, 1, 2, 2)
        ints = [torch.full(s, v, dtype=torch.int32, device=dev) for s, v in
                (((b, G, Hg, k), 500), ((b,), 2000), ((b,), 2767),
                 ((b,), 1800))]
        kw = dict(sink_size=sink, window_size=W, sm_scale=hd ** -0.5,
                  softcap=0.0)
        full = A._segment_attention(*args, ints[0], *ints[1:], **kw)
        part = A._segment_attention(
            *(a.narrow(ax, G // 2, G // 2).contiguous()
              for a, ax in zip(args, axes)), ints[0][:, h].contiguous(),
            *ints[1:], **kw)
        q = r(1, P, G * Hg, hd)
        kv = (r(1, n, G, hd), r(1, n, G, hd), r(1, P, G, hd), r(1, P, G, hd))
        pos = (torch.arange(n, device=dev)[None],
               n + torch.arange(P, device=dev)[None])
        fill = A.chunk_fill_attention(q, kv[0], kv[1], pos[0], kv[2], kv[3],
                                      pos[1], pos[1], sm_scale=hd ** -0.5)
        fill_part = A.chunk_fill_attention(
            q[:, :, G // 2 * Hg:].contiguous(),
            *(t[:, :, h].contiguous() for t in kv[:2]), pos[0],
            *(t[:, :, h].contiguous() for t in kv[2:]), pos[1], pos[1],
            sm_scale=hd ** -0.5)
        out[name] = (float((full[:, h] - part).abs().max()),
                     float((fill[:, :, G // 2 * Hg:] - fill_part).abs()
                           .max()))
    return out


def _shard_engine(cfg, params, dev, shards: int, **kw):
    """The engine phase's geometry over ``shards`` ranks (the sharded and
    arch phases' engine)."""
    from repro_torch.serving import PagedServingEngine
    return PagedServingEngine(cfg, params, n_max=16384, block_size=128,
                              num_blocks=512, max_batch=4, chunk_size=8,
                              mesh_shards=shards, device=dev, **kw)


def _pool_bytes(eng) -> int:
    """Device bytes of the pool: K/V, metadata and histograms, all global
    layers."""
    from repro_torch.models.serve import pool_entries
    return sum(t.nbytes for lc in pool_entries(eng._state.caches)
               for t in (*lc["kv"], lc["hist"]))


def _ring_bytes(eng) -> int:
    """Device bytes of the local layers' slot-local ring buffers."""
    from repro_torch.models.serve import is_ring
    return sum(t.nbytes for lc in eng._state.caches if is_ring(lc)
               for t in lc["kv"])


def _media_bytes(eng) -> int:
    """Device bytes of the slot-local media K/V (cross layers and
    sublayers)."""
    return sum(t.nbytes for lc in eng._state.caches
               for t in lc.get("media_kv", ()))


def _ssm_bytes(eng) -> int:
    """Device bytes of the slot-local SSD states and conv tails (mamba2's
    layers, hymba's hybrid layers)."""
    return sum(t.nbytes for lc in eng._state.caches
               for t in lc.get("ssm", ()))


def _ssm_bytes_want(cfg, slots: int) -> int:
    """``slots`` × layers × (the float32 state h·p·n + the conv tail of
    k - 1 rows of conv_dim in bf16)."""
    from repro_torch.models import ssm as SSM
    _, nh, hp, n, _ = SSM.ssm_dims(cfg)
    return slots * cfg.num_layers * (
        nh * hp * n * 4 + (cfg.ssm_conv_width - 1) * SSM.conv_dim(cfg) * 2)


def _digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import hashlib
    import torch
    raw = t.contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def _probe(eng, cfg, prompts, head_ranges):
    """One decode step's retrieval and gather outputs in every layer, once
    the four requests are admitted together and one chunk has run: for
    each KV-head range (g0, g1) of ``head_ranges`` (None: every head of
    the engine's pool), a digest per layer of each retrieval field (Stage
    I scores, the top-C set, Stage II's winners, estimates and rows) and
    of the decode gather's K/V rows on those heads."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.kernels.gather_kv import gather_decode_paged
    from repro_torch.models import serve as SV
    from repro_torch.serving import Request

    pcfg = cfg.pariskv
    W = CC.window_size(pcfg)
    eng.start()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=SHARD_GEN))
    eng.step_serve()
    st = eng._state
    bt = torch.from_numpy(eng._bt).to(eng.device)
    ws = (st.regions.pos + 2 - W).clamp_min(0).to(torch.int32)
    rec = []
    SV.decode_step(eng.params, cfg, st.cur_tok,
                   SV.ServeState(st.caches, st.regions), bt,
                   active=st.remaining > 0, record=rec, dist=eng.dist)
    out = [[] for _ in head_ranges]
    for lc, res in zip(st.caches, rec):
        dk, dv, wk, wv = gather_decode_paged(lc["kv"].k, lc["kv"].v, bt, ws,
                                             pcfg.sink_size, W, res.phys_rows)
        for row, hr in zip(out, head_ranges):
            g = slice(None) if hr is None else slice(*hr)
            row.append(dict(
                {f: _digest(getattr(res, f)[:, g]) for f in res._fields},
                dense_k=_digest(dk[:, :, g]), dense_v=_digest(dv[:, :, g]),
                ret_k=_digest(wk[:, g]), ret_v=_digest(wv[:, g])))
    eng.start()                          # drop the probe's requests
    return out


def _shard_f32(dev, cfg_full, shards: int):
    """(b) 2 layers in float32, the engine phase's geometry at n_max 4096:
    three staggered requests of 1,500/2,500/3,500 tokens (16 new) through
    the fused engine, the meta view and chunked prefill (budget 256), and
    three behind one 2,048-token prefix with sharing, every chunk
    audited. → per mode the tokens, the bucket_count launches and the
    shared block hits."""
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine

    cfg = dataclasses.replace(cfg_full, num_layers=2, dtype="float32")
    params = init_params(cfg, seed=4, device=dev)
    lens = _prompts(cfg, seed=6, lens=SHARD_F32_LENS)
    shared = _share_prompts(cfg, seed=10, prefix=2048,
                            suffixes=(96, 160, 224))
    budget = dict(prefill_budget=SHARD_F32_BUDGET)
    modes = (("fused", {}, lens), ("metaview", dict(fused=False), lens),
             ("chunked", budget, lens),
             ("shared", dict(share_prefixes=True, **budget), shared))
    out = {}
    for name, kw, prompts in modes:
        eng = PagedServingEngine(cfg, params, n_max=4096, block_size=128,
                                 num_blocks=128, max_batch=4, chunk_size=4,
                                 mesh_shards=shards, device=dev, **kw)
        rec, done = _serve(eng, prompts, SHARD_F32_GEN, (0, 1, 2), {}, cfg,
                           audit=True)
        out[name] = dict(
            tokens={u: r.output.tolist() for u, r in done.items()},
            bucket_count=rec["launches"]["bucket_count"],
            shared_block_hits=eng.shared_block_hits)
        del eng
    return out


def _shard_rank(rank: int, shards: int, backend: str, device_type: str):
    """One rank of the sharded phase: (a) at full width, the engine phase's
    first two requests with 16 new tokens each, its launches counted and
    checked
    (``_serve``), and the retrieval probe; (b) the float32 modes. A rank
    serves on its own card under NCCL, on card 0 under gloo."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type)
    if device_type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    from repro_torch import configs
    from repro_torch.models.model import init_params

    cfg = configs.get(SHARD_ARCH)
    params = init_params(cfg, seed=0, device=dev)
    eng = _shard_engine(cfg, params, dev, shards)
    _warm(eng, cfg)
    pool = _pool_bytes(eng)
    rec, done = _serve(eng, _prompts(cfg)[:SHARD_REQUESTS], SHARD_GEN,
                       ARRIVALS[:SHARD_REQUESTS], PAGED_KERNELS, cfg)
    probe = _probe(eng, cfg, _prompts(cfg), [None])[0]
    del eng, params
    torch.cuda.empty_cache()
    return dict(rec=rec, pool_bytes=pool, probe=probe,
                tokens={u: r.output.tolist() for u, r in done.items()},
                f32=_shard_f32(dev, cfg, shards))


def sharded_phase(dev):
    """Head-sharded paged serving (``mesh_shards=2``) of stablelm-1.6b,
    against the same engine on one device in this process."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.distributed import backend_for, launch_local
    from repro_torch.models.model import init_params, param_count

    cfg = configs.get(SHARD_ARCH)
    kern = _path_kernels(dev, cfg, cfg.num_kv_heads // SHARDS, "shard")
    invariance = _head_invariance(dev)
    params = init_params(cfg, seed=0, device=dev)
    n_params = param_count(params)
    eng = _shard_engine(cfg, params, dev, 1)
    _warm(eng, cfg)
    pool = _pool_bytes(eng)
    one, done = _serve(eng, _prompts(cfg)[:SHARD_REQUESTS], SHARD_GEN,
                       ARRIVALS[:SHARD_REQUESTS], PAGED_KERNELS, cfg)
    one_tokens = {u: r.output.tolist() for u, r in done.items()}
    per = cfg.num_kv_heads // SHARDS
    probes = _probe(eng, cfg, _prompts(cfg),
                    [(r * per, (r + 1) * per) for r in range(SHARDS)])
    del eng, params
    torch.cuda.empty_cache()
    f32_one = _shard_f32(dev, cfg, 1)
    torch.cuda.empty_cache()
    backend = backend_for(SHARDS, dev)
    t0 = time.perf_counter()
    ranks = launch_local(_shard_rank, SHARDS, backend, timeout_s=600.0,
                         args=(SHARDS, backend, dev.type))
    ranks_s = time.perf_counter() - t0
    mismatched = [(r, li, f) for r, rk in enumerate(ranks)
                  for li, (got, want) in enumerate(zip(rk["probe"],
                                                       probes[r]))
                  for f in want if got[f] != want[f]]
    f32_same = {name: all(rk["f32"][name]["tokens"] == want["tokens"]
                          for rk in ranks)
                for name, want in f32_one.items()}
    agree = [float(np.mean(np.asarray(ranks[0]["tokens"][u])
                           == np.asarray(one_tokens[u])))
             for u in sorted(one_tokens)]
    rec = dict(
        arch=SHARD_ARCH, layers=cfg.num_layers, dtype=cfg.dtype,
        params=n_params, shards=SHARDS, backend=backend,
        device=torch.cuda.get_device_name(0), ranks_wall_s=ranks_s,
        head_slice_max_abs_diff=dict(
            note="a head slice of the attention against the full call: "
                 "(decode, fill)", **invariance),
        unsharded=dict(tokens_per_s=one["tokens_per_s"],
                       serve_s=one["serve_s"],
                       decode_steps=one["decode_steps"],
                       peak_mem_gb=one["peak_mem_gb"], pool_bytes=pool,
                       launches=one["launches"]),
        sharded=[dict(rank=r, tokens_per_s=rk["rec"]["tokens_per_s"],
                      serve_s=rk["rec"]["serve_s"],
                      decode_steps=rk["rec"]["decode_steps"],
                      peak_mem_gb=rk["rec"]["peak_mem_gb"],
                      pool_bytes=rk["pool_bytes"],
                      launches=rk["rec"]["launches"])
                 for r, rk in enumerate(ranks)],
        ranks_tokens_identical=all(rk["tokens"] == ranks[0]["tokens"]
                                   for rk in ranks),
        bf16_token_agreement_with_unsharded=dict(
            per_request=agree, overall=float(np.mean(agree))),
        probe_layers=len(probes[0]), probe_fields=sorted(probes[0][0]),
        probe_mismatches=mismatched[:8], probe_mismatch_count=len(mismatched),
        f32=dict(layers=2, prompts=list(SHARD_F32_LENS), shared_prefix=2048,
                 new_tokens=SHARD_F32_GEN, prefill_budget=SHARD_F32_BUDGET,
                 tokens_identical=f32_same,
                 bucket_count_launches=[{n: rk["f32"][n]["bucket_count"]
                                         for n in f32_one} for rk in ranks],
                 shared_block_hits=[f32_one["shared"]["shared_block_hits"]]
                 + [rk["f32"]["shared"]["shared_block_hits"]
                    for rk in ranks]))
    print("sharded " + json.dumps(rec), flush=True)
    _check(all(d == 0 for d, _ in invariance.values()),
           f"the decode attention of a head slice differs: {invariance}")
    _check(rec["ranks_tokens_identical"], "the ranks emitted other tokens")
    _check(all(rk["pool_bytes"] * SHARDS == pool for rk in ranks),
           f"a rank's pool is not 1/{SHARDS} of the unsharded pool's "
           f"{pool} bytes: {[rk['pool_bytes'] for rk in ranks]}")
    _check(not mismatched, f"{len(mismatched)} probe outputs differ from the "
                           f"unsharded head slice, first {mismatched[:8]}")
    _check(all(f32_same.values()), f"float32 sharded tokens differ from the "
                                   f"unsharded engine's: {f32_same}")
    _check(all(rk["f32"][n]["bucket_count"] > 0 for rk in ranks
               for n in ("chunked", "shared")),
           "a chunked or sharing rank never launched bucket_count")
    _check(all(rk["f32"]["shared"]["shared_block_hits"]
               == f32_one["shared"]["shared_block_hits"] > 0 for rk in ranks),
           "the ranks mapped other shared blocks than one device")
    return rec, kern


# -------------------------------------------------------------- seqshard ---
def _seq_cfg():
    """qwen2-1.5b at full width, cut to the serving phases' depth."""
    from repro_torch import configs
    return dataclasses.replace(configs.get("qwen2-1.5b"),
                               num_layers=QWEN_LAYERS)


def _store_bytes(caches) -> int:
    """Bytes of the contiguous ParisKV stores (K/V and metadata)."""
    from repro_torch.core.cache import LayerKVCache
    return sum(t.numel() * t.element_size() for lc in caches
               if isinstance(lc.get("kv"), LayerKVCache) for t in lc["kv"])


def _seq_gather_kernel(dev, full, shards, regions, pcfg, seed: int = 0):
    """Row 6's rank-masked mode at the phase's shapes (layer 0 after the
    prefill): on each rank's shard, the decode gather of the sink, the
    window and a seeded set of winners (global positions in [sink,
    enc_end)), against its plain version exactly, against the unmasked
    decode-mode gather of the whole cache on the owned rows (zeros on the
    others), and summed over the ranks, against the whole gather. Timed
    on rank 0's shard beside its plain version and one advanced-indexing
    call over the shard with a zero row appended."""
    import torch
    from repro_torch.distributed import SeqShardDist
    from repro_torch.core.cache import window_size
    from repro_torch.kernels import row_tables
    from repro_torch.kernels.gather_kv import (gather_decode_masked,
                                               gather_decode_paged)
    from repro_torch.kernels.gather_kv.ref import gather_decode_masked_ref

    kv = full.caches[0]["kv"]
    b, n, G, hd = kv.k.shape
    Hg = _seq_cfg().num_heads // G
    sink, W, k = pcfg.sink_size, window_size(pcfg), pcfg.top_k
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = int(regions.enc_end[0])
    top = torch.randint(sink, enc, (b, G, Hg, k), generator=g, device=dev,
                        dtype=torch.int32)
    start = (regions.pos + 2 - W).clamp(0, n - W).to(torch.int32)
    rows1 = row_tables(b, dev)
    whole = gather_decode_paged(kv.k, kv.v, rows1, start, sink, W,
                                top + n * rows1[:, :, None, None])
    total = [torch.zeros_like(t) for t in whole]
    owned_bytes = []
    for r, st in enumerate(shards):
        sk = st.caches[0]["kv"]
        base, n_loc = SeqShardDist(r, len(shards)).rows(n)
        got = gather_decode_masked(sk.k, sk.v, rows1, start, sink, W, top,
                                   base, n_loc)
        want = gather_decode_masked_ref(sk.k, sk.v, rows1, start, sink, W,
                                        top, base, n_loc)
        _check(all(torch.equal(x, y) for x, y in zip(got, want)),
               f"the rank-masked gather differs from its plain version "
               f"(rank {r})")
        lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                          start[:, None] + torch.arange(W, device=dev)], 1)
        own_d = ((lidx >= base) & (lidx < base + n_loc))[..., None, None]
        own_r = ((top >= base) & (top < base + n_loc))[..., None]
        for x, y, own in zip(got, whole, (own_d, own_d, own_r, own_r)):
            _check(torch.equal(x, torch.where(own, y, torch.zeros_like(y))),
                   f"the rank-masked gather differs from the unmasked "
                   f"decode gather on rank {r}'s rows")
        for t, x in zip(total, got):
            t += x
        owned_bytes.append((int(own_d.sum()) * G + int(own_r.sum())) * hd
                           * kv.k.element_size() * 2)       # K and V
    _check(all(torch.equal(t, y) for t, y in zip(total, whole)),
           "the ranks' masked gathers do not sum to the whole gather")

    sk = shards[0].caches[0]["kv"]
    base, n_loc = 0, sk.k.shape[1]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def kern():
        return gather_decode_masked(sk.k, sk.v, rows1, start, sink, W, top,
                                    base, n_loc)

    def plain():
        return gather_decode_masked_ref(sk.k, sk.v, rows1, start, sink, W,
                                        top, base, n_loc)

    # one index_select over the shard's K and V head rows with a zero row
    # appended, at precomputed head-row indices (a zero row where unowned)
    heads = torch.cat([sk.k, sk.v]).reshape(-1, hd)
    heads = torch.cat([heads, heads.new_zeros((1, hd))])
    zero = heads.shape[0] - 1
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      start[:, None] + torch.arange(W, device=dev)], 1)
    gs = torch.arange(G, device=dev)

    def at(pos, g, kv_i):
        own = (pos >= base) & (pos < base + n_loc)
        row = ((kv_i * b + torch.arange(b, device=dev).view(
            (b,) + (1,) * (pos.dim() - 1))) * n_loc
            + (pos - base).clamp(0, n_loc - 1))
        return torch.where(own, row * G + g, zero)
    idx = torch.cat([at(lidx[..., None], gs, i).reshape(-1) for i in (0, 1)]
                    + [at(top, gs[None, :, None, None], i).reshape(-1)
                       for i in (0, 1)])

    def library():
        return torch.index_select(heads, 0, idx)
    _check(torch.equal(library()[:lidx.numel() * G].view(b, sink + W, G, hd),
                       kern()[0]), "the advanced-indexing yardstick differs")
    out_bytes = sum(t.numel() * t.element_size() for t in kern())
    rec = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_paged.cu",
        replaces="src/repro/kernels/gather_kv/gather_kv.py:46",
        mode="rank-masked (row_base, row_count)",
        max_abs_err=0,
        tolerance="exact: plain version, unmasked gather on owned rows, "
                  "zeros elsewhere, sum over the ranks",
        ms=_time_ms(kern, flush), call_ms=_time_ms(kern, flush, primed=False),
        plain_ms=_time_ms(plain, flush), library_ms=_time_ms(library, flush),
        owned_bytes=owned_bytes[0], out_bytes=out_bytes,
        bound_note="owned rows read once, every output row (zeros too) "
                   "written once, at 3.35 TB/s")
    rec["bound_ms"], rec["bound_by"] = _bound(
        owned_bytes[0] + out_bytes + top.numel() * 4 + b * 4, 0)
    print("kernel gather_rows_paged/seqshard " + json.dumps(rec), flush=True)
    return {"gather_rows_paged/seqshard": rec}


def _seq_records(rec, keep: bool):
    """A step's per-layer ``ShardRetrieval``s → host copies (all fields
    with ``keep``, else the merged winners only)."""
    out = []
    for r in rec:
        d = dict(indices=r.indices.cpu())
        if keep:
            d.update(scores=r.scores.cpu(),
                     local_indices=r.local_indices.cpu(),
                     local_scores=r.local_scores.cpu(),
                     q_norm=r.qt.q_norm.cpu(), q_sub=r.qt.q_sub.cpu(),
                     enc_end=r.enc_end.cpu())
        out.append(d)
    return out


def _seq_decode(params, cfg, st, forced, samples, dev, dist=None):
    """Teacher-forced decode steps from ``st`` (in place) → dict: per step
    the logits' SHA-256, the greedy token, its lead over the runner-up and
    the merged winners' SHA-256; the sampled steps' records; seconds; the
    final state."""
    import hashlib
    import torch
    from repro_torch.models import serve as SV
    out = dict(logits_sha=[], argmax=[], top2_gap=[], winners_sha=[],
               samples={})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for step, tok in enumerate(forced):
        rec = []
        lg, st = SV.decode_step(params, cfg, torch.tensor(
            [tok], dtype=torch.int32, device=dev), st, record=rec, dist=dist)
        host = lg.float().cpu()
        out["logits_sha"].append(
            hashlib.sha256(host.numpy().tobytes()).hexdigest())
        top2 = torch.topk(host[0], 2).values
        out["argmax"].append(int(host.argmax()))
        out["top2_gap"].append(float(top2[0] - top2[1]))
        win = torch.stack([r.indices for r in rec]).cpu()
        out["winners_sha"].append(
            hashlib.sha256(win.numpy().tobytes()).hexdigest())
        if step in samples:
            out["samples"][step] = (
                _seq_records(rec, True) if dist is not None
                else [dict(indices=r.indices.cpu()) for r in rec])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0
    return out, st


def _seqshard_rank(rank: int, shards: int, cfg, params, states, forced,
                   samples, device_type: str):
    """One rank of the seqshard phase: its shard of the prefilled state
    (shared from the parent, updated in place), the teacher-forced decode
    with ``dist=SeqShardDist``, its launches counted from zero."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type)
    if device_type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    from repro_torch import kernels as K
    from repro_torch.distributed import SeqShardDist

    d = SeqShardDist.from_process_group(shards)
    st = states[rank]
    enc0 = int(st.regions.enc_end[0])
    K.reset_launches()
    out, st = _seq_decode(params, cfg, st, forced, samples, dev, dist=d)
    out.update(
        launches=dict(K.LAUNCHES), tokens_per_s=len(forced) / out["seconds"],
        promotions=(int(st.regions.enc_end[0]) - enc0)
        // cfg.pariskv.update_interval,
        cache_bytes=_store_bytes(st.caches),
        peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                     if device_type == "cuda" else None))
    return out


def _oracle_recall(cache, rec, one_idx, signs, sink: int, k: int):
    """Layer 0 at a sampled step: the recall of the sharded and of the
    one-device winners against the exact inner-product top-k over the
    region [sink, enc_end). Layer 0's query and keys are the same in both
    runs (its input is the forced token's embedding), so only the
    retrieval differs; the query comes back from the record's transform
    (the rotation is orthogonal)."""
    import torch
    from repro_torch.core.retrieval import exact_topk, recall_at_k
    from repro_torch.core.srht import srht_rotate_t
    dev = cache.k.device
    q_sub = rec["q_sub"].to(dev)
    G, Hg = q_sub.shape[1:3]
    hd = cache.k.shape[-1]
    q = rec["q_norm"].to(dev)[..., None] * srht_rotate_t(
        q_sub.reshape(q_sub.shape[:3] + (-1,)), signs, hd)   # (1, G, Hg, hd)
    pos = torch.arange(cache.k.shape[1], device=dev)
    valid = (pos >= sink) & (pos < int(rec["enc_end"][0]))
    keys = cache.k[0].permute(1, 0, 2)[:, None]               # (G, 1, n, hd)
    oracle, _ = exact_topk(keys, q[0], valid, k)              # (G, Hg, k)
    return (float(recall_at_k(rec["indices"][0].to(dev), oracle).mean()),
            float(recall_at_k(one_idx[0].to(dev), oracle).mean()))


def seqshard_phase(dev, cfg=None, seq_len: int = SEQ_LEN, gen: int = SEQ_GEN,
                   samples=SEQ_SAMPLES, kernel: bool = True):
    """The sequence-sharded contiguous decode (``decode_step(dist=
    SeqShardDist)``) of qwen2-1.5b at full width over SEQ_SHARDS gloo ranks
    of the one card, from one prefill in this process, against the
    one-device decode from the same state."""
    import numpy as np
    import torch
    from repro_torch.distributed import (SeqShardDist, backend_for,
                                         launch_local)
    from repro_torch.models import layers as L
    from repro_torch.models import serve as SV
    from repro_torch.models.model import init_params
    from repro_torch.core.config import INPUT_SHAPES, InputShape
    from repro_torch.core.encode import QueryTransform
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MX

    cfg = cfg or _seq_cfg()
    pcfg = cfg.pariskv
    S = SEQ_SHARDS
    n_max = seq_len + SEQ_HEADROOM
    params = init_params(cfg, seed=0, device=dev)
    prompt = _prompts(cfg, seed=12, lens=(seq_len,))[0][None]
    forced = [int(t) for t in _prompts(cfg, seed=13, lens=(gen,))[0]]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, st = SV.prefill(params, cfg, prompt, n_max, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else None)
    shards = [SV.seq_shard_state(st, SeqShardDist(r, S)) for r in range(S)]
    kern = (_seq_gather_kernel(dev, st, shards, st.regions, pcfg)
            if kernel else {})
    one_bytes = _store_bytes(st.caches)

    backend = backend_for(S, dev)
    t0 = time.perf_counter()
    ranks = launch_local(_seqshard_rank, S, backend, timeout_s=900.0,
                         args=(S, cfg, params, shards, forced, samples,
                               dev.type))
    ranks_s = time.perf_counter() - t0
    one, st = _seq_decode(params, cfg, st, forced, samples, dev)
    one_samp, one_s = one["samples"], one["seconds"]

    # check 2: every sampled layer-step's merged winners from the shards
    # as they stand now (the metadata in [sink, enc_end) of a step never
    # changes after it), per shard and merged here without a collective
    n_loc = n_max // S
    replay_mismatch = []
    for step in samples:
        per_layer = zip(*(rk["samples"][step] for rk in ranks))
        for li, recs in enumerate(per_layer):
            loc = []
            for r, rc in enumerate(recs):
                qt = QueryTransform(rc["q_norm"].to(dev), rc["q_sub"].to(dev))
                kv = shards[r].caches[li]["kv"]
                sc, ix = L.seq_local_retrieve(kv, qt, rc["enc_end"].to(dev),
                                              pcfg, r * n_loc)
                if not (torch.equal(sc.cpu(), rc["local_scores"])
                        and torch.equal(ix.cpu(), rc["local_indices"])):
                    replay_mismatch.append((step, li, r, "local"))
                loc.append((sc, ix))
            ms, mi = L.merge_shard_winners(torch.stack([x for x, _ in loc]),
                                           torch.stack([y for _, y in loc]),
                                           pcfg.top_k)
            if not all(torch.equal(mi.cpu(), rc["indices"])
                       and torch.equal(ms.cpu(), rc["scores"])
                       for rc in recs):
                replay_mismatch.append((step, li, "merged"))

    # the sharded winners against one device's: layer 0 (the same query
    # and keys in both runs) apart from the deeper layers, and layer 0's
    # recall of the exact top-k for both
    overlap, recall = {}, {}
    signs = SV.rotation_signs(cfg, dev)
    for step in samples:
        o = [float((rc["indices"][..., :, None]
                    == one_rc["indices"][..., None, :]).any(-1)
                   .float().mean())
             for rc, one_rc in zip(ranks[0]["samples"][step],
                                   one_samp[step])]
        overlap[step] = dict(layer0=o[0], deeper=float(np.mean(o[1:])))
        recall[step] = dict(zip(("sharded", "one_device"), _oracle_recall(
            st.caches[0]["kv"], ranks[0]["samples"][step][0],
            one_samp[step][0]["indices"], signs, pcfg.sink_size,
            pcfg.top_k)))
    same_tok = float(np.mean(np.asarray(ranks[0]["argmax"])
                             == np.asarray(one["argmax"])))
    # the capacity planner's reckoning of this layout: each collective's
    # bytes a layer-step, and a rank's cache bytes
    mesh = MX.gpu_mesh(1, S)
    coll = MX.collective_plan(cfg, "seq_shards", mesh, 1,
                              n_max)["per_layer_step"]
    planned = D.plan_combo(cfg.name, InputShape("seqshard", n_max, 1,
                                                "decode"), mesh,
                           layouts=("seq_shards",), cfg=cfg)[0]
    planned_bytes = planned["argument_parts"]["caches"]
    # per ParisKV layer-step one launch of each, and per promotion one
    # more (K-only, rank-masked) gather
    steps, layers = len(forced), cfg.num_layers
    want_launch = {name: steps * layers for name in
                   ("collision_paged", "bucket_count", "bucket_topk",
                    "rerank_topk_paged")}
    want_launch["gather_rows_paged"] = (steps + ranks[0]["promotions"]) \
        * layers
    rec = dict(
        arch="qwen2-1.5b", layers=cfg.num_layers, dtype=cfg.dtype,
        context=seq_len, context_source=f"INPUT_SHAPES[{SEQ_CONTEXT!r}]: "
        f"{INPUT_SHAPES[SEQ_CONTEXT].seq_len} tokens" + (
            f", cut to {seq_len} (the script's time limit)"
            if seq_len < INPUT_SHAPES[SEQ_CONTEXT].seq_len else ""),
        promotions=ranks[0]["promotions"],
        n_max=n_max, shards=S, backend=backend, new_tokens=steps,
        device=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        prefill_s=prefill_s, prefill_peak_mem_gb=prefill_peak,
        cache_bytes=dict(one_device=one_bytes,
                         per_rank=[rk["cache_bytes"] for rk in ranks],
                         planned_per_rank=planned_bytes),
        tokens_per_s=dict(ranks=[rk["tokens_per_s"] for rk in ranks],
                          one_device=steps / one_s),
        decode_s=dict(ranks=[rk["seconds"] for rk in ranks],
                      one_device=one_s, ranks_wall=ranks_s),
        peak_mem_gb=[rk["peak_mem_gb"] for rk in ranks],
        collective_bytes_per_layer_step=coll,
        same_token_share=same_tok,
        one_device_top2_gap_median=float(np.median(one["top2_gap"])),
        winner_overlap=overlap, layer0_recall_of_exact_topk=recall,
        sampled_steps=list(samples), launches=ranks[0]["launches"],
        launches_want=want_launch, replay_mismatches=replay_mismatch[:8])
    print("seqshard " + json.dumps(rec), flush=True)
    _check(all(rk["logits_sha"] == ranks[0]["logits_sha"]
               and rk["winners_sha"] == ranks[0]["winners_sha"]
               for rk in ranks), "the ranks' logits or winners differ")
    _check(not replay_mismatch,
           f"{len(replay_mismatch)} sampled layer-steps' winners differ "
           f"from the per-shard retrieve and merge replayed without "
           f"collectives: {replay_mismatch[:8]}")
    _check(all(rk["launches"].get(n) == c for rk in ranks
               for n, c in want_launch.items()),
           f"seqshard launches {ranks[0]['launches']} != {want_launch}")
    _check(all(b_ * S == one_bytes for b_ in rec["cache_bytes"]["per_rank"]),
           "a rank does not hold 1/shards of the ParisKV stores")
    _check(all(b_ == planned_bytes for b_ in rec["cache_bytes"]["per_rank"]),
           f"a rank's cache bytes {rec['cache_bytes']['per_rank']} differ "
           f"from the planner's {planned_bytes}")
    del params, st, shards
    return rec, kern


# ------------------------------------------------------------------ arch ---
def _moe_compare(p_dev, p_cpu, x, top_k: int):
    """One MoE call on the card and on the CPU (the same torch code on
    copies of the same float32 weights and inputs): ``x`` (1, n, d) runs
    ``moe_fwd``, (b, d) ``moe_decode``. Routing is a float32 product and
    a softmax, so a near tie can fall the other way on one side. → the
    tokens whose expert ids (or their order) differ, with each one's top-2
    gap (the least gap between neighbours among its top k + 1 CPU
    probabilities), the least gap of any token, and the largest output
    difference over the tokens whose expert ids and capacity positions
    agree on both sides (elsewhere a flip moves whom capacity drops)."""
    import torch
    from repro_torch.models import moe as MOE

    E = p_dev["router"].shape[1]
    if x.dim() == 3:
        y_dev = MOE.moe_fwd(p_dev, x, top_k)[0]
        y_cpu = MOE.moe_fwd(p_cpu, x.cpu(), top_k)[0]
    else:
        y_dev = MOE.moe_decode(p_dev, x, top_k)
        y_cpu = MOE.moe_decode(p_cpu, x.cpu(), top_k)
    xt = x.reshape(-1, x.shape[-1])
    _, _, idx_d = MOE._route(p_dev, xt, top_k)
    probs, _, idx_c = MOE._route(p_cpu, xt.cpu(), top_k)
    idx_d = idx_d.cpu()
    top = probs.sort(-1, descending=True).values[:, :top_k + 1]
    gaps = (top[:, :-1] - top[:, 1:]).min(-1).values
    flipped = (idx_d != idx_c).any(-1)
    same = ~flipped & (MOE._positions(idx_d, E)
                       == MOE._positions(idx_c, E)).all(-1)
    y_dev = y_dev.reshape(xt.shape).cpu()
    y_cpu = y_cpu.reshape(xt.shape)
    err = (y_dev - y_cpu)[same].abs()
    bound = MOE_ATOL + MOE_RTOL * y_cpu[same].abs()
    return dict(
        tokens=xt.shape[0], routing_flips=int(flipped.sum()),
        flip_gaps=[float(g) for g in gaps[flipped]],
        least_top2_gap=float(gaps.min()), compared=int(same.sum()),
        max_abs_err=float(err.max()) if err.numel() else 0.0,
        within_tolerance=bool((err <= bound).all()),
        max_abs_out=float(y_cpu.abs().max()))


def _moe_card_vs_cpu(dev, cfg, seed: int = 0):
    """(c) One MoE layer of ``cfg`` at full width in float32 (grok-1: 8
    experts of 6144 × 32768, 19.3 GB; deepseek-v2-lite: 64 of 2048 × 1408
    and a shared MLP of 2 × 1408), card against CPU: a
    ``MOE_TOKENS``-token ``moe_fwd`` and a ``MOE_ROWS``-row
    ``moe_decode``, held by ``_moe_compare``: routing equal wherever the
    top-2 gap exceeds ``MOE_GAP``, outputs within ``MOE_ATOL`` +
    ``MOE_RTOL`` · |out| where routing agrees."""
    import torch
    from repro_torch.models import moe as MOE

    gen = torch.Generator(device=dev).manual_seed(seed)
    p_dev = MOE.init_moe(cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                         cfg.num_shared_experts, torch.float32, dev, gen)
    p_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.cpu())   # shared experts
             for k, v in p_dev.items()}
    out = {}
    for name, shape in (("moe_fwd", (1, MOE_TOKENS, cfg.d_model)),
                        ("moe_decode", (MOE_ROWS, cfg.d_model))):
        x = torch.randn(shape, generator=gen, device=dev)
        out[name] = _moe_compare(p_dev, p_cpu, x, cfg.experts_per_token)
    del p_dev, p_cpu
    torch.cuda.empty_cache()
    for name, rec in out.items():
        _check(all(g <= MOE_GAP for g in rec["flip_gaps"]),
               f"{name}: routing differs from the CPU's at top-2 gaps "
               f"{rec['flip_gaps']} (above {MOE_GAP})")
        _check(rec["within_tolerance"],
               f"{name}: card and CPU outputs differ by "
               f"{rec['max_abs_err']} where routing agrees")
    return dict(dtype="float32", experts=cfg.num_experts,
                top_k=cfg.experts_per_token, d_model=cfg.d_model,
                d_ff=cfg.moe_d_ff, tolerance=dict(
                    atol=MOE_ATOL, rtol=MOE_RTOL, routing_gap=MOE_GAP),
                **out)


def _seed_gates(params, seed: int = 1) -> list:
    """Set every cross layer's ``cross_gate`` (zero at init) to a seeded
    value in (0.3, 0.9), in place → the gates."""
    import numpy as np
    rng = np.random.RandomState(seed)
    gates = []
    for p in params["layers"]:
        if "cross_gate" in p:
            p["cross_gate"].fill_(float(rng.uniform(0.3, 0.9)))
            gates.append(float(p["cross_gate"]))
    return gates


def _arch_serve(dev, cfg, full_layers: int, lens, gen: int, arrivals,
                slot: bool = False):
    """``cfg`` (random bf16 weights, seed 0; cross gates seeded non-zero)
    through the fused paged engine at the engine phase's geometry: the
    requests ``lens`` (with stub media on a cross-attention architecture)
    submitted before the chunks ``arrivals``, ``gen`` new tokens each,
    launches counted and checked and every chunk audited (``_serve``).
    ``slot``: through the contiguous slot engine of the same geometry
    instead (mamba2, which has no pool), no launch expected, no audit."""
    import torch
    from repro_torch.models.model import init_params, param_count
    from repro_torch.serving import ServingEngine

    before = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=dev)
    param_gb = (torch.cuda.memory_allocated() - before) / 1e9
    n_params = param_count(params)
    gates = _seed_gates(params)
    eng = (ServingEngine(cfg, params, n_max=16384, max_batch=4,
                         chunk_size=8, device=dev) if slot
           else _shard_engine(cfg, params, dev, 1))
    _warm(eng, cfg)
    rec, done = _serve(eng, _prompts(cfg, lens=lens), gen, arrivals,
                       {} if slot else PAGED_KERNELS, cfg, audit=not slot,
                       media=_media(cfg, len(lens)))
    rec = dict(arch=cfg.name, engine=type(eng).__name__,
               layers=cfg.num_layers,
               full_layers=full_layers, dtype=cfg.dtype, params=n_params,
               param_gb=param_gb, pool_bytes=_pool_bytes(eng),
               ring_bytes=_ring_bytes(eng), media_bytes=_media_bytes(eng),
               ssm_bytes=_ssm_bytes(eng),
               **({"cross_gates": gates} if gates else {}), **rec)
    del eng, params
    torch.cuda.empty_cache()
    return rec, done


def arch_phase(dev):
    """The architectures of this slice: grok-1's kernel rows (d), its MoE
    layer card against CPU (c), grok-1 at full width and ``GROK_LAYERS``
    layers (a), and llama3.1-8b at full width and depth (b)."""
    import dataclasses as dc
    import torch
    from repro_torch import configs

    grok_full = configs.get(GROK_ARCH)
    kern = _path_kernels(dev, grok_full, grok_full.num_kv_heads, "grok")
    moe = _moe_card_vs_cpu(dev, grok_full)
    grok_cfg = dc.replace(grok_full, num_layers=GROK_LAYERS)
    grok, done = _arch_serve(dev, grok_cfg, grok_full.num_layers, PROMPTS,
                             GEN, ARRIVALS)
    for uid, r in done.items():
        _check(r.promotions >= 1, f"grok request {uid} never promoted")
    llama_cfg = configs.get(LLAMA_ARCH)
    llama, _ = _arch_serve(dev, llama_cfg, llama_cfg.num_layers, LLAMA_LENS,
                           LLAMA_GEN, ARRIVALS[:len(LLAMA_LENS)])
    rec = dict(device=torch.cuda.get_device_name(0), grok=grok,
               llama=llama, moe_card_vs_cpu=moe,
               cut=f"{GROK_ARCH}: {GROK_LAYERS} of {grok_full.num_layers} "
                   f"layers (what one card holds)")
    print("arch " + json.dumps(rec), flush=True)
    return rec, kern


def _count_kernel(dev, cfg, tag: str, seed: int = 0):
    """``bucket_count`` at ``cfg``'s shapes (all its KV heads, B from its
    head_dim, four rows of the kernel phase's lengths in a (4, 16384)
    store): held exactly to its plain version and timed beside
    ``scatter_add_``, the record ``bucket_count/<tag>``."""
    import torch
    from repro_torch.core import retrieval as R
    from repro_torch.kernels.collision import bucket_count
    from repro_torch.kernels.collision import ops as CO
    from repro_torch.kernels.collision.ref import bucket_count_ref

    pcfg = cfg.pariskv
    b, G, n = 4, cfg.num_kv_heads, 16384
    B, nc, sink = (pcfg.num_subspaces(cfg.head_dim), pcfg.num_centroids(),
                   pcfg.sink_size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, nc, (b, G, n, B), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    enc_end = torch.tensor([ln - KERNEL_NEW - pcfg.local_size
                            for ln in LENS_AFTER], dtype=torch.int32,
                           device=dev)
    nval = int((enc_end - sink).clamp_min(0).sum())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    counts = bucket_count(ids, enc_end, sink, nc)
    _check(torch.equal(counts, bucket_count_ref(ids, enc_end, sink, nc)),
           f"bucket_count differs from its plain version ({tag} shapes)")
    valid = R.region_mask(n, enc_end, pcfg)[:, None]
    ids_t = ids.transpose(-1, -2).reshape(-1, n).long()
    upd = torch.broadcast_to(valid[..., None, :], (b, G, B, n)).reshape(
        -1, n).to(torch.int32)
    acc = torch.zeros((ids_t.shape[0], nc), dtype=torch.int32, device=dev)
    rec = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_count.cu",
        replaces="none: the jnp bucket_histogram of "
                 "src/repro/core/retrieval.py:79 (no TPU kernel)",
        max_abs_err=0, tolerance="exact", G=G, B=B, rows=b, n=n,
        cluster=CO.count_cluster(n), threads=CO.COUNT_THREADS,
        ms=_time_ms(lambda: bucket_count(ids, enc_end, sink, nc), flush),
        plain_ms=_time_ms(lambda: bucket_count_ref(ids, enc_end, sink, nc),
                          flush),
        library_ms=_time_ms(lambda: acc.scatter_add_(1, ids_t, upd), flush),
        library="scatter_add_ alone, on prepared int64 ids and updates")
    rec["bound_ms"], rec["bound_by"] = _bound(
        G * nval * B + b * 4 + counts.numel() * 4, G * nval * B)
    print(f"kernel bucket_count/{tag} " + json.dumps(rec), flush=True)
    return {f"bucket_count/{tag}": rec}


def gemma_phase(dev):
    """gemma's local/global layers: the kernels at gemma3-12b's shapes
    (a), gemma3-12b at full width and ``GEMMA3_LAYERS`` layers (b),
    gemma2-27b at full width and ``GEMMA2_LAYERS`` layers (c), and gemma3
    at one period in float32, chunked against solo (d)."""
    import dataclasses as dc
    import torch
    from repro_torch import configs

    g3 = configs.get(GEMMA3_ARCH)
    kern = _path_kernels(dev, g3, g3.num_kv_heads, "g3")
    kern.update(_count_kernel(dev, g3, "g3"))
    gemma3, done3 = _arch_serve(dev, dc.replace(g3, num_layers=GEMMA3_LAYERS),
                                g3.num_layers, LLAMA_LENS, GEN,
                                ARRIVALS[:len(LLAMA_LENS)])
    # the paged engine counts each admission's histograms with bucket_count
    _check(gemma3["launches"]["bucket_count"] > 0,
           "gemma3: bucket_count never launched in the main path")
    g2 = configs.get(GEMMA2_ARCH)
    gemma2, done2 = _arch_serve(dev, dc.replace(g2, num_layers=GEMMA2_LAYERS),
                                g2.num_layers, PROMPTS, GEN, ARRIVALS)
    for arch, done in (("gemma3", done3), ("gemma2", done2)):
        for uid, r in done.items():
            _check(r.promotions >= 1, f"{arch} request {uid} never promoted")
    f32 = _f32_identity(dev, g3, layers=g3.local_global_period)
    rec = dict(device=torch.cuda.get_device_name(0), gemma3=gemma3,
               gemma2=gemma2, f32_chunked_identical_to_solo=f32,
               cut=f"{GEMMA2_ARCH}: {GEMMA2_LAYERS} of {g2.num_layers} layers "
                   f"(4 local/global periods; full depth's weights, pool "
                   f"and rings leave no room for a 16,384-token prefill); "
                   f"{GEMMA3_ARCH}: {GEMMA3_LAYERS} of {g3.num_layers} "
                   f"(the script's time limit)")
    print("gemma " + json.dumps(rec), flush=True)
    return rec, kern


def _card_vs_cpu(fn, args_dev, move):
    """``fn`` on the card's ``args_dev`` and on their CPU copies
    (``move``) → (max |difference|, max |CPU output|); an ``fn`` that
    returns a tuple of outputs gives a list of those pairs."""
    import torch
    got = fn(*args_dev)
    want = fn(*move(args_dev))
    torch.cuda.synchronize()

    def pair(g, w):
        return float((g.cpu() - w).abs().max()), float(w.abs().max())
    if isinstance(got, tuple):
        return [pair(g, w) for g, w in zip(got, want)]
    return pair(got, want)


def _cross_card_vs_cpu(dev, whisper, vision, seed: int = 0):
    """(d) Float32 at full width, card against the port's CPU run of the
    same function on copies of the same seeded weights and inputs:
    whisper's encoder at one layer over 1,500 stub frames
    (``encoder_fwd``), a whisper layer's cross sublayer
    (``attn_cross_decode``) and a whole vision cross layer (``_layer_decode``:
    the gated cross attention and the MLP, gate non-zero), each one decode
    step of ``CROSS_ROWS`` rows over random media K/V of its full length.
    Each held to ``CROSS_RTOL`` of the output's largest magnitude."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.data import media_stub
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    # whisper's encoder, one layer
    cfg = dataclasses.replace(whisper, num_layers=1, encoder_layers=1,
                              dtype="float32")
    params = M.init_params(cfg, seed=seed, device=dev)
    enc = {"encoder": params["encoder"],
           "enc_final_norm": params["enc_final_norm"]}
    feats = torch.from_numpy(media_stub(1, cfg.encoder_seq, cfg.d_model,
                                        seed=seed)).to(dev)
    out["whisper_encoder_layer"] = _card_vs_cpu(
        lambda p, f: M.encoder_fwd(p, cfg, f), (enc, feats), cpu)
    # whisper's cross sublayer, one decode step
    ld = M.layer_defs(cfg)[0]
    T, G, hd = cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim
    media = tuple(torch.randn((CROSS_ROWS, T, G, hd), generator=gen,
                              device=dev) for _ in range(2))
    h = L.rms_norm(torch.randn((CROSS_ROWS, cfg.d_model), generator=gen,
                               device=dev), params["layers"][0]["norm_cross"])
    out["whisper_cross_decode"] = _card_vs_cpu(
        lambda p, x, m: L.attn_cross_decode(p, x, m, ld.attn),
        (params["layers"][0]["cross"], h, media), cpu)
    del params, enc, media
    # a vision cross layer, one decode step
    cfg = dataclasses.replace(vision, dtype="float32")
    ld = M.layer_plan(cfg)[0].layers[-1]
    p = M.init_layer(cfg, ld, dev, gen)
    p["cross_gate"].fill_(0.6)
    T, G, hd = cfg.num_media_tokens, cfg.num_kv_heads, cfg.head_dim
    media = tuple(torch.randn((CROSS_ROWS, T, G, hd), generator=gen,
                              device=dev) for _ in range(2))
    x = torch.randn((CROSS_ROWS, cfg.d_model), generator=gen, device=dev)

    def layer(p, x, m):
        z = torch.zeros((CROSS_ROWS,), dtype=torch.int32, device=x.device)
        return SV._layer_decode(
            p, x, ld, cfg, {"media_kv": m, "cross": True},
            CC.CacheRegions(z, z), None, 0, z.bool(), False, None, None,
            None, True, True)
    out["vision_cross_layer_decode"] = _card_vs_cpu(layer, (p, x, media),
                                                    cpu)
    del p, media
    torch.cuda.empty_cache()
    for name, (err, mag) in out.items():
        _check(err <= CROSS_RTOL * mag,
               f"{name}: card and CPU differ by {err} (outputs up to {mag})")
    return dict(dtype="float32", rows=CROSS_ROWS, rtol=CROSS_RTOL,
                **{k: dict(max_abs_err=e, max_abs_out=m)
                   for k, (e, m) in out.items()})


def cross_phase(dev):
    """The cross-attention architectures: the kernels at whisper's shapes
    (a), whisper-large-v3 at full width and ``WHISPER_LAYERS`` decoder
    layers (its 32 encoder layers whole), every request promoting (b),
    llama-3.2-vision-11b at full width and depth with non-zero cross
    gates (c), and float32 card against CPU at full width (d)."""
    import torch
    from repro_torch import configs
    from repro_torch.models.serve import media_len

    w = configs.get(WHISPER_ARCH)
    kern = _path_kernels(dev, w, w.num_kv_heads, "w")
    kern.update(_count_kernel(dev, w, "w"))
    w_cut = dataclasses.replace(w, num_layers=WHISPER_LAYERS)
    whisper, done = _arch_serve(dev, w_cut, w.num_layers, PROMPTS, GEN,
                                ARRIVALS)
    for uid, r in done.items():
        _check(r.promotions >= 1, f"whisper request {uid} never promoted")
    v = configs.get(VISION_ARCH)
    vision, _ = _arch_serve(dev, v, v.num_layers, LLAMA_LENS, LLAMA_GEN,
                            ARRIVALS[:len(LLAMA_LENS)])
    for rec, cfg in ((whisper, w_cut), (vision, v)):
        # K and V, bf16, every slot of every cross layer or sublayer
        n_cross = (cfg.num_layers // cfg.cross_attn_period
                   if cfg.cross_attn_period else cfg.num_layers)
        want = (4 * n_cross * media_len(cfg) * cfg.num_kv_heads
                * cfg.head_dim * 2 * 2)
        _check(rec["media_bytes"] == want,
               f"{cfg.name}: media bytes {rec['media_bytes']} != {want}")
        _check(rec["ring_bytes"] == 0, f"{cfg.name}: ring buffers")
    _check(all(g > 0.29 for g in vision["cross_gates"]),
           "vision: a cross gate is zero")
    f32 = _cross_card_vs_cpu(dev, w, v)
    rec = dict(device=torch.cuda.get_device_name(0), whisper=whisper,
               vision=vision, card_vs_cpu=f32,
               note="head sharding of the cross families is held on the "
                    "CPU (tests/test_torch_cross_engines.py), not here")
    print("cross " + json.dumps(rec), flush=True)
    return rec, kern


def _ssm_card_vs_cpu(dev, hymba, mamba, seed: int = 0):
    """(d) Float32 at full width, card against the port's CPU run of the
    same function on copies of the same seeded weights and inputs: one
    hymba layer (``_layer_prefill``: ParisKV attention and the SSD mixer,
    halved, then the MLP) over ``len(SSM_F32_LENS)`` LEFT-aligned rows of
    up to ``SSM_F32_LEN`` tokens, and that prefill followed by one
    ``_layer_decode`` step on the contiguous path (the retrieval region is
    still empty at these lengths, so the winners cannot flip); one mamba2
    mixer's ``ssm_prefill`` over the same rows and one ``ssm_decode``
    step. Each held to ``CROSS_RTOL`` of the output's largest
    magnitude."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import ssm as SSM

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    b, S = len(SSM_F32_LENS), SSM_F32_LEN
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.tensor(SSM_F32_LENS, dtype=torch.int32, device=dev)
    out = {}
    # one hymba layer
    cfg = dataclasses.replace(hymba, num_layers=1, dtype="float32")
    ld = M.layer_defs(cfg)[0]
    p = M.init_layer(cfg, ld, dev, gen)
    x = torch.randn((b, S, cfg.d_model), generator=gen, device=dev)
    x_t = torch.randn((b, cfg.d_model), generator=gen, device=dev)

    def layer(p, x, lens, x_t):
        d = x.device
        cache = SV.make_caches(cfg, b, 2 * S, d)[0]
        valid = torch.arange(S, device=d)[None] < lens[:, None]
        signs = SV.rotation_signs(cfg, d)
        y = SV._layer_prefill(p, x, ld, cfg,
                              torch.arange(S, device=d).expand(b, S), cache,
                              signs, lens, None, valid)
        y_t = SV._layer_decode(
            p, x_t, ld, cfg, cache, CC.initial_regions(lens, cfg.pariskv),
            signs, cfg.pariskv.candidate_count(2 * S),
            torch.zeros((b,), dtype=torch.bool, device=d), False, None, None,
            None, True, True)
        return y, y_t
    (out["hymba_layer_prefill"],
     out["hymba_layer_decode"]) = _card_vs_cpu(layer, (p, x, lens, x_t), cpu)
    del p
    # one mamba2 mixer
    cfg = dataclasses.replace(mamba, num_layers=1, dtype="float32")
    p = SSM.init_ssm(cfg, torch.float32, dev, gen)
    x = torch.randn((b, S, cfg.d_model), generator=gen, device=dev)
    x_t = torch.randn((b, cfg.d_model), generator=gen, device=dev)

    def mixer(p, x, lens, x_t):
        valid = torch.arange(S, device=x.device)[None] < lens[:, None]
        y, cache = SSM.ssm_prefill(p, x, cfg, token_valid=valid,
                                   lengths=lens)
        return y, SSM.ssm_decode(p, x_t, cache, cfg)[0]
    (out["mamba2_ssm_prefill"],
     out["mamba2_ssm_decode"]) = _card_vs_cpu(mixer, (p, x, lens, x_t), cpu)
    del p
    torch.cuda.empty_cache()
    for name, (err, mag) in out.items():
        _check(err <= CROSS_RTOL * mag,
               f"{name}: card and CPU differ by {err} (outputs up to {mag})")
    return dict(dtype="float32", rows=b, lengths=list(SSM_F32_LENS),
                rtol=CROSS_RTOL,
                **{k: dict(max_abs_err=e, max_abs_out=m)
                   for k, (e, m) in out.items()})


def ssm_phase(dev):
    """The state-space architectures: the kernels at hymba's shapes (a),
    hymba-1.5b at full width and ``HYMBA_LAYERS`` layers through the fused
    paged engine, every request promoting (b), mamba2-780m at full width
    and depth through the slot engine with no ParisKV launch (c), and
    float32 card
    against CPU at full width (d)."""
    import torch
    from repro_torch import configs

    hy = configs.get(HYMBA_ARCH)
    kern = _path_kernels(dev, hy, hy.num_kv_heads, "h")
    kern.update(_count_kernel(dev, hy, "h"))
    hy_cut = dataclasses.replace(hy, num_layers=HYMBA_LAYERS)
    hymba, done = _arch_serve(dev, hy_cut, hy.num_layers, PROMPTS, GEN,
                              ARRIVALS)
    for uid, r in done.items():
        _check(r.promotions >= 1, f"hymba request {uid} never promoted")
    ma = configs.get(MAMBA_ARCH)
    mamba, _ = _arch_serve(dev, ma, ma.num_layers, LLAMA_LENS, MAMBA_GEN,
                           ARRIVALS[:len(LLAMA_LENS)], slot=True)
    _check(not any(mamba["launches"].values()),
           f"mamba2: ParisKV kernels launched: {mamba['launches']}")
    for rec, cfg in ((hymba, hy_cut), (mamba, ma)):
        want = _ssm_bytes_want(cfg, 4)
        _check(rec["ssm_bytes"] == want,
               f"{cfg.name}: SSM state bytes {rec['ssm_bytes']} != {want}")
    _check(mamba["pool_bytes"] == 0, "mamba2: a pool")
    _check(hymba["ring_bytes"] == hymba["media_bytes"] == 0,
           "hymba: ring or media bytes")
    f32 = _ssm_card_vs_cpu(dev, hy, ma)
    rec = dict(device=torch.cuda.get_device_name(0), hymba=hymba,
               mamba2=mamba, card_vs_cpu=f32,
               note="hymba's head sharding is held on the CPU "
                    "(tests/test_torch_ssm_engines.py), not here")
    print("ssm " + json.dumps(rec), flush=True)
    return rec, kern


# ------------------------------------------------------------------ mla ---
def _mla_ptxas() -> None:
    """Registers, shared memory and spills of the wide instantiations (the
    wide Stage I, Stage II at B = 128, ``bucket_count<128>``), from nvcc's
    -Xptxas -v logs."""
    from repro_torch.kernels import build
    picks = {"collision_paged": "wide", "rerank_topk_paged": "ILi32ELi1E",
             "bucket_count": "ILi128E"}
    for source, tag in picks.items():
        rep = {k: v for k, v in build.ptxas_report(source).items()
               if tag in k}
        _check(bool(rep), f"ptxas: no {tag} instantiation in {source}")
        print(f"ptxas_wide {source} " + json.dumps(rep), flush=True)


def _mla_kernels(dev, cfg, seed: int = 0, n: int = 16384):
    """(a) The "m" rows: Stage I (the wide mode: a 16-lane tier table),
    the cut, Stage II with its top-k, the K-only decode gather and
    ``bucket_count`` at deepseek-v2-lite's decode shapes: four slots of a
    (4, 16384) latent store (576 wide, bf16; its metadata B = 128), G 1,
    Hg 16 query heads, score range 768 (770 bins), C 1311, top-k 100, the
    kernel phase's region ends. Each held to its plain version (exact;
    Stage II's estimates to its tolerance, its selection exact) and timed
    beside its plain version and library call. Stage II's bound is priced
    on the distinct (row, position) candidates (its 16 heads share one
    latent's metadata) and printed beside the bound over every head's."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.core import centroids
    from repro_torch.core import encode as E
    from repro_torch.core import retrieval as R
    from repro_torch.kernels import SEG_LEN, row_tables
    from repro_torch.kernels.bucket_topk import bucket_topk
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision import (bucket_count,
                                               collision_scores_kernel,
                                               lane_packed_table,
                                               table_lanes)
    from repro_torch.kernels.collision import ops as CO
    from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                                   collision_paged_ref)
    from repro_torch.kernels.gather_kv import gather_decode_paged
    from repro_torch.kernels.gather_kv.ref import gather_decode_paged_ref
    from repro_torch.kernels.rerank import rerank_topk_paged
    from repro_torch.kernels.rerank.ref import rerank_topk_paged_ref
    from repro_torch.models import mla as MLA
    from repro_torch.models.serve import rotation_signs

    pcfg = cfg.pariskv
    b, G, Hg = 4, 1, cfg.num_heads
    D = cfg.retrieval_dim()
    B, m, nc = pcfg.num_subspaces(D), pcfg.m, pcfg.num_centroids()
    sink, W, k_top = pcfg.sink_size, CC.window_size(pcfg), pcfg.top_k
    C = pcfg.candidate_count(n)
    rng_s = R.max_collision_score(pcfg, B)
    gen = torch.Generator(device=dev).manual_seed(seed)
    signs = rotation_signs(cfg, dev)
    cache = MLA.init_mla_cache(b, n, cfg, torch.bfloat16, dev)
    lat = torch.randn((b, n, D), generator=gen, device=dev)
    cache.latent.copy_(lat)
    for i in range(b):                    # one row at a time: ~1 GB a row
        meta = E.encode_keys(lat[i:i + 1, None], pcfg, signs)
        for dst, src in zip(cache[1:], meta):
            dst[i:i + 1].copy_(src)
    ids, rows1 = cache.meta_ids, row_tables(b, dev)
    enc_end = torch.tensor([ln - KERNEL_NEW - pcfg.local_size
                            for ln in LENS_AFTER], dtype=torch.int32,
                           device=dev)
    pos = enc_end + pcfg.local_size + 150
    nval = int((enc_end - sink).clamp_min(0).sum())
    # each query head near a key of its row's retrieval region, as a
    # trained model's queries lie near some keys: scores past 255
    at = (sink + torch.rand((b, Hg), generator=gen, device=dev)
          * (enc_end - sink)[:, None]).long()
    q = (lat[torch.arange(b, device=dev)[:, None], at]
         + 0.3 * torch.randn((b, Hg, D), generator=gen, device=dev))[:, None]
    qt = E.encode_query(q, pcfg, signs)
    del lat, meta
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shape = dict(G=G, Hg=Hg, latent=D, dtype="bfloat16", B=B, rows=b, n=n,
                 score_range=rng_s, C=C, top_k=k_top)
    out = {}

    # bucket_count at B = 128
    counts = bucket_count(ids, enc_end, sink, nc)
    _check(torch.equal(counts, bucket_count_ref(ids, enc_end, sink, nc)),
           "bucket_count differs from its plain version (m shapes)")
    valid = R.region_mask(n, enc_end, pcfg)[:, None]
    ids_t = ids.transpose(-1, -2).reshape(-1, n).long()
    upd = torch.broadcast_to(valid[..., None, :], (b, G, B, n)).reshape(
        -1, n).to(torch.int32)
    acc = torch.zeros((ids_t.shape[0], nc), dtype=torch.int32, device=dev)
    out["bucket_count/m"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_count.cu",
        replaces="none: the jnp bucket_histogram of "
                 "src/repro/core/retrieval.py:79 (no TPU kernel)",
        max_abs_err=0, tolerance="exact", **shape,
        cluster=CO.count_cluster(n), threads=CO.COUNT_THREADS,
        ms=_time_ms(lambda: bucket_count(ids, enc_end, sink, nc), flush),
        plain_ms=_time_ms(lambda: bucket_count_ref(ids, enc_end, sink, nc),
                          flush),
        library_ms=_time_ms(lambda: acc.scatter_add_(1, ids_t, upd), flush),
        library="scatter_add_ alone, on prepared int64 ids and updates",
        bound=_bound(G * nval * B + b * 4 + counts.numel() * 4,
                     G * nval * B))
    del ids_t, upd, acc

    # Stage I, the wide mode
    cs = centroids.centroid_scores(qt.q_sub, m)
    n_valid = (enc_end - sink).clamp_min(0)
    lanes = table_lanes(Hg, B, rng_s)
    _check(lanes == 16, f"deepseek's tier table takes {lanes} lanes, not 16")
    tables = R.tier_weight_table(cs, counts[:, :, None],
                                 n_valid[:, None, None], pcfg,
                                 out=lane_packed_table(*cs.shape, device=dev,
                                                       lanes=lanes))
    coarse, seg_hist = collision_scores_kernel(ids, tables, enc_end, sink,
                                               rng_s)
    want, want_hist = collision_paged_ref(ids, rows1, tables, enc_end, sink,
                                          rng_s)
    _check(torch.equal(coarse, want) and torch.equal(seg_hist, want_hist),
           "collision_paged (wide) differs from its plain version")
    _check(int(coarse.max()) > 255, "the wide scores stay below 256")
    del want, want_hist
    out["collision_paged/m"] = dict(
        route="cuda", source="src/repro_torch/csrc/collision_paged.cu",
        replaces="src/repro/kernels/collision/collision.py:83",
        max_abs_err=0, tolerance="exact (scores and seg_hist)",
        mode="wide: a 16-lane table staged 16 subspaces at a time",
        **shape,
        ms=_time_ms(lambda: collision_scores_kernel(ids, tables, enc_end,
                                                    sink, rng_s), flush),
        plain_ms=_time_ms(lambda: collision_paged_ref(
            ids, rows1, tables, enc_end, sink, rng_s), flush),
        library_ms=None,
        bound_parts_bytes=dict(ids=G * nval * B, tables=b * G * Hg * B * nc,
                               scores=coarse.numel() * 4,
                               seg_hist=seg_hist.numel() * 4),
        bound=_bound(G * nval * B + b * G * Hg * B * nc + b * 4
                     + coarse.numel() * 4 + seg_hist.numel() * 4,
                     G * nval * B))

    # the cut: 770 bins
    cand = bucket_topk(coarse, C, rng_s, seg_hist=seg_hist)
    _check(torch.equal(cand, bucket_topk_ref(coarse, C, rng_s)),
           "bucket_topk differs from its plain version (m shapes)")
    seg_read = int(torch.zeros(coarse.shape[:-1] + (n // SEG_LEN,),
                               dtype=torch.int32, device=dev).scatter_(
        -1, (cand // SEG_LEN).long(), 1).sum())
    out["bucket_topk/m"] = dict(
        route="cuda", source="src/repro_torch/csrc/bucket_topk.cu",
        replaces="src/repro/kernels/bucket_topk/bucket_topk.py:50",
        max_abs_err=0, tolerance="exact", **shape,
        ms=_time_ms(lambda: bucket_topk(coarse, C, rng_s, seg_hist=seg_hist),
                    flush),
        plain_ms=_time_ms(lambda: bucket_topk_ref(coarse, C, rng_s), flush),
        library_ms=_time_ms(lambda: torch.topk(coarse, C, -1, sorted=False),
                            flush),
        bound=_bound(seg_hist.numel() * 4 + seg_read * SEG_LEN * 4
                     + cand.numel() * 4, 0))

    # Stage II with its top-k at B = 128
    q_sub = qt.q_sub.float().contiguous()
    q_norm = qt.q_norm.float().contiguous()
    args = (cache.meta_codes, cache.meta_w, rows1, cand, q_sub, q_norm,
            enc_end, sink, k_top, m, pcfg.magnitude_bits)
    won, err = _stage2_checks(args, n, "m shapes")
    ok = (cand >= sink) & (cand < enc_end[:, None, None, None])
    n_cand = int(ok.sum())
    keyed = torch.where(ok, cand.long()
                        + torch.arange(b, device=dev)[:, None, None, None]
                        * n, -1)
    n_distinct = int(torch.unique(keyed[keyed >= 0]).numel())
    small = (cand.numel() * 8 + b * 4 + b * G * Hg * k_top * 16
             + q_sub.numel() * 4 + q_norm.numel() * 4)
    ops = n_cand * (2 * B * m + 2 * B)
    all_heads = _bound(n_cand * B * 8 + small, ops)
    out["rerank_topk_paged/m"] = dict(
        route="cuda", source="src/repro_torch/csrc/rerank_topk_paged.cu",
        replaces="src/repro/kernels/rerank/rerank.py:78",
        max_abs_err=err,
        tolerance=f"estimates rtol {RERANK_RTOL}, atol {RERANK_ATOL}; the "
                  f"selection exact against the plain top-k of the "
                  f"kernel's own estimates", **shape,
        candidates_valid=n_cand, candidates_distinct=n_distinct,
        bound_ms_every_head=all_heads[0],
        ms=_time_ms(lambda: rerank_topk_paged(*args), flush),
        plain_ms=_time_ms(lambda: rerank_topk_paged_ref(*args), flush),
        library_ms=None,
        bound=_bound(n_distinct * B * 8 + small, ops))

    # the K-only decode gather: sink, window and the winners' latent rows
    lat4 = cache.latent[:, :, None]
    ws = (pos + 2 - W).clamp(0, n - W).to(torch.int32)
    phys = won.phys_rows

    def kern():
        return gather_decode_paged(lat4, None, rows1, ws, sink, W, phys)
    got = kern()
    plain = gather_decode_paged_ref(lat4, None, rows1, ws, sink, W, phys)
    _check(got[1] is None and got[3] is None
           and torch.equal(got[0], plain[0]) and torch.equal(got[2], plain[2]),
           "gather_rows_paged (K only) differs from its plain version")
    flat = cache.latent.reshape(b * n, 1, D)
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      ws[:, None] + torch.arange(W, device=dev)], 1)
    rows_l = (torch.arange(b, device=dev)[:, None] * n + lidx).long()
    rows_p = phys.long()
    out["gather_rows_paged/m"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_rows_paged.cu",
        replaces="src/repro/kernels/gather_kv/gather_kv.py:46",
        max_abs_err=0, tolerance="exact", mode="K only (the latent is K "
        "and V)", **shape, row_bytes=D * 2,
        ms=_time_ms(kern, flush),
        plain_ms=_time_ms(lambda: gather_decode_paged_ref(
            lat4, None, rows1, ws, sink, W, phys), flush),
        library_ms=_time_ms(lambda: (flat[rows_l], flat[rows_p, 0]), flush),
        bound=_bound(2 * (got[0].numel() + got[2].numel()) * 2
                     + phys.numel() * 4 + b * 4, 0))
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        print(f"kernel {name} " + json.dumps(rec), flush=True)
    _mla_ptxas()
    del cache, coarse, seg_hist, tables, cand
    torch.cuda.empty_cache()
    return out


def _mla_card_vs_cpu(dev, cfg, seed: int = 0):
    """(c) Float32 at full width, card against the port's CPU run of the
    same code on copies of the same seeded weights and inputs: one MLA
    layer's ``mla_train`` and ``mla_prefill_cache`` over MLA_F32_ROWS
    prompts of MLA_F32_LEN tokens (576-wide latent, B = 128: the wide
    kernels on the card, the plain versions on the CPU), then
    MLA_F32_STEPS ``mla_decode`` steps retrieving over [sink, enc_end):
    the prefill within CROSS_RTOL of its output's magnitude, and each
    step whose every (row, head) winner set agrees on both sides too;
    then one 64-expert MoE layer (``_moe_card_vs_cpu``)."""
    import torch
    from repro_torch.core import cache as CC
    from repro_torch.models import mla as MLA
    from repro_torch.models.serve import rotation_signs

    b, S, steps = MLA_F32_ROWS, MLA_F32_LEN, MLA_F32_STEPS
    n_max = 2 * S
    pcfg = cfg.pariskv
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = MLA.init_mla(cfg, torch.float32, dev, gen)
    x = torch.randn((b, S, cfg.d_model), generator=gen, device=dev)
    xs = torch.randn((steps, b, cfg.d_model), generator=gen, device=dev)
    C = pcfg.candidate_count(n_max)

    def layer(p, x, xs):
        d = x.device
        cache = MLA.init_mla_cache(b, n_max, cfg, torch.float32, d)
        positions = torch.arange(S, device=d).expand(b, S)
        signs = rotation_signs(cfg, d)
        y = MLA.mla_train(p, x, cfg, positions)
        MLA.mla_prefill_cache(p, x, cache, cfg, positions, signs)
        regions = CC.initial_regions(
            torch.full((b,), S, dtype=torch.int32, device=d), pcfg)
        ys, won = [], []
        for t in range(steps):
            y_t, res = MLA.mla_decode(p, xs[t], cache, regions, cfg, signs,
                                      C)
            ys.append(y_t)
            won.append(res.indices.sort(-1).values)
            regions = CC.CacheRegions(regions.pos + 1, regions.enc_end)
        return y, torch.stack(ys), torch.stack(won)

    y_d, ys_d, won_d = layer(p, x, xs)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    y_c, ys_c, won_c = layer(p_cpu, x.cpu(), xs.cpu())
    torch.cuda.synchronize()
    agree = [bool(torch.equal(won_d[t].cpu(), won_c[t]))
             for t in range(steps)]
    pre = (float((y_d.cpu() - y_c).abs().max()), float(y_c.abs().max()))
    dec = [(float((ys_d[t].cpu() - ys_c[t]).abs().max()),
            float(ys_c[t].abs().max())) for t in range(steps)]
    _check(pre[0] <= CROSS_RTOL * pre[1],
           f"mla prefill: card and CPU differ by {pre[0]} (outputs up to "
           f"{pre[1]})")
    _check(any(agree), "mla decode: no step's winner sets agree")
    for t, (err, mag) in enumerate(dec):
        if agree[t]:
            _check(err <= CROSS_RTOL * mag,
                   f"mla decode step {t}: card and CPU differ by {err} "
                   f"(outputs up to {mag})")
    del p, p_cpu
    torch.cuda.empty_cache()
    return dict(dtype="float32", rows=b, prompt=S, n_max=n_max, C=C,
                rtol=CROSS_RTOL,
                mla_prefill=dict(max_abs_err=pre[0], max_abs_out=pre[1]),
                mla_decode=[dict(step=t, winners_agree=agree[t],
                                 max_abs_err=e, max_abs_out=mg)
                            for t, (e, mg) in enumerate(dec)],
                moe=_moe_card_vs_cpu(dev, cfg))


def _latent_bytes(eng):
    """Device bytes of the MLA latents and of their metadata, all
    layers."""
    from repro_torch.models.serve import is_mla
    lats = [lc["kv"] for lc in eng._state.caches if is_mla(lc)]
    return (sum(c.latent.nbytes for c in lats),
            sum(t.nbytes for c in lats for t in c[1:]))


def _mla_serve(dev, cfg):
    """(b) ``cfg`` at full width and depth (random bf16 weights, seed 0)
    through the slot ``ServingEngine`` (4 slots, n_max 16384, chunks of
    8) on MLA_LENS with MLA_GEN new tokens each: Stage I, the cut, Stage
    II and ``bucket_count`` launched exactly once per MLA layer and step,
    the gather once plus at most once per promotion, every request
    promoting, the latent and metadata bytes exactly 4 × 16384 × layers ×
    (576 bf16; 128 ids, codes and weights: 1,152 bytes each), no pool."""
    import torch
    from repro_torch.models.model import init_params, param_count
    from repro_torch.serving import ServingEngine

    before = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=dev)
    param_gb = (torch.cuda.memory_allocated() - before) / 1e9
    eng = ServingEngine(cfg, params, n_max=16384, max_batch=4, chunk_size=8,
                        device=dev)
    _warm(eng, cfg)
    rec, done = _serve(eng, _prompts(cfg, lens=MLA_LENS), MLA_GEN,
                       ARRIVALS[:len(MLA_LENS)], SLOT_KERNELS, cfg,
                       exact=EXACT + ("bucket_count",))
    for uid, r in done.items():
        _check(r.promotions >= 1, f"deepseek request {uid} never promoted")
    lat_b, meta_b = _latent_bytes(eng)
    rows = 4 * 16384 * cfg.num_layers
    D = cfg.retrieval_dim()
    want = (rows * D * 2, rows * cfg.pariskv.num_subspaces(D) * (1 + 4 + 4))
    _check((lat_b, meta_b) == want,
           f"deepseek: latent and metadata bytes {(lat_b, meta_b)}, not "
           f"{want}")
    _check(_pool_bytes(eng) == 0, "deepseek: a pool")
    rec = dict(arch=cfg.name, engine=type(eng).__name__, slots=4,
               layers=cfg.num_layers, dtype=cfg.dtype,
               params=param_count(params), param_gb=param_gb,
               latent_bytes=lat_b, metadata_bytes=meta_b, **rec)
    del eng, params
    torch.cuda.empty_cache()
    return rec


def mla_phase(dev):
    """deepseek-v2-lite's MLA: the wide kernels at its shapes, the "m"
    rows (a), the model at full width and depth through the slot engine
    (b), and float32 card against CPU of an MLA layer and a 64-expert MoE
    layer (c)."""
    import torch
    from repro_torch import configs

    cfg = configs.get(DEEPSEEK_ARCH)
    kern = _mla_kernels(dev, cfg)
    deepseek = _mla_serve(dev, cfg)
    f32 = _mla_card_vs_cpu(dev, cfg)
    rec = dict(device=torch.cuda.get_device_name(0), deepseek=deepseek,
               card_vs_cpu=f32,
               note="deepseek's paged, offloaded and sharded engines "
                    "refuse it (tests/test_torch_mla_engines.py)")
    print("mla " + json.dumps(rec), flush=True)
    return rec, kern


# ------------------------------------------------------------- baselines ---
def _near_ties(differ, gap, scale: float) -> dict:
    """The share of equal entries and the margins (``gap``) of those that
    differ; ``ok`` when every margin lies within ``BASE_NOISE`` of
    ``scale``."""
    margins = gap[differ].double()
    return dict(share_equal=1.0 - float(differ.double().mean()),
                differ=int(differ.sum()),
                max_margin=float(margins.max()) if margins.numel() else None,
                ok=bool(not margins.numel()
                        or float(margins.max()) <= BASE_NOISE * scale))


def _assign_ties(x, cents, got):
    """``got`` (the card's nearest centroids of x, on the CPU) against
    the CPU's ``assign_clusters`` on the same centroids; the margin of a
    differing point is its squared-distance gap (float64)."""
    from repro_torch.baselines.pqcache import assign_clusters
    differ = got != assign_clusters(x, cents)
    gap = x.new_zeros((x.shape[0],), dtype=x.dtype).double()
    rows = differ.nonzero()[:, 0]
    d2 = ((x[rows].double()[:, None] - cents.double()[None]) ** 2).sum(-1)
    if rows.numel():
        two = d2.topk(2, -1, largest=False).values
        gap[rows] = two[:, 1] - two[:, 0]
    scale = float((x.double() ** 2).sum(-1).max())
    return _near_ties(differ, gap, scale)


def _id_ties(got, want, score):
    """Ids from the card against the CPU's; a differing position's margin
    is the gap between the two ids' float64 scores."""
    got, want = got.cpu().long(), want.long()
    return _near_ties(got != want, (score[got] - score[want]).abs(),
                      float(score.abs().max()))


def baselines_phase(dev, seed: int = 0):
    """The paper's baselines and the exact oracle over ``BASE_KEYS``
    keys of one head on the card: build and retrieve times (CUDA events),
    each method's recall against ``exact_topk``, and card against CPU on
    the same inputs (signatures; assignments and PQ codes from the card's
    fitted centroids; every method's ids from the same tables and book),
    equal but at float near ties."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.baselines import magicpig as MP
    from repro_torch.baselines import pqcache as PQ
    from repro_torch.core.retrieval import exact_topk, recall_at_k

    rng = np.random.RandomState(seed)
    keys = torch.from_numpy(rng.randn(BASE_KEYS, BASE_DIM).astype(
        np.float32))
    q = torch.from_numpy(rng.randn(BASE_DIM).astype(np.float32))
    kd, qd = keys.to(dev), q.to(dev)
    valid = torch.ones(BASE_KEYS, dtype=torch.bool, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    K.reset_launches()
    lsh = MP.make_params(BASE_DIM, 10, 10, seed=seed, device=dev)
    tables = MP.build(kd, lsh)
    book = PQ.build_pq(kd, seed=seed)
    torch.cuda.synchronize()
    ms = dict(build=_time_ms(lambda: MP.build(kd, lsh), flush, iters=5),
              build_pq=_time_ms(lambda: PQ.build_pq(kd, seed=seed), flush,
                                iters=2))
    calls = dict(
        retrieve=lambda: MP.retrieve(tables, qd, BASE_TOP_K),
        coarse_retrieve=lambda: PQ.coarse_retrieve(kd, book.coarse, qd,
                                                   BASE_TOP_K),
        pq_retrieve=lambda: PQ.pq_retrieve(book, qd, BASE_TOP_K),
        exact_topk=lambda: exact_topk(kd, qd, valid, BASE_TOP_K)[0])
    ids = {name: fn() for name, fn in calls.items()}
    ms.update({name: _time_ms(fn, flush, iters=10)
               for name, fn in calls.items()})
    recall = {name: float(recall_at_k(ids[name], ids["exact_topk"]))
              for name in ("retrieve", "coarse_retrieve", "pq_retrieve")}
    _check(sum(K.LAUNCHES.values()) == 0, f"the baselines launched ParisKV "
           f"kernels: {dict(K.LAUNCHES)}")
    # card against CPU on the same inputs
    lsh_c = MP.LSHParams(lsh.projections.cpu())
    tables_c = MP.build(keys, lsh_c)
    book_c = PQ.PQCodebook(*(t.cpu() for t in book))
    proj = (keys.double() @ lsh_c.projections.reshape(100, BASE_DIM).T
            .double()).abs()
    cmp = dict(signatures=_near_ties(
        tables.codes.cpu() != tables_c.codes,
        proj.reshape(BASE_KEYS, 10, 10).amin(-1), float(proj.max())))
    cmp["assignments"] = _assign_ties(keys, book_c.coarse,
                                      book.assignments.cpu())
    n_sub, m = book_c.pq_codes.shape[1], book_c.sub_codebooks.shape[-1]
    resid = (keys - book_c.coarse[book_c.assignments]).reshape(
        BASE_KEYS, n_sub, m)
    per_sub = [_assign_ties(resid[:, b], book_c.sub_codebooks[b],
                            book_c.pq_codes[:, b].long())
               for b in range(n_sub)]
    cmp["pq_codes"] = dict(
        share_equal=float(np.mean([r["share_equal"] for r in per_sub])),
        differ=sum(r["differ"] for r in per_sub),
        max_margin=max((r["max_margin"] for r in per_sub
                        if r["max_margin"] is not None), default=None),
        ok=all(r["ok"] for r in per_sub))
    ip = keys.double() @ q.double()
    hits = (tables_c.codes == MP._signature(q, lsh_c)).sum(-1).double()
    c_score = (book_c.coarse.double() @ q.double())[book_c.assignments]
    lut = (book_c.sub_codebooks.double()
           * q.double().reshape(n_sub, 1, m)).sum(-1)
    adc = c_score + lut.gather(-1, book_c.pq_codes.long().T).sum(0)
    cmp["exact_topk"] = _id_ties(ids["exact_topk"], exact_topk(
        keys, q, torch.ones(BASE_KEYS, dtype=torch.bool), BASE_TOP_K)[0], ip)
    cmp["retrieve"] = _id_ties(ids["retrieve"],
                               MP.retrieve(tables_c, q, BASE_TOP_K), hits)
    cmp["coarse_retrieve"] = _id_ties(
        ids["coarse_retrieve"],
        PQ.coarse_retrieve(keys, book_c.coarse, q, BASE_TOP_K), c_score)
    cmp["pq_retrieve"] = _id_ties(ids["pq_retrieve"],
                                  PQ.pq_retrieve(book_c, q, BASE_TOP_K), adc)
    rec = dict(device=torch.cuda.get_device_name(0), keys=BASE_KEYS,
               dim=BASE_DIM, top_k=BASE_TOP_K,
               magicpig=dict(tables=10, bits=10),
               pqcache=dict(coarse=64, sub_codebooks=n_sub, fit_sample=32768,
                            n_probe=8),
               ms=ms, recall_vs_exact_topk=recall, card_vs_cpu=cmp,
               noise=BASE_NOISE)
    print("baselines " + json.dumps(rec), flush=True)
    for name, r in cmp.items():
        _check(r["ok"], f"baselines: {name} differ from the CPU's beyond "
               f"float noise: {r}")
    return rec


# ----------------------------------------------------------------- train ---
def _train_f32(dev, cfg_full, seed: int = 1):
    """(b) float32 at full width cut to 2 layers, card against CPU from
    the same params and batch: the gradients, then ``TRAIN_F32_STEPS``
    train steps on each side; (c) the card's trained params through
    ``save_checkpoint`` and ``load_checkpoint``, bit for bit. → (record,
    the bars it missed)."""
    import torch
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLMStream, make_batch
    from repro_torch.models.model import init_params
    from repro_torch import tree_leaves, tree_map
    from repro_torch.models.train import TrainState, loss_grads, train_step
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(cfg_full, num_layers=2, dtype="float32")
    p_cpu = init_params(cfg, seed=seed, device="cpu")
    tokens, labels = make_batch(SyntheticLMStream(cfg.vocab_size, seed),
                                TRAIN_F32_BATCH, TRAIN_F32_SEQ)
    batch = {"tokens": tokens, "labels": labels}
    side = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(d), p_cpu)
        mets0, grads = loss_grads(p, cfg, batch, remat=False)
        loss0 = float(mets0["loss"])
        state, mets = TrainState(p, adamw_init(p)), []
        for _ in range(TRAIN_F32_STEPS):
            state, m = train_step(state, batch, cfg, peak_lr=TRAIN_F32_LR,
                                  warmup=1, total_steps=TRAIN_F32_STEPS,
                                  remat=False)
            mets.append({k: float(v) for k, v in m.items()})
        side[name] = dict(grads=[g.cpu() for g in tree_leaves(grads)],
                          params=state.params, metrics=mets, loss0=loss0,
                          seconds=time.perf_counter() - t0)
    card, cpu = side["card"], side["cpu"]
    grad_err = max(float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(card["grads"], cpu["grads"]))
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                     for a, b in zip(card["metrics"], cpu["metrics"])
                     for k in ("loss", "grad_norm", "lr"))
    param_err, below = 0.0, 0
    by_floor = {f: 0.0 for f in (1e-4, 1e-3, 1e-2)}
    for a, b, g in zip(tree_leaves(card["params"]),
                       tree_leaves(cpu["params"]), cpu["grads"]):
        keep = g.abs() > TRAIN_GRAD_FLOOR * float(g.abs().max())
        below += int((~keep).sum())
        if keep.any():
            param_err = max(param_err,
                            float((a.cpu() - b)[keep].abs().max()))
        for f in by_floor:
            k = g.abs() > f * float(g.abs().max())
            if k.any():
                by_floor[f] = max(by_floor[f],
                                  float((a.cpu() - b)[k].abs().max()))
    path = os.path.join(ROOT, "build", "train_phase.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, card["params"], cfg, step=TRAIN_F32_STEPS)
    back = load_checkpoint(path, cfg, device=dev)
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(path)
    os.remove(path)
    bitwise = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(card["params"])))
    rec = dict(
        layers=2, dtype="float32", batch=TRAIN_F32_BATCH, seq=TRAIN_F32_SEQ,
        steps=TRAIN_F32_STEPS, peak_lr=TRAIN_F32_LR,
        loss={k: [m["loss"] for m in v["metrics"]] for k, v in side.items()},
        grad_norm={k: [m["grad_norm"] for m in v["metrics"]]
                   for k, v in side.items()},
        seconds={k: v["seconds"] for k, v in side.items()},
        max_grad_rel_err=grad_err, max_metric_rel_err=metric_err,
        max_param_err=param_err, params_below_grad_floor=below,
        max_param_err_by_floor=by_floor,
        tolerance=dict(metrics=TRAIN_RTOL, grads=TRAIN_GRAD_RTOL,
                       params=TRAIN_PARAM_ATOL, floor=TRAIN_GRAD_FLOOR),
        checkpoint=dict(bytes=ckpt_bytes, seconds=ckpt_s,
                        bitwise_equal=bitwise))
    bars = [
        (abs(card["loss0"] - cpu["loss0"]) <= TRAIN_RTOL * cpu["loss0"],
         f"train (b): card loss {card['loss0']} vs CPU {cpu['loss0']}"),
        (grad_err <= TRAIN_GRAD_RTOL, f"train (b): gradients differ by "
         f"{grad_err} of their leaf's largest"),
        (metric_err <= TRAIN_RTOL, f"train (b): step metrics differ by "
         f"{metric_err} relative"),
        (param_err <= TRAIN_PARAM_ATOL, f"train (b): params differ by "
         f"{param_err} after {TRAIN_F32_STEPS} steps"),
        (bitwise, "train (c): the checkpoint did not round-trip")]
    return rec, [msg for ok, msg in bars if not ok]


def train_phase(dev):
    """(a) qwen2-1.5b at full width and depth in its dtype: TRAIN_STEPS
    remat train steps on one fixed batch from ``make_batch``; (b), (c) in
    ``_train_f32``."""
    import math

    import torch
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.data import SyntheticLMStream, make_batch
    from repro_torch.models.model import init_params, param_count
    from repro_torch.models.train import TrainState, train_step
    from repro_torch.optim import adamw_init

    cfg = configs.get("qwen2-1.5b")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    n_params = param_count(params)
    state = TrainState(params, adamw_init(params))
    del params
    tokens, labels = make_batch(SyntheticLMStream(cfg.vocab_size, seed=0),
                                TRAIN_BATCH, TRAIN_SEQ)
    batch = {"tokens": torch.as_tensor(tokens, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
    torch.cuda.synchronize()
    K.reset_launches()
    steps = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = train_step(state, batch, cfg, peak_lr=TRAIN_LR, warmup=1,
                              total_steps=TRAIN_STEPS, remat=True)
        torch.cuda.synchronize()
        steps.append(dict({k: float(v) for k, v in m.items()},
                          seconds=time.perf_counter() - t0))
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del state, batch
    torch.cuda.empty_cache()
    losses = [s["loss"] for s in steps]
    steady = [s["seconds"] for s in steps[1:]]
    full = dict(
        arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, remat=True,
        peak_lr=TRAIN_LR, warmup=1, steps=steps,
        step_seconds_after_first=statistics.median(steady),
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(steady),
        max_memory_allocated=peak, pariskv_launches=launches)
    bars = [
        (all(math.isfinite(x) for x in losses), f"train (a): losses "
         f"{losses}"),
        (all(s["grad_norm"] > 0 for s in steps), "train (a): a zero "
         "gradient norm"),
        (losses[-1] < losses[0], f"train (a): the loss did not fall: "
         f"{losses}"),
        (sum(launches.values()) == 0, f"train (a) launched ParisKV "
         f"kernels: {launches}")]
    f32, missed = _train_f32(dev, cfg)
    rec = dict(device=torch.cuda.get_device_name(0), full=full,
               card_vs_cpu=f32)
    print("train " + json.dumps(rec), flush=True)
    missed = [msg for ok, msg in bars if not ok] + missed
    _check(not missed, "; ".join(missed))
    return rec


# ---------------------------------------------------------------- dryrun ---
def _plan_lines(capacity: int) -> dict:
    """(a) Every architecture at full width and depth, every input shape
    and layout, on one card and on (1, 4) and (1, 8): a rank's known GB
    (arguments, and gradients for train) and whether they fit the card, a
    lower bound (``dryrun.FITS_NOTE``), or the port's refusal; one compact
    line per architecture."""
    from repro_torch import configs
    from repro_torch.core.config import INPUT_SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MX

    out = {}
    for arch in configs.ARCHS:
        line = {}
        for shape in INPUT_SHAPES:
            line[shape] = {}
            for mesh in (MX.gpu_mesh(1, m) for m in PLAN_MODEL_AXES):
                line[shape][MX.mesh_tag(mesh)] = {
                    r["layout"]: ([round(r["known_bytes"] / 1e9, 3),
                                   r["fits"]] if r["ok"]
                                  else "refused")
                    for r in D.plan_combo(arch, shape, mesh,
                                          capacity=capacity)}
        print(f"dryrun {arch} " + json.dumps(line, separators=(",", ":")),
              flush=True)
        out[arch] = line
    return out


def _grounding(dev, n_max: int = 16384, num_blocks: int = 512):
    """(c) The engine phase's qwen2-1.5b (QWEN_LAYERS layers, 4 slots,
    num_blocks blocks of 128) built on the card: the growth of
    ``memory_allocated`` from its params and the engine's state against
    the planner's params plus state bytes (the head_shards layout on one
    card), beside the growth of the bytes requested of the caching
    allocator (before it rounds a block up or leaves a large block
    unsplit), then one decode step served."""
    import torch
    from repro_torch.core.config import InputShape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MX
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine, Request

    cfg = _seq_cfg()
    plan = D.plan_combo(cfg.name, InputShape("engine", n_max, 4, "decode"),
                        MX.gpu_mesh(1, 1), layouts=("head_shards",),
                        cfg=cfg)[0]
    _check(plan["num_blocks"] == num_blocks,
           f"the planner's pool has {plan['num_blocks']} blocks")
    planned = plan["argument_parts"]["params"] + plan["argument_parts"][
        "state"]
    def requested():
        """The bytes asked of the caching allocator, before its rounding
        (None where this torch does not count them)."""
        return torch.cuda.memory_stats().get("requested_bytes.all.current")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before, asked = torch.cuda.memory_allocated(), requested()
    params = init_params(cfg, seed=0, device=dev)
    eng = PagedServingEngine(cfg, params, n_max=n_max, block_size=128,
                             max_batch=4, num_blocks=num_blocks,
                             chunk_size=1, device=dev)
    eng.start()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    asked = None if asked is None else requested() - asked
    torch.cuda.reset_peak_memory_stats()
    eng.submit(Request(uid=0, prompt=_prompts(cfg, lens=(PROMPTS[0],))[0],
                       max_new_tokens=2))
    eng.step_serve()
    torch.cuda.synchronize()
    rec = dict(arch=cfg.name, layers=cfg.num_layers, slots=4, n_max=n_max,
               num_blocks=num_blocks, block_size=128,
               planned_bytes=dict(params=plan["argument_parts"]["params"],
                                  state=plan["argument_parts"]["state"],
                                  total=planned),
               allocated_growth=grown, ratio=grown / planned,
               requested_growth=asked,
               decode_steps=eng.decode_steps,
               step_peak_over_planned=torch.cuda.max_memory_allocated()
               - before - planned)
    _check(abs(grown - planned) <= 0.01 * planned,
           f"grounding: allocated {grown} bytes, planned {planned}")
    _check(eng.decode_steps == 1 and int(eng.nonfinite_logits) == 0,
           f"grounding: {eng.decode_steps} decode steps, "
           f"{int(eng.nonfinite_logits)} non-finite logits")
    del eng, params
    torch.cuda.empty_cache()
    return rec


def dryrun_phase(dev, train_rec=None):
    """The capacity planner (``launch.dryrun``, on meta tensors): (a)
    ``_plan_lines``; (b) the FLOPs of the train phase's step (qwen2-1.5b
    at full depth, TRAIN_BATCH × TRAIN_SEQ, remat) and, after the train
    phase, its FLOP/s from that phase's median step; (c) ``_grounding``."""
    import torch
    from repro_torch import configs
    from repro_torch.core.config import InputShape
    from repro_torch.launch import dryrun as D

    capacity = torch.cuda.get_device_properties(dev).total_memory
    t0 = time.perf_counter()
    lines = _plan_lines(capacity)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flops, _ = D.step_flops(configs.get("qwen2-1.5b"), InputShape(
        "train_phase", TRAIN_SEQ, TRAIN_BATCH, "train"))
    flops_s = time.perf_counter() - t0
    step_s = (None if train_rec is None
              else train_rec["full"]["step_seconds_after_first"])
    ground = _grounding(dev)
    rec = dict(device=torch.cuda.get_device_name(0), capacity=capacity,
               plan_s=plan_s, archs=len(lines),
               train_step=dict(flops=flops, count_s=flops_s, step_s=step_s,
                               tflop_per_s=None if step_s is None
                               else flops / step_s / 1e12),
               grounding=ground)
    print("dryrun " + json.dumps(rec), flush=True)
    _check(flops and flops > 0, f"train step FLOPs {flops}")
    return rec


# ---------------------------------------------------------------- parity ---
def faults_phase(dev, cfg, params, n_max: int = 16384, gen: int = FAULT_GEN):
    """Fault handling at full width (bf16, seed 0) on the offloaded engine
    (128 of 512 blocks staged, chunks of 8) with the engine phase's first
    two requests, FAULT_GEN new tokens each: a clean run, then (a) fetch
    delays, (b) transient failures, (c) a hung fetch past its deadline with
    the overlap on and off, (d) every fetch failing from the second chunk on
    (degraded attention), (e) ``engine.slot`` failing uid 0 (quarantine),
    (f) staging storms, each audited with ``verify_invariants()`` at every
    chunk, and (g) a chunked run (budget 512) whose fill prefix reads all
    exhaust their retries, on the engine phase's four requests: two fit
    the staging pool, so their fills would read no host row. In (d) and
    (g) every degraded tiered launch must read zero host rows."""
    import threading

    import numpy as np
    import torch
    from repro_torch.serving import FaultPlan, FaultSpec, PagedServingEngine

    before = set(threading.enumerate())
    prompts = _prompts(cfg)
    geom = dict(n_max=n_max, block_size=128, max_batch=4, num_blocks=512,
                num_device_blocks=128, chunk_size=8, offload=True,
                device=dev)
    first_chunk = cfg.num_layers * geom["chunk_size"]   # heads fetches
    runs = {
        "clean": ({}, ()),
        "a_delay": (dict(faults=[FaultSpec("fetch.gather", "delay",
                                           delay_s=0.01, count=4)]), ()),
        "b_fail": (dict(faults=[FaultSpec("fetch.gather", "fail", after=2,
                                          count=2)],
                        fetch_max_retries=2), ()),
        "c_hang_overlap": (dict(faults=[FaultSpec("fetch.gather", "hang",
                                                  after=4, count=1)],
                                fetch_timeout_s=0.25), ()),
        "c_hang_one_stream": (dict(faults=[FaultSpec("fetch.gather", "hang",
                                                     after=4, count=1)],
                                   fetch_timeout_s=0.25, overlap=False), ()),
        "d_degraded": (dict(faults=[FaultSpec("fetch.gather", "fail",
                                              after=first_chunk,
                                              count=None)],
                            fetch_max_retries=1), ()),
        "e_quarantine": (dict(faults=[FaultSpec("engine.slot", "fail",
                                                match={"uid": 0})]), (0,)),
        "f_storm": (dict(faults=[FaultSpec("staging.storm", "storm",
                                           after=1, count=2)]), ()),
    }
    out, toks = {}, {}
    for name, (kw, failed) in runs.items():
        plan = FaultPlan(kw.pop("faults", []))
        eng = PagedServingEngine(cfg, params, faults=plan, **geom, **kw)
        if name == "clean":
            _warm(eng, cfg)
        with _TieredTally(eng.host) as tally:
            rec, done = _serve(eng, prompts[:2], gen, ARRIVALS[:2],
                               OFFLOAD_KERNELS, cfg, audit=True,
                               failed=failed)
        toks[name] = {u: r.output for u, r in done.items()}
        out[name] = dict(
            tokens_per_s=rec["tokens_per_s"], decode_steps=rec[
                "decode_steps"], hist_checks=rec["hist_checks"],
            fetch_stall_s=eng.fetch_stall_s, fetch_retries=eng.fetch_retries,
            fetch_timeouts=eng.fetch_timeouts,
            degraded_steps=eng.degraded_steps,
            storm_evictions=eng.storm_evictions,
            abandoned_attempts=eng.host.abandoned_attempts,
            fired=len(plan.fired()), tally=tally.t,
            quarantined=[r.uid for r in eng.quarantined],
            per_request={u: dict(fetch_retries=r.fetch_retries,
                                 fetch_timeouts=r.fetch_timeouts,
                                 degraded_steps=r.degraded_steps,
                                 fetch_stall_s=r.fetch_stall_s,
                                 failed=r.failed, error=r.error)
                         for u, r in done.items()})
        eng.close()
        del eng
        torch.cuda.empty_cache()
    clean = toks["clean"]
    for name, rec in out.items():
        rec["tokens_per_s_vs_clean"] = (rec["tokens_per_s"]
                                        / out["clean"]["tokens_per_s"])
    # (g) the chunked run on four requests, every fill read failing
    plan = FaultPlan([FaultSpec("fetch.gather", "fail", count=None,
                                match={"kind": "rows"})])
    eng = PagedServingEngine(cfg, params, faults=plan, fetch_max_retries=1,
                             fetch_backoff_s=0.0, prefill_budget=CHUNK_BUDGET,
                             **geom)
    reads, spans = _fill_counts(cfg, prompts, CHUNK_BUDGET)
    with _TieredTally(eng.host) as tally:
        rec, done = _serve(eng, prompts, FAULT_CHUNKED_GEN, ARRIVALS,
                           OFFLOAD_KERNELS, cfg, audit=True,
                           fill=dict(gather_rows_tiered=reads,
                                     bucket_count=spans))
    out["g_chunked_rows"] = dict(
        requests=len(prompts), new_tokens=FAULT_CHUNKED_GEN,
        tokens_per_s=rec["tokens_per_s"], decode_steps=rec["decode_steps"],
        hist_checks=rec["hist_checks"], fetch_stall_s=eng.fetch_stall_s,
        fetch_retries=eng.fetch_retries, degraded_steps=eng.degraded_steps,
        fetched_fill_rows=eng.host.fetched_fill_rows,
        fetched_unique_fill_rows=eng.host.fetched_unique_fill_rows,
        fired=len(plan.fired()), tally=tally.t,
        degraded_per_request=[done[u].degraded_steps for u in sorted(done)])
    eng.close()
    del eng
    torch.cuda.empty_cache()
    agree = [float(np.mean(toks["d_degraded"][u] == clean[u]))
             for u in sorted(clean)]
    out["d_degraded"]["token_agreement_with_clean"] = agree
    time.sleep(0.1)
    leaked = [t.name for t in set(threading.enumerate()) - before
              if t.name.startswith("kv-fetch") and t.is_alive()]
    out["leaked_fetch_threads"] = leaked
    print("faults " + json.dumps(out), flush=True)
    for name in ("a_delay", "b_fail", "c_hang_overlap", "c_hang_one_stream",
                 "f_storm"):
        _check(_same_tokens(toks[name], clean),
               f"faults {name}: tokens differ from the clean run's")
    _check(out["a_delay"]["fired"] == 4 and out["b_fail"]["fetch_retries"]
           >= 2, f"faults: delay fired {out['a_delay']['fired']}, retries "
           f"{out['b_fail']['fetch_retries']}")
    for name in ("c_hang_overlap", "c_hang_one_stream"):
        r = out[name]
        _check(r["fetch_timeouts"] == 1 and r["fetch_retries"] >= 1
               and r["degraded_steps"] == 0 and r["fetch_stall_s"] < 10,
               f"faults {name}: {r}")
    _check(out["f_storm"]["storm_evictions"] > 0, "faults: no storm eviction")
    _check(out["e_quarantine"]["quarantined"] == [0]
           and _same_tokens({1: toks["e_quarantine"][1]}, {1: clean[1]}),
           "faults: quarantine did not fail exactly uid 0 with the survivor "
           "on the clean run's tokens")
    for name in ("d_degraded", "g_chunked_rows"):
        r = out[name]
        t = r["tally"]
        _check(r["degraded_steps"] > 0 and t["degraded_launches"] > 0,
               f"faults {name}: nothing degraded: {r}")
        _check(t["degraded_distinct_missed_head_rows"] == 0,
               f"faults {name}: degraded launches read "
               f"{t['degraded_distinct_missed_head_rows']} host rows")
    _check(not leaked, f"fetch threads survived close(): {leaked}")
    return out


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
              "chunked", "share", "faults", "sharded", "arch", "gemma",
              "cross", "ssm", "mla", "baselines", "train", "dryrun",
              "parity", "seqshard")
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

    # qwen2-1.5b at full width, cut to QWEN_LAYERS of its 28 layers for the
    # phases that serve it (the kernel phase takes only its widths)
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=QWEN_LAYERS)
    seconds = {}                  # wall seconds per phase
    t_phase = time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now
        print(f"phase {name} " + json.dumps({"seconds": seconds[name]}),
              flush=True)
    kern = kernel_phase(dev, cfg) if "kernels" in only else {}
    lap("kernels")
    params = None
    if {"engine", "slot", "metaview", "baseline", "offload", "chunked",
            "share", "faults"} & set(only):
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
        lap("engine")
    if "slot" in only:
        slot, engine = slot_phase(dev, cfg, params, paged_out)
        profile_phase(engine, cfg, "slot")
        del engine
        for k in (*SLOT_KERNELS, "bucket_hist"):
            launches.setdefault(k, slot["launches"][k])
        # the contiguous routes of the TPU kernels #5 and #6
        for k in ("collision_paged", "gather_rows_paged"):
            launches[f"{k}/contiguous"] = slot["launches"][k]
        lap("slot")
    if "metaview" in only:
        metaview_phase(dev, cfg, params)
        lap("metaview")
    if "baseline" in only:
        baseline_phase(dev, cfg, params)
        lap("baseline")
    if "offload" in only:
        off, _ = offload_phase(dev, cfg, params, eng, paged_out)
        launches.setdefault("gather_rows_tiered",
                            off["launches"]["gather_rows_tiered"])
        lap("offload")
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
        lap("chunked")
    if "share" in only:
        # the shared admissions' histogram rebuilds in the sharing run (a)
        sh = share_phase(dev, cfg, params)
        launches["bucket_count/share"] = sh["on"]["rebuild_launches"]
        lap("share")
    if "faults" in only:
        faults_phase(dev, cfg, params)
        lap("faults")
    if "sharded" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        sharded, shard_kern = sharded_phase(dev)
        kern.update(shard_kern)
        # rank 0's launches in (a), the sharded main path
        for name in shard_kern:
            launches[name] = sharded["sharded"][0]["launches"][
                name.split("/")[0]]
        lap("sharded")
    if "arch" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        arch, arch_kern = arch_phase(dev)
        kern.update(arch_kern)
        # grok-1's launches in (a)
        for name in arch_kern:
            launches[name] = arch["grok"]["launches"][name.split("/")[0]]
        lap("arch")
    if "gemma" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        gemma, gemma_kern = gemma_phase(dev)
        kern.update(gemma_kern)
        # gemma3-12b's launches in (b)
        for name in gemma_kern:
            launches[name] = gemma["gemma3"]["launches"][name.split("/")[0]]
        lap("gemma")
    if "cross" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        cross, cross_kern = cross_phase(dev)
        kern.update(cross_kern)
        # whisper-large-v3's launches in (b)
        for name in cross_kern:
            launches[name] = cross["whisper"]["launches"][name.split("/")[0]]
        lap("cross")
    if "ssm" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        ssm, ssm_kern = ssm_phase(dev)
        kern.update(ssm_kern)
        # hymba-1.5b's launches in (b)
        for name in ssm_kern:
            launches[name] = ssm["hymba"]["launches"][name.split("/")[0]]
        lap("ssm")
    if "mla" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        mla, mla_kern = mla_phase(dev)
        kern.update(mla_kern)
        # deepseek-v2-lite's launches in (b)
        for name in mla_kern:
            launches[name] = mla["deepseek"]["launches"][name.split("/")[0]]
        lap("mla")
    if "baselines" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        baselines_phase(dev)
        lap("baselines")
    train_rec = None
    if "train" in only:
        train_rec = train_phase(dev)
        lap("train")
    if "dryrun" in only:
        dryrun_phase(dev, train_rec)
        lap("dryrun")
    if "parity" in only:
        parity_phase(dev, cfg)
        lap("parity")
    if "seqshard" in only:
        del params, eng
        params = eng = None
        torch.cuda.empty_cache()
        seq, seq_kern = seqshard_phase(dev)
        kern.update(seq_kern)
        # rank 0's launches on the sequence-sharded decode
        launches["gather_rows_paged/seqshard"] = seq["launches"][
            "gather_rows_paged"]
        lap("seqshard")
    print("phase_seconds " + json.dumps(seconds), flush=True)
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
