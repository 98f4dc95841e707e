"""Each CUDA kernel of the port against its plain PyTorch version on the
card, over a paged pool and over a contiguous store (one block per batch
row): exact for integer outputs and gathers, Stage II to float32
reassociation. Every test here needs a card and skips without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (with ``--noconftest``: the suite's conftest imports
JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import row_tables  # noqa: E402
from repro_torch.kernels.bucket_topk import bucket_topk  # noqa: E402
from repro_torch.kernels.collision import (bucket_count,  # noqa: E402
                                           collision_scores_kernel,
                                           collision_scores_paged_kernel,
                                           lane_packed_table)
from repro_torch.kernels.gather_kv import (gather_decode_paged,  # noqa: E402
                                           gather_heads_tiered,
                                           gather_kv_kernel,
                                           gather_rows_paged)
from repro_torch.kernels.rerank import rerank_topk_paged  # noqa: E402

G, HG = 2, 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on one")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nsub", [8, 16, 32])
def test_kernels_match_plain_on_card(card, nsub):
    """Each CUDA kernel equals its plain version on the card (exact for
    integer outputs and gathers; rerank to float32 reassociation)."""
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                                   collision_paged_ref)
    from repro_torch.kernels.gather_kv.ref import (gather_decode_paged_ref,
                                                   gather_rows_paged_ref)
    from repro_torch.kernels.rerank.ref import (block_relative,
                                                rerank_topk_paged_ref,
                                                topk_ref)

    gen = torch.Generator(device=card).manual_seed(nsub)
    nb, bs, b, nblk = 10, 32, 2, 4

    def ri(lo, hi, shape, dt=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=card,
                             dtype=dt)
    ids = ri(0, 256, (nb, G, bs, nsub), torch.uint8)
    bt = torch.tensor([[7, 2, 9, -1], [0, 5, -1, -1]], dtype=torch.int32,
                      device=card)
    tables = lane_packed_table(b, G, HG, nsub, 256, card)
    tables.copy_(ri(0, 7, (b, G, HG, nsub, 256), torch.uint8))
    enc_end = torch.tensor([110, 50], dtype=torch.int32, device=card)
    got, hist = collision_scores_paged_kernel(ids, bt, tables, enc_end, 16,
                                              6 * nsub)
    want, want_hist = collision_paged_ref(ids, bt, tables, enc_end, 16,
                                          6 * nsub)
    assert torch.equal(got, want) and torch.equal(hist, want_hist)
    cand = bucket_topk(got, 40, 6 * nsub, seg_hist=hist)
    assert torch.equal(cand, bucket_topk_ref(got, 40, 6 * nsub))
    assert torch.equal(bucket_topk(got, 40, 6 * nsub), cand)
    codes = ri(-2 ** 31, 2 ** 31 - 1, (nb, G, bs, nsub))
    w = torch.rand((nb, G, bs, nsub), generator=gen, device=card)
    q_sub = torch.randn((b, G, HG, nsub, 8), generator=gen, device=card)
    q_norm = torch.rand((b, G, HG), generator=gen, device=card)
    args = (codes, w, bt, cand, q_sub, q_norm, enc_end, 16, 25, 8, 3)
    got, want = rerank_topk_paged(*args), rerank_topk_paged_ref(*args)
    torch.testing.assert_close(got.est, want.est, rtol=1e-5, atol=1e-4)
    # the selection: exactly the plain top-k of the kernel's own estimates
    top_est, top_pos = topk_ref(got.est, 25)
    assert torch.equal(got.top_est, top_est)
    assert torch.equal(got.top_idx, cand.gather(-1, top_pos))
    blk, phys = block_relative(got.top_idx, bt, bs)
    assert torch.equal(got.block_ids, blk) and torch.equal(got.phys_rows, phys)
    pool = torch.randn((2, nb, bs, G, 128), generator=gen, device=card
                       ).to(torch.bfloat16)
    lidx = ri(0, 128, (b, 24))
    gk, gv = gather_rows_paged(pool[0], pool[1], bt, lidx)
    assert torch.equal(gk, gather_rows_paged_ref(pool[0], bt, lidx))
    assert torch.equal(gv, gather_rows_paged_ref(pool[1], bt, lidx))
    ws = torch.tensor([40, 90], dtype=torch.int32, device=card)
    for phys in (got.phys_rows, None):
        outs = gather_decode_paged(pool[0], pool[1], bt, ws, 16, 30, phys)
        want_g = gather_decode_paged_ref(pool[0], pool[1], bt, ws, 16, 30,
                                         phys)
        assert all(x is y or torch.equal(x, y) for x, y in zip(outs, want_g))

    # the contiguous route (ragged n): the region's bucket histogram
    # (stride 1 and 3; row 1's region ends at the sink), Stage I over the
    # one-block-per-row table, and the decode gather with a window start
    # clamped to n - W
    n = 1000
    cids = ri(0, 256, (b, G, n, nsub), torch.uint8)
    cenc = torch.tensor([n - 3, 16], dtype=torch.int32, device=card)
    for stride in (1, 3):
        counts = bucket_count(cids, cenc, 16, 256, stride)
        assert torch.equal(counts, bucket_count_ref(cids, cenc, 16, 256,
                                                    stride))
    assert int(counts[0].sum()) > 0 and int(counts[1].sum()) == 0
    cenc[1] = 300
    ctab = lane_packed_table(b, G, HG, nsub, 256, card)
    ctab.copy_(ri(0, 7, (b, G, HG, nsub, 256), torch.uint8))
    rows1 = row_tables(b, card)
    got, hist = collision_scores_kernel(cids, ctab, cenc, 16, 6 * nsub)
    want, want_hist = collision_paged_ref(cids, rows1, ctab, cenc, 16,
                                          6 * nsub)
    assert torch.equal(got, want) and torch.equal(hist, want_hist)
    store = torch.randn((2, b, n, G, 128), generator=gen, device=card
                        ).to(torch.bfloat16)
    hidx = ri(0, n, (b, G, HG, 37)) + n * torch.arange(
        b, dtype=torch.int32, device=card)[:, None, None, None]
    start = torch.tensor([40, n + 7], dtype=torch.int32,
                         device=card).clamp(0, n - 30)
    outs = gather_decode_paged(store[0], store[1], rows1, start, 16, 30, hidx)
    want_g = gather_decode_paged_ref(store[0], store[1], rows1, start, 16, 30,
                                     hidx)
    assert all(torch.equal(x, y) for x, y in zip(outs, want_g))
    assert torch.equal(outs[0][1, -1], store[0][1, n - 1])
    ridx = ri(0, n, (b, 300))
    assert torch.equal(gather_kv_kernel(store[0].reshape(b, n, -1), ridx),
                       gather_rows_paged_ref(store[0], rows1, ridx
                                             ).reshape(b, 300, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_rank_masked_gather_matches_plain_on_card(card, shards):
    """The decode gather's rank-masked mode (one rank of a sequence-sharded
    contiguous cache) at qwen2-1.5b's shapes (G 2, Hg 6, hd 128, k 100,
    sink 128, window 768, bf16): equal to its plain version, to the
    unmasked decode gather of the whole cache on the rows the rank owns
    and zero elsewhere, and summed over the ranks, to the whole gather; a
    window straddles a shard boundary. The logical mode (promotion) too."""
    from repro_torch.kernels.gather_kv import (gather_decode_masked,
                                               gather_rows_masked)
    from repro_torch.kernels.gather_kv.ref import (gather_decode_masked_ref,
                                                   gather_rows_masked_ref)

    gen = torch.Generator(device=card).manual_seed(shards)
    b, n, g, hd, hg, k, sink, W = 2, 8192, 2, 128, 6, 100, 128, 768
    n_loc = n // shards
    k_all = torch.randn((b, n, g, hd), generator=gen, device=card).to(
        torch.bfloat16)
    v_all = torch.randn((b, n, g, hd), generator=gen, device=card).to(
        torch.bfloat16)
    top = torch.randint(sink, n - W, (b, g, hg, k), generator=gen,
                        device=card, dtype=torch.int32)
    start = torch.tensor([n_loc - W // 2, n - W], dtype=torch.int32,
                         device=card)
    rows1 = row_tables(b, card)
    whole = gather_decode_paged(k_all, v_all, rows1, start, sink, W,
                                top + n * rows1[:, :, None, None])
    lidx = torch.cat([torch.arange(sink, device=card).expand(b, sink),
                      start[:, None] + torch.arange(W, device=card)], 1)
    promo = (n_loc - 100 + torch.arange(256, device=card,
                                        dtype=torch.int32)).expand(b, 256)
    total = [torch.zeros_like(t) for t in whole]
    for r in range(shards):
        base = r * n_loc
        sk = k_all[:, base:base + n_loc].contiguous()
        sv = v_all[:, base:base + n_loc].contiguous()
        got = gather_decode_masked(sk, sv, rows1, start, sink, W, top, base,
                                   n_loc)
        want = gather_decode_masked_ref(sk, sv, rows1, start, sink, W, top,
                                        base, n_loc)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        own_d = ((lidx >= base) & (lidx < base + n_loc))[..., None, None]
        own_r = ((top >= base) & (top < base + n_loc))[..., None]
        for x, y, own in zip(got, whole, (own_d, own_d, own_r, own_r)):
            assert torch.equal(x, torch.where(own, y, torch.zeros_like(y)))
        for t, x in zip(total, got):
            t += x
        assert torch.equal(
            gather_rows_masked(sk, None, rows1, promo.contiguous(), base,
                               n_loc),
            gather_rows_masked_ref(sk, rows1, promo, base, n_loc))
    assert all(torch.equal(t, y) for t, y in zip(total, whole))


@pytest.mark.cuda
def test_topc_segments_match_plain_on_card(card):
    """Stage I with its histograms per segment, the histogram pass and the
    cut from histograms equal their plain versions exactly over several
    segments: on Stage I's own output (rows shorter than C), on all ties,
    and on threshold ties spread over every segment with the quota ending
    inside one; wrong inputs raise."""
    from repro_torch.kernels import SEG_LEN
    from repro_torch.kernels.bucket_topk import segment_histogram
    from repro_torch.kernels.bucket_topk.ref import (bucket_topk_ref,
                                                     segment_histogram_ref)
    from repro_torch.kernels.collision.ref import collision_paged_ref

    gen = torch.Generator(device=card).manual_seed(3)
    nb, bs, b, nblk, hg, nsub, sr = 64, 64, 3, 20, 6, 16, 96
    ids = torch.randint(0, 256, (nb, G, bs, nsub), generator=gen,
                        device=card, dtype=torch.uint8)
    bt = torch.randperm(nb, generator=gen, device=card)[:b * nblk].reshape(
        b, nblk).to(torch.int32)
    bt[1, 12:] = -1
    tables = lane_packed_table(b, G, hg, nsub, 256, card)
    tables.copy_(torch.randint(0, 7, (b, G, hg, nsub, 256), generator=gen,
                               device=card, dtype=torch.uint8))
    enc_end = torch.tensor([1280, 700, 100], dtype=torch.int32, device=card)
    got, hist = collision_scores_paged_kernel(ids, bt, tables, enc_end, 64,
                                              sr)
    want, want_hist = collision_paged_ref(ids, bt, tables, enc_end, 64, sr)
    assert torch.equal(got, want) and torch.equal(hist, want_hist)
    assert hist.shape[-2] == nblk * bs // SEG_LEN

    ties = torch.full_like(got, 7)
    spread = torch.randint(-1, 80, got.shape, generator=gen, device=card,
                           dtype=torch.int32)
    spread[..., 5::9] = 90                 # 142 ties in every segment
    for scores, k in ((got, 300), (ties, 300), (spread, 120)):
        h = segment_histogram(scores, sr)
        assert torch.equal(h, segment_histogram_ref(scores, sr))
        cand = bucket_topk(scores, k, sr, seg_hist=h)
        assert torch.equal(cand, bucket_topk_ref(scores, k, sr))
        assert torch.equal(bucket_topk(scores, k, sr), cand)
    for n in (1000, 1024):                 # ragged n: scalar loads
        s = spread[..., :n].contiguous()
        assert torch.equal(segment_histogram(s, sr),
                           segment_histogram_ref(s, sr))
        assert torch.equal(bucket_topk(s, 77, sr), bucket_topk_ref(s, 77, sr))
    # a row past 64k positions: its histograms do not fit shared memory
    long = torch.randint(-1, 97, (2, 70000), generator=gen, device=card,
                         dtype=torch.int32)
    long[:, 40000:] = -1
    assert torch.equal(bucket_topk(long, 3000, sr),
                       bucket_topk_ref(long, 3000, sr))

    # a score range of 256 needs the 16-lane layout, not these 8-lane
    # tables; 65,536 fits no layout
    with pytest.raises(ValueError, match="16-lane layout"):
        collision_scores_paged_kernel(ids, bt, tables, enc_end, 64, 256)
    with pytest.raises(ValueError, match="score_range"):
        collision_scores_paged_kernel(ids, bt, tables, enc_end, 64, 65536)
    with pytest.raises(ValueError, match="score_range"):
        collision_scores_paged_kernel(ids, bt, tables, enc_end, 64, -1)
    with pytest.raises(TypeError):
        collision_scores_paged_kernel(ids, bt, tables.int(), enc_end, 64, sr)
    with pytest.raises(ValueError, match="8-lane layout"):
        collision_scores_paged_kernel(ids, bt, tables.contiguous(), enc_end,
                                      64, sr)
    with pytest.raises(ValueError, match="seg_hist"):
        bucket_topk(got, 300, sr, seg_hist=hist[..., 1:, :])


@pytest.mark.cuda
def test_tiered_gather_matches_plain_on_card(card):
    """The tiered winner gather reads staged rows from the card and missed
    rows from a pinned host pool, byte-identical to its plain version
    (zero rows for -1); a pageable host pool raises instead of faulting."""
    from repro_torch.kernels.gather_kv.ref import gather_heads_tiered_ref

    gen = torch.Generator().manual_seed(5)
    nb, nd, bs, b, k = 40, 12, 32, 2, 37
    host = torch.randn((2, nb * bs, G, 128), generator=gen).to(
        torch.bfloat16).pin_memory()
    stag = torch.randn((2, nd, bs, G, 128), generator=gen).to(
        torch.bfloat16).to(card)
    dev_map = torch.full((nb,), -1, dtype=torch.int32)
    dev_map[torch.randperm(nb, generator=gen)[:nd]] = torch.arange(
        nd, dtype=torch.int32)
    rows = torch.randint(0, nb * bs, (b, G, HG, k), generator=gen,
                         dtype=torch.int32)
    rows[..., ::5] = -1
    dm, rw = dev_map.to(card), rows.to(card)
    got = gather_heads_tiered(stag[0], stag[1], host[0], host[1], dm, rw)
    torch.cuda.synchronize()
    staged = dev_map[rows.clamp_min(0).long() // bs] >= 0
    assert staged.any() and (~staged & (rows >= 0)).any() and (rows < 0).any()
    for g, s, h in zip(got, stag, host):
        assert torch.equal(g, gather_heads_tiered_ref(s, h, dm, rw))
    with pytest.raises(ValueError, match="pinned"):
        gather_heads_tiered(stag[0], stag[1], host[0].clone(), host[1], dm,
                            rw)


def _tiered_pools(gen, card, nb, nd, bs, hd, G_=G):
    """A pinned host K/V pool (2, nb·bs, G, hd) bf16, a staging pool of nd
    blocks on the card and a dev_map (nb,) staging nd random blocks."""
    host = torch.randn((2, nb * bs, G_, hd), generator=gen).to(
        torch.bfloat16).pin_memory()
    stag = torch.randn((2, nd, bs, G_, hd), generator=gen).to(
        torch.bfloat16).to(card)
    dev_map = torch.full((nb,), -1, dtype=torch.int32)
    dev_map[torch.randperm(nb, generator=gen)[:nd]] = torch.arange(
        nd, dtype=torch.int32)
    return host, stag, dev_map


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("qk,threads", [(37 * HG, 256), (3000, 64)])
def test_dedup_tiered_gather_matches_plain_on_card(card, qk, threads, hd):
    """The deduplicating tiered gather on constructed duplicates, at head
    rows of 128, 256 and 512 bytes and at every grid from one block per kv
    head (every key of a head in one block, its leader table full) to 264
    (3000 entries at 64 threads: passes of 1,024 entries, followers in
    later passes than their leaders): output byte-identical to its plain
    version, the distinct missed (row, head) count over the whole launch
    (the batch rows pick from the same host rows) equal to the plain
    version's and to ``torch.unique``'s."""
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref)

    gen = torch.Generator().manual_seed(qk + hd)
    nb, nd, bs, b = 40, 12, 32, 2
    host, stag, dev_map = _tiered_pools(gen, card, nb, nd, bs, hd)
    pick = torch.randint(0, nb * bs, (1, G, 50), generator=gen,
                         dtype=torch.int32).expand(b, G, 50)
    rows = pick.gather(2, torch.randint(0, 50, (b, G, qk), generator=gen))
    rows = rows.reshape(b, G, 1, qk).to(torch.int32).contiguous()
    rows[..., ::7] = -1
    dm, rw = dev_map.to(card), rows.to(card)
    want_k, want_v, distinct = gather_heads_tiered_dedup_ref(
        stag[0].cpu(), stag[1].cpu(), host[0], host[1], dev_map, rows)
    missed = (rows >= 0) & (dev_map[rows.clamp_min(0).long() // bs] < 0)
    keys = (rows.long() * G + torch.arange(G)[None, :, None, None])[missed]
    assert distinct == torch.unique(keys).numel() < int(missed.sum())
    assert b * qk > threads * GO.TIERED_PASS or qk < 100
    for blocks in (1, 2, 7, 66, 264):
        count = torch.zeros((1,), dtype=torch.int64, device=card)
        got = GO.launch_tiered(stag[0], stag[1], host[0], host[1], dm, rw,
                               count, blocks, threads)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want_k), blocks
        assert torch.equal(got[1].cpu(), want_v), blocks
        assert int(count) == distinct, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, 1])
def test_tiered_gather_reads_rewritten_host_rows_fresh_on_card(card,
                                                               blocks):
    """A host row rewritten between two launches comes back new: the
    first launch reads rows, the host rewrites them (a CPU write, then a
    device-to-host copy on the stream with no synchronization), and each
    next launch carries the new bytes, nothing of a cached copy."""
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.gather_kv.ref import gather_heads_tiered_ref

    gen = torch.Generator().manual_seed(23)
    nb, nd, bs, k = 40, 12, 32, 64
    host, stag, dev_map = _tiered_pools(gen, card, nb, nd, bs, 128)
    unstaged = torch.nonzero(dev_map < 0)[:, 0]
    rows = (unstaged[torch.randint(0, len(unstaged), (1, G, 1, k),
                                   generator=gen)] * bs
            + torch.randint(0, bs, (1, G, 1, k), generator=gen))
    rows = rows.to(torch.int32).contiguous()
    dm, rw = dev_map.to(card), rows.to(card)

    def launch():
        got = GO.launch_tiered(stag[0], stag[1], host[0], host[1], dm, rw,
                               None, blocks)
        return [t.cpu() for t in got]

    def want():
        return [gather_heads_tiered_ref(stag[i].cpu(), host[i], dev_map,
                                        rows) for i in (0, 1)]
    first = launch()
    assert all(torch.equal(g, w) for g, w in zip(first, want()))
    picked = torch.unique(rows.long())
    host[0][picked] = torch.randn((len(picked), G, 128), generator=gen).to(
        torch.bfloat16)
    host[1][picked] = torch.randn((len(picked), G, 128), generator=gen).to(
        torch.bfloat16)
    second = launch()
    assert all(torch.equal(g, w) for g, w in zip(second, want()))
    assert not torch.equal(second[0], first[0])
    new = torch.randn((2, len(picked), G, 128), device=card).to(
        torch.bfloat16)
    for i in (0, 1):
        host[i][picked[0]:picked[0] + 1].copy_(new[i, :1], non_blocking=True)
    got = GO.launch_tiered(stag[0], stag[1], host[0], host[1], dm, rw, None,
                           blocks)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want()))
    assert torch.equal(host[0][picked[0]], new[0, 0].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("G_", [2, 8])
def test_tiered_fill_prefix_read_matches_plain_on_card(card, G_):
    """The offloaded fill's prefix read: every kv head of 3,000 ascending
    rows (one vector expanded over the heads, -1 past the frontier), half
    the blocks staged, at the default grid and at one block per kv head:
    byte-identical to the plain version, the distinct count G times the
    missed rows."""
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref)

    gen = torch.Generator().manual_seed(29 + G_)
    nb, bs, n = 48, 64, 3000
    host, stag, dev_map = _tiered_pools(gen, card, nb, nb // 2, bs, 128, G_)
    order = torch.randperm(nb, generator=gen)
    idx = torch.arange(-(-n // bs) * bs)
    pref = torch.where(idx < n, order[idx // bs] * bs + idx % bs, -1)
    rows = pref.to(torch.int32).view(1, 1, 1, -1).expand(
        1, G_, 1, len(idx)).contiguous()
    want_k, want_v, distinct = gather_heads_tiered_dedup_ref(
        stag[0].cpu(), stag[1].cpu(), host[0], host[1], dev_map, rows)
    missed = (pref >= 0) & (dev_map[pref.clamp_min(0) // bs] < 0)
    assert distinct == G_ * int(missed.sum()) > 0
    assert (dev_map[pref[pref >= 0] // bs] >= 0).any()
    for blocks in (None, 1):
        count = torch.zeros((1,), dtype=torch.int64, device=card)
        got = GO.launch_tiered(stag[0], stag[1], host[0], host[1],
                               dev_map.to(card), rows.to(card), count,
                               blocks)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want_k), blocks
        assert torch.equal(got[1].cpu(), want_v), blocks
        assert int(count) == distinct, blocks


@pytest.mark.cuda
def test_bucket_count_span_matches_plain_on_card(card):
    """The chunked fill's histogram update (bucket_count's block-table
    mode) adds exactly its plain version's counts, through a table row with
    an unallocated block and past the table, at B = 8, 16 and 32."""
    from repro_torch.kernels.collision import bucket_count_span
    from repro_torch.kernels.collision.ref import bucket_count_span_ref

    gen = torch.Generator(device=card).manual_seed(3)
    nb, bs = 10, 32
    bt = torch.tensor([[7, 2, 9, -1, 0]], dtype=torch.int32, device=card)
    for nsub in (8, 16, 32):
        ids = torch.randint(0, 256, (nb, G, bs, nsub), generator=gen,
                            device=card, dtype=torch.int32).to(torch.uint8)
        for lo, hi in ((8, 40), (30, 120), (100, 200), (0, 1)):
            base = torch.randint(0, 9, (1, G, nsub, 256), generator=gen,
                                 device=card, dtype=torch.int32)
            got = bucket_count_span(ids, bt, lo, hi, 256, base.clone())
            want = base.cpu() + bucket_count_span_ref(ids.cpu(), bt.cpu(),
                                                      lo, hi, 256)
            assert torch.equal(got.cpu(), want), (nsub, lo, hi)


@pytest.mark.cuda
def test_b32_stage1_and_bucket_count_at_gemma3_shapes_on_card(card):
    """gemma3-12b's global layers at B = 32 (head_dim 256), G 8, Hg 2, 512
    blocks of 128, four rows: Stage I with its histograms, the cut and
    ``bucket_count`` (the contiguous region's and the fill's span) equal
    their plain versions exactly."""
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision import bucket_count_span
    from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                                   bucket_count_span_ref,
                                                   collision_paged_ref)

    gen = torch.Generator(device=card).manual_seed(32)
    G8, hg, B, nb, bs, b = 8, 2, 32, 512, 128, 4
    nblk = nb // b
    ids = torch.randint(0, 256, (nb, G8, bs, B), generator=gen, device=card,
                        dtype=torch.int32).to(torch.uint8)
    bt = torch.randperm(nb, generator=gen, device=card).to(
        torch.int32).reshape(b, nblk)
    bt[3, 100:] = -1
    enc_end = torch.tensor([16000, 9000, 3000, 12000], dtype=torch.int32,
                           device=card)
    tables = lane_packed_table(b, G8, hg, B, 256, card)
    tables.copy_(torch.randint(0, 7, (b, G8, hg, B, 256), generator=gen,
                               device=card, dtype=torch.int32).to(
                                   torch.uint8))
    got, hist = collision_scores_paged_kernel(ids, bt, tables, enc_end, 64,
                                              6 * B)
    want, want_hist = collision_paged_ref(ids, bt, tables, enc_end, 64, 6 * B)
    assert torch.equal(got, want) and torch.equal(hist, want_hist)
    assert int(got.max()) > 6 * 16          # past B = 16's score range
    cand = bucket_topk(got, 2048, 6 * B, seg_hist=hist)
    assert torch.equal(cand, bucket_topk_ref(got, 2048, 6 * B))
    view = ids[bt.clamp_min(0).long()].permute(0, 2, 1, 3, 4).reshape(
        b, G8, nblk * bs, B).contiguous()
    counts = bucket_count(view, enc_end, 64, 256)
    assert torch.equal(counts, bucket_count_ref(view, enc_end, 64, 256))
    base = torch.zeros((b, G8, B, 256), dtype=torch.int32, device=card)
    span = bucket_count_span(ids, bt, 64, 12000, 256, base)
    assert torch.equal(span.cpu(), bucket_count_span_ref(
        ids.cpu(), bt.cpu(), 64, 12000, 256))


@pytest.mark.cuda
def test_stage1_and_bucket_count_at_hymba_shapes_on_card(card):
    """hymba-1.5b's hybrid layers: G 5 KV heads, Hg 5 query heads each
    (the first odd Hg above 1: 5 of the 8 byte lanes of the packed tier
    table), B 8 (head_dim 64), 512 blocks of 128, four rows: Stage I with
    its histograms, the cut and ``bucket_count`` equal their plain
    versions exactly."""
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                                   collision_paged_ref)

    gen = torch.Generator(device=card).manual_seed(5)
    g5, hg, B, nb, bs, b = 5, 5, 8, 512, 128, 4
    nblk = nb // b
    ids = torch.randint(0, 256, (nb, g5, bs, B), generator=gen, device=card,
                        dtype=torch.int32).to(torch.uint8)
    bt = torch.randperm(nb, generator=gen, device=card).to(
        torch.int32).reshape(b, nblk)
    bt[2, 40:] = -1
    enc_end = torch.tensor([16000, 9000, 3000, 12000], dtype=torch.int32,
                           device=card)
    tables = lane_packed_table(b, g5, hg, B, 256, card)
    tables.copy_(torch.randint(0, 7, (b, g5, hg, B, 256), generator=gen,
                               device=card, dtype=torch.int32).to(
                                   torch.uint8))
    got, hist = collision_scores_paged_kernel(ids, bt, tables, enc_end, 8,
                                              6 * B)
    want, want_hist = collision_paged_ref(ids, bt, tables, enc_end, 8, 6 * B)
    assert torch.equal(got, want) and torch.equal(hist, want_hist)
    assert got.shape[:3] == (b, g5, hg)
    cand = bucket_topk(got, 1311, 6 * B, seg_hist=hist)
    assert torch.equal(cand, bucket_topk_ref(got, 1311, 6 * B))
    view = ids[bt.clamp_min(0).long()].permute(0, 2, 1, 3, 4).reshape(
        b, g5, nblk * bs, B).contiguous()
    counts = bucket_count(view, enc_end, 8, 256)
    assert torch.equal(counts, bucket_count_ref(view, enc_end, 8, 256))


@pytest.mark.cuda
def test_wide_kernels_at_deepseek_shapes_on_card(card):
    """deepseek-v2-lite's MLA retrieval shapes (one 576-wide latent: G 1,
    Hg 16 query heads, B 128, score range 768), four rows of 16,384 with
    about 27k valid keys: the wide Stage I (16-lane tier table) with its
    histograms, the cut (770 bins),
    ``bucket_count`` at B = 128, Stage II with its top-k at B = 128 and the
    K-only decode gather of 1,152-byte rows equal their plain versions
    (exact; Stage II's estimates to float32 reassociation, its selection
    the plain top-k of its own estimates)."""
    from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref
    from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                                   collision_paged_ref)
    from repro_torch.kernels.gather_kv.ref import gather_decode_paged_ref
    from repro_torch.kernels.rerank.ref import rerank_paged_ref, topk_ref

    gen = torch.Generator(device=card).manual_seed(25)
    b, hg, B, n, C, k, sink, rng_s = 4, 16, 128, 16384, 1311, 100, 128, 768
    ids = torch.randint(0, 256, (b, 1, n, B), generator=gen, device=card,
                        dtype=torch.int32).to(torch.uint8)
    enc_end = torch.tensor([2488, 5488, 8488, 11488], dtype=torch.int32,
                           device=card)
    tables = lane_packed_table(b, 1, hg, B, 256, card, lanes=16)
    tables.copy_(torch.randint(0, 7, (b, 1, hg, B, 256), generator=gen,
                               device=card, dtype=torch.int32).to(
                                   torch.uint8))
    got, hist = collision_scores_paged_kernel(
        ids, row_tables(b, card), tables, enc_end, sink, rng_s)
    want, want_hist = collision_paged_ref(ids, row_tables(b, card), tables,
                                          enc_end, sink, rng_s)
    assert torch.equal(got, want) and torch.equal(hist, want_hist)
    assert int(got.max()) > 255
    cand = bucket_topk(got, C, rng_s, seg_hist=hist)
    assert torch.equal(cand, bucket_topk_ref(got, C, rng_s))
    counts = bucket_count(ids, enc_end, sink, 256)
    assert torch.equal(counts, bucket_count_ref(ids, enc_end, sink, 256))
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, 1, n, B),
                          generator=gen, device=card, dtype=torch.int64).to(
                              torch.int32)
    w = torch.rand((b, 1, n, B), generator=gen, device=card)
    q_sub = torch.randn((b, 1, hg, B, 8), generator=gen, device=card)
    q_norm = torch.rand((b, 1, hg), generator=gen, device=card) + 0.5
    won = rerank_topk_paged(codes, w, row_tables(b, card), cand, q_sub,
                            q_norm, enc_end, sink, k)
    phys = cand + (torch.arange(b, device=card) * n)[:, None, None, None]
    est = rerank_paged_ref(codes, w, phys.to(torch.int32), cand, q_sub,
                           q_norm, enc_end, sink, 8)
    assert torch.allclose(won.est, est, rtol=1e-4, atol=1e-3)
    top, pos = topk_ref(won.est, k)
    assert torch.equal(won.top_est, top)
    assert torch.equal(won.top_idx, cand.gather(-1, pos))
    lat = torch.randn((b, n, 1, 576), generator=gen, device=card).to(
        torch.bfloat16)
    ws = (enc_end - 128).to(torch.int32)
    rows = gather_decode_paged(lat, None, row_tables(b, card), ws, sink, 640,
                               won.phys_rows)
    plain = gather_decode_paged_ref(lat, None, row_tables(b, card), ws, sink,
                                    640, won.phys_rows)
    assert rows[1] is None and rows[3] is None
    assert torch.equal(rows[0], plain[0]) and torch.equal(rows[2], plain[2])


@pytest.mark.cuda
def test_bucket_count_span_long_rebuild_exact_on_card(card):
    """A shared-prefix admission's histogram rebuild (``core/cache.py:
    bucket_hist_from_paged_meta``): bucket_count's block-table mode over
    [sink, enc_end) of an 8,192-token prefix, about 8,000 positions (the
    widest cluster), through a 128-entry table row that is -1 past the
    prefix and at two blocks inside it, is exact against its plain
    version."""
    from repro_torch.core import cache as CC
    from repro_torch.core.config import ParisKVConfig
    from repro_torch.kernels.collision.ops import count_cluster
    from repro_torch.kernels.collision.ref import bucket_count_span_ref

    gen = torch.Generator(device=card).manual_seed(18)
    pcfg = ParisKVConfig()
    nb, bs, nblk, prefix = 512, 128, 128, 8192
    ids = torch.randint(0, 256, (nb, G, bs, 16), generator=gen, device=card,
                        dtype=torch.int32).to(torch.uint8)
    row = torch.full((nblk,), -1, dtype=torch.int32, device=card)
    row[:prefix // bs] = torch.randperm(nb, generator=gen, device=card)[
        :prefix // bs].to(torch.int32)
    for holes in ((), (5, 40)):
        for h in holes:
            row[h] = -1
        enc = CC.fill_enc_end(prefix, pcfg)
        assert count_cluster(enc - pcfg.sink_size) == 8
        got = CC.bucket_hist_from_paged_meta(
            CC.PagedLayerKVCache(None, None, ids, None, None), row, enc,
            pcfg)
        want = bucket_count_span_ref(ids.cpu(), row.cpu()[None],
                                     pcfg.sink_size, enc, 256)[0]
        assert torch.equal(got.cpu(), want), holes
        assert int(want.sum()) == G * 16 * (enc - pcfg.sink_size
                                            - len(holes) * bs)


@pytest.mark.cuda
def test_degraded_tiered_gather_reads_no_host_row_on_card(card):
    """A degraded step's tiered gather (every missed winner at -1, the
    staged ones kept) equals its plain version, zeros at the misses, and
    counts zero distinct host rows: it read nothing over the link."""
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref)

    gen = torch.Generator().manual_seed(19)
    nb, nd, bs, b, k = 40, 12, 32, 2, 37
    host = torch.randn((2, nb * bs, G, 128), generator=gen).to(
        torch.bfloat16).pin_memory()
    stag = torch.randn((2, nd, bs, G, 128), generator=gen).to(
        torch.bfloat16).to(card)
    dev_map = torch.full((nb,), -1, dtype=torch.int32)
    dev_map[torch.randperm(nb, generator=gen)[:nd]] = torch.arange(
        nd, dtype=torch.int32)
    rows = torch.randint(0, nb * bs, (b, G, HG, k), generator=gen,
                         dtype=torch.int32)
    staged = dev_map[rows.long() // bs] >= 0
    assert staged.any() and (~staged).any()
    rows = torch.where(staged, rows, -1).contiguous()
    count = torch.zeros((1,), dtype=torch.int64, device=card)
    got = gather_heads_tiered(stag[0], stag[1], host[0], host[1],
                              dev_map.to(card), rows.to(card), count)
    torch.cuda.synchronize()
    want_k, want_v, distinct = gather_heads_tiered_dedup_ref(
        stag[0].cpu(), stag[1].cpu(), host[0], host[1], dev_map, rows)
    assert torch.equal(got[0].cpu(), want_k)
    assert torch.equal(got[1].cpu(), want_v)
    assert int(count) == distinct == 0
    assert not got[0].cpu()[~staged].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather_rows_tiered", "bucket_count"])
def test_kernel_error_propagates_on_card(card, monkeypatch, kernel):
    """A real launch whose status comes back as an error (the launcher
    runs, then reports cudaErrorLaunchFailure) raises ``KernelError`` out
    of ``step_serve()``, from inside a decode chunk (the tiered gather) or
    inside an admission's quarantine boundary (the histogram of the
    admitted prompt), and quarantines nobody."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine, Request

    real = build.launcher

    def failing(name):
        fn = real(name)
        if name != kernel:
            return fn
        return lambda *args: (fn(*args), 719)[1]

    cfg = configs.smoke("qwen2-1.5b")
    params = init_params(cfg, seed=0, device=card)
    eng = PagedServingEngine(cfg, params, n_max=512, max_batch=2,
                             block_size=16, num_blocks=64, chunk_size=4,
                             offload=True, num_device_blocks=16, device=card)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (300,))
    eng.submit(Request(uid=0, prompt=prompt.astype(np.int32),
                       max_new_tokens=8))
    monkeypatch.setattr(build, "launcher", failing)
    eng.start()
    with pytest.raises(build.KernelError, match=kernel):
        eng.step_serve()
    assert eng.quarantined == [] and not any(r.failed for r in eng._done)
    torch.cuda.synchronize()
    eng.close()


# three staggered prompts at stablelm-1.6b's full width, 2 layers, float32
SHARD_SPECS = ((700, 12), (1100, 9), (1500, 7))


def _shard_outputs(cfg, params, device, shards):
    """Tokens of ``SHARD_SPECS`` through ``PagedServingEngine(mesh_shards=
    shards)``, then the same prompts admitted together, one chunk, and one
    more decode step's retrieval result and decode gather in every layer
    (this rank's heads) as numpy."""
    import numpy as np

    from repro_torch.core import cache as CC
    from repro_torch.kernels.gather_kv import gather_decode_paged
    from repro_torch.models import serve as SV
    from repro_torch.serving import PagedServingEngine, Request

    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n, _ in SHARD_SPECS]
    eng = PagedServingEngine(cfg, params, n_max=2048, max_batch=4,
                             block_size=128, chunk_size=4,
                             mesh_shards=shards, device=device)
    for uid, (p, (_, gen)) in enumerate(zip(prompts, SHARD_SPECS)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=gen))
    tokens = {r.uid: r.output.tolist() for r in eng.run()}
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=16))
    eng.start()
    eng.step_serve()
    st, pcfg = eng._state, cfg.pariskv
    W = CC.window_size(pcfg)
    bt = torch.from_numpy(eng._bt).to(device)
    ws = (st.regions.pos + 2 - W).clamp_min(0).to(torch.int32)
    rec = []
    SV.decode_step(eng.params, cfg, st.cur_tok,
                   SV.ServeState(st.caches, st.regions), bt,
                   active=st.remaining > 0, record=rec, dist=eng.dist)
    layers = []
    for lc, res in zip(st.caches, rec):
        dk, dv, wk, wv = gather_decode_paged(lc["kv"].k, lc["kv"].v, bt, ws,
                                             pcfg.sink_size, W, res.phys_rows)
        layers.append(dict({f: getattr(res, f).cpu().numpy()
                            for f in res._fields},
                           dense_k=dk.cpu().numpy(), dense_v=dv.cpu().numpy(),
                           ret_k=wk.cpu().numpy(), ret_v=wv.cpu().numpy()))
    return tokens, layers


def _shard_config():
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get("stablelm-1.6b"), num_layers=2,
                               dtype="float32")


def _shard_rank_on_card(rank):
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = _shard_config()
    return _shard_outputs(cfg, init_params(cfg, seed=0, device=dev), dev, 2)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_one_device(card):
    """Two gloo ranks share the card (stablelm-1.6b at full width, 2
    layers, float32): each rank's tokens equal the one-device engine's,
    and at one decode step each rank's Stage I scores, top-C set, Stage
    II winners, estimates and rows, and the decode gather's K/V rows equal
    the one-device outputs' slice of its KV heads exactly."""
    import numpy as np

    from repro_torch.distributed import launch_local
    from repro_torch.models.model import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _shard_config()
    tokens, layers = _shard_outputs(
        cfg, init_params(cfg, seed=0, device=card), card, 1)
    torch.cuda.empty_cache()
    ranks = launch_local(_shard_rank_on_card, 2, "gloo", timeout_s=300.0)
    per = cfg.num_kv_heads // 2
    for rank, (got_tokens, got_layers) in enumerate(ranks):
        assert got_tokens == tokens, rank
        g = slice(rank * per, (rank + 1) * per)
        for li, (got, want) in enumerate(zip(got_layers, layers)):
            for name, arr in want.items():
                head = arr[:, :, g] if name.startswith("dense") else arr[:, g]
                np.testing.assert_array_equal(
                    got[name], head, err_msg=f"rank {rank} layer {li} {name}")


@pytest.mark.cuda
def test_grok_moe_matches_plain_cpu_run_on_card(card):
    """grok-1 at full width cut to 2 layers, float32: each layer's
    ``moe_fwd`` (64 tokens) and ``moe_decode`` (4 rows) on the card equal
    the same code on the CPU: expert ids exact wherever the top-2 gap (the
    least gap between neighbours among a token's top three probabilities)
    exceeds 1e-5, outputs within 1e-4 + 1e-4 · |out| on the tokens whose
    expert ids and capacity positions agree."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("grok-1-314b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, seed=0, device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    k, E = cfg.experts_per_token, cfg.num_experts
    for li, layer in enumerate(params["layers"]):
        p_dev = layer["moe"]
        p_cpu = {name: t.cpu() for name, t in p_dev.items()}
        for shape in ((1, 64, cfg.d_model), (4, cfg.d_model)):
            x = torch.randn(shape, generator=gen, device=card)
            if x.dim() == 3:
                got = MOE.moe_fwd(p_dev, x, k)[0].cpu()
                want = MOE.moe_fwd(p_cpu, x.cpu(), k)[0]
            else:
                got = MOE.moe_decode(p_dev, x, k).cpu()
                want = MOE.moe_decode(p_cpu, x.cpu(), k)
            xt = x.reshape(-1, cfg.d_model)
            idx_d = MOE._route(p_dev, xt, k)[2].cpu()
            probs, _, idx_c = MOE._route(p_cpu, xt.cpu(), k)
            top = probs.sort(-1, descending=True).values[:, :k + 1]
            gap = (top[:, :-1] - top[:, 1:]).min(-1).values
            flipped = (idx_d != idx_c).any(-1)
            assert (gap[flipped] <= 1e-5).all(), (li, shape)
            same = ~flipped & (MOE._positions(idx_d, E)
                               == MOE._positions(idx_c, E)).all(-1)
            assert flipped.any() or same.all()
            torch.testing.assert_close(
                got.reshape(xt.shape)[same], want.reshape(xt.shape)[same],
                atol=1e-4, rtol=1e-4, msg=f"layer {li} {tuple(shape)}")
        del p_cpu


@pytest.mark.cuda
def test_train_step_matches_plain_cpu_run_on_card(card):
    """Three ``train_step``s of qwen2-smoke and grok-smoke in float32 on
    the card and on the CPU from the same params and batch: loss and grad
    norm within 1e-5 relative at every step, the params within 1e-5 (1 %
    of the lr) where the CPU's first gradient exceeds 1e-3 of its leaf's
    largest (Adam divides each gradient by its own size)."""
    import dataclasses

    from repro_torch import configs, tree_leaves, tree_map
    from repro_torch.data import SyntheticLMStream, make_batch
    from repro_torch.models import model as M
    from repro_torch.models import train as T
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen2-1.5b", "grok-1-314b"):
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
        p_cpu = M.init_params(cfg, seed=4, device="cpu")
        tokens, labels = make_batch(SyntheticLMStream(cfg.vocab_size, 2),
                                    2, 64)
        batch = {"tokens": tokens, "labels": labels}
        g0 = tree_leaves(T.loss_grads(p_cpu, cfg, batch, remat=False)[1])
        sides = []
        for dev in (card, torch.device("cpu")):
            p = tree_map(lambda t: t.to(dev), p_cpu)
            state = T.TrainState(p, adamw_init(p))
            mets = []
            for _ in range(3):
                state, m = T.train_step(state, batch, cfg, peak_lr=1e-3,
                                        warmup=1, total_steps=3,
                                        remat=True)
                mets.append({k: float(v) for k, v in m.items()})
            sides.append((tree_leaves(state.params), mets))
        (p_card, m_card), (p_host, m_host) = sides
        for a, b in zip(m_card, m_host):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1e-6), (
                    arch, k, a[k], b[k])
        for a, b, g in zip(p_card, p_host, g0):
            keep = g.abs() > 1e-3 * g.abs().max().clamp_min(1e-30)
            err = (a.cpu() - b)[keep].abs()
            assert not err.numel() or float(err.max()) <= 1e-5, arch


@pytest.mark.cuda
def test_baselines_match_plain_cpu_run_on_card(card):
    """On 8,192 keys of 128, card against CPU on the same inputs:
    MagicPIG's signatures, PQCache's assignments and PQ codes from the
    card's fitted centroids, and the ids of ``retrieve``,
    ``coarse_retrieve``, ``pq_retrieve`` and ``exact_topk`` from the same
    tables, book and keys. Each is equal, or differs only where a float
    near tie lies within 1e-5 of the values' scale (a projection's
    distance from 0, a squared-distance gap, a score gap), which the
    message reports. The two k-means fits need not agree: a near tie
    flipped in one iteration moves a centroid."""
    from repro_torch.baselines import magicpig as MP
    from repro_torch.baselines import pqcache as PQ
    from repro_torch.core.retrieval import exact_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    keys = torch.randn((8192, 128), generator=gen)
    q = keys[11] + 0.5 * torch.randn((128,), generator=gen)
    lsh = MP.make_params(128, 10, 10, seed=0, device="cpu")
    k_card, q_card = keys.to(card), q.to(card)
    tables = MP.build(k_card, MP.LSHParams(lsh.projections.to(card)))
    book = PQ.build_pq(k_card, 16, 16, fit_sample=4096)
    book_cpu = PQ.PQCodebook(*(t.cpu() for t in book))
    tables_cpu = MP.build(keys, lsh)

    def near_tie(differ, gap, scale, name):
        assert not differ.any() or float(gap[differ].max()) <= 1e-5 * scale, (
            name, int(differ.sum()), float(gap[differ].max()))

    y = (keys.double() @ lsh.projections.reshape(100, 128).T.double()).abs()
    near_tie(tables.codes.cpu() != tables_cpu.codes,
             y.reshape(8192, 10, 10).amin(-1), float(y.max()), "signatures")

    def assign_check(x, cents, got, name):
        d2 = ((x.double()[:, None] - cents.double()[None]) ** 2).sum(-1)
        two = d2.topk(2, -1, largest=False).values
        near_tie(got.cpu() != PQ.assign_clusters(x, cents),
                 two[:, 1] - two[:, 0], float(d2.max()), name)
    assign_check(keys, book_cpu.coarse, book.assignments, "assignments")
    resid = (keys - book_cpu.coarse[book_cpu.assignments]).reshape(
        8192, 16, 8)
    for b in range(16):
        assign_check(resid[:, b], book_cpu.sub_codebooks[b],
                     book.pq_codes[:, b].long(), f"pq_codes {b}")

    def ids_check(got, want, score, name):
        """The ids may differ only where their scores differ by noise."""
        got, want = got.cpu().long(), want.long()
        near_tie(got != want, (score[got] - score[want]).abs(),
                 float(score.abs().max()), name)
    ones = torch.ones(8192, dtype=torch.bool)
    ip = keys.double() @ q.double()
    ids_check(exact_topk(k_card, q_card, ones.to(card), 256)[0],
              exact_topk(keys, q, ones, 256)[0], ip, "exact_topk")
    ids_check(MP.retrieve(tables, q_card, 256),
              MP.retrieve(tables_cpu, q, 256),
              (tables_cpu.codes == MP._signature(q, lsh)).sum(-1).double(),
              "retrieve")
    c_score = (book_cpu.coarse.double() @ q.double())[book_cpu.assignments]
    ids_check(PQ.coarse_retrieve(k_card, book.coarse, q_card, 256),
              PQ.coarse_retrieve(keys, book_cpu.coarse, q, 256), c_score,
              "coarse_retrieve")
    lut = (book_cpu.sub_codebooks.double()
           * q.double().reshape(16, 1, 8)).sum(-1)
    adc = c_score + lut.gather(-1, book_cpu.pq_codes.long().T).sum(0)
    ids_check(PQ.pq_retrieve(book, q_card, 256),
              PQ.pq_retrieve(book_cpu, q, 256), adc, "pq_retrieve")
