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
@pytest.mark.parametrize("nsub", [8, 16])
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

    with pytest.raises(ValueError, match="score_range"):
        collision_scores_paged_kernel(ids, bt, tables, enc_end, 64, 256)
    with pytest.raises(ValueError, match="score_range"):
        collision_scores_paged_kernel(ids, bt, tables, enc_end, 64, -1)
    with pytest.raises(TypeError):
        collision_scores_paged_kernel(ids, bt, tables.int(), enc_end, 64, sr)
    with pytest.raises(ValueError, match="byte-lane"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("qk,threads", [(37 * HG, 256), (3000, 64)])
def test_dedup_tiered_gather_matches_plain_on_card(card, qk, threads):
    """The deduplicating tiered gather on constructed duplicates, at every
    cluster size it can launch (3000 entries at 64 threads: followers in
    later tiles than their leaders): output byte-identical to its plain
    version, the distinct missed (row, head) count over the whole launch
    (the batch rows pick from the same host rows) equal to the plain
    version's and to ``torch.unique``'s, the leader table back to all -1
    after each launch."""
    from repro_torch.kernels.gather_kv import ops as GO
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref)

    gen = torch.Generator().manual_seed(qk)
    nb, nd, bs, b = 40, 12, 32, 2
    host = torch.randn((2, nb * bs, G, 128), generator=gen).to(
        torch.bfloat16).pin_memory()
    stag = torch.randn((2, nd, bs, G, 128), generator=gen).to(
        torch.bfloat16).to(card)
    dev_map = torch.full((nb,), -1, dtype=torch.int32)
    dev_map[torch.randperm(nb, generator=gen)[:nd]] = torch.arange(
        nd, dtype=torch.int32)
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
    owner = GO._owner_table(card, nb * bs * G)
    for cluster in (1, 2, 4, 8, 16):
        count = torch.zeros((1,), dtype=torch.int64, device=card)
        got = GO.launch_tiered(stag[0], stag[1], host[0], host[1], dm, rw,
                               count, cluster, threads)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want_k), cluster
        assert torch.equal(got[1].cpu(), want_v), cluster
        assert int(count) == distinct, cluster
        assert bool((owner == -1).all()), cluster


@pytest.mark.cuda
def test_bucket_count_span_matches_plain_on_card(card):
    """The chunked fill's histogram update (bucket_count's block-table
    mode) adds exactly its plain version's counts, through a table row with
    an unallocated block and past the table, at B = 8 and 16."""
    from repro_torch.kernels.collision import bucket_count_span
    from repro_torch.kernels.collision.ref import bucket_count_span_ref

    gen = torch.Generator(device=card).manual_seed(3)
    nb, bs = 10, 32
    bt = torch.tensor([[7, 2, 9, -1, 0]], dtype=torch.int32, device=card)
    for nsub in (8, 16):
        ids = torch.randint(0, 256, (nb, G, bs, nsub), generator=gen,
                            device=card, dtype=torch.int32).to(torch.uint8)
        for lo, hi in ((8, 40), (30, 120), (100, 200), (0, 1)):
            base = torch.randint(0, 9, (1, G, nsub, 256), generator=gen,
                                 device=card, dtype=torch.int32)
            got = bucket_count_span(ids, bt, lo, hi, 256, base.clone())
            want = base.cpu() + bucket_count_span_ref(ids.cpu(), bt.cpu(),
                                                      lo, hi, 256)
            assert torch.equal(got.cpu(), want), (nsub, lo, hi)
