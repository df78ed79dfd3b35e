"""The port's CUDA kernels against their plain PyTorch versions, on the
card (#1, #2, #4 and #5 also at zamba2-7b's head_dim 112, #6 also at its
state N 64), and the serving paths through them against the CPU's. Every test is marked ``gpu`` and skips (with its reason) where no
CUDA device is present — the decision is taken inside the ``cuda``
fixture, so every worker collects the same tests. Run them on the GPU
machine from the repository root:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: 2e-5 absolute in float32 (TF32 off; the kernels sum in
another order than the plain versions' matmuls) and 2e-2 absolute and
relative in bfloat16 (the plain versions round the softmax weights to
bfloat16 before the weighted sum, the kernels keep them in float32). The
SSD scan in float32: 1e-4 of the output's scale (max |plain|, at least
1), since its chunk sums reassociate terms as large as the output. An
engine that replays CUDA graphs and one that runs the same steps eagerly
must agree bit for bit: same kernels, same inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import chunk_attention as CA  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models.layers import packed_positions  # noqa: E402
from repro_torch.serving.engine import (InferenceEngine,  # noqa: E402
                                        make_engine)
from repro_torch.serving.plan import (PlannerConfig, StepPlanner,  # noqa
                                      serve_ticks)
from repro_torch.serving.request import Request, RequestQueue  # noqa: E402

pytestmark = pytest.mark.gpu

HEADS = [(16, 16, 128), (14, 2, 64)]          # olmo-1b, qwen2-0.5b
# #1, #2, #4 and #5 also at zamba2-7b's shared attention: 32 heads of 112
HEADS_112 = HEADS + [(32, 32, 112)]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=2e-5, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _randn(gen, shape, dtype, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(
        getattr(torch, dtype))


def _tables(gen, rows, max_pages, live, dev):
    """Scrambled block tables; entries past each row's live pages point
    far outside the pool (the kernel must not read them) and, for the
    plain version, at the null page."""
    n_pages = rows * max_pages + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:rows * max_pages].reshape(rows, max_pages).int()
    past = (torch.arange(max_pages, device=dev)[None, :]
            >= torch.tensor(live, device=dev)[:, None])
    return (tables.masked_fill(past, 1 << 30).contiguous(),
            tables.masked_fill(past, 0).contiguous(), n_pages)


def _split_edges(kv, c, dev):
    """Lengths one below, at and one above the ends of the first two
    splits that the decode wrappers cut of 8 rows of capacity c, a row of
    c - 1 and an empty row."""
    n = DA.decode_splits(8, kv, c, DA.sm_count(dev.index or 0))[1]
    return [n - 1, n, n + 1, 2 * n - 1, 2 * n, 2 * n + 1, c - 1, 0]


@pytest.mark.parametrize("h,kv,d", HEADS_112)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps,max_pages,lengths", [
    (16, 8, [0, 1, 16, 17, 100, 128, 0, 65]),   # empty, page edges, full
    (16, 64, "split edges"),                    # split boundaries +-1
    (16, 1024, [16384, 0]),                     # a 1024-page row
    (24, 16, [0, 1, 23, 24, 25, 200, 383, 384]),  # a page of no power of 2
    (8, 40, [319, 1, 64, 65]),                  # pages of 8
])
def test_paged_decode_kernel_matches_plain(cuda, h, kv, d, dtype, ps,
                                           max_pages, lengths):
    gen = torch.Generator(device=cuda).manual_seed(0)
    if lengths == "split edges":
        lengths = _split_edges(kv, ps * max_pages, cuda)
    live = [-(-n // ps) for n in lengths]
    poisoned, sane, n_pages = _tables(gen, len(lengths), max_pages, live,
                                      cuda)
    q = _randn(gen, (len(lengths), h, d), dtype, cuda)
    kp = _randn(gen, (n_pages, ps, kv, d), dtype, cuda)
    vp = _randn(gen, (n_pages, ps, kv, d), dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = PA.launches
    got = PA.paged_decode_attention_cuda(q, kp, vp, poisoned, lens)
    assert PA.launches == before + 1
    want = PA.paged_decode_attention_plain(q, kp, vp, sane, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all()


@pytest.mark.parametrize("h,kv,d", HEADS_112)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,lengths", [
    (256, [0, 1, 31, 32, 33, 200, 256, 0]),     # empty, tile edges, full
    (200, [200, 0, 137, 1]),                    # C no multiple of 32
    (16384, [16384]),                           # one long row, many splits
    (4096, "split edges"),                      # split boundaries +-1
    (4096, list(range(2000, 2065, 9))),         # generate's decode shape
])
def test_decode_kernel_matches_plain(cuda, h, kv, d, dtype, c, lengths):
    gen = torch.Generator(device=cuda).manual_seed(4)
    if lengths == "split edges":
        lengths = _split_edges(kv, c, cuda)
    b = len(lengths)
    q = _randn(gen, (b, h, d), dtype, cuda)
    kc = _randn(gen, (b, c, kv, d), dtype, cuda)
    vc = _randn(gen, (b, c, kv, d), dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = DA.launches
    got = DA.decode_attention_cuda(q, kc, vc, lens)
    assert DA.launches == before + 1
    want = DA.decode_attention_plain(q, kc, vc, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all()


@pytest.mark.parametrize("h,kv,d", HEADS_112)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,causal,window", [
    (100, True, 0),                 # ragged last tile
    (256, True, 48),                # window
    (96, False, 0),                 # non-causal
    (80, False, 24),                # non-causal window
    (1, True, 0),                   # one token
    (63, True, 0),                  # the edges of 64-row tiles
    (64, True, 0),
    (65, True, 0),
    (127, True, 0),
    (128, True, 0),
    (129, True, 0),
    (129, False, 0),
    (300, True, 100),               # windows that start mid-tile
    (300, False, 70),
])
def test_flash_kernel_matches_plain(cuda, h, kv, d, dtype, s, causal,
                                    window):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (2, s, h, d), dtype, cuda)
    k = _randn(gen, (2, s, kv, d), dtype, cuda)
    v = _randn(gen, (2, s, kv, d), dtype, cuda)
    before = FA.flash_launches
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert FA.flash_launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_bf16_flash_kernel_runs_on_tensor_cores(cuda):
    """The built bf16 kernels hold Hopper's warpgroup tensor-core
    instructions (HGMMA, from wgmma): the dense and the segment flash
    kernels in the SASS of all three head dims (64, 128, 112), the dense
    one with and without its lse store (the training path's), the paged
    chunk kernel of both of its own (64, 128), and the SSD scan for both
    chunk tiles (64 and 128 rows) at both state sizes (N 128, 64); their
    float32 bodies hold none."""
    from repro_torch.kernels import build
    counts = build.sass_count("flash_attention", "HGMMA")
    for name, want in (("flash_tc_kernel", 6), ("segment_tc_kernel", 3)):
        tc = {k: n for k, n in counts.items() if name in k}
        assert len(tc) == want and all(n > 0 for n in tc.values()), counts
    assert all(n == 0 for k, n in counts.items()
               if k.startswith("_Z12flash_kernel")
               or "segment_flash_kernel" in k), counts
    chunk = build.sass_count("chunk_attention", "HGMMA")
    tc = {k: n for k, n in chunk.items() if "chunk_tc_kernel" in k}
    assert len(tc) == 2 and all(n > 0 for n in tc.values()), chunk
    assert all(n == 0 for k, n in chunk.items()
               if "paged_chunk_kernel" in k), chunk
    ssd = build.sass_count("ssd_scan", "HGMMA")
    tc = {k: n for k, n in ssd.items() if "ssd_tc_kernel" in k}
    assert len(tc) == 4 and all(n > 0 for n in tc.values()), ssd
    assert all(n == 0 for k, n in ssd.items() if "ssd_kernel" in k), ssd


@pytest.mark.parametrize("h,kv,d", HEADS_112)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,lens,window", [
    (96, (40, 17, 30), 0),          # 3·2^5 bucket, ragged last tile
    (48, (1, 1, 40), 0),            # single-token segments
    (192, (100, 50, 20), 16),       # window
    (160, (50, 60, 40), 0),         # a segment straddles a 64-row tile
    (512, (300, 130, 70), 0),       # interior full tiles
    (200, (90, 70), 0),             # T % 64 != 0, a padding segment
    (136, (1, 1, 1, 100, 1, 1), 0),  # single tokens around a long one
    (512, (420, 60), 100),          # window over a long segment
])
def test_segment_flash_kernel_matches_plain(cuda, h, kv, d, dtype, t, lens,
                                            window):
    gen = torch.Generator(device=cuda).manual_seed(1)
    seg = np.full((t,), len(lens), np.int32)
    starts = np.zeros((len(lens),), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        starts[i] = off
        off += n
    seg_t = torch.from_numpy(seg).to(cuda)
    starts_t = torch.from_numpy(starts).to(cuda)
    slens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = _randn(gen, (1, t, h, d), dtype, cuda)
    k = _randn(gen, (1, t, kv, d), dtype, cuda)
    v = _randn(gen, (1, t, kv, d), dtype, cuda)
    got = FA.segment_flash_attention_cuda(q, k, v, seg_t, window=window)
    want = FA.segment_flash_attention_plain(
        q, k, v, seg_t, packed_positions(seg_t, starts_t), starts_t, slens,
        row_len=1 << (max(lens) - 1).bit_length(), window=window)
    torch.testing.assert_close(got[:, :off].float(), want[:, :off].float(),
                               **TOL[dtype])


@pytest.mark.parametrize("h,kv,d", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps,max_pages,r,hist,slen,window", [
    # fresh, mid-page, padding segment (all inside one 64-key tile)
    (8, 8, 16, [0, 13, 40, 0], [16, 5, 16, 0], 0),
    # phase (b)'s continuations: histories 388 and 512, 512 chunk rows,
    # partial row tiles of 300 and 129 real rows
    (16, 64, 512, [0, 512, 388, 0], [512, 300, 129, 0], 0),
    (16, 64, 512, [0, 512, 388], [512, 300, 129], 100),   # a window
    (16, 128, 5, [2000, 0, 1999], [5, 3, 1], 0),   # R 5 over hist 2000
    (24, 32, 200, [388, 0, 100], [200, 64, 65], 0),  # page of no power 2
])
def test_paged_chunk_kernel_matches_plain(cuda, h, kv, d, dtype, ps,
                                          max_pages, r, hist, slen, window):
    gen = torch.Generator(device=cuda).manual_seed(2)
    live = [-(-n // ps) for n in hist]
    s = len(hist)
    poisoned, sane, n_pages = _tables(gen, s, max_pages, live, cuda)
    q = _randn(gen, (s, r, h, d), dtype, cuda)
    kc = _randn(gen, (s, r, kv, d), dtype, cuda)
    vc = _randn(gen, (s, r, kv, d), dtype, cuda)
    kp = _randn(gen, (n_pages, ps, kv, d), dtype, cuda)
    vp = _randn(gen, (n_pages, ps, kv, d), dtype, cuda)
    hl = torch.tensor(hist, dtype=torch.int32, device=cuda)
    sl = torch.tensor(slen, dtype=torch.int32, device=cuda)
    before = CA.launches
    got = CA.paged_chunk_attention_cuda(q, kp, vp, kc, vc, poisoned, hl, sl,
                                        window=window)
    assert CA.launches == before + 1
    want = CA.paged_chunk_attention_plain(q, kp, vp, kc, vc, sane, hl, sl,
                                          window=window)
    for i, m in enumerate(slen):
        torch.testing.assert_close(got[i, :m].float(), want[i, :m].float(),
                                   **TOL[dtype])
        assert (got[i, m:] == 0).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 4, 64, device=cuda)
    pages = torch.zeros(5, 12, 2, 64, device=cuda)          # page 12
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        PA.paged_decode_attention_cuda(q, pages, pages, tables, lens)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 8, 2, 32, device=cuda)
        FA.segment_flash_attention_cuda(
            x, x, x, torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        x = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
        FA.segment_flash_attention_cuda(
            x, x, x, torch.zeros(8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 8, 2, 96, device=cuda)
        FA.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="int32"):
        DA.decode_attention_cuda(q, pages[:2], pages[:2], lens.long())
    with pytest.raises(ValueError, match="head_dim 112 not built"):
        x = torch.zeros(1, 8, 2, 112, device=cuda)        # #3: 64 and 128
        p112 = torch.zeros(5, 8, 2, 112, device=cuda)
        CA.paged_chunk_attention_cuda(
            x, p112, p112, x, x, tables, lens, lens)


def test_wrappers_refuse_views_off_a_16_byte_boundary(cuda):
    """#1, #3, #4 and the bf16 #2, #5 and #6 read 16-byte vectors: a
    contiguous view at an odd offset raises instead of faulting."""
    flat = torch.zeros(2 * 64 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    kc = flat[1:].view(2, 64, 2, 64)
    q = torch.zeros(2, 4, 64, device=cuda, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        DA.decode_attention_cuda(q, kc, kc, lens)
    x = flat[1:1 + 2 * 16 * 4 * 64].view(2, 16, 4, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        FA.flash_attention_cuda(x, x, x)
    seg = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        FA.segment_flash_attention_cuda(x[:1], x[:1], x[:1], seg)
    pages = flat[1:1 + 2 * 16 * 2 * 64].view(2, 16, 2, 64)
    tables = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        PA.paged_decode_attention_cuda(q, pages, pages, tables, lens)
    with pytest.raises(ValueError, match="16-byte boundary"):
        rows = flat[1:1 + 16 * 2 * 64].view(1, 16, 2, 64)
        CA.paged_chunk_attention_cuda(x[:1], pages, pages, rows, rows,
                                      tables[:1], lens[:1], lens[:1])
    xs = flat[1:1 + 2 * 16 * 64].view(1, 16, 2, 64)
    bc = torch.zeros(1, 16, 128, device=cuda, dtype=torch.bfloat16)
    dt = torch.zeros(1, 16, 2, device=cuda)
    a = -torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        SSD.ssd_scan_cuda(xs, dt, a, bc, bc, 16)


@pytest.mark.parametrize("h,kv,d", [(8, 4, 64), (16, 4, 128), (18, 2, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_pads_groups_to_eight_heads(cuda, h, kv, d, dtype):
    """Groups of 2 and 4 query heads run the 8-head body with padded
    heads, and a group of 9 takes two passes of it."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    lengths = [0, 1, 700, 2048]
    b, c = len(lengths), 2048
    q = _randn(gen, (b, h, d), dtype, cuda)
    kc = _randn(gen, (b, c, kv, d), dtype, cuda)
    vc = _randn(gen, (b, c, kv, d), dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = DA.decode_attention_cuda(q, kc, vc, lens)
    want = DA.decode_attention_plain(q, kc, vc, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert (got[0] == 0).all()


def _launch_counts():
    return (PA.launches, FA.segment_launches, CA.launches, DA.launches,
            FA.flash_launches)


@pytest.mark.parametrize("paged", [True, False])
def test_gpu_serving_matches_cpu_serving(cuda, paged):
    """The same seeded weights and requests, served through the kernels
    on the card and through the plain versions on the CPU (reduced
    olmo-1b, float32), on paged and on ring slots: identical greedy
    streams, and every kernel of the path ran."""
    cfg = get_config("olmo-1b").reduced()
    gpu = make_engine(cfg, seed=3, cache_len=64, device=cuda).init_slots(
        4, paged=paged, page_size=8)
    cpu = make_engine(cfg, cache_len=64, device="cpu").init_slots(
        4, paged=paged, page_size=8)
    cpu.params = _cpu(gpu.params)
    rng = np.random.default_rng(0)
    spec = [(i, int(rng.integers(3, 40)), int(rng.integers(2, 10)))
            for i in range(6)]
    prompts = {i: rng.integers(1, cfg.vocab_size, (1, p)).astype(np.int32)
               for i, p, _ in spec}
    launches0 = _launch_counts()
    streams = []
    for eng in (gpu, cpu):
        reqs = [Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                        n_tokens=nt, prompt_len=p) for i, p, nt in spec]
        planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                              PlannerConfig(chunk_tokens=16))
        srv = serve_ticks(planner, reqs, lambda r: {"tokens": prompts[r.rid]})
        assert not srv.truncated
        streams.append(planner.streams)
    assert streams[0] == streams[1]
    ran = [n > n0 for n, n0 in zip(_launch_counts(), launches0)]
    # paged: paged decode, packed prefill, chunk; ring: packed prefill
    # (admissions and recomputed continuations) and contiguous decode
    assert ran == ([True, True, True, False, False] if paged
                   else [False, True, False, True, False])


def test_gpu_generate_matches_cpu_generate(cuda):
    """Batch ``generate`` through the flash and decode kernels equals the
    plain versions' on the CPU, token for token."""
    cfg = get_config("qwen2-0.5b").reduced()
    gpu = make_engine(cfg, seed=2, cache_len=32, device=cuda)
    cpu = make_engine(cfg, cache_len=32, device="cpu")
    cpu.params = _cpu(gpu.params)
    tokens = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, 45)).astype(np.int32)
    launches0 = _launch_counts()
    got = gpu.generate({"tokens": tokens}, 12).cpu()
    assert [n > n0 for n, n0 in zip(_launch_counts(), launches0)] == \
        [False, False, False, True, True]
    assert torch.equal(got, cpu.generate({"tokens": tokens}, 12))


def _shared_prefix_requests(cfg, n=10):
    """``tests/test_prefix_cache.py``'s shared-prefix stream: templates of
    20 and 8 tokens (20 is not a page multiple: hits copy a page) plus
    tails of 2-5, budgets 3-8."""
    rng = np.random.default_rng(3)
    temps = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
             for s in (20, 8)]
    spec, prompts = [], {}
    for i in range(n):
        t = temps[int(rng.integers(0, 2))]
        tail = rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(2, 6))).astype(np.int32)
        prompts[i] = np.concatenate([t, tail])[None, :]
        spec.append((i, prompts[i].shape[1], int(rng.integers(3, 9))))
    return spec, prompts


@pytest.mark.parametrize("feature", ["prefix_cache", "speculative"])
def test_gpu_prefix_and_speculative_serves_match_cpu(cuda, feature):
    """The radix prompt cache (the shared-prefix stream, cache off and
    on) and speculative decoding (an identical-weights ring draft,
    spec_k 3, plain and speculative) on the card under CUDA graphs and on
    the CPU (reduced olmo-1b, float32): every serve's greedy streams and
    counters equal across devices, each feature's streams equal its plain
    serve's, acceptance is 1.0, and the feature's kernels ran on the card:
    #1 and #2 for forced catch-up and misses; #3 (verify) and #4 (the
    draft) for speculation."""
    cfg = get_config("olmo-1b").reduced()
    engines = []
    for dev in (cuda, "cpu"):
        eng = make_engine(cfg, seed=3, cache_len=32, device=dev).init_slots(
            4, page_size=8)
        if engines:
            eng.params = _cpu(engines[0].params)
        if feature == "prefix_cache":
            eng.enable_prefix_cache()
            eng.warm_prefix_ops()
        else:
            draft = InferenceEngine(eng.api, eng.params,
                                    cache_len=32).init_slots(4, paged=False)
            eng.attach_draft(draft, spec_k=3)
        engines.append(eng)
    spec, prompts = _shared_prefix_requests(cfg)
    on = ({"prefix_cache": True} if feature == "prefix_cache"
          else {"spec_k": 3})
    launches0 = _launch_counts()
    runs = []
    for eng in engines:
        for kw in ({}, on):
            eng.release_all_slots()
            eng.reset_stats()
            reqs = [Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                            n_tokens=nt, prompt_len=p) for i, p, nt in spec]
            planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                                  PlannerConfig(gen_len=4, **kw))
            srv = serve_ticks(planner, reqs,
                              lambda r: {"tokens": prompts[r.rid]})
            assert not srv.truncated
            runs.append((planner.streams, dataclasses.asdict(eng.stats)))
        if eng.device.type == "cuda":
            ran = [n > n0 for n, n0 in zip(_launch_counts(), launches0)]
    assert runs[2:] == runs[:2], "GPU and CPU serves differ"
    assert runs[1][0] == runs[0][0], f"{feature} changed the streams"
    st = runs[1][1]
    if feature == "prefix_cache":
        assert st["prefix_hits"] and st["cow_copies"]
        assert st["forced_catchup_tokens"]
        assert ran == [True, True, False, False, False]
    else:
        assert st["spec_rounds"]
        assert st["accepted_tokens"] == st["draft_tokens"]
        assert ran == [True, True, True, True, False]


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _ssd_inputs(gen, dev, dtype, b, l, h, n=128, p=64):
    """x, b, c in ``dtype``; dt (softplus of a normal) and a (negative) in
    float32, as the model feeds them."""
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=gen, device=dev))
    a = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))
    return (_randn(gen, (b, l, h, p), dtype, dev), dt, a,
            _randn(gen, (b, l, n), dtype, dev),
            _randn(gen, (b, l, n), dtype, dev))


def _ssd_close(got, want, dtype):
    if dtype == "float32":
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.float().abs().max())), err
    else:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("n", [128, 64])          # mamba2-1.3b, zamba2-7b
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,h,chunk,with_state", [
    (2, 300, 4, 128, False),        # ragged last chunk
    (1, 64, 3, 128, False),         # L < chunk: one chunk of L rows
    (2, 1, 2, 128, False),          # one token
    (1, 257, 2, 64, True),          # chunk 64, a carried-in state
    (2, 45, 2, 18, False),          # chunk 18: rows not a multiple of 4
    (2, 300, 5, 128, True),         # a ragged head group, a carried state
    (1, 1000, 3, 100, False),       # chunk 100 < L, a ragged head group
])
def test_ssd_kernel_matches_plain(cuda, dtype, b, l, h, chunk, with_state,
                                  n):
    gen = torch.Generator(device=cuda).manual_seed(l)
    x, dt, a, bb, cc = _ssd_inputs(gen, cuda, dtype, b, l, h, n=n)
    s0 = (torch.randn(b, h, n, 64, generator=gen, device=cuda)
          if with_state else None)
    before = SSD.launches
    y, s = SSD.ssd_scan_cuda(x, dt, a, bb, cc, chunk, initial_state=s0)
    assert SSD.launches == before + 1
    wy, ws = SSD.ssd_chunked_plain(x, dt, a, bb, cc, chunk,
                                   initial_state=s0)
    assert y.dtype == x.dtype and s.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    _ssd_close(y, wy, dtype)
    _ssd_close(s, ws, "float32")


@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_dt_zero_tail_freezes_the_state(cuda, dtype, n):
    """Packed rows whose tails carry dt = 0 (x, b, c there are not zero)
    end with the state of their unpadded runs, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    lens, row_len = (300, 512, 129), 512
    x, dt, a, bb, cc = _ssd_inputs(gen, cuda, dtype, len(lens), row_len, 4,
                                   n=n)
    for i, n in enumerate(lens):
        dt[i, n:] = 0.0
    y, s = SSD.ssd_scan_cuda(x, dt, a, bb, cc, 128)
    for i, n in enumerate(lens):
        one = [v[i:i + 1, :n].contiguous() for v in (x, dt)] + [a] + \
            [v[i:i + 1, :n].contiguous() for v in (bb, cc)]
        y1, s1 = SSD.ssd_scan_cuda(*one, 128)
        assert torch.equal(s[i:i + 1], s1), f"row {i}: state moved"
        assert torch.equal(y[i:i + 1, :n], y1), f"row {i}: outputs differ"


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_does_not_depend_on_the_batch(cuda, dtype):
    """A batch of 4 rows gives each row, bit for bit, the outputs and
    final state of that row run alone (the block layout and every order
    of summation are independent of B)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, dt, a, bb, cc = _ssd_inputs(gen, cuda, dtype, 4, 384, 5)
    y, s = SSD.ssd_scan_cuda(x, dt, a, bb, cc, 128)
    for i in range(4):
        one = [v[i:i + 1].contiguous() for v in (x, dt)] + [a] + \
            [v[i:i + 1].contiguous() for v in (bb, cc)]
        y1, s1 = SSD.ssd_scan_cuda(*one, 128)
        assert torch.equal(s[i:i + 1], s1), f"row {i}: state differs"
        assert torch.equal(y[i:i + 1], y1), f"row {i}: outputs differ"


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, a, bb, cc = _ssd_inputs(gen, cuda, "float32", 1, 8, 2, n=32)
    with pytest.raises(ValueError, match="not built"):
        SSD.ssd_scan_cuda(x, dt, a, bb, cc, 128)
    x, dt, a, bb, cc = _ssd_inputs(gen, cuda, "float32", 1, 300, 2)
    with pytest.raises(ValueError, match="above"):
        SSD.ssd_scan_cuda(x, dt, a, bb, cc, 256)
    with pytest.raises(ValueError, match="one dtype"):
        SSD.ssd_scan_cuda(x, dt, a, bb.bfloat16(), cc, 128)
    with pytest.raises(ValueError, match="float32"):
        SSD.ssd_scan_cuda(x, dt.bfloat16(), a, bb, cc, 128)


def _ssm_cfg():
    """mamba2-1.3b reduced to 2 layers and d_model 256, with the full
    model's SSD heads (N 128, P 64), the shapes the kernel is built for."""
    return dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                               ssm_state=128, ssm_head_dim=64,
                               ssm_chunk=128)


def _hybrid_cfg():
    """zamba2-7b reduced to d_model 256 and 12 layers (two invocations of
    the shared block), with the full model's head_dim 112 and SSD heads
    (N 64, P 64, chunk 128): the shapes the kernels are built for."""
    return dataclasses.replace(get_config("zamba2-7b").reduced(),
                               num_layers=12, attn_every=6, head_dim=112,
                               ssm_state=64, ssm_head_dim=64, ssm_chunk=128)


def test_gpu_hybrid_paged_serve_matches_cpu(cuda):
    """The hybrid family on the card, float32: a paged ``serve_ticks``
    with recomputed continuations equals the CPU's plain run token for
    token, through #6 (every mamba layer of every prefill), #2 and #1,
    never #3."""
    cfg = _hybrid_cfg()
    gpu = make_engine(cfg, seed=3, cache_len=256, device=cuda).init_slots(
        4, page_size=16)
    cpu = make_engine(cfg, cache_len=256, device="cpu").init_slots(
        4, page_size=16)
    cpu.params = _cpu(gpu.params)
    assert gpu.paged and not gpu.chunk_capable()
    rng = np.random.default_rng(1)
    spec = [(i, int(rng.integers(3, 200)), int(rng.integers(2, 10)))
            for i in range(6)]
    prompts = {i: rng.integers(1, cfg.vocab_size, (1, p)).astype(np.int32)
               for i, p, _ in spec}
    before = ops.launch_counts()
    streams = []
    for eng in (gpu, cpu):
        reqs = [Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                        n_tokens=nt, prompt_len=p) for i, p, nt in spec]
        planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                              PlannerConfig(chunk_tokens=64))
        srv = serve_ticks(planner, reqs, lambda r: {"tokens": prompts[r.rid]})
        assert not srv.truncated
        streams.append(planner.streams)
    assert streams[0] == streams[1]
    assert gpu.stats.chunk_prefills > 0
    ran = {k: n - before[k] for k, n in ops.launch_counts().items()}
    assert ran["ssd_scan"] == cfg.num_layers * gpu.stats.prefills, ran
    assert ran["segment_flash_attention"] > 0
    assert ran["paged_decode_attention"] > 0
    assert ran["paged_chunk_attention"] == 0


def test_gpu_ssm_serving_and_generate_match_cpu(cuda):
    """The Mamba2 family on the card: ``serve_ticks`` with recomputed
    continuations, then batch ``generate``, equal the CPU's plain run
    token for token, and every scan went through the kernel."""
    cfg = _ssm_cfg()
    gpu = make_engine(cfg, seed=3, cache_len=256, device=cuda).init_slots(4)
    cpu = make_engine(cfg, cache_len=256, device="cpu").init_slots(4)
    cpu.params = _cpu(gpu.params)
    assert not gpu.paged
    rng = np.random.default_rng(0)
    spec = [(i, int(rng.integers(3, 200)), int(rng.integers(2, 10)))
            for i in range(6)]
    prompts = {i: rng.integers(1, cfg.vocab_size, (1, p)).astype(np.int32)
               for i, p, _ in spec}
    before = SSD.launches
    streams = []
    for eng in (gpu, cpu):
        reqs = [Request(arrival=0.0, rid=i, model=cfg.name, slo=1e9,
                        n_tokens=nt, prompt_len=p) for i, p, nt in spec]
        planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                              PlannerConfig(chunk_tokens=64))
        srv = serve_ticks(planner, reqs, lambda r: {"tokens": prompts[r.rid]})
        assert not srv.truncated
        streams.append(planner.streams)
    assert streams[0] == streams[1]
    assert gpu.stats.chunk_prefills > 0
    assert SSD.launches > before
    tokens = rng.integers(1, cfg.vocab_size, (3, 150)).astype(np.int32)
    got = gpu.generate({"tokens": tokens}, 12).cpu()
    assert torch.equal(got, cpu.generate({"tokens": tokens}, 12))


# --------------------------------------------------------------------------
# CUDA graphs: the graphed engine against the eager one
# --------------------------------------------------------------------------
GRAPH_PATHS = {
    # path: (model, slots (None: generate), paged, chunk_tokens, kernels)
    "paged": ("olmo-1b", 4, True, 0,
              {"paged_decode_attention", "segment_flash_attention"}),
    "chunked": ("olmo-1b", 4, True, 16,
                {"paged_decode_attention", "segment_flash_attention",
                 "paged_chunk_attention"}),
    "ring": ("olmo-1b", 4, False, 16,
             {"segment_flash_attention", "decode_attention"}),
    "ssm": ("mamba2-1.3b", 4, True, 64, {"ssd_scan"}),
    "generate": ("qwen2-0.5b", None, False, 0,
                 {"flash_attention", "decode_attention"}),
    "ssm_generate": ("mamba2-1.3b", None, False, 0, {"ssd_scan"}),
}


def _graph_cfg(model, dtype):
    cfg = _ssm_cfg() if model == "mamba2-1.3b" else \
        get_config(model).reduced()
    return dataclasses.replace(cfg, dtype=dtype)


def _graph_run(eng, path, rng_seed=0):
    """Run ``path`` on ``eng``; returns its tokens."""
    model, slots, paged, chunk_tokens, _ = GRAPH_PATHS[path]
    rng = np.random.default_rng(rng_seed)
    if slots is None:
        tokens = rng.integers(1, eng.cfg.vocab_size, (3, 150)).astype(
            np.int32)
        return eng.generate({"tokens": tokens}, 12).cpu().tolist()
    spec = [(i, int(rng.integers(3, 200 if model == "mamba2-1.3b" else 40)),
             int(rng.integers(2, 10))) for i in range(6)]
    prompts = {i: rng.integers(1, eng.cfg.vocab_size, (1, p)).astype(
        np.int32) for i, p, _ in spec}
    eng.release_all_slots()
    reqs = [Request(arrival=0.0, rid=i, model=eng.cfg.name, slo=1e9,
                    n_tokens=nt, prompt_len=p) for i, p, nt in spec]
    planner = StepPlanner(eng, RequestQueue(eng.cfg.name, slo=1e9),
                          PlannerConfig(chunk_tokens=chunk_tokens))
    srv = serve_ticks(planner, reqs, lambda r: {"tokens": prompts[r.rid]})
    assert not srv.truncated
    return planner.streams


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graphed_engine_equals_eager_engine(cuda, path, dtype):
    """The same weights and requests through an engine that replays CUDA
    graphs and one that runs every step eagerly (``graphs=False``):
    identical streams and bit-identical last-step logits of the rows it
    stepped; a repeat on the
    graphed engine captures nothing new; the launch counters count the
    replays, as many launches as the eager run makes, of exactly the
    path's kernels."""
    model, slots, paged, _, kernels = GRAPH_PATHS[path]
    cfg = _graph_cfg(model, dtype)
    engines = []
    for graphs in (True, False):
        eng = make_engine(cfg, seed=3, cache_len=256, device=cuda,
                          dtype=getattr(torch, dtype), graphs=graphs)
        if slots is not None:
            eng.init_slots(slots, paged=paged, page_size=16)
        engines.append(eng)
    graphed, eager = engines
    # the graphed run captures its buckets; both engines then hold the
    # same history, vacant slots included
    first = _graph_run(graphed, path)
    assert _graph_run(eager, path) == first
    sizes = graphed.jit_cache_sizes()
    assert sum(sizes.values()) > 0, sizes
    assert sum(eager.jit_cache_sizes().values()) == 0
    launches = []
    for eng in (graphed, eager):
        ops.reset_launch_counts()
        streams = _graph_run(eng, path)
        torch.cuda.synchronize()
        launches.append(ops.launch_counts())
        assert streams == first
    assert graphed.jit_cache_sizes() == sizes, "a repeat captured again"
    assert launches[0] == launches[1]
    assert {n for n, k in launches[0].items() if k} == kernels, launches
    kind = "generate" if slots is None else "slot_step"
    steps = [next(iter(e._graphs.entries[kind].values())) for e in engines]
    rows = slice(None)
    if slots is not None:
        # rows the last step stepped: a vacant row reads the null page,
        # where every vacant row's dead write lands in an unordered race
        rows = steps[0].views["mask"] != 0
        assert torch.equal(rows, steps[1].views["mask"] != 0)
        assert bool(rows.any())
    assert torch.equal(steps[0].out[rows], steps[1].out[rows])


def test_graphed_slot_state_keeps_its_addresses(cuda):
    """A graphed serve reads and writes the slot buffers in place: every
    leaf and the pending tokens keep their addresses, and switching the
    same engine to eager and back keeps its captures."""
    cfg = get_config("olmo-1b").reduced()
    eng = make_engine(cfg, seed=3, cache_len=256, device=cuda).init_slots(
        4, page_size=16)
    addr = {k: v.data_ptr() for k, v in eng._slot_cache.items()}
    tok = eng._last_tok.data_ptr()
    first = _graph_run(eng, "chunked")
    sizes = eng.jit_cache_sizes()
    eng.graphs = False
    assert _graph_run(eng, "chunked") == first
    eng.graphs = True
    assert _graph_run(eng, "chunked") == first
    assert eng.jit_cache_sizes() == sizes
    assert {k: v.data_ptr() for k, v in eng._slot_cache.items()} == addr
    assert eng._last_tok.data_ptr() == tok


# --------------------------------------------------------------------------
# sampled decoding, the telemetry plane and the gateway on the card
# --------------------------------------------------------------------------
NUCLEUS = dict(temperature=0.8, top_k=50, top_p=0.95)


def _sampled_serve(eng, seed):
    """``_graph_run``'s chunked path with the slot noise restarted from
    ``seed``."""
    eng.seed_slots(seed)
    return _graph_run(eng, "chunked")


def test_graphed_sampled_step_equals_eager_and_replays_draw_afresh(cuda):
    """A sampled slot serve whose steps replay CUDA graphs draws, from the
    same seed, what the eager engine draws (the generator is registered
    with each capture), every replay draws afresh (another seed, another
    stream; a repeat of a seed, the same stream), and a repeat captures
    nothing; sampled ``generate`` likewise."""
    from repro_torch.serving.engine import SamplingParams
    cfg = get_config("olmo-1b").reduced()
    engines = [make_engine(cfg, seed=3, cache_len=256, device=cuda,
                           graphs=graphs).init_slots(
        4, page_size=16, sampling=SamplingParams(**NUCLEUS))
        for graphs in (True, False)]
    graphed, eager = engines
    first = _sampled_serve(graphed, 0)
    sizes = graphed.jit_cache_sizes()
    assert sizes["slot_step"] == 1
    again = _sampled_serve(graphed, 0)
    assert again == first == _sampled_serve(eager, 0)
    other = _sampled_serve(graphed, 1)
    assert other != first and other == _sampled_serve(eager, 1)
    assert graphed.jit_cache_sizes() == sizes
    assert all(0 <= t < cfg.vocab_size for s in first.values() for t in s)
    tokens = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, 40)).astype(np.int32)
    sp = SamplingParams(temperature=5.0)
    runs = [e.generate({"tokens": tokens}, 12, rng=r, sampling=sp).cpu()
            for e, r in ((graphed, 7), (graphed, 7), (eager, 7),
                         (graphed, 8))]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], runs[3])
    # a near-uniform draw: the 12 steps of a row are not one token
    assert all(len(set(row.tolist())) > 1 for row in runs[0])


def test_sampler_distribution_on_the_card(cuda):
    """Phase (i2) at a small size: every draw lies in the support the
    plain filter leaves, and the draws' total variation from the
    renormalised softmax over it is at most 0.03."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=cuda).manual_seed(0)
    lg = torch.randn(4, 1000, generator=gen, device=cuda) * 3.0
    n = 1 << 14
    conf = dict(temperature=0.8, top_k=50, top_p=0.95)
    filt = L.top_k_top_p_filter(lg / 0.8, top_k=50, top_p=0.95)
    p = torch.softmax(filt.double(), -1)
    draws = L.sample_logits(gen, lg.repeat_interleave(n, 0), **conf)
    draws = draws.view(4, n)
    support = filt > -1e29
    assert bool(support.gather(1, draws).all())
    freq = torch.zeros_like(p).scatter_add_(
        1, draws, torch.ones_like(draws, dtype=p.dtype)) / n
    tv = 0.5 * (freq - p).abs().sum(-1)
    assert float(tv.max()) <= 0.03, tv


def test_telemetry_attached_graphed_serve_captures_nothing(cuda):
    """A graphed serve with the telemetry plane attached (each dispatch
    timed behind a synchronisation of the engine's stream) gives the
    detached serve's streams and captures nothing new; the trace is
    valid and every dispatch kind was timed."""
    from repro_torch.serving.telemetry import (Telemetry, TraceRecorder,
                                               validate_chrome_trace)
    cfg = get_config("olmo-1b").reduced()
    eng = make_engine(cfg, seed=3, cache_len=256, device=cuda).init_slots(
        4, page_size=16)
    first = _graph_run(eng, "chunked")
    sizes = eng.jit_cache_sizes()
    tel = Telemetry(trace=TraceRecorder())
    eng.attach_telemetry(tel)
    try:
        traced = _graph_run(eng, "chunked")
    finally:
        eng.attach_telemetry(None)
    assert traced == first
    assert eng.jit_cache_sizes() == sizes
    assert validate_chrome_trace(tel.trace.to_chrome_trace()) > 0
    kinds = {k[2] for k in tel.timers.samples}
    assert {"admission_prefill", "chunk_prefill", "decode"} <= kinds
    assert all(x > 0 for xs in tel.timers.samples.values() for x in xs)


def test_gateway_on_cuda_equals_serve_ticks(cuda):
    """``bench_gateway``'s quick burst trace through the async gateway on
    a graphed CUDA engine (float32): the streams of ``serve_ticks`` on the
    same engine and of the gateway on the CPU, under tiers; and the CPU's
    scorecard counts."""
    from repro_torch.serving import traffic
    from repro_torch.serving.gateway import AsyncGateway
    cfg = get_config("olmo-1b").reduced()
    gpu = make_engine(cfg, seed=3, cache_len=32, device=cuda).init_slots(
        4, page_size=8)
    cpu = make_engine(cfg, cache_len=32, device="cpu").init_slots(
        4, page_size=8)
    cpu.params = _cpu(gpu.params)
    reqs = traffic.burst_trace(traffic.TrafficConfig(
        model=cfg.name, duration=0.2, rate=240.0, seed=12, slo_unit=1e-3,
        prompt_tokens=(4, 12), gen_tokens=(3, 8)), burst_mult=16.0)
    prompts = traffic.synth_prompts(reqs, vocab=cfg.vocab_size, seed=0)
    tiers = dict(traffic.TIER_WEIGHTS)
    out = []
    for eng, gateway in ((gpu, True), (gpu, False), (cpu, True)):
        for r in reqs:
            r.state, r.finish, r.first_token, r.tokens_out = \
                "pending", -1.0, -1.0, 0
        eng.release_all_slots()
        planner = StepPlanner(eng, RequestQueue(cfg.name, slo=1e9),
                              PlannerConfig(gen_len=4, tiers=tiers))
        if gateway:
            gw = AsyncGateway(planner, stall_limit=100)
            gw.serve_trace(reqs, prompts)
            assert not gw.truncated
        else:
            srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid],
                              stall_limit=100)
            assert not srv.truncated
        q = planner.queue
        out.append(({r: tuple(t) for r, t in planner.streams.items()},
                    (q.completed, q.shed, q.dropped, q.deadline_aborted),
                    traffic.attainment_by(reqs, "tier")))
    assert out[0] == out[1] == out[2]


# --------------------------------------------------------------------------
# the encoder-decoder family: #5 with more keys than queries, whisper
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (2, 64, 1536, 12, 12, 64),      # whisper's packed cross rows
    (2, 224, 1536, 12, 12, 64),
    (3, 5, 16, 4, 4, 64),           # reduced whisper
    (1, 70, 33, 8, 2, 128),         # fewer keys than queries, GQA
    (2, 129, 200, 16, 16, 128),     # ragged edges on both sides
])
def test_flash_kernel_cross_attention_matches_plain(cuda, dtype, b, sq, sk,
                                                    h, kv, d):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = _randn(gen, (b, sq, h, d), dtype, cuda)
    k = _randn(gen, (b, sk, kv, d), dtype, cuda)
    v = _randn(gen, (b, sk, kv, d), dtype, cuda)
    got = FA.flash_attention_cuda(q, k, v, causal=False)
    want = FA.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    with pytest.raises(ValueError, match="as many keys as queries"):
        FA.flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="as many keys as queries"):
        FA.flash_attention_cuda(q, k, v, causal=False, window=8)


def test_cross_decode_lengths_are_captured_without_a_host_copy(cuda):
    """The cross-attention decode's one length (the encoder's) is filled
    on the device: the call captures into a CUDA graph (a copy from
    pageable host memory would fail the capture) and the replay equals an
    eager call."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (8, 12, 64), "bfloat16", cuda)
    kc = _randn(gen, (8, 1536, 12, 64), "bfloat16", cuda)
    vc = _randn(gen, (8, 1536, 12, 64), "bfloat16", cuda)
    want = L.decode_attention(q, kc, vc, 1536)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        L.decode_attention(q, kc, vc, 1536)           # warm on the stream
        with torch.cuda.graph(graph, stream=side):
            out = L.decode_attention(q, kc, vc, 1536)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _whisper_serve(eng, seed=0):
    """Six requests with their own stub frames through ``serve_ticks``
    (chunked: continuations recompute the prefix). Returns the streams."""
    from repro_torch.serving import modality
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    spec = [(i, int(rng.integers(3, 40)), int(rng.integers(2, 10)))
            for i in range(6)]
    prompts = {i: {"tokens": rng.integers(1, eng.cfg.vocab_size, (1, p))
                   .astype(np.int32),
                   "enc_embeds": modality.audio_frames(eng.cfg, 1,
                                                       generator=gen)}
               for i, p, _ in spec}
    eng.release_all_slots()
    reqs = [Request(arrival=0.0, rid=i, model=eng.cfg.name, slo=1e9,
                    n_tokens=nt, prompt_len=p) for i, p, nt in spec]
    planner = StepPlanner(eng, RequestQueue(eng.cfg.name, slo=1e9),
                          PlannerConfig(chunk_tokens=16))
    srv = serve_ticks(planner, reqs, lambda r: prompts[r.rid])
    assert not srv.truncated
    return planner.streams


@pytest.mark.parametrize("paged", [True, False])
def test_graphed_whisper_serve_equals_eager_and_cpu(cuda, paged):
    """Reduced whisper-small (float32): a graphed serve captures once and
    then replays; it equals the same engine's eager serve and the CPU's
    plain versions, stream for stream, through exactly the family's
    kernels: #5 (encoder, cross), #2, and #1 (paged) or #4 (ring self),
    with #4 for the cross-attention decode."""
    cfg = get_config("whisper-small").reduced()
    gpu = make_engine(cfg, seed=4, cache_len=64, device=cuda).init_slots(
        4, paged=paged, page_size=8)
    cpu = make_engine(cfg, cache_len=64, device="cpu").init_slots(
        4, paged=paged, page_size=8)
    cpu.params = _cpu(gpu.params)
    first = _whisper_serve(gpu)
    sizes = gpu.jit_cache_sizes()
    assert sizes["packed_prefill"] > 0 and sizes["slot_step"] == 1
    ops.reset_launch_counts()
    assert _whisper_serve(gpu) == first
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert gpu.jit_cache_sizes() == sizes, "a repeat captured again"
    want = {"segment_flash_attention", "decode_attention",
            "flash_attention"} | ({"paged_decode_attention"} if paged
                                  else set())
    assert {n for n, k in launches.items() if k} == want, launches
    gpu.graphs = False
    assert _whisper_serve(gpu) == first
    gpu.graphs = True
    assert _whisper_serve(cpu) == first


# --------------------------------------------------------------------------
# the mixture-of-experts family
# --------------------------------------------------------------------------
def _moe_cfg():
    """Reduced granite-moe at granite's routing width: 40 experts, top-8
    (float32)."""
    return dataclasses.replace(get_config("granite-moe").reduced(),
                               num_experts=40, experts_per_token=8)


@pytest.mark.parametrize("cf", [1.25, 0.1])
@pytest.mark.parametrize("shape", [(8, 1), (2, 16), (1, 300)],
                         ids=["decode", "flat", "per_row"])
def test_gpu_moe_dispatch_matches_cpu(cuda, shape, cf):
    """The expert dispatch on the card and on the CPU, float32: the same
    expert indices and drop masks, outputs within 2e-5."""
    from repro_torch.models import moe
    from repro_torch.models.weights import init_params
    cfg = _moe_cfg()
    lp = init_params(cfg, torch.Generator(device=cuda).manual_seed(1),
                     device=cuda)["layers"]["moe"]
    p = {k: v[0] for k, v in lp.items()}
    x = torch.randn(shape + (cfg.d_model,),
                    generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    got = moe.dispatch(p, cfg, x, cf)
    want = moe.dispatch(_cpu(p), cfg, x.cpu(), cf)
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[3].cpu(), want[3])
    torch.testing.assert_close(got[0].cpu(), want[0], **TOL["float32"])
    if cf == 0.1 and shape != (8, 1):
        assert bool(want[3].any())


def _moe_serve(eng, spec, prompts, **planner_kw):
    eng.release_all_slots()
    eng.reset_stats()
    reqs = [Request(arrival=0.0, rid=i, model=eng.cfg.name, slo=1e9,
                    n_tokens=nt, prompt_len=p) for i, p, nt in spec]
    planner = StepPlanner(eng, RequestQueue(eng.cfg.name, slo=1e9),
                          PlannerConfig(gen_len=4, **planner_kw))
    srv = serve_ticks(planner, reqs, lambda r: {"tokens": prompts[r.rid]})
    assert not srv.truncated
    return planner.streams, dataclasses.asdict(eng.stats)


@pytest.mark.parametrize("paged", [True, False])
def test_graphed_moe_serve_equals_eager_and_cpu(cuda, paged):
    """Reduced granite-moe at 40 experts top-8 (float32): a chunked serve
    (continuations recompute the prefix) captures once, then replays; it
    equals the same engine's eager serve and the CPU's, stream for stream
    and counter for counter, through exactly #2 and #1 (paged) or #4
    (ring) — never #3."""
    cfg = _moe_cfg()
    gpu = make_engine(cfg, seed=4, cache_len=64, device=cuda).init_slots(
        4, paged=paged, page_size=8)
    cpu = make_engine(cfg, cache_len=64, device="cpu").init_slots(
        4, paged=paged, page_size=8)
    cpu.params = _cpu(gpu.params)
    rng = np.random.default_rng(5)
    spec = [(i, int(rng.integers(3, 40)), int(rng.integers(2, 10)))
            for i in range(6)]
    prompts = {i: rng.integers(1, cfg.vocab_size, (1, p)).astype(np.int32)
               for i, p, _ in spec}
    first = _moe_serve(gpu, spec, prompts, chunk_tokens=16)
    assert first[1]["chunk_prefills"] > 0 and first[1]["incr_chunks"] == 0
    sizes = gpu.jit_cache_sizes()
    ops.reset_launch_counts()
    assert _moe_serve(gpu, spec, prompts, chunk_tokens=16) == first
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert gpu.jit_cache_sizes() == sizes, "a repeat captured again"
    want = {"segment_flash_attention"} | (
        {"paged_decode_attention"} if paged else {"decode_attention"})
    assert {n for n, k in launches.items() if k} == want, launches
    gpu.graphs = False
    assert _moe_serve(gpu, spec, prompts, chunk_tokens=16) == first
    gpu.graphs = True
    assert _moe_serve(cpu, spec, prompts, chunk_tokens=16) == first


def test_gpu_moe_prefix_cache_and_generate_match_cpu(cuda):
    """Reduced granite-moe at 40 experts top-8 (float32) with the prompt
    cache: the shared-prefix stream cache off and on (hits caught up by
    forced tokens) under CUDA graphs equals the CPU's, streams and
    counters; batch ``generate`` equals the CPU's token for token."""
    cfg = _moe_cfg()
    engines = []
    for dev in (cuda, "cpu"):
        eng = make_engine(cfg, seed=6, cache_len=32, device=dev).init_slots(
            4, page_size=8)
        if engines:
            eng.params = _cpu(engines[0].params)
        eng.enable_prefix_cache()
        eng.warm_prefix_ops()
        engines.append(eng)
    spec, prompts = _shared_prefix_requests(cfg)
    runs = [[_moe_serve(e, spec, prompts, **kw)
             for kw in ({}, {"prefix_cache": True})] for e in engines]
    assert runs[0] == runs[1], "GPU and CPU serves differ"
    st = runs[0][1][1]
    assert st["prefix_hits"] and st["forced_catchup_tokens"]
    assert st["incr_chunks"] == 0
    tokens = np.random.default_rng(7).integers(
        1, cfg.vocab_size, (3, 21)).astype(np.int32)
    gens = [make_engine(cfg, cache_len=32, device=d) for d in (cuda, "cpu")]
    gens[0].params = engines[0].params
    gens[1].params = engines[1].params
    assert torch.equal(gens[0].generate({"tokens": tokens}, 9).cpu(),
                       gens[1].generate({"tokens": tokens}, 9))


# ---------------------------------------------------------------------------
# training: #5's lse and the flash backward (flash_attention_bwd)
# ---------------------------------------------------------------------------
# the backward against its plain version: max |kernel - plain| <= this
# times max(1, max |plain|), per gradient (float32: sums of up to S terms
# in another order; bfloat16: both widen the same inputs and sum in
# float32, each rounds its gradients once)
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_CASES = [
    # (b, s, sk, h, kv, d, causal, window)
    (2, 300, 300, 14, 2, 64, True, 0),        # qwen2-0.5b heads, ragged
    (1, 257, 257, 16, 16, 128, True, 0),      # olmo-1b heads
    (2, 200, 200, 4, 2, 64, True, 50),        # window
    (2, 100, 260, 4, 4, 128, False, 0),       # cross: Sk != S
    (1, 1, 1, 2, 1, 64, True, 0),
    (1, 65, 65, 2, 2, 128, True, 0),
]


def _bwd_inputs(cuda, dtype, b, s, sk, h, kv, d):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = _randn(gen, (b, s, h, d), dtype, cuda)
    k = _randn(gen, (b, sk, kv, d), dtype, cuda)
    v = _randn(gen, (b, sk, kv, d), dtype, cuda)
    dout = _randn(gen, (b, s, h, d), dtype, cuda)
    return q, k, v, dout


def _close(got, want, tol):
    scale = max(1.0, float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,sk,h,kv,d,causal,window", BWD_CASES)
def test_flash_lse_and_backward_match_plain(cuda, dtype, b, s, sk, h, kv, d,
                                            causal, window):
    """#5's lse equals the plain forward's, and ``flash_attention_bwd``
    from #5's output and lse equals ``flash_bwd_plain`` from the same
    inputs, gradient by gradient."""
    from repro_torch.kernels import flash_vjp as FV
    q, k, v, dout = _bwd_inputs(cuda, dtype, b, s, sk, h, kv, d)
    kw = dict(causal=causal, window=window)
    out, lse = FA.flash_attention_cuda(q, k, v, lse=True, **kw)
    _, lse_plain = FV.flash_fwd_plain(q, k, v, **kw)
    assert _close(lse, lse_plain, BWD_TOL[dtype] / 10)
    got = FV.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    want = FV.flash_bwd_plain(q, k, v, out, dout, lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        assert _close(g, w, BWD_TOL[dtype])


def test_flash_backward_is_deterministic(cuda):
    """No float atomics: two float32 runs give the same bits."""
    from repro_torch.kernels import flash_vjp as FV
    q, k, v, dout = _bwd_inputs(cuda, "float32", 2, 300, 300, 14, 2, 64)
    out, lse = FA.flash_attention_cuda(q, k, v, lse=True)
    a = FV.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    b = FV.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_vjp_on_the_card_matches_the_plain_route(cuda, dtype):
    """``flash_attention_vjp`` on CUDA tensors (#5 with its lse, then the
    backward) gives the plain route's output and gradients, launching each
    kernel once."""
    from repro_torch.kernels import flash_vjp as FV
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, 300, 300, 14, 2, 64)
    grads = {}
    for route in ("cuda", "cpu"):
        xs = [x.detach().to(route).requires_grad_(True) for x in (q, k, v)]
        ops.reset_launch_counts()
        out = FV.flash_attention_vjp(*xs, causal=True)
        out.backward(dout.to(route))
        if route == "cuda":
            counts = ops.launch_counts()
            assert counts["flash_attention"] == 1
            assert counts["flash_attention_bwd"] == 1
        grads[route] = [out.detach()] + [x.grad for x in xs]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _close(g.cpu(), w, BWD_TOL[dtype])


def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """A kernel's output would carry no gradient: every wrapper raises
    under grad mode when an operand requires grad, and runs under
    ``torch.no_grad()``."""
    q, k, v, _ = _bwd_inputs(cuda, "float32", 1, 64, 64, 2, 2, 64)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="gradient"):
        FA.flash_attention_cuda(q, k, v)
    with torch.no_grad():
        FA.flash_attention_cuda(q, k, v)
    lengths = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="gradient"):
        DA.decode_attention_cuda(q[:, 0], k, v, lengths)


def test_flash_backward_without_queries_gives_zero_key_grads(cuda):
    """Non-causal, no query over 64 keys: dk and dv are zeros."""
    from repro_torch.kernels import flash_vjp as FV
    q, k, v, dout = _bwd_inputs(cuda, "float32", 2, 0, 64, 4, 2, 64)
    lse = torch.empty((2, 4, 0), dtype=torch.float32, device=cuda)
    dq, dk, dv = FV.flash_attention_bwd_cuda(q, k, v, torch.zeros_like(q),
                                             dout, lse, causal=False)
    assert dq.shape == q.shape
    assert not dk.any() and not dv.any()


def test_flash_backward_refuses_head_dim_112(cuda):
    from repro_torch.kernels import flash_vjp as FV
    q, k, v, dout = _bwd_inputs(cuda, "float32", 1, 64, 64, 2, 2, 112)
    out, lse = FA.flash_attention_cuda(q, k, v, lse=True)
    with pytest.raises(ValueError, match="head_dim 112"):
        FV.flash_attention_bwd_cuda(q, k, v, out, dout, lse)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "granite-moe"])
def test_gpu_training_loss_and_grads_match_cpu(cuda, name):
    """One ``lm_loss`` and its gradients on the card (the kernels, remat
    on) and on the CPU (the plain versions), float32, reduced config at
    S 1100 (past 1024: the CPU takes the plain flash VJP): the loss within
    1e-5 relative, every gradient leaf within 1e-4 of its max |value|."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.registry import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg = get_config(name).reduced()
    out = {}
    weights = build_model(cfg, cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    for dev in ("cuda", "cpu"):
        api = build_model(cfg, dev)
        params = _tree(weights,
                       lambda t: t.detach().to(dev).requires_grad_(True))
        batch = next(iter(TokenPipeline(cfg, DataConfig(2, 1100), dev)))
        metrics, grads = loss_and_grads(api, params, batch, remat=True)
        out[dev] = (metrics, grads)
    lg, lc = float(out["cuda"][0]["loss"]), float(out["cpu"][0]["loss"])
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for path, g, w in _pairs(out["cuda"][1], out["cpu"][1]):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(scale, 1e-30), path


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        return [x for k in a for x in _pairs(a[k], b[k], f"{path}/{k}")]
    return [(path, a, b)]
