#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py              # all phases, as the acceptance run
    python3 chip_smoke.py --phases a   # kernels only (a quick first check)

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and runs three phases, each printing one JSON line:

  (a) kernels vs plain: each hand-written kernel against its plain
      PyTorch version on the card, at the serving path's head shapes
      (olmo-1b: 16 heads of 128; qwen2-0.5b: 14 query / 2 KV heads of 64),
      in float32 (TF32 off) and bfloat16, with length-0 rows, fresh
      sequences (history 0), padding segments and ragged packed lengths;
      times the kernel, the plain version and (for the packed prefill)
      one ``scaled_dot_product_attention`` call as a yardstick, beside the
      least time the card could take;
  (b) serve: olmo-1b at full width in bfloat16 with seeded random weights
      answers 16 requests through ``StepPlanner``/``serve_ticks`` on one
      paged engine (admissions, chunk continuations and decodes all
      occur), and every kernel must have launched during it;
  (c) equality: olmo-1b at full width cut to 2 layers, float32 with TF32
      off, serves the same seeded requests once on the GPU (the kernels)
      and once on the CPU (the plain versions); the greedy streams must be
      identical.

Then it prints the ``kernels`` summary line, the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; so does a machine without a CUDA device, or a
directory without the port's sources. Detailed results go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s per input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

HEADS = {"olmo-1b": (16, 16, 128), "qwen2-0.5b": (14, 2, 64)}
TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2e-2)}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, torch, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase (a): kernels against their plain versions
# --------------------------------------------------------------------------
def _decode_case(torch, gen, dev, dtype, h, kv, d, ps=16, max_pages=64):
    lengths = [0, 1, 17, 100, 500, 1000, 1024, 900]
    b = len(lengths)
    n_pages = b * max_pages + 1
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    # entries past a row's live pages point far outside the pool: the
    # kernel must never read them (the plain version gathers every entry,
    # so it gets them parked on the null page)
    live = torch.tensor([-(-n // ps) for n in lengths], device=dev)
    past = torch.arange(max_pages, device=dev)[None, :] >= live[:, None]
    poisoned = tables.masked_fill(past, 1 << 30).contiguous()
    sane = tables.masked_fill(past, 0).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    elt = q.element_size()
    live_tok = sum(lengths)
    nbytes = (2 * q.numel() * elt + 2 * live_tok * kv * d * elt
              + int(live.sum()) * 4 + b * 4)
    flops = 4.0 * live_tok * h * d
    return dict(args_kernel=(q, kp, vp, poisoned, lens),
                args_plain=(q, kp, vp, sane, lens),
                real=lambda out: out, zero_rows=[0], nbytes=nbytes,
                flops=flops, library=None)


def _segments(t, lens):
    seg = np.full((t,), len(lens), np.int32)
    starts = np.zeros((len(lens),), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        starts[i] = off
        off += n
    return seg, starts, off


def _flash_case(torch, gen, dev, dtype, h, kv, d, t=3072,
                lens=(900, 700, 512, 300, 64, 200, 17, 100), window=0):
    from repro_torch.models.layers import packed_positions
    seg_np, starts_np, n_real = _segments(t, lens)
    seg = torch.from_numpy(seg_np).to(dev)
    starts = torch.from_numpy(starts_np).to(dev)
    slens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = packed_positions(seg, starts)
    q = torch.randn(1, t, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(1, t, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(1, t, kv, d, generator=gen, device=dev).to(dtype)
    row_len = 1 << max(0, max(lens) - 1).bit_length()
    seg_all = np.full((t,), len(lens), np.int64)
    seg_all[:n_real] = seg_np[:n_real]
    # visible pairs, counted from the segment layout (padding tokens
    # attend each other too, and the kernel computes them)
    runs = list(lens) + ([t - n_real] if t > n_real else [])
    if window:
        pairs = sum(sum(min(i + 1, window) for i in range(n)) for n in runs)
    else:
        pairs = sum(n * (n + 1) // 2 for n in runs)
    elt = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt + t * 4
    flops = 4.0 * pairs * h * d

    def library():
        import torch.nn.functional as F
        ids = torch.from_numpy(seg_all).to(dev)
        i = torch.arange(t, device=dev)
        mask = (ids[:, None] == ids[None, :]) & (i[None, :] <= i[:, None])
        if window:
            mask &= (i[:, None] - i[None, :]) < window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = {"enable_gqa": True} if kv != h else {}
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[None, None], **kw)

    return dict(args_kernel=(q, k, v, seg), kernel_kw={"window": window},
                args_plain=(q, k, v, seg, pos, starts, slens),
                plain_kw={"row_len": row_len, "window": window},
                real=lambda out: out[:, :n_real], zero_rows=[],
                nbytes=nbytes, flops=flops, library=library)


def _chunk_case(torch, gen, dev, dtype, h, kv, d, ps=16, max_pages=64,
                r=512, hist=(0, 512, 388, 0), slen=(512, 300, 129, 0)):
    s = len(hist)
    n_pages = s * max_pages + 1
    q = torch.randn(s, r, h, d, generator=gen, device=dev).to(dtype)
    kc = torch.randn(s, r, kv, d, generator=gen, device=dev).to(dtype)
    vc = torch.randn(s, r, kv, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pages, ps, kv, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:s * max_pages].reshape(s, max_pages).to(torch.int32)
    live = torch.tensor([-(-n // ps) for n in hist], device=dev)
    past = torch.arange(max_pages, device=dev)[None, :] >= live[:, None]
    poisoned = tables.masked_fill(past, 1 << 30).contiguous()
    sane = tables.masked_fill(past, 0).contiguous()
    hl = torch.tensor(hist, dtype=torch.int32, device=dev)
    sl = torch.tensor(slen, dtype=torch.int32, device=dev)
    elt = q.element_size()
    rows = sum(slen)
    nbytes = ((2 * rows * h + 2 * rows * kv) * d * elt
              + 2 * sum(n for n, m in zip(hist, slen) if m) * kv * d * elt
              + int(live.sum()) * 4 + 2 * s * 4)
    pairs = sum(m * n + m * (m + 1) // 2 for n, m in zip(hist, slen))
    flops = 4.0 * pairs * h * d

    def real(out):
        return torch.cat([out[i, :m] for i, m in enumerate(slen)])

    pad_rows = [(i, m) for i, m in enumerate(slen) if m < r]
    return dict(args_kernel=(q, kp, vp, kc, vc, poisoned, hl, sl),
                args_plain=(q, kp, vp, kc, vc, sane, hl, sl), real=real,
                pad_rows=pad_rows, nbytes=nbytes, flops=flops, library=None)


def phase_a(torch, timing_model: str = "olmo-1b"):
    from repro_torch.kernels import chunk_attention, flash_attention
    from repro_torch.kernels import paged_attention
    dev = torch.device("cuda")
    kernels = {
        "paged_decode_attention": (
            paged_attention.paged_decode_attention_cuda,
            paged_attention.paged_decode_attention_plain, _decode_case,
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:44"),
        "segment_flash_attention": (
            flash_attention.segment_flash_attention_cuda,
            flash_attention.segment_flash_attention_plain, _flash_case,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:89"),
        "paged_chunk_attention": (
            chunk_attention.paged_chunk_attention_cuda,
            chunk_attention.paged_chunk_attention_plain, _chunk_case,
            "src/repro_torch/kernels/csrc/chunk_attention.cu",
            "src/repro/kernels/chunk_attention.py:38"),
    }
    extra = {  # further shapes checked for correctness only
        "segment_flash_attention": [
            dict(t=48, lens=(20, 13, 9)),                  # ragged T
            dict(t=96, lens=(40, 17, 30), window=16),      # window
            dict(t=1536, lens=(1000, 5, 300))],            # 3·2^9 bucket
        "paged_chunk_attention": [
            dict(r=8, hist=(13, 0), slen=(8, 3), ps=8, max_pages=4)],
        "paged_decode_attention": [dict(ps=8, max_pages=128)],
    }
    rows, summary = [], {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (cuda_fn, plain_fn, make, source, replaces) in kernels.items():
        for model, (h, kv, d) in HEADS.items():
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                shapes = [{}] + extra[name]
                for si, kw in enumerate(shapes):
                    case = make(torch, gen, dev, dtype, h, kv, d, **kw)
                    kout = cuda_fn(*case["args_kernel"],
                                   **case.get("kernel_kw", {}))
                    pout = plain_fn(*case["args_plain"],
                                    **case.get("plain_kw", {}))
                    torch.cuda.synchronize()
                    got = case["real"](kout).float()
                    want = case["real"](pout).float()
                    assert torch.isfinite(got).all(), (name, model, dname)
                    err = float((got - want).abs().max())
                    atol, rtol = TOL[dname]
                    ok = bool(torch.allclose(got, want, atol=atol,
                                             rtol=rtol))
                    for rix in case.get("zero_rows", []):
                        ok &= bool((kout[rix] == 0).all())
                    for i, m in case.get("pad_rows", []):
                        ok &= bool((kout[i, m:] == 0).all())
                    row = {"kernel": name, "model": model, "dtype": dname,
                           "shape": kw or "main", "max_abs_err": err,
                           "ok": ok}
                    if si == 0:
                        run_k = lambda: cuda_fn(*case["args_kernel"],  # noqa
                                                **case.get("kernel_kw", {}))
                        run_p = lambda: plain_fn(*case["args_plain"],  # noqa
                                                 **case.get("plain_kw", {}))
                        row["ms"] = _time_ms(run_k, torch)
                        row["plain_ms"] = _time_ms(run_p, torch, iters=5)
                        row["bound_ms"], row["bound_by"] = _bound_ms(
                            case["nbytes"], case["flops"], dname)
                        lib = case["library"]
                        row["library_ms"] = (_time_ms(lib(), torch)
                                             if lib is not None else None)
                        if model == timing_model and dname == "bfloat16":
                            summary[name] = {
                                "name": name, "route": "cuda",
                                "source": source, "replaces": replaces,
                                "max_abs_err": err, "ms": row["ms"],
                                "plain_ms": row["plain_ms"],
                                "bound_ms": row["bound_ms"],
                                "bound_by": row["bound_by"],
                                "library_ms": row["library_ms"]}
                    rows.append(row)
                    _log(json.dumps(row))
                    del case, kout, pout
    bad = [r for r in rows if not r["ok"]]
    _emit({"phase": "a", "cases": len(rows), "failed": len(bad),
           "max_abs_err": {f"{r['kernel']}/{r['model']}/{r['dtype']}":
                           r["max_abs_err"] for r in rows
                           if r["shape"] == "main"}})
    assert not bad, f"kernel disagrees with its plain version: {bad}"
    return rows, summary


# --------------------------------------------------------------------------
# phases (b) and (c): the serving path
# --------------------------------------------------------------------------
def _requests(n, prompt_range, budget_range, vocab, seed):
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    reqs, prompts = [], {}
    for i in range(n):
        p = int(rng.integers(*prompt_range))
        nt = int(rng.integers(*budget_range))
        reqs.append(Request(arrival=0.0, rid=i, model="olmo-1b", slo=1e9,
                            n_tokens=nt, prompt_len=p))
        prompts[i] = rng.integers(1, vocab, size=(1, p)).astype(np.int32)
    return reqs, prompts


def _serve(eng, reqs, prompts, chunk_tokens):
    import copy
    from repro_torch.serving.plan import (PlannerConfig, StepPlanner,
                                          serve_ticks)
    from repro_torch.serving.request import RequestQueue
    eng.release_all_slots()
    eng.reset_stats()
    planner = StepPlanner(eng, RequestQueue("olmo-1b", slo=1e9),
                          PlannerConfig(chunk_tokens=chunk_tokens))
    srv = serve_ticks(planner, copy.deepcopy(reqs),
                      lambda r: {"tokens": prompts[r.rid]})
    assert not srv.truncated
    return {r: list(t) for r, t in planner.streams.items()}, srv


def _launch_counts():
    from repro_torch.kernels import chunk_attention, flash_attention
    from repro_torch.kernels import paged_attention
    return {"paged_decode_attention": paged_attention.launches,
            "segment_flash_attention": flash_attention.launches,
            "paged_chunk_attention": chunk_attention.launches}


def _reset_launch_counts():
    from repro_torch.kernels import chunk_attention, flash_attention
    from repro_torch.kernels import paged_attention
    paged_attention.launches = 0
    flash_attention.launches = 0
    chunk_attention.launches = 0


def phase_b(torch):
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_engine
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    eng = make_engine(cfg, seed=0, cache_len=1024, dtype=torch.bfloat16,
                      device="cuda").init_slots(8, page_size=16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up serve (cuBLAS handles, allocator pools), not measured
    wreqs, wprompts = _requests(3, (40, 200), (4, 8), cfg.vocab_size, 99)
    _serve(eng, wreqs, wprompts, chunk_tokens=128)
    reqs, prompts = _requests(16, (64, 901), (16, 65), cfg.vocab_size, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    streams, srv = _serve(eng, reqs, prompts, chunk_tokens=512)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    n_tok = sum(len(s) for s in streams.values())
    for r in reqs:
        s = streams[r.rid]
        assert len(s) == r.n_tokens, (r.rid, len(s), r.n_tokens)
        assert all(0 <= t < cfg.vocab_size for t in s), r.rid
    st = eng.stats
    assert st.incr_chunks > 0 and st.packed_prefills > st.incr_chunks
    assert all(n > 0 for n in launches.values()), launches
    walls = sorted(w for w, _ in srv.tick_walls)
    profile = _profile_serve(torch, eng, reqs, prompts, streams)
    out = {"phase": "b", "model": cfg.name, "dtype": "bfloat16",
           "layers": cfg.num_layers, "params": cfg.param_count(),
           "requests": len(reqs), "prompt_tokens": sum(
               r.prompt_len for r in reqs),
           "tokens_served": n_tok, "ticks": srv.ticks,
           "dispatches": srv.dispatches, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "tick_ms_p50": 1e3 * walls[len(walls) // 2],
           "tick_ms_p99": 1e3 * walls[min(len(walls) - 1,
                                          int(0.99 * len(walls)))],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "kv_cache_bytes": eng.kv_cache_bytes(), "setup_s": setup_s,
           "stats": dataclasses.asdict(st), "launches": launches,
           "profile": profile}
    _emit(out)
    del eng
    torch.cuda.empty_cache()
    return out


def _profile_serve(torch, eng, reqs, prompts, streams, top: int = 8):
    """Serve the same requests again under ``torch.profiler`` and return
    the device time by kernel (the largest ``top``), the total, and the
    device's busy share of the wall time. The streams must repeat."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again, srv = _serve(eng, reqs, prompts, chunk_tokens=512)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert again == streams, "a repeated serve changed the streams"
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((getattr(e, "device_time_total", 0.0) / 1e3,
                        e.count, e.key[:90]))
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    return {"wall_ms": 1e3 * wall, "device_ms": device_ms,
            "device_busy_share": device_ms / (1e3 * wall),
            "ticks": srv.ticks,
            "top": [{"kernel": k, "ms": ms, "count": n}
                    for ms, n, k in kernels[:top]]}


def phase_c(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import (InferenceEngine, _packed_bucket,
                                            make_engine)
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2,
                              dtype="float32")
    gpu = make_engine(cfg, seed=1, cache_len=512,
                      device="cuda").init_slots(4, page_size=16)
    cpu_params = _to_cpu(gpu.params)
    cpu = InferenceEngine(build_model(cfg, device="cpu"), cpu_params,
                          cache_len=512).init_slots(4, page_size=16)
    reqs, prompts = _requests(6, (20, 301), (8, 33), cfg.vocab_size, 1)
    _reset_launch_counts()
    gs, gsrv = _serve(gpu, reqs, prompts, chunk_tokens=128)
    launches = _launch_counts()
    t0 = time.perf_counter()
    cs, _ = _serve(cpu, reqs, prompts, chunk_tokens=128)
    cpu_s = time.perf_counter() - t0
    assert gpu.stats.incr_chunks > 0, "no continuation ran"
    assert all(n > 0 for n in launches.values()), launches
    # first-token logits: one packed prefill of every prompt, both sides
    lens = [r.prompt_len for r in reqs]
    packed = gpu._pack_prompts([{"tokens": prompts[r.rid]} for r in reqs],
                               lens)
    row_len = 1 << max(0, max(lens) - 1).bit_length()
    logits = {}
    for name, eng in (("cuda", gpu), ("cpu", cpu)):
        dev = {k: torch.from_numpy(v).to(eng.device)
               for k, v in packed.items()}
        lg, _ = eng.api.prefill_packed(eng.params, dev, row_len)
        logits[name] = lg[:len(reqs)].float().cpu()
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    same = gs == cs
    out = {"phase": "c", "model": "olmo-1b (2 layers)", "dtype": "float32",
           "requests": len(reqs), "tokens": sum(len(s) for s in gs.values()),
           "ticks": gsrv.ticks, "streams_identical": same,
           "first_token_logits_max_abs_diff": diff,
           "packed_tokens": _packed_bucket(sum(lens)), "cpu_serve_s": cpu_s,
           "launches": launches}
    _emit(out)
    assert same, f"GPU and CPU greedy streams differ: {gs} vs {cs}"
    return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="abc",
                    help="which phases to run (default: abc)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        _log("chip_smoke: no CUDA device")
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        _log(f"chip_smoke: the port's sources are not under {src}")
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    logs = build.build_logs()
    (OUT_DIR / "ptxas.log").write_text(
        "\n".join(f"== {n}\n{t}" for n, t in logs.items()))
    for n, t in logs.items():
        for line in t.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"{n}: {line.strip()}")
    _log(f"kernels built in {build_s:.1f} s")
    report = {"build_s": build_s}
    summary = {}
    if "a" in args.phases:
        report["a"], summary = phase_a(torch)
    if "b" in args.phases:
        report["b"] = phase_b(torch)
        for name, n in report["b"]["launches"].items():
            if name in summary:
                summary[name]["launches"] = n
    if "c" in args.phases:
        report["c"] = phase_c(torch)
    if summary:
        _emit({"kernels": list(summary.values())})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    report["card"] = card
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
