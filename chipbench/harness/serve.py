"""One run of a cell: the program serves the cell's traffic in wall time,
and its clients stamp every token.

The path is the program's own: ``serving.gateway.AsyncGateway`` on the
wall clock over ``serving.plan.StepPlanner`` / ``TickServer`` over
``InferenceEngine.execute``, its CUDA graphs and kernels. Set-up builds the
weights from the seed on the device, the engine and its slots, warms every
step shape the traffic can reach (``warm.py``) and runs the prelude (the
first requests admitted, the queue at its level). Then the window: every
token that reaches a client is stamped with ``perf_counter``. Requests due
in the window that have no token when it closes are waited for, at most
``GRACE_S``, while the traffic goes on.

The harness observes the engine through one wrapper around ``execute``:
it reads each admission's first token (the token a prefill ends with,
which the decode consumes and the stream never shows), and in a traced run
what each tick's plan asked for. In a traced run the program's telemetry
(spans ``plan``, ``execute``) is attached for the window and the profiler
records the device.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import itertools
import time
from typing import Any, Dict, List, Optional

from harness import stats, traffic, warm, weights
from harness.stats import Record
from harness.work import Tick

GRACE_S = 60.0


def log(*a) -> None:
    import sys
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    cell: Any
    seed: int
    seconds: float
    setup_s: float
    w0: float
    w1: float
    records: List[Record]
    seeds: Dict[int, int]                  # rid -> the prefill's token
    weights: Any
    device_kind: str
    memory_peak_bytes: int
    warmed: Dict[str, int]
    captures_in_window: int
    ticks: List[Tick] = dataclasses.field(default_factory=list)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    lags: List[float] = dataclasses.field(default_factory=list)
    device: Optional[Any] = None           # devtrace.DeviceSummary

    @property
    def in_window(self) -> List[Record]:
        return stats.due_in(self.records, self.w0, self.w1)


def port_config(cfg: Dict[str, Any]):
    """The program's ``ModelConfig`` of a configuration file: its named
    configuration with every field the file sets."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_config"])
    fields = {f.name for f in dataclasses.fields(base)}
    over = {k: v for k, v in cfg.items() if k in fields and k not in
            ("name", "source", "family", "head_dim")
            and getattr(base, k) != v}
    out = dataclasses.replace(base, **over) if over else base
    if "head_dim" in cfg and out.resolved_head_dim != cfg["head_dim"]:
        out = dataclasses.replace(out, head_dim=cfg["head_dim"])
    if out.padded_vocab != cfg["padded_vocab"]:
        raise ValueError(f"{cfg['name']}: the program pads the vocabulary "
                         f"to {out.padded_vocab}, the file says "
                         f"{cfg['padded_vocab']}")
    return out


def check_layout(layout, plan) -> None:
    """The reference's parameter layout is the program's plan."""
    got, want = weights.shapes(layout), weights.shapes(plan)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise ValueError(f"reference layout differs from the program's "
                         f"plan: {diff}")


class _Observer:
    """Wraps ``engine.execute``: records each admission's first token and,
    when ``detail``, what each tick's plan asked for."""

    def __init__(self, eng, detail: bool):
        self.eng = eng
        self.detail = detail
        self.seeds: Dict[int, int] = {}
        self.ticks: List[Tick] = []
        self._execute = eng.execute
        self.label = None
        eng.execute = self

    def __call__(self, plan):
        eng = self.eng
        t0 = time.perf_counter()
        if self.detail:
            dense = bool(eng.api.paged_keys)
            ctx = [eng.slot_pos(s) + 1 if dense else 0 for s in plan.decodes]
            first = [c.length for c in plan.admissions
                     if c.slot is None and c.alias is None]
            cont = [(c.start, c.length) for c in plan.admissions
                    if c.slot is not None]
        if self.label is not None:
            with self.label("chipbench.execute"):
                res = self._execute(plan)
        else:
            res = self._execute(plan)
        for c in plan.admissions:
            if c.final:
                slot = res.admitted.get(c.rid) if c.slot is None else c.slot
                if slot is not None:
                    self.seeds[c.rid] = eng.host_last_token(slot)
        if self.detail:
            self.ticks.append(Tick(t0, time.perf_counter(), ctx, first, cont))
        return res


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> Run:
    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.gateway import AsyncGateway, GatewayRejection
    from repro_torch.serving.plan import PlannerConfig, StepPlanner
    from repro_torch.serving.request import Request, RequestQueue

    cfg, sv = cell.config, cell.serve
    dtype = getattr(torch, cfg["dtype"])
    pcfg = port_config(cfg)
    api = build_model(pcfg, device)
    ref = cell.reference()
    layout = ref.layout(cfg)
    check_layout(layout, api.plan)
    t0 = time.perf_counter()
    w = weights.make(layout, seed, device, dtype)
    eng = InferenceEngine(api, w, cache_len=sv["cache_len"]).init_slots(
        sv["slots"], page_size=sv["page_size"])
    t1 = time.perf_counter()
    warmed = warm.warm(eng, sv["warm"])
    log(f"set-up: imports {t0 - t_start:.2f} s, weights and slots "
        f"{t1 - t0:.2f} s, warm {warmed} {time.perf_counter() - t1:.2f} s")
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()

    tr = traffic.Traffic(cell.mix, seed, cfg["vocab_size"])
    planner = StepPlanner(eng, RequestQueue(pcfg.name, slo=1e9),
                          PlannerConfig(chunk_tokens=sv["chunk_tokens"]))
    gw = AsyncGateway(planner, wall_clock=True, max_ticks=10 ** 9)
    obs = _Observer(eng, detail=trace)
    records: List[Record] = []
    lags: List[float] = []
    tel = dev = None
    if trace:
        from torch.autograd.profiler import record_function
        from harness.devtrace import DeviceTrace
        from repro_torch.serving.telemetry import Telemetry, TraceRecorder
        tel = Telemetry(trace=TraceRecorder(capacity=4_000_000))
        obs.label = record_function
        build = planner.build

        def labelled_build(now):
            with record_function("chipbench.plan"):
                return build(now)

        planner.build = labelled_build
        if cuda:
            dev = DeviceTrace()
            dev.start()
    rids = itertools.count()
    window = {}
    prelude = float(sv["prelude_s"])
    reports_ttft = any(m.name == "ttft_p95_ms" for m in cell.end_to_end)

    async def consume(st, rec):
        rec.tokens = st.tokens
        async for _ in st:
            rec.stamps.append(time.perf_counter())
        rec.state = st.state

    wave = int(sv.get("start_wave", 0))

    async def client(i):
        # the first requests go out ``start_wave`` clients a tick
        while wave and gw.server.ticks < i // wave:
            await asyncio.sleep(0)
        for d in tr.client(i):
            rid = next(rids)
            now = time.perf_counter()
            rec = Record(rid, now, d.prompt, d.n_tokens)
            records.append(rec)
            req = Request(arrival=now - (gw._t0 or now), rid=rid,
                          model=pcfg.name, slo=1e9, n_tokens=d.n_tokens,
                          prompt_len=len(d.prompt))
            try:
                st = gw.submit(req, {"tokens": d.prompt[None]})
            except GatewayRejection:
                rec.refused = True
                await asyncio.sleep(0)
                continue
            await consume(st, rec)

    def waiting() -> bool:
        return any(not r.stamps and r.state is None and not r.refused
                   for r in stats.due_in(records, window["w0"],
                                         window["w1"]))

    async def drive():
        tasks = []
        if tr.loop == "open":
            draws = tr.arrivals(prelude + seconds + GRACE_S)
            reqs, prompts = [], {}
            for d in draws:
                rid = next(rids)
                records.append(Record(rid, d.due, d.prompt, d.n_tokens))
                reqs.append(Request(arrival=d.due, rid=rid, model=pcfg.name,
                                    slo=1e9, n_tokens=d.n_tokens,
                                    prompt_len=len(d.prompt)))
                prompts[rid] = {"tokens": d.prompt[None]}
            if trace:
                submit = planner.submit

                def stamped(req, batch):
                    lags.append((req.rid, time.perf_counter()))
                    return submit(req, batch)

                planner.submit = stamped
            gw.schedule(reqs, prompts)
            for rec in records:
                tasks.append(asyncio.ensure_future(
                    consume(gw.streams[rec.rid], rec)))
        # the prelude's first admissions run eagerly where the cell says
        # (their one-off shapes are never captured); the window's shapes
        # are all warm
        eng.graphs = not sv.get("prelude_eager", False)
        runner = asyncio.ensure_future(gw.run(hold_open=tr.loop == "closed"))
        await asyncio.sleep(0)
        t0 = gw._t0
        if tr.loop == "open":
            for rec in records:                # due times on the clock
                rec.due += t0
        else:
            tasks += [asyncio.ensure_future(client(i))
                      for i in range(tr.clients)]
            while (len([r for r in records if r.stamps]) < tr.clients
                   and time.perf_counter() < t0 + prelude
                   and not runner.done()):
                await asyncio.sleep(0.01)
        eng.graphs = True
        await asyncio.sleep(max(0.0, t0 + prelude - time.perf_counter()))
        if runner.done():
            runner.result()                # the serve died: raise its error
        if trace:
            planner.telemetry = tel
            eng.attach_telemetry(tel)
            tel.trace.clear()
            if dev is not None:
                dev.window_start()
        window["c0"] = sum(eng.jit_cache_sizes().values())
        window["w0"] = w0 = time.perf_counter()
        window["w1"] = w0 + seconds
        await asyncio.sleep(seconds)
        window["c1"] = sum(eng.jit_cache_sizes().values())
        window["end"] = time.perf_counter()
        if trace:
            if dev is not None:
                dev.window_end()
                dev.stop()
            planner.telemetry = None
            eng.attach_telemetry(None)
        if reports_ttft:
            limit = time.perf_counter() + GRACE_S
            while waiting() and time.perf_counter() < limit:
                await asyncio.sleep(0.05)
        runner.cancel()
        for t in tasks:
            t.cancel()
        for got in await asyncio.gather(runner, *tasks,
                                        return_exceptions=True):
            if isinstance(got, Exception):
                raise got

    asyncio.run(drive())
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(eng.device) if cuda else "cpu"
    w0, w1 = window["w0"], window["w1"]
    run = Run(cell=cell, seed=seed, seconds=seconds, setup_s=w0 - t_start,
              w0=w0, w1=w1, records=records, seeds=dict(obs.seeds),
              weights=w, device_kind=kind, memory_peak_bytes=peak,
              warmed=warmed,
              captures_in_window=window["c1"] - window["c0"])
    if trace:
        end = window["end"]
        run.ticks = [t for t in obs.ticks if w0 <= t.t0 and t.t1 <= end]
        run.spans = _spans(tel.trace, w0, end)
        due = {r.rid: r.due for r in records}
        run.lags = [at - due[rid] for rid, at in lags
                    if w0 <= due[rid] < w1]
        run.device = dev.summary() if dev is not None else None
    # the program's state goes before the reference runs
    del eng, planner, gw, obs, api, tel, dev
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run


def _spans(rec, w0: float, w1: float) -> Dict[str, List[float]]:
    """Seconds of each ``plan`` and ``execute`` span that began in
    [w0, w1] (the recorder was cleared at w0, its clock starting there)."""
    out: Dict[str, List[float]] = {"plan": [], "execute": []}
    for ev in rec.events:
        if ev.get("ph") == "X" and ev["name"] in out:
            start = w0 + ev["ts"] / 1e6
            if start + ev["dur"] / 1e6 <= w1:
                out[ev["name"]].append(ev["dur"] / 1e6)
    return out
