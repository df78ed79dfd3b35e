"""Async streaming gateway over the tick plane — a copy of the JAX
package's ``repro.serving.gateway`` over the port's planner.

The client-facing layer the ROADMAP's serving-plane item calls for:
clients ``submit(request, prompt)`` and get a ``TokenStream`` — an
async iterator yielding decode tokens as the planner emits them —
while one asyncio drive loop steps a ``TickServer`` underneath. The
loop is a line-for-line async mirror of ``core.eventloop
.run_event_loop`` (same epsilon, same deliver-then-fire-then-plan
order, same drain exit), which is what makes gateway-served streams
BIT-EXACT against driving ``serve_ticks`` directly on the same trace:
the planner sees identical (arrival, tick) interleavings, so it builds
identical plans. Between ticks the loop yields to the event loop once
(``asyncio.sleep(0)``), so client consumers interleave with serving
without perturbing it.

Lifecycle edges map onto the planner's fault machinery — nothing new
below the gateway:

* client disconnect (``TokenStream.cancel`` / ``gateway.cancel``) →
  ``StepPlanner.cancel`` → a ``Cancel`` plan event frees the slot's
  pages (mid-chunked-prefill and mid-spec-round included);
* load shedding → ``planner.submit`` refuses → the gateway raises a
  typed ``ShedRejection`` (live) or closes the stream terminally
  (trace replay) — a shed request never held a page;
* a deadline already blown AT submit → typed ``DeadlineRejection``
  with the same dropped/violated accounting ``pop_batch`` would have
  charged; a deadline blown IN queue keeps the queue-side drop path.

Two clocks: virtual (default — time jumps event-to-event exactly like
``serve_ticks``) and **wall** (``wall_clock=True`` — the loop sleeps
until ``perf_counter`` reaches each event time and stamps ticks with
real elapsed seconds, so the planner's TTFT/TBT/deadline arithmetic
runs against the host clock and the telemetry plane's ``StepTimers``
and roofline report validate measured-vs-modeled per step).

Every edge lands as a telemetry instant on the model's queue track
when a ``Telemetry`` plane is attached, and costs one ``is None``
check when not — the zero-cost-when-detached contract. With a trace
attached, each turn of the drive loop also leaves port-only ``host``
spans on the tick server's track, beside its ``tick``: ``wait`` (the
wall-clock sleep until the next event, or a live gateway's idle wait),
``deliver`` (the turn's arrivals, ``arrivals=n``), ``pump`` (``_pump``)
and ``yield`` (the cooperative yield in which client consumers run).
"""
from __future__ import annotations

import asyncio
import math
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.serving.plan import StepPlanner, TickServer
from repro_torch.serving.request import Request

_EPS = 1e-12
_DONE = object()


class GatewayRejection(Exception):
    """Base for typed submit-time rejections: the request is terminal
    (``req.state`` says why) and never held a slot, page, or queue
    entry past this call."""

    def __init__(self, req: Request, reason: str):
        super().__init__(f"request {req.rid} {reason} "
                         f"(tenant={req.tenant!r}, tier={req.tier!r})")
        self.req = req
        self.reason = reason


class ShedRejection(GatewayRejection):
    """Refused at admission by the planner's load-shed watermarks."""

    def __init__(self, req: Request):
        super().__init__(req, "shed at admission (overload)")


class DeadlineRejection(GatewayRejection):
    """Deadline already passed when the client submitted."""

    def __init__(self, req: Request):
        super().__init__(req, "submitted past its deadline")


class TokenStream:
    """One request's per-token stream.

    ``async for tok in stream`` yields each decode token once, in
    order, and ends when the request reaches a terminal state
    (``stream.state``: completed / cancelled / deadline_aborted /
    shed). ``stream.tokens`` accumulates everything delivered —
    after the run it equals ``planner.streams[rid]`` for completed
    requests, which is the bit-exactness surface the tests compare.

    Requeue-for-recompute (preemption, failed grow, engine reset)
    clears the planner's stream and replays it bit-exactly; the
    gateway's high-water mark (``_sent``) suppresses the replayed
    prefix, so a client sees every token exactly once even when the
    request recomputed mid-stream."""

    def __init__(self, gateway: "AsyncGateway", req: Request):
        self.req = req
        self.rid = req.rid
        self.tokens: List[int] = []
        self.state: Optional[str] = None      # terminal cause once closed
        self._gw = gateway
        self._sent = 0
        self._q: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def cancel(self) -> bool:
        """Client disconnect: cancel the request wherever it lives
        (queued / resident / staged). The stream still closes through
        the normal pump — with state ``cancelled``."""
        return self._gw.cancel(self.rid)

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self._closed and self._q.empty():
            raise StopAsyncIteration
        item = await self._q.get()
        if item is _DONE:
            raise StopAsyncIteration
        return item

    async def collect(self) -> List[int]:
        """Drain the stream to its terminal state; returns tokens."""
        async for _ in self:
            pass
        return self.tokens

    # ------------------------------------------------ gateway internals
    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        self._q.put_nowait(tok)

    def _finish(self, state: str) -> None:
        if self._closed:
            return
        self.state = state
        self._closed = True
        self._q.put_nowait(_DONE)


class AsyncGateway:
    """Asyncio serving frontend over one ``(planner, TickServer)``.

    Trace mode — ``schedule(requests)`` then ``await run()`` (or the
    sync ``serve_trace``): a seeded arrival trace replays exactly like
    ``serve_ticks``. Live mode — ``run(hold_open=True)`` keeps the
    loop alive while clients ``submit`` concurrently; ``close()`` lets
    it drain and exit. Both share one drive loop; ``faults``,
    ``on_tick`` and ``stall_limit`` pass through to the underlying
    ``TickServer``, so the chaos harness runs unchanged THROUGH the
    gateway."""

    def __init__(self, planner: StepPlanner, prompt_fn=None, *,
                 tick_dt: float = 1e-3, wall_clock: bool = False,
                 faults=None, on_tick=None,
                 stall_limit: Optional[int] = None,
                 max_ticks: int = 100_000):
        self.planner = planner
        self.wall_clock = wall_clock
        self.max_ticks = max_ticks
        self._batches: Dict[int, Any] = {}
        self.server = TickServer(
            planner, prompt_fn if prompt_fn is not None else self._batch_of,
            tick_dt=tick_dt, faults=faults, on_tick=on_tick,
            stall_limit=stall_limit)
        self.streams: Dict[int, TokenStream] = {}
        self._live: Dict[int, TokenStream] = {}
        self._pending: List[Request] = []     # scheduled trace arrivals
        self._wake = asyncio.Event()
        self._running = False
        self._closed = False
        self.now = 0.0
        self.events = 0
        self.truncated = False
        self._t0: Optional[float] = None      # wall-clock epoch

    # --------------------------------------------------------- plumbing
    def _batch_of(self, req: Request):
        return self._batches[req.rid]

    def _tel(self, name: str, req: Request, **args) -> None:
        tel = self.planner.telemetry
        if tel is not None:
            tel.request_event(req.model, name, rid=req.rid, **args)

    def _elapsed(self) -> float:
        return time.perf_counter() - (self._t0 or 0.0)

    def _host_span(self, rec, name: str, start: float, **args) -> float:
        """Push a ``host`` span from ``start`` to now; returns now."""
        end = rec.now()
        rec.complete(self.server._track, name, start, end - start,
                     cat="host", **args)
        return end

    # ----------------------------------------------------- client surface
    def schedule(self, requests: Sequence[Request], prompts=None) -> None:
        """Pre-schedule a trace: arrivals deliver at their stamped
        times, exactly like ``serve_ticks``. ``prompts`` (rid -> prompt
        dict) feeds the default prompt_fn; with a custom prompt_fn it
        may be omitted. Streams exist immediately (``streams[rid]``) so
        consumers can start iterating before arrival."""
        for r in requests:
            if prompts is not None:
                self._batches[r.rid] = prompts[r.rid]
            st = TokenStream(self, r)
            self.streams[r.rid] = st
            self._live[r.rid] = st
        self._pending.extend(requests)
        self._pending.sort(key=lambda r: r.arrival)
        self._wake.set()

    def submit(self, req: Request, batch) -> TokenStream:
        """Live submission at the gateway's current clock. Returns the
        request's ``TokenStream``, or raises a typed rejection:
        ``DeadlineRejection`` when the deadline already passed (counted
        dropped+violated, the same accounting a queue-side expiry
        gets), ``ShedRejection`` when the planner's load-shed
        watermarks refuse it. Either way the request holds nothing."""
        now = self._elapsed() if (self.wall_clock and self._running) \
            else self.now
        self._tel("gw_submit", req, tenant=req.tenant, tier=req.tier)
        # req.arrival is the CLIENT's send stamp (the deadline anchor:
        # deadline = arrival + slo); the gateway never rewrites it —
        # failing fast here is the same judgement pop_batch would make
        # at the queue, just before the request holds anything
        if req.deadline < now:
            req.state = "deadline_aborted"
            q = self.planner.queue
            if q is not None:
                q.dropped += 1
                q.violated += 1
            self._tel("gw_reject_deadline", req)
            raise DeadlineRejection(req)
        self._batches[req.rid] = batch
        self._tel("arrival", req)
        if not self.planner.submit(req, batch):
            self._batches.pop(req.rid, None)
            raise ShedRejection(req)
        st = TokenStream(self, req)
        self.streams[req.rid] = st
        self._live[req.rid] = st
        self._wake.set()
        return st

    def cancel(self, rid: int) -> bool:
        """Client disconnect for ``rid`` — queued requests leave the
        queue immediately; resident/staged ones become a ``Cancel``
        plan event next tick (pages free before anything admits)."""
        st = self._live.get(rid)
        if st is not None:
            self._tel("gw_disconnect", st.req)
        ok = self.planner.cancel(rid)
        self._wake.set()
        return ok

    def close(self) -> None:
        """Stop accepting live submissions; ``run(hold_open=True)``
        exits once everything in flight drains."""
        self._closed = True
        self._wake.set()

    # --------------------------------------------------------- drive loop
    def _pump(self) -> None:
        """Move newly-emitted tokens from ``planner.streams`` into the
        client streams and close the terminal ones. The ``_sent``
        high-water mark makes requeue replays invisible: a cleared
        planner stream re-emits its (bit-exact) prefix below the mark
        and only genuinely new tokens reach the client."""
        done: List[int] = []
        for rid, st in self._live.items():
            toks = self.planner.streams.get(rid)
            if toks is not None and len(toks) > st._sent:
                for tok in toks[st._sent:]:
                    st._emit(tok)
                st._sent = len(toks)
            if st.req.state != "pending":
                self._tel("gw_stream_close", st.req, cause=st.req.state,
                          tokens=len(st.tokens))
                st._finish(st.req.state)
                done.append(rid)
        for rid in done:
            del self._live[rid]
            self._batches.pop(rid, None)

    def _deliver(self, req: Request) -> None:
        # mirrors run_event_loop's delivery: arrival instant, then the
        # hooks' deliver (planner.submit via TickServer.deliver — which
        # handles the shed branch and its accounting)
        self._tel("arrival", req)
        self.server.deliver(req)

    async def run(self, *, hold_open: bool = False) -> None:
        """Serve until drained (trace mode) or until ``close()`` then
        drained (``hold_open`` live mode). One invocation per gateway:
        the loop owns the server's clock."""
        if self._running:
            raise RuntimeError("gateway already running")
        self._running = True
        self._t0 = time.perf_counter()
        server = self.server
        now = 0.0
        # t=0 prologue, exactly like run_event_loop
        while self._pending and self._pending[0].arrival <= now:
            self._deliver(self._pending.pop(0))
        server.plan(now)
        self._pump()
        await asyncio.sleep(0)
        while True:
            if self.events >= self.max_ticks:
                self.truncated = True
                break
            # the trace, when attached (read every turn: it may come and go
            # while the loop runs)
            tel = self.planner.telemetry
            rec = None if tel is None else tel.trace
            t = min(server.next_completion(),
                    self._pending[0].arrival if self._pending else math.inf)
            if math.isinf(t):
                if hold_open and not self._closed:
                    self._wake.clear()
                    # idle live gateway: nothing scheduled, nothing
                    # resident — sleep until a submit/cancel/close
                    s = rec.now() if rec is not None else 0.0
                    await self._wake.wait()
                    if rec is not None:
                        self._host_span(rec, "wait", s)
                    continue
                break
            if self.wall_clock:
                delay = t - self._elapsed()
                if delay > 0:
                    s = rec.now() if rec is not None else 0.0
                    await asyncio.sleep(delay)
                    if rec is not None:
                        self._host_span(rec, "wait", s)
                now = max(t, self._elapsed())
            else:
                now = t
            self.now = now
            s = rec.now() if rec is not None else 0.0
            n = 0
            while (self._pending
                   and self._pending[0].arrival <= now + _EPS):
                self._deliver(self._pending.pop(0))
                n += 1
            if rec is not None and n:
                self._host_span(rec, "deliver", s, arrivals=n)
            self.events += server.fire(now, _EPS)
            server.plan(now)
            s = rec.now() if rec is not None else 0.0
            self._pump()
            if rec is not None:
                s = self._host_span(rec, "pump", s)
            # the one cooperative yield per event: queued consumers run
            # here, in FIFO order — deterministic interleaving
            await asyncio.sleep(0)
            if rec is not None:
                self._host_span(rec, "yield", s)
        self._pump()
        for rid in list(self._live):
            # truncated / never-drained remnants: close so consumers
            # terminate; state stays whatever the request reached
            st = self._live.pop(rid)
            st._finish(st.req.state)
        self._running = False

    def serve_trace(self, requests: Sequence[Request], prompts=None
                    ) -> Dict[int, TokenStream]:
        """Sync convenience mirroring ``serve_ticks``: schedule the
        trace, run to drain, return every stream (all closed). Shed /
        expired requests come back as terminally-closed streams rather
        than raising — a trace replay has no live client to reject."""
        self.schedule(requests, prompts)
        asyncio.run(self.run())
        return dict(self.streams)
