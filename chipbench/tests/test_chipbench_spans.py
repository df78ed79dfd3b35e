"""The readings of the program's spans (``harness/spans.py``) on
hand-made recorder events, against values computed by hand; and None
where the events hold nothing to read."""
import pytest

from harness import spans

T0 = 100.0                       # the recorder's t0, perf_counter seconds


def x(track, name, ts_ms, dur_ms, cat="serving", device_ms=None, **args):
    ev = {"track": track, "ph": "X", "name": name, "cat": cat,
          "ts": ts_ms * 1e3, "dur": dur_ms * 1e3, "args": args}
    if device_ms is not None:
        ev["device_dur"] = device_ms * 1e3
    return ev


def inst(name, ts_ms, rid):
    return {"track": "queue/m", "ph": "i", "name": name, "cat": "request",
            "ts": ts_ms * 1e3, "args": {"rid": rid}}


def tick(n, start, plan, execute, dispatches, read, observe):
    """Tick ``n`` from ``start`` (ms): plan, then execute holding
    ``dispatches`` [(name, host ms, device ms)], the last a decode whose
    final ``read`` ms are its readback, then observe."""
    evs = [x("tick/m", "plan", start, plan)]
    t = start + plan
    evs.append(x("engine/m@0ch", "execute", t, execute))
    t += 0.1                                  # execute before a dispatch
    for name, host, dev in dispatches:
        evs.append(x("engine/m@0ch", name, t, host, cat="dispatch",
                     device_ms=dev))
        t += host
    evs.append(x("engine/m@0ch", "readback", t - read, read, cat="host"))
    t = start + plan + execute
    evs.append(x("tick/m", "observe", t, observe, cat="host"))
    t += observe
    evs.append(x("tick/m", "tick", start, t - start, tick=n))
    return evs, t


def serve():
    """Three ticks, each followed by the gateway's pump and yield."""
    evs, t = [], 0.0
    for n, (prefill, decode) in enumerate([(2.0, 5.0), (None, 4.0),
                                           (1.0, 6.0)]):
        disp = ([("admission_prefill", 1.0, prefill)] if prefill else [])
        disp.append(("decode", 3.0, decode))
        # execute: 0.1 ms before, the dispatches, 0.2 ms after
        host = sum(h for _, h, _ in disp)
        tk, t = tick(n, t, plan=0.5, execute=host + 0.3, dispatches=disp,
                     read=1.0, observe=0.4)
        evs += tk
        evs.append(x("tick/m", "pump", t, 0.6, cat="host"))
        evs.append(x("tick/m", "yield", t + 0.6, 1.2, cat="host"))
        t += 1.8 + 0.3                        # 0.3 ms in no span
    return evs


def test_host_gap_and_its_split_by_hand():
    evs = serve()
    w0, w1 = T0, T0 + 1.0
    gaps = spans.host_gaps(evs, T0, w0, w1)
    # readback end -> next first dispatch: 0.2 (execute) + 0.4 (observe)
    # + 0.6 + 1.2 (pump, yield) + 0.3 (none) + 0.5 (plan) + 0.1 (execute)
    assert len(gaps) == 2
    assert [b - a for a, b in gaps] == pytest.approx([3.3e-3] * 2)
    assert spans.host_gap_ms(evs, T0, w0, w1) == pytest.approx(3.3)
    split = spans.host_split(evs, T0, gaps)
    want = {"wait": 0.0, "deliver": 0.0, "plan": 0.5, "execute.pre": 0.1,
            "execute.post": 0.2, "observe": 0.4, "pump": 0.6,
            "yield": 1.2, "other": 0.3}
    assert split == pytest.approx(want)


def test_dispatch_device_time_by_hand():
    evs = serve()
    # (2 + 5) + 4 + (1 + 6) over three ticks
    assert spans.dispatch_device_ms(evs, T0, T0, T0 + 1.0) == \
        pytest.approx(18.0 / 3)
    # the window holds the first tick alone
    assert spans.dispatch_device_ms(evs, T0, T0, T0 + 0.008) == \
        pytest.approx(7.0)
    # a tick with an unresolved dispatch is left out
    del [e for e in evs if e["name"] == "decode"][1]["device_dur"]
    assert spans.dispatch_device_ms(evs, T0, T0, T0 + 1.0) == \
        pytest.approx(14.0 / 2)


def test_request_waits_by_hand():
    evs = [inst("queued", 0.0, 1), inst("admitted", 30.0, 1),
           inst("first_token", 80.0, 1),
           inst("queued", 10.0, 2), inst("admitted", 20.0, 2),
           inst("first_token", 25.0, 2),
           # a requeue: the first of each instant counts
           inst("queued", 90.0, 2), inst("admitted", 95.0, 2),
           inst("queued", 40.0, 3)]            # never admitted
    queue, prefill = spans.request_waits(evs, T0, [1, 2, 3, 4])
    assert queue == pytest.approx([0.030, 0.010])
    assert prefill == pytest.approx([0.050, 0.005])
    assert spans.queue_wait_p95_ms(evs, T0, [1, 2, 3]) == \
        pytest.approx(30.0)
    assert spans.prefill_wait_p95_ms(evs, T0, [2]) == pytest.approx(5.0)


def test_no_events_read_none():
    assert spans.host_gap_ms([], T0, T0, T0 + 1) is None
    assert spans.dispatch_device_ms([], T0, T0, T0 + 1) is None
    assert spans.host_split([], T0, []) is None
    assert spans.queue_wait_p95_ms([], T0, [1, 2]) is None
    assert spans.prefill_wait_p95_ms([], T0, [1, 2]) is None
    # a program without host spans or device times: spans, no readings
    old = [e for e in serve() if e.get("cat") != "host"]
    for e in old:
        e.pop("device_dur", None)
    assert spans.host_gap_ms(old, T0, T0, T0 + 1) is None
    assert spans.dispatch_device_ms(old, T0, T0, T0 + 1) is None


def test_overlap_of_two_unions():
    assert spans.overlap([(0, 2), (3, 5), (8, 9)], [(1, 4), (4.5, 8.5)]) \
        == pytest.approx(1 + 1 + 0.5 + 0.5)
    assert spans.overlap([], [(0, 1)]) == 0.0
