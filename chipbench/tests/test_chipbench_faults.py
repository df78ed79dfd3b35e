"""Runs of small cells on the CPU, added by files and manifest entries
alone: a sound run comes out correct; the same run with the timed path
broken underneath comes out not correct, once for each fault a served
model can have (a token altered where it is produced; a decode step that
leaves its state unchanged), and the control (the reference through
float8 in the program's place) comes out not correct by the same
comparison. The harness's look for a chip is skipped:
the rest of a run is driven as ``run.py`` drives it."""
import json
import time

import pytest

import run as bench_run
from harness import check
from harness.manifest import load_cell
from harness.serve import run_cell
from repro_torch.serving import engine as engine_mod

from conftest import add_cell

# a few dozen requests each: seconds, not the benchmark's window
SECONDS = 1.5


def alter_tokens(monkeypatch):
    """Every 16th tick's decoded tokens altered where the engine
    returns them."""
    execute = engine_mod.InferenceEngine.execute
    ticks = [0]

    def faulty(self, plan):
        res = execute(self, plan)
        if res.tokens and ticks[0] % 16 == 0:
            v = self.cfg.vocab_size
            res.tokens = {s: (t + 1) % v for s, t in res.tokens.items()}
        ticks[0] += 1
        return res

    monkeypatch.setattr(engine_mod.InferenceEngine, "execute", faulty)


def freeze_state(monkeypatch):
    """A decode step that leaves the K/V or SSM state it was given
    unchanged (the eager step; put back after every step)."""
    step = engine_mod._slot_decode_step

    def faulty(api, skip, ring_keys, params, tok, cache, *rest):
        keep = {k: cache[k].clone() for k in ("k", "v", "ssm", "conv")
                if k in cache}
        out = step(api, skip, ring_keys, params, tok, cache, *rest)
        for k, old in keep.items():
            cache[k].copy_(old)
        return out

    monkeypatch.setattr(engine_mod, "_slot_decode_step", faulty)


FAULTS = {"token": alter_tokens, "state": freeze_state}


def run_tiny(bench_copy, family, loop, trace=False):
    bench, manifest = bench_copy
    name = add_cell(bench, manifest, family, loop)
    cell = load_cell(name, manifest, bench_dir=bench)
    run = run_cell(cell, 2 ** 31 + 99, SECONDS, trace, "cpu",
                   time.perf_counter())
    numbers, control = check.check_with_control(run)
    return run, numbers, control, bench_run.result(run, trace, numbers)


@pytest.mark.parametrize("family,loop", [("dense", "closed"),
                                         ("dense", "open"),
                                         ("ssm", "closed")])
def test_sound_run_is_correct(bench_copy, family, loop):
    run, numbers, control, out = run_tiny(bench_copy, family, loop)
    assert out["correct"], numbers
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m.name for m in run.cell.end_to_end}
    assert set(out["metrics"]) == names
    assert all(out["metrics"][n]["value"] > 0 for n in names)
    assert list(out)[-1] == "check"
    json.dumps(out)
    # the control, judged by the harness's own comparison, is not correct
    assert check.passed(numbers) and not check.passed(control), control
    assert control["max_gap"]["limit"] == numbers["max_gap"]["limit"]


@pytest.mark.parametrize("family,fault", [("dense", "token"),
                                          ("dense", "state"),
                                          ("ssm", "token"),
                                          ("ssm", "state")])
def test_broken_path_is_not_correct(bench_copy, monkeypatch, family, fault):
    FAULTS[fault](monkeypatch)
    _, numbers, _, out = run_tiny(bench_copy, family, "closed")
    assert not out["correct"], numbers
    assert numbers["max_gap"]["value"] > numbers["max_gap"]["limit"]


def test_traced_run_reports_per_layer_metrics_by_file(bench_copy):
    bench, _ = bench_copy
    # a new per-layer metric is a new reader file and a manifest entry
    (bench / "metrics" / "ticks_seen.tokens.py").write_text(
        'UNIT, LAYER, MOVES = "ticks", "serving.plan", "tokens_per_s"\n'
        "def read(run):\n    return float(len(run.ticks)) or None\n")
    bench_copy[1]["per_layer"].append({
        "name": "ticks_seen.tokens", "unit": "ticks", "better": "higher",
        "source": "program_counter", "layer": "serving.plan",
        "moves": "tokens_per_s"})
    run, numbers, _, out = run_tiny(bench_copy, "dense", "closed",
                                    trace=True)
    assert out["correct"], numbers
    got = out["metrics"]
    assert got["ticks_seen.tokens"]["value"] > 0
    assert 0 < got["decode_batch.tokens"]["value"] <= 4
    assert got["plan_ms.tbt"]["value"] > 0
    assert got["execute_ms.tokens"]["value"] > 0
    # no device on the CPU: the device's readers find nothing to read
    assert "idle_share.tokens" not in got and "busy_s" not in out["device"]
