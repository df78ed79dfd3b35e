"""Readings for a cell's limits and rate, many seeds in one process.

    python3 chipbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        --seconds 10 [--control] [--rates R ...] [--trace 0]

For each seed, one run of the cell as ``run.py`` makes it, then the output
check; with ``--control`` also the control's numbers on the same prompts
and tokens (the reference through float8 in the program's place), judged
by the harness's own comparison against the cell's limits
(``control_correct``, false where the limit separates the two). With
``--rates`` an open-loop mix arrives at each rate in turn, every seed at
every rate (the sweep that finds the rate a cell's system sustains). One
JSON line a run, on standard output and in
``chiprun_out/calibrate-<cell>.jsonl``.
The benchmark's runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", type=float, nargs="+", default=[None])
    args = ap.parse_args()
    bench_run.setup_paths()
    import torch
    from harness import check, stats
    from harness.manifest import load_cell
    from harness.serve import run_cell
    out_dir = BENCH.parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / f"calibrate-{args.workload}.jsonl", "a")
    t_start = T_START
    for seed, rate in [(s, r) for r in args.rates for s in args.seeds]:
        cell = load_cell(args.workload)
        if rate is not None:
            cell.mix["arrivals"]["rate"] = rate
        run = run_cell(cell, seed, args.seconds, bool(args.trace), "cuda",
                       t_start)
        t0 = time.perf_counter()
        if args.control:
            numbers, control = check.check_with_control(run)
        else:
            numbers, control = check.check(run), None
        check_s = time.perf_counter() - t0
        res = bench_run.result(run, bool(args.trace), numbers)
        due = run.in_window
        served = [r for r in run.records if r.state == "completed"]
        line = {"seed": seed, "rate": rate, "check_s": check_s,
                "correct": res["correct"], "metrics": res["metrics"],
                "check": numbers, "attempted": res["attempted"],
                "failed": res["failed"], "device": res["device"],
                "context": res["context"],
                "completed_in_window": sum(
                    1 for r in served if r.stamps
                    and run.w0 <= r.stamps[-1] < run.w1),
                "ttft_p50_ms": 1e3 * stats.percentile(
                    stats.ttfts(due), 0.5),
                "ttft_p95_ms": 1e3 * stats.percentile(
                    stats.ttfts(due), 0.95),
                "due_in_window": len(due),
                "distinct_token_share": (
                    sum(len(set(r.tokens)) for r in served)
                    / max(1, sum(len(r.tokens) for r in served)))}
        if control is not None:
            line["control"] = control
            line["control_correct"] = check.passed(control)
            print("control: " + ", ".join(
                f"{k} {n['value']} (limit {n['limit']})"
                for k, n in control.items())
                + f"; correct {line['control_correct']}",
                file=sys.stderr, flush=True)
        if "breakdown" in res:
            line["breakdown"] = res["breakdown"]
        print(json.dumps(line), flush=True)
        sink.write(json.dumps(line) + "\n")
        sink.flush()
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
