"""Run one cell of the benchmark once and print its result.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. The cell, its configuration, traffic mix and per-layer metrics are
found by name (``BENCHMARK.json``, ``chipbench/harness/manifest.py``).
With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, the device's busy
seconds and a breakdown of the device's time. Either way the served
tokens are held against the plain reference, and the last lines on
standard error give each number compared beside its limit.

The last line on standard output is the result (one JSON object). The run
exits non-zero and prints no result without the chips the cell asks for,
or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def setup_paths() -> None:
    """The harness and the program from this checkout; every build and
    kernel cache inside it."""
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    cache = ROOT / ".chipbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result(run, trace: bool, numbers, device_extra=None):
    from harness import check, endtoend, stats
    cell = run.cell
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m.name).read(run)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {m.name: {"value": endtoend.METRICS[m.name](run),
                            "unit": m.unit} for m in cell.end_to_end}
    due = run.in_window
    waited = any(m.name == "ttft_p95_ms" for m in cell.end_to_end)
    failed = sum(1 for r in due if r.refused or (waited and not r.stamps)
                 or r.state not in (None, "completed"))
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": check.passed(numbers), "attempted": len(due),
           "failed": failed, "metrics": metrics, "device": device}
    if trace and run.device is not None:
        device["busy_s"] = run.device.busy_s
        device["window_s"] = run.device.window_s
        out["breakdown"] = {"device_ops": run.device.top_ops(10),
                            "idle_gaps": [list(g) for g in
                                          run.device.gaps[:10]]}
    out["context"] = dict(device_extra or {}, seed=run.seed,
                          tokens_in_window=stats.tokens_in(
                              run.records, run.w0, run.w1),
                          warmed=run.warmed,
                          captures_in_window=run.captures_in_window)
    out["check"] = numbers
    return out


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    from harness import check
    from harness.serve import run_cell
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    t0 = time.perf_counter()
    numbers = check.check(run)
    log(f"window {run.seconds} s; check {time.perf_counter() - t0:.2f} s")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    out = result(run, bool(args.trace), numbers,
                 {"card": power_limit()})
    for name, n in numbers.items():
        log(f"check {name} {n['value']} limit {n['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
