"""CPU tests of the benchmark harness (``python -m pytest chipbench/tests``
from the repository's root). The harness imports as the benchmark runs
it: ``chipbench/`` and ``src/`` on the path. ``add_cell`` builds a cell
of a small model in a copy of the harness, by adding files and a manifest
entry alone, as a later change would add one."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device")
    # the small cells run in wall time: a process that shares the CPU
    # with others must not wait on its own idle threads
    torch.set_num_threads(2)


TINY = {
    "dense": dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
                  head_dim=64, d_ff=256, vocab_size=512, padded_vocab=512,
                  dtype="float32", init_std=0.1),
    "ssm": dict(num_layers=2, d_model=128, ssm_state=16, ssm_head_dim=32,
                ssm_chunk=32, vocab_size=500, padded_vocab=512,
                dtype="float32", init_std=0.1),
}
CLOSED = {"loop": "closed", "clients": 4, "first_aged": True,
          "prompt": {"dist": "uniform", "lo": 8, "hi": 24},
          "output": {"dist": "uniform", "lo": 8, "hi": 40}}
OPEN = {"loop": "open", "arrivals": {"process": "poisson", "rate": 20.0},
        "prompt": {"dist": "lognormal", "median": 30, "sigma": 0.8,
                   "lo": 8, "hi": 60},
        "output": {"dist": "lognormal", "median": 10, "sigma": 0.5,
                   "lo": 4, "hi": 20}}
SERVE = {
    "closed": {"slots": 4, "cache_len": 64, "page_size": 8,
               "chunk_tokens": 0, "prelude_s": 0.5, "prelude_eager": True,
               "start_wave": 2,
               "warm": {"packed": {"n_max": 4, "lo": 8, "hi": 24}},
               "check": {"sample": 40, "max_gap": 1e-3}},
    "open": {"slots": 4, "cache_len": 96, "page_size": 8,
             "chunk_tokens": 16, "prelude_s": 0.5,
             "warm": {"packed": {"n_max": 2, "lo": 1, "hi": 16,
                                 "sum_max": 16},
                      "chunk": {"n_max": 2, "lo": 1, "hi": 16,
                                "sum_max": 16}},
             "check": {"sample": 40, "max_gap": 1e-3}},
}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def add_cell(bench: Path, manifest, family: str, loop: str):
    """Add a small model's configuration, a mix and a cell to the harness
    copy ``bench`` and to ``manifest``, by new files and entries only.
    Returns the cell's name."""
    src = "olmo-1b" if family == "dense" else "mamba2-1.3b"
    cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    cfg.update(TINY[family], name=f"tiny-{family}", reduced=sorted(
        k for k in TINY[family] if k not in ("dtype", "init_std")))
    mix = CLOSED if loop == "closed" else OPEN
    name = f"{cfg['name']}.{loop}"
    write_json(bench / "configs" / f"{cfg['name']}.json", cfg)
    write_json(bench / "traffic" / f"tiny-{loop}.json", mix)
    write_json(bench / "workloads" / f"{name}.json",
               dict(SERVE[loop], config=cfg["name"],
                    traffic=f"tiny-{loop}"))
    manifest["configs"].append({
        "name": cfg["name"], "source": cfg["source"],
        "file": f"chipbench/configs/{cfg['name']}.json",
        "reduced": cfg["reduced"], "why": "a small model for CPU tests"})
    manifest["workloads"].append({
        "name": name, "config": cfg["name"], "traffic": f"tiny-{loop}",
        "chips": 1, "why": "a small cell for CPU tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m and m["name"] in (
                "tokens_per_s", "ttft_p95_ms", "tbt_p95_ms",
                "plan_ms.tbt", "execute_ms.tokens", "decode_batch.tokens"):
            m["workloads"].append(name)
    return name


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the harness's code and files, and of the manifest."""
    bench = tmp_path / "chipbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return bench, manifest
