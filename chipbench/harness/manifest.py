"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric sits in a file of its own under ``chipbench/``:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the parameters the one generator
  (``harness/traffic.py``) reads;
* ``workloads/<cell>.json``: slots, cache length, page size, chunking,
  prelude, the shapes to warm and the limits of the output check;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``reference/<reference>.py``: the plain float32 reference a
  configuration names.

A new cell, mix, configuration or metric is a new file and a new manifest
entry; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: Optional[float] = None          # end-to-end metrics only
    layer: Optional[str] = None            # per-layer metrics only
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    serve: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: Path = BENCH_DIR

    def reader(self, metric: str):
        """The reader module of per-layer metric ``metric``."""
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"chipbench_metric_{metric.replace('.', '_')}")

    def reference(self):
        """The configuration's plain reference module."""
        ref = self.config["reference"]
        return load_module(self.bench_dir / "reference" / f"{ref}.py",
                           f"chipbench_reference_{ref}")


def _metrics(entries, cell: str) -> List[Metric]:
    out = []
    for e in entries:
        m = Metric(**e)
        if m.applies_to(cell):
            out.append(m)
    return out


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, manifest: Optional[Dict[str, Any]] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    manifest = manifest if manifest is not None else load_manifest()
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        known = [w["name"] for w in manifest["workloads"]]
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {known}")
    serve = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if serve[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{serve[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(bench_dir / "configs" / f"{entry['config']}.json"),
        mix=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        serve=serve,
        end_to_end=_metrics(manifest["end_to_end"], name),
        per_layer=_metrics(manifest["per_layer"], name),
        bench_dir=bench_dir)
