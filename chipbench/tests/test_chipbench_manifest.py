"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""
import re

import pytest

from harness.manifest import load_cell, load_json, load_module

from conftest import BENCH, ROOT

MAN = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "chipbench/run.py"]
    assert MAN["paths"] == ["chipbench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits into its 43200 seconds
    r = MAN["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keys_and_names():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"chipbench/configs/{c['name']}.json"
        cfg = load_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg and NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_file_names_are_made_of_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        for part in p.relative_to(ROOT).parts:
            assert NAME.match(part), p


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(cell):
    c = load_cell(cell, MAN)
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert (BENCH / "reference" / f"{c.config['reference']}.py").exists()
    assert c.mix["loop"] in ("open", "closed")
    for m in c.per_layer:
        # a per-layer metric's arrow points at a metric the cell reports
        assert m.moves in e2e, (cell, m.name)
        r = c.reader(m.name)
        assert (r.UNIT, r.LAYER, r.MOVES) == (m.unit, m.layer, m.moves)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(len(k) < 80 for k in layers)


def test_every_reader_and_mix_is_used():
    readers = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in MAN["per_layer"]}
    mixes = {p.stem for p in (BENCH / "traffic").glob("*.json")}
    assert mixes == {w["traffic"] for w in MAN["workloads"]}
    cells = {p.stem for p in (BENCH / "workloads").glob("*.json")}
    assert cells == set(CELLS)
    for p in (BENCH / "metrics").glob("*.py"):
        load_module(p, "t_" + p.stem.replace(".", "_"))
