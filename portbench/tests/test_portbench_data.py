"""The benchmark as data: a cell or a metric added as files is found with no
edit, `BENCHMARK.json` keeps to the contract's characters and shapes, and
the import guard compares whole top-level names."""

import json
import re
import sys
import types
from pathlib import Path

import pytest

from portbench.harness import spec
from portbench.harness.cell import forbidden_modules
from portbench.tests.toy import write_toy

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_added_as_files_is_found(tmp_path):
    write_toy(tmp_path, "added_cell")
    cell = spec.load_cell("added_cell", tmp_path)
    assert cell.batch == 8 and cell.config["arch"] == "resnet18"
    assert cell.model.forward_flops(cell.config, 32) > 0


def test_a_cell_of_a_stage_with_no_module_is_refused(tmp_path):
    write_toy(tmp_path, "mlc_cell")
    traffic = tmp_path / "traffic" / "toy_mix.json"
    traffic.write_text(json.dumps(dict(json.loads(traffic.read_text()),
                                       stage="no_such_stage")))
    cell = spec.load_cell("mlc_cell", tmp_path)
    with pytest.raises(SystemExit, match="no_such_stage"):
        spec.load_stage(cell)
    assert spec.load_stage(spec.load_cell("r50_ssl_recipe")).__name__ == (
        "portbench.stages.ssl")


def test_a_metric_added_as_a_file_is_found(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.layer_ms.py").write_text(
        "UNIT = 'ms'\n\ndef read(ctx):\n    return ctx['x']\n")
    readers = spec.metric_readers(tmp_path)
    assert readers["new.layer_ms"].read({"x": 2.5}) == 2.5
    assert readers["new.layer_ms"].UNIT == "ms"


def test_every_cell_and_reader_of_the_benchmark_loads():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["chips"] == w["chips"]
    readers = spec.metric_readers()
    for m in bench["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert {m["better"] for m in metrics} <= {"lower", "higher"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    cells = {w["name"] for w in bench["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in metrics)
    assert all(w["chips"] == 1 for w in bench["workloads"])
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    assert 1 <= bench["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sm3x"):
            monkeypatch.delitem(sys.modules, name)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sm3x_torch_lookalike",
                        types.ModuleType("x"))
    assert forbidden_modules() == []
    for name in ("sm3x.core", "jaxlib", "flax.linen", "optax", "jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == ["flax", "jax", "jaxlib", "optax", "sm3x"]
