"""The benchmark's data, found by name: a cell (`workloads/<cell>.json`)
names its configuration (`configs/<config>.json`, with the functions of
that configuration in `configs/<config>.py`) and its traffic mix
(`traffic/<traffic>.json`); the mix names the stage of the recipe that it
trains (`stages/<stage>.py`); each per-layer metric is a reader of its own
(`metrics/<metric>.py`). Adding a cell, a configuration, a mix, a stage or
a metric adds files and edits none.

A stage module gives `Run(cell, seed, device, fault)`, whose `build()`,
`first_epoch()`, `window(seconds, traced)` and `free()` drive the program
(with `split`, `tracer`, `spans` and `boundaries` for the readers),
`reference(cell, split, seed, device, numerics)`, the plain reference's
readings of the same first steps, and `step_shapes(cell)`, what a step
launches and computes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    traffic: dict
    config: dict
    model: ModuleType      # configs/<config>.py

    @property
    def batch(self) -> int:
        return int(self.workload["batch"])


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"portbench: no cell {name!r} ({path} is missing)")
    workload = _json(path)
    config = workload["config"]
    return Cell(name, workload,
                _json(root / "traffic" / f"{workload['traffic']}.json"),
                _json(root / "configs" / f"{config}.json"),
                load_module(root / "configs" / f"{config}.py",
                            f"portbench_config_{config}"))


def metric_readers(root: Path = ROOT) -> dict:
    """{metric name: its reader}, one file a metric: `read(ctx)` gives the
    number or None where the cell has nothing to read, `UNIT` its unit."""
    out = {}
    for path in sorted((Path(root) / "metrics").glob("*.py")):
        name = path.name[:-len(".py")]
        out[name] = load_module(path, "portbench_metric_" + name.replace(
            ".", "_"))
    return out


def load_stage(cell: Cell, root: Path = ROOT) -> ModuleType:
    """The stage module that the cell's traffic names; a stage that has no
    module is refused, never run as another."""
    name = str(cell.traffic.get("stage", ""))
    if not name.isidentifier() or not (Path(root) / "stages"
                                       / f"{name}.py").exists():
        raise SystemExit(f"portbench: cell {cell.name!r} trains stage "
                         f"{name!r}, which has no stages/{name}.py")
    return importlib.import_module(f"portbench.stages.{name}")
