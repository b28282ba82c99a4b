"""`correct` on the CPU at a toy size: the port's run against the plain
reference passes; the control (the reference in fp8 in the program's
place) and each fault planted under the timed path fail. The run is the
benchmark's own, with the look for a card skipped."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.harness import checks, spec
from portbench.harness.cell import run_cell
from portbench.harness.inputs import paired_split
from portbench.reference.train import first_steps
from portbench.tests.toy import LIMITS, write_toy

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return spec.load_cell("toy_cell", write_toy(tmp_path_factory.mktemp("c")))


@pytest.mark.parametrize("fault", [None, "half_batch", "state_unchanged"])
def test_a_run_is_correct_and_each_fault_is_not(toy, fault):
    result, lines = run_cell(toy, 2**31 + 77, 1.0, False, time.perf_counter(),
                             device="cpu", fault=fault)
    assert result["correct"] is (fault is None), lines
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(LIMITS)
    assert result["attempted"] >= 3 and result["failed"] == 0
    m = result["metrics"]
    assert set(m) == {"train_cases_per_s", "step_ms_p90", "peak_mem_gib",
                      "setup_s"}
    assert m["train_cases_per_s"]["value"] > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_the_control_fails_a_number(toy, seed):
    t = toy.traffic
    split = paired_split(t["cases"], t["canvas"], seed)
    ref = first_steps(toy, split, seed, "cpu")
    ctl = first_steps(toy, split, seed, "cpu", numerics="fp8")
    ok, numbers = checks.judge(checks.gaps(ctl, ref), LIMITS)
    assert not ok, numbers


def test_the_reference_reads_the_same_inputs_twice_alike(toy):
    t = toy.traffic
    split = paired_split(t["cases"], t["canvas"], 9)
    a = first_steps(toy, split, 9, "cpu")
    b = first_steps(toy, split, 9, "cpu")
    assert a.losses == b.losses and a.grad == b.grad


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_exits_without_a_result_without_a_card():
    r = _run(["portbench/run.py", "--workload", "r50_ssl_recipe", "--seed",
              "3", "--seconds", "1"], REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_exits_without_a_result_without_the_program(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(["portbench/run.py", "--workload", "r50_ssl_recipe", "--seed",
              "3", "--seconds", "1"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_own_size_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    cell = spec.load_cell("vit_b16_ssl_recipe")
    t = cell.traffic
    for seed in (41, 42, 43):
        split = paired_split(t["cases"], t["canvas"], seed)
        ref = first_steps(cell, split, seed, "cuda")
        ctl = first_steps(cell, split, seed, "cuda", numerics="fp8")
        ok, numbers = checks.judge(checks.gaps(ctl, ref),
                                   cell.workload["limits"])
        assert not ok, numbers
