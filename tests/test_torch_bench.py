"""bench_torch.py, the port's headline benchmark, as far as a machine
without a card can hold it: with `--device cpu` at a toy size (resnet18,
56x56, 2 steps) it prints one JSON line with bench.py's keys and the
port's beside them, the device's keys null, for stage 1 and for each
`--stage`; without a card and without that flag it exits non-zero with a
message and prints no result. And tools/bench_serve_soak_torch.py at a
toy size prints its JSON line with the reference's keys, and
tools/bench_prefetch_torch.py at a toy size its four lines with the keys
of tools/bench_prefetch.py."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_torch.py")
PREFETCH = os.path.join(REPO, "tools", "bench_prefetch_torch.py")


def _run(args, cwd, script=BENCH):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, script] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _load(path):
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_prints_one_json_line_on_the_cpu(tmp_path):
    res = _run(["4", "2", "resnet18", "--img-sz", "56", "56", "--canvas",
                "80", "--device", "cpu"], str(tmp_path))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "step_ms",
                "step_ms_min", "device_busy_ms", "launches_per_step",
                "peak_memory_gib", "device"):
        assert key in out, key
    assert out["metric"] == "ssl_pretrain_images_per_sec_per_chip"
    assert out["vs_baseline"] is None
    assert "mfu" not in out and "mfu_pct" not in out and "tflops" not in out
    assert out["value"] > 0 and 0 < out["step_ms_min"] <= out["step_ms"]
    # no device number comes from a CPU run
    assert out["device"] == "cpu"
    assert out["device_busy_ms"] is None and out["launches_per_step"] is None
    assert out["peak_memory_gib"] is None
    assert (out["batch"], out["steps"], out["arch"]) == (4, 2, "resnet18")
    assert os.listdir(tmp_path) == []  # it leaves nothing behind


def test_bench_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        return  # on a card the default run is the benchmark itself
    res = _run(["4", "2", "resnet18"], str(tmp_path))
    assert res.returncode != 0
    assert "runs on an NVIDIA GPU" in res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("stage", ["mlc_train", "mlc_eval", "backbone_eval"])
def test_bench_prints_one_json_line_a_stage_on_the_cpu(tmp_path, stage):
    res = _run(["4", "2", "resnet18", "--stage", stage, "--img-sz", "32",
                "32", "--canvas", "48", "--device", "cpu"], str(tmp_path))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["metric"] == f"{stage}_images_per_sec_per_chip"
    assert (out["stage"], out["batch"], out["steps"], out["arch"]) == (
        stage, 4, 2, "resnet18")
    assert out["value"] > 0 and 0 < out["step_ms_min"] <= out["step_ms"]
    # one view a modality: 2 images a case
    assert out["images_per_sec"] == pytest.approx(2 * 4 / out["step_ms"]
                                                  * 1e3)
    assert out["device"] == "cpu" and out["vs_baseline"] is None
    assert out["device_busy_ms"] is None and out["peak_memory_gib"] is None
    assert os.listdir(tmp_path) == []


def test_serve_soak_prints_the_reference_s_keys_on_the_cpu(capsys):
    soak = _load(os.path.join(REPO, "tools", "bench_serve_soak_torch.py"))
    out = soak.main(["--device", "cpu", "--arch", "resnet18", "--test-sz",
                     "32", "--requests", "8", "--clients", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    for key in ("metric", "arch", "test_sz", "mlc_proj_dim", "sa_dim_ff",
                "value", "requests", "clients", "burst_n",
                "burst_coalesced_ms", "burst_serialized_ms",
                "coalescing_ratio", "latency_ms_p50", "latency_ms_p99",
                "device"):
        assert key in out, key
    assert out["metric"] == "serve_soak_cases_per_sec"
    assert (out["requests"], out["clients"], out["burst_n"]) == (8, 2, 8)
    assert out["value"] > 0 and out["coalescing_ratio"] > 0
    assert 0 < out["latency_ms_p50"] <= out["latency_ms_p99"]
    assert out["device"] == "cpu"


def test_prefetch_bench_prints_the_reference_s_four_lines_on_the_cpu(
        tmp_path, monkeypatch, capsys):
    """Four JSON lines, one a feed in the JAX tool's order, with its metric
    names and keys and the port's `device`; two steps an epoch (6 train
    cases at batch 4); nothing left in the working directory. In-process,
    on two threads, beside the suite's other workers."""
    tool = _load(PREFETCH)
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = tool.main(["12", "4", "2", "resnet18", "--img-sz", "32", "32",
                        "--tree-size", "48", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    lines = [json.loads(line) for line in out.out.strip().splitlines()]
    assert [line["metric"] for line in lines] == [
        f"ssl_feed_{feed}_images_per_sec"
        for feed in ("sync", "prefetch", "resident", "stream")]
    for line in lines:
        assert sorted(line) == ["device", "metric", "unit", "value"]
        assert line["value"] > 0 and line["device"] == "cpu"
        assert line["unit"].startswith("images/sec (resnet18, b=4, 2 "
                                       "steps/epoch, ")
        assert line["unit"].endswith("median of 1 epochs)")
    assert out.err.count("2 epochs of 2 steps") == 4
    assert os.listdir(tmp_path) == []


def test_prefetch_bench_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        return  # on a card the default run is the benchmark itself
    res = _run(["12", "4", "2", "resnet18"], str(tmp_path), PREFETCH)
    assert res.returncode != 0
    assert "runs on an NVIDIA GPU" in res.stderr
    assert res.stdout.strip() == ""
    assert os.listdir(tmp_path) == []
