"""bench_torch.py, the port's headline benchmark, as far as a machine
without a card can hold it: with `--device cpu` at a toy size (resnet18,
56x56, 2 steps) it prints one JSON line with bench.py's keys and the
port's beside them, the device's keys null; without a card and without
that flag it exits non-zero with a message and prints no result."""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_torch.py")


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, BENCH] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


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
