"""The port's synthetic data and the host tools around it, against the JAX
package's: `make_fake_derm7pt` writes the same tree byte for byte (plain
and structured, PNG), the demo's `make_structured_dataset` draws the same
canvases, labels and metadata codes, `cal_mean_std_torch` computes the
reference's channel statistics, and the demo, the recipe summary and
`tools/compare_ssl_loss.py` run at a toy size."""

import importlib.util
import json
import math
import os
import re

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("structured", [False, True])
def test_fake_derm7pt_tree_is_byte_identical(tmp_path, structured):
    from sm3x.data.synthetic import make_fake_derm7pt as reference
    from sm3x_torch.data.synthetic import make_fake_derm7pt

    kw = dict(n_cases=8, img_size=40, seed=7, structured=structured,
              ext="png")
    got = _tree(make_fake_derm7pt(str(tmp_path / "port"), **kw))
    want = _tree(reference(str(tmp_path / "ref"), **kw))
    assert sorted(got) == sorted(want)
    assert {"meta.csv", "train_indexes.csv", "valid_indexes.csv",
            "test_indexes.csv"} <= set(got)
    assert sum(k.startswith("images") for k in got) == 16
    for name in want:
        assert got[name] == want[name], name


def test_fake_derm7pt_refuses_splits_that_do_not_sum(tmp_path):
    from sm3x_torch.data.synthetic import make_fake_derm7pt

    with pytest.raises(ValueError, match="must sum"):
        make_fake_derm7pt(str(tmp_path / "t"), n_cases=4, img_size=32,
                          splits=(2, 1, 2))
    assert not (tmp_path / "t").exists()  # refused before anything is written


def test_structured_dataset_equals_the_reference():
    port = _load("tools/demo_synthetic_e2e_torch.py", "demo_port")
    ref = _load("tools/demo_synthetic_e2e.py", "demo_ref")
    got = port.make_structured_dataset(n=20, size=32, seed=3)
    want = ref.make_structured_dataset(n=20, size=32, seed=3)
    for g, w in zip(got, want):
        assert g.n == w.n
        for mod in ("derm", "clinic"):
            a, b = getattr(g, mod), getattr(w, mod)
            np.testing.assert_array_equal(a.canvases, b.canvases)
            np.testing.assert_array_equal(a.valid_hw, b.valid_hw)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.meta_codes, w.meta_codes)
        assert g.meta_vocab_sizes == w.meta_vocab_sizes
        assert g.labels.dtype == w.labels.dtype == np.int32
    assert (got[0].n, got[1].n) == (14, 6)


def test_cal_mean_std_matches_the_reference(tmp_path, capsys):
    """The same canvases through both functions. Mean and the second
    moment (std^2 + mean^2), which are the two accumulated float64 sums of
    per-canvas float32 sums, agree within rtol 1e-6; the std is derived
    as sqrt(E[x^2] - mean^2), so an rtol of 1e-6 on E[x^2] carries to it
    multiplied by E[x^2] / (2 var), and it is held to that."""
    from sm3x_torch.data.derm7pt import Derm7ptMeta
    from sm3x_torch.data.pipeline import ImageStore
    from sm3x_torch.data.synthetic import make_fake_derm7pt

    port = _load("tools/misc/cal_mean_std_torch.py", "cal_port")
    ref = _load("tools/misc/cal_mean_std.py", "cal_ref")
    root = make_fake_derm7pt(str(tmp_path / "t"), n_cases=12, img_size=72,
                             seed=2, structured=True)
    meta = Derm7ptMeta(root)
    derm, clinic, _ = meta.examples("train")
    store = ImageStore(derm + clinic, 64, meta.crop_amount)
    mean, std = port.channel_mean_std(store)
    mean_r, std_r = ref.channel_mean_std(store)
    assert mean.dtype == std.dtype == np.float64
    np.testing.assert_allclose(mean, mean_r, rtol=1e-6)
    second, second_r = std ** 2 + mean ** 2, std_r ** 2 + mean_r ** 2
    np.testing.assert_allclose(second, second_r, rtol=1e-6)
    carried = 1e-6 * second_r / (2 * std_r ** 2)
    assert np.all(np.abs(std - std_r) <= carried * std_r), (std, std_r)

    port.main(["--data-path", root, "--cache-size", "64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["mean: " + " ".join(f"{v:.4f}" for v in mean),
                     "std:  " + " ".join(f"{v:.4f}" for v in std)]


def test_demo_runs_at_a_toy_size(tmp_path, capsys):
    demo = _load("tools/demo_synthetic_e2e_torch.py", "demo_toy")
    res = demo.main(["--device", "cpu", "--data-n", "24", "--epochs", "1",
                     "--probe-epochs", "1", "--img-sz", "32",
                     "--full-pipeline", "--mlc-epochs", "1",
                     "--eval-epochs", "1", "--log-path",
                     str(tmp_path / "demo")])
    out = capsys.readouterr().out
    num = r"([0-9]+\.[0-9]{4})"
    forms = {
        "data": r"^data: train 16 / test 8$",
        "random": rf"^random-init probe: best val AUC_AVG {num} \(",
        "ssl": rf"^SSL-pretrained probe: best val AUC_AVG {num} \(",
        "result": rf"^RESULT: ssl {num} vs random {num} \((PASS|FAIL)\)$",
        "full": rf"^FULL-PIPELINE RESULT: supervised eval best AUC {num} vs "
                rf"linear probe {num} vs random {num} \(",
    }
    for key, form in forms.items():
        found = list(re.finditer(form, out, re.M))
        assert len(found) == 1, (key, out[-3000:])
        assert all(math.isfinite(float(v)) for v in found[0].groups()
                   if v not in ("PASS", "FAIL"))
    for key in ("auc_random", "auc_ssl", "auc_eval"):
        assert 0.0 <= res[key] <= 1.0
    assert len(res["ssl_losses"]) == 1
    assert all(math.isfinite(v) for v in res["ssl_losses"])
    assert set(res["seconds"]) == {"random-init probe", "ssl",
                                   "SSL-pretrained probe", "mlc", "eval"}


def test_compare_ssl_loss_reports_the_seed_table_keys(tmp_path,
                                                     monkeypatch, capsys):
    tool = _load("tools/compare_ssl_loss.py", "compare_toy")
    monkeypatch.setattr(tool, "DATA_N", 24)
    monkeypatch.setattr(tool, "IMG_SZ", 32)
    monkeypatch.setattr(tool, "BATCH", 8)
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # beside the suite's other workers
    try:
        out = tool.main(["torch", "3", "bf16", "--seed", "1", "--device",
                         "cpu", "--log-path", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(out) == {"package", "precision", "seed", "device",
                        "cudnn_tf32", "at", "L10", "losses"}
    assert (out["package"], out["precision"], out["seed"],
            out["device"]) == ("torch", "bf16", 1, "cpu")
    losses = out["losses"]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert out["at"] == {"0": losses[0], "2": losses[2]}
    assert out["L10"] == pytest.approx(sum(losses) / 3)
    # the marks and L10 of a longer run
    mark = tool.summarize([float(e) for e in range(200)])
    assert mark == {"at": {"0": 0.0, "50": 50.0, "100": 100.0,
                           "150": 150.0, "199": 199.0}, "L10": 194.5}


def test_demo_refuses_a_bn_stat_freq_above_one(tmp_path):
    """Under --arch-version trimodal, as the JAX package's trainer refuses
    it."""
    demo = _load("tools/demo_synthetic_e2e_torch.py", "demo_refuse")
    with pytest.raises(ValueError, match="--bn-stat-freq applies to the "
                       "dual-modal SSL step only"):
        demo.main(["--device", "cpu", "--bn-stat-freq", "4", "--data-n",
                   "24", "--arch-version", "trimodal", "--log-path",
                   str(tmp_path)])


def test_demo_takes_a_bn_stat_freq_above_one(tmp_path, capsys):
    """K = 2 at batch 8: each epoch's second step is the fast step."""
    from sm3x_torch.train import backbone_train

    demo = _load("tools/demo_synthetic_e2e_torch.py", "demo_bnfreq")
    made = []
    real = backbone_train.make_ssl_train_step

    def counted(*args, **kw):
        step = real(*args, **kw)
        kind = "fast" if kw.get("frozen_bn") else "standard"
        return lambda *a: made.append(kind) or step(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(backbone_train, "make_ssl_train_step", counted)
        res = demo.main(["--device", "cpu", "--data-n", "24", "--epochs", "2",
                         "--batch-size", "8", "--probe-epochs", "1",
                         "--img-sz", "32", "--bn-stat-freq", "2", "--lr",
                         "1e-5", "--log-path", str(tmp_path / "demo")])
    assert made == ["standard", "fast"] * 2
    assert len(res["ssl_losses"]) == 2
    assert all(math.isfinite(v) for v in res["ssl_losses"])
    assert 0.0 <= res["auc_ssl"] <= 1.0
    assert "RESULT: ssl " in capsys.readouterr().out


def test_recipe_summary_reads_the_stage_markers_and_the_logs(tmp_path):
    recipe = _load("tools/recipe_synthetic_torch.py", "recipe")
    ssl = tmp_path / "logs" / "backbone"
    mlc = tmp_path / "logs" / "mlc_train"
    for d, auc in ((ssl / "test_49", 0.64), (ssl / "test_99", 0.66),
                   (ssl / "control", 0.62), (mlc / "test_99", 0.67)):
        d.mkdir(parents=True)
        (d / "log.txt").write_text(f"x INFO: Best val AUC_AVG: {auc:.4f}\n")
    (ssl / "log.txt").write_text("x Epoch 0: loss 17.1800 (0.1 min)\n"
                                 "x Epoch 1: loss 14.7200 (0.1 min)\n")
    run_log = tmp_path / "run_torch.log"
    run_log.write_text("=== stage1_ssl:start 100 t ===\nnoise\n"
                       "=== stage1_ssl:end 460 t ===\n"
                       "=== stage1_eval:start 460 t ===\n")
    s = recipe.summarise(str(tmp_path), str(run_log))
    assert s["seconds"] == {"stage1_ssl": 360}
    assert (s["ssl_loss_first"], s["ssl_loss_last"], s["ssl_epochs"]) == (
        17.18, 14.72, 2)
    assert s["ssl_probes"][49] == 0.64 and s["ssl_probes"][149] is None
    assert (s["control"], s["best_ssl_probe"], s["best_stage2_eval"]) == (
        0.62, 0.66, 0.67)
    assert s["control_below_probe_below_eval"] is True
