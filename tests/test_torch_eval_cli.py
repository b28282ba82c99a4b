"""The port's four stages in a chain, through their apps with in-process
`argv`, on a synthetic Derm7pt tree on the CPU (the chain of
tests/test_cli_smoke.py): stage 1 -> stage 2 -> mlc_eval --finetune
projector -> backbone_eval --finetune fc -> reproduce on the
`best_eval.pth`; `--linear-probe`; `--resume-path` for each of the four
trainers, bit-identical to an uninterrupted run; the synthetic source's
labels, mask, order and padding; the stat writer without its packages.

Sizes: resnet18, 32x32, batch 8, `--mlc-proj-dim 32`, `--sa-dim-ff 16`.
"""

import csv
import logging
import math
import os
import re
import shutil

import numpy as np
import pytest
import torch

from sm3x_torch import reproduce
from sm3x_torch.cli import apps
from sm3x_torch.core.config import EvalConfig, MLCTrainConfig, SSLConfig
from sm3x_torch.data.pipeline import iter_batch_selections
from sm3x_torch.data.synthetic import SyntheticPairedData
from sm3x_torch.models.baseline import Baseline
from sm3x_torch.models.mlc import MLCModel
from sm3x_torch.train.backbone_eval import BackboneEvalTrainer
from sm3x_torch.train.backbone_train import SSLTrainer
from sm3x_torch.train.mlc_eval import MLCEvalTrainer
from sm3x_torch.train.mlc_train import MLCTrainer
from sm3x_torch.utils.checkpoint import (export_backbone, load_encoder_state,
                                         load_pretrained_state,
                                         load_state_dict_file)
from sm3x_torch.utils.logging import (StatWriter, generate_stat_text,
                                      log_every_n, log_first_n)
from sm3x_torch.utils.misc import BestRecorder, create_eval_stat

torch.set_num_threads(2)

COMMON = ["--data-name", "SevenPCBaseDataset", "--img-sz", "32", "32",
          "--cache-size", "48", "--mean", "0.78", "0.67", "0.60", "--std",
          "0.21", "0.25", "0.26", "-a", "resnet18", "-b", "8", "--save-freq",
          "1", "--device", "cpu", "-j", "2"]
MLC = ["--mlc-proj", "v4", "--mlc-proj-dim", "32", "--num-heads", "1",
       "--sa-dim-ff", "16", "--sa-dropout", "0.1"]


def _log(path):
    with open(os.path.join(path, "log.txt")) as f:
        return f.read()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The four stages and reproduce, once; the tests read what they left."""
    from sm3x.data.synthetic import make_fake_derm7pt

    work = tmp_path_factory.mktemp("chain")
    root = str(work / "7pc")
    make_fake_derm7pt(root, n_cases=32, img_size=56)
    common = COMMON + ["--data-path", root]
    out = {k: str(work / k) for k in ("ssl", "mlc", "ev", "bke")}
    out["root"], out["common"], out["work"] = root, common, str(work)

    apps.backbone_train_main(common + [
        "--epochs", "1", "--arch-version", "v32", "--proj-dim", "16",
        "--temperature", "0.1", "-lr", "1e-4", "--world-size", "2",
        "--ckpt-freq", "1", "--linear-probe", "--probe-epochs", "2",
        "--log-path", out["ssl"]])
    ssl_ckpt = os.path.join(out["ssl"], "ckp_0.pth")
    apps.mlc_train_main(common + MLC + [
        "--epochs", "1", "--temperature", "1", "-lr", "1e-4",
        "--extractor-weights", ssl_ckpt, "--log-path", out["mlc"]])
    mlc_ckpt = os.path.join(out["mlc"], "ckp_0.pth")
    apps.mlc_eval_main(common + MLC + [
        "--epochs", "1", "-lr", "1e-3", "--finetune", "projector",
        "--train-sz", "32", "--test-sz", "32", "--pretrain-path", mlc_ckpt,
        "--log-path", out["ev"]])
    apps.backbone_eval_main(common + [
        "--epochs", "1", "-lr", "1e-3", "--finetune", "fc",
        "--pretrain-path", ssl_ckpt, "--log-path", out["bke"]])
    out["repro_csv"] = str(work / "repro.csv")
    with pytest.raises(SystemExit) as done:
        reproduce.main([
            "--pretrain-path", os.path.join(out["ev"], "best_eval.pth"),
            "--data-path", root, "--out", out["repro_csv"], "--compare",
            os.path.join(out["ev"], "results.csv"), "-a", "resnet18",
            "--mlc-proj-dim", "32", "--sa-dim-ff", "16", "-b", "8",
            "--test-sz", "32", "--cache-size", "48", "--mean", "0.78", "0.67",
            "0.60", "--std", "0.21", "0.25", "0.26", "--fp32", "--device",
            "cpu"])
    out["repro_rc"] = done.value.code
    yield out
    shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(autouse=True)
def drop_checkpoints(request):
    """A checkpoint of two resnet18 with AdamW's moments takes ~130 MB:
    remove those a test wrote once it has read them."""
    own = ("tmp_path" in request.fixturenames
           and request.getfixturevalue("tmp_path"))
    yield
    for path in own.rglob("*.pth") if own else ():
        path.unlink()


def _table(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], {r[0]: [float(v) for v in r[1:]] for r in rows[1:]}


@pytest.mark.parametrize("stage", ["ev", "bke"])
def test_eval_stage_writes_results_csv_in_the_released_layout(chain, stage):
    header, table = _table(os.path.join(chain[stage], "results.csv"))
    assert header[1] == "BWV-1" and header[-1] == "DIAG avg"
    assert header[-5:] == ["8 all avg", "8 avg", "7 all avg", "7 avg",
                           "DIAG avg"]
    assert list(table) == ["Acc", "AUC", "Recall", "Spec", "Prec"]
    assert all(len(v) == len(header) - 1 and all(
        math.isfinite(x) and 0 <= x <= 100 for x in v)
        for v in table.values())
    log = _log(chain[stage])
    assert "train 16 / test 8 images loaded." in log
    m = re.search(r"Best val AUC_AVG: (\S+)", log)
    assert m and 0 < float(m.group(1)) <= 1
    assert re.search(r"Epoch 0: train loss \S+, val AUC_AVG", log)
    assert "Wrote " in log and os.path.exists(
        os.path.join(chain[stage], "configs.txt"))


def test_mlc_eval_grafts_the_stage2_checkpoint(chain):
    log = _log(chain["ev"])
    assert "Loading pre-trained weights from" in log
    # a stage-2 file has no prototype bias, and nothing else is missing
    assert re.findall(r"Missing key in checkpoint: (\S+)", log) == [
        f"prototypes.{i}.bias" for i in range(8)]
    stage2 = load_pretrained_state(os.path.join(chain["mlc"], "ckp_0.pth"))
    best = torch.load(os.path.join(chain["ev"], "best_eval.pth"),
                      weights_only=True)
    assert set(best) == {"epoch", "state_dict", "best_val_auc"}
    assert best["epoch"] == 1 and 0 < best["best_val_auc"] <= 1
    assert "wrote " in log and "best_eval.pth" in log
    model = MLCModel("resnet18", proj_dim=32, sa_dim_ff=16,
                     use_prototype_bias=True)
    model.load_state_dict(best["state_dict"], strict=True)
    # projector policy: the extractor as stage 2 left it, statistics too;
    # the head moved
    for k, v in stage2.items():
        same = torch.equal(best["state_dict"][k], v)
        assert same == k.startswith("extractor."), k


def test_backbone_eval_keeps_the_stage1_encoders(chain):
    enc = load_encoder_state(os.path.join(chain["ssl"], "ckp_0.pth"))
    best = torch.load(os.path.join(chain["bke"], "best_eval.pth"),
                      weights_only=True)["state_dict"]
    Baseline("resnet18").load_state_dict(best, strict=True)
    assert len(enc) == 2 * 120  # two resnet18: every leaf and statistic
    for k, v in enc.items():
        assert torch.equal(best[k.replace(".encoder.", ".")], v), k
    assert float(best["classifier.0.weight"].abs().max()) > 0
    assert sorted(export_backbone(load_state_dict_file(
        os.path.join(chain["ssl"], "ckp_0.pth")))) == sorted(enc)


def test_reproduce_matches_the_eval_stage_s_csv(chain):
    assert chain["repro_rc"] == 0
    h1, ours = _table(chain["repro_csv"])
    h2, theirs = _table(os.path.join(chain["ev"], "results.csv"))
    assert h1 == h2
    for row in theirs:  # the same float32 forward of the same weights
        np.testing.assert_allclose(ours[row], theirs[row], atol=1e-3)


def test_reproduce_preflight_names_what_is_missing(tmp_path):
    with pytest.raises(SystemExit) as e:
        reproduce.main(["--pretrain-path", str(tmp_path / "no.pth"),
                        "--data-path", str(tmp_path), "--device", "cpu",
                        "--compare", str(tmp_path / "no.csv")])
    said = str(e.value.code)
    assert "--pretrain-path" in said and "meta.csv not found" in said
    assert "--compare" in said


def test_compare_csv_is_by_column_name(tmp_path):
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    open(a, "w").write(",x,y\nAUC,1.0,2.0\n")
    open(b, "w").write(",y,x\nAUC,2.1,1.0\n")
    assert reproduce.compare_csv(a, b, 0.2)[0] == 0
    n_bad, report = reproduce.compare_csv(a, b, 0.05)
    assert n_bad == 1 and report[0].startswith("AUC/y")
    open(b, "w").write(",x,z\nAUC,1.0,2.0\nAcc,0,0\n")
    n_bad, report = reproduce.compare_csv(a, b)
    assert n_bad == 3 and "MISSING column z" in report


def test_linear_probe_runs_after_stage1(chain):
    log = _log(chain["ssl"])
    assert "not in the PyTorch port yet" not in log
    epochs = re.findall(r"probe epoch (\d): loss (\S+) val AUC_AVG (\S+)", log)
    assert [e[0] for e in epochs] == ["0", "1"]
    assert all(math.isfinite(float(e[1])) and 0 <= float(e[2]) <= 1
               for e in epochs)
    m = re.search(r"linear probe best val AUC_AVG: (\S+)", log)
    assert m and float(m.group(1)) == max(float(e[2]) for e in epochs)


def test_cli_resumes_stage1_from_its_rolling_checkpoint(chain):
    log_path = os.path.join(chain["work"], "ssl_resumed")
    apps.backbone_train_main(chain["common"] + [
        "--epochs", "2", "--arch-version", "v32", "--proj-dim", "16",
        "--temperature", "0.1", "-lr", "1e-4", "--world-size", "2",
        "--ckpt-freq", "100", "--resume-path",
        os.path.join(chain["ssl"], "checkpoint.pth"), "--log-path", log_path])
    log = _log(log_path)
    assert "resumed from" in log and "(epoch 1)" in log
    assert "Epoch 1: loss" in log and "Epoch 0: loss" not in log
    assert torch.load(os.path.join(log_path, "ckp_1.pth"),
                      weights_only=True)["epoch"] == 2


# ---------------------------------------------------------------------------
# --resume-path: two epochs in one run, and one epoch, a resume and one more
# ---------------------------------------------------------------------------

def _cfg(kind, log_path, epochs):
    cfg = {"ssl": SSLConfig, "mlc": MLCTrainConfig, "mlc_eval": EvalConfig,
           "backbone_eval": EvalConfig}[kind]()
    m = cfg.model
    m.arch, m.proj_dim, m.mlc_proj_dim, m.sa_dim_ff = "resnet18", 16, 32, 16
    m.finetune = "projector" if kind == "mlc_eval" else "all"
    cfg.data.img_sz = (32, 32)
    if kind.endswith("eval"):
        cfg.train_sz = cfg.test_sz = 32
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, epochs, False
    cfg.optim.base_lr = 1e-3
    cfg.run.device, cfg.run.log_path, cfg.run.world_size = "cpu", log_path, 2
    cfg.run.ckpt_freq, cfg.run.save_freq = 1, 100
    os.makedirs(log_path, exist_ok=True)
    return cfg


def _quiet(name):
    logger = logging.getLogger(name)
    logger.handlers, logger.propagate = [], False
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    return logger, lines


TRAINERS = {"ssl": SSLTrainer, "mlc": MLCTrainer, "mlc_eval": MLCEvalTrainer,
            "backbone_eval": BackboneEvalTrainer}


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, kind):
    train = SyntheticPairedData(16, canvas=40, seed=0)
    val = SyntheticPairedData(12, canvas=40, seed=3)
    data = (train, val) if kind.endswith("eval") else (train,)

    def run(tag, epochs, resume=None):
        logger, lines = _quiet(f"resume_{kind}_{tag}")
        trainer = TRAINERS[kind](_cfg(kind, str(tmp_path / tag), epochs),
                                 logger=logger)
        assert trainer.resume(resume) == (resume is not None)
        result = trainer.fit(*data)
        return trainer, lines, result

    whole, _, want = run("whole", 2)
    run("first", 1)
    ckpt = str(tmp_path / "first" / "checkpoint.pth")
    resumed, lines, got = run("second", 2, resume=ckpt)

    assert resumed.start_epoch == 1
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = (t.optimizer.state_dict()["state"] for t in (whole, resumed))
    assert list(sa) == list(sb) and len(sa) > 0
    for i in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)
    if kind == "mlc":
        # the bank came with the checkpoint: no second init pass
        assert torch.equal(whole.bank, resumed.bank)
        assert not any("Initializion of the memory banks" in ln
                       for ln in lines)
        assert any("Clustering for epoch 1 done." in ln for ln in lines)
        assert not any("Clustering for epoch 0" in ln for ln in lines)
        assert [h["step_losses"] for h in got] == [want[1]["step_losses"]]
    elif kind == "ssl":
        assert [h["step_losses"] for h in got] == [want[1]["step_losses"]]
    else:
        assert got == want and resumed.best_auc == whole.best_auc
        saved = torch.load(ckpt, weights_only=True)
        assert 0 <= saved["best_val_auc"] <= want


def test_resume_needs_its_file(tmp_path):
    trainer = SSLTrainer(_cfg("ssl", str(tmp_path), 1),
                         logger=_quiet("resume_missing")[0])
    assert trainer.resume() is False and trainer.start_epoch == 0
    with pytest.raises(FileNotFoundError, match="cannot find checkpoint"):
        trainer.resume(str(tmp_path / "checkpoint.pth"))
    trainer.cfg.run.resume_path = str(tmp_path / "nor_this.pth")
    with pytest.raises(FileNotFoundError):
        trainer.resume()


# ---------------------------------------------------------------------------
# The synthetic source: labels, mask, order, padding
# ---------------------------------------------------------------------------

def test_synthetic_source_carries_labels_mask_and_padding():
    from sm3x.data.synthetic import synthetic_canvas_batch as jax_synth

    data = SyntheticPairedData(10, canvas=40, seed=7)
    np.testing.assert_array_equal(data.labels, jax_synth(10, 40, 7)[2])
    assert data.labels.shape == (10, 8) and data.labels.dtype == np.int32
    batches = list(data.batches(4, epoch=0, shuffle=False))
    assert data.steps_per_epoch(4) == len(batches) == 3
    order = np.concatenate([b.index for b in batches])
    np.testing.assert_array_equal(order[:10], np.arange(10))
    np.testing.assert_array_equal(order[10:], [0, 1])  # wrapped
    last = batches[-1]
    np.testing.assert_array_equal(last.mask, [True, True, False, False])
    assert all(b.mask.all() for b in batches[:2])
    for b in batches:
        np.testing.assert_array_equal(b.label, data.labels[b.index])
        np.testing.assert_array_equal(b.derm, data.derm[b.index])
        np.testing.assert_array_equal(b.clinic_hw, data.clinic_hw[b.index])
        assert b.derm.shape == (4, 40, 40, 3)
    # the selections are the dataset pipeline's
    sels = list(iter_batch_selections(np.arange(10), 4))
    assert all(np.array_equal(s, b.index) and np.array_equal(m, b.mask)
               for (s, m), b in zip(sels, batches))


@pytest.mark.parametrize("n,batch", [(16, 8), (10, 4)])
def test_synthetic_full_batches_of_a_shuffled_epoch_are_unchanged(n, batch):
    """The full batches are the ones the first version of the source made:
    slices of `default_rng(seed + epoch).permutation(n)`."""
    data = SyntheticPairedData(n, canvas=24, seed=1)
    for epoch in (0, 3):
        order = np.random.default_rng(3407 + epoch).permutation(n)
        got = list(data.batches(batch, epoch, 3407))
        for k in range(n // batch):
            sel = order[k * batch:(k + 1) * batch]
            np.testing.assert_array_equal(got[k].index, sel)
            np.testing.assert_array_equal(got[k].derm, data.derm[sel])
            assert got[k].mask.all() and got[k].index.dtype == np.int32
    a = [b.index for b in data.batches(batch, 1)]
    b = [b.index for b in data.batches(batch, 2)]
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Stat writer and helpers
# ---------------------------------------------------------------------------

def test_stat_writer_without_its_packages_logs_and_never_raises(
        tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_sinks(name, *a, **kw):
        if name == "wandb" or name.startswith("torch.utils.tensorboard"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sinks)
    logger, lines = _quiet("stat_writer")
    for _ in range(2):
        writer = StatWriter(str(tmp_path), tensorboard=True, wandb=True,
                            logger=logger)
    assert writer.tb is None and writer.wb is None
    said = [ln for ln in lines if "cannot be used here" in ln]
    assert len(said) == 2 and "--tensorboard" in said[0] \
        and "--wandb" in said[1]                       # once each
    writer.define_summaries({"val/AUC_AVG": "max"})
    writer.log({"loss": 0.5, "AUC_AVG": 0.25}, 3, "val/")
    assert "stats step 3: val/loss 0.5000, val/AUC_AVG 0.2500" in lines
    writer.close()
    silent = StatWriter(str(tmp_path))                 # nothing asked for
    silent.log({"loss": 1.0}, 0)
    assert len(lines) == 3


def test_trainers_take_tensorboard_and_wandb_flags(tmp_path):
    cfg = _cfg("ssl", str(tmp_path), 1)
    cfg.run.wandb = True  # not installed here: the log file gets the stats
    logger, lines = _quiet("ssl_wandb")
    hist = SSLTrainer(cfg, logger=logger).fit(
        SyntheticPairedData(8, canvas=40, seed=0))
    assert any(ln.startswith("stats step 0: train/loss") for ln in lines)
    assert math.isfinite(hist[0]["loss"])


def test_log_helpers_and_summary_table():
    logger, lines = _quiet("helpers")
    for i in range(5):
        log_first_n(logger, "first", 2, key="t-first")
        log_every_n(logger, f"every {i}", 2, key="t-every")
    assert lines.count("first") == 2
    assert [ln for ln in lines if ln.startswith("every")] == [
        "every 0", "every 2", "every 4"]
    rec = BestRecorder("max")
    assert rec.update(0.5) == (0.5, True) and rec.update(0.25) == (0.5, False)
    low = BestRecorder("min")
    assert low.update(2.0)[1] and low.update(1.0) == (1.0, True)
    with pytest.raises(ValueError):
        BestRecorder("best")
    stat = create_eval_stat("val", ["AUC"], ["DIAG", "PN"], "max")
    assert stat == {"val/AUC_DIAG": "max", "val/AUC_PN": "max",
                    "val/AUC_AVG": "max"}
    summary = {f"{p}/{k}": BestRecorder("max", 0.75)
               for p in ("train", "val")
               for k in ("AUC_DIAG", "AUC_PN", "AUC_AVG")}
    cur = {"AUC_DIAG": 0.5, "AUC_PN": 0.25, "AUC_AVG": 0.375}
    text = generate_stat_text(cur, cur, summary, ["AUC"], ["DIAG", "PN"])
    assert text.splitlines()[1] == "AUC_DIAG: 0.5000/0.7500 | 0.5000/0.7500"
    assert len(text.splitlines()) == 4
