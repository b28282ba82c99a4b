"""The port's stage-1 CLI end to end on the CPU: tools/backbone_train_torch.py
on a synthetic Derm7pt tree (resnet18, 32x32, batch 8, one epoch). It must
log a finite epoch loss and write a `ckp_0.pth` that loads strictly into
the port's model. The same for a ViT with --use-checkpoint flash, for
multi-crop (--data-name SevenPCSwavDataset) and for --arch-version trimodal
(the metadata vocabularies from the data, named in the log);
tools/transfer_probe_torch.py on a tiny ISIC17 tree prints finite AUCs and
refuses a bad --modality. Flags outside the slice are refused with a
message."""

import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sm3x_torch.models.simclr import build_ssl_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "backbone_train_torch.py")

COMMON = ["--data-name", "SevenPCBaseDataset", "--img-sz", "32", "32",
          "--cache-size", "48", "--mean", "0.78", "0.67", "0.60",
          "--std", "0.21", "0.25", "0.26", "-a", "resnet18", "--epochs", "1",
          "-b", "8", "--save-freq", "1", "--ckpt-freq", "100",
          "--arch-version", "v32", "--proj-dim", "16", "--temperature", "0.1",
          "-lr", "1e-4", "--world-size", "2", "--device", "cpu", "-j", "2"]


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, TOOL] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from sm3x.data.synthetic import make_fake_derm7pt

    root = tmp_path_factory.mktemp("torch7pc")
    make_fake_derm7pt(str(root), n_cases=32, img_size=56)
    return str(root)


def test_cli_trains_one_epoch_and_writes_a_strict_checkpoint(dataset,
                                                             tmp_path):
    log = str(tmp_path / "bk")
    res = _run(COMMON + ["--data-path", dataset, "--log-path", log],
               str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    m = re.search(r"Epoch 0: loss (\S+)", res.stdout)
    assert m and math.isfinite(float(m.group(1))), res.stdout[-3000:]
    assert float(m.group(1)) > 0  # 16 train cases at -b 8: two real steps
    assert os.path.exists(os.path.join(log, "configs.txt"))
    ckpt = torch.load(os.path.join(log, "ckp_0.pth"), weights_only=True)
    assert ckpt["epoch"] == 1
    model, _ = build_ssl_model("v32", "resnet18", 16)
    model.load_state_dict(ckpt["state_dict"], strict=True)


def test_cli_trains_multicrop_and_writes_a_strict_checkpoint(dataset,
                                                             tmp_path):
    log = str(tmp_path / "crop")
    res = _run(COMMON + ["--data-path", dataset, "--log-path", log,
                         "--data-name", "SevenPCSwavDataset", "--size-crops",
                         "32", "16", "--nmb-crops", "2", "2"], str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "multi-crop SSL: sizes (32, 16), counts (2, 2)" in res.stdout
    m = re.search(r"Epoch 0: loss (\S+)", res.stdout)
    assert m and math.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    ckpt = torch.load(os.path.join(log, "ckp_0.pth"), weights_only=True)
    model, _ = build_ssl_model("v32", "resnet18", 16)
    model.load_state_dict(ckpt["state_dict"], strict=True)


def test_cli_trains_trimodal_with_the_data_s_vocabularies(dataset, tmp_path):
    from sm3x_torch.models.trimodal import TriModalSimCLR

    log = str(tmp_path / "tri")
    res = _run(COMMON + ["--data-path", dataset, "--log-path", log,
                         "--arch-version", "trimodal"], str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    # the synthetic tree has one elevation, one sex and one location
    assert "trimodal metadata vocab sizes: (1, 1, 1)" in res.stdout
    m = re.search(r"Epoch 0: loss (\S+)", res.stdout)
    assert m and math.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    ckpt = torch.load(os.path.join(log, "ckp_0.pth"), weights_only=True)
    TriModalSimCLR("resnet18", 16, (1, 1, 1)).load_state_dict(
        ckpt["state_dict"], strict=True)


def test_transfer_probe_tool_prints_finite_aucs(tmp_path):
    from test_torch_transfer_probe import _make_isic

    root = tmp_path / "isic"
    root.mkdir()
    _make_isic(root)
    torch.manual_seed(0)
    model, _ = build_ssl_model("v32", "resnet18", 16)
    ckpt = str(tmp_path / "ckp_0.pth")
    torch.save({"epoch": 1, "state_dict": model.state_dict()}, ckpt)
    tool = os.path.join(REPO, "tools", "transfer_probe_torch.py")
    args = ["--pretrain-path", ckpt, "--data-path", str(root), "-a",
            "resnet18", "--img-sz", "32", "32", "-b", "8", "--epochs", "1",
            "--cache-size", "48", "--workers", "1", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, tool] + args, cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    best = eval(res.stdout.strip().splitlines()[-1])
    assert {"AUC_L0", "AUC_L1", "AUC_AVG", "loss"} <= set(best)
    assert all(math.isfinite(v) for v in best.values())
    assert 0.0 <= best["AUC_AVG"] <= 1.0
    bad = subprocess.run([sys.executable, tool] + args
                         + ["--modality", "nope"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert bad.returncode == 2 and "--modality" in bad.stderr


# one process is no grid of data x 2 model
NOT_DIVIDED = "--mesh-model 2 does not divide the 1 process"


@pytest.mark.parametrize("flag,said", [
    (["--arch-version", "trimodal", "--data-name", "SevenPCSwavDataset"],
     "are not combinable"),
    (["--data-name", "SevenPCSwavDataset", "--nmb-crops", "3", "6"],
     "--nmb-crops must start with 2"),
    # the JAX package's own refusal: the fast step is the dual-modal step's
    (["--arch-version", "trimodal", "--bn-stat-freq", "2"],
     "--bn-stat-freq applies to the dual-modal SSL step only"),
    # the data axis is the run's processes over --mesh-model, which must
    # divide them; --coordinator needs its two companions
    (["--mesh-data", "2", "--mesh-model", "2"], NOT_DIVIDED),
    (["--coordinator", "localhost:1234"], "needs --num-processes"),
    (["--data-name", "ISIC17Dataset"], "go to tools/transfer_probe_torch.py"),
    (["--mesh-model", "2"], NOT_DIVIDED),
    (["--data-name", "ISIC18Dataset"], "go to tools/transfer_probe_torch.py"),
    (["--ckpt-backend", "orbax"], "is not ported")])
def test_cli_refuses_flags_outside_the_slice(dataset, tmp_path, flag, said):
    res = _run(COMMON + ["--data-path", dataset, "--log-path",
                         str(tmp_path / "bk")] + flag, str(tmp_path))
    assert res.returncode != 0
    assert said in res.stdout + res.stderr


def test_cli_trains_a_vit_with_flash_attention(dataset, tmp_path):
    log = str(tmp_path / "vit")
    res = _run(COMMON + ["--data-path", dataset, "--log-path", log, "-a",
                         "vit_t16", "--use-checkpoint", "flash"],
               str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    m = re.search(r"Epoch 0: loss (\S+)", res.stdout)
    assert m and math.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    with open(os.path.join(log, "configs.txt")) as f:
        assert "flash" in f.read()
    ckpt = torch.load(os.path.join(log, "ckp_0.pth"), weights_only=True)
    model, _ = build_ssl_model("v32", "vit_t16", 16, remat="flash",
                               img_size=32)
    model.load_state_dict(ckpt["state_dict"], strict=True)


@pytest.mark.parametrize("flag,mode", [(False, "attn"), ("off", False),
                                       ("flash", "flash"), (True, True)])
def test_vit_trainer_resolves_use_checkpoint(tmp_path, flag, mode):
    """A ViT defaults to 'attn' and says so; 'off' saves everything."""
    import logging

    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.ops import attention
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "vit_t16", 16
    cfg.model.use_checkpoint = flag
    cfg.data.img_sz = (32, 32)
    cfg.run.device, cfg.run.log_path = "cpu", str(tmp_path)
    records = []
    logger = logging.getLogger(f"vit_remat_{flag}")
    logger.addHandler(logging.Handler())
    logger.handlers[-1].emit = records.append
    logger.setLevel(logging.INFO)
    trainer = SSLTrainer(cfg, logger=logger)
    assert trainer.remat == mode
    enc = trainer.model.derm_backbone.encoder
    assert enc.remat == mode
    want_fn = {"attn": attention.attention_remat,
               "flash": attention.flash_attention}.get(
                   mode, attention.attention_xla)
    assert enc.block0.attn.attn_fn is want_fn
    said = any("defaulting --use-checkpoint to 'attn'" in r.getMessage()
               for r in records)
    assert said == (flag is False)


# ---------------------------------------------------------------------------
# The feeds: the same samples at every step, whatever brings them
# ---------------------------------------------------------------------------

def _train_in_process(dataset, log, extra):
    from sm3x_torch.cli.apps import backbone_train_main

    argv = [a for a in COMMON] + ["--data-path", dataset, "--log-path", log]
    argv[argv.index("--epochs") + 1] = "2"
    argv[argv.index("--save-freq") + 1] = "2"
    backbone_train_main(argv + extra)
    return torch.load(os.path.join(log, "ckp_1.pth"), weights_only=True)


@pytest.fixture(scope="module")
def host_run(dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("feeds")
    state = _train_in_process(dataset, str(root / "host"),
                              ["--device-feed", "host"])
    shutil.rmtree(root, ignore_errors=True)   # ~0.3 GB a checkpoint
    return state


@pytest.mark.parametrize("name,flags", [
    ("resident", ["--device-feed", "resident"]),
    ("prefetch", ["--device-feed", "prefetch", "--prefetch-depth", "1"]),
    ("auto", []),
    ("streaming", ["--no-cache-images"]),
    ("streaming_host", ["--no-cache-images", "--device-feed", "host"])])
def test_every_feed_writes_a_bit_identical_checkpoint(dataset, tmp_path,
                                                      host_run, name, flags):
    """Two epochs of stage 1 (16 train cases at batch 8) under each feed
    against `--device-feed host`: model and optimizer state bit for bit."""
    got = _train_in_process(dataset, str(tmp_path / name), flags)
    assert got["epoch"] == host_run["epoch"] == 2
    assert list(got["state_dict"]) == list(host_run["state_dict"])
    for k, v in host_run["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    a, b = got["optimizer"]["state"], host_run["optimizer"]["state"]
    assert list(a) == list(b) and len(a) > 0
    for i in a:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[i][key], b[i][key]), (i, key)
    with open(os.path.join(tmp_path, name, "configs.txt")) as f:
        text = f.read()
    assert ("cache_images: False" in text) == name.startswith("streaming")
    shutil.rmtree(tmp_path / name, ignore_errors=True)


def test_cli_takes_the_flags_this_slice_ported(dataset, tmp_path):
    """--arch-weights <file>, --use-lr-schedule, --save-on-preempt and bare
    --use-checkpoint on a ResNet in one run."""
    from sm3x_torch.models.resnet import build_resnet

    weights = str(tmp_path / "r18.pth")
    torch.manual_seed(3)
    torch.save(build_resnet("resnet18", num_classes=10).state_dict(), weights)
    log = str(tmp_path / "flags")
    res = _run(COMMON + ["--data-path", dataset, "--log-path", log,
                         "--arch-weights", weights, "--use-lr-schedule",
                         "--warmup-epochs", "0", "--save-on-preempt",
                         "--use-checkpoint", "--ckpt-keep", "5"],
               str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = res.stdout + res.stderr
    assert "not in the PyTorch port yet" not in out
    assert f"initialized encoders from '{weights}'" in out
    assert "lr schedule: warmup 0 epochs" in out
    m = re.search(r"Epoch 0: loss (\S+)", out)
    assert m and math.isfinite(float(m.group(1)))
    assert os.path.exists(os.path.join(log, "ckp_0.pth"))
    shutil.rmtree(log, ignore_errors=True)   # ~0.3 GB


# ---------------------------------------------------------------------------
# Two processes joined by --coordinator (the twin of test_cli_multihost.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_step_dataset(tmp_path_factory):
    """8 train cases: one step of -b 8, so the epoch's loss is the first
    step's."""
    from sm3x.data.synthetic import make_fake_derm7pt

    root = tmp_path_factory.mktemp("torch7pc_one_step")
    make_fake_derm7pt(str(root), n_cases=16, img_size=56)
    return str(root)


def _epoch_loss(text: str) -> float:
    m = re.search(r"Epoch 0: loss (\S+)", text)
    assert m, text[-3000:]
    return float(m.group(1))


def test_two_processes_joined_by_coordinator_train_as_one(one_step_dataset,
                                                          tmp_path):
    """Two tools/backbone_train_torch.py processes on gloo: one run
    directory (log.txt, log.txt.rank1, one configs.txt), rank 0 alone on
    stdout, a ckp_0.pth with the keys of a one-process run, and the first
    step's loss at rtol 1e-4 of the one-process run's (float32; the
    float64 checks are in test_torch_multigpu.py)."""
    from sm3x_torch.parallel.launch import free_port

    args = COMMON + ["--data-path", one_step_dataset, "--print-freq", "1"]
    single = _run(args + ["--log-path", str(tmp_path / "one")], str(tmp_path))
    assert single.returncode == 0, single.stdout[-3000:] + single.stderr[-3000:]
    run = str(tmp_path / "two")
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, TOOL] + args + [
            "--log-path", run, "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(i)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert sorted(f for f in os.listdir(run) if not f.endswith(".pth")) == [
        "configs.txt", "log.txt", "log.txt.rank1"]
    assert not os.path.exists(run + "_2")   # one directory, chosen by rank 0
    assert "Epoch 0: loss" not in outs[1]
    with open(os.path.join(run, "log.txt.rank1")) as f:
        rank1 = _epoch_loss(f.read())
    rank0 = _epoch_loss(outs[0])
    assert rank0 == rank1
    np.testing.assert_allclose(rank0, _epoch_loss(single.stdout), rtol=1e-4)
    ckpt = torch.load(os.path.join(run, "ckp_0.pth"), weights_only=True)
    model, _ = build_ssl_model("v32", "resnet18", 16)
    model.load_state_dict(ckpt["state_dict"], strict=True)
