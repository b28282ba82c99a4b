"""What the port's trainers share around their loops, against the JAX
package: the warm-up / cosine schedule step by step against optax (rtol
1e-6), stage 2 warning about --use-lr-schedule and training on, checkpoints
written off the loop's thread from a snapshot, SIGTERM turned into a
checkpoint and a clean break, --arch-weights from a torchvision-layout state
dict against `sm3x.utils.torch_convert.convert_resnet`, per-block remat of a
ResNet (exact in float64) and the bilinear pos_embed resize of the ViT
against the Flax ViT (atol 1e-5), and stage 2 and both eval stages under
--data-name SevenPCSwavDataset exactly as under SevenPCBaseDataset (the
reference's alias). All on the CPU at resnet18 / 32x32.
"""

import hashlib
import logging
import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.models import vit as jax_vit
from sm3x.train import common as ref_common
from sm3x.utils import torch_convert
from sm3x_torch.core.config import EvalConfig, MLCTrainConfig, SSLConfig
from sm3x_torch.data.synthetic import SyntheticPairedData
from sm3x_torch.models import backbones
from sm3x_torch.models.layers import BatchNorm, recomputing
from sm3x_torch.models.vit import ViT
from sm3x_torch.train import common
from sm3x_torch.train.backbone_eval import BackboneEvalTrainer
from sm3x_torch.train.backbone_train import SSLTrainer
from sm3x_torch.train.mlc_eval import MLCEvalTrainer
from sm3x_torch.train.mlc_train import MLCTrainer
from sm3x_torch.utils import weight_registry, weights
from sm3x_torch.utils.weight_registry import (DEFAULTS, WEIGHTS, WeightSpec,
                                              resolve_arch_weights,
                                              verify_weight_file)

from torch_ref import randomize_bn_stats, torch_resnet18

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """The checkpoints these tests write are hundreds of MB each: give the
    space back after every test, not when pytest prunes its old runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(kind, log_path, epochs=2):
    cfg = {"ssl": SSLConfig, "mlc": MLCTrainConfig, "mlc_eval": EvalConfig,
           "backbone_eval": EvalConfig}[kind]()
    m = cfg.model
    m.arch, m.proj_dim, m.mlc_proj_dim, m.sa_dim_ff = "resnet18", 16, 32, 16
    m.finetune = "all"
    cfg.data.img_sz = (32, 32)
    if kind.endswith("eval"):
        cfg.train_sz = cfg.test_sz = 32
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, epochs, False
    cfg.optim.base_lr = 1e-3
    cfg.run.device, cfg.run.log_path, cfg.run.world_size = "cpu", log_path, 2
    cfg.run.ckpt_freq, cfg.run.save_freq = 100, 100
    os.makedirs(log_path, exist_ok=True)
    return cfg


def _quiet(name):
    logger = logging.getLogger(name)
    logger.handlers, logger.propagate = [], False
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append((r.levelname, r.getMessage()))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    return logger, lines


def _data(n=16, seed=0):
    return SyntheticPairedData(n, canvas=40, seed=seed)


# ---------------------------------------------------------------------------
# --use-lr-schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,final,start", [
    (10, 0.0, 0.0), (1, 1e-5, 1e-4), (0, 0.0, 0.0), (0, 3e-4, 0.5)])
def test_schedule_factor_equals_optax_at_every_step(warmup, final, start):
    base, epochs, spe = 3e-3, 40, 7
    ref = ref_common.warmup_cosine_schedule(base, final, warmup, epochs, spe,
                                            start)
    factor = common.warmup_cosine_factor(base, final, warmup, epochs, spe,
                                         start)
    steps = np.arange(epochs * spe + 5)   # and past the end
    # optax in float64: in float32 its own rounding is 1e-6 of the lr in
    # the warm-up, and more where the cosine nears zero
    with jax.enable_x64(True):
        want = np.asarray([float(ref(int(s))) for s in steps])
    got = np.asarray([base * factor(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("warmup", [1, 0])
def test_trainer_lr_follows_the_optax_schedule(tmp_path, warmup):
    """The lr that every step of 3 epochs trains at."""
    cfg = _cfg("ssl", str(tmp_path), epochs=3)
    o = cfg.optim
    o.use_lr_schedule, o.warmup_epochs = True, warmup
    o.final_lr, o.start_warmup = 1e-5, 1e-4
    logger, lines = _quiet(f"sched_{warmup}")
    trainer = SSLTrainer(cfg, logger=logger)
    seen = []
    step = trainer.train_step

    def recording(*a):
        seen.append(trainer.optimizer.param_groups[0]["lr"])
        return step(*a)

    trainer.train_step = recording
    trainer.fit(_data())
    ref = ref_common.warmup_cosine_schedule(
        o.base_lr, o.final_lr, warmup, 3, 2, o.start_warmup)
    assert len(seen) == 6
    np.testing.assert_allclose(seen, [float(ref(s)) for s in range(6)],
                               rtol=1e-6)
    assert seen[0] == pytest.approx(1e-4 if warmup else 1e-3, rel=1e-6)
    assert any(f"lr schedule: warmup {warmup} epochs" in ln
               for _, ln in lines)


def test_schedule_is_refused_on_a_resumed_run(tmp_path):
    cfg = _cfg("ssl", str(tmp_path), epochs=2)
    cfg.run.ckpt_freq = 1
    trainer = SSLTrainer(cfg, logger=_quiet("sched_resume_a")[0])
    trainer.cfg.optim.epochs = 1
    trainer.fit(_data())
    cfg2 = _cfg("ssl", str(tmp_path / "b"), epochs=2)
    cfg2.optim.use_lr_schedule = True
    resumed = SSLTrainer(cfg2, logger=_quiet("sched_resume_b")[0])
    assert resumed.resume(str(tmp_path / "checkpoint.pth"))
    with pytest.raises(ValueError, match="--use-lr-schedule cannot resume "
                       "mid-run: the schedule count restarts at 0"):
        resumed.fit(_data())


def test_stage2_warns_about_the_schedule_and_trains(tmp_path):
    """The JAX package's stage 2 warns and trains at a constant lr
    (sm3x/train/mlc_train.py:276); the port raised here."""
    cfg = _cfg("mlc", str(tmp_path), epochs=1)
    cfg.optim.use_lr_schedule = True
    logger, lines = _quiet("mlc_sched")
    trainer = MLCTrainer(cfg, logger=logger)
    hist = trainer.fit(_data())
    assert np.isfinite(hist[0]["loss"])
    said = [ln for lvl, ln in lines if lvl == "WARNING"]
    assert any("--use-lr-schedule is only consumed by backbone_train" in ln
               for ln in said)
    assert trainer.optimizer.param_groups[0]["lr"] == cfg.optim.base_lr


def test_eval_stage_warns_about_the_schedule_and_trains(tmp_path):
    cfg = _cfg("backbone_eval", str(tmp_path), epochs=1)
    cfg.optim.use_lr_schedule = True
    logger, lines = _quiet("eval_sched")
    BackboneEvalTrainer(cfg, logger=logger).fit(_data(), _data(8, 3))
    assert any("this stage ignores it" in ln for lvl, ln in lines
               if lvl == "WARNING")


# ---------------------------------------------------------------------------
# --data-name SevenPCSwavDataset beyond stage 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def derm7pt_tree(tmp_path_factory):
    from sm3x.data.synthetic import make_fake_derm7pt

    root = tmp_path_factory.mktemp("swav7pc")
    make_fake_derm7pt(str(root), n_cases=24, img_size=48)
    return str(root)


@pytest.mark.parametrize("kind", ["mlc", "mlc_eval", "backbone_eval"])
def test_stage2_and_eval_take_the_multicrop_dataset_name(tmp_path,
                                                         derm7pt_tree, kind):
    """The reference's SevenPCSwavDataset is SevenPCBaseDataset under
    another name (sm3x/data/datasets.py:42): only stage 1 reads the name.
    Stage 2 and the eval stages build it and augment it per modality, so a
    run on it equals a run on SevenPCBaseDataset from the same seed: the
    same batches, losses and weights, exactly. The port refused the name
    here."""
    from sm3x_torch.data.datasets import build_dataset

    splits = {name: [build_dataset(name, derm7pt_tree, mode, cache_size=40,
                                   workers=1) for mode in ("train", "test")]
              for name in ("SevenPCBaseDataset", "SevenPCSwavDataset")}
    for a, b in zip(*(list(splits[n][0].batches(8, 0, 0)) for n in splits)):
        for field in ("derm", "derm_hw", "clinic", "clinic_hw", "label",
                      "index", "mask", "meta"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    runs = {}
    for name, (train, test) in splits.items():
        cfg = _cfg(kind, str(tmp_path / name), epochs=1)
        cfg.data.data_name = name
        torch.manual_seed(0)
        if kind == "mlc":
            trainer = MLCTrainer(cfg, logger=_quiet(f"j1_{kind}")[0])
            result = trainer.fit(train)[0]["loss"]
        else:
            make = MLCEvalTrainer if kind == "mlc_eval" else BackboneEvalTrainer
            trainer = make(cfg, logger=_quiet(f"j1_{kind}")[0])
            result = trainer.fit(train, test)
        runs[name] = (result, {k: v.clone() for k, v in
                               trainer.model.state_dict().items()})
    (loss_a, sd_a), (loss_b, sd_b) = runs.values()
    assert np.isfinite(loss_a) and loss_a == loss_b
    assert sd_a.keys() == sd_b.keys()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


# ---------------------------------------------------------------------------
# save_async / flush_saves / finish_checkpoints
# ---------------------------------------------------------------------------

def _one_step(trainer, data, it=0):
    batch = next(iter(data.batches(8, 0, 0)))
    trainer.train_step(*(trainer._upload(x) for x in (
        batch.derm, batch.derm_hw, batch.clinic, batch.clinic_hw)), 100 + it)


def _equal_state(a: dict, b: dict) -> bool:
    flat_a, flat_b = [], []
    common.map_tensors(flat_a.append, a)
    common.map_tensors(flat_b.append, b)
    return (len(flat_a) == len(flat_b) > 0 and
            all(torch.equal(x, y) for x, y in zip(flat_a, flat_b)))


def test_async_save_writes_the_snapshot_not_the_live_weights(tmp_path,
                                                             monkeypatch):
    trainer = SSLTrainer(_cfg("ssl", str(tmp_path)),
                         logger=_quiet("async_a")[0])
    data = _data()
    _one_step(trainer, data)
    # on the CPU `state_dict` shares the live tensors' memory: copy it
    want = common.map_tensors(torch.clone, trainer.state_dict(0))
    gate = threading.Event()
    write = common.write_checkpoint

    def held(paths, state):
        gate.wait(10)       # the loop steps on while the write is held
        write(paths, state)

    monkeypatch.setattr(common, "write_checkpoint", held)
    path = str(tmp_path / "ckp_0.pth")
    trainer.save_async(path, 0)
    try:
        for it in (1, 2):
            _one_step(trainer, data, it)
        assert not _equal_state(trainer.state_dict(0), want)
        assert not os.path.exists(path)
    finally:
        gate.set()
    trainer.finish_checkpoints()
    assert trainer._save_thread is None
    got = torch.load(path, weights_only=True)
    assert got["epoch"] == 1 and set(got) == {"epoch", "state_dict",
                                               "optimizer"}
    assert _equal_state(got, want)
    assert not os.path.exists(path + ".tmp")


def test_two_paths_share_one_fetch_and_one_save_is_in_flight(tmp_path,
                                                             monkeypatch):
    trainer = SSLTrainer(_cfg("ssl", str(tmp_path)),
                         logger=_quiet("async_b")[0])
    calls, running = [], []
    write = common.write_checkpoint

    def counting(paths, state):
        running.append(threading.current_thread().name)
        assert len([t for t in threading.enumerate()
                    if t.name == "sm3x-torch-save"]) == 1
        calls.append(list(paths))
        time.sleep(0.05)
        write(paths, state)

    monkeypatch.setattr(common, "write_checkpoint", counting)
    a, b, c = (str(tmp_path / n) for n in ("ckp_0.pth", "checkpoint.pth",
                                           "ckp_1.pth"))
    trainer.save_async([a, b], 0)
    trainer.save_async(c, 1)     # waits for the first
    assert os.path.exists(a) and os.path.exists(b)
    trainer.flush_saves()
    assert calls == [[a, b], [c]]            # one fetch for the two paths
    assert running == ["sm3x-torch-save"] * 2
    fa, fb = (torch.load(p, weights_only=True) for p in (a, b))
    assert _equal_state(fa, fb) and fa["epoch"] == fb["epoch"] == 1
    assert torch.load(c, weights_only=True)["epoch"] == 2


def test_epoch_checkpoint_makes_one_save_of_both_files(tmp_path, monkeypatch):
    cfg = _cfg("ssl", str(tmp_path), epochs=2)
    cfg.run.ckpt_freq, cfg.run.save_freq = 1, 2
    trainer = SSLTrainer(cfg, logger=_quiet("async_c")[0])
    calls = []
    write = common.write_checkpoint
    monkeypatch.setattr(common, "write_checkpoint",
                        lambda paths, state: (calls.append(
                            [os.path.basename(p) for p in paths]),
                            write(paths, state)))
    trainer.fit(_data())
    assert calls == [["checkpoint.pth"], ["ckp_1.pth", "checkpoint.pth"]]
    assert trainer._save_thread is None
    files = [torch.load(str(tmp_path / n), weights_only=True)
             for n in ("ckp_1.pth", "checkpoint.pth")]
    assert _equal_state(*files)
    assert _equal_state(files[0], trainer.state_dict(1))


def test_a_failed_write_is_raised_by_flush(tmp_path, monkeypatch):
    trainer = SSLTrainer(_cfg("ssl", str(tmp_path)),
                         logger=_quiet("async_d")[0])

    def broken(paths, state):
        raise OSError("disk full")

    monkeypatch.setattr(common, "write_checkpoint", broken)
    trainer.save_async(str(tmp_path / "x.pth"), 0)
    with pytest.raises(OSError, match="disk full"):
        trainer.flush_saves()
    trainer.flush_saves()   # raised once


def test_stage2_checkpoint_carries_the_bank_as_it_was(tmp_path):
    cfg = _cfg("mlc", str(tmp_path), epochs=1)
    cfg.run.ckpt_freq = 1
    trainer = MLCTrainer(cfg, logger=_quiet("async_e")[0])
    trainer.fit(_data())
    saved = torch.load(str(tmp_path / "checkpoint.pth"), weights_only=True)
    assert torch.equal(saved["bank"], trainer.bank)
    assert saved["bank"].device.type == "cpu"


# ---------------------------------------------------------------------------
# --save-on-preempt
# ---------------------------------------------------------------------------

def _signal_after_epoch(trainer, when=1):
    """SIGTERM to this process at the end of epoch `when`'s training: the
    handler runs in the main thread well before the epoch-boundary poll."""
    if hasattr(trainer, "train_epoch"):
        orig = trainer.train_epoch

        def epoch_then_signal(d, epoch):
            stat = orig(d, epoch)
            if epoch == when:
                os.kill(os.getpid(), signal.SIGTERM)
            return stat

        trainer.train_epoch = epoch_then_signal
    else:
        seen = []                   # the eval trainers' loop is shared
        step = trainer.train_step

        def step_then_signal(*a):
            out = step(*a)
            seen.append(1)
            if len(seen) == 2 * (when + 1):   # 2 steps an epoch
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        trainer.train_step = step_then_signal


@pytest.mark.parametrize("kind", ["ssl", "backbone_eval"])
def test_sigterm_checkpoints_and_breaks(tmp_path, kind):
    cls = {"ssl": SSLTrainer, "backbone_eval": BackboneEvalTrainer}[kind]
    data = (_data(),) if kind == "ssl" else (_data(), _data(8, 3))
    cfg = _cfg(kind, str(tmp_path), epochs=6)
    cfg.run.save_on_preempt = True    # ckpt_freq 100: only the signal saves
    logger, lines = _quiet(f"preempt_{kind}")
    trainer = cls(cfg, logger=logger)
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    _signal_after_epoch(trainer)
    try:
        trainer.fit(*data)
        after = {s: signal.getsignal(s) for s in prev}
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    assert trainer._preempt_signal == signal.SIGTERM
    roll = os.path.join(cfg.run.log_path, "checkpoint.pth")
    assert os.path.isfile(roll), "preemption must force the rolling save"
    assert not trainer._orig_handlers and after == prev
    assert any(f"preemption signal {int(signal.SIGTERM)} caught: epoch 1 "
               f"state saved; resume with --resume-path {roll}" in ln
               for lvl, ln in lines if lvl == "WARNING")
    if kind == "backbone_eval":
        assert os.path.isfile(os.path.join(cfg.run.log_path,
                                           "best_eval.pth"))
    fresh = cls(_cfg(kind, str(tmp_path / "again"), epochs=3),
                logger=_quiet(f"preempt_{kind}_2")[0])
    assert fresh.resume(roll)
    assert fresh.start_epoch == 2, "epochs 2..5 must not have run"
    fresh.fit(*data)    # and the run goes on to its end


def test_second_signal_finds_the_default_disposition(tmp_path):
    cfg = _cfg("ssl", str(tmp_path), epochs=1)
    cfg.run.save_on_preempt = True
    trainer = SSLTrainer(cfg, logger=_quiet("preempt_twice")[0])
    prev = signal.getsignal(signal.SIGINT)
    try:
        trainer.install_preemption_handler()
        handler = signal.getsignal(signal.SIGINT)
        assert handler is not prev
        handler(signal.SIGINT, None)
        assert trainer._preempt_signal == signal.SIGINT
        assert signal.getsignal(signal.SIGINT) == signal.SIG_DFL
        trainer.uninstall_preemption_handler()
        assert signal.getsignal(signal.SIGINT) is prev
    finally:
        signal.signal(signal.SIGINT, prev)


def test_no_handler_without_flag_or_off_the_main_thread(tmp_path):
    cfg = _cfg("ssl", str(tmp_path), epochs=1)
    prev = signal.getsignal(signal.SIGTERM)
    trainer = SSLTrainer(cfg, logger=_quiet("preempt_off")[0])
    try:
        trainer.install_preemption_handler()
        assert signal.getsignal(signal.SIGTERM) is prev
        assert not trainer.preemption_break(0)
        cfg.run.save_on_preempt = True
        logger, lines = _quiet("preempt_thread")
        trainer.logger = logger
        t = threading.Thread(target=trainer.install_preemption_handler)
        t.start()
        t.join()
        assert signal.getsignal(signal.SIGTERM) is prev
        assert any("--save-on-preempt ignored: trainer not in the main "
                   "thread" in ln for _, ln in lines)
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# --arch-weights and the weight registry
# ---------------------------------------------------------------------------

def test_registry_equals_the_jax_package_s():
    from sm3x.utils import weight_registry as ref

    assert {k: (v.url, v.num_params, v.acc1) for k, v in WEIGHTS.items()} \
        == {k: (v.url, v.num_params, v.acc1) for k, v in ref.WEIGHTS.items()}
    assert DEFAULTS == ref.DEFAULTS
    s = WEIGHTS[("resnet50", "IMAGENET1K_V1")]
    assert s.filename == "resnet50-0676ba61.pth"
    assert s.sha256_prefix == "0676ba61" and s.num_params == 25557032


def test_verify_weight_file(tmp_path, monkeypatch):
    p = tmp_path / "weights.pth"
    p.write_bytes(b"not really a state dict")
    sha8 = hashlib.sha256(b"not really a state dict").hexdigest()[:8]
    verify_weight_file(str(p), WeightSpec(
        f"https://example.com/models/fake-{sha8}.pth", 1, 0.0))
    bad = WeightSpec("https://example.com/models/fake-00000000.pth", 1, 0.0)
    with pytest.raises(ValueError, match="integrity check failed"):
        verify_weight_file(str(p), bad)
    monkeypatch.setenv("SM3X_SKIP_WEIGHT_VERIFY", "1")
    verify_weight_file(str(p), bad)


def test_resolve_enum_name_from_staged_dir(tmp_path, monkeypatch):
    staged = tmp_path / "resnet50-0676ba61.pth"
    staged.write_bytes(b"fake")
    monkeypatch.setenv("SM3X_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("SM3X_SKIP_WEIGHT_VERIFY", "1")
    assert resolve_arch_weights("IMAGENET1K_V1", "resnet50") == str(staged)
    with pytest.raises(FileNotFoundError, match="resnet50-11ad3fa6.pth"):
        resolve_arch_weights("DEFAULT", "resnet50")
    monkeypatch.delenv("SM3X_SKIP_WEIGHT_VERIFY")
    with pytest.raises(ValueError, match="integrity check failed"):
        resolve_arch_weights("IMAGENET1K_V1", "resnet50")


def test_resolve_path_passthrough_and_unknown(tmp_path):
    p = tmp_path / "my_weights.pth"
    p.write_bytes(b"x")
    assert resolve_arch_weights(str(p), "resnet50") == str(p)
    with pytest.raises(FileNotFoundError, match="is neither a file nor a "
                       "weight enum for resnet50"):
        resolve_arch_weights(str(tmp_path / "nope.pth"), "resnet50")
    with pytest.raises(FileNotFoundError, match="download.pytorch.org"):
        resolve_arch_weights("IMAGENET1K_V1", "resnet18")
    assert weight_registry.sha256_prefix(str(p)) == hashlib.sha256(
        b"x").hexdigest()[:8]


def test_arch_weights_bootstrap_equals_convert_resnet(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tm = torch_resnet18(num_classes=10)      # with an fc, which is dropped
    randomize_bn_stats(tm, gen)
    path = os.path.join(tmp_path, "r18.pth")
    torch.save(tm.state_dict(), path)
    cfg = _cfg("ssl", str(tmp_path))
    cfg.model.arch_weights = path
    logger, lines = _quiet("arch_weights")
    trainer = SSLTrainer(cfg, logger=logger)
    assert any(ln == f"initialized encoders from '{path}' "
               f"(--arch-weights {path})" for _, ln in lines)
    # the JAX package's conversion of the same file, back in torch's layout
    params, stats = torch_convert.convert_resnet(
        torch_convert.load_torch_state_dict(path), "resnet18")
    want = weights.to_tensors(weights.resnet_state_dict(params, stats, ""))
    for branch in (trainer.model.derm_backbone, trainer.model.clinic_backbone):
        got = branch.encoder.state_dict()
        assert not any(k.startswith("fc.") for k in got)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        assert set(got) - set(want) <= {k for k in got
                                        if k.endswith("num_batches_tracked")}
    # the projectors keep their own initialisation
    plain = SSLTrainer(_cfg("ssl", str(tmp_path)),
                       logger=_quiet("arch_weights_0")[0])
    assert torch.equal(
        trainer.model.derm_backbone.projector.state_dict()["0.weight"],
        plain.model.derm_backbone.projector.state_dict()["0.weight"])
    assert not torch.equal(trainer.model.derm_backbone.encoder.conv1.weight,
                           plain.model.derm_backbone.encoder.conv1.weight)


def test_arch_weights_missing_file_errors_with_help(tmp_path):
    cfg = _cfg("ssl", str(tmp_path))
    cfg.model.arch, cfg.model.arch_weights = "resnet50", "IMAGENET1K_V1"
    with pytest.raises(FileNotFoundError, match="resnet50-0676ba61.pth"):
        SSLTrainer(cfg, logger=_quiet("arch_weights_1")[0])
    cfg.model.arch_weights = str(tmp_path / "nope.pth")
    with pytest.raises(FileNotFoundError,
                       match="Pass the path to a torchvision resnet50 "
                             "checkpoint"):
        SSLTrainer(cfg, logger=_quiet("arch_weights_2")[0])


def test_eval_stages_ignore_arch_weights_as_the_reference_does(tmp_path):
    """`arch_weights` is read by stage 1 alone in the JAX package; an eval
    trainer given the flag builds and trains."""
    cfg = _cfg("backbone_eval", str(tmp_path), epochs=1)
    cfg.model.arch_weights = "IMAGENET1K_V1"
    BackboneEvalTrainer(cfg, logger=_quiet("arch_weights_3")[0])


# ---------------------------------------------------------------------------
# bare --use-checkpoint on a ResNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_remat_is_exact_in_float64(arch):
    torch.manual_seed(0)
    plain = backbones.build_backbone(arch).double().train()
    remat = backbones.build_backbone(arch, remat=True).double().train()
    assert remat.remat and not plain.remat
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(4, 32, 32, 3, dtype=torch.float64)
    proj = torch.randn(plain.feat_dim, dtype=torch.float64)
    outs = []
    for model in (plain, remat):
        for _ in range(2):       # two steps: the statistics move twice
            model.zero_grad()
            out = model(x)
            (out * proj).sum().backward()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    sa, sb = plain.state_dict(), remat.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert int(sb["layer1.0.bn1.num_batches_tracked"]) == 2
    for (k, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), k


def test_resnet_remat_saves_no_block_internals_and_evals_plainly():
    torch.manual_seed(1)
    model = backbones.build_backbone("resnet18", remat=True).train()
    x = torch.randn(2, 32, 32, 3)
    calls = []
    hook = model.layer2[0].conv1.register_forward_hook(
        lambda *a: calls.append(torch.is_grad_enabled()))
    model(x).sum().backward()
    assert len(calls) == 2          # once forward, once in the backward
    calls.clear()
    with torch.no_grad():
        model(x)
    model.eval()
    model(x)
    assert len(calls) == 2          # no checkpoint without a graph: 1 + 1
    hook.remove()
    with pytest.raises(ValueError, match="attention-memory mode"):
        backbones.build_backbone("resnet18", remat="flash")


def test_recomputing_batch_norm_leaves_its_statistics_alone():
    bn = BatchNorm(3).train()
    x = torch.randn(8, 3, 4, 4)
    want = bn(x)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with recomputing():
        got = bn(x)
    assert torch.equal(got, want)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k
    bn(x)
    assert int(bn.num_batches_tracked) == 2


# ---------------------------------------------------------------------------
# ViT on another patch grid
# ---------------------------------------------------------------------------

CUT = dict(patch=16, dim=128, depth=2, n_heads=2)


@pytest.mark.parametrize("size", [96, 32, (48, 80)])
def test_pos_embed_resize_matches_the_flax_vit(size):
    """A ViT made for a 4x4 grid (64x64) run at a larger, a smaller and a
    non-square input."""
    hw = (size, size) if isinstance(size, int) else size
    rng = np.random.default_rng(0)
    m = jax_vit.ViT(dtype=jnp.float32, **CUT)
    x0 = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    params = m.init(jax.random.key(0), jnp.asarray(x0))["params"]
    assert params["pos_embed"].shape == (1, 17, 128)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    model = ViT(img_size=64, **CUT)
    model.load_state_dict(weights.to_tensors(weights.vit_state_dict(params)),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        same = model(torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        same, np.asarray(m.apply({"params": params}, jnp.asarray(x0))),
        atol=1e-5)
    grid = (hw[0] // 16, hw[1] // 16)
    pos = model.pos_embed_for(grid)
    assert pos.shape == (1, grid[0] * grid[1] + 1, 128)
    assert torch.equal(pos[:, 0], model.pos_embed[:, 0])    # the class token
    assert model.pos_embed_for((4, 4)) is model.pos_embed
