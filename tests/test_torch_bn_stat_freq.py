"""--bn-stat-freq K in the port (the JAX package's `frozen_bn` fast step,
sm3x/train/backbone_train.py), on the CPU at the suite's small sizes
(resnet18, 32x32, 8 images). The fast step's numbers against the JAX
package's are held in tests/test_torch_train_step.py, on that file's
reference, and on two gloo processes in tests/test_torch_multigpu.py's
launch; here:

- the running statistics: a fast step leaves every `running_mean`,
  `running_var` and `num_batches_tracked` as it was, bit for bit, and every
  module in train mode after it; a standard step after it moves them. For
  the plain step, multi-crop, ResNet under --use-checkpoint (whose backward
  recomputes blocks: they must run in eval mode too, so the fast step's
  gradients equal those of the same step without checkpoints) and a ViT
  under --use-checkpoint attn;
- the trainer's schedule: over two epochs of 6 steps the steps that take
  the fast step are those the JAX package's `SSLTrainer.train_epoch` picks
  (`it % K`, `it` the step in the epoch), and K = 0 or -1 acts as 1;
- tri-modal with K > 1 refused with the JAX package's message;
- bench_torch.py's two secondary modes and tools/bench_bn_freq_torch.py
  at a toy size with --device cpu.
"""

import dataclasses
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LR, WD, EPS, T, GROUPS = 1e-4, 5e-2, 1e-5, 0.1, 2
B, SIZE, CANVAS = 8, 32, 48
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
VIT_NARROW = dict(patch=8, dim=64, depth=2, n_heads=2)
MULTICROP = dict(size_crops=(SIZE, 16), nmb_crops=(2, 2),
                 min_scale_crops=(0.5, 0.14), max_scale_crops=(1.0, 0.5),
                 local_weight=1.0)
TRIMODAL_REFUSAL = "--bn-stat-freq applies to the dual-modal SSL step only"

torch.set_num_threads(2)


def _load(path: str):
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0] + "_bnfreq", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _statistics(model) -> dict:
    return {k: b.clone() for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


# ---------------------------------------------------------------------------
# The running statistics, and the recomputation under --use-checkpoint
# ---------------------------------------------------------------------------

CASES = {
    "plain": dict(arch="resnet18", remat=False),
    "multicrop": dict(arch="resnet18", remat=False, multicrop=MULTICROP),
    "resnet_checkpoint": dict(arch="resnet18", remat=True),
    "vit_attn": dict(arch="vit_narrow", remat="attn"),
}


@pytest.fixture
def vit_narrow():
    """`vit_narrow` registered in the port's ViT tables for the test."""
    from sm3x_torch.models import vit

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit.VIT_SPECS, "vit_narrow", VIT_NARROW)
        mp.setitem(vit.VIT_FEAT_DIMS, "vit_narrow", VIT_NARROW["dim"])
        yield


def _steps(arch, remat, multicrop=None, state=None):
    """(model, fast step, standard step) of `make_ssl_train_step` on one
    model from seed 0's weights (or `state`)."""
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.ops.augment import SSL_AUG
    from sm3x_torch.train.backbone_train import make_ssl_train_step
    from sm3x_torch.train.common import make_adamw

    torch.manual_seed(0)
    model, style = build_ssl_model("v32", arch, 16, remat=remat,
                                   img_size=SIZE)
    if state is not None:
        model.load_state_dict(state)
    model.train()
    opt = make_adamw(model.parameters(), LR, WD, eps=EPS)
    aug = dataclasses.replace(SSL_AUG, out_size=(SIZE, SIZE))
    make = lambda frozen: make_ssl_train_step(
        model, opt, style, T, GROUPS, MEAN, STD, aug, multicrop=multicrop,
        frozen_bn=frozen)
    return model, make(True), make(False)


def _canvases():
    from sm3x_torch.data.synthetic import synthetic_canvas_batch

    d, dh, _ = synthetic_canvas_batch(B, CANVAS, 5)
    c, ch, _ = synthetic_canvas_batch(B, CANVAS, 6)
    return [torch.from_numpy(x) for x in (d, dh, c, ch)]


@pytest.mark.parametrize("case", list(CASES))
def test_the_fast_step_keeps_the_running_statistics(case, request):
    kw = CASES[case]
    if kw["arch"] == "vit_narrow":
        request.getfixturevalue("vit_narrow")
    model, fast, standard = _steps(**kw)
    batch = _canvases()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    before = _statistics(model)
    weights = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss = float(fast(*batch, 11)["loss"])
    assert np.isfinite(loss)
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), k
    assert all(m.training for m in model.modules())
    assert all(not torch.equal(p, weights[k])
               for k, p in model.named_parameters()
               if p.grad is not None and p.grad.abs().max() > 0)
    if kw["remat"]:
        # the recomputed segments ran in eval mode: the gradients of the
        # same fast step without checkpoints
        plain, plain_fast, _ = _steps(kw["arch"], False, state=initial)
        assert float(plain_fast(*batch, 11)["loss"]) == pytest.approx(
            loss, rel=1e-6)
        grads = dict(plain.named_parameters())
        for k, p in model.named_parameters():
            want = grads[k].grad
            err = float((p.grad - want).norm())
            assert err <= 1e-5 * float(want.norm()) + 1e-12, k
    standard(*batch, 12)
    after = _statistics(model)
    for k, b in after.items():
        if k.endswith("num_batches_tracked"):
            assert b > before[k], k
        else:
            assert not torch.equal(b, before[k]), k


def test_make_ssl_train_step_refuses_a_tri_modal_fast_step():
    from sm3x_torch.train.backbone_train import make_ssl_train_step

    with pytest.raises(ValueError, match="dual-modal"):
        make_ssl_train_step(None, None, 0, T, GROUPS, MEAN, STD,
                            trimodal=True, frozen_bn=True)


# ---------------------------------------------------------------------------
# The trainer's schedule, and its refusal, against the JAX package's trainer
# ---------------------------------------------------------------------------

def _cfg(tmp_path, k, arch_version="v32"):
    from sm3x_torch.core.config import SSLConfig

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.model.arch_version, cfg.model.bn_stat_freq = arch_version, k
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.optim.batch_size, cfg.optim.amp = B, False
    cfg.run.device, cfg.run.log_path = "cpu", str(tmp_path)
    cfg.run.print_freq = 10 ** 6
    return cfg


def _jax_choices(k: int, data, epochs: int) -> list:
    """The steps `sm3x.train.backbone_train.SSLTrainer.train_epoch` gives
    its fast step, run as it is with recording steps in place of its jitted
    ones (no model is built: its __init__ is skipped, and the attributes
    that train_epoch reads are set as __init__ sets them)."""
    from sm3x.core import prng
    from sm3x.core.config import SSLConfig
    from sm3x.core.mesh import make_mesh
    from sm3x.train.backbone_train import SSLTrainer as JaxTrainer

    trainer = JaxTrainer.__new__(JaxTrainer)
    trainer.cfg = SSLConfig()
    trainer.cfg.optim.batch_size, trainer.cfg.run.print_freq = B, 10 ** 6
    trainer.mesh, trainer.rng = make_mesh(), prng.root_key(0)
    trainer.is_trimodal, trainer.state = False, None
    # sm3x/train/backbone_train.py:209, with the model's field set to k
    trainer.bn_stat_freq = max(1, int(k))
    seen = []

    def recording(kind):
        return lambda state, *args: (seen.append(kind) or state,
                                     {"loss": 0.0})

    trainer.train_step = recording("standard")
    trainer.fast_step = recording("fast") if trainer.bn_stat_freq > 1 else None
    for epoch in range(epochs):
        trainer.train_epoch(data, epoch)
    return seen


@pytest.mark.parametrize("k", [4, 0, -1])
def test_the_schedule_is_the_jax_trainer_s(tmp_path, k):
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.train.backbone_train import SSLTrainer

    data = SyntheticPairedData(6 * B, canvas=CANVAS, seed=0)
    trainer = SSLTrainer(_cfg(tmp_path, k))
    assert trainer.bn_stat_freq == max(1, k)
    assert (trainer.fast_step is None) == (k <= 1)
    seen = []
    trainer.train_step = lambda *a: seen.append("standard") or {
        "loss": torch.zeros(())}
    if trainer.fast_step is not None:
        trainer.fast_step = lambda *a: seen.append("fast") or {
            "loss": torch.zeros(())}
    for epoch in range(2):
        trainer.train_epoch(data, epoch)
    assert len(seen) == 12
    assert seen == _jax_choices(k, data, 2)
    if k == 4:  # every epoch starts with a refresh step
        assert seen == (["standard"] + ["fast"] * 3 + ["standard", "fast"]) * 2


def test_tri_modal_is_refused_with_the_jax_package_s_message(tmp_path):
    from sm3x.core.config import SSLConfig as JaxConfig
    from sm3x.train.backbone_train import SSLTrainer as JaxTrainer
    from sm3x_torch.train.backbone_train import SSLTrainer

    with pytest.raises(ValueError, match=TRIMODAL_REFUSAL) as port:
        SSLTrainer(_cfg(tmp_path / "port", 2, "trimodal"))
    cfg = JaxConfig()
    cfg.model.arch_version, cfg.model.bn_stat_freq = "trimodal", 2
    cfg.run.log_path = str(tmp_path / "jax")
    with pytest.raises(ValueError) as jax_side:
        JaxTrainer(cfg)
    assert str(port.value) == str(jax_side.value)


def test_the_trainer_logs_the_experimental_line(tmp_path, caplog):
    from sm3x_torch.train.backbone_train import SSLTrainer

    logger = logging.getLogger("bnfreq_test")
    with caplog.at_level(logging.INFO, logger="bnfreq_test"):
        SSLTrainer(_cfg(tmp_path, 3), logger=logger)
    assert ("bn-stat-freq 3: BN statistics refresh every 3 steps "
            "(EXPERIMENTAL, off-recipe; running stats lag up to 2 steps"
            ) in caplog.text


# ---------------------------------------------------------------------------
# The benches on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,suffix", [
    (["--bn-stat-freq", "2"], "_bn_stat_freq2"),
    (["--negatives", "global"], "_negatives_global")])
def test_bench_prints_the_secondary_modes_metric(tmp_path, monkeypatch,
                                                 capsys, flags, suffix):
    bench = _load(os.path.join(REPO, "bench_torch.py"))
    monkeypatch.chdir(tmp_path)
    assert bench.main(["2", "2", "resnet18", "--img-sz", str(SIZE),
                       str(SIZE), "--canvas", str(CANVAS), "--device", "cpu"]
                      + flags) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "ssl_pretrain_images_per_sec_per_chip" + suffix
    assert out["value"] > 0 and out["device"] == "cpu"
    assert out["device_busy_ms"] is None
    assert os.listdir(tmp_path) == []


def test_bench_refuses_the_modes_outside_stage_1(capsys):
    bench = _load(os.path.join(REPO, "bench_torch.py"))
    with pytest.raises(SystemExit):
        bench.main(["--stage", "mlc_train", "--bn-stat-freq", "2",
                    "--device", "cpu"])
    assert "stage 1's" in capsys.readouterr().err


def test_bn_freq_bench_prints_the_jax_tool_s_lines_on_the_cpu(
        tmp_path, monkeypatch, capsys):
    tool = _load(os.path.join(REPO, "tools", "bench_bn_freq_torch.py"))
    monkeypatch.chdir(tmp_path)
    assert tool.main(["2", "1", "--arch", "resnet18", "--img-sz", str(SIZE),
                      str(SIZE), "--canvas", str(CANVAS), "--device",
                      "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("train-BN step (reference semantics, b=2): ")
    assert lines[1].startswith("eval-BN fast step (b=2): ")
    assert lines[2].startswith("alternating --bn-stat-freq 4 (b=2): ")
    assert lines[4].startswith("fast/slow: ") and "measured K=4: " in lines[4]
    assert [line.split(":")[0] for line in lines[5:8]] == [
        f"projected K={k}" for k in (2, 4, 8)]
    out = json.loads(lines[8])
    for kind in ("slow", "fast", "k4"):
        assert out[kind]["median_ms"] > 0 and out[kind]["window_ms"] > 0
        assert out[kind]["device_busy_ms"] is None
    assert out["device"] == "cpu" and out["peak_memory_gib"] is None
    assert os.listdir(tmp_path) == []


def test_bn_freq_bench_needs_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        return  # on a card the default run is the benchmark itself
    tool = _load(os.path.join(REPO, "tools", "bench_bn_freq_torch.py"))
    assert tool.main([]) != 0
    out = capsys.readouterr()
    assert "runs on an NVIDIA GPU" in out.err and out.out == ""
