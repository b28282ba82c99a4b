"""Stage 2 of the port (sm3x_torch.train.mlc_train) against the JAX package
(sm3x.train.mlc_train) on the same weights, bank and pre-augmented views,
on the CPU: the epoch's clustering, three train steps, the init-memory
pass, the freeze policy, and the CLI end to end.

Sizes: resnet18, 56x56, `mlc_proj_dim` 32, `sa_dim_ff` 16, batch 8, a bank
of 24 cases. Dropout is 0 where outputs are compared (the frameworks draw
different masks) and the views are fixed: the JAX step gets an `aug_fn`
that hands its input through, the port's `mlc_update` takes views.
k-means starts from the rows `jax.random.permutation` picks for the JAX
side's keys. Both sides compute in float32: `sm3x.models.mlc.MLCModel`
builds its head in float32 whatever its dtype, and the frozen extractor
runs in eval mode, which is well conditioned (unlike stage 1's train-mode
batch norm, which needs float64). Losses are held at rtol 1e-5 at every
step; parameters at atol 3 x lr, the bound of AdamW's update where a
near-zero gradient flips sign (AdamW's eps is 1e-8 here); bank rows, which
pass through the head after it has moved by such updates, at the same
atol with rtol 1e-4 (measured: 17 of 6144 entries beyond 1e-5, the worst
by 1.1e-4; the first step's rows, written before any update, within 1e-5).
"""

import dataclasses
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x import NUM_CLASSES
from sm3x.models.mlc import MLCModel as JaxMLCModel
from sm3x.ops.augment import MLC_TRAIN_AUG as JAX_AUG
from sm3x.train import common as jax_common
from sm3x.train import mlc_train as jt
from sm3x_torch.core.config import MLCTrainConfig
from sm3x_torch.data.synthetic import SyntheticPairedData
from sm3x_torch.models.mlc import MLCModel
from sm3x_torch.train import common, mlc_train
from sm3x_torch.utils import weights

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD, T = 1e-4, 5e-2, 1.0
B, N, SIZE, PROJ, STEPS, ITERS = 8, 24, 56, 32, 3, 10
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _handed_through(key, canvases, hw, mean, std, cfg):
    return canvases


@pytest.fixture(scope="module")
def reference():
    """The JAX side: initial weights, the bank, the clustering of epoch 0
    with the initial rows it drew, three train steps and one embed pass."""
    rng = np.random.default_rng(3407)
    views = rng.standard_normal((STEPS, 2, B, SIZE, SIZE, 3)).astype(np.float32)
    bank = rng.standard_normal((8, N, PROJ)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    index = rng.permutation(N).reshape(STEPS, B)

    jm = JaxMLCModel(arch="resnet18", proj_dim=PROJ, sa_dim_ff=16,
                     sa_dropout=0.0, dtype=jnp.float32)
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    v = jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                x, x, extractor_train=False, head_train=False)
    init_sd = weights.mlc_state_dict(_np_tree(v["params"]),
                                     _np_tree(v["batch_stats"]))

    key = jax.random.key(7)
    init_idx = [np.array(jax.random.permutation(jax.random.fold_in(key, i),
                                                N))[:k]
                for i, k in enumerate(NUM_CLASSES)]
    params, assignments = jt.cluster_and_update(
        key, jnp.asarray(bank), jax.tree.map(jnp.asarray, v["params"]),
        tuple(NUM_CLASSES), ITERS)
    clustered_sd = weights.mlc_state_dict(_np_tree(params),
                                          _np_tree(v["batch_stats"]))

    # the embed pass, from the clustered weights (train-mode statistics)
    embed = jt.make_embed_step(jm, MEAN, STD, JAX_AUG,
                               aug_fn=_handed_through)
    hw = jnp.zeros((B, 2), jnp.int32)
    sa, embed_stats = embed(params, v["batch_stats"],
                            jnp.asarray(views[0, 0]), hw,
                            jnp.asarray(views[0, 1]), hw, jax.random.key(2))
    embed_sd = weights.mlc_state_dict(_np_tree(params), _np_tree(embed_stats))

    mask = jax_common.path_mask(
        params, lambda p: jax_common.mlc_train_trainable(p, False))
    state = jax_common.create_train_state(
        jm, {"params": params, "batch_stats": v["batch_stats"]},
        jax_common.make_adamw(LR, WD, mask_tree=mask))
    step = jt.make_mlc_train_step(jm, T, MEAN, STD, JAX_AUG, False,
                                  aug_fn=_handed_through)
    jbank, losses = jnp.asarray(bank), []
    for s in range(STEPS):
        state, jbank, loss = step(
            state, jbank, jnp.asarray(views[s, 0]), hw,
            jnp.asarray(views[s, 1]), hw, jnp.asarray(index[s]), assignments,
            jax.random.key(10 + s))
        losses.append(float(loss))
    final_sd = weights.mlc_state_dict(_np_tree(state.params),
                                      _np_tree(state.batch_stats))
    return dict(views=views, bank=bank, index=index, init_sd=init_sd,
                init_idx=init_idx, assignments=np.asarray(assignments),
                clustered_sd=clustered_sd, embed_sa=np.asarray(sa),
                embed_sd=embed_sd, losses=losses, final_sd=final_sd,
                final_bank=np.asarray(jbank))


def _port(sd, finetune_backbone=False):
    model = MLCModel("resnet18", proj_dim=PROJ, sa_dim_ff=16, sa_dropout=0.0)
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    opt = common.make_adamw(common.trainable_parameters(
        model, lambda n: common.mlc_train_trainable(n, finetune_backbone)),
        LR, WD)
    return model, opt


def _running(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def test_cluster_and_update_matches_jax(reference):
    r = reference
    model, _ = _port(r["init_sd"])
    bank = torch.from_numpy(r["bank"].copy())
    got = mlc_train.cluster_and_update(
        7, bank, model, tuple(NUM_CLASSES), ITERS,
        init_idx=[torch.from_numpy(i) for i in r["init_idx"]])
    assert got.shape == (8, N) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), r["assignments"])
    for i, k in enumerate(NUM_CLASSES):
        assert 0 <= int(got[i].min()) and int(got[i].max()) < k
        w = model.prototypes[i].weight.detach()
        np.testing.assert_allclose(
            w.numpy(), r["clustered_sd"][f"prototypes.{i}.weight"],
            rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(w.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    # nothing but the prototypes moved
    have = model.state_dict()
    for k, v in r["init_sd"].items():
        if not k.startswith("prototypes."):
            np.testing.assert_array_equal(have[k].numpy(), v, err_msg=k)


def test_cluster_and_update_draws_its_rows_from_the_seed(reference):
    model, _ = _port(reference["init_sd"])
    bank = torch.from_numpy(reference["bank"].copy())
    runs = [mlc_train.cluster_and_update(s, bank, model, tuple(NUM_CLASSES), 0)
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_three_steps_match_jax(reference):
    r = reference
    model, opt = _port(r["clustered_sd"])
    bank = torch.from_numpy(r["bank"].copy())
    assignments = torch.from_numpy(r["assignments"].copy()).long()
    frozen = {k: v.clone() for k, v in model.extractor.state_dict().items()}
    for s in range(STEPS):
        d, c = (torch.from_numpy(r["views"][s, m]) for m in range(2))
        loss = mlc_train.mlc_update(
            model, opt, bank, d, c, torch.from_numpy(r["index"][s]).long(),
            assignments, T)
        np.testing.assert_allclose(float(loss), r["losses"][s], rtol=1e-5,
                                   err_msg=f"step {s}")
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), r["final_sd"][k],
                                   atol=3 * LR, err_msg=k)
    np.testing.assert_allclose(bank.numpy(), r["final_bank"], rtol=1e-4,
                               atol=3 * LR)
    first = r["index"][0]
    np.testing.assert_allclose(bank.numpy()[:, first],
                               r["final_bank"][:, first], rtol=1e-4, atol=1e-5)
    # the frozen extractor: no update, no weight decay, and in eval mode no
    # running statistic moved; the reference's came through unchanged too
    for k, v in model.extractor.state_dict().items():
        assert torch.equal(v, frozen[k]), k
        np.testing.assert_array_equal(v.numpy(),
                                      r["final_sd"][f"extractor.{k}"])
    assert not any(p.requires_grad for p in model.extractor.parameters())
    n_head = sum(1 for k, _ in model.named_parameters()
                 if not k.startswith("extractor."))
    assert sum(len(g["params"]) for g in opt.param_groups) == n_head
    assert opt.defaults["eps"] == 1e-8 and opt.defaults["weight_decay"] == WD


def test_embed_pass_matches_jax_and_moves_the_running_statistics(reference):
    """The init-memory pass runs every module in train mode: batch
    statistics, and the frozen encoders' running statistics move. A train
    step after it moves none of them."""
    r = reference
    model, opt = _port(r["clustered_sd"])
    before = _running(model)
    embed = mlc_train.make_embed_step(model, MEAN, STD, None)
    d, c = (torch.from_numpy(r["views"][0, m]) for m in range(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mlc_train, "augment_pair",
                   lambda seed, d_, dh, c_, ch, *a: (d_, c_))
        sa = embed(d, None, c, None, 5)
    assert model.extractor.training and not sa.requires_grad
    # train-mode batch norm over 8 images: see tests/test_torch_mlc_model.py
    np.testing.assert_allclose(sa.numpy(), r["embed_sa"], rtol=1e-3, atol=1e-3)
    after = _running(model)
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert len(moved) == len(before) and any("extractor" in k for k in moved)
    for k in after:
        np.testing.assert_allclose(after[k].numpy(), r["embed_sd"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    bank = torch.from_numpy(r["bank"].copy())
    mlc_train.mlc_update(model, opt, bank, d, c,
                         torch.from_numpy(r["index"][0]).long(),
                         torch.from_numpy(r["assignments"].copy()).long(), T)
    assert not model.extractor.training
    for k, v in _running(model).items():
        assert torch.equal(v, after[k]), k


def test_finetune_backbone_trains_the_extractor(reference):
    r = reference
    model, opt = _port(r["clustered_sd"], finetune_backbone=True)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(
        list(model.parameters()))
    conv = model.extractor.derm_backbone.encoder.conv1.weight
    before, stats = conv.detach().clone(), _running(model)
    bank = torch.from_numpy(r["bank"].copy())
    d, c = (torch.from_numpy(r["views"][0, m]) for m in range(2))
    loss = mlc_train.mlc_update(
        model, opt, bank, d, c, torch.from_numpy(r["index"][0]).long(),
        torch.from_numpy(r["assignments"].copy()).long(), T, finetune_backbone=True)
    assert math.isfinite(float(loss)) and model.extractor.training
    assert not torch.equal(conv.detach(), before)
    assert any(not torch.equal(v, stats[k])
               for k, v in _running(model).items() if "extractor" in k)


def _cfg(tmp_path, **model_kw):
    cfg = MLCTrainConfig()
    m = cfg.model
    m.arch, m.mlc_proj_dim, m.sa_dim_ff = "resnet18", PROJ, 16
    for k, v in model_kw.items():
        setattr(m, k, v)
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, 2, False
    cfg.run.device, cfg.run.log_path = "cpu", str(tmp_path)
    cfg.run.save_freq, cfg.run.ckpt_freq = 1, 100
    return cfg


def test_trainer_fit_on_synthetic_canvases(tmp_path):
    """MLCTrainer.fit, the entry point of the card's smoke run, on the CPU
    with dropout on: finite losses, targets within each label's classes,
    the bank written by the batch, rank-0 checkpoints that load strictly,
    prototype moments carried across the epochs' overwrites, and no kernel
    launched."""
    from sm3x_torch.ops import augment_cuda

    cfg = _cfg(tmp_path)
    data = SyntheticPairedData(16, canvas=64, seed=0)
    trainer = mlc_train.MLCTrainer(cfg)
    before = augment_cuda.photometric_cuda.launches
    assert trainer.optimizer.defaults["lr"] == 1e-4
    assert trainer.model.prototypes[0].bias is None
    hist = trainer.fit(data)
    assert augment_cuda.photometric_cuda.launches == before
    assert [len(h["step_losses"]) for h in hist] == [2, 2]
    assert all(math.isfinite(x) for h in hist for x in h["step_losses"])
    assert trainer.bank.shape == (8, 16, PROJ)
    assert bool((trainer.bank.norm(dim=-1) > 0).all())
    for i, k in enumerate(NUM_CLASSES):
        a = trainer.assignments[i]
        assert 0 <= int(a.min()) and int(a.max()) < k
    # AdamW's moments of a prototype weight count every step of both epochs
    state = trainer.optimizer.state[trainer.model.prototypes[0].weight]
    assert int(state["step"]) == 4
    ckpt = torch.load(tmp_path / "ckp_1.pth", weights_only=True)
    assert ckpt["epoch"] == 2 and (tmp_path / "ckp_0.pth").exists()
    MLCModel("resnet18", proj_dim=PROJ, sa_dim_ff=16).load_state_dict(
        ckpt["state_dict"], strict=True)


def test_trainer_clusters_then_trains(tmp_path):
    """Right after `cluster`, each prototype weight is its label's unit-norm
    centroid and the targets are the E-step of those centroids on the
    bank."""
    cfg = _cfg(tmp_path, l2_norm=True)
    trainer = mlc_train.MLCTrainer(cfg)
    trainer.init_memory(SyntheticPairedData(16, canvas=64, seed=1))
    trainer.cluster(0)
    for i, head in enumerate(trainer.model.prototypes):
        w = head.weight.detach()
        np.testing.assert_allclose(w.norm(dim=1).numpy(), 1.0, rtol=1e-5)
        assert torch.equal(trainer.assignments[i],
                           (trainer.bank[i] @ w.T).argmax(dim=1))
    # --l2-norm: the bank holds unit rows
    np.testing.assert_allclose(trainer.bank.norm(dim=-1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("run.mesh_model", 3), ("run.mesh_model", 2),
    ("run.ckpt_backend", "orbax"), ("data.data_name", "ISIC17Dataset"),
    ("data.data_name", "ISIC18Dataset"), ("run.mesh_model", 4)])
def test_trainer_refuses_what_is_not_ported(tmp_path, field, value):
    cfg = _cfg(tmp_path)
    part, name = field.split(".")
    setattr(getattr(cfg, part), name, value)
    with pytest.raises(ValueError):
        mlc_train.MLCTrainer(cfg)


@pytest.mark.parametrize("field,value", [
    ("run.save_on_preempt", True), ("data.cache_images", False),
    ("data.device_feed", "resident"), ("data.device_feed", "prefetch"),
    ("optim.use_lr_schedule", True), ("run.ckpt_keep", 7),
    # the data axis is the run's processes, whatever --mesh-data says
    ("run.mesh_data", 2),
    # the reference's alias of SevenPCBaseDataset: only stage 1 reads it
    ("data.data_name", "SevenPCSwavDataset")])
def test_trainer_takes_the_feed_and_loop_settings(tmp_path, field, value):
    cfg = _cfg(tmp_path)
    part, name = field.split(".")
    setattr(getattr(cfg, part), name, value)
    assert mlc_train.unsupported(cfg) == []
    mlc_train.MLCTrainer(cfg)


def test_joint_aug_shares_the_pair_parameters():
    """SevenPCBaseDataset2: both modalities get the derm stream's seed and
    the common valid region, so the pair shares every random parameter."""
    data = SyntheticPairedData(4, canvas=64, seed=2)
    canv = torch.from_numpy(data.derm)
    d_hw, c_hw = torch.from_numpy(data.derm_hw), torch.from_numpy(data.clinic_hw)
    cfg = dataclasses.replace(mlc_train.MLC_TRAIN_AUG, out_size=(32, 32))
    d, c = mlc_train.augment_pair(9, canv, d_hw, canv, c_hw, MEAN, STD, cfg,
                                  True)
    assert torch.equal(d, c)
    d, c = mlc_train.augment_pair(9, canv, d_hw, canv, c_hw, MEAN, STD, cfg,
                                  False)
    assert not torch.equal(d, c)


def _run(tool, args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", tool)] + args, cwd=cwd,
        env=env, capture_output=True, text=True, timeout=600)


def test_cli_trains_two_epochs_from_a_stage1_checkpoint(tmp_path):
    """tools/backbone_train_torch.py writes ckp_0.pth; tools/
    mlc_train_torch.py takes its two encoders (not its projectors), trains
    two epochs on the CPU and writes a ckp_1.pth that loads strictly."""
    from sm3x.data.synthetic import make_fake_derm7pt

    root = tmp_path / "7pc"
    make_fake_derm7pt(str(root), n_cases=32, img_size=56)
    common_args = ["--data-name", "SevenPCBaseDataset", "--data-path",
                   str(root), "--img-sz", "32", "32", "--cache-size", "48",
                   "--mean", "0.78", "0.67", "0.60", "--std", "0.21", "0.25",
                   "0.26", "-a", "resnet18", "-b", "8", "--save-freq", "1",
                   "--ckpt-freq", "100", "-lr", "1e-4", "--device", "cpu",
                   "-j", "2"]
    ssl_log, mlc_log = str(tmp_path / "ssl"), str(tmp_path / "mlc")
    res = _run("backbone_train_torch.py", common_args + [
        "--epochs", "1", "--arch-version", "v32", "--proj-dim", "16",
        "--temperature", "0.1", "--world-size", "2", "--log-path", ssl_log],
        str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    stage1 = os.path.join(ssl_log, "ckp_0.pth")
    res = _run("mlc_train_torch.py", common_args + [
        "--epochs", "2", "--temperature", "1", "--mlc-proj", "v4",
        "--mlc-proj-dim", "32", "--num-heads", "1", "--sa-dim-ff", "16",
        "--sa-dropout", "0.1", "--extractor-weights", stage1, "--log-path",
        mlc_log], str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "Initializion of the memory banks done." in res.stdout
    assert "Clustering for epoch 1 done." in res.stdout
    for epoch in (0, 1):
        m = re.search(rf"Epoch {epoch}: loss (\S+)", res.stdout)
        assert m and math.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    with open(os.path.join(mlc_log, "configs.txt")) as f:
        assert "extractor_weights" in f.read()
    ckpt = torch.load(os.path.join(mlc_log, "ckp_1.pth"), weights_only=True)
    assert ckpt["epoch"] == 2
    model = MLCModel("resnet18", proj_dim=32, sa_dim_ff=16)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    # the frozen encoders' weights are stage 1's, bit for bit
    ssl_sd = torch.load(stage1, weights_only=True)["state_dict"]
    got = mlc_train.load_extractor_state(stage1)
    assert got and not any("projector" in k or "cross_proj" in k for k in got)
    for k, v in got.items():
        assert torch.equal(v, ssl_sd[k])
        if "running" not in k and "num_batches" not in k:
            assert torch.equal(ckpt["state_dict"][f"extractor.{k}"], v), k


def test_cli_refuses_a_flag_outside_the_slice(tmp_path):
    res = _run("mlc_train_torch.py", ["--device", "cpu", "--mesh-model", "2",
                                      "--log-path", str(tmp_path / "m")],
               str(tmp_path))
    assert res.returncode != 0
    assert "--mesh-model 2 does not divide the 1 process" in (
        res.stdout + res.stderr)
