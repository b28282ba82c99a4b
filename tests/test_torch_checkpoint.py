"""Checkpoints written by the port are read back by the JAX package.

Stage 1: `SSLTrainer.save` -> `sm3x.utils.checkpoint.load_torch_ssl_checkpoint`
(the loader the reference's stage 2 uses for a `.pth`, with
`with_projectors=False`) -> Flax trees. Mapped forward again by the port's
bridge (`sm3x_torch.utils.weights`, whose inverse the loader is) every
encoder leaf and batch-norm statistic must equal what the port wrote,
exactly; with the projectors kept, the whole model must.

One step at resnet18 / 56x56 first, so that no leaf and no running
statistic is at its initial value. `sm3x.utils.torch_convert` has no ViT
layout, so a ViT checkpoint stays the port's own and is not read back
here.

Stage 2: `MLCTrainer.save` -> `sm3x.utils.checkpoint.load_torch_mlc_checkpoint`
(the loader the reference's eval stage and inference use: it strips every
`encoder.` substring and converts the MLC model) -> Flax trees, mapped
forward again by `weights.mlc_state_dict`: every leaf and statistic equal,
exactly, for the v4 projectors of the recipe and for v2's batch-normed
ones, and the bias-free prototypes come back without a bias.
"""

import numpy as np
import pytest
import torch

from sm3x.utils.checkpoint import (load_torch_mlc_checkpoint,
                                   load_torch_ssl_checkpoint)
from sm3x_torch.core.config import MLCTrainConfig, SSLConfig
from sm3x_torch.data.synthetic import SyntheticPairedData
from sm3x_torch.train.backbone_train import SSLTrainer
from sm3x_torch.train.mlc_train import MLCTrainer, load_extractor_state
from sm3x_torch.utils import weights

torch.set_num_threads(2)


@pytest.mark.parametrize("version", ["v3", "v32"])
def test_port_stage1_checkpoint_is_read_back_by_the_jax_package(tmp_path,
                                                                version):
    cfg = SSLConfig()
    cfg.model.arch, cfg.model.arch_version, cfg.model.proj_dim = (
        "resnet18", version, 16)
    cfg.data.img_sz = (56, 56)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, 1, False
    cfg.optim.base_lr = 1e-3
    cfg.run.device, cfg.run.world_size = "cpu", 2
    cfg.run.log_path, cfg.run.ckpt_freq = str(tmp_path), 100
    trainer = SSLTrainer(cfg)
    initial = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit(SyntheticPairedData(8, canvas=64, seed=0))
    path = str(tmp_path / "ckp_0.pth")
    wrote = torch.load(path, weights_only=True)
    assert set(wrote) == {"epoch", "state_dict", "optimizer"}
    wrote = {k: v.numpy() for k, v in wrote["state_dict"].items()}
    moved = [k for k, v in wrote.items() if not np.array_equal(
        v, initial[k].numpy())]
    assert len(moved) == len(wrote)  # the step left nothing as it was made

    def same(got, keys):
        assert sorted(got) == sorted(keys)
        for k in keys:
            if not k.endswith("num_batches_tracked"):  # Flax keeps no count
                np.testing.assert_array_equal(got[k], wrote[k], err_msg=k)

    # as stage 2 reads it: the two encoders, no projector
    params, stats = load_torch_ssl_checkpoint(path, "resnet18",
                                              with_projectors=False)
    got = {}
    for mod in ("derm_backbone", "clinic_backbone"):
        assert set(params[mod]) == {"encoder"}
        got.update(weights.resnet_state_dict(
            params[mod]["encoder"], stats[mod]["encoder"],
            f"{mod}.encoder."))
    encoder_keys = [k for k in wrote if ".encoder." in k]
    same(got, encoder_keys)
    # the port's own stage 2 takes the same subtrees
    assert sorted(load_extractor_state(path)) == sorted(encoder_keys)

    # the whole model, projectors kept
    params, stats = load_torch_ssl_checkpoint(
        path, "resnet18", shared_cross_proj=version == "v3")
    same(weights.simclr_skin_state_dict(params, stats), list(wrote))


@pytest.mark.parametrize("variant", ["v4", "v2"])
def test_port_stage2_checkpoint_is_read_back_by_the_jax_package(tmp_path,
                                                                variant):
    cfg = MLCTrainConfig()
    m = cfg.model
    m.arch, m.mlc_proj, m.mlc_proj_dim, m.sa_dim_ff = ("resnet18", variant,
                                                       32, 16)
    cfg.data.img_sz = (56, 56)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 8, 1, False
    cfg.optim.base_lr = 1e-3
    cfg.run.device, cfg.run.log_path, cfg.run.ckpt_freq = ("cpu",
                                                           str(tmp_path), 100)
    trainer = MLCTrainer(cfg)
    initial = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit(SyntheticPairedData(8, canvas=64, seed=0))
    path = str(tmp_path / "ckp_0.pth")
    wrote = torch.load(path, weights_only=True)
    assert {"epoch", "state_dict", "optimizer"} <= set(wrote)
    wrote = {k: v.numpy() for k, v in wrote["state_dict"].items()}
    assert not any(k.startswith("prototypes.") and k.endswith(".bias")
                   for k in wrote)
    # the init pass moved every statistic and the step every head tensor;
    # the frozen encoders' weights are as they were made
    moved = {k for k, v in wrote.items()
             if not np.array_equal(v, initial[k].numpy())}
    assert moved == {k for k in wrote if not k.startswith("extractor.")
                     or "running" in k or "num_batches" in k}

    params, stats = load_torch_mlc_checkpoint(path, "resnet18",
                                              variant=variant)
    assert set(params) == {"extractor", "head"}
    for i in range(8):
        assert set(params["head"]["prototypes"][f"proto{i}"]) == {"kernel"}
    got = weights.mlc_state_dict(params, stats, variant)
    assert sorted(got) == sorted(wrote)
    for k, v in wrote.items():
        if not k.endswith("num_batches_tracked"):  # Flax keeps no count
            np.testing.assert_array_equal(got[k], v, err_msg=k)
