#!/usr/bin/env python
"""The learning demo of the PyTorch port (the twin of
tools/demo_synthetic_e2e.py): the SM3 pipeline learns on synthetic
label-correlated data.

    python tools/demo_synthetic_e2e_torch.py --epochs 20
    python tools/demo_synthetic_e2e_torch.py --epochs 200 --full-pipeline

Builds a paired dataset whose luminance textures encode the 8 labels
(`make_structured_dataset`, 70 / 30 train / val), pretrains stage 1 with
`SSLTrainer` (ResNet-18 at 96 x 96, batch 48, v32, projection 64, T 0.1,
lr 1e-3, bf16 autocast), then linear-probes the frozen features and a
random-init extractor's alike (`LinearProbe`). SSL features that beat the
random ones on val AUC_AVG show the contrastive pipeline at work without
the Derm7pt images. `--full-pipeline` goes on in memory: stage 2
(`MLCTrainer` on the trained encoders) and the supervised eval
(`MLCEvalTrainer` on the stage-2 model).

The same flags and defaults as the JAX package's demo, plus `--device`
(default cuda) and `--seed` (the runs' seed, default 0; the data stay
those of seed 0). `--bn-stat-freq K` trains stage 1 with the off-recipe
periodic BatchNorm refresh (SSLTrainer's fast step on K - 1 of K steps);
a larger `--data-n` gives an epoch more steps for it. `main(argv)` returns
the AUCs, the SSL losses and the stages' seconds.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

META_VOCAB = (3, 3, 16)   # elevation, sex, location cardinalities


def make_structured_dataset(n=192, size=160, seed=0):
    """(train, val) `PairedImageData` of paired images whose textures
    encode the 8 labels, split 70 / 30, with metadata codes for the
    tri-modal path: the first three labels' codes with 15% replaced at
    random. The same numpy random calls, in the same order, as the JAX
    package's demo, so one seed gives the same canvases, labels and
    codes."""
    from sm3x_torch import NUM_CLASSES
    from sm3x_torch.data.pipeline import PairedImageData
    from sm3x_torch.data.synthetic import render_label_texture

    rng = np.random.default_rng(seed)
    labels = np.stack([rng.integers(0, c, n) for c in NUM_CLASSES], axis=1)
    meta = np.stack([labels[:, 0] % 3, labels[:, 1] % 3,
                     labels[:, 4] % 16], axis=1).astype(np.int32)
    noise_mask = rng.random(meta.shape) < 0.15
    noise_vals = np.stack([rng.integers(0, v, n) for v in META_VOCAB],
                          axis=1).astype(np.int32)
    meta = np.where(noise_mask, noise_vals, meta)

    def build(split_idx):
        views = []
        for shift in (0.0, 0.07):   # derm, then clinic
            canv = np.zeros((len(split_idx), size, size, 3), np.uint8)
            for j, i in enumerate(split_idx):
                canv[j] = render_label_texture(rng, labels[i], shift, size)
            hw = np.full((len(split_idx), 2), size, np.int32)
            views += [canv, hw]
        data = PairedImageData.from_canvases(
            *views, labels[split_idx].astype(np.int32))
        data.meta_codes = meta[split_idx]
        data.meta_vocab_sizes = list(META_VOCAB)
        return data

    perm = rng.permutation(n)
    n_tr = int(n * 0.7)
    return build(perm[:n_tr]), build(perm[n_tr:])


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=48)
    p.add_argument("--probe-epochs", type=int, default=15)
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--img-sz", type=int, default=96)
    p.add_argument("--log-path", default=os.path.join(tempfile.gettempdir(),
                                                      "sm3x_torch_demo"))
    p.add_argument("--full-pipeline", action="store_true",
                   help="also run stage-2 DeepCluster + supervised eval")
    p.add_argument("--mlc-epochs", type=int, default=40)
    p.add_argument("--eval-epochs", type=int, default=25)
    p.add_argument("--bn-stat-freq", type=int, default=1,
                   help="run the SSL stage with the off-recipe periodic "
                   "BN-stat refresh (learnability check for the lever)")
    p.add_argument("--lr", type=float, default=1e-3,
                   help="SSL learning rate (the BN-stat-freq lever's "
                   "safety depends on how fast params outrun the EMA)")
    p.add_argument("--arch-version", default="v32",
                   help="SSL model family (v2/v3/v32 styles or 'trimodal' "
                   "for the metadata third-modality path)")
    p.add_argument("--use-checkpoint", default="false",
                   help="a ViT's activation-memory mode: false|true|dots|"
                   "attn|flash|mlp|attn_mlp")
    p.add_argument("--data-n", type=int, default=192,
                   help="synthetic dataset size (70/30 train/val split)")
    p.add_argument("--multicrop", action="store_true",
                   help="SwAV-style multi-crop SSL (SevenPCSwavDataset): 2 "
                   "globals at --img-sz + 4 locals at half resolution")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="the seed of the runs (the data are seed 0's)")
    return p


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    use_ckpt = {"false": False, "true": True}.get(
        args.use_checkpoint.lower(), args.use_checkpoint)

    from sm3x_torch.core.config import (DataConfig, EvalConfig,
                                        MLCTrainConfig, ModelConfig,
                                        OptimConfig, RunConfig, SSLConfig)
    from sm3x_torch.models.backbones import feat_dim
    from sm3x_torch.train.backbone_train import SSLTrainer, unsupported
    from sm3x_torch.train.linear_probe import LinearProbe, make_ssl_extract_fn
    from sm3x_torch.utils.checkpoint import export_backbone

    mean = (0.5, 0.5, 0.5)
    std = (0.25, 0.25, 0.25)
    img_sz = (args.img_sz, args.img_sz)
    dkw = dict(img_sz=img_sz, mean=mean, std=std)
    if args.multicrop:
        # the reference's 224 / 96 ratio at the demo's resolution
        dkw.update(data_name="SevenPCSwavDataset",
                   size_crops=(args.img_sz, args.img_sz // 2),
                   nmb_crops=(2, 4), min_scale_crops=(0.5, 0.14),
                   max_scale_crops=(1.0, 0.5))
    cfg = SSLConfig(
        data=DataConfig(**dkw),
        model=ModelConfig(arch=args.arch, arch_version=args.arch_version,
                          proj_dim=64, temperature=0.1,
                          bn_stat_freq=args.bn_stat_freq,
                          use_checkpoint=use_ckpt,
                          meta_vocab_sizes=META_VOCAB),
        optim=OptimConfig(epochs=args.epochs, batch_size=args.batch_size,
                          base_lr=args.lr, amp=True),
        run=RunConfig(log_path=args.log_path, seed=args.seed, save_freq=1000,
                      ckpt_freq=1000, print_freq=1000, device=args.device),
    )
    problems = unsupported(cfg)
    if problems:
        raise SystemExit("demo_synthetic_e2e_torch: " + "; ".join(problems))

    train, test = make_structured_dataset(n=args.data_n)
    print(f"data: train {train.n} / test {test.n}", flush=True)
    seconds = {}

    def probe_auc(trainer, tag):
        t0 = time.time()
        extract = make_ssl_extract_fn(trainer.model, trainer.device, mean,
                                      std, img_sz)
        probe = LinearProbe(2 * feat_dim(args.arch), ft_lr=1e-3,
                            seed=args.seed, device=trainer.device)
        best = probe.run(extract, train, test, args.batch_size,
                         epochs=args.probe_epochs)
        seconds[tag] = time.time() - t0
        print(f"{tag}: best val AUC_AVG {best['AUC_AVG']:.4f} "
              f"({seconds[tag]:.1f} s)", flush=True)
        return best["AUC_AVG"]

    t0 = time.time()
    trainer = SSLTrainer(cfg)
    auc_random = probe_auc(trainer, "random-init probe")
    t1 = time.time()
    history = trainer.fit(train)
    seconds["ssl"] = time.time() - t1
    print(f"SSL {args.epochs} epochs in {(time.time() - t0) / 60:.1f} min "
          f"(fit {seconds['ssl']:.1f} s)", flush=True)
    auc_ssl = probe_auc(trainer, "SSL-pretrained probe")
    print(f"RESULT: ssl {auc_ssl:.4f} vs random {auc_random:.4f} "
          f"({'PASS' if auc_ssl > auc_random else 'FAIL'})", flush=True)
    out = dict(auc_random=auc_random, auc_ssl=auc_ssl, auc_eval=None,
               ssl_losses=[h["loss"] for h in history], seconds=seconds)

    if args.full_pipeline:
        from sm3x_torch.train.mlc_eval import MLCEvalTrainer
        from sm3x_torch.train.mlc_train import MLCTrainer

        head = dict(arch=args.arch, mlc_proj="v4", mlc_proj_dim=128,
                    num_heads=1, sa_dim_ff=64, sa_dropout=0.1)
        mcfg = MLCTrainConfig(
            data=cfg.data,
            model=ModelConfig(temperature=1.0, **head),
            optim=OptimConfig(epochs=args.mlc_epochs,
                              batch_size=args.batch_size, base_lr=1e-4,
                              amp=True),
            run=RunConfig(log_path=args.log_path + "/mlc", seed=args.seed,
                          save_freq=10000, ckpt_freq=10000, print_freq=1000,
                          device=args.device),
            kmeans_iters=10,
        )
        t0 = time.time()
        mlc = MLCTrainer(mcfg, extractor_state=export_backbone(
            trainer.model.state_dict()))
        mlc.fit(train)
        seconds["mlc"] = time.time() - t0
        print(f"MLC {args.mlc_epochs} epochs in {seconds['mlc'] / 60:.1f} "
              f"min ({seconds['mlc']:.1f} s)", flush=True)

        ecfg = EvalConfig(
            data=cfg.data,
            model=ModelConfig(finetune="projector", **head),
            optim=OptimConfig(epochs=args.eval_epochs,
                              batch_size=args.batch_size, base_lr=1e-3,
                              amp=True),
            run=RunConfig(log_path=args.log_path + "/eval", seed=args.seed,
                          print_freq=1000, device=args.device),
            train_sz=args.img_sz, test_sz=args.img_sz,
        )
        t0 = time.time()
        ev = MLCEvalTrainer(ecfg, pretrained_state=mlc.model.state_dict())
        best = ev.fit(train, test)
        seconds["eval"] = time.time() - t0
        out["auc_eval"] = best
        print(f"FULL-PIPELINE RESULT: supervised eval best AUC {best:.4f} "
              f"vs linear probe {auc_ssl:.4f} vs random {auc_random:.4f} "
              f"(eval {seconds['eval']:.1f} s)", flush=True)
    return out


if __name__ == "__main__":
    main()
