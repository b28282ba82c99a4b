#!/usr/bin/env python
"""Dry run of the PyTorch port's multi-process path: N processes on this
machine, one flushed line a check as it passes.

    python tools/dryrun_multigpu_torch.py --nprocs 4      # 4 NCCL ranks, a card each
    python tools/dryrun_multigpu_torch.py --cpu           # 2 gloo CPU processes
    python tools/dryrun_multigpu_torch.py --cpu --nprocs 4 --mesh-model 2

Each process joins the group through torchrun's environment
(sm3x_torch.parallel.launch), then, on the grid of N / M data x M model
ranks (--mesh-model M, 1 by default) and at a toy size (resnet18, 32x32, a
global batch of 4 a rank of the data axis, synthetic canvases):
  process group   rank, world, broadcast_string, one host_gather_tree
  stage-1 step    one SSLTrainer epoch of one step; the loss equal on
                  every rank
  stage-2 epoch   MLCTrainer's init pass and one epoch; the k-means
                  assignments equal on every rank
  eval epoch      one MLCEvalTrainer epoch (--finetune projector) and
                  results.csv from rank 0; the metrics equal on every rank
  tensor parallel one vit_s16 stage-1 step with its blocks split over the
                  model axis: each rank's q weight a slice, the loss equal
                  on every rank, the replicated weights equal across the
                  model group (with M > 1; a line that says it was
                  skipped otherwise). Under M > 1 the stage-2 and eval
                  checks above also run with their label heads split.
Rank 0 prints `[dryrun] <check> ok ...` as each passes; every process has
its own time limit (--timeout), and the script exits non-zero on the
first failure of any rank, with that rank's output.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZE, PER_RANK = 32, 4


def say(msg: str) -> None:
    print(f"[dryrun] {msg}", flush=True)


def _same_on_every_rank(name: str, value) -> None:
    import numpy as np

    from sm3x_torch.parallel import host_gather

    got = host_gather(np.asarray([value], dtype=np.float64))
    if not (got == got[0]).all():
        raise AssertionError(f"{name} differs between ranks: {got}")


def worker(out: str, cpu: bool, mesh_model: int = 1) -> None:
    import numpy as np
    import torch

    from sm3x_torch.core.config import EvalConfig, MLCTrainConfig, SSLConfig
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.parallel import (broadcast_string, distributed_initialize,
                                     host_gather_tree, process_info, shutdown)

    torch.set_num_threads(1)
    t = time.perf_counter()
    distributed_initialize(backend="gloo" if cpu else "nccl")
    rank, world = process_info()
    device = "cpu" if cpu else "cuda"
    path = broadcast_string(out if rank == 0 else "")
    tree = host_gather_tree({"rank": np.asarray([rank])})
    if path != out or tree["rank"].tolist() != list(range(world)):
        raise AssertionError(f"collectives: {path!r}, {tree}")
    batch = PER_RANK * world // mesh_model
    if rank == 0:
        say(f"process group ok: {world} ranks ({world // mesh_model} data x "
            f"{mesh_model} model) over "
            f"{torch.distributed.get_backend()}, {device} "
            f"({time.perf_counter() - t:.1f} s)")

    def common(cfg, tag):
        cfg.data.img_sz = (SIZE, SIZE)
        cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = batch, 1, False
        cfg.run.device, cfg.run.log_path = device, os.path.join(out, tag)
        cfg.run.save_freq = cfg.run.ckpt_freq = 100
        cfg.run.mesh_model = mesh_model
        return cfg

    from sm3x_torch.train.backbone_train import SSLTrainer

    t = time.perf_counter()
    cfg = common(SSLConfig(), "stage1")
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    hist = SSLTrainer(cfg).fit(synthetic_paired_data(batch, 48, seed=1))
    loss = hist[0]["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"stage-1 loss {loss}")
    _same_on_every_rank("the stage-1 loss", loss)
    if rank == 0:
        say(f"stage-1 step ok: loss {loss:.6f} on every rank "
            f"({time.perf_counter() - t:.1f} s)")

    from sm3x_torch.train.mlc_train import MLCTrainer

    t = time.perf_counter()
    cfg = common(MLCTrainConfig(), "stage2")
    m = cfg.model
    m.arch, m.mlc_proj_dim, m.sa_dim_ff, cfg.kmeans_iters = ("resnet18", 16,
                                                            16, 3)
    trainer = MLCTrainer(cfg)
    hist = trainer.fit(synthetic_paired_data(2 * batch, 48, seed=2))
    assigned = trainer.assignments.cpu().numpy()
    _same_on_every_rank("the k-means assignments",
                        float((assigned * np.arange(assigned.size).reshape(
                            assigned.shape)).sum()))
    if rank == 0:
        say(f"stage-2 epoch ok: loss {hist[0]['loss']:.6f}, k-means "
            f"assignments equal on every rank "
            f"({time.perf_counter() - t:.1f} s)")

    from sm3x_torch.train.mlc_eval import MLCEvalTrainer

    t = time.perf_counter()
    cfg = common(EvalConfig(), "eval")
    m = cfg.model
    m.arch, m.mlc_proj_dim, m.sa_dim_ff, m.finetune = ("resnet18", 16, 16,
                                                       "projector")
    cfg.train_sz = cfg.test_sz = SIZE
    trainer = MLCEvalTrainer(cfg)
    test = synthetic_paired_data(batch + 2, 48, seed=4)  # a padded batch
    best = trainer.fit(synthetic_paired_data(batch, 48, seed=3), test)
    csv = trainer.write_results(test, os.path.join(cfg.run.log_path,
                                                   "results.csv"))
    _same_on_every_rank("the best val AUC", best)
    if rank == 0:
        if not os.path.isfile(csv):
            raise AssertionError("rank 0 wrote no results.csv")
        say(f"eval epoch ok: val AUC_AVG {best:.4f} on every rank, "
            f"results.csv from rank 0 ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    if mesh_model == 1:
        if rank == 0:
            say("tensor parallel skipped: --mesh-model 1")
        shutdown()
        return
    from sm3x_torch.core.mesh import current_mesh
    from sm3x_torch.parallel import gather_objects

    cfg = common(SSLConfig(), "tp")
    cfg.model.arch, cfg.model.proj_dim = "vit_s16", 16
    trainer = SSLTrainer(cfg)
    hist = trainer.fit(synthetic_paired_data(batch, 48, seed=5))
    loss = hist[0]["loss"]
    _same_on_every_rank("the tensor-parallel loss", loss)
    q = tuple(trainer.model.derm_backbone.encoder.block0.attn.query.weight
              .shape)
    if q != (384 // mesh_model, 384):
        raise AssertionError(f"q weight {q} on a model axis of {mesh_model}")
    kept = {k: v for k, v in trainer.model.state_dict().items()
            if trainer.tp.plan(k, trainer.tp.shapes[k], mesh_model) is None}
    every = gather_objects({k: v.cpu() for k, v in kept.items()},
                           current_mesh().model_group)
    if not all(all(o[k].equal(v.cpu()) for k, v in kept.items())
               for o in every):
        raise AssertionError("replicated weights differ in a model group")
    if rank == 0:
        say(f"tensor parallel ok: vit_s16 blocks split over model "
            f"{mesh_model} (q weight {q} a rank), loss {loss:.6f} on every "
            f"rank, {len(kept)} replicated tensors equal across the model "
            f"group ({time.perf_counter() - t:.1f} s)")
    shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="gloo processes on the CPU (by default NCCL ranks, "
                   "one card each, which needs --nprocs cards)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="ranks of the model axis (tensor parallelism); it "
                   "must divide --nprocs")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds each process may take")
    p.add_argument("--out", default=None,
                   help="where the ranks write their runs (a temporary "
                   "directory, removed at the end, by default)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="sm3x_dryrun_")
    if args.worker:
        worker(out, args.cpu, args.mesh_model)
        return 0

    from sm3x_torch.parallel.launch import launch_local

    if not args.cpu:
        import torch

        if torch.cuda.device_count() < args.nprocs:
            say(f"{args.nprocs} NCCL ranks need {args.nprocs} cards, found "
                f"{torch.cuda.device_count()} (--cpu runs gloo on the CPU)")
            return 2
    say(f"launching {args.nprocs} {'gloo CPU' if args.cpu else 'NCCL'} "
        f"processes, {args.timeout:.0f} s each")
    if args.nprocs % args.mesh_model:
        say(f"--mesh-model {args.mesh_model} does not divide --nprocs "
            f"{args.nprocs}")
        return 2
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--out",
           out, "--mesh-model", str(args.mesh_model)] + (
               ["--cpu"] if args.cpu else [])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    t = time.perf_counter()
    try:
        res = launch_local(cmd, args.nprocs, args.timeout, env=env,
                           cwd=ROOT, live=True)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    failed = [(r, rc, text) for r, (rc, text) in enumerate(res) if rc != 0]
    for r, rc, text in failed:
        say(f"rank {r} failed with exit code {rc}"
            + (":\n" + text[-4000:] if text else ""))
    if failed:
        return 1
    say(f"all checks passed ({args.nprocs} processes, "
        f"{time.perf_counter() - t:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
