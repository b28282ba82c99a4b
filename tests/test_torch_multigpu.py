"""The port's multi-process data parallelism on the CPU: two gloo processes
(this file run as a script, with torchrun's environment from
`sm3x_torch.parallel.launch`) against the JAX package's 2-device mesh and
against the port's own one-process run, which the other test files hold
against the JAX package.

One launch makes every check below; each rank saves what it saw and the
test functions read it back. A run on N processes is the one-process run
on the global batch:

- stage 1, three steps on fixed views in float64 (resnet18, 32x32, global
  batch 8, v32, proj 16): against the JAX package's step on a 2-device
  mesh (`make_mesh(devices=jax.devices()[:2])`, `shard_batch`) at the
  tolerances of tests/test_torch_train_step.py (loss rtol 1e-5 each step;
  parameters atol 3 x lr, all but 1e-4 of entries 1e-2 x lr); against
  the port's one-process step (computed in each worker before it joins
  the group) for --world-size 2 (one group a rank), 4 (two a rank) and
  --negatives global (the gathered problem): loss rtol 1e-9, parameters
  atol 1e-3 x lr, BN running statistics rtol 1e-9 (the variance biased),
  and both ranks' state identical bit for bit after every step;
- the views: the ranks' augmented views side by side equal the
  one-process views bit for bit (float32, the plain K1 path), for the
  SSL, stage-2 and finetune presets and multi-crop's globals and locals,
  and so do the dropout masks;
- multi-crop and tri-modal stage 1, one step each in float64: the loss at
  rtol 1e-9 and parameters within 1e-3 x lr of one process's, the state
  identical on both ranks;
- the --bn-stat-freq fast step (the model in eval mode) on the first
  views, then a standard step on the second, in float64: losses, the
  parameters and, after the standard step, the running statistics at the
  bounds above; after the fast step the statistics are the initial ones
  bit for bit on both ranks;
- the feed: every strategy and streaming gives each rank its rows of the
  one-process batches, the wrap-padded last batch included;
- stage 2, the init pass and one epoch in float64: the k-means
  assignments equal across ranks and to one process's bit for bit; bank,
  centroids and loss at rtol 1e-9; the state identical on both ranks;
- eval (one epoch of mlc_eval --finetune projector in float64, and of
  backbone_eval --finetune fc in float32): predictions and metrics equal
  on both ranks and to one process's (rtol 1e-9 and 1e-4); only rank 0
  writes results.csv, best_eval.pth and checkpoints;
- preemption: SIGTERM to rank 1 alone breaks both ranks at the epoch
  boundary; rank 0 writes checkpoint.pth, rank 1 nothing;
- the linear probe: features of each rank's rows, gathered; the heads
  and the best stats equal on both ranks, and to one process's at rtol
  1e-4 (float32, where the frozen encoders see 4 images instead of 8).

Also here, in this process: I1 (--mesh-data 2 on one process trains and
warns) and tools/dryrun_multigpu_torch.py at N = 2.
"""

import hashlib
import os
import signal
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 300

LR, WD, EPS, T = 1e-4, 5e-2, 1e-5, 0.1
B, SIZE, STEPS = 8, 32, 3
GROUPS = {"local": 2, "two_a_rank": 4, "gathered": 1}
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# What both sides run
# ---------------------------------------------------------------------------

def _views() -> np.ndarray:
    return np.random.default_rng(3407).standard_normal(
        (STEPS, 4, B, SIZE, SIZE, 3)).astype(np.float32)


def _initial_model(init_path: str):
    """The port's model with the JAX package's initial weights (those of
    tests/test_torch_train_step.py, at whose tolerances the parameters
    are held), as the test process saved them."""
    from sm3x_torch.models.simclr import build_ssl_model

    model, style = build_ssl_model("v32", "resnet18", 16, img_size=SIZE)
    model.load_state_dict(torch.load(init_path), strict=True)
    return model, style


def _digest(module: torch.nn.Module, *extra) -> str:
    h = hashlib.sha256()
    for t in list(module.state_dict().values()) + list(extra):
        h.update(t.detach().contiguous().view(-1).numpy().view(np.uint8).data)
    return h.hexdigest()


def _stage1(init_path: str, groups: int, rows=None) -> dict:
    """Three steps of `ssl_update` on this rank's rows of the fixed views
    (all of them without `rows`), float64."""
    from sm3x_torch.train import common
    from sm3x_torch.train.backbone_train import ssl_update

    model, style = _initial_model(init_path)
    model.double().train()
    net = common.data_parallel(model, "cpu")
    opt = common.make_adamw(model.parameters(), LR, WD, eps=EPS)
    views = torch.from_numpy(_views()).double()
    world = 1 if rows is None else rows.world
    out = {"losses": [], "digests": []}
    for s in range(STEPS):
        v = views[s] if rows is None else rows.take(views[s], dim=1)
        m = ssl_update(net, opt, (v[0], v[1]), (v[2], v[3]), style, T,
                       groups, world=world)
        out["losses"].append(float(m["loss"]))
        out["digests"].append(_digest(model))
    out["model"] = model
    return out


def _stage1_paths(rows=None) -> dict:
    """One float64 step of the multi-crop update (two 16 x 16 locals a
    modality, local weight 0.5) and of the tri-modal update, each model
    from the seed's weights, on this rank's rows (all without `rows`):
    each path's loss, parameters after the step and state digest."""
    from sm3x_torch.core import prng
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.models.trimodal import TriModalSimCLR
    from sm3x_torch.train import common
    from sm3x_torch.train.backbone_train import ssl_update, trimodal_update

    world = 1 if rows is None else rows.world
    take = (lambda t, dim=0: t) if rows is None else rows.take
    v = take(torch.from_numpy(_views()[0]).double(), dim=1)
    lv = take(torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, B, 16, 16, 3))).double(), dim=1)
    codes = torch.from_numpy(np.random.default_rng(6).integers(0, 4, (B, 3)))
    out = {}
    for kind in ("crop", "tri"):
        torch.manual_seed(7)
        model = (build_ssl_model("v32", "resnet18", 16)[0] if kind == "crop"
                 else TriModalSimCLR("resnet18", 16, (4, 4, 4)))
        model.double().train()
        net = common.data_parallel(model, "cpu")
        opt = common.make_adamw(model.parameters(), LR, WD, eps=EPS)
        if kind == "crop":
            m = ssl_update(net, opt, (v[0], v[1]), (v[2], v[3]), 0, T, 2,
                           world=world, derm_locals=(lv[0], lv[1]),
                           clinic_locals=(lv[2], lv[3]), local_weight=0.5)
        else:
            m = trimodal_update(net, opt, (v[0], v[1]), (v[2], v[3]),
                                take(codes), prng.generator(20, "cpu"), T, 2,
                                rows)
        losses = [float(m["loss"])]
        out[kind] = {"losses": losses, "digest": _digest(model),
                     "params": {n: p.detach().clone()
                                for n, p in model.named_parameters()}}
    return out


def _fast_then_standard(init_path: str, rows=None) -> dict:
    """A fast step (`frozen_bn`) on the first views and a standard step on
    the second, float64, on this rank's rows (all without `rows`): the
    initial statistics, and the losses, parameters, statistics and state
    digest after each step."""
    from sm3x_torch.train import common
    from sm3x_torch.train.backbone_train import ssl_update

    model, style = _initial_model(init_path)
    model.double().train()
    net = common.data_parallel(model, "cpu")
    opt = common.make_adamw(model.parameters(), LR, WD, eps=EPS)
    views = torch.from_numpy(_views()).double()
    world = 1 if rows is None else rows.world
    stats = lambda: {n: b.clone() for n, b in model.named_buffers()}
    out = {"initial": stats(), "losses": [], "params": [], "stats": [],
           "digests": []}
    for s, frozen in enumerate((True, False)):
        v = views[s] if rows is None else rows.take(views[s], dim=1)
        m = ssl_update(net, opt, (v[0], v[1]), (v[2], v[3]), style, T,
                       GROUPS["local"], world=world, frozen_bn=frozen)
        out["losses"].append(float(m["loss"]))
        out["params"].append({n: p.detach().clone()
                              for n, p in model.named_parameters()})
        out["stats"].append(stats())
        out["digests"].append(_digest(model))
    return out


def _canvases():
    from sm3x_torch.data.synthetic import synthetic_canvas_batch

    d, dh, _ = synthetic_canvas_batch(B, 48, 5)
    c, ch, _ = synthetic_canvas_batch(B, 48, 6)
    return [torch.from_numpy(x) for x in (d, dh, c, ch)]


def _views_of(rows=None) -> dict:
    """Augmented views and dropout masks of this rank's rows."""
    import dataclasses

    from sm3x_torch.core import mesh, prng
    from sm3x_torch.models.transformer import dropout
    from sm3x_torch.ops import augment as A
    from sm3x_torch.train.backbone_train import augment_views
    from sm3x_torch.train.mlc_train import augment_pair

    canv = _canvases()
    if rows is not None:
        canv = [rows.take(x) for x in canv]
    d, dh, c, ch = canv
    out = {}
    ssl = dataclasses.replace(A.SSL_AUG, out_size=(SIZE, SIZE))
    out["ssl"] = torch.stack(augment_views(11, d, dh, MEAN, STD, ssl, rows))
    mlc = dataclasses.replace(A.MLC_TRAIN_AUG, out_size=(SIZE, SIZE))
    out["mlc"] = torch.stack(augment_pair(12, d, dh, c, ch, MEAN, STD, mlc,
                                          False, rows))
    fin = dataclasses.replace(A.FINETUNE_AUG, out_size=(SIZE, SIZE))
    out["finetune"] = A.supervised_augment_batch(
        prng.generator(13, "cpu"), c, ch, MEAN, STD, fin, rows)
    gen = prng.generator(14, "cpu")
    n = B if rows is None else rows.size
    crops = A.multicrop_augment_batch(
        15, d, dh, MEAN, STD, size_crops=(SIZE, 16), nmb_crops=(2, 3),
        min_scale_crops=(0.5, 0.14), max_scale_crops=(1.0, 0.5), rows=rows)
    out["crop_global"] = torch.stack(crops[:2])
    out["crop_local"] = torch.stack(crops[2:])
    with mesh.batch_rows(rows):
        out["drop0"] = dropout(torch.ones(n, 3, 5, dtype=torch.float64), 0.3,
                               True, gen)
        out["drop1"] = dropout(torch.ones(3, n, 5, dtype=torch.float64), 0.3,
                               True, gen, batch_dim=1)
    return out


FEED_FIELDS = ("derm", "derm_hw", "clinic", "clinic_hw", "label", "index",
               "mask")


def _split(data_dir: str, streaming: bool):
    from sm3x_torch.data.datasets import build_dataset

    return build_dataset("SevenPCBaseDataset", data_dir, "train",
                         cache_size=48, workers=1, streaming=streaming)


def _feed_batches(feed) -> list:
    return [{f: np.asarray(getattr(b, f)).copy() for f in FEED_FIELDS}
            for b in feed.batches(B, 1, 3)]


def _in_float64(model) -> None:
    """The float32 views into a float64 MLCModel, and its extractor's
    features (which it casts to float32) back to float64."""
    def views(module, args, kwargs):
        return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                     else a for a in args), kwargs

    model.register_forward_pre_hook(views, with_kwargs=True)
    model.extractor.register_forward_hook(lambda m, a, out: out.double())


def _stage2(log_path: str) -> dict:
    """The init pass and one epoch of MLCTrainer.fit in float64."""
    from sm3x_torch.core.config import MLCTrainConfig
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.train.mlc_train import MLCTrainer

    cfg = MLCTrainConfig()
    m = cfg.model
    m.arch, m.mlc_proj_dim, m.sa_dim_ff, m.num_heads = "resnet18", 16, 16, 1
    m.sa_dropout = 0.1
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (SIZE, SIZE), MEAN, STD
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = B, 1, False
    cfg.kmeans_iters = 3
    cfg.run.device, cfg.run.log_path = "cpu", log_path
    cfg.run.save_freq = cfg.run.ckpt_freq = 100
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        trainer = MLCTrainer(cfg)
        _in_float64(trainer.model)
        hist = trainer.fit(synthetic_paired_data(16, 48, seed=21))
    finally:
        torch.set_default_dtype(before)
    return {"losses": hist[0]["step_losses"], "bank": trainer.bank,
            "assignments": trainer.assignments,
            "centroids": [p.weight.detach() for p in trainer.model.prototypes],
            "digest": _digest(trainer.model, trainer.bank),
            "files": sorted(os.listdir(log_path))}


def _eval(log_path: str, kind: str = "mlc") -> dict:
    """One epoch of mlc_eval --finetune projector in float64, or of
    backbone_eval --finetune fc in float32, then the metrics of the test
    split and results.csv."""
    from sm3x_torch.core.config import EvalConfig
    from sm3x_torch.data.prefetch import wrap_from_config
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.train import supervised
    from sm3x_torch.train.backbone_eval import BackboneEvalTrainer
    from sm3x_torch.train.mlc_eval import MLCEvalTrainer

    cfg = EvalConfig()
    m = cfg.model
    m.arch, m.mlc_proj_dim, m.sa_dim_ff = "resnet18", 16, 16
    m.finetune = "projector" if kind == "mlc" else "fc"
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = (SIZE, SIZE), MEAN, STD
    cfg.train_sz = cfg.test_sz = SIZE
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = B, 1, False
    cfg.run.device, cfg.run.log_path = "cpu", log_path
    train = synthetic_paired_data(16, 48, seed=31)
    test = synthetic_paired_data(12, 48, seed=32)   # a wrap-padded batch
    before = torch.get_default_dtype()
    if kind == "mlc":
        torch.set_default_dtype(torch.float64)
    try:
        if kind == "mlc":
            trainer = MLCEvalTrainer(cfg)
            _in_float64(trainer.model)
        else:
            trainer = BackboneEvalTrainer(cfg)
        best = trainer.fit(train, test)
        wrapped = wrap_from_config(test, trainer.device, cfg.data)
        stats = supervised.run_eval_epoch(trainer, wrapped)
        preds, targets = supervised.collect_eval_logits(trainer, wrapped)
        trainer.write_results(wrapped, os.path.join(log_path, "results.csv"))
    finally:
        torch.set_default_dtype(before)
    return {"best": best, "stats": stats, "preds": preds,
            "targets": targets, "files": sorted(os.listdir(log_path))}


def _probe() -> dict:
    """Two epochs of the in-tool linear probe on a stage-1 model's frozen
    encoders: each rank extracts its rows, the probe is replicated."""
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.models.simclr import build_ssl_model
    from sm3x_torch.train.linear_probe import LinearProbe, make_ssl_extract_fn

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model, _ = build_ssl_model("v32", "resnet18", 16, img_size=SIZE)
    extract = make_ssl_extract_fn(model, "cpu", MEAN, STD, (SIZE, SIZE))
    probe = LinearProbe(1024, device="cpu")
    best = probe.run(extract, synthetic_paired_data(16, 48, seed=51),
                     synthetic_paired_data(12, 48, seed=52), B, epochs=2)
    return {"best": best, "heads": [p.detach().clone() for p in
                                    probe.model.parameters()]}


def _preempted(log_path: str) -> dict:
    """SSLTrainer.fit with --save-on-preempt over 3 epochs of 2 steps;
    rank 1 sends itself SIGTERM in its first step."""
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import synthetic_paired_data
    from sm3x_torch.parallel import process_info
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = 4, 3, False
    cfg.run.device, cfg.run.log_path = "cpu", log_path
    cfg.run.save_freq = cfg.run.ckpt_freq = 100
    cfg.run.save_on_preempt = True
    trainer = SSLTrainer(cfg)
    step = trainer.train_step

    def signalled(*args):
        if process_info()[0] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        trainer.train_step = step
        return step(*args)

    trainer.train_step = signalled
    hist = trainer.fit(synthetic_paired_data(8, 48, seed=41))
    return {"epochs": len(hist), "files": sorted(os.listdir(log_path))}


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def worker(out_dir: str, data_dir: str) -> None:
    from sm3x_torch.core.mesh import local_rows
    from sm3x_torch.data.prefetch import wrap_for_device
    from sm3x_torch.parallel import collectives as C

    torch.set_num_threads(1)
    init = os.path.join(out_dir, "init.pt")
    # the one-process runs, before the group exists
    ref = {k: _stage1(init, g) for k, g in GROUPS.items()}
    ref_paths = _stage1_paths()
    ref_fast = _fast_then_standard(init)
    assert C.distributed_initialize(backend="gloo")
    rank, world = C.process_info()
    rows = local_rows(B)
    got = {"rank": rank, "rows": (rows.start, rows.stop)}
    for k, g in GROUPS.items():
        run = _stage1(init, g, rows)
        want = dict(ref[k]["model"].named_parameters())
        got[k] = {
            "losses": run["losses"], "ref_losses": ref[k]["losses"],
            "digests": run["digests"],
            "param_err": max(float((p - want[n]).abs().max())
                             for n, p in run["model"].named_parameters()),
            "stats": {n: (b.clone(), ref[k]["model"].get_buffer(n).clone())
                      for n, b in run["model"].named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}
        if k == "local" and rank == 0:
            torch.save({n: p.detach().float() for n, p in
                        run["model"].named_parameters()},
                       os.path.join(out_dir, "stage1_params.pt"))
        del run
    del ref
    paths = _stage1_paths(rows)
    got["paths"] = {k: {"losses": run["losses"],
                        "ref_losses": ref_paths[k]["losses"],
                        "digest": run["digest"],
                        "param_err": max(float((p - ref_paths[k]["params"][n])
                                               .abs().max())
                                         for n, p in run["params"].items())}
                    for k, run in paths.items()}
    del paths, ref_paths
    run = _fast_then_standard(init, rows)
    got["fast"] = {
        "losses": run["losses"], "ref_losses": ref_fast["losses"],
        "digests": run["digests"],
        "param_err": [max(float((p - want[n]).abs().max())
                          for n, p in got_s.items())
                      for got_s, want in zip(run["params"],
                                             ref_fast["params"])],
        "kept": all(torch.equal(b, run["initial"][n])
                    for n, b in run["stats"][0].items()),
        "changed": all(not torch.equal(b, run["initial"][n])
                       for n, b in run["stats"][1].items()
                       if n.endswith(("running_mean", "running_var"))),
        "moved": {n: (b, ref_fast["stats"][1][n])
                  for n, b in run["stats"][1].items()
                  if n.endswith(("running_mean", "running_var"))}}
    del run, ref_fast
    got["views"] = _views_of(rows)
    host, stream = _split(data_dir, False), _split(data_dir, True)
    got["feed"] = {s: _feed_batches(wrap_for_device(host, "cpu", strategy=s))
                   for s in ("auto", "prefetch", "resident", "host")}
    got["feed"]["streaming"] = _feed_batches(wrap_for_device(stream, "cpu"))
    got["feed_types"] = type(wrap_for_device(host, "cpu")).__name__
    here = os.path.join(out_dir, f"rank{rank}")
    got["stage2"] = _stage2(os.path.join(here, "stage2"))
    got["eval"] = {k: _eval(os.path.join(here, f"eval_{k}"), k)
                   for k in ("mlc", "backbone")}
    got["preempt"] = _preempted(os.path.join(here, "preempt"))
    got["probe"] = _probe()
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    C.shutdown()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from sm3x.data.synthetic import make_fake_derm7pt

    root = tmp_path_factory.mktemp("mgpu7pc")
    make_fake_derm7pt(str(root), n_cases=24, img_size=56)
    return str(root)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's model and initial variables (float64 compute,
    float32 parameters)."""
    import jax
    import jax.numpy as jnp

    from sm3x.models.simclr import build_ssl_model as jax_build_ssl_model

    with jax.enable_x64(True):
        jm, style = jax_build_ssl_model("v32", "resnet18", 16,
                                        dtype=jnp.float64)
        x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float64)
        v = jm.init(jax.random.key(0), (x, x), (x, x), train=False)
    return jm, style, v


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data_dir, jax_init):
    """What the two workers saw; the JAX package's mesh steps run here
    meanwhile, on a thread of this process."""
    import threading

    from sm3x_torch.parallel.launch import launch_local
    from sm3x_torch.utils import weights

    out = tmp_path_factory.mktemp("multigpu")
    v = jax_init[2]
    torch.save(weights.to_tensors(weights.simclr_skin_state_dict(
        v["params"], v["batch_stats"])), out / "init.pt")
    jax_side = {}
    thread = threading.Thread(target=lambda: jax_side.update(
        result=_jax_mesh_steps(*jax_init)))
    thread.start()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    try:
        res = launch_local([sys.executable, os.path.abspath(__file__),
                            str(out), data_dir], 2, WORKER_TIMEOUT, env=env,
                           cwd=REPO)
    finally:
        thread.join()
    assert all(rc == 0 for rc, _ in res), "\n".join(o[-4000:] for _, o in res)
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    got[0]["stage1_params"] = torch.load(out / "stage1_params.pt")
    for name in ("stage1_params.pt", "init.pt"):
        os.remove(out / name)
    got[0]["jax"] = jax_side["result"]
    return got


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------

def _jax_mesh_steps(jm, style, v):
    """Losses and final parameters of the JAX package's step on a 2-device
    mesh, in float64 (parameters and AdamW moments in float32, as in
    test_torch_train_step.py)."""
    import jax
    import jax.numpy as jnp

    from sm3x.core.mesh import make_mesh, replicate, shard_batch
    from sm3x.losses.ssl import ssl_loss as jax_ssl_loss
    from sm3x.train import common as jax_common
    from sm3x_torch.utils import weights

    views = _views()
    mesh = make_mesh(devices=jax.devices()[:2])
    with jax.enable_x64(True):
        state = replicate(mesh, jax_common.create_train_state(
            jm, v, jax_common.make_adamw(LR, WD, eps=EPS)))

        @jax.jit
        def step(state, vs):
            def loss_fn(p):
                outs, mut = jm.apply(
                    {"params": p, "batch_stats": state.batch_stats},
                    (vs[0], vs[1]), (vs[2], vs[3]), train=True,
                    mutable=["batch_stats"])
                return jax_ssl_loss(outs, style, T, 2)[0], mut["batch_stats"]

            (loss, st), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            return state.apply_gradients(grads=grads, batch_stats=st), loss

        losses = []
        for s in range(STEPS):
            vs = shard_batch(mesh, tuple(jnp.asarray(v, jnp.float64)
                                         for v in views[s]))
            assert len(vs[0].sharding.device_set) == 2
            state, loss = step(state, vs)
            losses.append(float(loss))
        final = weights.simclr_skin_state_dict(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))
    return losses, final


def test_stage1_matches_the_jax_package_on_a_2_device_mesh(ranks):
    losses, final = ranks[0]["jax"]
    for g in ranks:
        np.testing.assert_allclose(g["local"]["losses"], losses, rtol=1e-5)
    far = total = 0
    for k, p in ranks[0]["stage1_params"].items():
        got = p.double().numpy()
        np.testing.assert_allclose(got, final[k], atol=3 * LR, err_msg=k)
        far += int((np.abs(got - final[k]) > 1e-2 * LR).sum())
        total += got.size
    assert far <= 1e-4 * total, f"{far} of {total} entries beyond 1e-2 x lr"


@pytest.mark.parametrize("config", list(GROUPS))
def test_stage1_on_two_ranks_is_the_one_process_run(ranks, config):
    for g in ranks:
        run = g[config]
        np.testing.assert_allclose(run["losses"], run["ref_losses"],
                                   rtol=1e-9)
        assert run["param_err"] <= 1e-3 * LR, run["param_err"]
        for name, (got, want) in run["stats"].items():
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                       err_msg=name)
    assert ranks[0][config]["digests"] == ranks[1][config]["digests"]
    # the reported loss is the global one on both ranks
    assert ranks[0][config]["losses"] == ranks[1][config]["losses"]


@pytest.mark.parametrize("kind", ["crop", "tri"])
def test_multicrop_and_trimodal_on_two_ranks_are_the_one_process_run(ranks,
                                                                     kind):
    """The local views' own batch norms, the 16-term and 9-term losses in
    one group a rank, and the metadata's dropout views drawn for the whole
    batch: two ranks take the one-process steps."""
    for g in ranks:
        run = g["paths"][kind]
        np.testing.assert_allclose(run["losses"], run["ref_losses"],
                                   rtol=1e-9)
        assert run["param_err"] <= 1e-3 * LR, run["param_err"]
    assert ranks[0]["paths"][kind]["digest"] == ranks[1]["paths"][kind][
        "digest"]
    assert ranks[0]["paths"][kind]["losses"] == ranks[1]["paths"][kind][
        "losses"]


def test_the_fast_step_on_two_ranks_is_the_one_process_step(ranks):
    """--bn-stat-freq's fast step under DDP: the model in eval mode on
    every rank, the gradients still all-reduced, no statistic moved."""
    for g in ranks:
        run = g["fast"]
        np.testing.assert_allclose(run["losses"], run["ref_losses"],
                                   rtol=1e-9)
        assert max(run["param_err"]) <= 1e-3 * LR, run["param_err"]
        assert run["kept"] and run["changed"]
        for name, (got, want) in run["moved"].items():
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                       err_msg=name)
    assert ranks[0]["fast"]["digests"] == ranks[1]["fast"]["digests"]
    assert ranks[0]["fast"]["losses"] == ranks[1]["fast"]["losses"]


def test_the_views_do_not_depend_on_the_process_count(ranks):
    assert [g["rows"] for g in ranks] == [(0, 4), (4, 8)]
    want = _views_of()
    for name, w in want.items():
        dim = 1 if name in ("ssl", "mlc", "drop1", "crop_global",
                            "crop_local") else 0
        got = torch.cat([g["views"][name] for g in ranks], dim=dim)
        assert torch.equal(got, w), name


def test_every_feed_gives_each_rank_its_rows(ranks, data_dir):
    assert ranks[0]["feed_types"] == "ProcessShardedData"
    want = _feed_batches(_split(data_dir, False))
    assert len(want) == 2 and not want[-1]["mask"].all()  # wrap-padded
    for r, g in enumerate(ranks):
        for name, batches in g["feed"].items():
            assert len(batches) == len(want), name
            for got, w in zip(batches, want):
                for f in FEED_FIELDS:
                    exp = w[f][4 * r:4 * r + 4] if f in (
                        "derm", "derm_hw", "clinic", "clinic_hw") else w[f]
                    np.testing.assert_array_equal(got[f], exp,
                                                  err_msg=f"{name} {f}")


# ---------------------------------------------------------------------------
# Stage 2, eval, preemption
# ---------------------------------------------------------------------------

def test_stage2_epoch_on_two_ranks_is_the_one_process_epoch(ranks, tmp_path):
    want = _stage2(str(tmp_path / "one"))
    a, b = ranks[0]["stage2"], ranks[1]["stage2"]
    assert torch.equal(a["assignments"], b["assignments"])
    assert torch.equal(a["assignments"], want["assignments"])
    assert a["digest"] == b["digest"] and a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], want["losses"], rtol=1e-9)
    np.testing.assert_allclose(a["bank"], want["bank"], rtol=1e-9,
                               atol=1e-12)
    for got, w in zip(a["centroids"], want["centroids"]):
        np.testing.assert_allclose(got, w, rtol=1e-9, atol=1e-12)
    assert a["files"] == ["ckp_0.pth", "log.txt"]
    assert b["files"] == ["log.txt.rank1"]


@pytest.mark.parametrize("kind,tol", [("mlc", 1e-9), ("backbone", 1e-4)])
def test_eval_metrics_are_the_same_on_every_rank(ranks, tmp_path, kind, tol):
    """mlc_eval in float64 (predictions float32 from the eval pass), the
    frozen-backbone backbone_eval in float32."""
    want = _eval(str(tmp_path / "one"), kind)
    a, b = ranks[0]["eval"][kind], ranks[1]["eval"][kind]
    assert a["best"] == b["best"] and a["stats"] == b["stats"]
    np.testing.assert_allclose(a["best"], want["best"], rtol=tol)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(a["stats"][k], v, rtol=tol, atol=tol,
                                   err_msg=k)
    assert len(a["preds"]) == 8 and len(a["targets"]) == 12
    for p, q, w in zip(a["preds"], b["preds"], want["preds"]):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_allclose(p, w, rtol=max(tol, 1e-6), atol=1e-6)
    np.testing.assert_array_equal(a["targets"], want["targets"])
    assert {"results.csv", "best_eval.pth"} <= set(a["files"])
    assert b["files"] == ["log.txt.rank1"]


def test_linear_probe_is_the_same_on_every_rank(ranks):
    want = _probe()
    a, b = ranks[0]["probe"], ranks[1]["probe"]
    assert a["best"] == b["best"]
    for p, q, w in zip(a["heads"], b["heads"], want["heads"]):
        assert torch.equal(p, q)
        np.testing.assert_allclose(p, w, rtol=1e-4, atol=1e-6)
    for k, v in want["best"].items():
        np.testing.assert_allclose(a["best"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_a_signal_to_one_rank_stops_both(ranks):
    a, b = ranks[0]["preempt"], ranks[1]["preempt"]
    assert a["epochs"] == b["epochs"] == 1
    assert "checkpoint.pth" in a["files"]
    assert b["files"] == ["log.txt.rank1"]   # its log and nothing else


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def test_mesh_data_on_one_process_trains_and_warns(tmp_path, caplog):
    """I1: the JAX package never reads --mesh-data (its trainers build the
    mesh from the devices); the port refused it with a ValueError."""
    import logging

    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.data.synthetic import SyntheticPairedData
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = B, 1, False
    cfg.run.device, cfg.run.log_path, cfg.run.mesh_data = ("cpu",
                                                           str(tmp_path), 2)
    logger = logging.getLogger("i1")
    with caplog.at_level(logging.WARNING, logger="i1"):
        trainer = SSLTrainer(cfg, logger=logger)
        hist = trainer.fit(SyntheticPairedData(B, canvas=48, seed=0))
    assert np.isfinite(hist[0]["loss"])
    assert "--mesh-data 2 ignored" in caplog.text
    assert trainer.groups == 1   # one process: one group of negatives
    cfg.run.mesh_model = 2
    with pytest.raises(ValueError, match=r"--mesh-model 2 does not divide "
                       r"the 1 process"):
        SSLTrainer(cfg, logger=logger)


def test_dryrun_prints_a_line_a_check(tmp_path):
    import subprocess

    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "dryrun_multigpu_torch.py"),
         "--nprocs", "2", "--cpu", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=400,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[dryrun]")]
    for check in ("process group", "stage-1 step", "stage-2 epoch",
                  "eval epoch"):
        assert any(check in ln and " ok" in ln for ln in lines), lines
    assert lines[-1].startswith("[dryrun] all checks passed")


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
