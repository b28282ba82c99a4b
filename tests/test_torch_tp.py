"""The port's tensor parallelism (--mesh-model > 1) on the CPU: the plans
against the JAX package's placement specs, the split state dicts, and four
gloo processes on a grid of 2 data x 2 model (this file run as a script,
with torchrun's environment from `sm3x_torch.parallel.launch`) against the
port's own one-process run and the JAX package's 2 x 2 mesh.

Without processes:
- `label_head_shardings` / `vit_tp_shardings` of sm3x_torch.core.mesh
  against the reference's of the same names on the JAX models' real
  parameter trees, carried to the port's keys by sm3x_torch.utils.weights:
  each leaf of the JAX tree is filled with the index of the model rank
  that holds each entry under the reference's spec (-1: replicated), so
  every port key must split on the counterpart axis, with each rank's
  block holding its own index, or be replicated where the reference
  replicates it (vit_s16, vit_t16 whose 3 heads fall back, the MLC model
  with v4 and v2 heads at L = 8; model 2 and 3);
- every model rank's split module holds exactly `shard_state_dict` of the
  whole model's state, and `unshard_state_dict` of the parts gives back
  the parameters and the AdamW moments exactly.

One launch of 4 ranks, data 2 x model 2 (`OMP_NUM_THREADS=1`); each
worker saves what it saw, and the test functions read it back:
- the grid: data and model index, the ranks of both groups in the
  reference's device order (rank r at data r // 2, model r % 2);
- stage 1 with vit_s16's blocks (dim 384, 6 heads of 64, MLP 1536) at a
  depth of 2 (`vit_cut`, registered in both packages), v32, 32x32, global
  batch 8, --world-size 4, two AdamW steps on fixed views in float64,
  the second under --use-checkpoint
  block (the recomputed blocks repeat their all-reduces): the losses
  against the one-process port run (rtol 1e-7) and against the JAX
  package's step on its 2 x 2 mesh with `vit_tp_shardings` (rtol 1e-5);
  rank 0's `ckp_0.pth` (the whole model and optimizer) against the
  one-process file (weights by tests/test_torch_multigpu.py's rule: atol
  3 x lr, at most 1e-4 of entries beyond 1e-2 x lr; moments rtol 1e-6);
  each rank's q weight (3 x 64, 384) and its AdamW moments likewise;
  replicated parameters bit-identical across every rank;
- one MLC stage-2 step (resnet18, 48x48, v4, mlc_proj_dim 32, batch 8)
  with fixed assignments, as tests/test_tp.py does, float64: 4 of the 8
  heads a rank, the loss and the bank against one process (B rows
  written, not 2 B); rank 0's checkpoint, resumed by a one-process
  trainer, gives the one-process run's next step;
- one mlc_eval step under --finetune projector and under all, float64:
  the loss and the whole model after the step against one process;
- one resnet18 stage-1 step: nothing split, the whole model against one
  process.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 400
NPROCS, MODEL = 4, 2

LR, WD, EPS, T = 1e-3, 5e-2, 1e-5, 0.1
B, SIZE, STEPS, GROUPS = 8, 32, 2, 4
MLC_SIZE, N_BANK = 48, 16
MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Without processes: the plans and the split state dicts
# ---------------------------------------------------------------------------

def _jax_trees(kind):
    """(params, batch_stats, port mapper, reference spec walkers) of a JAX
    model, its trees as shapes only (`jax.eval_shape`)."""
    import jax
    import jax.numpy as jnp

    from sm3x.core import mesh as jmesh
    from sm3x_torch.utils import weights

    if kind.startswith("vit"):
        from sm3x.models.simclr import build_ssl_model

        jm, _ = build_ssl_model("v32", kind, 16, dtype=jnp.float32)
        x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), (x, x),
                                                (x, x), train=False))
        return (shapes["params"], shapes.get("batch_stats", {}),
                weights.simclr_skin_state_dict,
                lambda mesh, tree, stats: (jmesh.vit_tp_shardings(mesh, tree),
                                           jmesh.label_head_shardings(
                                               mesh, stats, 0)))
    from sm3x.models.mlc import MLCModel as JaxMLCModel

    variant = kind.split("_")[1]
    jm = JaxMLCModel(arch="resnet18", proj_dim=32, mlc_proj=variant,
                     sa_dim_ff=16, dtype=jnp.float32)
    x = jnp.zeros((2, MLC_SIZE, MLC_SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, x, x,
        extractor_train=False, head_train=False))
    return (shapes["params"], shapes["batch_stats"],
            lambda p, s: weights.mlc_state_dict(p, s, variant),
            lambda mesh, tree, stats: (jmesh.label_head_shardings(mesh, tree),
                                       jmesh.label_head_shardings(mesh,
                                                                  stats)))


def _owners(shape_tree, spec_tree, model):
    """Each leaf filled with the model rank that holds each entry under
    the reference's spec, -1 where it is replicated."""
    import jax

    from sm3x.core.mesh import MODEL_AXIS

    def fill(shape, sharding):
        axes = [a for a, p in enumerate(sharding.spec) if p == MODEL_AXIS]
        if not axes:
            return np.full(shape.shape, -1, np.float32)
        n = shape.shape[axes[0]]
        owner = np.arange(n) * model // n
        view = [1] * len(shape.shape)
        view[axes[0]] = n
        return np.broadcast_to(owner.reshape(view),
                               shape.shape).astype(np.float32)

    return jax.tree.map(fill, shape_tree, spec_tree)


@pytest.mark.parametrize("model", [2, 3])
@pytest.mark.parametrize("kind", ["vit_s16", "vit_t16", "mlc_v4", "mlc_v2"])
def test_plans_split_what_the_reference_places_on_model(kind, model):
    import functools

    import jax

    from sm3x.core.mesh import make_mesh as jax_make_mesh
    from sm3x_torch.core.mesh import (head_of, label_head_shardings,
                                      vit_tp_shardings)

    params, stats, to_port, specs = _jax_trees(kind)
    mesh = jax_make_mesh(jax.devices()[:2 * model], model=model)
    p_spec, s_spec = specs(mesh, params, stats)
    sd = to_port(_owners(params, p_spec, model),
                 _owners(stats, s_spec, model) if stats else {})
    plan = (vit_tp_shardings if kind.startswith("vit")
            else functools.partial(label_head_shardings, num_labels=8))
    split = 0
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue   # no counterpart in the JAX tree
        dim = plan(key, v.shape, model)
        if dim is None:
            assert (v == -1).all(), key
        elif head_of(key) is not None:
            assert (v == head_of(key) * model // 8).all(), key
            split += 1
        else:
            for m, part in enumerate(np.split(v, model, axis=dim)):
                assert (part == m).all(), (key, m)
            split += 1
    want = {("vit_s16", 2): 2 * 12 * 10, ("vit_s16", 3): 2 * 12 * 10,
            ("vit_t16", 2): 2 * 12 * 3, ("vit_t16", 3): 2 * 12 * 10,
            ("mlc_v4", 2): 16, ("mlc_v4", 3): 0,
            ("mlc_v2", 2): 8 * 8, ("mlc_v2", 3): 0}[kind, model]
    assert split == want


VIT_CUT = dict(patch=16, dim=384, depth=2, n_heads=6)   # vit_s16's blocks


def _register_vit_cut(setitem, *modules):
    for mod in modules:
        setitem(mod.VIT_SPECS, "vit_cut", VIT_CUT)
        setitem(mod.VIT_FEAT_DIMS, "vit_cut", VIT_CUT["dim"])


def _whole_model(kind, monkeypatch):
    """A small port model of a split kind, from a seed: the stage-1 model
    with two of vit_s16's blocks an encoder, or the MLC model with v2
    heads."""
    from sm3x_torch.models import vit
    from sm3x_torch.models.mlc import MLCModel
    from sm3x_torch.models.simclr import build_ssl_model

    torch.manual_seed(0)
    if kind == "labels":
        return MLCModel("resnet18", proj_dim=32, mlc_proj="v2", sa_dim_ff=16,
                        img_size=MLC_SIZE)
    _register_vit_cut(monkeypatch.setitem, vit)
    return build_ssl_model("v32", "vit_cut", 16, img_size=SIZE)[0]


def _adamw_state(model):
    """One AdamW step on random gradients: {entry: {name: tensor}}."""
    params = [p for p in model.parameters()]
    opt = torch.optim.AdamW(params, lr=LR)
    gen = torch.Generator().manual_seed(1)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    names = {id(p): n for n, p in model.named_parameters()}
    return {e: {names[id(p)]: opt.state[p][e] for p in params}
            for e in ("exp_avg", "exp_avg_sq", "step")}


@pytest.mark.parametrize("model", [2, 3])
@pytest.mark.parametrize("kind", ["vit", "labels"])
def test_split_modules_hold_their_shard_and_the_parts_join(kind, model,
                                                           monkeypatch):
    import copy

    from sm3x_torch.core.mesh import Mesh
    from sm3x_torch.parallel.tensor import (shard_state_dict,
                                            tensor_parallel,
                                            unshard_state_dict)

    whole = _whole_model(kind, monkeypatch)
    sd = whole.state_dict()
    moments = _adamw_state(whole)
    shards, split = [], None
    plan_args = {"num_labels": 8} if kind == "labels" else {}
    for m in range(model):
        part = copy.deepcopy(whole)
        split = tensor_parallel(part, Mesh(data=1, model=model,
                                           model_index=m), kind, **plan_args)
        got = part.state_dict()
        want = shard_state_dict(sd, split.plan, model, m)
        assert list(got) == list(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
        shards.append(got)
    if kind == "labels" and model == 2:
        assert len(shards[1]) < len(sd)   # heads 4-7 only
        assert "projectors.projectors.5.0.weight" in shards[1]
        assert "projectors.projectors.1.0.weight" not in shards[1]
    if kind == "vit":
        q = "derm_backbone.encoder.block0.attn.query.weight"
        assert shards[0][q].shape == (384 // model, 384)
    back = unshard_state_dict(shards, split.plan,
                              {k: v.shape for k, v in sd.items()})
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    for entry, named in moments.items():
        parts = [shard_state_dict(named, split.plan, model, m)
                 for m in range(model)]
        shapes = {k: v.shape for k, v in named.items()}
        back = unshard_state_dict(parts, split.plan, shapes)
        assert list(back) == list(named)
        for k in named:
            assert torch.equal(back[k], named[k]), (entry, k)


# ---------------------------------------------------------------------------
# What the workers and the one-process reference both run
# ---------------------------------------------------------------------------

def _views() -> np.ndarray:
    return np.random.default_rng(3407).standard_normal(
        (STEPS, 4, B, SIZE, SIZE, 3))


def _canvases(seed: int, size: int):
    from sm3x_torch.data.synthetic import synthetic_canvas_batch

    d, dh, _ = synthetic_canvas_batch(B, size, seed)
    c, ch, _ = synthetic_canvas_batch(B, size, seed + 1)
    return [torch.from_numpy(x) for x in (d, dh, c, ch)]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).numpy().view(np.uint8).data)
    return h.hexdigest()


def _float64():
    """torch's default dtype float64 for the block (the trainers build
    their models in it)."""
    import contextlib

    @contextlib.contextmanager
    def block():
        before = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            yield
        finally:
            torch.set_default_dtype(before)

    return block()


def _in_float64(model) -> None:
    """The float32 views into a float64 MLCModel, and its extractor's
    features (which it casts to float32) back to float64."""
    def views(module, args, kwargs):
        return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                     else a for a in args), kwargs

    model.register_forward_pre_hook(views, with_kwargs=True)
    model.extractor.register_forward_hook(lambda m, a, out: out.double())


def _run(cfg, mesh_model: int, log_path: str):
    cfg.run.device, cfg.run.log_path, cfg.run.mesh_model = ("cpu", log_path,
                                                            mesh_model)
    cfg.run.seed, cfg.run.save_freq, cfg.run.ckpt_freq = 0, 1, 100
    cfg.optim.batch_size, cfg.optim.epochs, cfg.optim.amp = B, 1, False
    cfg.optim.base_lr = LR
    return cfg


def _vit(mesh_model: int, log_path: str, init_path: str) -> dict:
    """Two float64 steps of the `vit_cut` trainer on fixed views, from the
    JAX package's initial weights; the second with every block under
    checkpoint. Then `ckp_0.pth`, rank 0's."""
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.train.backbone_train import SSLTrainer, ssl_update

    cfg = _run(SSLConfig(), mesh_model, log_path)
    cfg.model.arch, cfg.model.arch_version = "vit_cut", "v32"
    cfg.model.proj_dim, cfg.model.temperature = 16, T
    cfg.model.use_checkpoint = "off"
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.run.world_size = GROUPS
    with _float64():
        trainer = SSLTrainer(cfg)
    init = torch.load(init_path)
    trainer.model.load_state_dict(
        init if trainer.tp is None else trainer.tp.shard(init), strict=True)
    views = torch.from_numpy(_views())
    rows = trainer.rows
    out = {"losses": []}
    for s in range(STEPS):
        if s == 1:   # --use-checkpoint block from here on
            for enc in (trainer.model.derm_backbone.encoder,
                        trainer.model.clinic_backbone.encoder):
                enc.remat, enc.block_remat = True, True
        v = rows.take(views[s], dim=1)
        m = ssl_update(trainer.net, trainer.optimizer, (v[0], v[1]),
                       (v[2], v[3]), trainer.style, T, trainer.groups,
                       world=rows.world)
        out["losses"].append(float(m["loss"]))
    q = trainer.model.derm_backbone.encoder.block0.attn.query.weight
    out["q_shape"] = tuple(q.shape)
    out["q_moments"] = {e: tuple(v.shape)
                        for e, v in trainer.optimizer.state[q].items()}
    plan = trainer.tp.plan if trainer.tp is not None else None
    out["replicated"] = _digest(
        v for k, v in trainer.model.state_dict().items()
        if plan is None or plan(k, trainer.tp.shapes[k], MODEL) is None)
    trainer.epoch_checkpoint(0)
    trainer.finish_checkpoints()
    return out


def _mlc_cfg(cfg, mesh_model: int, log_path: str):
    cfg = _run(cfg, mesh_model, log_path)
    m = cfg.model
    m.arch, m.mlc_proj, m.mlc_proj_dim = "resnet18", "v4", 32
    m.num_heads, m.sa_dim_ff, m.sa_dropout, m.temperature = 1, 16, 0.1, 1.0
    cfg.data.img_sz, cfg.data.mean, cfg.data.std = ((MLC_SIZE, MLC_SIZE),
                                                    MEAN, STD)
    return cfg


def _stage2_inputs(step: int, rows):
    d, dh, c, ch = (rows.take(x) for x in _canvases(20 + 2 * step, 72))
    rng = np.random.default_rng(step)
    assign = torch.from_numpy(rng.integers(0, 2, size=(8, N_BANK)))
    index = torch.arange(B) + (step % 2) * B
    return d, dh, c, ch, index, assign


def _stage2_trainer(mesh_model: int, log_path: str):
    from sm3x_torch.core.config import MLCTrainConfig
    from sm3x_torch.train.mlc_train import MLCTrainer

    with _float64():
        trainer = MLCTrainer(_mlc_cfg(MLCTrainConfig(), mesh_model, log_path))
    _in_float64(trainer.model)
    return trainer


def _stage2_step(trainer, step: int):
    """One stage-2 step with fixed targets; (loss, bank)."""
    bank = torch.zeros(8, N_BANK, 32, dtype=torch.float64)
    loss = trainer.train_step(bank, *_stage2_inputs(step, trainer.rows),
                              seed=100 + step)
    return float(loss), bank


def _stage2(mesh_model: int, log_path: str) -> dict:
    trainer = _stage2_trainer(mesh_model, log_path)
    loss, bank = _stage2_step(trainer, 0)
    heads = trainer.model.projectors.projectors
    out = {"loss": loss, "bank": bank,
           "heads": sorted(int(k) for k, _ in heads.named_children())}
    w = next(iter(heads.children()))[0].weight
    out["head_moments"] = tuple(trainer.optimizer.state[w]["exp_avg"].shape)
    trainer.epoch_checkpoint(0)
    trainer.finish_checkpoints()
    return out


def _eval(mesh_model: int, log_path: str, finetune: str) -> dict:
    """One mlc_eval step under `finetune`; the loss of the global batch and
    the whole model after it."""
    from sm3x_torch.core.config import EvalConfig
    from sm3x_torch.train.common import global_mean
    from sm3x_torch.train.mlc_eval import MLCEvalTrainer

    cfg = _mlc_cfg(EvalConfig(), mesh_model, log_path)
    cfg.model.finetune = finetune
    cfg.train_sz = cfg.test_sz = MLC_SIZE
    with _float64():
        trainer = MLCEvalTrainer(cfg)
    _in_float64(trainer.model)
    rows = trainer.rows
    labels = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, size=(B, 8)))
    loss, _ = trainer.train_step(*(rows.take(x) for x in _canvases(30, 72)),
                                 rows.take(labels), 7)
    return {"loss": float(global_mean(loss)),
            "state": {k: v.clone() for k, v in trainer.model_state().items()}}


def _resnet(mesh_model: int, log_path: str) -> dict:
    """One resnet18 stage-1 step through the trainer's own step (views
    from the seed); the whole model after it."""
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.train.backbone_train import SSLTrainer
    from sm3x_torch.train.common import map_tensors

    cfg = _run(SSLConfig(), mesh_model, log_path)
    cfg.model.arch, cfg.model.proj_dim, cfg.model.temperature = ("resnet18",
                                                                 16, T)
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.run.world_size = GROUPS
    with _float64():
        trainer = SSLTrainer(cfg)
    trainer.model.register_forward_pre_hook(   # the float32 views in float64
        lambda mod, args: map_tensors(
            lambda t: t.double() if t.is_floating_point() else t, args))
    rows = trainer.rows
    m = trainer.train_step(*(rows.take(x) for x in _canvases(40, 48)), 9)
    return {"loss": float(m["loss"]), "split": trainer.tp is not None,
            "state": {k: v.clone() for k, v in trainer.model_state().items()}}


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def worker(out_dir: str) -> None:
    import gc

    import torch.distributed as dist

    from sm3x_torch.core.mesh import make_mesh
    from sm3x_torch.models import vit
    from sm3x_torch.parallel import collectives as C

    torch.set_num_threads(1)
    _register_vit_cut(lambda d, k, v: d.__setitem__(k, v), vit)
    assert C.distributed_initialize(backend="gloo")
    rank, _ = C.process_info()
    mesh = make_mesh(MODEL)
    got = {"rank": rank,
           "grid": (mesh.data, mesh.model, mesh.data_index, mesh.model_index),
           "groups": (dist.get_process_group_ranks(mesh.data_group),
                      dist.get_process_group_ranks(mesh.model_group))}
    got["vit"] = _vit(MODEL, os.path.join(out_dir, "vit"),
                      os.path.join(out_dir, "init.pt"))
    gc.collect()
    got["stage2"] = _stage2(MODEL, os.path.join(out_dir, "stage2"))
    gc.collect()
    got["eval"] = {f: _eval(MODEL, os.path.join(out_dir, f"eval_{f}"), f)
                   for f in ("projector", "all")}
    if rank != 0:   # the whole states are rank 0's to keep
        for e in got["eval"].values():
            del e["state"]
    gc.collect()
    got["resnet"] = _resnet(MODEL, os.path.join(out_dir, "resnet"))
    if rank != 0:
        del got["resnet"]["state"]
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    C.shutdown()


# ---------------------------------------------------------------------------
# The launch, and the JAX package's 2 x 2 mesh beside it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_cut():
    """`vit_cut` registered in both packages' ViT tables while the module's
    tests run."""
    from sm3x.models import vit as jax_vit
    from sm3x_torch.models import vit

    with pytest.MonkeyPatch.context() as mp:
        _register_vit_cut(mp.setitem, jax_vit, vit)
        yield


@pytest.fixture(scope="module")
def jax_init(vit_cut):
    """The JAX package's `vit_cut` v32 model and initial variables (float64
    compute, float32 parameters)."""
    import jax
    import jax.numpy as jnp

    from sm3x.models.simclr import build_ssl_model as jax_build_ssl_model

    with jax.enable_x64(True):
        jm, style = jax_build_ssl_model("v32", "vit_cut", 16,
                                        dtype=jnp.float64)
        x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float64)
        v = jm.init(jax.random.key(0), (x, x), (x, x), train=False)
    return jm, style, jax.device_get(v)


def _jax_mesh_steps(jm, style, v):
    """The losses of the JAX package's step on a 2 data x 2 model mesh,
    the parameters placed by `vit_tp_shardings`, the views by `shard_batch`,
    in float64."""
    import jax
    import jax.numpy as jnp

    from sm3x.core.mesh import (make_mesh, replicate, shard_batch,
                                vit_tp_shardings)
    from sm3x.losses.ssl import ssl_loss as jax_ssl_loss
    from sm3x.train import common as jax_common

    views = _views()
    mesh = make_mesh(jax.devices()[:4], model=2)
    with jax.enable_x64(True):
        state = jax_common.create_train_state(
            jm, v, jax_common.make_adamw(LR, WD, eps=EPS))
        params = jax.tree.map(jax.device_put, state.params,
                              vit_tp_shardings(mesh, state.params))
        state = state.replace(params=params,
                              opt_state=replicate(mesh, state.opt_state),
                              batch_stats=replicate(mesh, state.batch_stats))

        @jax.jit
        def step(state, vs):
            def loss_fn(p):
                outs, mut = jm.apply(
                    {"params": p, "batch_stats": state.batch_stats},
                    (vs[0], vs[1]), (vs[2], vs[3]), train=True,
                    mutable=["batch_stats"])
                return (jax_ssl_loss(outs, style, T, GROUPS)[0],
                        mut["batch_stats"])

            (loss, st), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            return state.apply_gradients(grads=grads, batch_stats=st), loss

        losses = []
        for s in range(STEPS):
            vs = shard_batch(mesh, tuple(jnp.asarray(x, jnp.float64)
                                         for x in views[s]))
            state, loss = step(state, vs)
            losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def jax_mesh_losses(jax_init):
    """The JAX package's 2 x 2 mesh steps, run after the workers have
    ended (a test asks for them after `ranks`): the file's processes then
    do not hold the JAX side's memory and the workers' at once."""
    return _jax_mesh_steps(*jax_init)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    """What the four workers saw, and rank 0's checkpoints. The files go
    when the module's tests are done."""
    import shutil

    from sm3x_torch.parallel.launch import launch_local
    from sm3x_torch.utils import weights

    out = tmp_path_factory.mktemp("tp")
    v = jax_init[2]
    torch.save(weights.to_tensors(weights.simclr_skin_state_dict(
        v["params"], v["batch_stats"])), out / "init.pt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = launch_local([sys.executable, os.path.abspath(__file__),
                        str(out)], NPROCS, WORKER_TIMEOUT, env=env, cwd=REPO)
    assert all(rc == 0 for rc, _ in res), "\n".join(o[-4000:] for _, o in res)
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(NPROCS)]
    got[0]["out"] = out
    yield got
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def one_process(ranks, vit_cut, tmp_path_factory):
    """The port's one-process runs of the same work, in this process (its
    files go when the module's tests are done)."""
    import gc
    import shutil

    out = tmp_path_factory.mktemp("tp_one")
    one = {"vit": _vit(1, str(out / "vit"), str(ranks[0]["out"] / "init.pt"))}
    gc.collect()
    one["stage2"] = _stage2(1, str(out / "stage2"))
    one["eval"] = {f: _eval(1, str(out / f"eval_{f}"), f)
                   for f in ("projector", "all")}
    one["resnet"] = _resnet(1, str(out / "resnet"))
    one["out"] = out
    yield one
    shutil.rmtree(out, ignore_errors=True)


def _close(got, want, name=""):
    """tests/test_torch_multigpu.py's rule for weights: atol 3 x lr, at most
    1e-4 of the entries beyond 1e-2 x lr."""
    got, want = got.double().numpy(), want.double().numpy()
    np.testing.assert_allclose(got, want, atol=3 * LR, err_msg=name)
    far = int((np.abs(got - want) > 1e-2 * LR).sum())
    return far, got.size


def _states_close(got: dict, want: dict):
    assert list(got) == list(want)
    far = total = 0
    for k in want:
        if not want[k].is_floating_point():
            assert torch.equal(got[k], want[k]), k
            continue
        f, n = _close(got[k], want[k], k)
        far, total = far + f, total + n
    assert far <= 1e-4 * total, f"{far} of {total} entries beyond 1e-2 x lr"


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

def test_the_grid_is_data_by_model_in_the_reference_order(ranks):
    for r, g in enumerate(ranks):
        assert g["rank"] == r
        assert g["grid"] == (2, 2, r // 2, r % 2)
        assert g["groups"] == ([r % 2, r % 2 + 2], [r - r % 2, r - r % 2 + 1])


# ---------------------------------------------------------------------------
# Stage 1, ViT
# ---------------------------------------------------------------------------

def test_vit_stage1_losses_are_the_one_process_run_and_the_jax_mesh(
        ranks, one_process, jax_mesh_losses):
    want = one_process["vit"]["losses"]
    for g in ranks:
        np.testing.assert_allclose(g["vit"]["losses"], want, rtol=1e-7)
        assert g["vit"]["losses"] == ranks[0]["vit"]["losses"]
    np.testing.assert_allclose(ranks[0]["vit"]["losses"], jax_mesh_losses,
                               rtol=1e-5)


def test_vit_ranks_hold_their_slices_and_replicate_the_rest(ranks,
                                                            one_process):
    for g in ranks:
        assert g["vit"]["q_shape"] == (3 * 64, 384)
        assert g["vit"]["q_moments"] == {"step": (), "exp_avg": (192, 384),
                                         "exp_avg_sq": (192, 384)}
        assert g["vit"]["replicated"] == ranks[0]["vit"]["replicated"]
    assert one_process["vit"]["q_shape"] == (384, 384)


def test_vit_checkpoint_is_whole_and_the_one_process_file(ranks,
                                                          one_process):
    got = torch.load(ranks[0]["out"] / "vit" / "ckp_0.pth",
                     weights_only=False)
    want = torch.load(one_process["out"] / "vit" / "ckp_0.pth",
                      weights_only=False)
    assert sorted(os.listdir(ranks[0]["out"] / "vit")) == [
        "ckp_0.pth", "log.txt", "log.txt.rank1", "log.txt.rank2",
        "log.txt.rank3"]
    _states_close(got["state_dict"], want["state_dict"])
    go, wo = got["optimizer"], want["optimizer"]
    assert go["param_groups"] == wo["param_groups"]
    assert list(go["state"]) == list(wo["state"])
    for i, w in wo["state"].items():
        for e, t in w.items():
            np.testing.assert_allclose(go["state"][i][e], t, rtol=1e-6,
                                       atol=1e-12, err_msg=f"{i} {e}")


# ---------------------------------------------------------------------------
# Stage 2 and mlc_eval
# ---------------------------------------------------------------------------

def test_stage2_step_splits_the_heads_and_is_the_one_process_step(
        ranks, one_process):
    want = one_process["stage2"]
    for r, g in enumerate(ranks):
        s = g["stage2"]
        assert s["heads"] == list(range(4 * (r % 2), 4 * (r % 2) + 4))
        assert s["head_moments"] == (32, 2 * 512)
        np.testing.assert_allclose(s["loss"], want["loss"], rtol=1e-7)
        # B rows of the bank written, each once, as on one process
        assert s["bank"].shape == (8, N_BANK, 32)
        np.testing.assert_allclose(s["bank"], want["bank"], rtol=1e-7,
                                   atol=1e-12)
    assert want["heads"] == list(range(8))


def test_stage2_checkpoint_resumes_at_model_1_into_the_next_step(
        ranks, one_process, tmp_path):
    path = ranks[0]["out"] / "stage2" / "ckp_0.pth"
    ckpt = torch.load(path, weights_only=False)
    whole = torch.load(one_process["out"] / "stage2" / "ckp_0.pth",
                       weights_only=False)
    _states_close(ckpt["state_dict"], whole["state_dict"])
    # the one-process run's next step, and the same step after a resume
    ref = _stage2_trainer(1, str(tmp_path / "ref"))
    _stage2_step(ref, 0)
    want_loss, _ = _stage2_step(ref, 1)
    resumed = _stage2_trainer(1, str(tmp_path / "resumed"))
    assert resumed.resume(str(path))
    loss, _ = _stage2_step(resumed, 1)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-7)
    _states_close({k: v for k, v in resumed.model.state_dict().items()},
                  {k: v for k, v in ref.model.state_dict().items()})


@pytest.mark.parametrize("finetune", ["projector", "all"])
def test_mlc_eval_step_is_the_one_process_step(ranks, one_process,
                                               finetune):
    want = one_process["eval"][finetune]
    for g in ranks:
        np.testing.assert_allclose(g["eval"][finetune]["loss"], want["loss"],
                                   rtol=1e-7)
    _states_close(ranks[0]["eval"][finetune]["state"], want["state"])


def test_resnet_stage1_replicates_and_is_the_one_process_step(ranks,
                                                              one_process):
    want = one_process["resnet"]
    for g in ranks:
        assert not g["resnet"]["split"]
        np.testing.assert_allclose(g["resnet"]["loss"], want["loss"],
                                   rtol=1e-7)
    _states_close(ranks[0]["resnet"]["state"], want["state"])


if __name__ == "__main__":
    worker(sys.argv[1])
