"""Optimizer, freeze-policy, checkpoint and process helpers shared by the
trainers (counterpart of sm3x/train/common.py).

The JAX package freezes parameters with an optimizer mask (optax
`multi_transform` with `set_to_zero` on the masked leaves): a frozen tensor
gets no update and no weight decay. Here the same policy decides which
parameters the optimizer is given at all."""

from __future__ import annotations

import math
import os
import signal
import threading

import torch

from sm3x_torch.core.mesh import (current_mesh, data_group, local_rows,
                                  make_mesh)
from sm3x_torch.data.prefetch import indexed
from sm3x_torch.parallel.collectives import (  # noqa: F401  (re-exported)
    is_distributed, is_main_process, max_over_ranks, process_info)
from sm3x_torch.parallel.tensor import tensor_parallel
from sm3x_torch.utils.profiling import annotate, count


def make_adamw(params, lr: float, wd: float = 5e-2, eps: float = 1e-8,
               fused: bool = False) -> torch.optim.AdamW:
    """torch.optim.AdamW with betas (0.9, 0.999) and decoupled weight decay
    on every tensor, as the JAX package configures optax.adamw
    (sm3x/train/common.py:24-36). Stage 1 passes eps 1e-5, the other
    stages keep the 1e-8 default; the lr is constant, as in run.sh.
    `fused`: torch's fused update, one multi-tensor kernel over the
    parameters with the step counts on their device, which a CUDA graph
    can hold (`GraphedStep`; torch asks a captured optimizer to be built
    `capturable` too)."""
    graph = dict(fused=True, capturable=True) if fused else {}
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                             weight_decay=wd, **graph)


def load_optimizer_state(optimizer, state: dict) -> None:
    """`optimizer.load_state_dict(state)`, with each group left as fused
    and capturable as `optimizer` was built: the file's groups carry the
    flags of the trainer that wrote them, and a fused group keeps its step
    counts on its parameters' device in float32, the others on the host."""
    kept = [{k: g[k] for k in ("fused", "capturable") if k in g}
            for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, flags in zip(optimizer.param_groups, kept):
        if not flags:
            continue
        group.update(flags)
        on_device = bool(flags.get("fused") or flags.get("capturable"))
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = (st["step"].to(p.device, torch.float32)
                              if on_device else st["step"].cpu())


def mlc_train_trainable(name: str, finetune_backbone: bool = False) -> bool:
    """Stage 2's freeze policy over the model's parameter names: the whole
    extractor is frozen unless --finetune-backbone; the head always trains
    (its prototype weights are also overwritten by k-means every epoch)."""
    if name.startswith("extractor."):
        return finetune_backbone
    return True


def mlc_eval_trainable(name: str, finetune: str = "projector") -> bool:
    """The eval stage's freeze policies over `MLCModel`'s parameter names
    (the model is its own head: `projectors.*`, `mlc_sa.*`, `prototypes.*`
    beside `extractor.*`):
      fc        -> only the prototype heads train
      projector -> the whole head (projectors, mlc_sa, prototypes) trains
      all       -> the head and the encoders' layer1-4 train; the stem
                   (conv1, bn1) stays frozen
    """
    head = not name.startswith("extractor.")
    if finetune == "fc":
        return name.startswith("prototypes.")
    if finetune == "projector":
        return head
    if finetune == "all":
        return head or ".encoder.layer" in name
    raise ValueError(f"unknown finetune policy {finetune!r}")


def backbone_eval_trainable(name: str, finetune: str = "fc") -> bool:
    """`Baseline` under --finetune: `fc` freezes both backbones, anything
    else trains everything."""
    if finetune == "fc":
        return name.startswith("classifier.")
    return True


def trainable_parameters(model: torch.nn.Module, predicate) -> list:
    """The parameters whose names `predicate` accepts, for the optimizer;
    the others are switched off for autograd and stay as they are."""
    chosen = []
    for name, param in model.named_parameters():
        keep = bool(predicate(name))
        param.requires_grad_(keep)
        if keep:
            chosen.append(param)
    return chosen


def drain_losses(pending: list, meter, out: list) -> None:
    """Read back the deferred (loss tensor, batch size) pairs: one wait for
    the device where a read-back a step would stall every step. Each read
    is a synchronising call (counted in `host.device_waits`); only the
    first finds work in the stream."""
    if not pending:
        return
    with annotate("trainer.drain"):
        count("host.device_waits", len(pending))
        for loss, n in pending:
            out.append(float(loss))
            meter.update(out[-1], n)
        pending.clear()


def warmup_cosine_factor(base_lr: float, final_lr: float, warmup_epochs: int,
                         total_epochs: int, steps_per_epoch: int,
                         start_warmup: float = 0.0):
    """--use-lr-schedule as a `LambdaLR` factor: step -> lr(step) / base_lr
    of the JAX package's `warmup_cosine_schedule` (sm3x/train/common.py:
    105-130, optax's schedules). With warm-up the lr rises linearly from
    `start_warmup` to `base_lr` over `warmup_epochs * steps_per_epoch` steps
    and falls on a half cosine to `final_lr` at the last step;
    `warmup_epochs=0` is the plain cosine from `base_lr` to `final_lr`,
    with no first step at `start_warmup`."""
    warm = warmup_epochs * steps_per_epoch
    total = total_epochs * steps_per_epoch
    if not base_lr:
        return lambda step: 1.0
    if warm == 0:
        decay, alpha = max(total, 1), final_lr / base_lr

        def plain(step: int) -> float:
            cos = 0.5 * (1.0 + math.cos(math.pi * min(step, decay) / decay))
            return (1.0 - alpha) * cos + alpha

        return plain
    decay = max(total, 2) - warm
    if decay <= 0:
        raise ValueError(f"the cosine needs steps after the warm-up: "
                         f"{warm} warm-up steps of {total}")

    def warm_then_cosine(step: int) -> float:
        if step < warm:
            lr = start_warmup + (base_lr - start_warmup) * step / warm
        else:
            cos = 0.5 * (1.0 + math.cos(
                math.pi * min(step - warm, decay) / decay))
            lr = final_lr + (base_lr - final_lr) * cos
        return lr / base_lr

    return warm_then_cosine


def map_tensors(fn, obj):
    """`obj` with `fn` applied to every tensor inside its dicts, lists and
    tuples; anything else as it is."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def write_checkpoint(paths, state: dict) -> None:
    """Fetch `state` to the host once and write it to every path, each
    through a temporary file beside it, so that a reader finds the old file
    or the new one and never a part of one."""
    host = map_tensors(lambda t: t.detach().cpu(), state)
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(host, tmp)
        os.replace(tmp, path)


def data_axis(cfg, logger):
    """This rank's rows of every global batch of `-b` (all of them on one
    process), on the run's grid of the processes over --mesh-model
    (sm3x_torch.core.mesh.make_mesh, which refuses a model size that does
    not divide them); after a word where --mesh-data names another data
    axis than that: the JAX package builds its mesh from the devices and
    never reads the flag, and the port follows it."""
    mesh = make_mesh(cfg.run.mesh_model)
    if cfg.run.mesh_data not in (None, mesh.data):
        logger.warning(f"--mesh-data {cfg.run.mesh_data} ignored: the data "
                       f"axis is the run's {mesh.data} process(es) over "
                       f"--mesh-model {mesh.model}")
    return local_rows(cfg.optim.batch_size)


def data_parallel(model: torch.nn.Module, device) -> torch.nn.Module:
    """What a train step calls: `model` itself on one process, under
    DistributedDataParallel over the data group where a process group is up
    (world size 1 included). The running statistics need no broadcast (the
    global-batch BatchNorm keeps them equal on every rank) and the
    gradients live in DDP's buckets. Checkpoints come from `model`, with
    the keys of a single-process run."""
    if not is_distributed():
        return model
    from torch.nn.parallel import DistributedDataParallel

    device = indexed(device)
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, gradient_as_bucket_view=True,
        process_group=data_group())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis of a detached device value (a loss);
    one all-reduce on the device, read back when the caller reads it."""
    from sm3x_torch.parallel.collectives import cross_replica_mean

    return cross_replica_mean(x.detach(), data_group())


# --- one update as a CUDA graph -------------------------------------------

LAUNCH_TALLIES = ("launches", "variants", "shapes")


def launch_tallies() -> dict:
    """The host's counts of the port's kernel launches
    (`sm3x_torch.ops.counted_kernels`): {(wrapper, attribute, key):
    count}, `key` the kernel or shape counted in a dict of counts, None
    for a plain count."""
    from sm3x_torch.ops import counted_kernels

    out = {}
    for fn in counted_kernels():
        for attr in LAUNCH_TALLIES:
            v = getattr(fn, attr, None)
            if isinstance(v, dict):
                out.update({(fn, attr, k): n for k, n in v.items()})
            elif v is not None:
                out[fn, attr, None] = v
    return out


def add_launch_tallies(delta: dict, sign: int = 1) -> None:
    """Add `delta` (`launch_tallies`' layout) to the wrappers' counts."""
    for (fn, attr, key), n in delta.items():
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + sign * n)
        else:
            counts = getattr(fn, attr)
            counts[key] = counts.get(key, 0) + sign * n


class GraphedStep:
    """A train step whose update replays as one CUDA graph.

    `step(*tensors, seed)` is the step as it runs without a graph (kept as
    `eager`); `step.update(*tensors, generators)` the same update on the
    generators that `step.seeds(seed)` seeds, returning a dict of device
    scalars: the eager step is `update` on fresh generators from those
    seeds. A call whose tensors have the shapes, dtypes and devices of the
    call before it, and no graph yet, captures `update` on buffers the
    graph owns (its own memory pool and generators) and replays it at once;
    every later call of those shapes copies its tensors into the buffers
    (device to device), seeds the generators as the eager step would
    (`manual_seed` restarts Philox's offset, so a replay draws what a fresh
    generator draws) and replays. Any other call, and every call under
    autograd's anomaly mode (`enable_nan_checks` reads values back inside
    the step), runs the eager step. So each call is one update, and the
    first, which makes the optimizer's state and fires one-shot hooks, runs
    outside any capture.

    A call returns copies of the graph's outputs. The kernels' host launch
    counts that the capture made are added again at each replay. Counters:
    `trainer.graph_captures`, `trainer.graph_replays` and
    `trainer.graph_eager_steps`; a replay is the span `trainer.replay`
    inside `trainer.step`. The capture is thread-local: another thread's
    CUDA calls (a feed's producer, a checkpoint's writer) cannot break
    it."""

    def __init__(self, step):
        self.eager = step
        self.graph = None
        self.shapes = None       # of the graph's inputs, or of the last call
        self.static = self.generators = self.packed = self.keys = None
        self.launches = {}       # the kernels' host counts of one replay

    def __call__(self, *args) -> dict:
        *tensors, seed = args
        shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)
        if shapes != self.shapes or torch.is_anomaly_enabled():
            if self.graph is None:
                self.shapes = shapes
            count("trainer.graph_eager_steps")
            return self.eager(*args)
        with annotate("trainer.step"):
            if self.graph is None:
                self._capture(tensors)
            with annotate("trainer.replay"):
                for buf, t in zip(self.static, tensors):
                    buf.copy_(t)
                for g, s in zip(self.generators, self.eager.seeds(seed)):
                    g.manual_seed(s)
                self.graph.replay()
                add_launch_tallies(self.launches)
                out = self.packed.clone()
            count("trainer.graph_replays")
        return dict(zip(self.keys, out.unbind()))

    def _capture(self, tensors) -> None:
        self.static = [t.clone() for t in tensors]
        self.generators = [torch.Generator(device=tensors[0].device)
                           for _ in self.eager.seeds(0)]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = launch_tallies()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.eager.update(*self.static, self.generators)
            self.packed = torch.stack(list(out.values()))
        self.keys = list(out)
        # the capture launched nothing: each replay counts its launches
        self.launches = {k: n - before.get(k, 0)
                         for k, n in launch_tallies().items()
                         if n != before.get(k, 0)}
        add_launch_tallies(self.launches, -1)
        self.graph = graph
        count("trainer.graph_captures")


class CheckpointableTrainer:
    """What the trainers share around their loops; a trainer sets `cfg`,
    `model`, `optimizer`, `device` and `logger`. Checkpoints are `.pth`
    files in the reference's `{"epoch", "state_dict"}` wrapper, with the
    model's keys in the layout of the exported checkpoints, the optimizer's
    state beside them, and whatever else the trainer needs to go on
    (`extra_state`). `resume` reads one back, and every `fit` loop starts
    at `start_epoch`.

    The epoch loop does not wait for a checkpoint: `save_async` clones the
    state on the device and a background thread fetches, serialises and
    writes it (one save in flight). Every `fit` ends in
    `finish_checkpoints`, so `resume` and the end of the process find whole
    files. With --save-on-preempt SIGTERM / SIGINT become a checkpoint and
    a clean end of the loop at the next epoch boundary.

    Under tensor parallelism (`split_model`, --mesh-model > 1) a file holds
    the whole model and the whole optimizer, in the layout of a
    one-process run: before rank 0 writes, every rank takes part in
    gathering the split tensors over its model group (`live_state`), and
    `resume` cuts each rank's part out of the whole file. So a file moves
    between model sizes, one process included."""

    start_epoch: int = 0
    tp = None   # sm3x_torch.parallel.tensor.Split of a split model
    _best = None
    _save_thread = None
    _save_error = None
    _preempt_signal = None
    _orig_handlers = None

    def extra_state(self) -> dict:
        """What a trainer keeps beside the model and the optimizer; tensors
        as they are, on their device."""
        return {}

    def restore_extra_state(self, ckpt: dict) -> None:
        pass

    def split_model(self, kind: str, **plan_args) -> None:
        """Split `model` over the model axis of the run's grid (nothing with
        --mesh-model 1): "vit" for the ViT blocks, "labels" for the label
        heads (sm3x_torch.parallel.tensor.tensor_parallel). Before DDP and
        the optimizer see the parameters."""
        self.tp = tensor_parallel(self.model, current_mesh(), kind,
                                  **plan_args)
        if self.tp is not None:
            self.logger.info(
                f"tensor parallelism: {kind} split over the grid "
                f"{self.tp.mesh.shape}, this rank at model index "
                f"{self.tp.mesh.model_index}")

    def model_state(self) -> dict:
        """The model's state dict, whole (gathered over the model group
        under tensor parallelism: every rank must call it then)."""
        sd = {k: v.detach() for k, v in self.model.state_dict().items()}
        return sd if self.tp is None else self.tp.gather(sd)

    def live_state(self, epoch: int) -> dict:
        """The checkpoint's content with the tensors the run is using;
        under tensor parallelism the whole model and optimizer, gathered
        (every rank must call it)."""
        optim = (self.optimizer.state_dict() if self.tp is None else
                 self.tp.whole_optimizer_state(self.model, self.optimizer))
        return {
            "epoch": epoch + 1,
            "state_dict": self.model_state(),
            "optimizer": optim,
            **self.extra_state(),
        }

    def _state_to_write(self, epoch: int):
        """What rank 0 writes, taken on every rank where it has to be
        gathered; None where `save` / `save_async` take it themselves."""
        return None if self.tp is None else self.live_state(epoch)

    def state_dict(self, epoch: int) -> dict:
        """The checkpoint's content on the host."""
        return map_tensors(lambda t: t.detach().cpu(), self.live_state(epoch))

    def save_async(self, paths, epoch: int, state=None) -> None:
        """Write the state as it stands to `paths` (one path or several;
        several share one fetch) without holding the loop for the transfer
        and the disk: every tensor is cloned on its device first, so the
        next step cannot change what is written, then a background thread
        fetches, serialises and writes. One save is in flight at a time:
        the one before is waited for here, which bounds the extra device
        memory to one state. `state`: the content to write where the
        caller took it already (`live_state`)."""
        if isinstance(paths, str):
            paths = [paths]
        snap = map_tensors(lambda t: t.detach().clone(),
                           self.live_state(epoch) if state is None else state)
        cloned, device = None, indexed(self.device)
        if device.type == "cuda":
            # the clones are queued on the loop's stream; the thread copies
            # them out on a stream of its own, beside the next steps
            cloned = torch.cuda.Event()
            cloned.record(torch.cuda.current_stream(device))
        self.flush_saves()
        pending = [snap]   # the thread takes it out, and frees it when done
        del snap

        def work():
            try:
                state = pending.pop()
                if cloned is None:
                    write_checkpoint(paths, state)
                    return
                torch.cuda.set_device(device)
                side = torch.cuda.Stream(device)
                side.wait_event(cloned)
                with torch.cuda.stream(side):
                    write_checkpoint(paths, state)
            except BaseException as e:  # raised again by flush_saves
                self._save_error = e

        self._save_thread = threading.Thread(
            target=work, name="sm3x-torch-save", daemon=False)
        self._save_thread.start()

    def flush_saves(self) -> None:
        """Wait for the save in flight; an error of its thread is raised
        here."""
        t, self._save_thread = self._save_thread, None
        if t is not None:
            t.join()
        err, self._save_error = self._save_error, None
        if err is not None:
            raise err

    def finish_checkpoints(self) -> None:
        """The end of every `fit`: the last write has landed, and the
        signals have their earlier handlers back (nothing polls the flag
        after the loop)."""
        self.flush_saves()
        self.uninstall_preemption_handler()

    def install_preemption_handler(self) -> None:
        """--save-on-preempt: SIGTERM / SIGINT set a flag that the epoch
        loop polls through `preemption_break`. A second signal finds the
        default disposition again, which ends the process at once."""
        if not self.cfg.run.save_on_preempt:
            return
        if threading.current_thread() is not threading.main_thread():
            self.logger.warning(
                "--save-on-preempt ignored: trainer not in the main thread")
            return
        self._preempt_signal = None

        def handler(signum, frame):
            self._preempt_signal = signum
            signal.signal(signum, signal.SIG_DFL)

        self._orig_handlers = {
            sig: signal.signal(sig, handler)
            for sig in (signal.SIGTERM, signal.SIGINT)}

    def uninstall_preemption_handler(self) -> None:
        for sig, orig in (self._orig_handlers or {}).items():
            signal.signal(sig, orig)
        self._orig_handlers = {}

    def preemption_break(self, epoch: int) -> bool:
        """Polled at each epoch boundary. After a signal: the save in
        flight is settled, rank 0 writes `checkpoint.pth` whatever
        `ckpt_freq` says and logs how to resume, and the caller leaves the
        loop. Several processes agree first (an all-reduce MAX of the
        signal number): a signal to any rank breaks every rank, where a
        lone breaker would leave the others waiting in a collective."""
        signum = self._preempt_signal
        if self._orig_handlers and process_info()[1] > 1:
            signum = max_over_ranks(signum or 0) or None
        if signum is None:
            return False
        state = self._state_to_write(epoch)
        if not is_main_process():
            return True
        self.flush_saves()
        where = os.path.join(self.cfg.run.log_path, "checkpoint.pth")
        self.save(where, epoch, state)
        self.logger.warning(
            f"preemption signal {signum} caught: epoch {epoch} state saved; "
            f"resume with --resume-path {where}")
        return True

    def resume(self, path=None) -> bool:
        """--resume-path: load a `checkpoint.pth` or `ckp_*.pth` this
        trainer wrote (the model strictly, the optimizer's state, the
        trainer's extras) and start the loop at its epoch. False when no
        path was given; a missing file raises."""
        from sm3x_torch.utils.checkpoint import load_checkpoint_file

        path = path or self.cfg.run.resume_path
        if not path:
            return False
        if not os.path.isfile(path):
            raise FileNotFoundError(f"cannot find checkpoint at '{path}'")
        self.logger.info(f"Re-starting from checkpoint: '{path}' ...")
        ckpt = load_checkpoint_file(path)
        state, optim = ckpt["state_dict"], ckpt.get("optimizer")
        if self.tp is not None:   # this rank's part of the whole file
            state = self.tp.shard(state)
            if optim is not None:
                optim = self.tp.local_optimizer_state(optim, self.model,
                                                      self.optimizer)
        self.model.load_state_dict(state, strict=True)
        if optim is not None:
            load_optimizer_state(self.optimizer, optim)
        self.restore_extra_state(ckpt)
        self.start_epoch = int(ckpt.get("epoch", 0))
        self.logger.info(f"resumed from '{path}' (epoch {self.start_epoch})")
        return True

    def stash_best(self, epoch: int, best_val_auc: float):
        """Keep the model as it stands as the best one, as clones on the
        device: a write to disk at every improvement would stall the epoch
        loop. `write_best` persists the stash once, after the loop."""
        self._best = {
            "epoch": epoch + 1,
            "state_dict": {k: v.clone()
                           for k, v in self.model_state().items()},
            "best_val_auc": float(best_val_auc),
        }

    def write_best(self):
        """Rank 0 writes the stashed best model to `best_eval.pth`; nothing
        when no epoch improved."""
        best, self._best = self._best, None
        if best is None or not is_main_process():
            return
        path = os.path.join(self.cfg.run.log_path, "best_eval.pth")
        best["state_dict"] = {k: v.cpu()
                              for k, v in best["state_dict"].items()}
        torch.save(best, path)
        self.logger.info(f"wrote {path} (epoch {best['epoch']}, "
                         f"val AUC {best['best_val_auc']:.4f})")

    def warn_unconsumed_lr_schedule(self):
        """--use-lr-schedule belongs to SSL pretraining; the other stages
        say so and train at a constant lr."""
        if self.cfg.optim.use_lr_schedule:
            self.logger.warning(
                "--use-lr-schedule is only consumed by backbone_train "
                "(SSL pretraining); this stage ignores it and uses a "
                "constant lr")

    def save(self, path: str, epoch: int, state=None):
        """Write the state now (or `state`, where the caller took it) and
        return when the file is whole; the epoch loop uses `save_async`."""
        write_checkpoint([path], self.live_state(epoch) if state is None
                         else state)

    def guard_loss(self, epoch: int, loss: float):
        """--nan-guard: dump the state and stop on a non-finite epoch loss."""
        if not self.cfg.run.nan_guard or math.isfinite(loss):
            return
        path = os.path.join(self.cfg.run.log_path, "nan_dump.pth")
        state = self._state_to_write(epoch)
        if is_main_process():
            self.save(path, epoch, state)
        raise FloatingPointError(
            f"non-finite loss {loss} at epoch {epoch} (state: {path})")

    def epoch_checkpoint(self, epoch: int):
        """Rank 0 writes `ckp_{epoch}.pth` every `save_freq` epochs and at
        the end, and `checkpoint.pth` every `ckpt_freq` epochs, through
        `save_async`: where both fall on one epoch they share one snapshot
        and one fetch."""
        cfg = self.cfg
        paths = []
        if ((epoch + 1) % cfg.run.save_freq == 0
                or epoch + 1 == cfg.optim.epochs):
            paths.append(os.path.join(cfg.run.log_path, f"ckp_{epoch}.pth"))
        if (epoch + 1) % max(cfg.run.ckpt_freq, 1) == 0:
            paths.append(os.path.join(cfg.run.log_path, "checkpoint.pth"))
        if not paths:
            return
        state = self._state_to_write(epoch)
        if is_main_process():
            self.save_async(paths, epoch, state)
