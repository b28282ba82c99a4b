"""The stage `ssl` (stage 1, dual-encoder NT-Xent): a cell driven through
the port as a user's run drives it.

Set-up builds one `SSLTrainer` from the cell's configuration, loads the
benchmark's weights into it, wraps the split in the port's own feed
(`wrap_from_config` at the recipe's defaults) and trains epoch 0 through
`SSLTrainer.train_epoch`: the window's own call on the window's own feed.
Its first steps are the ones the reference follows: the loss of each, the
first gradient as AdamW holds it after step 1 (exp_avg / (1 - beta1)) and
the parameters' change after the last checked step, read before the next
step moves them. The same trainer then trains whole epochs until the
window's seconds are up, making the calls `SSLTrainer.fit` makes between
epochs, less its checkpoints.

The trainer's `train_step` is wrapped: a CUDA event is recorded on the
training stream after each step, and the host's time in the step
(`train_step`) and in the feed's next batch (`feed.next`) are kept as
spans. Nothing else waits for the device inside the window but the
program's own read-back of the losses at each epoch's end.
"""

from __future__ import annotations

import logging
import math
import tempfile
import time

import torch

from portbench.harness import flops
from portbench.harness.checks import Readings, projections
from portbench.harness.inputs import load_weights, make_weights, paired_split
from portbench.reference.train import first_steps as reference  # noqa: F401


def quiet_logger() -> logging.Logger:
    log = logging.getLogger("portbench")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def program_config(cell, seed: int, device: str, log_path: str):
    """The port's SSLConfig of the cell: run.sh's stage 1 as the
    configuration file states it, at the batch of the cell."""
    from sm3x_torch.core.config import SSLConfig

    c, t = cell.config, cell.traffic
    cfg = SSLConfig()
    m, o, d, r = cfg.model, cfg.optim, cfg.data, cfg.run
    m.arch, m.arch_version = c["arch"], c["arch_version"]
    m.proj_dim, m.temperature = c["proj_dim"], c["temperature"]
    m.use_checkpoint = c["use_checkpoint"]
    o.batch_size, o.base_lr, o.wd, o.adam_eps = (cell.batch, c["lr"], c["wd"],
                                                 c["adam_eps"])
    o.amp = c["precision"]["encoders"] == "bf16" and device != "cpu"
    d.img_sz = (c["img_size"], c["img_size"])
    d.mean, d.std = tuple(c["mean"]), tuple(c["std"])
    d.cache_size = t["canvas"]
    r.world_size, r.device, r.log_path, r.seed = (c["world_size"], device,
                                                  log_path, seed)
    return cfg


def step_shapes(cell) -> dict:
    """What a step launches and computes, from the cell's shapes alone: two
    views a modality at the model's size, K1 once a view."""
    c, b, size = cell.config, cell.batch, cell.config["img_size"]
    k1 = [(b, size, size)] * 4
    k3 = []
    if c["use_checkpoint"] == "flash":
        tokens = (size // c["patch"]) ** 2 + 1
        k3 = [(b, tokens, c["heads"], c["hidden"] // c["heads"])] * (
            4 * c["depth"])
    model = 4 * b * (cell.model.forward_flops(c, size)
                     + 2 * flops.projector_forward(c["feat_dim"],
                                                   c["proj_dim"]))
    return {"k1": k1, "k3": k3, "flops": 3.0 * model}


class TimedFeed:
    """The port's feed, with the host's time in each next batch kept."""

    def __init__(self, feed, run):
        self.feed, self.run = feed, run

    def steps_per_epoch(self, batch: int) -> int:
        return self.feed.steps_per_epoch(batch)

    def batches(self, *args, **kw):
        it = self.feed.batches(*args, **kw)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.run.span("feed.next", t, time.perf_counter())
            yield batch


class SSLRun:
    """One stage-1 cell's trainer, feed and inputs for one seed; `fault`
    plants one of `_plant`'s faults under the timed path."""

    def __init__(self, cell, seed: int, device: str = "cuda", fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.fault = fault
        self.on_card = device != "cpu"
        self.checked = int(cell.traffic["checked_steps"])
        self.calls = 0
        self.window_calls = None   # steps since the window began
        self.spans, self.boundaries, self.step_ends = [], [], []
        self.tracer = None
        self.first = None
        self._losses = []

    # ------------------------------------------------------------- set-up

    def build(self) -> None:
        from sm3x_torch.data.pipeline import PairedImageData
        from sm3x_torch.data.prefetch import wrap_from_config
        from sm3x_torch.train.backbone_train import SSLTrainer

        t = self.cell.traffic
        self.split = paired_split(t["cases"], t["canvas"], self.seed)
        s = self.split
        data = PairedImageData.from_canvases(s["derm"], s["derm_hw"],
                                             s["clinic"], s["clinic_hw"],
                                             s["labels"])
        self._logs = tempfile.TemporaryDirectory()
        cfg = program_config(self.cell, self.seed, self.device,
                             self._logs.name)
        self.trainer = SSLTrainer(cfg, logger=quiet_logger())
        load_weights(self.trainer.model, self.seed, self.trainer.device,
                     self.cell.config.get("init_constants"))
        self.feed = TimedFeed(wrap_from_config(data, self.trainer.device,
                                               cfg.data), self)
        self.steps_per_epoch = self.feed.steps_per_epoch(self.cell.batch)
        self._wrap_step()
        self._restore = _plant(self.fault, self.trainer)
        self._hook = self.trainer.model.register_forward_hook(self._projections)

    def _projections(self, module, args, out) -> None:
        """The first forward's projections, in the order `projections`
        gives them."""
        self._proj = projections(out).detach().float().cpu()
        self._hook.remove()

    def _wrap_step(self) -> None:
        trainer, run = self.trainer, self
        orig = trainer.train_step

        def step(derm, derm_hw, clinic, clinic_hw, seed, *meta):
            k = run.window_calls
            if run.tracer is not None and k is not None:
                run.tracer.before(k)
            t = time.perf_counter()
            out = orig(derm, derm_hw, clinic, clinic_hw, seed, *meta)
            t_end = time.perf_counter()
            run.calls += 1
            if k is None:
                run._first_step_readings(out)
            else:
                run.span("train_step", t, t_end)
                run.step_ends.append(run._mark())
                run.window_calls += 1
                if run.tracer is not None:
                    run.tracer.after(k)
            return out

        trainer.train_step = step

    def _mark(self):
        if not self.on_card:
            return time.perf_counter() * 1e3
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(self, name: str, a: float, b: float) -> None:
        if self.window_calls is not None:
            self.spans.append((name, a, b))

    def _first_step_readings(self, out) -> None:
        if self.calls > self.checked:
            return
        self._losses.append(out["loss"].detach())
        model = self.trainer.model
        if self.calls == 1:
            opt = self.trainer.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            norms = {}
            for name, p in model.named_parameters():
                st = opt.state.get(p, {})
                norms[name] = (st["exp_avg"].norm() / (1.0 - beta1)
                               if "exp_avg" in st else p.new_zeros(()))
            self._grad = norms
        if self.calls == self.checked:
            params = dict(model.named_parameters())
            before = make_weights({n: tuple(p.shape) for n, p in params.items()},
                                  self.seed, self.trainer.device,
                                  self.cell.config.get("init_constants"))
            change = {n: (p.detach() - before[n]).norm()
                      for n, p in params.items()}
            del before
            self.first = Readings(
                [float(x) for x in self._losses],
                _floats(self._grad), _floats(change), self._proj)

    def first_epoch(self) -> Readings:
        """Epoch 0 through the trainer: the checked steps and the warm-up
        of every shape the window uses."""
        self._epoch(0)
        if self.on_card:
            torch.cuda.synchronize()
        return self.first

    def _epoch(self, epoch: int) -> dict:
        tr = self.trainer
        stat = tr.train_epoch(self.feed, epoch)
        tr.guard_loss(epoch, stat["loss"])
        tr.writer.log({"loss": stat["loss"]}, epoch, "train/")
        tr.logger.info(f"Epoch {epoch}: loss {stat['loss']:.4f}")
        return stat

    # ------------------------------------------------------------- window

    def window(self, seconds: float, trace: bool = False) -> dict:
        """Whole epochs from epoch 1 until `seconds` have passed; the step
        intervals, the cases trained and the failed steps. With `trace`,
        `trace_epochs` more whole epochs follow under the profiler, which
        every number of the window leaves out."""
        self.window_calls = 0
        if self.on_card:
            torch.cuda.synchronize()
        start = self._mark()
        t0 = time.perf_counter()
        epoch, failed, epochs = 1, 0, 0
        while True:
            stat = self._epoch(epoch)
            failed += sum(not math.isfinite(x) for x in stat["step_losses"])
            epochs += 1
            epoch += 1
            if time.perf_counter() - t0 >= seconds:
                break
            self.boundaries.append((self.spans[-1][2] if self.spans else t0,
                                    time.perf_counter()))
        if self.on_card:
            torch.cuda.synchronize()
        end = time.perf_counter()
        steps = self.window_calls
        if trace:
            from portbench.harness.trace import Tracer

            n = int(self.cell.traffic["trace_epochs"])
            self.tracer = Tracer(steps, steps + n * self.steps_per_epoch - 1,
                                 self.trainer.device)
            for e in range(epoch, epoch + n):
                self.boundaries.append((self.spans[-1][2],
                                        time.perf_counter()))
                self._epoch(e)
        if self.on_card:
            ends = [start.elapsed_time(e) for e in self.step_ends]
            start_ms = 0.0
        else:
            ends, start_ms = self.step_ends, start
        self.window_calls = None
        return dict(wall_s=end - t0, end_s=end, steps=steps,
                    cases=epochs * self.cell.traffic["cases"],
                    failed=failed, step_ends_ms=ends[:steps],
                    start_ms=start_ms)

    def free(self) -> None:
        """Drop the program's state, so that the reference runs in the
        memory it leaves."""
        for name in ("trainer", "feed"):
            if hasattr(self, name):
                delattr(self, name)
        self._logs.cleanup()
        self._restore()
        import gc

        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


def _plant(fault, trainer):
    """A fault under the timed path, for the checks that `correct` comes
    out false: `state_unchanged` (the optimizer moves nothing) or
    `half_batch` (the loss over the first half of the batch's rows alone).
    Returns what undoes it."""
    if fault is None:
        return lambda: None
    if fault == "state_unchanged":
        trainer.optimizer.step = lambda *a, **k: None
        return lambda: None
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    from sm3x_torch.train import backbone_train as bt

    whole = bt.ssl_loss

    def half_loss(outputs, *args, **kw):
        b = outputs["derm_z"].shape[0] // 2
        h = b // 2
        cut = {k: (torch.cat([v[:h], v[b:b + h]]) if torch.is_tensor(v)
                   else tuple(x[:h] for x in v)) for k, v in outputs.items()}
        return whole(cut, *args, **kw)

    bt.ssl_loss = half_loss
    return lambda: setattr(bt, "ssl_loss", whole)


def _floats(d: dict) -> dict:
    names = list(d)
    vals = torch.stack([d[n].float() for n in names]).tolist()
    return dict(zip(names, vals))


Run = SSLRun
