"""The stage-1 update replayed as one CUDA graph (`common.GraphedStep`,
`backbone_train.graph_refusals`).

On the CPU: which runs take the graph and which the eager step, each with
its reason; a reseeded generator draws, through `ssl_augment_batch`, what
a fresh one draws; the update a graph records is the eager step on the
generators `seeds` gives; `GraphedStep`'s own logic (when it captures,
replays or steps eagerly, its counters, and outputs that a later step
leaves alone) around a stand-in for
`torch.cuda.CUDAGraph` whose replay runs the update again; and a
checkpoint's optimizer groups keep the trainer's own `fused` and
`capturable`.

Marked `cuda` and skipped without a card: a small ResNet at 64 px, b8, two
epochs of three steps, graphed against eager (losses, parameters and AdamW
state; counters; each kernel's launches in the device trace of the
second epoch; a one-shot forward hook), checkpoints
from either resumed in the other, and the capture under the resident and
the prefetch feed. On a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graph_step.py
"""

import contextlib
import functools

import pytest
import torch

from sm3x_torch.core import prng
from sm3x_torch.core.config import SSLConfig
from sm3x_torch.train import backbone_train as bt
from sm3x_torch.train import common
from sm3x_torch.utils import profiling

torch.set_num_threads(2)

B, SIZE, CANVAS, CASES = 8, 64, 80, 24      # 3 steps an epoch
MEAN, STD = (0.7833, 0.6712, 0.6026), (0.2139, 0.2472, 0.2571)
COUNTERS = ("trainer.graph_captures", "trainer.graph_replays",
            "trainer.graph_eager_steps")


def _cfg(device="cpu", log_path=".", size=SIZE) -> SSLConfig:
    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.data.img_sz, cfg.data.cache_size = (size, size), CANVAS
    cfg.optim.batch_size, cfg.optim.amp = B, device != "cpu"
    cfg.optim.base_lr, cfg.optim.epochs = 1e-4, 2
    cfg.run.world_size, cfg.run.device = 2, device
    cfg.run.log_path, cfg.run.print_freq = str(log_path), 10 ** 6
    return cfg


@pytest.fixture
def recorder():
    """The port's recorder, on and empty; off and empty afterwards."""
    profiling.record(False)
    profiling.take()
    profiling.record(True)
    yield profiling
    profiling.record(False)
    profiling.take()


def _counters(rec) -> dict:
    c = rec.take().counters
    return {k: c.get(k, 0) for k in COUNTERS}


# --- when the graph engages ----------------------------------------------

def _trimodal(cfg):
    cfg.model.arch_version = "trimodal"


def _multicrop(cfg):
    cfg.data.data_name = bt.MULTICROP


def _schedule(cfg):
    cfg.optim.use_lr_schedule = True


def _bn_freq(cfg):
    cfg.model.bn_stat_freq = 4


@pytest.mark.parametrize("device,distributed,tweak,reason", [
    ("cuda", False, None, None),
    ("cpu", False, None, "the device is not a CUDA card"),
    ("cuda", False, _schedule, "--use-lr-schedule"),
    ("cuda", False, _trimodal, "--arch-version trimodal"),
    ("cuda", False, _multicrop, "multi-crop"),
    ("cuda", False, _bn_freq, "--bn-stat-freq > 1"),
    ("cuda", True, None, "a process group is up"),
], ids=["recipe", "cpu", "lr_schedule", "trimodal", "multicrop",
        "bn_stat_freq", "process_group"])
def test_the_graph_engages_only_where_every_condition_holds(
        device, distributed, tweak, reason):
    """The one-process dual-modal recipe on a card takes the graph
    (run.sh's --world-size 2 is NT-Xent groups, not processes); each other
    run takes the eager step, with its one reason."""
    cfg = _cfg()
    if tweak is not None:
        tweak(cfg)
    got = bt.graph_refusals(cfg, torch.device(device), distributed)
    if reason is None:
        assert got == []
    else:
        assert len(got) == 1 and got[0].startswith(reason), got


def test_an_eager_trainer_keeps_its_step_and_optimizer(tmp_path):
    """On the CPU the trainer's step is the eager one and its AdamW is the
    foreach update, neither fused nor capturable: stages 2-4 and every
    refused run keep today's code."""
    tr = bt.SSLTrainer(_cfg(log_path=tmp_path))
    assert tr.graph_refusals == ["the device is not a CUDA card"]
    assert not isinstance(tr.train_step, common.GraphedStep)
    for opt in (tr.optimizer, common.make_adamw([torch.zeros(2)], 1e-3)):
        assert all(not g["capturable"] and not g["fused"]
                   for g in opt.param_groups)
    graphed = common.make_adamw([torch.zeros(2)], 1e-3, fused=True)
    assert all(g["capturable"] and g["fused"] for g in graphed.param_groups)


# --- randomness ------------------------------------------------------------

def _canvases(device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    canv = torch.randint(0, 256, (B, CANVAS, CANVAS, 3), generator=gen,
                         dtype=torch.uint8)
    hw = torch.randint(CANVAS // 2, CANVAS + 1, (B, 2), generator=gen)
    return canv.to(device), hw.to(device)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_reseeded_generator_draws_what_a_fresh_one_draws(device):
    """One generator object, seeded before each of three steps with the
    seeds of a step's first view, gives through `ssl_augment_batch` views
    bitwise equal to a fresh generator's: what a replay's generators give
    against the eager step's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from sm3x_torch.ops.augment import SSL_AUG, ssl_augment_batch

    canv, hw = _canvases(device)
    cfg = bt.dataclasses.replace(SSL_AUG, out_size=(SIZE, SIZE))
    kept = torch.Generator(device=device)
    for step in range(3):
        s = bt.view_seeds(prng.step_seed(7, 0, step))[0]
        kept.manual_seed(s)
        got = ssl_augment_batch(kept, canv, hw, MEAN, STD, cfg)
        want = ssl_augment_batch(prng.generator(s, device), canv, hw, MEAN,
                                 STD, cfg)
        assert torch.equal(got, want)


def test_the_recorded_update_is_the_eager_step(tmp_path):
    """`train_step.update` on generators seeded with `train_step.seeds`
    (what a graph records and replays) makes the eager step's update:
    the same losses and parameters, bitwise, over two steps."""
    runs = []
    for recorded in (False, True):
        tr = bt.SSLTrainer(_cfg(log_path=tmp_path))
        step = tr.train_step
        gens = [torch.Generator() for _ in step.seeds(0)]
        losses = []
        for it in range(2):
            canv, hw = _canvases("cpu", it)
            seed = prng.step_seed(tr.cfg.run.seed, 0, it)
            if recorded:
                for g, s in zip(gens, step.seeds(seed)):
                    g.manual_seed(s)
                out = step.update(canv, hw, canv.flip(1), hw, gens)
            else:
                out = step(canv, hw, canv.flip(1), hw, seed)
            losses.append([float(v) for v in out.values()])
        runs.append((losses, [p.detach().clone()
                              for p in tr.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_view_seeds_share_the_derm_keys_under_joint_aug():
    """SevenPCBaseDataset2 hands both modalities the derm stream's seeds."""
    seeds = bt.view_seeds(12345, joint_aug=True)
    assert seeds[:2] == seeds[2:] and seeds[0] != seeds[1]
    assert seeds[:2] == bt.stream_seeds(prng.fold_in(12345, 0))
    assert bt.view_seeds(12345)[:2] == seeds[:2]
    assert bt.view_seeds(12345)[2:] != seeds[2:]


# --- GraphedStep's logic, around a stand-in graph ----------------------------

class _StandInGraph:
    """torch.cuda.CUDAGraph's part that GraphedStep uses, on the CPU: a
    replay runs the step's update again on its buffers and generators and
    writes the outputs where the capture put them."""

    def __init__(self, step):
        self.registered, self.step = [], step

    def register_generator_state(self, gen):
        self.registered.append(gen)

    def replay(self):
        s = self.step
        with _phase("replay"):
            out = s.eager.update(*s.static, s.generators)
        s.packed.copy_(torch.stack(list(out.values())))


_PHASE = ["run"]   # what the toy update runs in: run, capture or replay


@contextlib.contextmanager
def _phase(name: str):
    was, _PHASE[0] = _PHASE[0], name
    try:
        yield
    finally:
        _PHASE[0] = was


class _StandInCapture:
    def __init__(self, graph, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.ctx = _phase("capture")

    def __enter__(self):
        self.ctx.__enter__()

    def __exit__(self, *exc):
        return self.ctx.__exit__(*exc)


@pytest.fixture
def toy_step(monkeypatch):
    """A GraphedStep over a toy update that draws from two generators,
    around the stand-in graph."""
    monkeypatch.setattr(torch.cuda, "graph", _StandInCapture)
    ran = []

    def update(x, hw, gens):
        ran.append(_PHASE[0])
        return {"loss": x.float().mean() + torch.rand((), generator=gens[0]),
                "part": hw.float().sum() * torch.rand((), generator=gens[1])}

    def seeds(seed):
        return prng.fold_in(seed, 0), prng.fold_in(seed, 1)

    def eager(x, hw, seed):
        return update(x, hw, [prng.generator(s, x.device)
                              for s in seeds(seed)])

    step = common.GraphedStep(bt.SSLStep(eager, update, seeds))
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        functools.partial(_StandInGraph, step))
    step.ran = ran
    return step, eager


def test_graphed_step_captures_at_the_second_call_and_replays_after(
        toy_step, recorder):
    """Call 1 eager; call 2 of the same shapes captures and replays at
    once; call 3 replays: every call one update, each replay's outputs
    those of the eager step at its seed, and the counters 1 / 2 / 1."""
    step, eager = toy_step
    xs = [_canvases("cpu", i) for i in range(3)]
    outs = [step(x, hw, 100 + i) for i, (x, hw) in enumerate(xs)]
    assert step.ran == ["run", "capture", "replay", "replay"]
    for i, ((x, hw), out) in enumerate(zip(xs, outs)):
        want = eager(x, hw, 100 + i)
        assert list(out) == ["loss", "part"]
        assert all(torch.equal(out[k], want[k]) for k in out)
    assert _counters(recorder) == {"trainer.graph_captures": 1,
                                   "trainer.graph_replays": 2,
                                   "trainer.graph_eager_steps": 1}


def test_graphed_step_returns_its_own_tensors(toy_step):
    """A step's metrics are copies: the next replay, which rewrites the
    graph's outputs, leaves them as they were."""
    step, _ = toy_step
    x, hw = _canvases("cpu")
    step(x, hw, 1)
    first = step(x, hw, 2)
    kept = {k: v.clone() for k, v in first.items()}
    step(x, hw, 3)
    assert all(torch.equal(first[k], kept[k]) for k in kept)
    assert all(v.untyped_storage().data_ptr()
               != step.packed.untyped_storage().data_ptr()
               for v in first.values())


def test_graphed_step_steps_eagerly_off_its_shapes_and_under_anomaly(
        toy_step, recorder):
    """A call of other shapes than the graph's, and a call under anomaly
    mode (the NaN checks), take the eager step, counted; the graph stays
    and replays at its shapes again."""
    step, eager = toy_step
    x, hw = _canvases("cpu")
    step(x, hw, 1)
    step(x, hw, 2)
    half = step(x[:4], hw[:4], 3)
    assert torch.equal(half["loss"], eager(x[:4], hw[:4], 3)["loss"])
    with torch.autograd.set_detect_anomaly(True):
        step(x, hw, 4)
    again = step(x, hw, 5)
    assert torch.equal(again["loss"], eager(x, hw, 5)["loss"])
    assert step.ran.count("capture") == 1
    assert _counters(recorder) == {"trainer.graph_captures": 1,
                                   "trainer.graph_replays": 2,
                                   "trainer.graph_eager_steps": 3}


def test_graphed_step_waits_for_two_calls_of_one_shape(toy_step):
    """Shapes that change from call to call never capture."""
    step, _ = toy_step
    x, hw = _canvases("cpu")
    for n in (8, 4, 8, 4):
        step(x[:n], hw[:n], n)
    assert "capture" not in step.ran and step.graph is None


# --- checkpoints ---------------------------------------------------------

@pytest.mark.parametrize("written,loaded", [(True, False), (False, True)])
def test_a_loaded_optimizer_keeps_its_own_fused(written, loaded):
    """A file's groups carry the writer's `fused` and `capturable`; after
    `load_optimizer_state` each group has its own trainer's again, with
    the writer's moments and step count. (On the card a fused group's
    count moves to the device, as the resume test below checks.)"""
    p = torch.nn.Parameter(torch.ones(3))
    opt = common.make_adamw([p], 1e-3, fused=written)
    p.grad = torch.ones(3)
    opt.step()
    q = torch.nn.Parameter(torch.ones(3))
    into = common.make_adamw([q], 1e-3, fused=loaded)
    common.load_optimizer_state(into, opt.state_dict())
    group = into.param_groups[0]
    assert bool(group["fused"]) is loaded
    assert group["capturable"] is loaded
    st = into.state[q]
    assert st["step"].device.type == "cpu" and float(st["step"]) == 1.0
    assert torch.equal(st["exp_avg"], opt.state[p]["exp_avg"])


# --- on the card ---------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """The CUDA device with the kernels built; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph and the kernels run "
                    "on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sm3x_torch.ops import _native

    _native.library()
    return torch.device("cuda")


def _data():
    from sm3x_torch.data.synthetic import synthetic_paired_data

    return synthetic_paired_data(CASES, canvas=CANVAS, seed=1)


def _card_run(tmp_path, graphed: bool, feed: str = "resident"):
    """Two epochs through `train_epoch`; the losses, the parameters, AdamW's
    state, the counters, each kernel's launches in the device trace of the
    second epoch (all replays where the step is graphed) and the one-shot
    hook's calls. The eager run is the same trainer with its eager step
    (the same fused AdamW)."""
    from sm3x_torch.data.prefetch import wrap_from_config
    from sm3x_torch.utils.timing import traced_launches

    cfg = _cfg("cuda", tmp_path)
    cfg.data.device_feed = feed
    tr = bt.SSLTrainer(cfg)
    assert isinstance(tr.train_step, common.GraphedStep)
    if not graphed:
        tr.train_step = tr.train_step.eager
    fired = []

    def once(module, args, out):
        fired.append(1)
        hook.remove()

    hook = tr.model.register_forward_hook(once)
    data = wrap_from_config(_data(), tr.device, cfg.data)
    profiling.take()
    profiling.record(True)
    try:
        losses = [tr.train_epoch(data, 0)["step_losses"]]
        traced = []
        launched = traced_launches(lambda _: traced.append(
            tr.train_epoch(data, 1)["step_losses"]))
        losses.append(traced[-1])
    finally:
        profiling.record(False)
    state = [t.detach().clone() for p in tr.model.parameters()
             for t in (p, tr.optimizer.state[p]["exp_avg"],
                       tr.optimizer.state[p]["exp_avg_sq"])]
    return dict(losses=losses, state=state, fired=len(fired),
                counters=_counters(profiling), launched=launched,
                trainer=tr)


def _gap(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


@pytest.mark.cuda
def test_graphed_trainer_matches_the_eager_step_on_the_card(card, tmp_path):
    """Losses, parameters and AdamW's moments of six graphed steps against
    two eager runs: bitwise equal where the eager step repeats bitwise
    (deterministic algorithms), else within four times the eager runs' own
    gap. Counters 1 / 5 / 1; the eager run's kernel launches in the device
    trace of the second epoch, every K1 launch the band kernel; the
    one-shot forward hook fires once, at the eager first step."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager = [_card_run(tmp_path / f"e{i}", False) for i in range(2)]
        graphed = _card_run(tmp_path / "g", True)
    finally:
        torch.use_deterministic_algorithms(was)
    assert graphed["counters"] == {"trainer.graph_captures": 1,
                                   "trainer.graph_replays": 5,
                                   "trainer.graph_eager_steps": 1}
    assert eager[0]["counters"] == dict.fromkeys(COUNTERS, 0)
    assert graphed["launched"] == eager[0]["launched"]
    assert graphed["launched"]["photometric_cuda"] == 12   # 4 a step
    assert graphed["launched"]["band"] == 12
    assert graphed["fired"] == eager[0]["fired"] == 1
    flat = [sum(r["losses"], []) for r in (*eager, graphed)]
    assert len(flat[2]) == 6 and all(map(torch.isfinite,
                                         torch.tensor(flat[2])))
    eager_gap = max(_gap(eager[0]["state"], eager[1]["state"]),
                    max(abs(a - b) for a, b in zip(flat[0], flat[1])))
    gap = max(_gap(eager[0]["state"], graphed["state"]),
              max(abs(a - b) for a, b in zip(flat[0], flat[2])))
    if eager_gap == 0.0:
        assert gap == 0.0
    else:
        assert gap <= 4 * eager_gap, (gap, eager_gap)


@pytest.mark.cuda
@pytest.mark.parametrize("feed", ["resident", "prefetch"])
def test_the_capture_holds_under_each_feed(card, tmp_path, feed):
    """The prefetch feed's producer thread makes CUDA calls while the main
    thread captures; the capture is thread-local, so it holds."""
    run = _card_run(tmp_path, True, feed)
    assert run["counters"]["trainer.graph_captures"] == 1
    assert run["counters"]["trainer.graph_replays"] == 5
    assert all(map(torch.isfinite, torch.tensor(sum(run["losses"], []))))


@pytest.mark.cuda
@pytest.mark.parametrize("first_graphed", [True, False],
                         ids=["graphed_then_eager", "eager_then_graphed"])
def test_a_checkpoint_resumes_across_graph_and_eager(card, tmp_path,
                                                     monkeypatch,
                                                     first_graphed):
    """`fit` writes checkpoint.pth after epoch 0 in one kind of trainer and
    the other resumes it at epoch 1: the optimizer keeps its own `fused`,
    the step counts sit where that puts them and read 3, and
    the resumed epoch trains (a graphed resume captures once more)."""
    real = bt.graph_refusals

    def trainer(graphed, cfg):
        monkeypatch.setattr(bt, "graph_refusals", real if graphed else (
            lambda *a: ["eager for the test"]))
        return bt.SSLTrainer(cfg)

    cfg = _cfg("cuda", tmp_path)
    cfg.optim.epochs = 1
    trainer(first_graphed, cfg).fit(_data())
    cfg = _cfg("cuda", tmp_path / "resumed")
    cfg.run.resume_path = str(tmp_path / "checkpoint.pth")
    tr = trainer(not first_graphed, cfg)
    assert tr.resume()
    assert tr.start_epoch == 1
    groups = tr.optimizer.param_groups
    assert all(bool(g["fused"]) is g["capturable"] is (not first_graphed)
               for g in groups)
    steps = [tr.optimizer.state[p]["step"] for p in groups[0]["params"]]
    want = "cuda" if not first_graphed else "cpu"
    assert all(s.device.type == want and float(s) == 3.0 for s in steps)
    profiling.take()
    profiling.record(True)
    try:
        hist = tr.fit(_data())
    finally:
        profiling.record(False)
    assert len(hist) == 1 and all(
        map(torch.isfinite, torch.tensor(hist[0]["step_losses"])))
    assert _counters(profiling)["trainer.graph_captures"] == (
        0 if first_graphed else 1)
