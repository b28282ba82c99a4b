"""The port's span recorder (sm3x_torch.utils.profiling: `annotate`,
`count`, `record`, `take`) and the spans and counters of the stage-1 loop,
on the CPU: off it records nothing, on each step's phases nest under the
step in time and by index, the feeds record their batches and uploads on
their own threads, the device waits are counted where the loop makes them,
and recording moves no loss and no parameter."""

import sys
import threading
import time
from collections import Counter

import pytest
import torch

from sm3x_torch.utils import profiling

torch.set_num_threads(2)

B, SIZE, CANVAS, CASES = 8, 32, 48, 20     # 3 steps an epoch, the last padded
STEP_PHASES = Counter({"augment.views": 2, "model.forward": 1, "loss": 1,
                       "trainer.backward": 1, "trainer.optimizer": 2})
WAITS = "host.device_waits"


@pytest.fixture
def recorder():
    """A clean recorder, off and empty again afterwards."""
    profiling.record(False)
    profiling.take()
    yield profiling
    profiling.record(False)
    profiling.take()


def _trainer(tmp_path):
    from sm3x_torch.core.config import SSLConfig
    from sm3x_torch.train.backbone_train import SSLTrainer

    cfg = SSLConfig()
    cfg.model.arch, cfg.model.proj_dim = "resnet18", 16
    cfg.data.img_sz = (SIZE, SIZE)
    cfg.optim.batch_size, cfg.optim.amp = B, False
    cfg.run.device, cfg.run.log_path = "cpu", str(tmp_path)
    cfg.run.print_freq = 10 ** 6
    return SSLTrainer(cfg)


def _resident():
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.synthetic import synthetic_paired_data

    return DeviceData(synthetic_paired_data(CASES, CANVAS, seed=3), "cpu")


def _children(spans, i):
    return [s for j, s in enumerate(spans) if s.root == i and j != i]


def test_off_annotate_is_the_shared_no_op_and_an_epoch_records_nothing(
        recorder, tmp_path):
    assert recorder.annotate("a") is recorder.annotate("b")
    with recorder.annotate("a") as entered:
        assert entered is None
    trainer = _trainer(tmp_path)
    trainer.train_epoch(_resident(), 0)
    got = recorder.take()
    assert got.spans == [] and got.counters == {} and got.dropped == 0


def test_on_each_step_s_phases_nest_under_it(recorder, tmp_path):
    trainer, feed = _trainer(tmp_path), _resident()
    steps = feed.steps_per_epoch(B)
    t0 = time.perf_counter()
    recorder.record(True)
    trainer.train_epoch(feed, 0)
    recorder.record(False)
    t1 = time.perf_counter()
    spans = recorder.take().spans
    me = threading.get_ident()
    roots = [i for i, s in enumerate(spans) if s.name == "trainer.step"]
    assert len(roots) == steps
    for i in roots:
        step = spans[i]
        assert (step.parent, step.root, step.thread) == (-1, i, me)
        assert step.cpu_ns[0] <= step.cpu_ns[1]
        kids = _children(spans, i)
        assert Counter(s.name for s in kids) == STEP_PHASES
        for s in kids:
            assert s.parent == i and s.thread == me and s.cpu_ns is None
            assert step.start_ns <= s.start_ns < s.end_ns <= step.end_ns
        order = [s.name for s in kids]
        assert order[:2] == ["augment.views"] * 2
        assert order[2:] == ["trainer.optimizer", "model.forward", "loss",
                             "trainer.backward", "trainer.optimizer"]
        ends = [s.end_ns for s in kids]
        starts = [s.start_ns for s in kids]
        assert all(e <= a for e, a in zip(ends, starts[1:]))
    for s in spans:
        assert t0 <= s.start_ns * 1e-9 <= s.end_ns * 1e-9 <= t1


@pytest.mark.parametrize("feed", ["resident", "prefetch"])
def test_the_feed_records_batch_over_upload_on_its_thread(recorder, feed):
    from sm3x_torch.data.prefetch import PrefetchData
    from sm3x_torch.data.synthetic import synthetic_paired_data

    data = (_resident() if feed == "resident"
            else PrefetchData(synthetic_paired_data(CASES, CANVAS, 3), "cpu"))
    recorder.record(True)
    n = sum(1 for _ in data.batches(B, 0))
    recorder.record(False)
    got = recorder.take()
    batches = [i for i, s in enumerate(got.spans) if s.name == "feed.batch"]
    assert len(batches) == n == data.steps_per_epoch(B)
    here = threading.get_ident()
    for i in batches:
        outer = got.spans[i]
        assert (outer.parent, outer.root) == (-1, i)
        assert (outer.thread == here) == (feed == "resident")
        (upload,) = _children(got.spans, i)
        assert upload.name == "feed.upload" and upload.parent == i
        assert upload.thread == outer.thread
        assert outer.start_ns <= upload.start_ns <= upload.end_ns \
            <= outer.end_ns
    # the resident feed's index upload is a wait a batch; on the CPU the
    # prefetch feed copies nothing to a card
    assert got.counters.get(WAITS, 0) == (n if feed == "resident" else 0)


def test_a_drain_that_reads_back_counts_each_read(recorder):
    from sm3x_torch.train.common import drain_losses
    from sm3x_torch.utils.misc import AverageMeter

    meter, out = AverageMeter("Loss", ":.4f"), []
    recorder.record(True)
    drain_losses([], meter, out)
    drain_losses([(torch.tensor(1.0), 8), (torch.tensor(3.0), 8)], meter,
                 out)
    recorder.record(False)
    got = recorder.take()
    assert out == [1.0, 3.0] and meter.avg == 2.0
    assert [s.name for s in got.spans] == ["trainer.drain"]
    assert got.counters == {WAITS: 2}


def test_an_epoch_counts_a_wait_a_batch_and_a_loss(recorder, tmp_path):
    trainer, feed = _trainer(tmp_path), _resident()
    recorder.record(True)
    trainer.train_epoch(feed, 0)
    recorder.record(False)
    got = recorder.take()
    steps = feed.steps_per_epoch(B)
    # a step's batch norms: resnet18's 20 in each of its 4 encoder calls
    # and the projectors' 18; on the CPU none is the card's kernel
    assert got.counters == {WAITS: 2 * steps,
                            "model.bn_library": (4 * 20 + 18) * steps}
    names = Counter(s.name for s in got.spans)
    assert names["feed.batch"] == names["feed.upload"] == steps
    assert names["trainer.drain"] == 1


def test_recording_moves_no_loss_and_no_parameter(recorder, tmp_path):
    runs = []
    for on in (False, True):
        trainer = _trainer(tmp_path / str(on))
        recorder.record(on)
        stat = trainer.train_epoch(_resident(), 0)
        recorder.record(False)
        runs.append((stat["step_losses"],
                     {k: v.detach().clone()
                      for k, v in trainer.model.state_dict().items()}))
    (off_losses, off_state), (on_losses, on_state) = runs
    assert len(on_losses) == 3 and on_losses == off_losses
    assert off_state.keys() == on_state.keys()
    assert all(torch.equal(off_state[k], on_state[k]) for k in off_state)
    assert recorder.take().spans


def test_a_span_on_a_second_thread_keeps_its_own_parent_chain(recorder):
    opened, done = threading.Event(), threading.Event()

    def work():
        opened.wait(10)
        with recorder.annotate("t.outer"):
            with recorder.annotate("t.inner"):
                recorder.count("t.count")
        done.set()

    t = threading.Thread(target=work)
    t.start()
    recorder.record(True)
    with recorder.annotate("m.outer"):
        opened.set()
        assert done.wait(10)
        with recorder.annotate("m.inner"):
            pass
    recorder.record(False)
    t.join(10)
    assert not t.is_alive()
    spans = recorder.take().spans
    at = {s.name: i for i, s in enumerate(spans)}
    assert spans[at["t.outer"]][3:5] == (-1, at["t.outer"])
    assert spans[at["t.inner"]][3:5] == (at["t.outer"], at["t.outer"])
    assert spans[at["m.inner"]][3:5] == (at["m.outer"], at["m.outer"])
    assert spans[at["t.inner"]].thread == spans[at["t.outer"]].thread \
        != spans[at["m.outer"]].thread


def test_threads_lose_no_span_and_no_count(recorder):
    threads, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with recorder.annotate("outer"):
                    with recorder.annotate("inner"):
                        recorder.count("n")
                    recorder.count("n", 2)

        recorder.record(True)
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
        recorder.record(False)
    got = recorder.take()
    assert got.counters == {"n": 3 * threads * rounds}
    assert len(got.spans) == 2 * threads * rounds and got.dropped == 0
    for s in got.spans:
        if s.name == "inner":
            outer = got.spans[s.parent]
            assert outer.name == "outer" and outer.thread == s.thread
            assert s.root == s.parent
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        else:
            assert s.parent == -1 and got.spans[s.root] is s


def test_the_cap_keeps_the_first_spans_and_counts_the_rest(recorder,
                                                           monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    recorder.record(True)
    for k in range(5):
        with recorder.annotate(f"s{k}"):
            pass
    recorder.record(False)
    got = recorder.take()
    assert [s.name for s in got.spans] == ["s0", "s1", "s2"]
    assert got.dropped == 2
    assert recorder.take().dropped == 0


def test_take_inside_a_span_returns_it_open_and_restarts_the_chain(recorder):
    recorder.record(True)
    with recorder.annotate("outer"):
        first = recorder.take()
        with recorder.annotate("after"):
            pass
    recorder.record(False)
    (outer,) = first.spans
    assert outer.name == "outer" and outer.end_ns == 0
    (after,) = recorder.take().spans
    assert (after.parent, after.root) == (-1, 0)


def test_under_trace_a_recorded_span_is_on_the_timeline(recorder, tmp_path):
    import json

    recorder.record(True)
    with profiling.trace(str(tmp_path)):
        with recorder.annotate("sm3x_recorded"):
            torch.ones(8).sum()
    recorder.record(False)
    (f,) = list(tmp_path.iterdir())
    events = json.loads(f.read_text())["traceEvents"]
    assert any(e.get("name") == "sm3x_recorded" for e in events)
    assert [s.name for s in recorder.take().spans] == ["sm3x_recorded"]
    assert recorder.annotate("x") is recorder.annotate("y")
