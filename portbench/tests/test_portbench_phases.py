"""`portbench/phases.py`'s readings against hand counts on made-up spans,
and on the card a toy cell whose traced slice holds each K1 launch after
the host's `augment.views` span that launched it (the shared clock) and
whose epoch's synchronising calls are all counted."""

import pytest
import torch

from portbench import phases
from portbench.harness.trace import Slice
from sm3x_torch.utils.profiling import Span

MAIN, OTHER = 1, 2
MS = 1_000_000  # ns


def _span(name, a_ms, b_ms, parent=-1, root=0, thread=MAIN, cpu=None):
    return Span(name, a_ms * MS, b_ms * MS, parent, root, thread, cpu)


SPANS = [
    _span("feed.batch", 0, 9, root=0),
    _span("feed.upload", 1, 8, parent=0, root=0),
    _span("trainer.step", 10, 60, root=2, cpu=(0, 30 * MS)),
    _span("augment.views", 11, 15, parent=2, root=2),
    _span("augment.views", 15, 19, parent=2, root=2),
    _span("trainer.backward", 30, 50, parent=2, root=2),
    _span("trainer.step", 70, 120, root=6, cpu=(40 * MS, 60 * MS)),
    _span("trainer.backward", 90, 100, parent=6, root=6),
    _span("feed.batch", 40, 45, root=8, thread=OTHER),
]
BENCH = [("feed.next", 0.0, 0.0095), ("train_step", 0.0098, 0.061),
         ("train_step", 0.069, 0.121)]


def test_host_and_cpu_ms_a_step_read_the_window_s_spans():
    assert phases.host_ms_per_step(SPANS, "trainer.backward", 1.0, 2) == 15.0
    # the second step began after the window's end: left out
    assert phases.host_ms_per_step(SPANS, "trainer.backward", 0.065, 1) \
        == 20.0
    assert phases.host_ms_per_step(SPANS, "feed.upload", 1.0, 2) == 3.5
    assert phases.cpu_ms_per_step(SPANS, 1.0, 2) == 25.0
    assert phases.host_ms_per_step(SPANS, "loss", 1.0, 0) is None


def test_a_gap_is_labelled_by_the_innermost_span_of_the_launching_thread():
    label = phases.phase_label
    assert label(0.035, BENCH, [], SPANS, MAIN) == "train_step/trainer.backward"
    assert label(0.025, BENCH, [], SPANS, MAIN) == "train_step/trainer.step"
    assert label(0.005, BENCH, [], SPANS, MAIN) == "feed.next/feed.upload"
    # the feed's thread is not the launching thread
    assert label(0.0425, BENCH, [], SPANS, OTHER) == "train_step/feed.batch"
    assert label(0.065, BENCH, [(0.061, 0.069)], SPANS, MAIN) \
        == "epoch_boundary"
    assert label(0.2, BENCH, [], SPANS, MAIN) == "loop"
    assert label(0.035, BENCH, [], [], MAIN) == "train_step"


def test_idle_by_phase_sums_the_gaps_and_the_share_in_no_program_span():
    gaps = [(0.035, 0.004), (0.005, 0.001), (0.065, 0.003), (0.095, 0.002)]
    got = phases.idle_by_phase(gaps, BENCH, [(0.061, 0.069)], SPANS, MAIN)
    assert got["idle_s"] == pytest.approx({
        "train_step/trainer.backward": 0.006,
        "epoch_boundary": 0.003, "feed.next/feed.upload": 0.001})
    assert list(got["idle_s"])[0] == "train_step/trainer.backward"
    assert got["unlabelled_share"] == pytest.approx(0.3)
    assert phases.idle_by_phase([], BENCH, [], SPANS, MAIN)[
        "unlabelled_share"] is None


def test_k1_lead_pairs_each_views_span_with_its_first_launch():
    views = [s for s in SPANS if s.name == "augment.views"]
    k1 = "photometric_band_kernel"
    launches = [(k1, 0.0112, 0.0113), (k1, 0.0114, 0.0115),
                (k1, 0.0149, 0.0151), (k1, 0.0152, 0.0153),
                ("other", 0.0, 0.001)]
    sl = Slice(launches, 0.010, 0.020, steps=1)
    # the second span's first launch starts 0.1 ms before the span began
    assert phases.k1_leads_ms(sl, views, MAIN) == pytest.approx([-0.2, 0.1])
    assert phases.k1_leads_ms(Slice(launches[:3], 0.010, 0.020, 1), views,
                              MAIN) is None
    assert phases.k1_leads_ms(sl, views, OTHER) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the traced slice and the sync "
                    "debug mode are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_the_slice_and_the_spans_share_one_clock(card, tmp_path):
    from portbench.harness import spec
    from portbench.tests.toy import write_toy

    cell = spec.load_cell("toy_cell", write_toy(tmp_path))
    out = phases.phases(cell, 2 ** 31 + 11, 2.0, traced=True)
    assert out["k1_lead_ms"] is not None and out["k1_lead_ms"] < 0.1
    check = out["sync_check"]
    assert check["reported"] == check["counted"] == 2 * check["steps"]
    assert out["trainer.host_waits_per_step"] == pytest.approx(2.0)
    assert any(k.startswith("train_step/") for k in out["gaps"]["idle_s"])
