"""The yardstick's arithmetic against hand counts: the FLOP functions, the
kernels' bounds, the rate and p90 of a window, the traced slice's busy
time, gaps and labels."""

import pytest

from portbench.harness import clock, flops, kernels
from portbench.harness.trace import Slice, label


def test_resnet50_forward_is_8_2_gflop_at_224():
    # He et al. 2016, Table 1: 3.8e9 FLOPs counted as multiply-adds with
    # the fc layer; torchvision's count is 4.09 G multiply-adds
    got = flops.resnet_forward("bottleneck", [3, 4, 6, 3], 64, 224)
    assert got == pytest.approx(8.18e9, rel=0.005)


def test_vit_b16_forward_is_about_35_gflop_at_224():
    got = flops.vit_forward(16, 768, 12, 4.0, 224)
    assert got == pytest.approx(35.1e9, rel=0.005)


def test_projector_forward_by_hand():
    assert flops.projector_forward(2048, 128) == 2 * (2 * 2048 ** 2
                                                      + 2048 * 128)


@pytest.mark.parametrize("kind, us", [("fwd", 23.3), ("dq", 35.0),
                                      ("dkv", 35.0)])
def test_k3_bounds_at_vit_b16(kind, us):
    got = kernels.k3_bounds_s(64, 197, 12, 64)[kind] * 1e6
    assert got == pytest.approx(us, abs=0.05)


def test_k1_bound_at_the_recipe_view():
    assert kernels.k1_bound_s(96, 224, 224) * 1e6 == pytest.approx(34.5,
                                                                   abs=0.05)


def test_rate_and_p90_with_a_stall():
    # 20 steps of 100 ms, one of them held 900 ms by an epoch's end
    ends, t = [], 0.0
    for k in range(20):
        t += 1000.0 if k == 9 else 100.0
        ends.append(t)
    iv = clock.intervals_ms(ends)
    assert iv[0] == 100.0 and iv[9] == 1000.0 and len(iv) == 20
    assert clock.p90(iv) == pytest.approx(100.0)
    ends[4] += 500.0          # a second stall moves the tail
    ends[5:] = [e + 500.0 for e in ends[5:]]
    assert clock.p90(clock.intervals_ms(ends)) > 100.0
    assert clock.rate(413 * 4, 2.9) == pytest.approx(569.655, rel=1e-5)


def test_slice_busy_gaps_and_labels():
    kernels_ = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0),
                ("photometric_band_kernel", 4.5, 5.0)]
    sl = Slice(kernels_, 0.0, 6.0, steps=2)
    assert sl.busy_s == pytest.approx(3.5)
    assert sl.gaps() == [(2.0, 1.0), (4.0, 0.5), (5.0, 1.0)]
    assert sl.seconds("photometric") == pytest.approx(0.5)
    assert [r[0] for r in sl.rows()][:1] == ["b"]
    spans = [("train_step", 1.5, 2.5), ("feed.next", 3.9, 4.2)]
    assert label(2.0, spans, []) == "train_step"
    assert label(4.0, spans, []) == "feed.next"
    assert label(5.0, spans, [(4.9, 5.5)]) == "epoch_boundary"
    assert label(5.9, spans, [(4.9, 5.5)]) == "loop"
