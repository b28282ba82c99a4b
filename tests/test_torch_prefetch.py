"""The port's device feeds (sm3x_torch.data.prefetch, device_data) against
the JAX package's (sm3x.data.prefetch, device_data) on one synthetic Derm7pt
tree: every feed's batches are exactly equal to the host data's and to the
reference's, shuffled and not, with the wrap-padded last batch; then early
stop, producer errors, and the whole strategy table of `wrap_for_device`
(the cases of tests/test_prefetch.py and tests/test_device_data.py). On the
CPU the port's feeds hand over CPU tensors; the pinned ring and the side
stream are the card's path (tests/test_torch_kernels_cuda.py).
"""

import threading
import warnings

import numpy as np
import pytest

import torch

from sm3x.core.mesh import make_mesh
from sm3x.data import datasets as ref_datasets
from sm3x.data.device_data import DeviceData as RefDeviceData
from sm3x.data.prefetch import PrefetchData as RefPrefetchData
from sm3x.data.synthetic import make_fake_derm7pt
from sm3x_torch.core.config import DataConfig
from sm3x_torch.data.datasets import build_dataset
from sm3x_torch.data.device_data import DeviceData
from sm3x_torch.data.prefetch import (PrefetchData, iter_with_producer,
                                      resident_nbytes, to_device,
                                      wrap_for_device, wrap_from_config)
from sm3x_torch.data.streaming import StreamingPairedData
from sm3x_torch.data.synthetic import (SyntheticPairedData,
                                       synthetic_paired_data)

CPU = torch.device("cpu")
FIELDS = ("derm", "derm_hw", "clinic", "clinic_hw", "label", "index", "mask",
          "meta")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("feed7pc"))
    make_fake_derm7pt(r, n_cases=24, img_size=56)   # 12 train cases
    return r


@pytest.fixture(scope="module")
def host_data(root):
    return build_dataset("SevenPCBaseDataset", root, "train", cache_size=64)


@pytest.fixture(scope="module")
def ref_feeds(root):
    host = ref_datasets.build_dataset("SevenPCBaseDataset", root, "train",
                                      cache_size=64)
    mesh = make_mesh()
    return {"host": host, "prefetch": RefPrefetchData(host, mesh, depth=2),
            "resident": RefDeviceData(host, mesh)}


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _feed(name, host_data):
    return {"host": lambda: host_data,
            "prefetch": lambda: PrefetchData(host_data, CPU, depth=2),
            "resident": lambda: DeviceData(host_data, CPU)}[name]()


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("name", ["host", "prefetch", "resident"])
def test_feed_batches_equal_the_reference_s(host_data, ref_feeds, name,
                                            shuffle):
    """12 cases at batch 8 (the JAX side shards a batch over 8 CPU
    devices): a full batch and a wrap-padded one."""
    feed = _feed(name, host_data)
    assert feed.steps_per_epoch(8) == 2
    for epoch in (0, 1):
        got = list(feed.batches(8, epoch=epoch, seed=7, shuffle=shuffle))
        assert not got[-1].mask.all() and got[0].mask.all()
        _assert_batches_equal(
            got, ref_feeds[name].batches(8, epoch=epoch, seed=7,
                                         shuffle=shuffle))
        _assert_batches_equal(
            got, host_data.batches(8, epoch=epoch, seed=7, shuffle=shuffle))
        if name != "host":
            assert torch.is_tensor(got[0].derm) and got[0].derm.dtype == \
                torch.uint8 and got[0].derm_hw.dtype == torch.int32
            assert isinstance(got[0].label, np.ndarray)


def test_feeds_keep_the_host_data_s_surface(host_data):
    for feed in (PrefetchData(host_data, CPU), DeviceData(host_data, CPU)):
        assert feed.n == host_data.n
        assert feed.labels is host_data.labels
        assert feed.meta_codes is host_data.meta_codes
        assert feed.meta_vocab_sizes == host_data.meta_vocab_sizes
        np.testing.assert_array_equal(feed.epoch_order(3, 5),
                                      host_data.epoch_order(3, 5))


def test_to_device_takes_arrays_and_tensors():
    x = np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::2]  # not contiguous
    t = to_device(x, CPU)
    assert torch.equal(t, torch.tensor([[0, 2], [3, 5]], dtype=torch.int32))
    assert to_device(t, CPU) is t


def test_synthetic_paired_data_equals_the_synthetic_batches():
    a, b = SyntheticPairedData(10, 40, 3), synthetic_paired_data(10, 40, 3)
    for shuffle in (True, False):
        _assert_batches_equal(b.batches(4, 2, 11, shuffle),
                              a.batches(4, 2, 11, shuffle))
    assert isinstance(wrap_for_device(b, CPU), DeviceData)
    assert wrap_for_device(a, CPU) is a


def test_prefetch_early_stop_does_not_hang(host_data):
    it = PrefetchData(host_data, CPU, depth=1).batches(4, epoch=0)
    next(it)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "sm3x-torch-prefetch"]


def test_prefetch_early_stop_cancels_producer(host_data):
    uploads = []

    class Counting:
        n, labels = host_data.n, host_data.labels

        def steps_per_epoch(self, bs):
            return host_data.steps_per_epoch(bs)

        def epoch_order(self, *a, **k):
            return host_data.epoch_order(*a, **k)

        def batches(self, *a, **k):
            one = next(iter(host_data.batches(8, epoch=0)))
            for _ in range(6):
                uploads.append(1)
                yield one

    it = PrefetchData(Counting(), CPU, depth=1).batches(8, epoch=0)
    next(it)
    it.close()
    # consumed 1; the producer may have 1 in flight and depth (1) queued
    assert sum(uploads) <= 3, uploads


def test_prefetch_propagates_producer_errors(host_data):
    class Boom(Exception):
        pass

    class BadData:
        n, labels = host_data.n, host_data.labels

        def steps_per_epoch(self, bs):
            return 1

        def epoch_order(self, *a, **k):
            return np.arange(self.n)

        def batches(self, *a, **k):
            raise Boom("producer failed")
            yield  # pragma: no cover

    with pytest.raises(Boom):
        list(PrefetchData(BadData(), CPU).batches(2))


def test_iter_with_producer_runs_ahead_and_ends():
    made = []

    def items():
        for i in range(5):
            made.append(i)
            yield i

    assert list(iter_with_producer(items, 2, "t")) == [0, 1, 2, 3, 4]
    assert made == [0, 1, 2, 3, 4]


def test_prefetch_rejects_bad_depth(host_data):
    with pytest.raises(ValueError, match="depth must be >= 1, got 0"):
        PrefetchData(host_data, CPU, depth=0)


def test_wrap_for_device_picks_resident_then_prefetch(host_data):
    assert isinstance(wrap_for_device(host_data, CPU), DeviceData)
    small = host_data.derm.canvases.nbytes  # < derm + clinic
    wrapped = wrap_for_device(host_data, CPU, hbm_budget_bytes=small)
    assert isinstance(wrapped, PrefetchData)
    assert wrap_for_device(wrapped, CPU) is wrapped   # already wrapped


def test_wrap_for_device_forced_strategies(host_data):
    assert wrap_for_device(host_data, CPU, strategy="host") is host_data
    assert isinstance(wrap_for_device(host_data, CPU, strategy="resident"),
                      DeviceData)
    forced = wrap_for_device(host_data, CPU, strategy="prefetch", depth=3)
    assert isinstance(forced, PrefetchData) and forced.depth == 3
    with pytest.raises(ValueError, match=r"unknown device-feed strategy "
                       r"'bogus' \(auto\|resident\|prefetch\|host\)"):
        wrap_for_device(host_data, CPU, strategy="bogus")


def test_wrap_for_device_and_streaming():
    stream = StreamingPairedData(["a"], ["b"], [[0] * 8])
    with pytest.raises(ValueError, match="device-feed"):
        wrap_for_device(stream, CPU, strategy="bogus")
    assert isinstance(wrap_for_device(stream, CPU), PrefetchData)
    assert isinstance(wrap_for_device(stream, CPU, strategy="prefetch"),
                      PrefetchData)
    assert wrap_for_device(stream, CPU, strategy="host") is stream
    with pytest.raises(ValueError, match="--device-feed resident needs the "
                       "decoded canvas cache"):
        wrap_for_device(stream, CPU, strategy="resident")


def test_wrap_for_device_warns_on_ignored_forced_strategy():
    class Synthetic:  # not a paired canvas dataset
        pass

    s = Synthetic()
    with pytest.warns(UserWarning, match="--device-feed resident has no "
                      "effect on Synthetic"):
        assert wrap_for_device(s, CPU, strategy="resident") is s
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert wrap_for_device(s, CPU) is s
        assert wrap_for_device(s, CPU, strategy="host") is s


def test_wrap_for_device_budget_is_cumulative(host_data):
    both = host_data.derm.canvases.nbytes + host_data.clinic.canvases.nbytes
    first = wrap_for_device(host_data, CPU, hbm_budget_bytes=both + both // 2)
    assert isinstance(first, DeviceData)
    assert resident_nbytes(first) == both
    assert resident_nbytes(host_data) == 0
    second = wrap_for_device(host_data, CPU,
                             hbm_budget_bytes=both + both // 2,
                             reserved_bytes=resident_nbytes(first))
    assert isinstance(second, PrefetchData)
    assert resident_nbytes(second) == 0


def test_wrap_from_config_plumbs_cli_flags(host_data):
    forced = wrap_from_config(
        host_data, CPU, DataConfig(device_feed="prefetch", prefetch_depth=4))
    assert isinstance(forced, PrefetchData) and forced.depth == 4
    auto = wrap_from_config(host_data, CPU, DataConfig(hbm_data_budget_mb=0))
    assert isinstance(auto, PrefetchData)
    assert wrap_from_config(host_data, CPU,
                            DataConfig()).__class__ is DeviceData
    assert wrap_from_config(host_data, CPU,
                            DataConfig(device_feed="host")) is host_data


def test_auto_in_a_multi_process_run_is_refused(host_data, monkeypatch):
    """No longer refused: under a process group every strategy yields this
    rank's rows (sm3x_torch.data.multihost), `auto` through the
    process-sharded prefetch; on one rank those are the whole batch."""
    import sm3x_torch.data.prefetch as prefetch
    from sm3x_torch.data.device_data import DeviceData
    from sm3x_torch.data.multihost import LocalRows, ProcessShardedData

    monkeypatch.setattr(prefetch, "is_distributed", lambda: True)
    feeds = {s: wrap_for_device(host_data, CPU, strategy=s)
             for s in ("auto", "prefetch", "resident", "host")}
    assert type(feeds["auto"]) is ProcessShardedData
    assert type(feeds["prefetch"]) is ProcessShardedData
    assert type(feeds["resident"]) is DeviceData and feeds["resident"].local
    assert type(feeds["host"]) is LocalRows
    want = list(host_data.batches(8, 1, 3))
    for name, feed in feeds.items():
        got = list(feed.batches(8, 1, 3))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            for f in ("derm", "derm_hw", "clinic", "clinic_hw", "label",
                      "index", "mask"):
                np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                              getattr(w, f), err_msg=name)
