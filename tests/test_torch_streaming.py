"""The port's streaming dataset (sm3x_torch.data.streaming) and native
libjpeg loader (sm3x_torch.native) against the JAX package's, on files the
tests write: streamed batches exactly equal to cached ones and to
`sm3x.data.streaming`'s; the loader, built here from the same source against
the same libjpeg, exactly equal to `sm3x.native.loader` and within the
reference's mean absolute error of 3.0 of the OpenCV path (the cases of
tests/test_streaming.py and tests/test_native_loader.py).
"""

import os

import numpy as np
import pytest

import torch

from sm3x.data import datasets as ref_datasets
from sm3x.data.synthetic import make_fake_derm7pt
from sm3x.native import loader as ref_loader
from sm3x_torch.cli.parser import base_configs, get_parser
from sm3x_torch.data.datasets import build_dataset
from sm3x_torch.data.pipeline import (ImageStore, decode_canvas_batch,
                                      decode_image, letterbox)
from sm3x_torch.data.prefetch import PrefetchData, wrap_for_device
from sm3x_torch.data.streaming import StreamingPairedData
from sm3x_torch.native import loader

FIELDS = ("derm", "derm_hw", "clinic", "clinic_hw", "label", "index", "mask",
          "meta")


@pytest.fixture(scope="module", params=["png", "jpg"])
def root(request, tmp_path_factory):
    r = str(tmp_path_factory.mktemp(f"stream7pc_{request.param}"))
    make_fake_derm7pt(r, n_cases=20, img_size=56, ext=request.param)
    return r


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)


def test_streaming_matches_cached_and_reference_batches(root):
    cached = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64)
    stream = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64,
                           streaming=True)
    ref = ref_datasets.build_dataset("SevenPCBaseDataset", root, "train",
                                     cache_size=64, streaming=True)
    assert isinstance(stream, StreamingPairedData)
    assert stream.n == cached.n == ref.n == 10
    assert stream.steps_per_epoch(4) == cached.steps_per_epoch(4) == 3
    np.testing.assert_array_equal(stream.labels, cached.labels)
    np.testing.assert_array_equal(stream.meta_codes, cached.meta_codes)
    for epoch in (0, 1):
        got = list(stream.batches(4, epoch=epoch))
        _assert_batches_equal(got, cached.batches(4, epoch=epoch))
        _assert_batches_equal(got, ref.batches(4, epoch=epoch))
    _assert_batches_equal(stream.batches(4, shuffle=False),
                          ref.batches(4, shuffle=False))


def test_streaming_through_prefetch_is_the_same_batches(root):
    cached = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64)
    stream = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64,
                           streaming=True)
    wrapped = wrap_for_device(stream, torch.device("cpu"))
    assert isinstance(wrapped, PrefetchData)
    got = list(wrapped.batches(4, epoch=1))
    assert torch.is_tensor(got[0].derm)
    _assert_batches_equal(got, cached.batches(4, epoch=1))


def test_decode_rows_decodes_only_the_rows(root):
    cached = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64)
    stream = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64,
                           streaming=True)
    derm, derm_hw, clinic, clinic_hw = stream.decode_rows([3, 0])
    np.testing.assert_array_equal(derm, cached.derm.canvases[[3, 0]])
    np.testing.assert_array_equal(clinic_hw, cached.clinic.valid_hw[[3, 0]])
    np.testing.assert_array_equal(stream.epoch_order(2, 9),
                                  cached.epoch_order(2, 9))


def test_streaming_early_stop_and_bad_depth(root):
    stream = build_dataset("SevenPCBaseDataset", root, "train", cache_size=64,
                           streaming=True)
    it = stream.batches(2, epoch=0)
    next(it)
    it.close()  # the decode-ahead producer must not hang the generator
    with pytest.raises(ValueError, match="decode_ahead must be >= 1, got 0"):
        StreamingPairedData(["a"], ["b"], [[0] * 8], decode_ahead=0)


def test_streaming_propagates_decode_errors():
    stream = StreamingPairedData(
        ["/nonexistent/x.png"], ["/nonexistent/y.png"], [[0] * 8],
        cache_size=32)
    with pytest.raises(FileNotFoundError):
        list(stream.batches(1))


def test_streaming_rejected_for_single_modality(tmp_path):
    with pytest.raises(NotImplementedError, match="streaming"):
        build_dataset("ISIC17Dataset", str(tmp_path), "train", streaming=True)
    with pytest.raises(NotImplementedError, match="streaming"):
        ref_datasets.build_dataset("ISIC17Dataset", str(tmp_path), "train",
                                   streaming=True)


def test_no_cache_images_flag_lands_in_config():
    data, _, _ = base_configs(get_parser("t").parse_args(
        ["--no-cache-images"]))
    assert data.cache_images is False
    data, _, _ = base_configs(get_parser("t").parse_args([]))
    assert data.cache_images is True


@pytest.fixture(scope="module")
def jpeg_files(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(200, 300), (120, 90), (64, 64), (40, 44)]):
        # smooth images, so that the two area-average resizes stay close
        base = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        p = os.path.join(d, f"img{i}.jpg")
        cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append(p)
    return paths


def test_native_loader_builds_into_the_build_directory():
    assert loader.native_loader_available(), "g++ / libjpeg build failed"
    assert loader._SO.is_file()
    assert loader._SO.parent.parts[-2:] == ("build", "sm3x_torch")
    here = os.path.dirname(os.path.abspath(loader.__file__))
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


@pytest.mark.parametrize("cache,crop", [(128, 10), (64, 25), (320, 0)])
def test_native_loader_equals_the_reference_s(jpeg_files, cache, crop):
    canv, hw, ok = loader.decode_letterbox_batch(jpeg_files, cache, crop, 2)
    rc, rhw, rok = ref_loader.decode_letterbox_batch(jpeg_files, cache, crop,
                                                     2)
    assert ok.all() and rok.all()
    np.testing.assert_array_equal(canv, rc)
    np.testing.assert_array_equal(hw, rhw)
    assert canv.dtype == np.uint8 and hw.dtype == np.int32


def test_native_matches_python_path(jpeg_files):
    cache, crop = 128, 10
    canv, hw, ok = loader.decode_letterbox_batch(jpeg_files, cache, crop,
                                                 workers=2)
    assert ok.all()
    for i, p in enumerate(jpeg_files):
        img = decode_image(p)[:, :, :3][crop:-crop, crop:-crop]
        want_canvas, (h, w) = letterbox(img, cache)
        assert tuple(hw[i]) == (h, w)
        got = canv[i][:h, :w].astype(np.int32)
        want = want_canvas[:h, :w].astype(np.int32)
        assert np.mean(np.abs(got - want)) < 3.0
        assert canv[i][h:, :].sum() == 0 and canv[i][:, w:].sum() == 0


def test_decode_canvas_batch_routes_jpegs_through_the_loader(jpeg_files):
    native, nhw = decode_canvas_batch(jpeg_files, 128, 10, 2)
    direct, dhw, _ = loader.decode_letterbox_batch(jpeg_files, 128, 10, 2)
    np.testing.assert_array_equal(native, direct)
    np.testing.assert_array_equal(nhw, dhw)
    python, phw = decode_canvas_batch(jpeg_files, 128, 10, 2,
                                      use_native=False)
    np.testing.assert_array_equal(phw, nhw)
    assert np.mean(np.abs(native.astype(np.int32) - python)) < 3.0


def test_non_jpeg_falls_back(tmp_path, jpeg_files):
    import cv2

    p = os.path.join(tmp_path, "img.png")
    img = np.random.default_rng(1).integers(0, 255, (50, 50, 3), np.uint8)
    cv2.imwrite(p, img[:, :, ::-1])
    canv, hw, ok = loader.decode_letterbox_batch([p, jpeg_files[2]], 64, 0, 1)
    assert not ok[0] and ok[1]  # the loader takes the JPEG and not the PNG
    store = ImageStore([p, jpeg_files[2]], cache_size=64, crop_amount=0)
    assert tuple(store.valid_hw[0]) == (50, 50)  # ...and the store has both
    np.testing.assert_array_equal(store.canvases[0][:50, :50], img)
    np.testing.assert_array_equal(store.canvases[1], canv[1])
    assert loader.decode_letterbox_batch([], 64, 0)[0].shape == (0, 64, 64, 3)
