"""The port's own data layer (sm3x_torch/data/derm7pt.py, pipeline.py,
datasets.py) against the JAX package's, on one synthetic Derm7pt tree:
equal sizes, canvases, valid sizes, labels, metadata codes and batch order,
exactly (both decode PNGs through OpenCV; integers throughout)."""

import dataclasses

import numpy as np
import pytest

import sm3x.data.datasets as ref_datasets
import sm3x.data.derm7pt as ref_derm7pt
import sm3x.data.pipeline as ref_pipeline
from sm3x.data.synthetic import make_fake_derm7pt
from sm3x_torch.data import datasets, derm7pt, pipeline


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_data_7pc")
    make_fake_derm7pt(str(path), n_cases=32, img_size=56)
    return str(path)


@pytest.mark.parametrize("name,mode", [("SevenPCBaseDataset", "train"),
                                       ("SevenPCBaseDataset", "valid"),
                                       ("SevenPCBaseDataset2", "test")])
def test_build_dataset_equals_the_jax_packages(root, name, mode):
    kw = dict(cache_size=48, workers=2)
    got = datasets.build_dataset(name, root, mode, **kw)
    want = ref_datasets.build_dataset(name, root, mode, **kw)
    assert got.n == want.n > 0
    for side in ("derm", "clinic"):
        g, w = getattr(got, side), getattr(want, side)
        assert g.canvases.dtype == w.canvases.dtype == np.uint8
        np.testing.assert_array_equal(g.canvases, w.canvases)
        np.testing.assert_array_equal(g.valid_hw, w.valid_hw)
        assert g.canvases.any()
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.meta_codes, want.meta_codes)
    assert got.meta_vocab_sizes == want.meta_vocab_sizes
    assert got.steps_per_epoch(8) == want.steps_per_epoch(8)
    for epoch in (0, 1):
        gb = list(got.batches(8, epoch, 3407))
        wb = list(want.batches(8, epoch, 3407))
        assert len(gb) == len(wb) == got.steps_per_epoch(8)
        for g, w in zip(gb, wb):
            for field in ("derm", "derm_hw", "clinic", "clinic_hw", "label",
                          "index", "mask", "meta"):
                a, b = getattr(g, field), getattr(w, field)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    # the two epochs are different permutations
    assert not np.array_equal(next(got.batches(8, 0)).index,
                              next(got.batches(8, 1)).index)


def test_letterbox_of_a_larger_image_equals_the_jax_packages(root):
    """The INTER_AREA downscale branch (the synthetic images are smaller
    than the cache above): a 56-px source into a 24-px canvas, no crop."""
    meta = derm7pt.Derm7ptMeta(root)
    paths = meta.derm_paths[:6]
    got = pipeline.ImageStore(paths, cache_size=24, crop_amount=0, workers=2)
    want = ref_pipeline.ImageStore(paths, cache_size=24, crop_amount=0,
                                   workers=2)
    np.testing.assert_array_equal(got.canvases, want.canvases)
    np.testing.assert_array_equal(got.valid_hw, want.valid_hw)
    assert (got.valid_hw.max(axis=1) == 24).all()  # every image was shrunk


def test_ungrouped_schema_refuses_grouped_labels_as_the_jax_package(root):
    """The synthetic tree carries grouped label strings: the full schema
    raises on them, with the same message in both packages."""
    errs = []
    for mod in (derm7pt, ref_derm7pt):
        with pytest.raises(ValueError, match="not in category") as e:
            mod.Derm7ptMeta(root, grouped=False)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    for schema in ("FULL_SCHEMA", "GROUPED_SCHEMA"):
        got, want = getattr(derm7pt, schema), getattr(ref_derm7pt, schema)
        assert ({k: dataclasses.asdict(v) for k, v in got.items()}
                == {k: dataclasses.asdict(v) for k, v in want.items()})


def test_meta_equals_the_jax_packages(root):
    got = derm7pt.Derm7ptMeta(root)
    want = ref_derm7pt.Derm7ptMeta(root)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.num_classes() == want.num_classes()
    assert got.derm_paths == want.derm_paths
    assert got.clinic_paths == want.clinic_paths
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(got.split_indexes(split),
                                      want.split_indexes(split))
    assert got.meta_vocabs == want.meta_vocabs


@pytest.mark.parametrize("n,batch", [(10, 4), (3, 8), (8, 8)])
def test_batch_selections_equal_the_jax_packages(n, batch):
    order = np.random.default_rng(n).permutation(n)
    got = list(pipeline.iter_batch_selections(order, batch))
    want = list(ref_pipeline.iter_batch_selections(order, batch))
    assert len(got) == len(want)
    for (gs, gm), (ws, wm) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)


def test_registry_holds_what_stage_1_takes(root):
    """Stage 1 takes the paired sets; the registry also holds the
    single-image ISIC sets of the transfer probe, as the reference's."""
    from sm3x_torch.train.backbone_train import DATASETS

    assert sorted(DATASETS) == sorted(datasets.PAIRED)
    assert sorted(datasets.REGISTRY) == sorted(
        datasets.PAIRED + datasets.SINGLE_IMAGE)
    assert sorted(datasets.REGISTRY) == sorted(ref_datasets.REGISTRY)
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.build_dataset("ISIC19Dataset", root, "train")
