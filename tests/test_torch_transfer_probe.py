"""The ISIC transfer probe of the port (sm3x_torch.train.transfer_probe and
the single-image datasets) against the JAX package's
(sm3x.train.transfer_probe, sm3x.data.datasets), on the CPU, on tiny ISIC17
trees and one stage-1 `.pth` (running statistics moved off their initial
values) that both read:
- the datasets: the same canvases, sizes and label columns, exactly;
- the frozen encoder's eval features (`make_single_extract_fn`: the
  resize, ImageNet's mean and std, the encoder in eval mode) on one batch,
  in float32 at rtol 1e-4 / atol 1e-5, and under each side's default bf16
  at atol 5e-2 (measured 1.6e-2: one or two bf16 steps of values up to
  1.4);
- the train features: the `PROBE_AUG` view of the seed's stream 0 through
  the frozen encoder, and `PROBE_AUG` equal to the JAX package's;
- the whole probe, both sides in float32 with the port's heads given the
  JAX package's initial weights, on a tree of one-colour images (so a
  crop and a flip change no pixel, and jax.random's draws, which torch
  cannot reproduce, do not matter): every stats value at rtol 1e-5 /
  atol 1e-6, measured 1.3e-7;
- one 2-class head a label column, named `L{i}`; the derm and clinic
  encoders loaded strictly from a dual-modal and from a tri-modal
  checkpoint; the CLI's refusals.
"""

import csv
import dataclasses
import functools

import numpy as np
import pytest
import torch

from sm3x.data import datasets as ref_datasets
from sm3x_torch.data import datasets
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.models.trimodal import TriModalSimCLR
from sm3x_torch.train import transfer_probe
from sm3x_torch.utils import weights

torch.set_num_threads(2)

N_TRAIN, N_TEST = 10, 6


def _make_isic(root, year=17, n_train=N_TRAIN, n_test=N_TEST, seed=0,
               columns=("melanoma", "seborrheic_keratosis")):
    """An ISIC-layout tree: JPEGs of 40-70 pixels a side and their label
    CSVs with binary columns."""
    from PIL import Image

    subs = {17: ("ISIC-2017_Training_Data", "ISIC-2017_Test_v2_Data"),
            18: ("ISIC2018_Task1-2_Training_Input",
                 "ISIC2018_Task1-2_Test_Input")}[year]
    rng = np.random.default_rng(seed)
    for sub, csvname, n in ((subs[0], "train_labels.csv", n_train),
                            (subs[1], "test_labels.csv", n_test)):
        (root / sub).mkdir()
        with open(root / csvname, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image_id", *columns])
            for i in range(n):
                h, wd = rng.integers(40, 71, 2)
                img = rng.integers(0, 256, (h, wd, 3), dtype=np.uint8)
                Image.fromarray(img).save(root / sub / f"isic{i}.jpg")
                w.writerow([f"isic{i}"] + [int((i + k) % 2)
                                           for k in range(len(columns))])
    return str(root)


@pytest.fixture(scope="module")
def isic17(tmp_path_factory):
    return _make_isic(tmp_path_factory.mktemp("isic17"))


@pytest.fixture(scope="module")
def ssl_pth(tmp_path_factory):
    """A port stage-1 checkpoint (v32, resnet18), as its trainer writes
    one."""
    torch.manual_seed(0)
    model, _ = build_ssl_model("v32", "resnet18", 16)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for k, buf in model.named_buffers():
            if k.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0.0, 0.1, buf.shape)))
            elif k.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, buf.shape)))
    path = str(tmp_path_factory.mktemp("ckpt") / "ckp_0.pth")
    torch.save({"epoch": 1, "state_dict": model.state_dict()}, path)
    return path, model


@pytest.mark.parametrize("year", [17, 18])
def test_single_image_sets_equal_the_jax_package_s(tmp_path, year):
    root = _make_isic(tmp_path, year, columns=("a", "b", "c"))
    name = f"ISIC{year}Dataset"
    for mode in ("train", "test"):
        got = datasets.build_dataset(name, root, mode, cache_size=48,
                                     workers=1)
        want = ref_datasets.build_dataset(name, root, mode, cache_size=48,
                                          workers=1)
        assert got.n == want.n == (N_TRAIN if mode == "train" else N_TEST)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.labels.shape[1] == 3
        np.testing.assert_array_equal(got.store.canvases,
                                      want.store.canvases)
        np.testing.assert_array_equal(got.store.valid_hw, want.store.valid_hw)
        for a, b in zip(got.batches(4, 1, 7), want.batches(4, 1, 7)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_single_image_sets_are_never_streamed(tmp_path):
    for name in datasets.SINGLE_IMAGE:
        with pytest.raises(NotImplementedError) as got:
            datasets.build_dataset(name, str(tmp_path), "train",
                                   streaming=True)
        with pytest.raises(NotImplementedError) as want:
            ref_datasets.build_dataset(name, str(tmp_path), "train",
                                       streaming=True)
        assert str(got.value) == str(want.value)


def _batch(root, mode="train"):
    data = transfer_probe.SingleProbeData(datasets.build_dataset(
        "ISIC17Dataset", root, mode, cache_size=48, workers=1))
    return next(iter(data.batches(8, 0, 3407, shuffle=False)))


MEAN_STD = (transfer_probe.IMAGENET_MEAN, transfer_probe.IMAGENET_STD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_features_equal_the_jax_package_s(isic17, ssl_pth, dtype):
    """The clinic encoder's eval features on one batch of 8, at 32 x 32."""
    import jax
    import jax.numpy as jnp

    from sm3x.models import backbones as jax_backbones
    from sm3x.train import transfer_probe as jax_tp

    path, _ = ssl_pth
    batch = _batch(isic17)
    enc = transfer_probe.load_single_encoder(path, "resnet18", "clinic",
                                             "cpu", (32, 32))
    got = transfer_probe.make_single_extract_fn(
        enc, "cpu", *MEAN_STD, (32, 32), dtype=getattr(torch, dtype))(
            batch, 5, False).numpy()
    jenc, params, stats, mesh = jax_tp.load_single_encoder(path, "resnet18",
                                                           "clinic")
    if dtype == "float32":
        jenc = jax_backbones.build_backbone("resnet18", dtype=jnp.float32)
    want = np.asarray(jax_tp.make_single_extract_fn(
        jenc, params, stats, mesh, *MEAN_STD, (32, 32))(
            batch, jax.random.key(0), False), np.float32)
    assert got.shape == want.shape == (8, 512)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(
        rtol=0.0, atol=5e-2)
    np.testing.assert_allclose(got, want, **tol)


def test_train_features_are_the_probe_views_through_the_frozen_encoder(
        isic17, ssl_pth):
    from sm3x.ops.augment import PROBE_AUG as JAX_PROBE_AUG
    from sm3x_torch.core import prng
    from sm3x_torch.ops.augment import PROBE_AUG, ssl_augment_batch

    assert dataclasses.asdict(PROBE_AUG) == dataclasses.asdict(JAX_PROBE_AUG)
    path, _ = ssl_pth
    batch = _batch(isic17)
    enc = transfer_probe.load_single_encoder(path, "resnet18", "clinic",
                                             "cpu", (32, 32))
    extract = transfer_probe.make_single_extract_fn(
        enc, "cpu", *MEAN_STD, (32, 32), dtype=torch.float32)
    got = extract(batch, 5, True)
    views = ssl_augment_batch(
        prng.generator(prng.fold_in(5, 0), "cpu"),
        torch.from_numpy(batch.image), torch.from_numpy(batch.image_hw),
        *MEAN_STD, dataclasses.replace(PROBE_AUG, out_size=(32, 32)))
    with torch.no_grad():
        assert torch.equal(got, enc(views))
    assert not torch.allclose(got, extract(batch, 5, False), atol=1e-2)


def _make_flat_isic(root, n_train=16, n_test=8, seed=2):
    """An ISIC17 tree of one-colour JPEGs of 40-70 pixels a side, with
    random binary labels."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub, csvname, n in (("ISIC-2017_Training_Data", "train_labels.csv",
                             n_train),
                            ("ISIC-2017_Test_v2_Data", "test_labels.csv",
                             n_test)):
        (root / sub).mkdir()
        with open(root / csvname, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image_id", "melanoma", "seborrheic_keratosis"])
            for i in range(n):
                h, wd = rng.integers(40, 71, 2)
                colour = rng.integers(0, 256, 3, dtype=np.uint8)
                Image.fromarray(np.broadcast_to(colour, (h, wd, 3)).copy()
                                ).save(root / sub / f"isic{i}.jpg")
                w.writerow([f"isic{i}", *rng.integers(0, 2, 2)])
    return str(root)


def test_probe_against_the_jax_package_s(tmp_path, ssl_pth, monkeypatch):
    """Both probes from the same `.pth` (the clinic encoder, 32x32, batch
    8, 2 epochs) in float32, the port's heads starting from the JAX
    package's: the same best stats."""
    import jax
    import jax.numpy as jnp

    from sm3x.models import backbones as jax_backbones
    from sm3x.train import transfer_probe as jax_tp

    root = _make_flat_isic(tmp_path)
    for mode in ("train", "test"):
        store = datasets.build_dataset("ISIC17Dataset", root, mode,
                                       cache_size=48, workers=1).store
        for canvas, (h, w) in zip(store.canvases, store.valid_hw):
            assert (canvas[:h, :w] == canvas[0, 0]).all()
    path, _ = ssl_pth
    kw = dict(arch="resnet18", modality="clinic", img_sz=(32, 32),
              batch_size=8, epochs=2, cache_size=48, workers=1)
    heads = {}

    class JaxProbe(jax_tp.LinearProbe):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            heads.update(jax.tree.map(np.array, self.state.params))

    class Probe(transfer_probe.LinearProbe):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sd = weights.baseline_state_dict({"classifier": heads}, {})
            self.model.load_state_dict(
                {k[len("classifier."):]: torch.from_numpy(v)
                 for k, v in sd.items()}, strict=True)

    build = jax_backbones.build_backbone
    with monkeypatch.context() as mp:
        mp.setattr(jax_backbones, "build_backbone",
                   lambda arch, *a, **k: build(arch, dtype=jnp.float32))
        mp.setattr(jax_tp, "LinearProbe", JaxProbe)
        want = jax_tp.run_transfer_probe(path, "ISIC17Dataset", root, **kw)
    monkeypatch.setattr(transfer_probe, "LinearProbe", Probe)
    monkeypatch.setattr(transfer_probe, "make_single_extract_fn",
                        functools.partial(
                            transfer_probe.make_single_extract_fn,
                            dtype=torch.float32))
    got = transfer_probe.run_transfer_probe(path, "ISIC17Dataset", root,
                                            device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert {"AUC_L0", "AUC_L1", "AUC_AVG", "loss"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        if k.startswith("AUC"):
            assert 0.0 <= v <= 1.0, k


def test_probe_heads_are_one_binary_head_a_column(isic17, ssl_pth,
                                                  monkeypatch):
    built = []
    real = transfer_probe.LinearProbe

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(transfer_probe, "LinearProbe", spy)
    transfer_probe.run_transfer_probe(
        ssl_pth[0], "ISIC17Dataset", isic17, arch="resnet18",
        img_sz=(32, 32), batch_size=8, epochs=1, cache_size=48, workers=1,
        device="cpu")
    probe = built[0]
    assert probe.num_classes == (2, 2)
    assert probe.classes_name == ("L0", "L1")
    heads = [m for m in probe.model.modules()
             if isinstance(m, torch.nn.Linear)]
    assert [h.weight.shape for h in heads] == [(2, 512)] * 2


@pytest.mark.parametrize("modality", ["derm", "clinic"])
def test_encoder_loads_strictly_from_dual_and_trimodal_files(tmp_path,
                                                             ssl_pth,
                                                             modality):
    path, model = ssl_pth
    mod = f"{modality}_backbone"
    enc = transfer_probe.load_single_encoder(path, "resnet18", modality,
                                             "cpu", (32, 32))
    want = getattr(model, mod).encoder.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in enc.state_dict().items())
    assert not enc.training and not any(p.requires_grad
                                        for p in enc.parameters())
    torch.manual_seed(1)
    tri = TriModalSimCLR("resnet18", 16, (4, 4, 16))
    tri_path = str(tmp_path / "tri.pth")
    torch.save({"epoch": 1, "state_dict": tri.state_dict()}, tri_path)
    enc = transfer_probe.load_single_encoder(tri_path, "resnet18", modality,
                                             "cpu")
    want = getattr(tri, mod).encoder.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in enc.state_dict().items())


def test_a_file_without_encoders_is_refused(tmp_path):
    path = str(tmp_path / "x.pth")
    torch.save({"state_dict": {"fc.weight": torch.zeros(2, 2)}}, path)
    with pytest.raises(ValueError, match="no 'derm_backbone.encoder"):
        transfer_probe.load_single_encoder(path, "resnet18", "derm", "cpu")


def test_cli_rejects_a_bad_modality_as_the_jax_package_s():
    from sm3x.train.transfer_probe import main as jax_main

    argv = ["--pretrain-path", "x", "--data-path", "y", "--modality", "nope"]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        transfer_probe.main(argv)
    assert got.value.code == want.value.code == 2
