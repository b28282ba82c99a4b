"""The golden quality-parity lock of tests/test_golden_pth_lock.py, for the
port: a real `.pth` with the released checkpoints' key conventions (the
`{"state_dict": ...}` wrapper, `module.` prefixes, `encoder.` inside the
extractor keys), written from the torch oracle of tests/torch_ref.py, goes
through `sm3x_torch.reproduce` on the CPU in float32:

  * its logits are within 2e-4 of `sm3x.reproduce.evaluate(..., fp32=True)`
    on the same file and data (load, key surgery, eval resize, forward);
  * every cell of its CSV is within 0.2 of the CSV computed from the
    oracle's own forward (which resizes with F.interpolate), and
    `compare_csv` passes;
  * the file loads in both key forms, with `encoder.` kept and stripped, and
    `inference_torch.py`'s API gives the oracle's logits on its own inputs.
"""

import numpy as np
import pytest
import torch

from sm3x.data.datasets import SevenPCBaseDataset
from sm3x.data.synthetic import make_fake_derm7pt
from sm3x.metrics import write_results_csv
from sm3x.reproduce import evaluate as jax_evaluate
from sm3x_torch import api, reproduce
from sm3x_torch.utils.checkpoint import (load_pretrained_state,
                                         load_state_dict_file)

from test_golden_pth_lock import MEAN, STD, TorchEvalModel, _torch_eval_preds
from torch_ref import randomize_bn_stats

torch.set_num_threads(2)

SHAPE = dict(arch="resnet18", mlc_proj_dim=32, sa_dim_ff=16, batch_size=8,
             cache_size=64, test_sz=64)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden")
    root = str(tmp / "data")
    make_fake_derm7pt(root, n_cases=24, img_size=56)
    gen = torch.Generator().manual_seed(11)
    torch.manual_seed(11)
    oracle = TorchEvalModel(feat_dim=1024, proj_dim=32, ff=16)
    randomize_bn_stats(oracle, gen)
    # the released init is normal(0, 0.01); wider heads separate the cases'
    # logits, so AUROC is not brittle to ties at this size
    for p in oracle.prototypes:
        p.weight.data.normal_(0.0, 0.5, generator=gen)
        p.bias.data.normal_(0.0, 0.5, generator=gen)
    oracle.eval()
    pth = str(tmp / "best_finetune.pth")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in oracle.state_dict().items()},
                "epoch": 3}, pth)
    stripped = str(tmp / "stripped.pth")  # as the reference's loader sees it
    torch.save({k.replace("encoder.", ""): v
                for k, v in oracle.state_dict().items()}, stripped)
    data = SevenPCBaseDataset(root, "test", cache_size=64)
    preds, targets = _torch_eval_preds(oracle, data, 64, batch_size=8)
    expected = str(tmp / "expected.csv")
    write_results_csv(expected, preds, targets)
    return dict(tmp=tmp, root=root, oracle=oracle, pth=pth, stripped=stripped,
                expected=expected, oracle_preds=preds, targets=targets)


def test_port_logits_match_the_jax_package_on_the_released_layout(golden):
    got, targets = reproduce.evaluate(golden["pth"], golden["root"], **SHAPE,
                                      mean=MEAN, std=STD, fp32=True,
                                      device="cpu")
    want, want_targets = jax_evaluate(golden["pth"], golden["root"], **SHAPE,
                                      mean=MEAN, std=STD, fp32=True)
    np.testing.assert_array_equal(targets, want_targets)
    np.testing.assert_array_equal(targets, golden["targets"])
    assert len(got) == 8 and got[0].shape == (len(targets), 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-4)


def test_port_csv_locks_against_the_oracle_s(golden, capsys):
    out_csv = str(golden["tmp"] / "ours.csv")
    with pytest.raises(SystemExit) as done:
        reproduce.main([
            "--pretrain-path", golden["pth"], "--data-path", golden["root"],
            "--out", out_csv, "--compare", golden["expected"], "--tolerance",
            "0.2", "-a", "resnet18", "--mlc-proj-dim", "32", "--sa-dim-ff",
            "16", "-b", "8", "--test-sz", "64", "--cache-size", "64",
            "--fp32", "--device", "cpu"])
    assert done.value.code == 0
    assert "PASS: 0 cells beyond" in capsys.readouterr().out
    assert reproduce.compare_csv(out_csv, golden["expected"], 0.2)[0] == 0
    ours = open(out_csv).read().splitlines()
    exp = open(golden["expected"]).read().splitlines()
    assert ours[0] == exp[0]  # the released header
    for a, b in zip(ours[1:], exp[1:]):
        ca, cb = a.split(","), b.split(",")
        assert ca[0] == cb[0]
        assert max(abs(float(x) - float(y))
                   for x, y in zip(ca[1:], cb[1:])) <= 0.2, ca[0]


def test_both_key_forms_load_to_the_same_model(golden):
    kept = load_pretrained_state(golden["pth"])
    stripped = load_pretrained_state(golden["stripped"])
    assert sorted(kept) == sorted(stripped) == sorted(
        golden["oracle"].state_dict())
    assert all(torch.equal(kept[k], stripped[k]) for k in kept)
    raw = load_state_dict_file(golden["stripped"])
    assert "extractor.derm_backbone.conv1.weight" in raw
    assert not any(k.startswith("module.")
                   for k in load_state_dict_file(golden["pth"]))
    models = [api.load_weights(api.build_evaluator(
        "resnet18", mlc_proj_dim=32, sa_dim_ff=16, amp=False), path, "cpu")
        for path in (golden["pth"], golden["stripped"])]
    a, b = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_predict_fn_gives_the_oracle_s_logits(golden):
    """NHWC float batches in, eight logit tensors out, from an eval-mode
    forward without a graph; the oracle takes the same images as NCHW."""
    model = api.load_weights(api.build_evaluator(
        "resnet18", mlc_proj_dim=32, sa_dim_ff=16, amp=False), golden["pth"],
        "cpu")
    rng = np.random.default_rng(5)
    derm, clinic = (rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
                    for _ in range(2))
    model.train()  # predict_fn runs in eval mode whatever the flag says
    preds = api.predict_fn(model)(derm, clinic)
    with torch.no_grad():
        want = golden["oracle"](
            torch.from_numpy(derm).permute(0, 3, 1, 2),
            torch.from_numpy(clinic).permute(0, 3, 1, 2))
    assert len(preds) == 8 and not preds[0].requires_grad
    for g, w in zip(preds, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_a_wrong_shape_fails_the_strict_load(golden):
    with pytest.raises(RuntimeError, match="size mismatch"):
        api.load_weights(api.build_evaluator(
            "resnet18", mlc_proj_dim=64, sa_dim_ff=16, amp=False),
            golden["pth"], "cpu")
