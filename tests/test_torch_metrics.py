"""The port's metrics (sm3x_torch.metrics, numpy alone) against the JAX
package's (sm3x.metrics): every function exactly equal on random logits,
on probabilities and on ties, and the results CSV equal byte for byte. The
port's `_rankdata` stands in for scipy's and is held against it."""

import warnings

import numpy as np
import pytest

import sm3x.metrics as ref
import sm3x_torch.metrics as port
from sm3x import NUM_CLASSES

N = 57


def _case(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    targets = np.stack([rng.integers(0, c, N) for c in NUM_CLASSES], axis=1)
    if kind == "logits":
        preds = [3 * rng.standard_normal((N, c)) for c in NUM_CLASSES]
    elif kind == "float32":
        preds = [rng.standard_normal((N, c)).astype(np.float32)
                 for c in NUM_CLASSES]
    elif kind == "probabilities":
        preds = [ref.softmax(rng.standard_normal((N, c))) for c in NUM_CLASSES]
    elif kind == "ties":   # few distinct scores: ranks and thresholds tie
        preds = [rng.integers(-2, 3, (N, c)).astype(np.float64)
                 for c in NUM_CLASSES]
    elif kind == "one_class":  # a label whose targets are all one class
        preds = [rng.standard_normal((N, c)) for c in NUM_CLASSES]
        targets[:, 2] = 0
    else:
        raise ValueError(kind)
    return preds, targets


KINDS = ["logits", "float32", "probabilities", "ties", "one_class"]


def test_rankdata_equals_scipy():
    from scipy.stats import rankdata

    rng = np.random.default_rng(1)
    for a in (rng.standard_normal(100), rng.integers(0, 5, 100).astype(float),
              np.zeros(7), np.array([2.0]), np.array([])):
        np.testing.assert_array_equal(port._rankdata(a), rankdata(a))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn", [
    "multiclass_auroc", "multiclass_recall", "multiclass_specificity",
    "multiclass_precision", "multiclass_accuracy",
    "multiclass_average_precision"])
def test_per_class_metric_equals_the_jax_package(fn, kind):
    preds, targets = _case(kind)
    for i, c in enumerate(NUM_CLASSES):
        for average in (None, "macro"):
            got = getattr(port, fn)(preds[i], targets[:, i], c, average)
            want = getattr(ref, fn)(preds[i], targets[:, i], c, average)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("probabilities", [None, False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_stage_metrics_and_map_equal_the_jax_package(kind, probabilities):
    preds, targets = _case(kind, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for fn in ("compute_stage_metrics", "mean_average_precision"):
            got = getattr(port, fn)(preds, targets,
                                    probabilities=probabilities)
            want = getattr(ref, fn)(preds, targets,
                                    probabilities=probabilities)
            assert got == want and list(got) == list(want)


@pytest.mark.parametrize("kind", KINDS)
def test_results_csv_equals_the_jax_package_byte_for_byte(tmp_path, kind):
    preds, targets = _case(kind, seed=3)
    prob = True if kind == "probabilities" else False
    a = port.write_results_csv(str(tmp_path / "port.csv"), preds, targets,
                               probabilities=prob)
    b = ref.write_results_csv(str(tmp_path / "ref.csv"), preds, targets,
                              probabilities=prob)
    got, want = open(a, "rb").read(), open(b, "rb").read()
    assert got == want
    header = got.decode().splitlines()[0].split(",")
    assert header[1] == "BWV-1" and header[-1] == "DIAG avg"
    assert [ln.split(",")[0] for ln in got.decode().splitlines()[1:]] == [
        "Acc", "AUC", "Recall", "Spec", "Prec"]
    assert port.results_table(preds, targets, prob) == ref.results_table(
        preds, targets, prob)


def test_probability_heuristic_and_its_warning():
    rng = np.random.default_rng(4)
    inside = rng.random((N, 3)) * 0.9        # in [0, 1], rows not summing to 1
    for mod in (port, ref):
        with pytest.warns(UserWarning, match="probabilities=False"):
            mod._as_probabilities(inside)
    np.testing.assert_array_equal(port._as_probabilities(inside), inside)
    logits = 4 * rng.standard_normal((N, 3))
    for p in (None, False, True):
        np.testing.assert_array_equal(port._as_probabilities(logits, p),
                                      ref._as_probabilities(logits, p))
    np.testing.assert_array_equal(port.softmax(logits), ref.softmax(logits))


def test_auroc_and_ap_edge_cases():
    scores = np.array([0.1, 0.4, 0.4, 0.8])
    for pos in ([0, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 1, 0]):
        pos = np.array(pos, dtype=bool)
        assert port.binary_auroc_from_scores(scores, pos) == \
            ref.binary_auroc_from_scores(scores, pos)
        assert port.binary_average_precision(scores, pos) == \
            ref.binary_average_precision(scores, pos)
    assert port.binary_auroc_from_scores(scores, np.zeros(4, bool)) == 0.0


def test_topk_accuracy_equals_the_jax_package():
    rng = np.random.default_rng(5)
    out, tgt = rng.standard_normal((N, 5)), rng.integers(0, 5, N)
    assert port.topk_accuracy(out, tgt, (1, 3)) == ref.topk_accuracy(
        out, tgt, (1, 3))


def test_constants_and_layout_are_the_jax_package():
    assert port._CSV_LABEL_ORDER == ref._CSV_LABEL_ORDER
    assert port._CSV_METRIC_ROWS == ref._CSV_METRIC_ROWS
    assert list(port.METRIC_FNS) == list(ref.METRIC_FNS)
