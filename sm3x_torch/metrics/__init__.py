"""Evaluation metrics with torchmetrics' semantics, on host numpy: the
port's own copy of sm3x/metrics/__init__.py, which it does not import, and
held exactly equal to it (CSV bytes included) by tests/test_torch_metrics.py.
It needs numpy alone: the average ranks come from `_rankdata` below, not
from scipy.

Per label the reference computes per-class AUROC / Recall / Specificity /
Precision with `average=None` and selects one class, the clinically
positive index CLS_WEIGHTS[label]; AVG is the mean over the 8 labels. The
released CSVs also store every per-class column.

* AUROC: softmax the logits, one-vs-rest, tie-aware rank statistic
  (Mann-Whitney U), 0.0 when a class has no positives or no negatives.
* Recall = TP/(TP+FN), Specificity = TN/(TN+FP), Precision = TP/(TP+FP)
  on argmax predictions, 0.0 where the denominator is 0.

The eval sets are a few hundred rows; the forward passes that produce the
logits are the device's work.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from sm3x_torch import CLASSES_NAME, CLS_WEIGHTS, METRICS_NAME, NUM_CLASSES


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _rankdata(a: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with ties, scipy.stats.rankdata('average'):
    a run of equal values at sorted positions i..j gets (i + j) / 2 + 1."""
    a = np.asarray(a).ravel()
    order = np.argsort(a, kind="stable")
    s = a[order]
    starts = np.r_[True, s[1:] != s[:-1]]
    group = np.cumsum(starts) - 1
    first = np.flatnonzero(starts)
    last = np.r_[first[1:], len(s)] - 1
    ranks = np.empty(len(s), dtype=np.float64)
    ranks[order] = (first[group] + last[group]) / 2.0 + 1.0
    return ranks


def binary_auroc_from_scores(scores: np.ndarray, positives: np.ndarray) -> float:
    n_pos = int(positives.sum())
    n_neg = len(positives) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    ranks = _rankdata(scores)
    u = ranks[positives].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _as_probabilities(preds: np.ndarray, probabilities=None) -> np.ndarray:
    """torchmetrics' input convention: values outside [0,1] are logits
    (softmaxed), else probabilities. That heuristic silently mis-reads
    early-training logits that happen to land inside [0,1] — so when it
    fires on rows that do NOT sum to 1 we warn, and `probabilities` lets
    callers state the input kind explicitly (True = already
    probabilities, False = logits, None = heuristic)."""
    preds = np.asarray(preds, dtype=np.float64)
    if probabilities is False:
        return softmax(preds, axis=-1)
    if probabilities is True:
        return preds
    if preds.min() < 0 or preds.max() > 1:
        return softmax(preds, axis=-1)
    if preds.size and not np.allclose(preds.sum(axis=-1), 1.0, atol=1e-3):
        import warnings

        warnings.warn(
            "metric inputs all fall in [0,1] and are being treated as "
            "probabilities (torchmetrics convention), but rows do not sum "
            "to 1 — if these are logits, pass probabilities=False",
            stacklevel=3)
    return preds


def multiclass_auroc(preds: np.ndarray, target: np.ndarray,
                     num_classes: int, average=None,
                     probabilities=None) -> np.ndarray:
    """preds (N, C) logits or probabilities; target (N,) ints."""
    preds = _as_probabilities(preds, probabilities)
    target = np.asarray(target)
    out = np.array([
        binary_auroc_from_scores(preds[:, c], target == c)
        for c in range(num_classes)
    ])
    return out.mean() if average == "macro" else out


def _confusion_counts(preds: np.ndarray, target: np.ndarray, num_classes: int):
    pred_cls = np.asarray(preds).argmax(-1) if np.asarray(preds).ndim == 2 else np.asarray(preds)
    target = np.asarray(target)
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    tn = np.zeros(num_classes)
    for c in range(num_classes):
        p = pred_cls == c
        t = target == c
        tp[c] = np.sum(p & t)
        fp[c] = np.sum(p & ~t)
        fn[c] = np.sum(~p & t)
        tn[c] = np.sum(~p & ~t)
    return tp, fp, fn, tn


def _safe_div(a, b):
    return np.where(b > 0, a / np.maximum(b, 1), 0.0)


def multiclass_recall(preds, target, num_classes, average=None):
    tp, fp, fn, tn = _confusion_counts(preds, target, num_classes)
    out = _safe_div(tp, tp + fn)
    return out.mean() if average == "macro" else out


def multiclass_specificity(preds, target, num_classes, average=None):
    tp, fp, fn, tn = _confusion_counts(preds, target, num_classes)
    out = _safe_div(tn, tn + fp)
    return out.mean() if average == "macro" else out


def multiclass_precision(preds, target, num_classes, average=None):
    tp, fp, fn, tn = _confusion_counts(preds, target, num_classes)
    out = _safe_div(tp, tp + fp)
    return out.mean() if average == "macro" else out


def multiclass_accuracy(preds, target, num_classes, average=None):
    """Per-class accuracy == recall with average=None (what the released
    CSVs' 'Acc' row contains — it equals their Recall row)."""
    return multiclass_recall(preds, target, num_classes, average)


def binary_average_precision(scores: np.ndarray, positives: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over the descending-score operating
    points (sklearn average_precision_score / torchmetrics semantics);
    0.0 when the class has no positives."""
    positives = np.asarray(positives, dtype=bool)
    n_pos = int(positives.sum())
    if n_pos == 0:
        return 0.0
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")
    hits = positives[order]
    s = scores[order]
    # one operating point per unique threshold (ties grouped, as in
    # sklearn's precision_recall_curve)
    last = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tp = np.cumsum(hits)[last]
    precision = tp / (last + 1.0)
    recall_step = np.diff(np.r_[0.0, tp]) / n_pos
    return float((precision * recall_step).sum())


def multiclass_average_precision(preds, target, num_classes, average=None,
                                 probabilities=None):
    """One-vs-rest per-class AP; preds (N, C) logits or probabilities
    (see _as_probabilities for the input convention and the explicit
    `probabilities` override)."""
    preds = _as_probabilities(preds, probabilities)
    target = np.asarray(target)
    out = np.array([
        binary_average_precision(preds[:, c], target == c)
        for c in range(num_classes)
    ])
    return out.mean() if average == "macro" else out


def mean_average_precision(preds_list: Sequence[np.ndarray],
                           targets: np.ndarray,
                           num_classes: Sequence[int] = tuple(NUM_CLASSES),
                           cls_weights: Sequence[int] = tuple(CLS_WEIGHTS),
                           classes_name: Sequence[str] = tuple(CLASSES_NAME),
                           probabilities=None) -> Dict[str, float]:
    """mAP over the 8 labels (BASELINE.json names 'mAP parity'; the
    released CSVs carry Acc/AUC/Recall/Spec/Prec, so this is reported
    separately). Per label: macro AP over its classes plus the
    CLS_WEIGHTS-selected positive-class AP; *_AVG = mean over labels."""
    stats: Dict[str, float] = {}
    macro, sel = [], []
    for i, cname in enumerate(classes_name):
        ap = multiclass_average_precision(preds_list[i], targets[:, i],
                                          num_classes[i],
                                          probabilities=probabilities)
        stats[f"mAP_{cname}"] = float(ap.mean())
        macro.append(float(ap.mean()))
        sel.append(float(ap[min(cls_weights[i], num_classes[i] - 1)]))
    stats["mAP_AVG"] = float(np.mean(macro))
    stats["mAP_SEL_AVG"] = float(np.mean(sel))
    return stats


METRIC_FNS = {
    "AUC": multiclass_auroc,
    "Recall": multiclass_recall,
    "Spec": multiclass_specificity,
    "Prec": multiclass_precision,
}


def compute_stage_metrics(preds_list: Sequence[np.ndarray],
                          targets: np.ndarray,
                          num_classes: Sequence[int] = tuple(NUM_CLASSES),
                          cls_weights: Sequence[int] = tuple(CLS_WEIGHTS),
                          classes_name: Sequence[str] = tuple(CLASSES_NAME),
                          probabilities=None) -> Dict[str, float]:
    """The update_meters computation (misc.py:299-327): per label, compute
    the per-class metric and select index cls_weights[label]; AVG = mean
    over the labels. Returns {"AUC_DIAG": ..., "AUC_AVG": ..., ...}.

    `probabilities` states the input kind for the score-based metrics
    (AUC); trainer eval loops hold logits and pass False, the
    reproduce/parity paths keep the torchmetrics heuristic (None)."""
    stats: Dict[str, float] = {}
    for m in METRICS_NAME:
        fn = METRIC_FNS[m]
        kw = ({"probabilities": probabilities}
              if fn is multiclass_auroc else {})
        vals = []
        for i, cname in enumerate(classes_name):
            sel = min(cls_weights[i], num_classes[i] - 1)
            v = float(fn(preds_list[i], targets[:, i],
                         num_classes[i], **kw)[sel])
            stats[f"{m}_{cname}"] = v
            vals.append(v)
        stats[f"{m}_AVG"] = float(np.mean(vals))
    return stats


# ----------------------------------------------------------------------------
# Released-CSV emitter (linear_results.csv / finetune_results.csv layout)
# ----------------------------------------------------------------------------

# column order of the released CSVs: labels alphabetical, DIAG last
_CSV_LABEL_ORDER = ["BWV", "DaG", "PIG", "PN", "RS", "STR", "VS", "DIAG"]
_CSV_METRIC_ROWS = ["Acc", "AUC", "Recall", "Spec", "Prec"]


def results_table(preds_list: Sequence[np.ndarray], targets: np.ndarray,
                  probabilities=None):
    """Full per-class results in the released-CSV layout. Returns
    (header, {metric_row: [values...]}) with values in percent.
    `probabilities` as in compute_stage_metrics (affects AUC only)."""
    fns = dict(METRIC_FNS, Acc=multiclass_accuracy)
    label_idx = {c: i for i, c in enumerate(CLASSES_NAME)}

    header = []
    per_class = {m: [] for m in _CSV_METRIC_ROWS}
    sel = {m: [] for m in _CSV_METRIC_ROWS}          # CLS_WEIGHTS-selected
    diag_cols = {m: [] for m in _CSV_METRIC_ROWS}
    for cname in _CSV_LABEL_ORDER:
        i = label_idx[cname]
        vals = {m: fns[m](preds_list[i], targets[:, i], NUM_CLASSES[i],
                          **({"probabilities": probabilities}
                             if fns[m] is multiclass_auroc else {})) * 100.0
                for m in _CSV_METRIC_ROWS}
        for j in range(NUM_CLASSES[i]):
            header.append(f"{cname}-{j + 1}")
            for m in _CSV_METRIC_ROWS:
                per_class[m].append(float(vals[m][j]))
                if cname == "DIAG":
                    diag_cols[m].append(float(vals[m][j]))
        for m in _CSV_METRIC_ROWS:
            sel[m].append(float(vals[m][CLS_WEIGHTS[i]]))

    rows = {}
    n_diag = NUM_CLASSES[label_idx["DIAG"]]
    for m in _CSV_METRIC_ROWS:
        cols = per_class[m]
        all8 = float(np.mean(cols))
        avg8 = float(np.mean(sel[m]))
        all7 = float(np.mean(cols[: len(cols) - n_diag]))
        avg7 = float(np.mean(sel[m][: len(sel[m]) - 1]))
        diag = float(np.mean(diag_cols[m]))
        rows[m] = cols + [all8, avg8, all7, avg7, diag]
    header = header + ["8 all avg", "8 avg", "7 all avg", "7 avg", "DIAG avg"]
    return header, rows


def write_results_csv(path: str, preds_list, targets, probabilities=None):
    header, rows = results_table(preds_list, targets,
                                 probabilities=probabilities)
    with open(path, "w") as f:
        f.write("," + ",".join(header) + "\n")
        for m in _CSV_METRIC_ROWS:
            f.write(m + "," + ",".join(repr(v) for v in rows[m]) + "\n")
    return path


def topk_accuracy(output: np.ndarray, target: np.ndarray, topk=(1,)):
    """Top-k accuracy in percent (reference misc.py:611-625)."""
    maxk = max(topk)
    order = np.argsort(-np.asarray(output), axis=1)[:, :maxk]
    correct = order == np.asarray(target)[:, None]
    return [100.0 * float(correct[:, :k].any(axis=1).mean()) for k in topk]
