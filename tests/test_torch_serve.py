"""The port's serving path (sm3x_torch.serve, sm3x_torch.serve_http) against
the JAX package's (sm3x.serve) on the same weights and the same raw images,
on the CPU in float32, where the port's forward runs eagerly (a CUDA graph a
bucket is the card's path; tests/test_torch_kernels_cuda.py holds it).

Weights are initialised in JAX, moved off Flax's ones and zeros, exported
with `sm3x.utils.torch_export.export_mlc_model` and loaded strictly.
Probabilities: rtol 1e-4 / atol 1e-5, the tolerance the two ResNet-18
encoders are held to at this size (tests/test_torch_models.py). The request
surface (bucket, padding, chunking, crop, empty request) and the HTTP server
(round trip, concurrency, coalescing, 400 / 404 / 413, stop, a failing
predictor) follow tests/isolated/test_serve.py case by case.
"""

import base64
import concurrent.futures
import io
import json
import os
import queue
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.models.mlc import MLCModel as JaxMLCModel
from sm3x.serve import Predictor as JaxPredictor
from sm3x.utils import torch_export
from sm3x_torch import CLASSES_NAME, NUM_CLASSES
from sm3x_torch.api import build_evaluator
from sm3x_torch.serve import BucketedPredictor, Predictor, crop_border
from sm3x_torch.serve_http import PredictionServer, _Batcher, _decode_image
from sm3x_torch.utils import weights

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """The checkpoints these tests write are hundreds of MB each: give the
    space back after every test, not when pytest prunes its old runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


MODEL = dict(rtol=1e-4, atol=1e-5)
MEAN, STD = (0.5,) * 3, (0.25,) * 3
KW = dict(test_sz=48, buckets=(1, 4), canvas=64)


def _randomise(tree, rng):
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def pair():
    """(the JAX package's Predictor, the port's) on shared weights."""
    rng = np.random.default_rng(5)
    jm = JaxMLCModel(arch="resnet18", proj_dim=32, sa_dim_ff=16,
                     use_prototype_bias=True, dtype=jnp.float32)
    d = jnp.zeros((1, 48, 48, 3), jnp.float32)
    v = jax.jit(lambda r: jm.init({"params": r, "dropout": r}, d, d))(
        jax.random.key(0))
    v = {"params": _randomise(jax.tree.map(np.asarray, v["params"]), rng),
         "batch_stats": _randomise(jax.tree.map(np.asarray,
                                                v["batch_stats"]), rng)}
    ref = JaxPredictor(jm, v, mean=MEAN, std=STD, **KW)
    model = build_evaluator("resnet18", mlc_proj_dim=32, sa_dim_ff=16,
                            amp=False)
    sd = torch_export.export_mlc_model(v["params"], v["batch_stats"],
                                       "resnet18", "v4")
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    return ref, Predictor(model, MEAN, STD, **KW)


@pytest.fixture(scope="module")
def bf16_pair(pair):
    """(the JAX package's Predictor, the port's) at both packages' default
    bf16, on the float32 pair's weights."""
    ref, port = pair
    jm = JaxMLCModel(arch="resnet18", proj_dim=32, sa_dim_ff=16,
                     use_prototype_bias=True)
    model = build_evaluator("resnet18", mlc_proj_dim=32, sa_dim_ff=16)
    model.load_state_dict(port.model.state_dict(), strict=True)
    return (JaxPredictor(jm, ref.variables, mean=MEAN, std=STD, **KW),
            Predictor(model, MEAN, STD, **KW))


@pytest.fixture(scope="module")
def predictor(pair):
    return pair[1]


def _imgs(n, seed=0, low=40, high=80):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (rng.integers(low, high),
                                  rng.integers(low, high), 3), dtype=np.uint8)
            for _ in range(n)]


def _mixed(seed):
    """Images that fit the canvas, some larger than it, some smaller than
    twice the crop."""
    return (_imgs(2, seed) + _imgs(2, seed + 1, 130, 200)
            + _imgs(2, seed + 2, 30, 50))


@pytest.mark.parametrize("n", [1, 3, 4, 6])
def test_probabilities_match_the_jax_predictor(pair, n):
    ref, port = pair
    derm, clinic = _mixed(10)[:n], _mixed(20)[:n]
    want = ref.predict(derm, clinic)
    got = port.predict(derm, clinic)
    assert len(got) == len(want) == 8
    for g, w, c in zip(got, want, NUM_CLASSES):
        assert g.shape == (n, c) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **MODEL)
        np.testing.assert_allclose(g.sum(axis=-1), 1.0, rtol=1e-5)


def test_build_evaluator_runs_bf16_where_the_jax_package_does():
    """`build_evaluator()` runs the encoders in bf16 and the head in
    float32 by default, as `sm3x.api.build_evaluator()` (dtype bfloat16,
    the head float32) does; `amp=False` is the JAX package's
    `dtype=jnp.float32`."""
    import inspect

    from sm3x import api as jax_api

    assert jax_api.build_evaluator().dtype == jnp.bfloat16
    assert inspect.signature(build_evaluator).parameters["amp"].default
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    for amp, want in ((None, torch.bfloat16), (False, torch.float32)):
        kw = {} if amp is None else {"amp": amp}
        model = build_evaluator("resnet18", mlc_proj_dim=32, sa_dim_ff=16,
                                **kw).eval()
        conv = next(m for m in model.extractor.modules()
                    if isinstance(m, torch.nn.Conv2d))
        seen = []
        conv.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
        with torch.no_grad():
            feats, preds = model(x, x)
        assert seen == [want]
        assert feats.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in preds)


# bf16 serving against float32 (the float32 pair's JAX Predictor), relative
# L2 error of the 12 cases' packed probabilities, with the values measured
# when the bounds were set: the port's error is BF16_RATIO times the JAX
# package's (measured 2.31e-4 against 1.91e-4: 1.21x); the port against the
# JAX package's bf16 within BF16_PORT_TO_JAX (measured 2.62e-4). A port in
# float32 reads ~0x: below 0.5x its encoders ran in another precision.
BF16_RATIO = (0.5, 1.5)
BF16_PORT_TO_JAX = 1e-3


def test_bf16_probabilities_against_the_jax_package_s(pair, bf16_pair):
    """Both packages' default bf16 Predictors on the same weights and raw
    images, each held against the float32 run by the ratio of their
    errors, and to each other."""
    ref32 = pair[0]
    jax16, port16 = bf16_pair
    requests = [(_mixed(30 + k)[:4], _mixed(40 + k)[:4]) for k in range(3)]

    def packed(p):
        return np.concatenate([np.concatenate(p.predict(d, c), -1)
                               for d, c in requests]).astype(np.float64)

    truth, jax_bf16, port_bf16 = packed(ref32), packed(jax16), packed(port16)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    e_jax, e_port = rel(jax_bf16, truth), rel(port_bf16, truth)
    assert BF16_RATIO[0] * e_jax <= e_port <= BF16_RATIO[1] * e_jax
    assert rel(port_bf16, jax_bf16) <= BF16_PORT_TO_JAX
    np.testing.assert_allclose(port_bf16.reshape(12, -1)[:, :5].sum(-1), 1.0,
                               rtol=1e-5)


def test_canvases_match_the_jax_predictor(pair):
    ref, port = pair
    imgs = _mixed(3)
    (rc, rhw), (pc, phw) = ref._canvases(imgs), port._canvases(imgs)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(phw, rhw)


@pytest.mark.parametrize("n,want", [(1, 1), (2, 4), (4, 4), (5, 4), (9, 4)])
def test_bucket_choice(pair, n, want):
    ref, port = pair
    assert port._bucket(n) == ref._bucket(n) == want


def test_padding_does_not_change_results(predictor):
    d, c = _imgs(2, 2), _imgs(2, 3)
    out2 = predictor.predict(d, c)                     # bucket 4, padded
    out1 = [predictor.predict([d[i]], [c[i]]) for i in range(2)]
    for h in range(8):
        for i in range(2):
            np.testing.assert_allclose(out2[h][i], out1[i][h][0], **MODEL)


def test_padding_repeats_the_last_case(predictor):
    seen = {}
    call = predictor._call

    def spy(b, derm, derm_hw, clinic, clinic_hw):
        seen.update(b=b, derm=derm, hw=derm_hw)
        return call(b, derm, derm_hw, clinic, clinic_hw)

    predictor._call = spy
    try:
        predictor.predict(_imgs(2, 4), _imgs(2, 5))
    finally:
        del predictor._call
    assert seen["b"] == 4 and seen["derm"].shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(seen["derm"][2], seen["derm"][1])
    np.testing.assert_array_equal(seen["hw"][3], seen["hw"][1])


def test_oversize_requests_are_chunked_before_any_canvas_work(predictor):
    sizes = []
    canvases = predictor._canvases

    def spy(images):
        sizes.append(len(images))
        return canvases(images)

    predictor._canvases = spy
    try:
        d, c = _imgs(7, 4), _imgs(7, 5)
        out = predictor.predict(d, c)
    finally:
        del predictor._canvases
    assert sizes == [4, 4, 3, 3]  # derm and clinic of each chunk
    assert out[0].shape == (7, 5)
    parts = [predictor.predict(d[s:s + 4], c[s:s + 4]) for s in (0, 4)]
    for h in range(8):
        np.testing.assert_array_equal(
            out[h], np.concatenate([parts[0][h], parts[1][h]]))


def test_empty_request_returns_empty(predictor):
    out = predictor.predict([], [])
    assert [p.shape for p in out] == [(0, c) for c in NUM_CLASSES]


def test_serving_applies_the_training_border_crop(predictor):
    img = np.zeros((120, 100, 3), np.uint8)
    _, hw = predictor._canvases([img])
    # cropped to 70x50, letterboxed into the 64-canvas
    assert tuple(hw[0]) == (64, round(50 * 64 / 70))
    tiny = np.zeros((40, 40, 3), np.uint8)   # no interior left: not cropped
    _, hw = predictor._canvases([tiny])
    assert tuple(hw[0]) == (40, 40)
    assert crop_border(tiny, 25) is tiny
    assert crop_border(img, 25).shape == (70, 50, 3)
    p0 = Predictor(predictor.model, MEAN, STD, test_sz=48, buckets=(1,),
                   canvas=64, crop_amount=0)
    _, hw = p0._canvases([img])
    assert tuple(hw[0]) == (64, round(100 * 64 / 120))


def test_defaults_are_the_reference_s():
    import inspect

    sig = inspect.signature(Predictor.__init__).parameters
    assert sig["buckets"].default == (1, 8, 32, 128)
    assert (sig["canvas"].default, sig["crop_amount"].default,
            sig["test_sz"].default) == (320, 25, 224)
    assert BucketedPredictor.num_classes == tuple(NUM_CLASSES)


def test_from_checkpoint_pth(tmp_path, predictor):
    """`from_checkpoint` reads an eval stage's `best_eval.pth` wrapper
    through the port's api and serves the same numbers."""
    path = os.path.join(tmp_path, "best_eval.pth")
    torch.save({"epoch": 3, "state_dict": predictor.model.state_dict(),
                "best_val_auc": 0.5}, path)
    p = Predictor.from_checkpoint(
        path, arch="resnet18", mean=MEAN, std=STD, mlc_proj_dim=32,
        sa_dim_ff=16, device="cpu", test_sz=48, buckets=(1, 2), canvas=64)
    # the JAX package's default: the encoders in bf16
    assert p.model.extractor.amp
    bf16 = build_evaluator("resnet18", mlc_proj_dim=32, sa_dim_ff=16)
    bf16.load_state_dict(predictor.model.state_dict(), strict=True)
    d, c = _imgs(2, 11), _imgs(2, 12)
    got = p.predict(d, c)
    want = Predictor(bf16, MEAN, STD, **KW).predict(d, c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MODEL)


def _b64(img: np.ndarray, fmt: str) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def _post(base, cases, timeout=120):
    req = urllib.request.Request(
        f"{base}/predict", data=json.dumps({"cases": cases}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)["predictions"]


def _status(url, data=None):
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_decode_image(fmt):
    img = _imgs(1, 3)[0]
    got = _decode_image(_b64(img, fmt))
    assert got.shape == img.shape and got.dtype == np.uint8
    if fmt == "PNG":
        np.testing.assert_array_equal(got, img)


def test_http_server_roundtrip(predictor):
    server = PredictionServer(predictor, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"status": "ok", "labels": 8}
        with urllib.request.urlopen(f"{base}/labels", timeout=30) as r:
            labels = json.load(r)
        assert labels == {"labels": list(CLASSES_NAME),
                          "num_classes": list(NUM_CLASSES)}
        imgs = _imgs(2, 7)
        preds = _post(base, [
            {"derm": _b64(imgs[0], "PNG"), "clinic": _b64(imgs[1], "PNG")},
            {"derm": _b64(imgs[1], "JPEG"), "clinic": _b64(imgs[0], "JPEG")}])
        assert len(preds) == 2
        for case in preds:
            assert set(case) == set(CLASSES_NAME)
            for probs in case.values():
                np.testing.assert_allclose(sum(probs), 1.0, rtol=1e-3)
        # PNG is lossless: the first case is the direct call's, to the digit
        direct = predictor.predict([imgs[0]], [imgs[1]])
        for h, name in enumerate(CLASSES_NAME):
            np.testing.assert_allclose(preds[0][name], direct[h][0], **MODEL)
    finally:
        server.stop()


def test_http_errors_400_404_413(predictor):
    server = PredictionServer(predictor, host="127.0.0.1", port=0,
                              max_body_mb=0.001).start()   # 1 KiB cap
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _status(f"{base}/predict",
                       b'{"cases": [{"derm": "!!"}]}') == 400
        assert _status(f"{base}/predict", b"not json") == 400
        assert _status(f"{base}/nowhere") == 404
        assert _status(f"{base}/nowhere", b"{}") == 404
        big = json.dumps({"cases": [{"derm": "x" * 4096,
                                     "clinic": "x" * 4096}]}).encode()
        assert _status(f"{base}/predict", big) == 413
    finally:
        server.stop()


def test_http_server_concurrent_requests_without_batching(predictor):
    """16 parallel requests on the --no-batching path serialize behind the
    dispatch lock and all get the same answer."""
    server = PredictionServer(predictor, host="127.0.0.1", port=0,
                              batching=False).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        imgs = _imgs(2, 21)
        cases = [{"derm": _b64(imgs[0], "PNG"),
                  "clinic": _b64(imgs[1], "PNG")}]
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            results = list(ex.map(lambda _: _post(base, cases), range(16)))
        assert len(results) == 16
        for r in results[1:]:
            np.testing.assert_allclose(r[0]["DIAG"], results[0][0]["DIAG"],
                                       rtol=1e-5)
    finally:
        server.stop()


def test_http_batching_coalesces_distinct_requests(predictor):
    """Concurrent requests with different images each get their own rows
    of the coalesced batch, equal to a direct call, in fewer dispatches
    than requests."""
    calls = []
    predict = predictor.predict

    def counting(derm, clinic):
        calls.append(len(derm))
        return predict(derm, clinic)

    predictor.predict = counting
    server = PredictionServer(predictor, host="127.0.0.1", port=0,
                              batching=True, max_batch=8,
                              max_wait_ms=300).start()
    base = f"http://127.0.0.1:{server.port}"
    derms, clinics = _imgs(4, 31), _imgs(4, 32)
    try:
        def one(i):
            return _post(base, [{"derm": _b64(derms[i], "PNG"),
                                 "clinic": _b64(clinics[i], "PNG")}])[0]

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            results = list(ex.map(one, range(4)))
    finally:
        server.stop()
        del predictor.predict
    assert sum(calls) == 4 and len(calls) < 4
    direct = predictor.predict(derms, clinics)
    for i, case in enumerate(results):
        for h, name in enumerate(CLASSES_NAME):
            np.testing.assert_allclose(case[name], direct[h][i], **MODEL)
    assert not np.allclose(results[0]["DIAG"], results[1]["DIAG"], atol=1e-6)


def test_batcher_stop_fails_pending_requests():
    """Requests that race `_Batcher.stop()`'s sentinel are failed with an
    error instead of blocking their handler threads forever; requests after
    the stop are refused at once."""

    class SlowPredictor:
        def predict(self, derm, clinic):
            time.sleep(0.3)
            return [np.zeros((len(derm), 5), np.float32)] * 8

    b = _Batcher(SlowPredictor(), max_batch=1, max_wait_ms=1.0)
    errors: "queue.Queue" = queue.Queue()
    img = [np.zeros((8, 8, 3), np.uint8)]

    def blocked_request():
        try:
            b.predict(img, img)
            errors.put(None)
        except RuntimeError as e:
            errors.put(str(e))

    t1 = threading.Thread(target=blocked_request)
    t1.start()
    time.sleep(0.1)  # let the first dispatch start
    done = threading.Event()
    slot: dict = {}
    b.q.put((img, img, done, slot))
    b._stopped = True
    b.q.put(b._SENTINEL)
    t1.join(timeout=10)
    b._thread.join(timeout=10)
    b._fail_pending("server stopped")
    assert done.wait(timeout=5), "pending request was never released"
    assert ("probs" in slot) or ("error" in slot)
    with pytest.raises(RuntimeError, match="server stopping"):
        b.predict(img, img)


def test_batcher_stop_returns_with_no_caller_waiting():
    class SlowPredictor:
        def predict(self, derm, clinic):
            time.sleep(0.2)
            return [np.zeros((len(derm), c), np.float32)
                    for c in NUM_CLASSES]

    b = _Batcher(SlowPredictor(), max_batch=1, max_wait_ms=1.0)
    img = [np.zeros((8, 8, 3), np.uint8)]
    outcomes: "queue.Queue" = queue.Queue()

    def call():
        try:
            outcomes.put(b.predict(img, img)[0].shape)
        except RuntimeError as e:
            outcomes.put(str(e))

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    b.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    got = [outcomes.get_nowait() for _ in range(4)]
    assert all(g == (1, 5) or "batched dispatch failed" in g for g in got)
    assert (1, 5) in got  # the dispatch in flight was finished


def test_failing_predictor_gives_each_caller_its_own_exception():
    class Failing:
        def predict(self, derm, clinic):
            raise ValueError("boom")

    b = _Batcher(Failing(), max_batch=8, max_wait_ms=200)
    img = [np.zeros((8, 8, 3), np.uint8)]
    caught = []

    def call():
        try:
            b.predict(img, img)
        except RuntimeError as e:
            caught.append(e)

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    b.stop()
    assert len(caught) == 3 and len({id(e) for e in caught}) == 3
    assert all("ValueError: boom" in str(e) for e in caught)


def test_main_parser_has_device_and_no_exported_path(tmp_path, predictor,
                                                     monkeypatch, capsys):
    """`main` warms every bucket before the socket opens, defaults
    --max-batch to the largest bucket and passes --device on; the JAX
    package's --exported-path is not offered."""
    import sm3x_torch.serve_http as http

    path = os.path.join(tmp_path, "best_eval.pth")
    torch.save({"state_dict": predictor.model.state_dict()}, path)
    made = {}

    class Server:
        def __init__(self, predictor, host, port, **kw):
            made.update(kw, predictor=predictor, port=port)
            self.port = port

        def serve_forever(self):
            made["order"] = capsys.readouterr().out

    monkeypatch.setattr(http, "PredictionServer", Server)
    real = Predictor.from_checkpoint.__func__

    def small(cls, path, **kw):
        made["device"] = kw["device"]
        return real(cls, path, mlc_proj_dim=32, sa_dim_ff=16, canvas=64,
                    **kw)

    monkeypatch.setattr(Predictor, "from_checkpoint", classmethod(small))
    http.main(["--pretrain-path", path, "-a", "resnet18", "--device", "cpu",
               "--test-sz", "48", "--buckets", "1", "2", "--port", "0"])
    assert made["device"] == "cpu" and made["max_batch"] == 2
    assert made["batching"] is True
    assert made["order"].split("\n")[:3] == [
        "warmed bucket 1", "warmed bucket 2", "serving on 127.0.0.1:0"]
    with pytest.raises(SystemExit):
        http.main(["--exported-path", "x"])
