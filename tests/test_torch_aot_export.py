"""The port's AOT serving artifact (sm3x_torch.export, serve_http
--exported-path) and its profiling hooks (sm3x_torch.utils.profiling)
against the JAX package's (sm3x.export, sm3x.utils.profiling), on the CPU,
where the loaded programs run eagerly (a CUDA graph a bucket is the card's
path; tests/test_torch_kernels_cuda.py and chip_smoke.py [export] hold it).

ResNet-18 at 48 x 48, proj_dim 32, canvas 64, buckets (1, 4). Weights are
initialised in JAX, moved off Flax's ones and zeros, exported with
`sm3x.utils.torch_export.export_mlc_model` and loaded strictly, as in
tests/test_torch_serve.py. Bounds: the artifact against the port's live
`Predictor` rtol 1e-5 / atol 1e-6 (tests/isolated/test_export.py:53);
against the JAX package's `ExportedPredictor` in float32 rtol 1e-4 / atol
1e-5 (the two ResNet-18 encoders' tolerance at this size) and in bf16 a
relative L2 error within 1e-3 (`BF16_PORT_TO_JAX`, tests/test_torch_serve.py).
"""

import base64
import io
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.export import ExportedPredictor as JaxExportedPredictor
from sm3x.export import export_predictor as jax_export_predictor
from sm3x.models.mlc import MLCModel as JaxMLCModel
from sm3x.utils import profiling as jax_profiling
from sm3x.utils import torch_export
from sm3x_torch import CLASSES_NAME, NUM_CLASSES
from sm3x_torch.api import build_evaluator
from sm3x_torch.export import ExportedPredictor, export_predictor
from sm3x_torch.serve import Predictor
from sm3x_torch.serve_http import PredictionServer
from sm3x_torch.utils import profiling, weights

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
BF16_PORT_TO_JAX = 1e-3
MEAN, STD = (0.5,) * 3, (0.25,) * 3
SIZES = dict(image_size=48, mean=MEAN, std=STD, canvas=64)
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
def root(tmp_path_factory):
    """The module's artifacts (~175 MB each): removed after its last test."""
    path = tmp_path_factory.mktemp("aot")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def shared():
    """The JAX variables and the port's state dict of the same weights."""
    rng = np.random.default_rng(5)
    jm = JaxMLCModel(arch="resnet18", proj_dim=32, sa_dim_ff=16,
                     use_prototype_bias=True, dtype=jnp.float32)
    d = jnp.zeros((1, 48, 48, 3), jnp.float32)
    v = jax.jit(lambda r: jm.init({"params": r, "dropout": r}, d, d))(
        jax.random.key(0))
    v = {"params": _randomise(jax.tree.map(np.asarray, v["params"]), rng),
         "batch_stats": _randomise(jax.tree.map(np.asarray,
                                                v["batch_stats"]), rng)}
    sd = torch_export.export_mlc_model(v["params"], v["batch_stats"],
                                       "resnet18", "v4")
    return v, weights.to_tensors(sd)


def _port_model(state, amp):
    model = build_evaluator("resnet18", mlc_proj_dim=32, sa_dim_ff=16,
                            amp=amp)
    model.load_state_dict(state, strict=True)
    return model.eval()


def _export(state, amp, path):
    model = _port_model(state, amp)
    manifest = export_predictor(model, path, buckets=(1, 4), **SIZES)
    assert manifest["buckets"] == [1, 4]
    return model, path


@pytest.fixture(scope="module")
def art32(shared, root):
    """The float32 (`amp=False`) model and its artifact."""
    return _export(shared[1], False, str(root / "port_float32"))


@pytest.fixture(scope="module")
def art16(shared, root):
    """The model at the default bf16 and its artifact."""
    return _export(shared[1], True, str(root / "port_bf16"))


@pytest.fixture(scope="module", params=["float32", "bf16"])
def exported(request, shared, root):
    """(tag, the port's model, its artifact, the artifact loaded, the JAX
    package's artifact) in float32 (`amp=False`, `dtype=jnp.float32`) and
    at both packages' default bf16."""
    tag = request.param
    model, path = request.getfixturevalue(
        "art32" if tag == "float32" else "art16")
    jm = JaxMLCModel(arch="resnet18", proj_dim=32, sa_dim_ff=16,
                     use_prototype_bias=True,
                     dtype=jnp.float32 if tag == "float32" else jnp.bfloat16)
    jax_path = str(root / f"jax_{tag}")
    jax_export_predictor(jm, shared[0], jax_path, buckets=(1, 4), **SIZES)
    return (tag, model, path, ExportedPredictor(path, device="cpu"),
            jax_path)


@pytest.fixture(scope="module")
def loaded32(art32):
    return ExportedPredictor(art32[1], device="cpu")


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


def _packed(outs):
    return np.concatenate(outs, axis=-1).astype(np.float64)


def test_the_artifact_holds_a_program_a_bucket_and_the_jax_manifest(
        exported):
    tag, _, path, _, jax_path = exported
    with open(os.path.join(jax_path, "manifest.json")) as f:
        jax_manifest = json.load(f)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == set(jax_manifest)
    for key in ("buckets", "image_size", "canvas", "crop_amount", "mean",
                "std", "num_classes", "platforms"):
        assert manifest[key] == jax_manifest[key], key
    assert sorted(os.listdir(path)) == ["fwd_b1_cpu.pt2", "fwd_b4_cpu.pt2",
                                        "manifest.json"]
    program = torch.export.load(os.path.join(path, "fwd_b4_cpu.pt2"))
    inputs = [n.meta["val"] for n in program.graph.nodes
              if n.op == "placeholder"][-4:]
    assert [(tuple(t.shape), t.dtype) for t in inputs] == [
        ((4, 64, 64, 3), torch.uint8), ((4, 2), torch.int32)] * 2
    code = program.graph_module.code
    # lowered to ATen: the encoders' autocast is explicit casts in bf16
    assert "wrap_with_autocast" not in code and "autocast" not in code
    casts = [n for n in program.graph.nodes
             if n.target == torch.ops.aten._to_copy.default
             and n.kwargs.get("dtype") == torch.bfloat16]
    assert (len(casts) > 0) == (tag == "bf16")


@pytest.mark.parametrize("n", [1, 3, 4])
def test_the_artifact_matches_the_live_predictor(exported, n):
    _, model, _, got, _ = exported
    live = Predictor(model, MEAN, STD, **KW)
    d, c = _mixed(10)[:n], _mixed(20)[:n]
    a, b = got.predict(d, c), live.predict(d, c)
    assert [p.shape for p in a] == [(n, k) for k in NUM_CLASSES]
    assert all(p.dtype == np.float32 for p in a)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **LIVE)


def test_the_artifact_matches_the_jax_package_s(exported):
    """Both packages' artifacts on the same weights and raw images: float32
    case by case, bf16 by the relative L2 error of 12 cases."""
    tag, _, _, port, jax_path = exported
    ref = JaxExportedPredictor(jax_path)
    requests = [(_mixed(30 + k)[:4], _mixed(40 + k)[:4]) for k in range(3)]
    got = np.concatenate([_packed(port.predict(d, c)) for d, c in requests])
    want = np.concatenate([_packed(ref.predict(d, c)) for d, c in requests])
    if tag == "float32":
        np.testing.assert_allclose(got, want, **MODEL)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_PORT_TO_JAX
    np.testing.assert_allclose(got[:, :5].sum(-1), 1.0, rtol=1e-5)


def test_the_artifact_chunks_pads_and_answers_an_empty_request(loaded32):
    exported = loaded32
    d, c = _imgs(6, 3), _imgs(6, 4)
    out = exported.predict(d, c)                        # chunked through b=4
    assert [p.shape for p in out] == [(6, k) for k in NUM_CLASSES]
    for p in out:
        np.testing.assert_allclose(p.sum(axis=-1), 1.0, rtol=1e-5)
    parts = [exported.predict(d[s:s + 4], c[s:s + 4]) for s in (0, 4)]
    for h in range(8):
        np.testing.assert_array_equal(
            out[h], np.concatenate([parts[0][h], parts[1][h]]))
    # a padded request (bucket 4) against the case alone (bucket 1)
    three, alone = exported.predict(d[:3], c[:3]), exported.predict(d[1:2],
                                                                    c[1:2])
    for h in range(8):
        np.testing.assert_allclose(three[h][1:2], alone[h], **MODEL)
    empty = exported.predict([], [])
    assert [p.shape for p in empty] == [(0, k) for k in NUM_CLASSES]


def _b64(img: np.ndarray, fmt: str) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def test_the_http_server_serves_the_artifact(loaded32):
    exported = loaded32
    server = PredictionServer(exported, host="127.0.0.1", port=0).start()
    try:
        imgs = _imgs(2, 7)
        body = json.dumps({"cases": [
            {"derm": _b64(imgs[0], "PNG"), "clinic": _b64(imgs[1], "PNG")},
            {"derm": _b64(imgs[1], "PNG"), "clinic": _b64(imgs[0], "PNG")},
        ]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            preds = json.load(r)["predictions"]
    finally:
        server.stop()
    assert len(preds) == 2 and all(set(p) == set(CLASSES_NAME)
                                   for p in preds)
    # PNG is lossless: the direct call on the same two cases, to the digit
    direct = exported.predict([imgs[0], imgs[1]], [imgs[1], imgs[0]])
    for i in range(2):
        for h, name in enumerate(CLASSES_NAME):
            np.testing.assert_allclose(preds[i][name], direct[h][i], **LIVE)


def test_serve_http_main_takes_the_artifact_or_a_checkpoint(
        art32, monkeypatch, capsys):
    """--exported-path serves the artifact with the manifest's buckets,
    each warmed before the socket opens; --pretrain-path and
    --exported-path are one required choice, as in sm3x/serve_http.py."""
    import sm3x_torch.serve_http as http

    made = {}

    class Server:
        def __init__(self, predictor, host, port, **kw):
            made.update(kw, predictor=predictor)
            self.port = port

        def serve_forever(self):
            made["order"] = capsys.readouterr().out

    monkeypatch.setattr(http, "PredictionServer", Server)
    http.main(["--exported-path", art32[1], "--device", "cpu", "--buckets",
               "8", "--port", "0"])
    assert isinstance(made["predictor"], ExportedPredictor)
    assert made["predictor"].device.type == "cpu"
    assert made["max_batch"] == 4
    assert made["order"].split("\n")[:3] == [
        "warmed bucket 1", "warmed bucket 4", "serving on 127.0.0.1:0"]
    for argv in ([], ["--exported-path", art32[1], "--pretrain-path", "x"]):
        with pytest.raises(SystemExit):
            http.main(argv)


def test_loading_and_serving_import_no_model_code(art32, loaded32,
                                                 tmp_path):
    """In a fresh interpreter the artifact loads and serves with no model
    code, trainer, api, JAX package or JAX imported, and gives the
    answers of this process."""
    out = tmp_path / "probs.npy"
    script = f"""
import json, sys
import numpy as np
from sm3x_torch.export import ExportedPredictor

rng = np.random.default_rng(3)
imgs = [rng.integers(0, 256, (50 + 7 * i, 60, 3), dtype=np.uint8)
        for i in range(3)]
predictor = ExportedPredictor({art32[1]!r}, device="cpu")
probs = predictor.predict(imgs, imgs[::-1])
np.save({str(out)!r}, np.concatenate(probs, -1))
print(json.dumps(sorted(sys.modules)))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    modules = json.loads(res.stdout.strip().splitlines()[-1])
    for absent in ("sm3x_torch.models", "sm3x_torch.train", "sm3x_torch.api",
                   "sm3x", "jax"):
        assert not [m for m in modules
                    if m == absent or m.startswith(absent + ".")], absent
    assert "sm3x_torch.export" in modules
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (50 + 7 * i, 60, 3), dtype=np.uint8)
            for i in range(3)]
    here = loaded32.predict(imgs, imgs[::-1])
    np.testing.assert_allclose(np.load(out), np.concatenate(here, -1),
                               **LIVE)


def _copy_with_manifest(src: str, dst: str, edit) -> str:
    """`src`'s programs linked into `dst` under an edited manifest."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".pt2"):
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    edit(manifest)
    with open(os.path.join(dst, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return dst


def test_an_absent_crop_amount_defaults_to_25(art32, tmp_path):
    def old(m):  # one bucket, to load one program
        m.pop("crop_amount")
        m.update(buckets=[1])

    path = _copy_with_manifest(art32[1], str(tmp_path / "old"), old)
    assert ExportedPredictor(path, device="cpu").crop_amount == 25
    path = _copy_with_manifest(art32[1], str(tmp_path / "none"),
                               lambda m: m.update(crop_amount=0, buckets=[1]))
    assert ExportedPredictor(path, device="cpu").crop_amount == 0


def test_the_wrong_device_and_a_stablehlo_directory_are_refused(
        art32, exported, tmp_path):
    with pytest.raises(ValueError, match=r"\['cpu'\].*'cuda'"):
        ExportedPredictor(art32[1], device="cuda")
    # the JAX package's artifact (its manifest says cpu) holds no program
    with pytest.raises(FileNotFoundError, match="no torch.export artifact"):
        ExportedPredictor(exported[4], device="cpu")
    # a manifest that names a platform whose programs are missing
    path = _copy_with_manifest(art32[1], str(tmp_path / "both"),
                               lambda m: m.update(platforms=["cpu", "cuda"]))
    with pytest.raises(FileNotFoundError):
        ExportedPredictor(path, device="cuda")


def test_export_refuses_an_unknown_platform_and_no_bucket(shared, tmp_path):
    model = _port_model(shared[1], amp=False)
    with pytest.raises(ValueError, match="tpu"):
        export_predictor(model, str(tmp_path / "a"), platforms=("tpu",))
    with pytest.raises(ValueError, match="bucket"):
        export_predictor(model, str(tmp_path / "b"), buckets=())
    assert not os.listdir(tmp_path)


def test_main_exports_a_pth_that_serves_as_from_checkpoint(tmp_path, capsys):
    """The CLI on an eval stage's `best_eval.pth`: the default bf16
    evaluator, the manifest's values from the flags, the closing line;
    the artifact serves what `Predictor.from_checkpoint` serves."""
    from sm3x_torch.export import main

    torch.manual_seed(0)
    model = build_evaluator("resnet18", amp=False)
    pth = str(tmp_path / "best_eval.pth")
    torch.save({"epoch": 3, "state_dict": model.state_dict()}, pth)
    out = str(tmp_path / "artifact")
    main(["--pretrain-path", pth, "--out", out, "-a", "resnet18",
          "--test-sz", "48", "--canvas", "64", "--buckets", "2",
          "--crop-amount", "10", "--mean", *map(str, MEAN), "--std",
          *map(str, STD), "--platforms", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    assert line == (f"exported buckets [2] for platforms ['cpu'] -> {out} "
                    f"({size / 1e6:.1f} MB)")
    exported = ExportedPredictor(out, device="cpu")
    assert (exported.buckets, exported.canvas, exported.crop_amount) == (
        [2], 64, 10)
    live = Predictor.from_checkpoint(pth, arch="resnet18", mean=MEAN,
                                     std=STD, device="cpu", test_sz=48,
                                     buckets=(2,), canvas=64, crop_amount=10)
    assert live.model.extractor.amp
    d, c = _mixed(50)[:3], _mixed(60)[:3]
    for x, y in zip(exported.predict(d, c), live.predict(d, c)):
        np.testing.assert_allclose(x, y, **LIVE)


# --- profiling ---------------------------------------------------------------

def test_step_timer_summary_equals_the_jax_one(monkeypatch):
    ticks = [1.0, 1.5, 3.0, 3.25, 4.0, 4.5, 7.0]

    def run(cls):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls()
        for _ in range(3):
            timer.data_ready()
            timer.step_done()
        return timer.summary(), timer.count

    jax_summary, jax_count = run(jax_profiling.StepTimer)
    summary, count = run(profiling.StepTimer)
    assert (summary, count) == (jax_summary, jax_count)
    assert summary == {"data_time": (0.5 + 0.25 + 0.5) / 3,
                       "step_time": (1.5 + 0.75 + 2.5) / 3}
    monkeypatch.undo()
    assert profiling.StepTimer().summary() == {"data_time": 0.0,
                                               "step_time": 0.0}


def test_check_finite_prints_the_jax_counts(capsys):
    tree = {"b": [np.array([1.0, np.nan, np.inf], np.float32),
                  np.array([1, 2], np.int32)],
            "a": (np.full((2, 3), np.nan, np.float32),
                  np.ones(3, np.float32)),
            "c": {"d": np.array([-np.inf], np.float32)}}
    jax_profiling.check_finite(jax.tree.map(jnp.asarray, tree), name="w")
    jax.effects_barrier()
    jax_lines = capsys.readouterr().out.strip().splitlines()
    port_tree = jax.tree.map(torch.from_numpy, tree)
    assert profiling.check_finite(port_tree, name="w") is port_tree
    lines = capsys.readouterr().out.strip().splitlines()

    def counts(out):
        return [(line.split(" at ")[0], line.rsplit(": ", 1)[1])
                for line in out]

    assert counts(lines) == counts(jax_lines) == [
        ("NON-FINITE in w", "6 bad values"),
        ("NON-FINITE in w", "2 bad values"),
        ("NON-FINITE in w", "1 bad values")]
    assert [line.split(" at ")[1].split(":")[0] for line in lines] == [
        "['a'][0]", "['b'][0]", "['c']['d']"]
    profiling.check_finite({"ok": torch.ones(2)})
    assert capsys.readouterr().out == ""


def test_trace_writes_under_log_dir_with_the_annotated_region(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.annotate("sm3x_region"):
            torch.ones(8).sum()
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sm3x_region" for e in events)


def test_enable_nan_checks_turns_anomaly_detection_on_and_off():
    x = torch.tensor([-1.0], requires_grad=True)
    try:
        profiling.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()   # off: the NaN gradient passes
    assert torch.isnan(x.grad).all()


# the three cases of fault M1: (JAX function, port function, input, whether
# the checks raise); each port function returns the value the JAX one does
NAN_CASES = {
    "sqrt_forward": (jax.jit(lambda x: jnp.sqrt(x) * 2),
                     lambda x: torch.sqrt(x) * 2, [-1.0], True),
    "sqrt_gradient": (jax.grad(lambda x: jnp.sum(jnp.sqrt(x) * 0)),
                      lambda x: torch.autograd.grad(
                          (torch.sqrt(x) * 0).sum(), x)[0], [0.0], True),
    "divide_by_zero": (jax.jit(lambda x: x / 0), lambda x: x / 0, [1.0],
                       False),
}


@pytest.mark.parametrize("checks", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_nan_checks_raise_where_the_jax_package_s_do(case, checks):
    """Under each package's enable_nan_checks a NaN made in a forward pass
    or in a gradient raises FloatingPointError naming "nan"; an infinity
    passes; with the checks off each returns what the JAX function does."""
    jax_fn, port_fn, value, raises = NAN_CASES[case]
    x = torch.tensor(value, requires_grad=case == "sqrt_gradient")
    try:
        jax_profiling.enable_nan_checks(checks)
        profiling.enable_nan_checks(checks)
        if checks and raises:
            with pytest.raises(FloatingPointError, match="nan"):
                jax_fn(jnp.asarray(value))
            with pytest.raises(FloatingPointError, match="nan"):
                port_fn(x)
            return
        want = np.asarray(jax_fn(jnp.asarray(value)))
        got = port_fn(x).detach().numpy()
    finally:
        jax_profiling.enable_nan_checks(False)
        profiling.enable_nan_checks(False)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).all() == (raises and not checks)


def test_nan_checks_enter_their_mode_once():
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack as mode_stack)

    before = len(mode_stack())
    try:
        profiling.enable_nan_checks(True)
        profiling.enable_nan_checks(True)
        assert len(mode_stack()) == before + 1
    finally:
        profiling.enable_nan_checks(False)
    assert len(mode_stack()) == before and not torch.is_anomaly_enabled()
    profiling.enable_nan_checks(False)
    assert len(mode_stack()) == before
    assert torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all()


def test_nan_checks_skip_views_but_not_what_reads_them():
    """A view computes nothing, so a NaN that was there before the checks
    passes through one; the first operator that reads it raises."""
    x = torch.tensor([1.0, float("nan"), 2.0, 3.0])
    try:
        profiling.enable_nan_checks()
        y = x.view(2, 2)[:, 1:]
        with pytest.raises(FloatingPointError, match="aten.mul.Tensor"):
            y * 1
    finally:
        profiling.enable_nan_checks(False)
