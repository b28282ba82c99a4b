"""The PyTorch port stands alone: importing `sm3x_torch`, every module in
it, `chip_smoke.py`, `bench_torch.py`, `inference_torch.py` and the
`tools/*_torch.py` scripts loads nothing of the JAX package (`sm3x`,
`sm3x.*`) and none of `jax`, `flax`, `optax`. The port never calls PyTorch's
fused attention either: that call is only the yardstick that
`chip_smoke.py` times beside K3.

The probe runs in a fresh interpreter, because this test process has
imported jax already (tests/conftest.py)."""

import glob
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import glob, importlib, importlib.util, json, os, pkgutil, sys
    import sm3x_torch
    mods = ["sm3x_torch"] + [m.name for m in pkgutil.walk_packages(
        sm3x_torch.__path__, "sm3x_torch.")]
    mods += ["chip_smoke", "bench_torch", "inference_torch"]
    for m in mods:
        importlib.import_module(m)
    for path in sorted(glob.glob(os.path.join("tools", "*_torch.py"))
                       + glob.glob(os.path.join("tools", "misc",
                                                "*_torch.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        mods.append(os.path.relpath(os.path.splitext(path)[0]))
    banned = ("sm3x", "jax", "flax", "optax")
    print(json.dumps({"modules": mods, "loaded": sorted(
        k for k in sys.modules
        if k in banned or k.startswith(tuple(b + "." for b in banned)))}))
""")


def _probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_and_reused_modules_load_no_jax():
    res = _probe()
    # the slices' modules and scripts are all there to be checked
    for m in ("sm3x_torch.core.config", "sm3x_torch.core.prng",
              "sm3x_torch.utils.weights", "sm3x_torch.models.resnet",
              "sm3x_torch.models.simclr", "sm3x_torch.ops.ntxent_cuda",
              "sm3x_torch.ops.augment_cuda", "sm3x_torch.losses.ssl",
              "sm3x_torch.train.backbone_train", "sm3x_torch.cli.apps",
              "sm3x_torch.models.vit", "sm3x_torch.ops.attention",
              "sm3x_torch.ops.attention_cuda", "sm3x_torch.ops.copy_cuda",
              "sm3x_torch.data.derm7pt", "sm3x_torch.data.pipeline",
              "sm3x_torch.data.datasets", "chip_smoke",
              "tools/backbone_train_torch", "tools/bench_copy_torch",
              "sm3x_torch.models.transformer", "sm3x_torch.models.mlc",
              "sm3x_torch.models.projector", "sm3x_torch.ops.kmeans",
              "sm3x_torch.losses", "sm3x_torch.train.mlc_train",
              "sm3x_torch.train.common", "sm3x_torch.utils.timing",
              "bench_torch", "tools/mlc_train_torch",
              "tools/k2b_variants_torch", "sm3x_torch.metrics",
              "sm3x_torch.models.baseline", "sm3x_torch.models.evaluator",
              "sm3x_torch.utils.checkpoint", "sm3x_torch.utils.logging",
              "sm3x_torch.train.supervised", "sm3x_torch.train.mlc_eval",
              "sm3x_torch.train.backbone_eval",
              "sm3x_torch.train.linear_probe", "sm3x_torch.api",
              "sm3x_torch.reproduce", "inference_torch",
              "tools/mlc_eval_torch", "tools/backbone_eval_torch",
              "tools/reproduce_results_torch", "sm3x_torch.serve",
              "sm3x_torch.serve_http", "sm3x_torch.data.prefetch",
              "sm3x_torch.data.device_data", "sm3x_torch.data.streaming",
              "sm3x_torch.native.loader", "sm3x_torch.utils.weight_registry",
              "sm3x_torch.parallel", "sm3x_torch.parallel.collectives",
              "sm3x_torch.parallel.launch", "sm3x_torch.parallel.tensor",
              "sm3x_torch.core.mesh",
              "sm3x_torch.data.multihost", "tools/dryrun_multigpu_torch",
              "sm3x_torch.models.trimodal", "sm3x_torch.models.layers",
              "sm3x_torch.train.transfer_probe",
              "tools/transfer_probe_torch", "sm3x_torch.data.synthetic",
              "sm3x_torch.cli", "sm3x_torch.core", "sm3x_torch.data",
              "sm3x_torch.models", "sm3x_torch.native", "sm3x_torch.ops",
              "sm3x_torch.train", "sm3x_torch.utils",
              "tools/demo_synthetic_e2e_torch", "tools/misc/cal_mean_std_torch",
              "tools/bench_serve_soak_torch", "tools/recipe_synthetic_torch",
              "tools/bench_prefetch_torch"):
        assert m in res["modules"]
    assert res["loaded"] == [], (
        f"modules of the JAX package or of JAX loaded: {res['loaded']}")


def test_port_sources_name_no_module_of_the_jax_package():
    """No import statement of the port, its smoke script or its tools
    names `sm3x` or a module under it."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+sm3x(\.|\s|$)", re.M)
    files = (glob.glob(os.path.join(ROOT, "sm3x_torch", "**", "*.py"),
                       recursive=True)
             + glob.glob(os.path.join(ROOT, "tools", "*_torch.py"))
             + glob.glob(os.path.join(ROOT, "tools", "misc", "*_torch.py"))
             + [os.path.join(ROOT, "chip_smoke.py"),
                os.path.join(ROOT, "bench_torch.py"),
                os.path.join(ROOT, "inference_torch.py")])
    assert len(files) > 45
    bad = [f for f in files if pat.search(open(f).read())]
    assert bad == []


def test_metrics_need_numpy_alone():
    """`sm3x_torch.metrics` imports neither scipy nor torch: the machine
    that serves or evaluates may have numpy only."""
    probe = ("import sys, importlib.util as u; "
             "spec = u.spec_from_file_location('m', "
             "'sm3x_torch/metrics/__init__.py'); m = u.module_from_spec(spec); "
             "sys.modules['sm3x_torch'] = type(sys)('sm3x_torch'); "
             "sys.modules['sm3x_torch'].__dict__.update("
             "CLASSES_NAME=['a'], CLS_WEIGHTS=[1], METRICS_NAME=['AUC'], "
             "NUM_CLASSES=[2]); spec.loader.exec_module(m); "
             "import numpy as np; "
             "print(m.binary_auroc_from_scores(np.array([.1, .4, .4, .8]), "
             "np.array([False, False, True, True]))); "
             "print(sorted(k for k in sys.modules "
             "if k.split('.')[0] in ('scipy', 'torch')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["0.875", "[]"]


def test_serving_arrays_needs_no_image_decoder():
    """Importing the server and predicting from numpy images that fit the
    canvas loads neither OpenCV nor PIL: the serving machine may have
    neither."""
    probe = ("import sys, numpy as np; "
             "import sm3x_torch.serve_http; "
             "from sm3x_torch.serve import BucketedPredictor; "
             "p = BucketedPredictor(); p.buckets, p.canvas = [4], 64; "
             "p._call = lambda b, d, dh, c, ch: "
             "[np.zeros((b, k), np.float32) for k in p.num_classes]; "
             "img = [np.zeros((60, 64, 3), np.uint8)] * 3; "
             "print(len(p.predict(img, img)), p.predict(img, img)[0].shape); "
             "print(sorted(k for k in sys.modules "
             "if k.split('.')[0] in ('cv2', 'PIL', 'sm3x', 'jax')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == ["8 (3, 5)", "[]"]


def test_packaging_names_the_port_s_server_and_loader():
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    assert 'sm3x-torch-serve = "sm3x_torch.serve_http:main"' in text
    assert '"sm3x_torch.native" = ["loader.cpp"]' in text
    a = open(os.path.join(ROOT, "sm3x", "native", "loader.cpp"), "rb").read()
    b = open(os.path.join(ROOT, "sm3x_torch", "native", "loader.cpp"),
             "rb").read()
    assert a == b


def test_run_torch_sh_names_the_port_s_tools():
    text = open(os.path.join(ROOT, "run_torch.sh")).read()
    res = subprocess.run(["bash", "-n", os.path.join(ROOT, "run_torch.sh")],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    tools = set(__import__("re").findall(r"tools/(\w+)\.py", text))
    assert tools == {"backbone_train_torch", "backbone_eval_torch",
                     "mlc_train_torch", "mlc_eval_torch"}
    assert ".msgpack" not in text and "ckp_399.pth" in text
    for t in tools:
        assert os.path.exists(os.path.join(ROOT, "tools", t + ".py"))


def test_port_never_calls_the_library_attention():
    files = [f for f in glob.glob(os.path.join(ROOT, "sm3x_torch", "**", "*"),
                                  recursive=True)
             if os.path.isfile(f) and not f.endswith((".pyc", ".so"))]
    assert any(f.endswith("attention.py") for f in files)
    bad = [f for f in files
           if "scaled_dot_product_attention" in open(f, errors="ignore").read()]
    assert bad == []
