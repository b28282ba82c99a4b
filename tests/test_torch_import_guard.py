"""The PyTorch port stands alone: importing `sm3x_torch`, every module in
it, `chip_smoke.py` and the `tools/*_torch.py` scripts loads nothing of the
JAX package (`sm3x`, `sm3x.*`) and none of `jax`, `flax`, `optax`. The port
never calls PyTorch's fused attention either: that call is only the
yardstick that `chip_smoke.py` times beside K3.

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
    mods += ["chip_smoke"]
    for m in mods:
        importlib.import_module(m)
    for path in sorted(glob.glob(os.path.join("tools", "*_torch.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        mods.append("tools/" + name)
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
              "tools/backbone_train_torch", "tools/bench_copy_torch"):
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
             + [os.path.join(ROOT, "chip_smoke.py")])
    assert len(files) > 30
    bad = [f for f in files if pat.search(open(f).read())]
    assert bad == []


def test_port_never_calls_the_library_attention():
    files = [f for f in glob.glob(os.path.join(ROOT, "sm3x_torch", "**", "*"),
                                  recursive=True)
             if os.path.isfile(f) and not f.endswith((".pyc", ".so"))]
    assert any(f.endswith("attention.py") for f in files)
    bad = [f for f in files
           if "scaled_dot_product_attention" in open(f, errors="ignore").read()]
    assert bad == []
