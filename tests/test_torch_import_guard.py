"""The PyTorch port loads no JAX: importing `sm3x_torch`, every module in
it, `chip_smoke.py`, and the host-side modules of the JAX package that the
port reuses leaves `jax`, `flax` and `optax` out of `sys.modules`.

It runs in a fresh interpreter, because this test process has imported jax
already (tests/conftest.py)."""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import sm3x_torch
    mods = ["sm3x_torch"] + [m.name for m in pkgutil.walk_packages(
        sm3x_torch.__path__, "sm3x_torch.")]
    # host-side modules of the JAX package that the port imports
    mods += {reused}
    mods += ["chip_smoke"]
    for m in mods:
        importlib.import_module(m)
    print(json.dumps({{"modules": mods, "loaded": sorted(
        k for k in ("jax", "flax", "optax") if k in sys.modules)}}))
""")

REUSED = ["sm3x", "sm3x.data.derm7pt", "sm3x.data.pipeline",
          "sm3x.data.datasets", "sm3x.data.synthetic", "sm3x.native.loader",
          "sm3x.metrics"]


def _probe(reused):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(reused=reused)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_and_reused_modules_load_no_jax():
    res = _probe(REUSED)
    port = [m for m in res["modules"] if m.startswith("sm3x_torch")]
    # the slice's modules are all there to be checked
    for m in ("sm3x_torch.core.config", "sm3x_torch.core.prng",
              "sm3x_torch.utils.weights", "sm3x_torch.models.resnet",
              "sm3x_torch.models.simclr", "sm3x_torch.ops.ntxent_cuda",
              "sm3x_torch.ops.augment_cuda", "sm3x_torch.losses.ssl",
              "sm3x_torch.train.backbone_train", "sm3x_torch.cli.apps",
              "sm3x_torch.models.vit", "sm3x_torch.ops.attention",
              "sm3x_torch.ops.attention_cuda", "sm3x_torch.ops.copy_cuda"):
        assert m in port
    assert res["loaded"] == [], f"JAX-side packages loaded: {res['loaded']}"
