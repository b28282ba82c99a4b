"""The port's public surface against the JAX package's, read with `ast`
and no import: every public top-level name of each `sm3x/**.py` (the
names an `__init__.py` re-exports included) is in the file's counterpart
under `sm3x_torch/`, or stands in NOT_PORTED with the reason, which is
the port's name for it or "Do not port" (ROADMAP.md). A file of `sm3x/`
has a counterpart at the same path, `*_pallas.py` at `*_cuda.py`, unless
it stands in FILES_NOT_PORTED. Then the port's console scripts, whose
targets must import, and `ntxent_loss_from_logits` against the JAX
function on the same logits."""

import ast
import glob
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DNP = "Do not port"
SHARDING = f"{DNP}: a JAX sharding helper; a process holds whole tensors"
PRNG = f"{DNP}: a jax.random key helper; torch.Generators take its place"

FILES_NOT_PORTED = {
    "sm3x/core/cache.py": f"{DNP}: the XLA compilation cache",
    "sm3x/core/precision.py": f"{DNP}: the bf16 policy; torch.autocast",
    "sm3x/export.py": f"{DNP}: StableHLO export",
    "sm3x/utils/profiling.py": f"{DNP}: xprof; torch.profiler in "
                               "chip_smoke.py --profile",
    "sm3x/utils/torch_convert.py": f"{DNP}: the port keeps .pth state dicts "
                                   "natively",
    "sm3x/utils/torch_export.py": f"{DNP}: the port keeps .pth state dicts "
                                  "natively",
}

NOT_PORTED = {
    "sm3x/cli/apps.py": {
        "load_encoder_tree": "sm3x_torch.utils.checkpoint.load_encoder_state",
        "load_extractor_tree": "sm3x_torch.utils.checkpoint."
                               "load_encoder_state",
        "load_pretrained_tree": "sm3x_torch.utils.checkpoint."
                                "load_pretrained_state",
    },
    "sm3x/core/__init__.py": {
        "Policy": f"{DNP}: the bf16 policy; torch.autocast",
        "DEFAULT_POLICY": f"{DNP}: the bf16 policy; torch.autocast",
        "FP32_POLICY": f"{DNP}: the bf16 policy; torch.autocast",
        "data_sharding": SHARDING,
        "replicated_sharding": SHARDING,
        "enable_compilation_cache": f"{DNP}: the XLA compilation cache",
        "step_rng": PRNG,
        "fold_in_axis": PRNG,
    },
    "sm3x/core/mesh.py": {
        "data_sharding": SHARDING,
        "replicate": SHARDING,
        "replicated_sharding": SHARDING,
        "shard_batch": SHARDING,
        "shard_label_heads": "sm3x_torch.parallel.tensor.shard_state_dict",
    },
    "sm3x/core/prng.py": {
        "DEFAULT_SEED": "sm3x_torch.core.config.RunConfig.seed's default",
        "root_key": PRNG,
        "step_rng": PRNG,
        "fold_in_axis": PRNG,
    },
    "sm3x/models/projector.py": {
        "torch_linear_init": "torch.nn.Linear's own initialisation",
    },
    "sm3x/models/resnet.py": {
        "ConvBN": "sm3x_torch.models.resnet's torchvision layout (a conv "
                  "and a BatchNorm of their own)",
        "ModuleDef": f"{DNP}: a Flax type alias",
    },
    "sm3x/ops/augment.py": {
        "get_ssl_augment_fn": "sm3x_torch.ops.augment.ssl_augment_batch, "
                              "which launches K1 on a CUDA tensor",
    },
    "sm3x/ops/augment_pallas.py": {
        "P_ORD1": "sm3x_torch.ops.augment_cuda.P_ORD0 + 1",
        "P_ORD2": "sm3x_torch.ops.augment_cuda.P_ORD0 + 2",
        "P_ORD3": "sm3x_torch.ops.augment_cuda.P_ORD0 + 3",
        "photometric_pallas": "sm3x_torch.ops.augment_cuda.photometric_cuda",
    },
    "sm3x/ops/ntxent_pallas.py": {
        "ntxent_loss_pallas": "sm3x_torch.ops.ntxent_cuda."
                              "ntxent_problems_loss",
        "ntxent_loss_fused": "sm3x_torch.ops.ntxent_cuda."
                             "ntxent_problems_loss",
    },
    "sm3x/parallel/__init__.py": {
        "data_sharding": SHARDING,
        "replicate": SHARDING,
        "replicated_sharding": SHARDING,
        "shard_batch": SHARDING,
    },
    "sm3x/train/__init__.py": {
        "TrainState": f"{DNP}: the Flax train state; the trainers own "
                      "torch modules and optimizers",
        "create_train_state": f"{DNP}: the Flax train state",
        "path_mask": f"{DNP}: an optax mask; sm3x_torch.train.common."
                     "trainable_parameters",
    },
    "sm3x/train/backbone_train.py": {
        "make_trimodal_train_step": "sm3x_torch.train.backbone_train."
                                    "make_ssl_train_step(trimodal=True)",
    },
    "sm3x/train/common.py": {
        "TrainState": f"{DNP}: the Flax train state",
        "create_train_state": f"{DNP}: the Flax train state",
        "path_mask": f"{DNP}: an optax mask; sm3x_torch.train.common."
                     "trainable_parameters",
        "ssl_trainable": "sm3x_torch.train.common.trainable_parameters "
                         "(stage 1 trains every parameter)",
        "warmup_cosine_schedule": "sm3x_torch.train.common."
                                  "warmup_cosine_factor",
    },
    "sm3x/utils/__init__.py": {
        "save_checkpoint": "sm3x_torch.train.common.write_checkpoint",
        "load_checkpoint": "sm3x_torch.utils.checkpoint.load_checkpoint_file",
        "restart_from_checkpoint": "sm3x_torch.train.common."
                                   "CheckpointableTrainer.resume",
    },
    "sm3x/utils/checkpoint.py": {
        "save_checkpoint": "sm3x_torch.train.common.write_checkpoint",
        "save_checkpoint_many": "sm3x_torch.train.common.write_checkpoint",
        "load_checkpoint": "sm3x_torch.utils.checkpoint.load_checkpoint_file",
        "restart_from_checkpoint": "sm3x_torch.train.common."
                                   "CheckpointableTrainer.resume",
        "restore_into": f"{DNP}: Flax state surgery; load_state_dict",
        "OrbaxManager": f"{DNP}: the Orbax backend; the port writes .pth",
        "load_torch_ssl_checkpoint": "sm3x_torch.utils.checkpoint."
                                     "load_encoder_state (.pth natively)",
        "load_torch_mlc_checkpoint": "sm3x_torch.utils.checkpoint."
                                     "load_pretrained_state (.pth natively)",
    },
}

SCRIPTS = {
    "sm3x-torch-backbone-train": "sm3x_torch.cli.apps:backbone_train_main",
    "sm3x-torch-mlc-train": "sm3x_torch.cli.apps:mlc_train_main",
    "sm3x-torch-mlc-eval": "sm3x_torch.cli.apps:mlc_eval_main",
    "sm3x-torch-backbone-eval": "sm3x_torch.cli.apps:backbone_eval_main",
    "sm3x-torch-reproduce": "sm3x_torch.reproduce:main",
    "sm3x-torch-serve": "sm3x_torch.serve_http:main",
    "sm3x-torch-probe-transfer": "sm3x_torch.train.transfer_probe:main",
}


def _public_names(path: str, reexports: bool) -> set:
    """Top-level defs, classes and assigned names of `path`; with
    `reexports`, the names it imports from modules too."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        names.add(e.id)
        elif (isinstance(node, ast.ImportFrom) and reexports
              and node.module != "__future__"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _reference_files() -> list:
    return sorted(os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "sm3x", "**", "*.py"), recursive=True))


def _counterpart(ref: str) -> str:
    return "sm3x_torch/" + ref[len("sm3x/"):].replace("_pallas.py",
                                                       "_cuda.py")


@pytest.mark.parametrize("ref", _reference_files())
def test_every_public_name_has_a_counterpart_or_a_reason(ref):
    port = _counterpart(ref)
    if ref in FILES_NOT_PORTED:
        assert not os.path.exists(os.path.join(ROOT, port))
        return
    assert os.path.exists(os.path.join(ROOT, port)), f"{port} is missing"
    want = _public_names(os.path.join(ROOT, ref),
                         reexports=ref.endswith("__init__.py"))
    # a port module's imports count: a name may be used from where it is
    # defined and re-exported where the reference keeps it
    have = _public_names(os.path.join(ROOT, port), reexports=True)
    listed = NOT_PORTED.get(ref, {})
    missing = sorted(want - have - set(listed))
    assert missing == [], f"{port} lacks {missing}"
    # a listed name is really absent, and its reason is one line
    assert sorted(set(listed) & have) == []
    assert all(r and "\n" not in r for r in listed.values())


def test_the_lists_name_only_reference_files():
    refs = set(_reference_files())
    assert set(FILES_NOT_PORTED) <= refs
    assert set(NOT_PORTED) <= refs
    for ref, names in NOT_PORTED.items():
        want = _public_names(os.path.join(ROOT, ref),
                             reexports=ref.endswith("__init__.py"))
        assert set(names) <= want, ref


def test_the_port_s_names_in_the_reasons_exist():
    """A reason that names the port's counterpart names one that is
    there."""
    reasons = list(FILES_NOT_PORTED.values()) + [
        r for names in NOT_PORTED.values() for r in names.values()]
    dotted = {m for r in reasons
              for m in re.findall(r"sm3x_torch(?:\.\w+)+", r)}
    assert len(dotted) > 10
    for path in sorted(dotted):
        parts = path.split(".")
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:i]))
                break
            except ImportError:
                continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)


@pytest.mark.parametrize("pkg", ["sm3x_torch", "sm3x_torch.cli",
                                 "sm3x_torch.core", "sm3x_torch.data",
                                 "sm3x_torch.losses", "sm3x_torch.models",
                                 "sm3x_torch.native", "sm3x_torch.ops",
                                 "sm3x_torch.parallel", "sm3x_torch.train",
                                 "sm3x_torch.utils"])
def test_package_reexports_resolve(pkg):
    """Each name a package's `__all__` or re-export lists is there after
    import, and is the object of the module that defines it."""
    mod = importlib.import_module(pkg)
    ref = os.path.join("sm3x", *pkg.split(".")[1:], "__init__.py")
    for name in _public_names(os.path.join(ROOT, ref), reexports=True):
        if name in NOT_PORTED.get(ref, {}):
            continue
        assert hasattr(mod, name), f"{pkg}.{name}"
    for name in getattr(mod, "__all__", []):
        assert hasattr(mod, name), f"{pkg}.{name}"


def test_console_scripts_name_targets_that_import():
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    scripts = dict(re.findall(r'^(sm3x-torch-[\w-]+) = "([\w.:]+)"', text,
                              re.M))
    assert scripts == SCRIPTS
    for target in scripts.values():
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func))


def test_named_resnet_constructors_build_their_arch():
    from sm3x_torch.models import resnet

    for name in ("resnet18", "resnet34", "resnet50", "resnet101",
                 "resnet152", "resnext50_32x4d", "resnext101_32x8d",
                 "resnext101_64x4d", "wide_resnet50_2", "wide_resnet101_2"):
        assert getattr(resnet, name).args == (name,)
    model = resnet.resnet18(num_classes=3).eval()
    assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 3)


def test_classes_name_2_equals_the_reference():
    import sm3x
    import sm3x_torch

    assert sm3x_torch.CLASSES_NAME_2 == sm3x.CLASSES_NAME_2


def test_copy_best_copies_the_file(tmp_path):
    from sm3x_torch.utils.checkpoint import copy_best

    src, dst = tmp_path / "ckp_3.pth", tmp_path / "best_eval.pth"
    src.write_bytes(b"\x00\x01weights")
    copy_best(str(src), str(dst))
    assert dst.read_bytes() == src.read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ntxent_loss_from_logits_matches_the_reference(dtype):
    from sm3x.ops.ntxent import ntxent_logits as jax_logits
    from sm3x.ops.ntxent import ntxent_loss as jax_loss
    from sm3x.ops.ntxent import ntxent_loss_from_logits as jax_fn
    from sm3x_torch.losses import ntxent_loss, ntxent_loss_from_logits
    from sm3x_torch.ops.ntxent import ntxent_logits

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((14, 9)).astype(dtype) * 3
    labels = rng.integers(0, 9, 14)
    got = ntxent_loss_from_logits(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    want = np.asarray(jax_fn(jnp.asarray(logits, jnp.float32),
                             jnp.asarray(labels)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # through the explicit layout it equals the fused loss, as in JAX
    z1 = rng.standard_normal((6, 16)).astype(np.float32)
    z2 = rng.standard_normal((6, 16)).astype(np.float32)
    lg, lb = ntxent_logits(torch.from_numpy(z1), torch.from_numpy(z2), 0.1)
    np.testing.assert_allclose(
        ntxent_loss_from_logits(lg, lb).numpy(),
        np.asarray(jax_fn(*jax_logits(jnp.asarray(z1), jnp.asarray(z2),
                                      0.1))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ntxent_loss_from_logits(lg, lb).numpy(),
        ntxent_loss(torch.from_numpy(z1), torch.from_numpy(z2), 0.1).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jax_loss(jnp.asarray(z1), jnp.asarray(z2), 0.1)),
        ntxent_loss(torch.from_numpy(z1), torch.from_numpy(z2), 0.1).numpy(),
        rtol=1e-5, atol=1e-6)


def test_setup_logger_is_reexported_under_the_reference_s_module():
    from sm3x_torch.utils import logging as L
    from sm3x_torch.utils.misc import setup_logger

    assert L.setup_logger is setup_logger
