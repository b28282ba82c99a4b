"""The port's public surface against the JAX package's, read with `ast`
and no import: every public top-level name of each `sm3x/**.py` (the
names an `__init__.py` re-exports included) is in the file's counterpart
under `sm3x_torch/`, or stands in NOT_PORTED with the reason, which is
the port's name for it or "Do not port" (ROADMAP.md). A file of `sm3x/`
has a counterpart at the same path, `*_pallas.py` at `*_cuda.py`, unless
it stands in FILES_NOT_PORTED. Each script of the JAX package (every
`tools/**.py` but the port's `*_torch.py`, and each root `*.py` that
imports `sm3x`) has a `_torch` twin, whose parser takes every option of
the JAX script's with an equal default, or stands in SCRIPTS_NOT_TWINNED
with its counterpart or reason. Then the port's console scripts, whose
targets must import, and `ntxent_loss_from_logits` against the JAX
function on the same logits."""

import argparse
import ast
import glob
import importlib
import os
import re
import runpy
import sys
from unittest import mock

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
    "sm3x-torch-export-aot": "sm3x_torch.export:main",
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


# --- parameters ------------------------------------------------------------
#
# Every parameter of a public function or method of the JAX package (a
# Flax module's or dataclass's fields for its constructor) is a parameter
# of the counterpart with an equal default, the JAX default read in the
# port module's own names. The exceptions:

# parameters the port takes in another form, wherever they appear
PARAMS_IN_ANOTHER_FORM = {
    "mesh": "a torch.distributed process group (sm3x_torch.core.mesh) takes "
            "the place of a device mesh",
    "axis_name": "a process group takes the place of a mesh axis",
    "bn_axis_name": "the global-batch BatchNorm reduces over the data "
                    "process group",
    "use_pallas": "a CUDA tensor takes the kernel, a CPU tensor its plain "
                  "version",
    "use_pallas_aug": "a CUDA tensor takes the kernel, a CPU tensor its plain "
                      "version",
    "interpret": "a CUDA tensor takes the kernel, a CPU tensor its plain "
                 "version",
    "train": "the module's mode: nn.Module.train() / eval()",
    "deterministic": "the module's mode: nn.Module.train() / eval()",
}

# `dtype=jnp.bfloat16` is `amp=True` (bf16 autocast around the encoders) and
# `jnp.float32` is a float32 module, which needs no parameter; these keep
# `amp=False` by default
AMP_OFF_BY_DEFAULT = {
    name: "every trainer passes --amp to it explicitly (the CLI's default), "
          "and a float32 default keeps a bare construction exact"
    for name in ("sm3x/models/mlc.py:DualExtractor.__init__",
                 "sm3x/models/mlc.py:MLCModel.__init__",
                 "sm3x/models/simclr.py:build_ssl_model",
                 "sm3x/models/simclr.py:SimCLRBranch.__init__",
                 "sm3x/models/simclr.py:SimCLR.__init__",
                 "sm3x/models/simclr.py:SimCLRSkin.__init__",
                 "sm3x/models/simclr.py:SimCLRSkinV3.__init__",
                 "sm3x/models/simclr.py:SimCLRSkinV2.__init__",
                 "sm3x/models/trimodal.py:TriModalSimCLR.__init__",
                 "sm3x/models/baseline.py:Baseline.__init__",
                 "sm3x/models/baseline.py:SingleBaseline.__init__")}

ENCODER_DTYPE = ("an encoder runs in the autocast region of the model that "
                 "owns it (that model's `amp`)")
RNG = "a torch.Generator or an integer seed takes the place of a jax key"
TREE = ("a torch module holds its weights; the function takes the module or "
        "its state dict")
AUG_FN = ("the augmentation is the step's own (ssl_augment_batch), K1 on a "
          "CUDA tensor")

# each other difference, by "file:function" or "file:Class.method", with its
# reason
SIGNATURE_DIFFERENCES = {
    "sm3x/api.py:load_weights": {
        "arch": "the port loads into a model that build_evaluator made for "
                "its arch",
    },
    "sm3x/api.py:predict_fn": {"variables": TREE},
    # `platforms` keeps its name and default (None: where the model is);
    # its values are torch device types, "cpu" and "cuda", where the JAX
    # package's are lowering platforms, and each is a program file of its
    # own. ExportedPredictor.__init__ adds `device`, "cuda" by default as
    # every port entry point's (test_every_device_parameter_defaults_to_
    # the_card holds it)
    "sm3x/export.py:export_predictor": {"variables": TREE},
    "sm3x/cli/parser.py:get_parser": {
        "desc": "the help text's title names the port's program",
    },
    "sm3x/core/mesh.py:make_mesh": {
        "devices": "a process is one card; the grid is made of processes",
        "data": "the data size is the world size over `model`",
    },
    "sm3x/core/mesh.py:label_head_shardings": {
        "mesh": "a plan a tensor: (key, shape, model) -> the split axis",
        "tree": "a plan a tensor: (key, shape, model) -> the split axis",
    },
    "sm3x/core/mesh.py:vit_tp_shardings": {
        "mesh": "a plan a tensor: (key, shape, model) -> the split axis",
        "tree": "a plan a tensor: (key, shape, model) -> the split axis",
    },
    "sm3x/models/backbones.py:build_backbone": {"dtype": ENCODER_DTYPE},
    "sm3x/models/resnet.py:build_resnet": {"dtype": ENCODER_DTYPE},
    "sm3x/models/resnet.py:ResNet.__init__": {"dtype": ENCODER_DTYPE},
    "sm3x/models/resnet.py:BasicBlock.__init__": {
        "dtype": ENCODER_DTYPE,
        "strides": "torchvision's block, whose parameter is `stride`",
    },
    "sm3x/models/resnet.py:Bottleneck.__init__": {
        "dtype": ENCODER_DTYPE,
        "strides": "torchvision's block, whose parameter is `stride`",
    },
    "sm3x/models/vit.py:build_vit": {"dtype": ENCODER_DTYPE},
    "sm3x/models/vit.py:ViT.__init__": {"dtype": ENCODER_DTYPE},
    "sm3x/models/vit.py:ViTBlock.__init__": {"dtype": ENCODER_DTYPE},
    "sm3x/models/projector.py:SSLProjector.__call__": {
        "x": "an nn.Sequential, whose forward names its input `input`",
    },
    "sm3x/ops/augment.py:ssl_augment_batch": {"rng": RNG},
    "sm3x/ops/augment.py:supervised_augment_batch": {"rng": RNG},
    "sm3x/ops/augment.py:multicrop_augment_batch": {
        "rng": RNG,
        "aug_fn": "a crop group's views go through one K1 launch, so the "
                  "augmentation is fixed",
    },
    "sm3x/ops/augment_pallas.py:ssl_augment_batch_fused": {
        "rng": RNG,
        "cfg": "None meant SSL_AUG there; the port names SSL_AUG",
    },
    "sm3x/ops/augment_pallas.py:build_params": {"rng": RNG},
    "sm3x/ops/kmeans.py:spherical_kmeans": {"rng": RNG},
    "sm3x/parallel/collectives.py:distributed_initialize": {
        "coordinator_address": "`coordinator`, torchrun's host:port",
    },
    "sm3x/parallel/collectives.py:broadcast_string": {
        "max_len": "4096 bytes: a run directory's path on a deep tree fits; "
                   "the length is checked",
    },
    "sm3x/parallel/collectives.py:all_gather_varlen": {
        "max_len": "the lengths are gathered first, so no cap is needed",
    },
    "sm3x/reproduce.py:evaluate": {
        "platform": "--platform is the JAX backend's (Do not port); the "
                    "port's `device`",
    },
    "sm3x/serve.py:Predictor.__init__": {"variables": TREE},
    "sm3x/train/backbone_eval.py:BackboneEvalTrainer.__init__": {
        "encoder_tree": "`encoder_state`, a state dict",
    },
    "sm3x/train/mlc_eval.py:MLCEvalTrainer.__init__": {
        "pretrained_tree": "`pretrained_state`, a state dict",
    },
    "sm3x/train/mlc_train.py:MLCTrainer.__init__": {
        "extractor_tree": "`extractor_state`, a state dict",
    },
    "sm3x/train/common.py:make_adamw": {
        "mask_tree": "the optimizer takes only the trainable parameters "
                     "(trainable_parameters)",
    },
    "sm3x/train/common.py:mlc_train_trainable": {
        "path": "`name`, a state-dict key",
    },
    "sm3x/train/common.py:mlc_eval_trainable": {
        "path": "`name`, a state-dict key",
    },
    "sm3x/train/common.py:backbone_eval_trainable": {
        "path": "`name`, a state-dict key",
    },
    "sm3x/train/common.py:CheckpointableTrainer.save_async": {
        "tree": "`state`, the trainer's state dicts, taken from the trainer "
                "when not given",
    },
    "sm3x/train/common.py:CheckpointableTrainer.resume_from_orbax": {
        "*": f"{DNP}: the Orbax backend",
    },
    "sm3x/train/linear_probe.py:make_ssl_extract_fn": {
        "state": TREE,
    },
    "sm3x/train/mlc_train.py:make_mlc_train_step": {"aug_fn": AUG_FN},
    "sm3x/train/mlc_train.py:make_embed_step": {"aug_fn": AUG_FN},
    "sm3x/train/mlc_train.py:cluster_and_update": {
        "rng": RNG,
        "params": TREE,
    },
    "sm3x/train/supervised.py:make_supervised_steps": {
        "apply_train": "`forward_train`, the module's train-mode call",
        "apply_eval": "`forward_eval`, the module's eval-mode call",
        "aug_fn": AUG_FN,
    },
    "sm3x/train/transfer_probe.py:make_single_extract_fn": {
        "params": TREE,
        "batch_stats": TREE,
    },
    "sm3x/utils/checkpoint.py:export_backbone": {
        "params": "`state`, the module's state dict",
        "batch_stats": "`state`, the module's state dict",
    },
    "sm3x/utils/logging.py:setup_logger": {
        "name": "the port's loggers are named sm3x_torch",
        "to_stdout": "rank 0 writes to stdout, always",
        "distributed_rank": "`rank`",
    },
}

# entry points whose `device` does not default to the card, with the reason
DEVICE_NOT_THE_CARD = {
    "sm3x_torch.utils.weights.to_tensors": "host tensors for "
                                            "load_state_dict, which copies "
                                            "them to the module's device",
}


def _record(cls: ast.ClassDef) -> bool:
    """A Flax module, a dataclass or a NamedTuple: its annotated fields are
    its constructor's parameters."""
    marks = [ast.unparse(d) for d in cls.decorator_list] + [
        ast.unparse(b) for b in cls.bases]
    return any("dataclass" in m or m.endswith("Module") or m == "NamedTuple"
               for m in marks)


def _def_params(fn: ast.FunctionDef) -> list:
    """[(name, default source or None)] of a def, self / cls and the
    catch-alls left out."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    pairs = list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    return [(p.arg, None if d is None else ast.unparse(d)) for p, d in pairs
            if p.arg not in ("self", "cls")]


def _reference_signatures(path: str):
    """(qualified name, method or None, [(param, default source)]) of every
    public function, constructor and method of `path`."""
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            yield node.name, None, _def_params(node)
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        methods = {n.name: n for n in node.body
                   if isinstance(n, ast.FunctionDef)}
        if "__init__" in methods:
            yield node.name, "__init__", _def_params(methods["__init__"])
        elif _record(node):
            yield node.name, "__init__", [
                (n.target.id, None if n.value is None
                 else ast.unparse(n.value)) for n in node.body
                if isinstance(n, ast.AnnAssign)
                and isinstance(n.target, ast.Name)
                and "ClassVar" not in ast.unparse(n.annotation)]
        for name, fn in methods.items():
            # `setup` is Flax's construction hook: torch builds in __init__
            if name == "setup" or (name.startswith("_")
                                   and name != "__call__"):
                continue
            if any(ast.unparse(d) == "property" for d in fn.decorator_list):
                continue
            yield node.name, name, _def_params(fn)


def _port_defaults(obj) -> dict:
    """{param: default or inspect.Parameter.empty} of a port callable; a
    dataclass field's default factory is called."""
    import dataclasses
    import inspect

    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
            else:
                out[f.name] = inspect.Parameter.empty
        return out
    return {p.name: p.default
            for p in inspect.signature(obj).parameters.values()
            if p.name not in ("self", "cls")
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _reference_default(source: str, namespace: dict):
    """The JAX default `source` read in the port module's names; a
    dataclass field's factory is called."""
    import dataclasses

    value = eval(source, dict(namespace))
    if isinstance(value, dataclasses.Field):
        return (value.default if value.default is not dataclasses.MISSING
                else value.default_factory())
    return value


def _port_target(module, name: str, method):
    """The port's counterpart of `name` (and `method`): a torch module's
    forward stands for a Flax module's __call__."""
    obj = getattr(module, name)
    if method is None or method == "__init__":
        return obj
    if method == "__call__" and issubclass(obj, torch.nn.Module):
        method = "forward"
    return getattr(obj, method, None)


def _equal(a, b) -> bool:
    try:
        return bool(a == b)
    except (TypeError, ValueError, RuntimeError):
        return False


@pytest.mark.parametrize("ref", [r for r in _reference_files()
                                 if r not in FILES_NOT_PORTED])
def test_every_parameter_has_a_counterpart_with_an_equal_default(ref):
    """The JAX package's parameters against the port's, by name and
    default, apart from the lists above; each listed difference is real."""
    import inspect

    port = _counterpart(ref)
    module = importlib.import_module(
        port[:-3].replace("/", ".").removesuffix(".__init__"))
    names_not_ported = NOT_PORTED.get(ref, {})
    problems, listed_seen = [], set()
    for name, method, params in _reference_signatures(
            os.path.join(ROOT, ref)):
        if name in names_not_ported:
            continue
        key = f"{ref}:{name}" + (f".{method}" if method else "")
        listed = SIGNATURE_DIFFERENCES.get(key, {})
        target = _port_target(module, name, method)
        if "*" in listed:
            assert target is None, f"{key} is listed as not ported"
            listed_seen.add(key)
            continue
        assert target is not None, f"{key}: no counterpart"
        have = _port_defaults(target)
        for param, source in params:
            if param in PARAMS_IN_ANOTHER_FORM:
                continue
            if param == "dtype" and param in listed:
                assert "amp" not in have, f"{key} has amp: unlist dtype"
                listed_seen.add(key)
                continue
            if param == "dtype":
                if source == "jnp.bfloat16":
                    amp = have.get("amp", inspect.Parameter.empty)
                    if not (amp is True or (amp is False
                                            and key in AMP_OFF_BY_DEFAULT)):
                        problems.append(f"{key}: dtype={source} but amp "
                                        f"defaults to {amp}")
                continue
            if param in listed:
                listed_seen.add(key)
                got = have.get(param, inspect.Parameter.empty)
                real = (param not in have or source is None
                        or got is inspect.Parameter.empty
                        or not _equal(got, _reference_default(
                            source, vars(module))))
                assert real, f"{key}({param}) is listed but matches"
                continue
            if param not in have:
                problems.append(f"{key}: no parameter {param!r}")
            elif source is not None:
                got = have[param]
                if got is inspect.Parameter.empty:
                    problems.append(f"{key}({param}): no default, the JAX "
                                    f"package's is {source}")
                    continue
                want = _reference_default(source, vars(module))
                if not _equal(got, want):
                    problems.append(f"{key}({param}): default {got!r}, the "
                                    f"JAX package's {source} = {want!r}")
    assert problems == []
    # the lists name only what this file has
    mine = {k for k in list(SIGNATURE_DIFFERENCES) + list(AMP_OFF_BY_DEFAULT)
            if k.startswith(ref + ":")}
    assert mine - set(AMP_OFF_BY_DEFAULT) <= listed_seen
    assert all(r and "\n" not in r for k in mine
               for r in SIGNATURE_DIFFERENCES.get(k, {}).values())


def test_the_signature_lists_name_reference_files():
    refs = set(_reference_files())
    for key in list(SIGNATURE_DIFFERENCES) + list(AMP_OFF_BY_DEFAULT):
        assert key.split(":")[0] in refs, key


def _port_callables():
    """(dotted name, callable) of every public function, class and method
    defined in a module of sm3x_torch."""
    import inspect
    import pkgutil

    import sm3x_torch

    for info in pkgutil.walk_packages(sm3x_torch.__path__, "sm3x_torch."):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if (name.startswith("_") or not callable(obj)
                    or getattr(obj, "__module__", None) != info.name):
                continue
            yield f"{info.name}.{name}", obj
            if inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    if isinstance(member, (classmethod, staticmethod)):
                        member = member.__func__
                    if callable(member) and not attr.startswith("_"):
                        yield f"{info.name}.{name}.{attr}", member


def test_every_device_parameter_defaults_to_the_card():
    """An entry point of the port runs on the card unless the caller asks
    for the CPU: every `device` parameter with a default says cuda."""
    import inspect

    found = {}
    for dotted, obj in _port_callables():
        try:
            param = inspect.signature(obj).parameters.get("device")
        except (TypeError, ValueError):
            continue
        if param is not None and param.default is not param.empty:
            found[dotted] = param.default
    assert "sm3x_torch.train.linear_probe.LinearProbe" in found
    wrong = {k: v for k, v in found.items()
             if v != "cuda" and k not in DEVICE_NOT_THE_CARD}
    assert wrong == {}
    assert set(DEVICE_NOT_THE_CARD) <= set(found)


def test_increment_path_follows_the_reference(tmp_path):
    """exist_ok keeps the path, mkdir=False makes nothing, and the next
    free suffix, the same as sm3x.utils.misc.increment_path's."""
    from sm3x.utils.misc import increment_path as jax_fn
    from sm3x_torch.utils.misc import increment_path

    run = tmp_path / "exp"
    assert increment_path(run, mkdir=False) == jax_fn(run, mkdir=False) == run
    assert not run.exists()
    assert increment_path(run) == run and run.is_dir()
    assert increment_path(run, exist_ok=True) == run
    free = increment_path(run, mkdir=False)
    assert free == jax_fn(run, mkdir=False) == tmp_path / "exp_2"
    assert not free.exists()
    assert increment_path(run, sep="-") == tmp_path / "exp-2"
    (tmp_path / "exp_5").mkdir()
    assert increment_path(run) == tmp_path / "exp_6"
    assert jax_fn(run) == tmp_path / "exp_7"
    nested = tmp_path / "a" / "b" / "c.txt"
    assert increment_path(nested, mkdir=False) == nested
    assert not nested.parent.exists()
    assert increment_path(nested) == nested and nested.parent.is_dir()


# --- scripts ---------------------------------------------------------------
#
# The JAX package's scripts without a `_torch` twin, with the port's
# counterpart (whose files must exist) or the reason

TPU_TOOL = (f"{DNP}: a TPU measurement tool; sm3x_torch.utils.profiling.trace "
            "and chip_smoke.py --profile serve the port")
BOTH = "runs both packages, one a process, to compare them"

SCRIPTS_NOT_TWINNED = {
    "__graft_entry__.py": "chip_smoke.py and tools/dryrun_multigpu_torch.py",
    "tools/bench_stages.py": "bench_torch.py --stage",
    "tools/bench_pallas_io.py": "tools/bench_copy_torch.py",
    "tools/misc/process_data_for_gcs.py": "serves both packages: it imports "
                                          "neither",
    "tools/compare_ssl_loss.py": BOTH,
    "tools/bf16_census.py": BOTH,
    "tools/export_torch_ckpt.py": f"{DNP}: the sm3x.utils.torch_export "
                                  "bridge; the port keeps .pth state dicts "
                                  "natively",
    "tools/bench_torch_baseline.py": f"{DNP}: the CPU torch denominator of "
                                     "the TPU bench",
    **{f"tools/{name}.py": TPU_TOOL for name in (
        "bench_int8_mxu", "bench_int8_conv", "bench_compiler_options",
        "bench_hbm_attribution", "bench_bn_alternation", "bench_bn_stale",
        "bench_bn_subsample", "bench_aug_pallas",
        "profile_step")},
}

# options of a JAX script whose twin differs, by (script, option or the
# index of a positional argument), with the reason
OPTION_DIFFERENCES = {
    ("bench.py", 0): "the stage's batch, run.sh's (96 for stage 1) where "
                     "bench.py's is 128",
    ("tools/demo_synthetic_e2e.py", "--log-path"):
        "sm3x_torch_demo under the temporary directory that the environment "
        "names, so that a run of each package keeps its own",
    ("tools/export_model.py", "--platforms"):
        "['cuda']: the card, as every device of the port defaults to it; "
        "the JAX package's None is its default backend",
    ("tools/reproduce_results.py", "--platform"):
        "--platform is the JAX backend's (Do not port); the port's --device",
}


def _imports(path: str) -> set:
    """The modules `path` imports, anywhere in the file."""
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _jax_scripts() -> list:
    """Every tools/**.py but the port's, and the root scripts that import
    the JAX package."""
    tools = glob.glob(os.path.join(ROOT, "tools", "**", "*.py"),
                      recursive=True)
    root = [p for p in glob.glob(os.path.join(ROOT, "*.py"))
            if any(m == "sm3x" or m.startswith("sm3x.")
                   for m in _imports(p))]
    return sorted(os.path.relpath(p, ROOT) for p in tools + root
                  if not p.endswith("_torch.py"))


def _twin(script: str) -> str:
    return script[:-len(".py")] + "_torch.py"


@pytest.mark.parametrize("script", _jax_scripts())
def test_every_jax_script_has_a_twin_or_a_reason(script):
    listed = SCRIPTS_NOT_TWINNED.get(script)
    if listed is None:
        assert os.path.exists(os.path.join(ROOT, _twin(script))), (
            f"{_twin(script)} is missing")
        return
    assert not os.path.exists(os.path.join(ROOT, _twin(script)))
    assert listed and "\n" not in listed
    for path in re.findall(r"[\w/]+\.py", listed):
        assert os.path.exists(os.path.join(ROOT, path)), path


def test_the_script_lists_name_jax_scripts():
    scripts = set(_jax_scripts())
    assert "tools/bench_prefetch.py" in scripts and "bench.py" in scripts
    assert set(SCRIPTS_NOT_TWINNED) <= scripts
    assert {s for s, _ in OPTION_DIFFERENCES} <= scripts


class _Parsed(Exception):
    pass


def _parser_of(script: str) -> argparse.ArgumentParser:
    """The parser `script` builds when run with no arguments: its
    parse_args is stopped before anything else runs."""
    built = []

    def stop(self, *args, **kwargs):
        built.append(self)
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_known_args",
                           stop), \
            mock.patch.object(sys, "argv", [script]), \
            mock.patch.object(sys, "path", list(sys.path)), \
            pytest.raises(_Parsed):
        runpy.run_path(os.path.join(ROOT, script), run_name="__main__")
    return built[0]


def _normal(value):
    return list(value) if isinstance(value, tuple) else value


def _parser_options(parser) -> dict:
    """{option string or positional index: default} of a parser."""
    out, positional = {}, 0
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        if action.option_strings:
            for name in action.option_strings:
                out[name] = _normal(action.default)
        else:
            out[positional] = _normal(action.default)
            positional += 1
    return out


def _argv_defaults(script: str) -> dict:
    """{positional index: default} of a script that reads sys.argv by hand
    (`sys.argv[i] if len(sys.argv) > i else default`)."""
    out = {}
    for node in ast.walk(ast.parse(open(os.path.join(ROOT, script)).read())):
        if (isinstance(node, ast.IfExp) and isinstance(node.test, ast.Compare)
                and ast.unparse(node.test.left) == "len(sys.argv)"
                and isinstance(node.orelse, ast.Constant)):
            out[node.test.comparators[0].value - 1] = node.orelse.value
    return out


def _parses_options(script: str) -> bool:
    """Whether `script`, or the module of the JAX package whose main it
    runs, builds an argparse parser."""
    paths = [os.path.join(ROOT, script)]
    for node in ast.walk(ast.parse(open(paths[0]).read())):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "sm3x"
                and any(a.name == "main" or a.name.endswith("_main")
                        for a in node.names)):
            paths.append(os.path.join(ROOT, *node.module.split(".")) + ".py")
    return any("add_argument(" in open(p).read() for p in paths)


TWINNED = [s for s in _jax_scripts() if s not in SCRIPTS_NOT_TWINNED]


@pytest.mark.parametrize("script", TWINNED)
def test_every_option_has_a_twin_with_an_equal_default(script):
    """Every option of the JAX script, and each positional argument it
    reads from sys.argv by hand, is taken by its twin with an equal
    default, apart from OPTION_DIFFERENCES; each listed difference is
    real."""
    if _parses_options(script):
        want = _parser_options(_parser_of(script))
    else:
        want = _argv_defaults(script)
    assert want, f"no option read from {script}"
    have = _parser_options(_parser_of(_twin(script)))
    problems = []
    for option, default in want.items():
        reason = OPTION_DIFFERENCES.get((script, option))
        if reason is not None:
            assert option not in have or have[option] != default, (
                f"{script} {option} is listed but matches")
            continue
        if option not in have:
            problems.append(f"{_twin(script)} lacks {option}")
        elif have[option] != default:
            problems.append(f"{_twin(script)} {option}: default "
                            f"{have[option]!r}, the JAX script's "
                            f"{default!r}")
    assert problems == []


def test_the_option_check_reads_every_kind_of_script():
    """Parsers built by the script itself, by the module of the JAX
    package whose main it runs, and positionals read by hand."""
    assert _argv_defaults("tools/bench_prefetch.py") == {
        0: 160, 1: 32, 2: 4, 3: "resnet50"}
    assert _parser_options(_parser_of("tools/bench_prefetch_torch.py"))[
        3] == "resnet50"
    assert _parses_options("tools/export_model.py")
    assert "--buckets" in _parser_options(_parser_of("tools/export_model.py"))
    assert "--arch-version" in _parser_options(
        _parser_of("tools/backbone_train.py"))
    assert not _parses_options("bench.py")
