"""AOT model export (counterpart of sm3x/export.py; the port's own code, it
imports nothing of the JAX package): serialise the served program to a
self-contained `torch.export` artifact.

The deployment unit of `Predictor` is a `.pth` plus the model code that
rebuilds it. Here it can be the captured program itself: `torch.export`
captures `sm3x_torch.serve.ServedForward` (device resize + normalise ->
MLC model -> per-label softmax), weights baked in, and `ExportedPredictor`
serves it without the model code, the checkpoint or any tracing at load.
The program is lowered to ATen (`run_decompositions`), so the encoders'
bf16 autocast is a set of explicit casts in it. One program is exported
per batch bucket (the padding discipline of `Predictor`), and, since a
program is traced on one device, one per device type: `platforms=("cpu",
"cuda")` is the counterpart of the JAX package's `--platforms cpu tpu`.

Artifact layout (a directory):
    manifest.json              {"buckets": [...], "image_size": ...,
                                "platforms": [...], "num_classes": [...]}
    fwd_b{N}_{platform}.pt2    an ExportedProgram per bucket per device type
"""

from __future__ import annotations

import copy
import json
import os
from typing import Sequence

import torch

from sm3x_torch import NUM_CLASSES
from sm3x_torch.serve import ServedForward, _GraphPredictor, _tf32_off

_MANIFEST = "manifest.json"
PLATFORMS = ("cpu", "cuda")


def _program_file(path: str, b: int, platform: str) -> str:
    return os.path.join(path, f"fwd_b{b}_{platform}.pt2")


def export_predictor(model, path: str,
                     buckets: Sequence[int] = (1, 8, 32),
                     image_size: int = 224,
                     mean=(0.7833, 0.6712, 0.6026),
                     std=(0.2139, 0.2472, 0.2571),
                     canvas: int = 320,
                     crop_amount: int = 25,
                     platforms: Sequence[str] | None = None) -> dict:
    """Export the full eval path of `model` (an `MLCModel` with its weights
    loaded, in the precision it was built with) at each batch bucket.
    Inputs per bucket b: uint8 canvases (b, canvas, canvas, 3) + valid-hw
    (b, 2) int32 per modality; output the packed (b, sum C_i) float32
    probabilities.

    `platforms` are device types, "cpu" and "cuda"; None means the model's.
    A platform other than the model's exports a copy of it moved there."""
    mean, std = tuple(mean), tuple(std)
    buckets = sorted(set(int(b) for b in buckets))
    if not buckets:
        raise ValueError("export needs at least one batch bucket")
    own = next(model.parameters()).device
    platforms = list(dict.fromkeys(platforms or [own.type]))
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown}: the port exports for "
                         f"{list(PLATFORMS)}")
    os.makedirs(path, exist_ok=True)
    model = model.eval()
    for platform in platforms:
        if platform == own.type:
            dev, m = own, model
        else:
            dev = torch.device(platform)
            m = copy.deepcopy(model).to(dev)
            if dev.type == "cuda":  # the layout load_weights gives the card
                m.to(memory_format=torch.channels_last)
        served = ServedForward(m, mean, std, image_size)
        for b in buckets:
            hw = torch.full((b, 2), canvas, dtype=torch.int32, device=dev)
            img = torch.zeros((b, canvas, canvas, 3), dtype=torch.uint8,
                              device=dev)
            # no_grad, not inference_mode: export refuses inference tensors
            with torch.no_grad(), _tf32_off():
                program = torch.export.export(
                    served, (img, hw, img.clone(), hw.clone()))
                program = program.run_decompositions()
            torch.export.save(program, _program_file(path, b, platform))
    manifest = {
        "buckets": buckets,
        "image_size": int(image_size),
        "canvas": int(canvas),
        "crop_amount": int(crop_amount),
        "mean": list(mean),
        "std": list(std),
        "num_classes": list(NUM_CLASSES),
        "platforms": platforms,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedPredictor(_GraphPredictor):
    """Serving wrapper over an exported artifact: the loaded programs stand
    in for model and weights (no model code, no checkpoint, no tracing).
    On the card each bucket's program is one CUDA graph, as in
    `sm3x_torch.serve.Predictor`, with which it shares the bucketed request
    surface, so it drops into the HTTP server unchanged; on the CPU the
    programs run eagerly. A device type the artifact holds no programs for
    is refused."""

    def __init__(self, path: str, device="cuda"):
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.device = torch.device(device)
        platforms = self.manifest["platforms"]
        if self.device.type not in platforms:
            raise ValueError(f"{path} holds programs for {platforms}, not "
                             f"for device {self.device.type!r}")
        self.buckets = sorted(self.manifest["buckets"])
        self.canvas = int(self.manifest["canvas"])
        # pre-crop artifacts (no crop_amount key) predate the border-crop
        # preprocessing fix; apply the training pipeline's default
        self.crop_amount = int(self.manifest.get("crop_amount", 25))
        self.num_classes = tuple(self.manifest["num_classes"])
        self._programs = {}
        for b in self.buckets:
            name = _program_file(path, b, self.device.type)
            if not os.path.exists(name):
                raise FileNotFoundError(
                    f"{name}: {path} is no torch.export artifact for "
                    f"{self.device.type} (a StableHLO export of the JAX "
                    f"package holds fwd_b{b}.stablehlo)")
            self._programs[b] = torch.export.load(name).module()
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._start()

    def _program(self, b: int):
        module = self._programs[b]

        def run(*args):
            with torch.inference_mode(), _tf32_off():
                return module(*args)
        return run


def main(argv=None):
    """CLI: checkpoint -> AOT serving artifact (sm3x-torch-export-aot;
    tools/export_model_torch.py is the repo-checkout shim)."""
    import argparse

    p = argparse.ArgumentParser("sm3x_torch AOT exporter")
    p.add_argument("--pretrain-path", type=str, required=True,
                   help="best_eval.pth of an eval stage, or a released "
                        "best_linear / best_finetune .pth")
    p.add_argument("--out", type=str, required=True,
                   help="artifact output directory")
    p.add_argument("-a", "--arch", type=str, default="resnet50")
    p.add_argument("--test-sz", type=int, default=224)
    p.add_argument("--canvas", type=int, default=320)
    p.add_argument("--crop-amount", type=int, default=25,
                   help="black-border crop the serving wrapper applies to "
                        "request images before letterbox (recorded in the "
                        "manifest; 0 disables)")
    p.add_argument("--buckets", nargs="*", type=int, default=[1, 8, 32])
    p.add_argument("--mean", nargs=3, type=float,
                   default=[0.7833, 0.6712, 0.6026])
    p.add_argument("--std", nargs=3, type=float,
                   default=[0.2139, 0.2472, 0.2571])
    p.add_argument("--platforms", nargs="*", type=str, default=["cuda"],
                   help="device types to export for, e.g. 'cpu cuda' for an "
                        "artifact loadable on both (a program a bucket a "
                        "device type)")
    args = p.parse_args(argv)

    from sm3x_torch.api import build_evaluator, load_weights

    model = build_evaluator(arch=args.arch)
    load_weights(model, args.pretrain_path,
                 device=(args.platforms or ["cuda"])[0])
    manifest = export_predictor(
        model, args.out, buckets=args.buckets,
        image_size=args.test_sz, mean=args.mean, std=args.std,
        canvas=args.canvas, crop_amount=args.crop_amount,
        platforms=args.platforms)
    size = sum(
        os.path.getsize(os.path.join(args.out, f))
        for f in os.listdir(args.out))
    print(f"exported buckets {manifest['buckets']} for platforms "
          f"{manifest['platforms']} -> {args.out} ({size / 1e6:.1f} MB)")


__all__ = ["export_predictor", "ExportedPredictor", "main"]
