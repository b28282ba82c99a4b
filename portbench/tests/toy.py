"""A toy stage-1 cell for the CPU tests: the ResNet-50 configuration cut
to a ResNet-18 at 32 x 32 over 24 cases of 48-pixel canvases, batch 8,
written as data files into a folder of its own."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
LIMITS = {"loss_gap": 1e-4, "proj_gap": 1e-3, "grad_gap": 5e-3,
          "change_gap": 3e-2}


def write_toy(root: Path, name: str = "toy_cell") -> Path:
    for d in ("workloads", "configs", "traffic"):
        (root / d).mkdir(parents=True, exist_ok=True)
    config = json.loads((BENCH / "configs/sm3_resnet50.json").read_text())
    config.update(arch="resnet18", block="basic", layers=[2, 2, 2, 2],
                  feat_dim=512, img_size=32)
    (root / "configs/toy_r18.json").write_text(json.dumps(config))
    shutil.copy(BENCH / "configs/sm3_resnet50.py", root / "configs/toy_r18.py")
    traffic = json.loads((BENCH / "traffic/ssl_recipe.json").read_text())
    traffic.update(cases=24, canvas=48)
    (root / "traffic/toy_mix.json").write_text(json.dumps(traffic))
    (root / f"workloads/{name}.json").write_text(json.dumps(
        {"config": "toy_r18", "traffic": "toy_mix", "chips": 1, "batch": 8,
         "why": "toy", "limits": LIMITS}))
    return root
