"""sm3x_torch — the PyTorch / CUDA port of sm3x for NVIDIA Hopper GPUs.

The JAX package `sm3x` is the reference; this package mirrors its layout
and names, so each module has its counterpart there. It imports `torch`
and never `jax`. Kernels written by hand for Hopper live in `csrc/` and
are built with nvcc at first use (`sm3x_torch.ops._native`).

Subpackages
-----------
core      configs, seed discipline
models    ResNet and ViT families, SimCLR dual-modal models, projectors,
          batch norm, the transformer layer and the MLC model of stage 2
ops       NT-Xent, augmentation, attention, copy: plain versions and CUDA
          kernels; spherical k-means
losses    stage-1 SSL loss assembly, the cluster cross-entropy of stage 2
train     the stage-1 and stage-2 trainers
data      Derm7pt metadata, decode-once canvas cache, dataset registry,
          in-memory synthetic paired canvases, synthetic Derm7pt trees
utils     weight bridge from Flax trees, run helpers, device clocks
cli       argparse surface and the stage-1 and stage-2 apps
"""

__version__ = "0.1.0"

# The task's constants, shared by every stage: the port's own copy of those
# in sm3x/__init__.py (the eight labels of the 7-point checklist with the
# diagnosis first, their class counts, and the weights of the averaged
# metrics).
METRICS_NAME = ["AUC", "Recall", "Spec", "Prec"]
CLASSES_NAME = ["DIAG", "PN", "BWV", "VS", "PIG", "STR", "DaG", "RS"]
NUM_CLASSES = [5, 3, 2, 3, 3, 3, 3, 2]
CLS_WEIGHTS = [2, 2, 1, 2, 2, 2, 2, 1]
# one name a class, "DIAG-1" .. "RS-2", in the labels' order
CLASSES_NAME_2 = [
    f"{CLASSES_NAME[i]}-{j + 1}"
    for i in range(len(CLASSES_NAME))
    for j in range(NUM_CLASSES[i])
]
