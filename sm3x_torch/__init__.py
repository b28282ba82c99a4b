"""sm3x_torch — the PyTorch / CUDA port of sm3x for NVIDIA Hopper GPUs.

The JAX package `sm3x` is the reference; this package mirrors its layout
and names, so each module has its counterpart there. It imports `torch`
and never `jax`. Kernels written by hand for Hopper live in `csrc/` and
are built with nvcc at first use (`sm3x_torch.ops._native`).

Subpackages
-----------
core      configs, seed discipline
models    ResNet and ViT families, SimCLR dual-modal models, projector,
          batch norm
ops       NT-Xent, augmentation, attention, copy: plain versions and CUDA
          kernels
losses    stage-1 SSL loss assembly
train     the stage-1 trainer
data      Derm7pt metadata, decode-once canvas cache, dataset registry,
          in-memory synthetic paired canvases
utils     weight bridge from Flax trees, run helpers
cli       argparse surface and the stage-1 app
"""

__version__ = "0.1.0"
