"""sm3_vmoe_b16: two V-MoE-B/16 encoders (Riquelme et al. 2021,
arXiv:2106.05974: ViT-B/16 with the MLP of every other block, 1, 3, ..., 11,
a mixture of 32 experts of width 3072, top-2, capacity ratio 1.05) in the
SM3 dual encoder v3.2. The plain reference of the encoder
(`portbench/reference/vmoe.py`), and its operations a forward pass of one
image: 46.3 GFLOP at 224 x 224. The count is nominal: every token's k
expert passes, whether the capacity kept the choice or dropped it, and the
router; the capacity's empty slots are not counted."""

from portbench.harness import flops
from portbench.reference import vmoe


def encoder(c):
    m = c["moe"]
    return vmoe.VMoE(c["patch"], c["hidden"], c["depth"], c["heads"],
                     c["mlp_ratio"], c["img_size"], c["ln_eps"],
                     m["experts"], m["k"], m["blocks"], m["capacity_ratio"])


def forward_flops(c, size: int) -> float:
    """The ViT's dense count, plus for each MoE block k - 1 more MLP passes
    a token and the router's (S, D) x (D, E) product."""
    m = c["moe"]
    s = (size // c["patch"]) ** 2 + 1
    d, hidden = c["hidden"], int(c["hidden"] * c["mlp_ratio"])
    mlp = 2.0 * 2 * s * d * hidden
    router = 2.0 * s * d * m["experts"]
    return (flops.vit_forward(c["patch"], d, c["depth"], c["mlp_ratio"], size)
            + len(m["blocks"]) * ((m["k"] - 1) * mlp + router))
