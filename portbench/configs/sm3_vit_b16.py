"""sm3_vit_b16: two ViT-B/16 encoders (Dosovitskiy et al. 2021, Table 1:
hidden 768, 12 layers, 12 heads, MLP 3072, patch 16; 197 tokens at 224) in
the SM3 dual encoder v3.2. The plain reference of the encoder (pre-LN,
LayerNorm eps 1e-6, tanh GELU, the class token's feature), and its
operations a forward pass of one image: 35.1 GFLOP at 224 x 224."""

from portbench.harness import flops
from portbench.reference import nets


def encoder(c):
    return nets.ViT(c["patch"], c["hidden"], c["depth"], c["heads"],
                    c["mlp_ratio"], c["img_size"], c["ln_eps"])


def forward_flops(c, size: int) -> float:
    return flops.vit_forward(c["patch"], c["hidden"], c["depth"],
                             c["mlp_ratio"], size)
