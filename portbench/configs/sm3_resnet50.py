"""sm3_resnet50: two ResNet-50 encoders (He et al. 2016, Table 1:
bottleneck blocks [3, 4, 6, 3], widths 64 to 2048) in the SM3 dual encoder
v3.2. The plain reference of the encoder, and its operations a forward
pass of one image: 8.17 GFLOP at 224 x 224 (4.09 G multiply-adds)."""

from portbench.harness import flops
from portbench.reference import nets


def encoder(c):
    return nets.ResNet(c["block"], c["layers"], c["width"])


def forward_flops(c, size: int) -> float:
    return flops.resnet_forward(c["block"], c["layers"], c["width"], size)
