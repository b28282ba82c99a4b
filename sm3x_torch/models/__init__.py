"""The port's models (counterpart of sm3x/models/): the ResNet family, the
SimCLR dual-modal models, the projectors, the transformer layer, the MLC
model of stage 2 and the supervised baselines."""

from sm3x_torch.models.resnet import ResNet, build_resnet, feat_dim  # noqa: F401
from sm3x_torch.models.projector import (  # noqa: F401
    MultiLabelProjector, SSLProjector)
from sm3x_torch.models.transformer import (  # noqa: F401
    MultiheadSelfAttention, TransformerEncoderLayer)
from sm3x_torch.models.simclr import (  # noqa: F401
    SimCLRBranch, SimCLRSkin, SimCLRSkinV2, SimCLRSkinV3, SimCLRSkinV32,
    build_ssl_model)
from sm3x_torch.models.mlc import (  # noqa: F401
    DualExtractor, MLCHead, MLCModel, Prototypes)
from sm3x_torch.models.baseline import (  # noqa: F401
    Baseline, LogisticRegressEvaluator, MLPHead, MultiHeadClassifier,
    SingleBaseline)

__all__ = [
    "build_resnet", "feat_dim", "ResNet", "SSLProjector",
    "MultiLabelProjector", "TransformerEncoderLayer",
    "MultiheadSelfAttention", "SimCLRBranch", "SimCLRSkin", "SimCLRSkinV2",
    "SimCLRSkinV3", "SimCLRSkinV32", "build_ssl_model", "MLCHead",
    "Prototypes", "MLCModel", "DualExtractor", "Baseline", "SingleBaseline",
    "MultiHeadClassifier", "LogisticRegressEvaluator", "MLPHead",
]
