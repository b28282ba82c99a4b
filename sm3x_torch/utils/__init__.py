"""Run helpers of the port (counterpart of sm3x/utils/): run directories,
meters, the logger and stat writer, checkpoint files."""

from sm3x_torch.utils.misc import (  # noqa: F401
    AverageMeter, BestRecorder, ProgressMeter, create_eval_stat,
    fix_random_seeds, increment_path, save_args, setup_logger)
from sm3x_torch.utils.logging import (  # noqa: F401
    StatWriter, generate_stat_text)
from sm3x_torch.utils.checkpoint import export_backbone  # noqa: F401

__all__ = [
    "increment_path", "save_args", "fix_random_seeds", "AverageMeter",
    "ProgressMeter", "BestRecorder", "create_eval_stat", "setup_logger",
    "StatWriter", "generate_stat_text", "export_backbone",
]
