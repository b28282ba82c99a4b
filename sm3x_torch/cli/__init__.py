"""The port's command-line surface (counterpart of sm3x/cli/): the parser
and the configs it builds; the four stage apps are in
`sm3x_torch.cli.apps`."""

from sm3x_torch.cli.parser import (  # noqa: F401
    base_configs, eval_config, get_parser, mlc_train_config, ssl_config)

__all__ = ["get_parser", "ssl_config", "mlc_train_config", "eval_config",
           "base_configs"]
