"""The host-side native code of the port: the libjpeg decode / letterbox
loader (`loader.cpp`, bound by `loader.py`)."""

from sm3x_torch.native.loader import (  # noqa: F401
    decode_letterbox_batch, native_loader_available)

__all__ = ["native_loader_available", "decode_letterbox_batch"]
