"""The host-side native code of the port: the libjpeg decode / letterbox
loader (`loader.cpp`, bound by `loader.py`)."""
