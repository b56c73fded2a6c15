"""Native (C++) host components, built with g++ and loaded via ctypes
(the exports of ``pecanpy_tpu/native/__init__.py``)."""

from pecanpy_tpu_torch.native.loader import (  # noqa: F401
    native_available,
    parse_edgelist_native,
)
