"""Native host-side batch assembly (counterpart of vaw_tpu/runtime)."""

from .native import (
    gather_normalize,
    gather_normalize_reference,
    get_lib,
    native_available,
    normalize_u8,
    normalize_u8_reference,
)

__all__ = ["gather_normalize", "normalize_u8", "native_available", "get_lib",
           "gather_normalize_reference", "normalize_u8_reference"]
