"""Host-side utilities for the CUDA port."""

from .devices import device_info

__all__ = ["device_info"]
