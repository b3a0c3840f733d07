"""Native host runtime: C++ batch assembly for the trainers' data path."""

from confignet_tpu_torch.runtime.native import gather_images, gather_rows, native_available

__all__ = ["gather_images", "gather_rows", "native_available"]
