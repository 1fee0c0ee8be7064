"""Native (C++) host runtime components, loaded via ctypes."""

from kobato_eyes_tpu_torch.native.build import load_native_library

__all__ = ["load_native_library"]
