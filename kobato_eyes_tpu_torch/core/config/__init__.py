"""Configuration subsystem (pydantic schema + YAML persistence)."""

from kobato_eyes_tpu_torch.core.config.schema import (
    DupSettings,
    PipelineSettings,
    RefineSettings,
    Settings,
    TaggerSettings,
)
from kobato_eyes_tpu_torch.core.config.service import load_settings, save_settings

__all__ = [
    "DupSettings",
    "PipelineSettings",
    "RefineSettings",
    "Settings",
    "TaggerSettings",
    "load_settings",
    "save_settings",
]
