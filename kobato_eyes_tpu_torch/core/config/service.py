"""YAML load/save for Settings with graceful fallback.

Counterpart of the reference's ``src/core/config/service.py:31-68`` (load with
fallback to defaults on parse failure; atomic save).
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path

import yaml

from kobato_eyes_tpu_torch.core.config.schema import Settings

logger = logging.getLogger(__name__)


def load_settings(path: str | Path | None) -> Settings:
    """Load settings from YAML; any failure yields defaults (never raises)."""
    if path is None:
        return Settings()
    p = Path(path)
    if not p.exists():
        return Settings()
    try:
        raw = yaml.safe_load(p.read_text(encoding="utf-8")) or {}
        return Settings.model_validate(raw)
    except Exception as exc:
        # Failure policy: a corrupt config file must not block startup;
        # fall back to defaults and log (reference service.py:41-53).
        logger.warning("failed to load settings from %s: %s; using defaults", p, exc)
        return Settings()


def apply_env_overrides(settings: Settings) -> Settings:
    """Apply KET_* environment tuning flags over loaded settings.

    The escape-hatch tier of the reference's config system (its ~25 KE_*/
    KOE_* flags, SURVEY §5 config): env beats file, file beats defaults.
    """
    import os

    from kobato_eyes_tpu_torch.utils.env import positive_or_none, safe_float, safe_int

    env = os.environ
    p = settings.pipeline
    updates: dict[str, object] = {}
    if (v := safe_int(env.get("KET_BATCH_SIZE"))) is not None:
        updates["batch_size"] = v
    if (v := safe_int(env.get("KET_PREFETCH_DEPTH"))) is not None:
        updates["prefetch_depth"] = v
    if (v := safe_int(env.get("KET_IO_WORKERS"))) is not None:
        updates["io_workers"] = v
    if env.get("KET_TAGGER_INPUT_CACHE") is not None:
        updates["tagger_input_cache"] = env["KET_TAGGER_INPUT_CACHE"].strip().lower() in (
            "1", "true", "yes", "on"
        )
    if updates:
        settings.pipeline = p.model_copy(update=updates)

    d = settings.dup
    dup_updates: dict[str, object] = {}
    if (v := safe_int(env.get("KET_HAMMING_THRESHOLD"))) is not None:
        dup_updates["hamming_threshold"] = v
    if "KET_DUP_BUCKET_PAIR_CAP" in env:
        dup_updates["bucket_pair_cap"] = positive_or_none(env["KET_DUP_BUCKET_PAIR_CAP"])
    if (v := safe_float(env.get("KET_DUP_SIZE_RATIO"))) is not None:
        dup_updates["size_ratio"] = v
    if dup_updates:
        settings.dup = d.model_copy(update=dup_updates)

    if (v := safe_float(env.get("KET_TAG_SCORE_FLOOR"))) is not None:
        settings.tagger = settings.tagger.model_copy(update={"score_floor": v})
    return settings


def save_settings(settings: Settings, path: str | Path) -> None:
    """Atomically persist settings as YAML."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    data = settings.model_dump(mode="json")
    fd, tmp = tempfile.mkstemp(dir=p.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            yaml.safe_dump(data, fh, sort_keys=False, allow_unicode=True)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
