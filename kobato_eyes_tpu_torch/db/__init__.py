"""Host catalog: durable SQLite metadata store."""

from kobato_eyes_tpu_torch.db.connection import bootstrap, connect, quiesced
from kobato_eyes_tpu_torch.db.schema import CURRENT_SCHEMA_VERSION, ensure_schema

__all__ = [
    "CURRENT_SCHEMA_VERSION",
    "bootstrap",
    "connect",
    "ensure_schema",
    "quiesced",
]
