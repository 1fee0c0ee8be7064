"""Host-side async services (catalog writeback)."""
