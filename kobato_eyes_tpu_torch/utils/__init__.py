"""L0 utilities: stdlib/PIL/numpy helpers with no torch dependency."""
