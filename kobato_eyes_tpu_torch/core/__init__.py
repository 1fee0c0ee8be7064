"""Core runtime: config, scanner, progress, index pipeline."""
