"""Shared utilities: logging, device selection, registries, metrics."""
