"""Shared utilities: device selection, matrix lookup, state carried over."""
