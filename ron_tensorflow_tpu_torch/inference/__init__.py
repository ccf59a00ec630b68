"""Pixels-to-boxes detection heads."""
