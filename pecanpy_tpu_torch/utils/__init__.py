"""Utilities: the downstream evaluation protocol (``evaluate``)."""
