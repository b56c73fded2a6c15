"""Utilities: the downstream evaluation protocol (``evaluate``) and SGNS
training checkpoints (``checkpoint``)."""
