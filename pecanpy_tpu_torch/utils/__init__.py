"""Utilities: the downstream evaluation protocol (``evaluate``), SGNS
training checkpoints (``checkpoint``) and the port's spans and counters
(``trace``)."""
