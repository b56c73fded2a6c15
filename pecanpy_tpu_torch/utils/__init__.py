"""Utilities: the downstream evaluation protocol (``evaluate``), SGNS
training checkpoints (``checkpoint``), CUDA-graph capture (``cudagraph``)
and the port's spans and counters (``trace``)."""
