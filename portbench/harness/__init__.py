"""The port's benchmark harness: one cell, one run (``portbench/run.py``)."""
