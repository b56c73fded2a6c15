"""Plain references the benchmark judges the port against.

Plain PyTorch and NumPy only: nothing here imports the port, JAX or the
JAX package, and nothing takes a table the port derived (layout, hub
tables, counts, negative table, initial tables): each is worked out again
from the benchmark's own graph and the seed.
"""
