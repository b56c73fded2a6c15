"""Multi-rank training: process groups, edge-partitioned walks, fused
walk + SGNS steps (counterpart of ``pecanpy_tpu/parallel``)."""
