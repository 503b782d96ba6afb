# Copied verbatim from gatk_tpu/align/__init__.py; only import lines may differ.
"""Host alignment (seed-and-extend; the BwaMemAligner-class capability)."""
