# Copied verbatim from gatk_tpu/vqsr/__init__.py; only import lines may differ.
"""VQSR: variant quality score recalibration (GMM over annotation vectors)."""
