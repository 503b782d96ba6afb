# Copied verbatim from gatk_tpu/preprocessing/__init__.py; only import lines may differ.
"""Preprocessing: duplicate marking (+ future sorting/merging utilities)."""
