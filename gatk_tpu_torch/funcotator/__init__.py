# Copied verbatim from gatk_tpu/funcotator/__init__.py; only import lines may differ.
"""Funcotator: functional annotation against GENCODE datasources."""
