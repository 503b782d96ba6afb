# Copied verbatim from gatk_tpu/vareval/__init__.py; only import lines may differ.
"""VariantEval stratifier x evaluator framework
(tools/walkers/varianteval/ equivalent)."""
