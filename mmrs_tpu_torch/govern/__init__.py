"""Data governance: dedup, leakage, format normalization, manifests, VQA
datasets (counterpart of mmrs_tpu/govern)."""
