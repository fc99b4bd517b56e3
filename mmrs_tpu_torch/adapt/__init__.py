"""Few-shot adaptation (Tip-Adapter / Tip-Adapter-F) and contrastive tower
training (mmrs_tpu/adapt)."""
