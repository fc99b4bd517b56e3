"""Tower configurations, layers, towers, checkpoints and tokenizers."""
