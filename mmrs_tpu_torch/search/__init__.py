"""Query engine, prototypes and threshold calibration."""
