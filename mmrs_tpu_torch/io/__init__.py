"""Image decoding and dataset enumeration (host side)."""
