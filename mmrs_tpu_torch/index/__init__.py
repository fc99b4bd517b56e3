"""The on-disk embedding gallery."""
