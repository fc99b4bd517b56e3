"""The `mmrs-torch` command line."""
