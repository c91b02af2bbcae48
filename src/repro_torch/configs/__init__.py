"""Model configurations whose weights the port carries (widths only)."""
