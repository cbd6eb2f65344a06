"""Command-line entry points (offline decode)."""
