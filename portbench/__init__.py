"""The port's benchmark: one command, cells found by name (harness.py)."""
