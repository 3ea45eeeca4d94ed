"""Diagnostic scripts of the port, run with `python -m` from the repository
root."""
