"""Command-line entry points of the port (run with ``python -m``)."""
