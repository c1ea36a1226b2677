"""Command-line entry points (analogs of the reference's samples/)."""
