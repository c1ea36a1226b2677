"""The benchmark's plain reference: NumPy only, independent of the
program under test (see ``gpc``)."""
