"""Preprocessing, leaf codes and the fused key kernel."""
