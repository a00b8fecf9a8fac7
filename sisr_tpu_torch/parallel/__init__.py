"""Overlap-tiled inference."""
