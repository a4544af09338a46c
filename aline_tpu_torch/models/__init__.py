"""Embedder, encoder, heads and the Aline model."""
