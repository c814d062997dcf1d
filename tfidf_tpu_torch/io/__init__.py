"""Corpus discovery and packing."""
