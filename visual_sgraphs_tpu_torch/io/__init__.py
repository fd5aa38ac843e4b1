"""Synthetic RGB-D sequences."""
