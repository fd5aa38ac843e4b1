"""Lie groups, pinhole cameras and trajectory alignment."""
