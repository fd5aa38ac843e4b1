"""Analytic windowed bundle adjustment."""
