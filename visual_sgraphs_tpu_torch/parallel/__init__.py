"""Landmark-grouped Schur reduction (single device)."""
