"""Data loading."""
