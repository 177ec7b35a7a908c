"""Application-level losses and metrics."""
