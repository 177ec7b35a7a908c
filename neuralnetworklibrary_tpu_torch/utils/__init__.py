"""Helpers around the port's modules."""
