"""Serving runners of the port."""
