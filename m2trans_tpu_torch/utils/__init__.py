"""Experiment utilities of the port."""
