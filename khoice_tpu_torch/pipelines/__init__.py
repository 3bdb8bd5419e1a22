"""Experiment drivers of the port (exp1 so far)."""
