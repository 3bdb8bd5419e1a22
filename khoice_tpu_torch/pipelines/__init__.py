"""Experiment drivers of the port: exp0 (host only) and exp1-4."""
