"""Trajectory output and error metrics."""
