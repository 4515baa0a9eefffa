"""Solvers: motion-only pose optimization."""
