"""Solvers: motion-only pose optimization, bundle adjustment, PnP and Sim3
estimation, the Sim3 LM and the essential graph."""
