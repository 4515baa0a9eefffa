"""The plain reference the checks hold the system to: plain PyTorch and
NumPy, importing nothing of the system under test."""
