"""SE(3), Sim(3) and camera projection math on torch tensors."""
