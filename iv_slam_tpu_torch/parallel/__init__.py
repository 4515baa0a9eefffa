"""Multi-process data-parallel training, offline replay and training-data
generation on torch.distributed."""
