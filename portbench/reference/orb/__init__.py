"""The ORB stereo frontend in plain PyTorch: pyramid, FAST, cell budgets
weighted by a cost map, IC angles, rBRIEF and stereo matching
(Frame.cc:89-230, ORBextractor.cc:880-1296). No custom kernel: each
per-frame image kernel is its plain formulation (plain_kernels.py)."""
