"""The benchmark of the PyTorch/CUDA port (``iv_slam_tpu_torch``): one
command runs one cell once (``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``); cells, configurations, traffic
mixes and per-layer metrics are files found by name."""
