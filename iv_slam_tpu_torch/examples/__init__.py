"""The dataset drivers of the port: ``python -m
iv_slam_tpu_torch.examples.<name>`` for run_stereo, run_mono, run_rgbd,
run_stream, run_batch, evaluate_batch and eval_introspection, each also
callable in process as ``main(argv)``."""
