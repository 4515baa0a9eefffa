#!/bin/bash
# Evaluate a trained FCN on held-out Jackal sessions (the reference's
# testing/run_scripts/exec_test_modular_jackal.bash analogue), on the
# PyTorch/CUDA port. Extra flags (e.g. --device cpu) pass through.
cd "$(dirname "$0")/../../.." || exit 1
python -m iv_slam_tpu_torch.examples.eval_introspection --mode eval \
  --ckpt checkpoints/jackal_mobilenetv2_c1deepsup/best \
  --data_root "${IVSLAM_DATA_ROOT:?set IVSLAM_DATA_ROOT}" \
  --raw_img_root "${IVSLAM_RAW_ROOT:?set IVSLAM_RAW_ROOT}" \
  --sessions 3 --out_dir fcn_eval "$@"
