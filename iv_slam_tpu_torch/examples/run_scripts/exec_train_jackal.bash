#!/bin/bash
# Train the introspection FCN on Jackal sessions (the reference's
# training/run_scripts/exec_train_modular_jackal.bash analogue), on the
# PyTorch/CUDA port. Extra flags (e.g. --device cpu) pass through.
cd "$(dirname "$0")/../../.." || exit 1
python -m iv_slam_tpu_torch.train \
  --data_root "${IVSLAM_DATA_ROOT:?set IVSLAM_DATA_ROOT}" \
  --raw_img_root "${IVSLAM_RAW_ROOT:?set IVSLAM_RAW_ROOT}" \
  --train_sessions 0 1 2 --val_sessions 3 \
  --num_epochs 20 --batch_size 8 --lr 0.02 --input_size 512 \
  --ckpt_dir checkpoints/jackal_mobilenetv2_c1deepsup "$@"
