#!/bin/bash
# Batch introspective inference over Jackal sessions (the reference's
# scripts/run_stereo_jackal_batch_inference.bash analogue), on the
# PyTorch/CUDA port. Extra flags (e.g. --device cpu) pass through.
cd "$(dirname "$0")/../../.." || exit 1
python -m iv_slam_tpu_torch.examples.run_batch --mode inference \
  --sessions_root "${IVSLAM_SESSIONS_ROOT:?set IVSLAM_SESSIONS_ROOT}" \
  --sessions ${IVSLAM_SESSIONS:-00000} \
  --settings settings/jackal_stereo.yaml \
  --introspection_model "${IVSLAM_FCN_CKPT:-}" \
  --out jackal_batch_out --dataset jackal "$@"
