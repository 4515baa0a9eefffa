"""iv_slam_tpu_torch — the PyTorch/CUDA port of iv_slam_tpu for NVIDIA Hopper.

The JAX package ``iv_slam_tpu`` stays beside this one, unchanged, as the
reference every piece of the port is held against. This package imports
torch, numpy, scipy and the standard library only; it never imports jax
or anything from ``iv_slam_tpu``.

Layout (mirrors the JAX package):
  config.py      copy of the dataclass config tree
  _kernels.py    nvcc build + ctypes loading of csrc/*.cu (first use), and
                 of the host C source csrc/png_unfilter.c
  csrc/          hand-written CUDA C++ kernels for sm_90a; the PNG row
                 unfilter (host C)
  numerics.py    float32 arithmetic that rounds alike on the CPU and the GPU
  geometry/      SE(3), Sim(3), camera projection
  ops/           image, pyramid, FAST, orientation, BRIEF, Hamming, stereo,
                 extractor (and its quadtree path, octtree.py); each kernel
                 has a ``*_cuda.py`` wrapper beside
                 its plain PyTorch version; projection matching and fuse,
                 the monocular initialization search, triangulation;
                 vocabulary-tree descent, BoW and Sim3 matching; the GP
                 heatmaps of training-data generation
  solvers/       pose LM, bundle adjustment (Schur LM, local, constrained
                 and global BA), the monocular H/F initializer, PnP and
                 Sim3 RANSAC, Sim3 LM, the essential graph
  slam/          Frame and the stereo, mono and RGB-D frontends, MapStore,
                 DeviceMap, the fused tracking step, LocalMapping,
                 Tracking, System, the vocabulary and keyframe database,
                 LoopClosing
  models/        the introspection FCN (MobileNetV2-dilated + C1-DeepSup)
                 for cost-map inference, and its weight loaders
  introspection/ training-data generation: feature scoring, unsupervised
                 quality labels, the dataset writer, the per-frame orchestrator
  train/, parallel/  FCN training; data-parallel training, replay, datagen
  io/            PNG and PFM codecs, dataset readers, rectification, the
                 decode-ahead loader, trajectory writers and metrics
  utils/         per-stage timers
  examples/      the dataset drivers (``python -m iv_slam_tpu_torch.examples.<name>``)

Device rule: functions follow the device of the tensors they are given. A
wrapper handed a CPU tensor runs the plain PyTorch version; handed a CUDA
tensor it launches its kernel or raises. Nothing falls back.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry/solver math is f32 and precision-sensitive, and the reference runs
# f32 matmuls at full precision (iv_slam_tpu/__init__.py). TF32 keeps ~3
# decimal digits, so turn it off for matmuls and cuDNN convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
