"""The SLAM runtime: frames and the stereo frontend, the map and its device
mirror, the fused tracking step, local mapping, the vocabulary, keyframe
database and loop closing, tracking and System."""

import torch


def resolve_device(device, who: str) -> torch.device:
    """`device`, or the current CUDA device when it is None: the runtime's
    entry points run on the card unless the caller asks for the CPU (the
    tests do). Raises when CUDA is absent and no device was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
