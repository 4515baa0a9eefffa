"""What the port's dataset drivers share: the --device flag, the
introspection model, and the SIGINT flush."""

from __future__ import annotations

import contextlib
import signal
import zipfile

import numpy as np
import torch

MODEL_HELP = ("introspection FCN: a checkpoint written by the port's "
              "train.trainer.Trainer.save, or a TorchScript file from "
              "models.export.export_inference (the JAX package's orbax "
              "checkpoints need orbax, which the port does not use)")


def add_device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a CUDA device the "
                        "driver raises unless given --device cpu")


def device_of(args) -> torch.device:
    """--device through the runtime's device rule: the default, cuda,
    raises when there is no CUDA device (no fallback)."""
    from ..slam import resolve_device

    return resolve_device(None if args.device == "cuda" else args.device, "--device")


def _is_torchscript(path: str) -> bool:
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def load_introspection(path: str, device: torch.device):
    """(net, net_hw, cost_fn): the IntrospectionNet of a Trainer.save
    checkpoint with its input size, or (None, None, cost_fn) for a
    TorchScript file. cost_fn maps an (H, W) grey or (H, W, 3) RGB uint8
    image to its (H, W) uint8 cost map on `device`."""
    from ..models.introspection import inference_cost_map

    def rgb_of(img):
        t = torch.as_tensor(np.asarray(img), device=device)
        return t[..., None].expand(-1, -1, 3) if t.ndim == 2 else t

    if _is_torchscript(path):
        from ..models.export import load_inference

        run = load_inference(path, device)
        return None, None, lambda img: run(rgb_of(img))
    from ..train.trainer import TrainConfig, build_net, load_snapshot

    cfg = TrainConfig()
    net = build_net(cfg).to(device)
    load_snapshot(net, path, device)
    net.eval()
    net_hw = tuple(cfg.input_hw)

    def cost_fn(img):
        rgb = rgb_of(img)
        return inference_cost_map(net, rgb, tuple(rgb.shape[:2]), net_hw)
    return net, net_hw, cost_fn


@contextlib.contextmanager
def flush_on_sigint():
    """Yields a list that gains an entry at the first SIGINT (the frame loop
    stops and the outputs are still written: the reference's handler calls
    ShutdownMinimal, stereo_kitti.cc:185-196); a second SIGINT takes the
    default action. The previous handler comes back on exit. Off the main
    thread no handler is installed."""
    interrupted = []

    def on_sigint(_sig, _frm):
        interrupted.append(True)
        signal.signal(signal.SIGINT, signal.SIG_DFL)

    try:
        prev = signal.signal(signal.SIGINT, on_sigint)
    except ValueError:   # not the main thread
        prev = None
    try:
        yield interrupted
    finally:
        if prev is not None:
            signal.signal(signal.SIGINT, prev)
