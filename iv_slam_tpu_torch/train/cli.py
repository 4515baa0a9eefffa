"""Train the introspection FCN (training/train_modular.py equivalent).

  python -m iv_slam_tpu_torch.train \\
      --data_root <sessions with generated_training_data> \\
      --raw_img_root <raw session images> \\
      --train_sessions 0 1 2 --val_sessions 3 \\
      --ckpt_dir checkpoints/jackal_mobilenet_c1deepsup

The arguments of the JAX package's examples/train_introspection.py, and
the yacs tree's MODEL.arch_encoder / arch_decoder (config/defaults.py):
--arch_encoder resnet101dilated --arch_decoder ppm_deepsup --lr_decoder
0.002 trains PSPNet-101 from the model zoo (models/zoo.py; at the
decoder's default rate, --lr, its regression head diverges); the defaults
train the flagship MobileNetV2-dilated + C1-DeepSup. MODEL.fc_dim, the
decoder's input width, follows the encoder.
--multichip trains data-parallel, one process a rank (NCCL with a card
each, gloo otherwise); --ranks sets their number (default: the cards). On
the CPU: --device cpu [--multichip --ranks 2].
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.train")
    p.add_argument("--data_root", required=True)
    p.add_argument("--raw_img_root", required=True)
    p.add_argument("--train_sessions", type=int, nargs="+", required=True)
    p.add_argument("--val_sessions", type=int, nargs="*", default=[])
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.02,
                   help="TRAIN.lr_encoder, and lr_decoder unless --lr_decoder is given")
    p.add_argument("--lr_decoder", type=float, default=None, help="TRAIN.lr_decoder")
    p.add_argument("--input_size", type=int, default=512)
    p.add_argument("--arch_encoder", default="mobilenetv2dilated",
                   help="MODEL.arch_encoder: an encoder of models/zoo.py")
    p.add_argument("--arch_decoder", default="c1_deepsup",
                   help="MODEL.arch_decoder: a decoder of models/zoo.py")
    p.add_argument("--ckpt_dir", default="checkpoints/introspection")
    p.add_argument("--resume", default="")
    p.add_argument("--multichip", action="store_true",
                   help="train data-parallel over several processes, one a rank")
    p.add_argument("--ranks", type=int, default=0,
                   help="ranks of --multichip (default: the CUDA devices)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


def train_config(args):
    """The ``TrainConfig`` the parsed arguments ask for."""
    from .trainer import TrainConfig

    return TrainConfig(num_epochs=args.num_epochs, batch_size=args.batch_size,
                       lr_encoder=args.lr,
                       lr_decoder=args.lr if args.lr_decoder is None else args.lr_decoder,
                       input_hw=(args.input_size, args.input_size), ckpt_dir=args.ckpt_dir,
                       arch_encoder=args.arch_encoder, arch_decoder=args.arch_decoder)


def run(rank: int, world: int, port: int, args) -> None:
    """Train as `rank` of `world` (world 1: one process, no group)."""
    import torch.distributed as dist

    from ..parallel import mesh
    from .data import ImageQualityDataset
    from .trainer import Trainer

    device = mesh.rank_device(rank, world, args.device)
    dp = mesh.init_data_parallel(rank, world, port, device) if world > 1 else None
    try:
        cfg = train_config(args)
        trainer = Trainer(cfg, device=device, dp=dp)
        if args.resume:
            trainer.restore(args.resume)
        train_ds = ImageQualityDataset(args.data_root, args.raw_img_root, args.train_sessions,
                                       input_hw=cfg.input_hw)
        val_ds = (ImageQualityDataset(args.data_root, args.raw_img_root, args.val_sessions,
                                      input_hw=cfg.input_hw) if args.val_sessions else None)
        log = print if rank == 0 else (lambda *_: None)
        log(f"train samples: {len(train_ds)}" + (f", val: {len(val_ds)}" if val_ds else "")
            + f", {world} rank(s) on {device}")
        hist = trainer.train(train_ds, val_ds, log_fn=log)
        log(f"best val {hist.best_val:.4f} @ epoch {hist.best_epoch}")
    finally:
        if dp is not None:
            dist.destroy_process_group()


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.multichip:
        run(0, 1, 0, args)
        return
    import torch

    from ..parallel import mesh

    world = args.ranks or torch.cuda.device_count()
    if world < 1:
        raise SystemExit("--multichip: no CUDA device; pass --device cpu --ranks N")
    mesh.spawn(run, world, args)
