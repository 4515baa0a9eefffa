"""Offline FCN evaluation (testing/{test_modular,inference_modular,
eval_model_outputs}.py equivalents).

Port of the JAX package's ``examples/eval_introspection.py``. Modes:
  inference: run the FCN over session images, write predicted cost maps
      (+ optional overlays) in each image's own format, PNG or JPEG (at
      imageio's default JPEG quality, 75) — inference_modular.py;
  eval: masked-MSE against generated heatmaps on held-out sessions —
      test_modular.py;
  retention: sort keypoints by predicted cost and report mean ground-truth
      epipolar error vs retained fraction — the "retained-data" curves of
      eval_model_outputs.py:48-60.
The same flags, plus --device (cuda unless cpu is asked for); --ckpt is a
checkpoint of the port's Trainer.save or a TorchScript file.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import common


def _write_jpeg(path, img):
    from ..io.jpeg import write_jpeg

    write_jpeg(path, img, quality=75)      # imageio's (PIL's) default quality


def _write_png(path, img):
    from ..io.png import write_png

    write_png(path, img)


WRITERS = {".png": _write_png, ".jpg": _write_jpeg, ".jpeg": _write_jpeg}


def main(argv=None):
    """Run the mode; returns its report (inference: the names written)."""
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.eval_introspection")
    p.add_argument("--mode", choices=["inference", "eval", "retention"], required=True)
    p.add_argument("--ckpt", required=True, help=common.MODEL_HELP)
    p.add_argument("--data_root", default="")
    p.add_argument("--raw_img_root", default="")
    p.add_argument("--sessions", type=int, nargs="*", default=[])
    p.add_argument("--img_dir", default="", help="inference-mode input dir")
    p.add_argument("--out_dir", default="fcn_out")
    p.add_argument("--save_overlays", action="store_true")
    p.add_argument("--keypoints_json", default="",
                   help="retention mode: keypoints.json from datagen")
    common.add_device_flag(p)
    args = p.parse_args(argv)
    device = common.device_of(args)

    if args.mode == "inference":
        from ..io.datasets import read_image

        names = sorted(os.listdir(args.img_dir))
        bad = [n for n in names if os.path.splitext(n)[1].lower() not in WRITERS]
        if bad:
            raise ValueError(f"{bad[0]}: only PNG and JPEG images are read and written")
        _, _, cost_fn = common.load_introspection(args.ckpt, device)
        os.makedirs(args.out_dir, exist_ok=True)
        for name in names:
            img = read_image(os.path.join(args.img_dir, name))
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            img = np.ascontiguousarray(img[..., :3])
            cost = cost_fn(img).cpu().numpy()
            write = WRITERS[os.path.splitext(name)[1].lower()]
            write(os.path.join(args.out_dir, name), cost)
            if args.save_overlays:
                overlay = (0.6 * img[..., 0] + 0.4 * cost).astype(np.uint8)
                write(os.path.join(args.out_dir, "overlay_" + name), overlay)
        print(f"wrote {len(names)} cost maps to {args.out_dir}")
        return names

    net, _, _ = common.load_introspection(args.ckpt, device)
    if net is None:
        raise ValueError("--mode eval/retention needs a Trainer checkpoint, not TorchScript")
    if args.mode == "eval":
        from ..train.data import ImageQualityDataset
        from ..train.train_state import eval_loss

        ds = ImageQualityDataset(args.data_root, args.raw_img_root, args.sessions)
        losses = [float(eval_loss(net, b))
                  for b in ds.batches(1, np.random.default_rng(0), shuffle=False)]
        report = dict(masked_mse=float(np.mean(losses)), n=len(losses))
        print(json.dumps(report))
        return report

    # retention curves (eval_model_outputs.py:48-60)
    from ..train.data import ImageQualityDatasetPP, retention_curve

    ds = ImageQualityDatasetPP(args.data_root, args.raw_img_root, args.sessions,
                               network_output_root=args.img_dir)
    costs, errs = [], []
    for i in range(len(ds)):
        s = ds[i]
        xi = np.clip(s.keypt_xy[:, 0].astype(int), 0, s.network_output.shape[1] - 1)
        yi = np.clip(s.keypt_xy[:, 1].astype(int), 0, s.network_output.shape[0] - 1)
        costs.append(s.network_output[yi, xi, 0].astype(np.float32))
        errs.append(s.keypt_epipolar_err)
    curve = retention_curve(np.concatenate(costs), np.concatenate(errs))
    print(json.dumps(curve, indent=2))
    return curve


if __name__ == "__main__":
    main()
