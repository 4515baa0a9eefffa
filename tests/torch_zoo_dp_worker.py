"""Rank processes for tests/test_torch_zoo_train.py: each joins a gloo group
of 4 on the CPU, trains its rows of every batch with the port's Trainer in
float64 (the flagship net at 32x32, 2 rows a rank), and rank 0 writes the
losses, its momentum after the first step and the weights and BatchNorm
statistics after the last to an .npz file. Imports torch, the port and
the benchmark's seeded weights only (a spawned process starts from a fresh
interpreter)."""

import numpy as np
import torch

WORLD = 4
ROWS = 2          # a rank's rows of every batch
HW = (32, 32)
STEPS = 2
SEED = 2147483701
RECIPE = dict(lr=0.02, momentum=0.9, weight_decay=1e-4, lr_pow=0.9, deep_sup_scale=0.4,
              num_epochs=20)


def arch():
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", "fcn_mnv2_c1ds_train.json")) as f:
        return json.load(f)["fcn"]


def batches():
    """STEPS global batches of WORLD * ROWS rows (NHWC float64)."""
    rng = np.random.default_rng(7)
    n, (h, w) = WORLD * ROWS, HW
    return [dict(image=rng.normal(size=(n, h, w, 3)),
                 target=rng.uniform(size=(n, h // 8, w // 8, 1)),
                 mask=(rng.uniform(size=(n, h // 8, w // 8, 1)) > 0.3).astype(np.float64))
            for _ in range(STEPS)]


def seeded_weights():
    from portbench.reference import fcn as ref
    from portbench.traffic import weights

    return {k: v.double() for k, v in weights.fcn_weights(
        ref.param_shapes(arch()), SEED, torch.device("cpu")).items()}


def rank_main(rank, world, port, local_bn, out_path):
    import torch.distributed as dist

    from iv_slam_tpu_torch.parallel import mesh
    from iv_slam_tpu_torch.train import trainer as trainer_mod

    torch.set_num_threads(1)
    if local_bn:                        # each rank's BatchNorms see its own rows only
        trainer_mod.set_process_group = lambda model, group: None
    dp = mesh.init_data_parallel(rank, world, port, torch.device("cpu"))
    try:
        rc = RECIPE
        trainer = trainer_mod.Trainer(trainer_mod.TrainConfig(
            num_epochs=rc["num_epochs"], batch_size=world * ROWS, lr_encoder=rc["lr"],
            lr_decoder=rc["lr"], momentum=rc["momentum"], weight_decay=rc["weight_decay"],
            lr_pow=rc["lr_pow"], deep_sup_scale=rc["deep_sup_scale"], input_hw=HW),
            device="cpu", dp=dp)
        net = trainer.net.double()
        w = seeded_weights()
        sd = net.state_dict()
        sd.update(w)
        net.load_state_dict(sd)
        losses = []
        for s, b in enumerate(batches()):
            losses.append(float(trainer.step(b)["loss"]))
            if s == 0:
                opt = trainer.state.optimizer
                update = {k: opt.state[p]["momentum_buffer"].numpy().copy()
                          for k, p in net.named_parameters()}
        if rank == 0:
            now = net.state_dict()
            np.savez(out_path, loss=np.asarray(losses),
                     **{f"update/{k}": v for k, v in update.items()},
                     **{f"params/{k}": now[k].numpy() for k in w})
    finally:
        dist.destroy_process_group()
