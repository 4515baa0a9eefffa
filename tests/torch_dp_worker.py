"""Rank processes for tests/test_torch_parallel.py: each joins a gloo
group on the CPU, runs the port's data-parallel train step on its rows of
a batch and ShardedReplay on its share of the frames, and rank 0 writes
the results to an .npz file. Imports torch and the port only (a spawned
process starts from a fresh interpreter)."""

import numpy as np
import torch


def train_batch(seed=0, n=4, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    return dict(image=rng.normal(size=(n,) + hw + (3,)).astype(np.float32),
                target=rng.uniform(size=(n, hw[0] // 8, hw[1] // 8, 1)).astype(np.float32),
                mask=(rng.uniform(size=(n, hw[0] // 8, hw[1] // 8, 1)) > 0.3)
                .astype(np.float32))


def trained_state(dp=None, lr=0.02, seed=0):
    """One train step of a seeded flagship net on train_batch() -> (loss,
    mse, state dict as numpy)."""
    from iv_slam_tpu_torch.models import IntrospectionNet, set_process_group
    from iv_slam_tpu_torch.train import train_state as ts

    state = ts.create_train_state(IntrospectionNet(), seed, "cpu", lr_encoder=lr,
                                  lr_decoder=lr, max_iters=10)
    if dp is not None:
        set_process_group(state.model, torch.distributed.group.WORLD)
    m = ts.train_step(state, train_batch(), dp)
    return float(m["loss"]), float(m["mse"]), {k: v.numpy().copy() for k, v in
                                                state.model.state_dict().items()}


def replay_inputs():
    import synth_world
    from iv_slam_tpu_torch import config

    cfg = config.Config()
    cfg.camera = config.CameraConfig(fx=400, fy=400, cx=160, cy=120, bf=200, width=320,
                                     height=240)
    cfg.orb = config.ORBConfig(n_features=400, n_levels=3)
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(11), n_frames=5)
    return cfg, np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def vocabulary():
    from iv_slam_tpu_torch.slam.vocabulary import Vocabulary

    corpus = np.random.default_rng(3).integers(0, 256, (2000, 32)).astype(np.uint8)
    return Vocabulary.train(corpus, k=5, L=2, seed=1)


def rank_main(rank, world, port, out_path):
    import torch.distributed as dist

    from iv_slam_tpu_torch.parallel import mesh
    from iv_slam_tpu_torch.parallel.replay import ShardedReplay

    torch.set_num_threads(1)
    dp = mesh.init_data_parallel(rank, world, port, torch.device("cpu"))
    try:
        loss, mse, sd = trained_state(dp)
        cfg, lefts, rights = replay_inputs()
        recs = ShardedReplay(cfg, 240, 320, dp, vocabulary(), device="cpu").process_batch(
            lefts, rights)
        if rank == 0:
            out = {f"sd/{k}": v for k, v in sd.items()}
            out.update({f"rec{i}/{k}": v for i, r in enumerate(recs) for k, v in r.items()})
            np.savez(out_path, loss=loss, mse=mse, n_recs=len(recs), **out)
    finally:
        dist.destroy_process_group()
