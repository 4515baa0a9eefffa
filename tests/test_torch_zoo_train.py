"""The port's training path on a model-zoo pair and across ranks, against the
benchmark's plain references (portbench/reference/), on the CPU in float64
from the same seeded weights (made under the references' upstream names).

* PSPNet-101 (ResNet-101-dilated + PPM-DeepSup, every published width,
  fc_dim 2048) through ``Trainer.step``: one step at 64x64 and batch 2,
  then three steps at a shallow stage depth, each against
  ``reference/resnet_ppm.py`` given the program's own dropout masks
  (``drivers/train_zoo.MaskTap``); the same steps against the reference
  given every mask one channel off must fail. In float64 the two sides
  differ by summation order alone: measured 4e-15 on the loss, 2e-11 on
  a momentum leaf and 4e-11 on a statistic at 101 layers, held to 1e-9,
  1e-7 and 1e-7.
* The flagship data-parallel over 4 gloo ranks (tests/torch_zoo_dp_worker.py,
  2 rows a rank at 32x32) against ``reference/fcn.py`` on the whole global
  batch of 8: Sync-BN over the ranks is BatchNorm over all rows. With each
  rank's BatchNorms on its own rows the same comparison must fail.
* ``python -m iv_slam_tpu_torch.train``'s --arch_encoder, --arch_decoder and
  --lr_decoder reach ``TrainConfig``; the decoder's input width follows the
  encoder.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_zoo_dp_worker as dpw
from iv_slam_tpu_torch.models import zoo
from iv_slam_tpu_torch.train import cli
from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer, build_net
from portbench.drivers.train_zoo import MaskTap, port_key
from portbench.reference import fcn as fcn_ref
from portbench.reference import resnet_ppm as ref
from portbench.traffic import weights
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(ROOT, "portbench", "configs", "fcn_r101d_ppmds_train.json")))
SEED = 2147483701
LOSS_RTOL, LEAF_RTOL, STATS_RTOL = 1e-9, 1e-7, 1e-7


def _batches(n_steps, b=2, hw=(64, 64)):
    rng = np.random.default_rng(11)
    h, w = hw
    return [dict(image=rng.normal(size=(b, h, w, 3)),
                 target=rng.uniform(size=(b, h // 8, w // 8, 1)),
                 mask=(rng.uniform(size=(b, h // 8, w // 8, 1)) > 0.3).astype(np.float64))
            for _ in range(n_steps)]


def _nchw(batch):
    return tuple(torch.from_numpy(batch[k]).permute(0, 3, 1, 2)
                 for k in ("image", "target", "mask"))


def _leaf_gap(got, want):
    """The worst leaf's largest difference over the larger of the leaf's
    largest value and the median leaf's (a leaf whose gradient vanishes in
    theory, a bias before a BatchNorm, holds round-off alone)."""
    top = {k: float(want[k].abs().max()) for k in want}
    med = float(np.median(list(top.values())))
    return max(float((got[k] - want[k]).abs().max()) / max(top[k], med, 1e-300) for k in want)


def _zoo_steps(arch, n_steps):
    """The port's Trainer on the pair for n_steps in float64 from the seeded
    weights: (weights, losses, momentum after step 1 and the state after
    the last step under the upstream keys, the dropout masks a step)."""
    rc = CFG["recipe"]
    trainer = Trainer(TrainConfig(arch_encoder=arch["arch_encoder"],
                                  arch_decoder=arch["arch_decoder"], fc_dim=arch["fc_dim"],
                                  lr_encoder=rc["lr"], lr_decoder=rc["lr_decoder"]),
                      device="cpu")
    net = trainer.net.double()
    w = {k: v.double() for k, v in weights.fcn_weights(
        ref.param_shapes(arch), SEED, torch.device("cpu")).items()}
    keys = {k: port_key(k, arch["layers"]) for k in w}
    sd = net.state_dict()
    assert set(keys.values()) <= set(sd)
    sd.update({keys[k]: v for k, v in w.items()})
    net.load_state_dict(sd)
    params = dict(net.named_parameters())
    tap = MaskTap(net)
    losses = []
    for s, b in enumerate(_batches(n_steps)):
        losses.append(float(trainer.step(b)["loss"]))
        if s == 0:
            opt = trainer.state.optimizer
            update = {k: opt.state[params[keys[k]]]["momentum_buffer"].clone()
                      for k in w if not fcn_ref.is_buffer(k)}
    tap.close()
    now = net.state_dict()
    state = {k: now[keys[k]] for k in w}
    masks = [tap.masks[2 * s:2 * s + 2] for s in range(n_steps)]
    return w, losses, update, state, masks


def _compare(arch, n_steps, roll=0):
    """The port against the reference over n_steps: (loss gap, momentum gap,
    weights gap, statistics gap), the reference's masks rolled by `roll`
    channels."""
    w, losses, update, state, masks = _zoo_steps(arch, n_steps)
    masks = [[m.roll(roll, 1) for m in ms] for ms in masks]
    r = ref.train_steps(arch, CFG["recipe"], w, [_nchw(b) for b in _batches(n_steps)], masks)
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, r["loss"]))
    stats = [k for k in w if fcn_ref.is_buffer(k)]
    params = [k for k in w if not fcn_ref.is_buffer(k)]
    return (loss, _leaf_gap(update, r["update"]),
            _leaf_gap({k: state[k] for k in params}, {k: r["params"][k] for k in params}),
            _leaf_gap({k: state[k] for k in stats}, {k: r["params"][k] for k in stats}))


def _shallow(monkeypatch):
    """PSPNet with stage depths [1, 1, 2, 1]: the port's encoder built at
    that depth, the reference told so."""
    layers = [1, 1, 2, 1]
    monkeypatch.setattr(zoo, "build_encoder",
                        lambda name: zoo.ResNetEncoder(layers, "bottleneck", 8))
    return dict(CFG["fcn"], layers=layers)


def test_pspnet101_step_matches_the_reference():
    """Every width and all 101 layers: step 1's loss, the momentum SGD got
    and the BatchNorm statistics it left."""
    loss, upd, _, stats = _compare(CFG["fcn"], 1)
    print(f"PSPNet-101 one step: loss {loss:.3g}, momentum {upd:.3g}, statistics {stats:.3g}")
    assert loss <= LOSS_RTOL and upd <= LEAF_RTOL and stats <= STATS_RTOL


@pytest.mark.parametrize("masks", ["the_programs", "one_channel_off"])
def test_pspnet_shallow_three_steps(monkeypatch, masks):
    """Three steps at stage depths [1, 1, 2, 1]: every step's loss, the
    first momentum, the weights and statistics after the third. Given the
    masks one channel off, the reference must part from the program."""
    roll = 0 if masks == "the_programs" else 1
    gaps = _compare(_shallow(monkeypatch), 3, roll)
    print(f"shallow PSPNet, masks {masks}: loss, momentum, weights, statistics {gaps}")
    within = [g <= tol for g, tol in zip(gaps, (LOSS_RTOL, LEAF_RTOL, LEAF_RTOL, STATS_RTOL))]
    if roll == 0:
        assert all(within), gaps
    else:
        assert not any(within), gaps


def test_ppm_deepsup_drops_whole_channels_in_both_branches():
    """The PPM-DeepSup's two dropouts (the main head's, then the deep
    supervision's) each drop whole channels of a sample, about a tenth of
    them, counted over 20 forwards."""
    dec = zoo.build_decoder("ppm_deepsup", fc_dim=64).train()
    calls = []
    dec.dropout.register_forward_hook(lambda m, i, o: calls.append((i[0], o)))
    rng = np.random.default_rng(1)
    conv_out = [torch.from_numpy(rng.normal(size=(2, c, 6, 7)).astype(np.float32))
                for c in (8, 16, 32, 64)]
    torch.manual_seed(0)
    with torch.no_grad():
        for _ in range(20):
            dec(conv_out)
    assert len(calls) == 40 and calls[0][0].shape[1] == 512 and calls[1][0].shape[1] == 16
    for branch in (0, 1):
        dropped = live = 0
        for i, o in calls[branch::2]:
            nz = i != 0
            gone = (o == 0) & nz
            lit = nz.any((2, 3))
            assert torch.equal(gone.any((2, 3)), (gone.sum((2, 3)) == nz.sum((2, 3))) & lit)
            dropped += int((gone.any((2, 3)) & lit).sum())
            live += int(lit.sum())
        assert 0.05 < dropped / live < 0.15, (branch, dropped / live)


# --- 4 gloo ranks against the reference on the global batch -------------------


@pytest.fixture(scope="module", params=["sync_bn", "rank_local_bn"])
def four_ranks(request, tmp_path_factory):
    from iv_slam_tpu_torch.parallel import mesh

    out = str(tmp_path_factory.mktemp("dp4") / "rank0.npz")
    mesh.spawn(dpw.rank_main, dpw.WORLD, request.param == "rank_local_bn", out)
    with np.load(out) as z:
        return request.param, {k: torch.from_numpy(z[k]) for k in z.files}


def test_four_ranks_match_the_reference_on_the_global_batch(four_ranks):
    """Rank 0's losses, momentum after step 1 and weights and statistics
    after step 2 against the reference's steps on all 8 rows; with
    rank-local BatchNorm the losses part at once."""
    kind, got = four_ranks
    w = dpw.seeded_weights()
    feed = [_nchw(b) for b in dpw.batches()]
    r = fcn_ref.train_steps(dpw.arch(), dpw.RECIPE, w, feed)
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"].tolist(), r["loss"]))
    upd = _leaf_gap({k: got[f"update/{k}"] for k in r["update"]}, r["update"])
    state = _leaf_gap({k: got[f"params/{k}"] for k in w}, r["params"])
    print(f"4 ranks, {kind}: loss {loss:.3g}, momentum {upd:.3g}, state {state:.3g}")
    if kind == "sync_bn":
        assert loss <= LOSS_RTOL and upd <= LEAF_RTOL and state <= LEAF_RTOL
    else:
        assert loss > 1e-3 and upd > 1e-2


# --- the training entry point ---------------------------------------------------


DATA = ["--data_root", "d", "--raw_img_root", "r", "--train_sessions", "0"]


def test_cli_zoo_flags_reach_train_config():
    cfg = cli.train_config(cli.parse_args(DATA + [
        "--arch_encoder", "resnet101dilated", "--arch_decoder", "ppm_deepsup",
        "--lr_decoder", "0.002"]))
    assert (cfg.arch_encoder, cfg.arch_decoder) == ("resnet101dilated", "ppm_deepsup")
    assert (cfg.lr_encoder, cfg.lr_decoder) == (0.02, 0.002)
    net = build_net(cfg)
    assert isinstance(net, zoo.SegmentationModel)
    assert isinstance(net.decoder, zoo.PPM) and net.decoder.deep_sup
    assert net.decoder.ConvBNAct_0.Conv_0.in_channels == 2048 + 4 * 512   # fc_dim 2048
    assert net.decoder.ConvBNAct_1.Conv_0.in_channels == 1024
    assert sum(isinstance(m, zoo.Bottleneck) for m in net.encoder.modules()) == 33
    default = cli.train_config(cli.parse_args(DATA))
    assert (default.arch_encoder, default.arch_decoder, default.fc_dim) == (
        TrainConfig.arch_encoder, TrainConfig.arch_decoder, TrainConfig.fc_dim)
    assert default.lr_encoder == default.lr_decoder == 0.02
    assert type(build_net(default)).__name__ == "IntrospectionNet"
