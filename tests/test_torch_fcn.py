"""Port parity: the introspection FCN (iv_slam_tpu_torch.models) against
the JAX package's Flax model, on the CPU, at tests/test_fcn.py's sizes
(net input 64x64, image 96x128).

The Flax variables are a seeded init with seeded BatchNorm statistics and
a head re-centred so that the sharpened map spans the uint8 range (a
fresh init predicts ~0 everywhere, which sigmoid(20 (x - 0.5)) sends to 0);
``from_jax_variables`` carries them to the port. The two frameworks order
their convolution sums differently (XLA:CPU against oneDNN) and Flax and
torch BatchNorm associate differently, so float outputs are held to
atol/rtol 2e-4 on activations of order 1-10, and the uint8 cost map to 1
count (a value near a truncation step may land on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.models import convert_torch as jconvert
from iv_slam_tpu.models import introspection as jintro
from iv_slam_tpu.models import mobilenet as jmn
from iv_slam_tpu_torch import models as tmodels
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

NET_HW = (64, 64)


def seeded_variables(seed=0):
    """A Flax IntrospectionNet init (both heads) with seeded BatchNorm
    statistics and affine terms, as numpy."""
    net = jintro.IntrospectionNet()
    v = net.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + NET_HW + (3,)), train=True)
    v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    rng = np.random.default_rng(seed)

    def perturb(tree, kind):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                perturb(sub, kind)
            elif kind == "stats":
                tree[k] = (rng.uniform(0.5, 1.5, sub.shape) if k == "var"
                           else rng.normal(0, 0.2, sub.shape)).astype(np.float32)
            elif k in ("scale", "bias") and sub.ndim == 1:
                tree[k] = (sub + rng.normal(0, 0.1, sub.shape)).astype(np.float32)

    perturb(v["batch_stats"], "stats")
    perturb(v["params"], "params")
    return v


def centre_head(v, img):
    """Scale and shift conv_last so that the prediction on `img` has median
    0.5 and a 10-90% spread of 0.3 (the JAX model decides)."""
    x = jax.image.resize(jintro.normalize_image(jnp.asarray(img))[None],
                         (1,) + NET_HW + (3,), method="bilinear")
    pred = np.asarray(jintro.IntrospectionNet().apply(v, x, train=False))
    q10, q50, q90 = np.percentile(pred, [10, 50, 90])
    a = np.float32(0.3 / max(q90 - q10, 1e-6))
    head = v["params"]["decoder"]["conv_last"]
    head["kernel"] = (head["kernel"] * a).astype(np.float32)
    head["bias"] = (0.5 + (head["bias"] - q50) * a).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def model():
    img = np.random.default_rng(1).integers(0, 255, (96, 128, 3), dtype=np.uint8)
    v = centre_head(seeded_variables(), img)
    net = tmodels.IntrospectionNet()
    net.load_state_dict(tmodels.from_jax_variables(v))
    return v, net, img


def test_encoder_taps_and_prediction_match_flax(model):
    v, net, _ = model
    x = np.random.default_rng(2).normal(size=(2,) + NET_HW + (3,)).astype(np.float32)
    enc = {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}
    j_taps = jmn.MobileNetV2Dilated().apply(enc, jnp.asarray(x), train=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        t_taps = net.encoder(xt)
        t_pred = net(xt)
    assert [t.shape[1] for t in t_taps] == [24, 32, 64, 160, 320]
    for i, (a, b) in enumerate(zip(t_taps, j_taps)):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   atol=2e-4, rtol=2e-4, err_msg=f"tap {i}")
    j_pred = np.asarray(jintro.IntrospectionNet().apply(v, jnp.asarray(x), train=False))
    assert t_pred.shape == (2, 1, 8, 8)
    np.testing.assert_allclose(t_pred.permute(0, 2, 3, 1).numpy(), j_pred, atol=2e-4, rtol=2e-4)


def test_inference_cost_map_within_one_count(model):
    v, net, img = model
    j = np.asarray(jintro.inference_cost_map(jintro.IntrospectionNet(), v, jnp.asarray(img),
                                             out_hw=(96, 128), net_hw=NET_HW)).astype(int)
    t = tmodels.inference_cost_map(net, torch.from_numpy(img), (96, 128), NET_HW)
    assert t.dtype == torch.uint8 and t.shape == (96, 128)
    d = np.abs(t.numpy().astype(int) - j)
    share = float((d > 0).mean())
    print(f"cost map: {share:.4%} of pixels differ by 1; range {j.min()}-{j.max()}")
    assert d.max() <= 1 and share < 0.02
    assert len(np.unique(j)) > 100   # the head spans the uint8 range
    batched = tmodels.inference_cost_map(net, torch.from_numpy(np.stack([img, img])),
                                         (96, 128), NET_HW)
    assert torch.equal(batched[0], t) and torch.equal(batched[1], t)


def test_normalize_image_matches_jax():
    img = np.random.default_rng(4).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    img[0, 0] = 255
    want = np.asarray(jax.jit(jintro.normalize_image)(jnp.asarray(img)))
    got = tmodels.normalize_image(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0, 0], (1.0 - np.array([0.485, 0.456, 0.406]))
                               / np.array([0.229, 0.224, 0.225]), rtol=1e-5)


def test_upstream_state_dict_loads_like_convert_torch(tmp_path):
    """A random state dict under the upstream names goes through the JAX
    package's convert_torch into Flax, and through load_state_dict into the
    port (and from .pth snapshots through convert_checkpoint): the
    predictions agree."""
    rng = np.random.default_rng(5)
    ref = tmodels.IntrospectionNet()
    sd = {}
    for k, t in ref.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = t
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((rng.normal(size=t.shape)
                                      * (0.3 if t.ndim == 4 else 0.2)).astype(np.float32))
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    net = tmodels.IntrospectionNet()
    net.encoder.load_state_dict(enc)
    net.decoder.load_state_dict(dec)
    enc_p, enc_s = jconvert.convert_encoder({k: v.numpy() for k, v in enc.items()})
    dec_p, dec_s = jconvert.convert_decoder({k: v.numpy() for k, v in dec.items()})
    v = {"params": {"encoder": enc_p, "decoder": dec_p},
         "batch_stats": {"encoder": enc_s, "decoder": dec_s}}
    x = rng.normal(size=(1,) + NET_HW + (3,)).astype(np.float32)
    j = np.asarray(jintro.IntrospectionNet().apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        t = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, atol=2e-4 * scale, rtol=2e-4)
    torch.save(enc, str(tmp_path / "encoder.pth"))
    torch.save(dec, str(tmp_path / "decoder.pth"))
    snap = tmodels.convert_checkpoint(str(tmp_path / "encoder.pth"),
                                      str(tmp_path / "decoder.pth"))
    with torch.no_grad():
        assert torch.equal(snap(torch.from_numpy(x).permute(0, 3, 1, 2)),
                           net(torch.from_numpy(x).permute(0, 3, 1, 2)))
    # and the port's own loader reads what convert_torch writes back out
    back = tmodels.from_jax_variables(v)
    for k, want in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], want), k


def test_training_forward_matches_flax(model):
    """In training mode the network returns (pred, pred_deepsup) with
    batch statistics, as the JAX package's IntrospectionNet(train=True),
    and updates the running statistics as flax does (momentum 0.9, the
    biased variance); eval mode is left as it was."""
    v, _, _ = model
    net = tmodels.IntrospectionNet()
    net.load_state_dict(tmodels.from_jax_variables(v))
    x = np.random.default_rng(6).normal(size=(2,) + NET_HW + (3,)).astype(np.float32)
    (j_pred, j_aux), upd = jintro.IntrospectionNet().apply(v, jnp.asarray(x), train=True,
                                                          mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        t_pred, t_aux = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert t_pred.shape == t_aux.shape == (2, 1, 8, 8)
    for a, b in ((t_pred, j_pred), (t_aux, j_aux)):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   atol=2e-4 * scale, rtol=2e-4)
    want = tmodels.from_jax_variables({"params": v["params"], "batch_stats": upd["batch_stats"]})
    got = net.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    net.eval()
    with torch.no_grad():
        assert net(torch.from_numpy(x).permute(0, 3, 1, 2)).shape == (2, 1, 8, 8)
