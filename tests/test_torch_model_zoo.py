"""Port parity: the model zoo (iv_slam_tpu_torch.models.zoo) against the
JAX package's, on the CPU.

First the shape and structure cases of tests/test_model_zoo.py on the
port's modules (output strides, channel counts, deep-supervision tuples,
dilation surgery, encoder+decoder pairs). Then every encoder and decoder
against its Flax counterpart with the Flax variables carried across
(``models.from_jax_variables``): a Flax init with BatchNorm statistics and
affine terms perturbed, eval forwards (decoders on a 4-map pyramid of odd
sizes, 5x7 and 10x13), and training forwards for the decoders without
dropout, with the running statistics they leave. The two frameworks order
their convolution sums differently, so outputs are held to 1e-5 relative
to the output's largest magnitude (measured: 1.3e-6 at most). PPM's
training forward is compared in shape and dropout rate only (JAX draws its
masks from a PRNG key). The encoders are in test_torch_zoo_encoders.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.models import zoo as jzoo
from iv_slam_tpu_torch.models import from_jax_variables
from iv_slam_tpu_torch.models import zoo
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

X32 = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
REL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def fake_conv_out(fc_dim=64):
    """Stand-in encoder pyramid, channels fc_dim / 8, / 4, / 2, / 1; the
    first map 10x13, the rest 5x7 (NHWC numpy)."""
    rng = np.random.default_rng(1)
    chans = [fc_dim // 8, fc_dim // 4, fc_dim // 2, fc_dim]
    return [rng.normal(size=(2,) + ((10, 13) if i == 0 else (5, 7)) + (c,)).astype(np.float32)
            for i, c in enumerate(chans)]


def _perturb(v, seed=2):
    """BatchNorm statistics and affine terms drawn around the identity."""
    rng = np.random.default_rng(seed)

    def go(tree, kind):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                go(sub, kind)
            elif kind == "stats":
                tree[k] = (rng.uniform(0.5, 1.5, sub.shape) if k == "var"
                           else rng.normal(0, 0.2, sub.shape)).astype(np.float32)
            elif k in ("scale", "bias") and sub.ndim == 1:
                tree[k] = (sub + rng.normal(0, 0.1, sub.shape)).astype(np.float32)

    v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    go(v["batch_stats"], "stats")
    go(v["params"], "params")
    return v


def flax_run(mod, x, train):
    """Op by op (a jitted init of the deep encoders compiles for minutes):
    init with both heads, perturb, apply in eval mode and, when `train`, in
    training mode -> (variables, eval out, train out or None, the updated
    statistics or None) as numpy."""
    xj = jax.tree.map(jnp.asarray, x)
    v = _perturb(mod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                          xj, train=True))
    ev = mod.apply(v, xj, train=False)
    tr = upd = None
    if train:
        tr, upd = mod.apply(v, xj, train=True, mutable=["batch_stats"])
        upd = upd["batch_stats"]
    return jax.tree.map(np.asarray, (v, ev, tr, upd))


def close(got, want):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= REL * scale, (got.shape, want.shape, err, scale)
    return err / scale


# ---- shapes and structure (tests/test_model_zoo.py) -------------------------


@pytest.mark.parametrize("arch,stride,fc_dim", [("resnet18", 32, 512),
                                                ("resnet18dilated", 8, 512),
                                                ("resnet50dilated", 8, 2048),
                                                ("resnext101", 32, 2048)])
def test_resnet_family_shapes(arch, stride, fc_dim):
    enc = zoo.build_encoder(arch).eval()
    with torch.no_grad():
        feats = enc(nchw(X32[:1]))
    assert len(feats) == 4
    assert feats[-1].shape[1] == fc_dim == zoo.ENCODER_FC_DIM[arch]
    assert feats[-1].shape[2] == 32 // stride
    assert feats[0].shape[1] * 8 == feats[-1].shape[1]
    assert tuple(f.shape[1] for f in feats) == zoo.encoder_channels(arch)


def test_dilated_keeps_resolution():
    with torch.no_grad():
        plain = zoo.build_encoder("resnet18").eval()(nchw(X32[:1]))
        dil = zoo.build_encoder("resnet18dilated").eval()(nchw(X32[:1]))
    assert plain[-1].shape[2] == 1 and dil[-1].shape[2] == 4
    assert plain[0].shape == dil[0].shape and plain[1].shape == dil[1].shape


def test_decoder_shapes_and_deep_supervision():
    conv_out = [nchw(c) for c in fake_conv_out()]
    with torch.no_grad():
        assert zoo.build_decoder("c1", fc_dim=64).eval()(conv_out).shape == (2, 1, 5, 7)
        assert zoo.build_decoder("ppm", fc_dim=64).eval()(conv_out).shape == (2, 1, 5, 7)
        assert zoo.build_decoder("upernet_lite", fc_dim=64).eval()(conv_out).shape \
            == (2, 1, 10, 13)
        ds = zoo.build_decoder("ppm_deepsup", fc_dim=64).train()(conv_out)
    assert isinstance(ds, tuple) and ds[0].shape == ds[1].shape == (2, 1, 5, 7)
    assert zoo.build_decoder("upernet", fc_dim=64).fpn_dim == 512
    assert zoo.build_decoder("upernet_lite", fc_dim=64).fpn_dim == 256


@pytest.mark.parametrize("hw,out", [((6, 6), 2), ((5, 7), 3), ((7, 5), 6), ((1, 1), 6),
                                    ((13, 10), 6)])
def test_adaptive_avg_pool_matches_jax(hw, out):
    """torch's bin split, at odd and smaller-than-output sizes."""
    x = np.random.default_rng(2).normal(size=(2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jzoo.adaptive_avg_pool(jnp.asarray(x), out))
    np.testing.assert_allclose(nhwc(zoo.adaptive_avg_pool(nchw(x), out)), want,
                               rtol=1e-6, atol=1e-6)


def test_segmentation_classes_log_softmax():
    dec = zoo.build_decoder("c1", fc_dim=64, num_class=5, regression_mode=False).eval()
    with torch.no_grad():
        out = dec([nchw(c) for c in fake_conv_out()])
    assert out.shape[1] == 5
    torch.testing.assert_close(out.exp().sum(dim=1), torch.ones(2, 5, 7))


def test_segmentation_model_end_to_end_and_groups():
    model = zoo.SegmentationModel("resnet18dilated", "ppm_deepsup")
    assert not model.training
    with torch.no_grad():
        assert model(nchw(X32[:1])).shape == (1, 1, 4, 4)
        model.train()
        out = model(nchw(X32))
    assert isinstance(out, tuple) and out[0].shape == (2, 1, 4, 4)
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == {"encoder", "decoder"}


def test_builder_rejects_unknown():
    with pytest.raises(ValueError):
        zoo.build_encoder("vgg16")
    with pytest.raises(ValueError):
        zoo.build_decoder("fcn8s")


# ---- parity with the JAX package ---------------------------------------------


@pytest.mark.parametrize("arch", ["c1", "c1_deepsup", "upernet", "upernet_lite", "ppm",
                                  "ppm_deepsup"])
def test_decoder_matches_jax(arch):
    """Eval forward for every decoder; training forward and the running
    statistics it leaves for those without dropout."""
    conv_out = fake_conv_out()
    train = "ppm" not in arch
    v, want, want_tr, want_stats = flax_run(jzoo.build_decoder(arch, fc_dim=64), conv_out,
                                            train)
    dec = zoo.build_decoder(arch, fc_dim=64).eval()
    dec.load_state_dict(from_jax_variables(v))
    tin = [nchw(c) for c in conv_out]
    with torch.no_grad():
        close(nhwc(dec(tin)), want)
        dec.train()
        got_tr = dec(tin)
    got_tr = got_tr if isinstance(got_tr, tuple) else (got_tr,)
    if train:
        want_tr = want_tr if isinstance(want_tr, tuple) else (want_tr,)
        assert len(got_tr) == len(want_tr) == (2 if arch.endswith("deepsup") else 1)
        for g, w in zip(got_tr, want_tr):
            close(nhwc(g), w)
        stats = from_jax_variables({"params": v["params"], "batch_stats": want_stats})
        sd = dec.state_dict()
        for k, w in stats.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert len(got_tr) == (2 if arch == "ppm_deepsup" else 1)
        assert all(g.shape == (2, 1, 5, 7) for g in got_tr)


def test_ppm_training_dropout_rate():
    """PPM drops 10% of the channels before its class conv in training mode,
    each sample's channel whole (upstream's nn.Dropout2d(0.1); the JAX
    package's flax Dropout(0.1) drops single elements), none in eval mode.
    The rate is counted over 10 forwards (10,240 channel draws)."""
    dec = zoo.build_decoder("ppm", fc_dim=64)
    assert jzoo.build_decoder("ppm", fc_dim=64) is not None
    seen = {}
    dec.dropout.register_forward_hook(lambda m, i, o: seen.update(i=i[0], o=o))
    tin = [nchw(c) for c in fake_conv_out()]
    torch.manual_seed(0)
    dropped, live = 0, 0
    with torch.no_grad():
        dec.train()
        for _ in range(10):
            dec(tin)
            nz = seen["i"] != 0
            gone = (seen["o"] == 0) & nz
            lit = nz.any((2, 3))
            # a channel is dropped whole or kept whole
            assert torch.equal(gone.any((2, 3)), (gone.sum((2, 3)) == nz.sum((2, 3))) & lit)
            dropped += int((gone.any((2, 3)) & lit).sum())
            live += int(lit.sum())
        dec.eval()(tin)
        assert torch.equal(seen["o"], seen["i"])
    assert abs(dropped / live - 0.1) < 0.01, dropped / live
    assert dec.dropout.p == 0.1
