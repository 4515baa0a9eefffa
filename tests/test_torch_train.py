"""Port parity: the FCN's training recipe (iv_slam_tpu_torch.train.losses,
train_state, the training forward and models.layers.BatchNorm2d) against
the JAX package's, on the CPU, at 64x64 inputs and batch 2.

The JAX side's initial variables are carried across with
``models.from_jax_variables``; the JAX step is jitted on XLA:CPU.

Tolerances. The losses, the schedule and the optimizer's arithmetic are
held to float32 rounding. The train step is not: at a fresh init the
gradient of the flagship net is ill-conditioned in float32 (BatchNorms of
near-constant channels at 8x8 maps amplify rounding), so JAX's own jitted
step and the same step run op by op differ by 5.0e-4 in the parameters
after one step at lr 0.02 (0.0971 moved), and by 0.158 after three. The
port differs from the jitted step by 6.9e-4 to 7.9e-4 after one step
(XLA:CPU compiles the step a little differently from process to process).
So one step
is held at the recipe's learning rate (parameters within 2e-3, the loss
within 1e-5 relative, running means within 1e-5 and running variances
within 1e-4 relative), and three steps at lr 2e-4, where the trajectories
stay together (measured: the loss within 2.5e-4 relative, parameters
within 2.0e-4 of 2.6e-3 moved, running variances within 7.2e-4 relative;
held at 1e-3, 1e-3 and 5e-3). nn.BatchNorm2d's unbiased running variance
is 1/127 larger at 8x8 maps and batch 2, and fails the one-step check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from iv_slam_tpu.models import introspection as jintro
from iv_slam_tpu.train import losses as jlosses
from iv_slam_tpu.train import train_state as jts
from iv_slam_tpu_torch.models import IntrospectionNet, from_jax_variables, layers
from iv_slam_tpu_torch.train import losses as tlosses
from iv_slam_tpu_torch.train import train_state as tts
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

HW = (64, 64)


def jax_init(seed=0, hw=(16, 16)):
    """JAX's create_train_state variables, initialized under jit (equal to
    the eager init; the parameters do not depend on the dummy's size)."""
    net = jintro.IntrospectionNet()
    rng = jax.random.PRNGKey(seed)
    v = jax.jit(lambda r: net.init({"params": r, "dropout": jax.random.fold_in(r, 1)},
                                   jnp.zeros((1,) + hw + (3,), jnp.float32), train=True))(rng)
    return v["params"], v["batch_stats"]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(image=rng.normal(size=(2,) + HW + (3,)).astype(np.float32),
                 target=rng.uniform(size=(2, 8, 8, 1)).astype(np.float32),
                 mask=(rng.uniform(size=(2, 8, 8, 1)) > 0.2).astype(np.float32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def init():
    return jax_init()


def port_net(params, stats):
    net = IntrospectionNet()
    net.load_state_dict(from_jax_variables({"params": to_np(params), "batch_stats": to_np(stats)}))
    return net


@pytest.fixture(scope="module")
def jax_steps(init):
    """JAX's jitted train_step from the initial variables, n steps at lr
    (cached) -> (per-step (loss, mse), the final state as a port state
    dict)."""
    params, stats = init
    net = jintro.IntrospectionNet()
    cache = {}

    def run(n, lr):
        if (n, lr) not in cache:
            tx = jts.make_optimizer(lr, lr, max_iters=10)
            state = jts.TrainState(params, stats, tx.init(params), jnp.int32(0))
            step = jax.jit(lambda s, b: jts.train_step(s, b, net, tx))
            losses = []
            for b in batches(n):
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                losses.append((float(m["loss"]), float(m["mse"])))
            cache[(n, lr)] = losses, from_jax_variables(
                {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats)})
        return cache[(n, lr)]

    return run


def run_steps(init, jax_steps, n, lr):
    """n train steps of JAX and of the port from the same variables ->
    per-step losses of both and the final state dicts."""
    tnet = port_net(*init)
    opt, sched = tts.make_optimizer(tnet, lr, lr, max_iters=10)
    tstate = tts.TrainState(tnet, opt, sched)
    tl = []
    for b in batches(n):
        tm = tts.train_step(tstate, b)
        tl.append((float(tm["loss"]), float(tm["mse"])))
    jl, want = jax_steps(n, lr)
    return jl, tl, want, tnet.state_dict()


def compare(want, got):
    """(max parameter error, max running-mean error, max relative
    running-variance error)."""
    d_p = d_m = d_v = 0.0
    for k, w in want.items():
        g = got[k]
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var"):
            d_v = max(d_v, float(((g - w).abs() / w.abs().clamp(min=1e-3)).max()))
        elif k.endswith("running_mean"):
            d_m = max(d_m, float((g - w).abs().max()))
        else:
            d_p = max(d_p, float((g - w).abs().max()))
    return d_p, d_m, d_v


@pytest.mark.parametrize("mask_kind", ["ones", "partial", "zeros"])
def test_losses_match_jax(mask_kind):
    rng = np.random.default_rng(1)
    pred, aux, tgt = (rng.normal(size=(2, 8, 8, 1)).astype(np.float32) for _ in range(3))
    mask = {"ones": np.ones_like(pred), "zeros": np.zeros_like(pred),
            "partial": (rng.uniform(size=pred.shape) > 0.5).astype(np.float32)}[mask_kind]
    j_mse = float(jax.jit(jlosses.masked_mse)(pred, tgt, mask))
    j_loss, j_main = (float(v) for v in jax.jit(jlosses.deep_sup_loss)(pred, aux, tgt, mask))
    t = [torch.from_numpy(a) for a in (pred, aux, tgt, mask)]
    t_loss, t_main = tlosses.deep_sup_loss(*t)
    np.testing.assert_allclose(float(tlosses.masked_mse(t[0], t[2], t[3])), j_mse, rtol=1e-6)
    np.testing.assert_allclose([float(t_loss), float(t_main)], [j_loss, j_main], rtol=1e-6)


def test_poly_schedule_matches_optax():
    """The learning rate of every step, including the clip past max_iters:
    LambdaLR after k scheduler steps = optax's schedule at count k."""
    p = nn.Parameter(torch.zeros(2, 2))
    opt = torch.optim.SGD([p], lr=0.02, momentum=0.9)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, tts.poly_factor(10, 0.9))
    j = jts.poly_schedule(0.02, 10, 0.9)
    for count in range(14):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(j(count)), rtol=1e-6)
        np.testing.assert_allclose(tts.poly_schedule(0.02, 10)(count), float(j(count)),
                                   rtol=1e-6)
        opt.step()
        sched.step()


def test_param_groups_and_weight_decay_mask(init):
    """Four groups: encoder and decoder, each with and without decay; a
    tensor decays exactly when JAX's _wd_mask says so, and sits in the
    group JAX's label_fn gives it."""
    params, stats = init
    net = port_net(params, stats)
    groups = tts.param_groups(net, 0.02, 0.01, 1e-4)
    assert [g["name"] for g in groups] == ["encoder", "encoder_no_decay", "decoder",
                                           "decoder_no_decay"]
    where = {id(p): g for g in groups for p in g["params"]}
    assert len(where) == len(list(net.parameters()))
    # JAX's masks, mapped onto the port's names through the weight loader
    mask = from_jax_variables({"params": jax.tree.map(
        lambda p, m: np.full(p.shape, 1.0 if m else 0.0, np.float32), to_np(params),
        jts._wd_mask(params)), "batch_stats": to_np(stats)})
    for name, p in net.named_parameters():
        g = where[id(p)]
        assert g["name"].startswith("encoder" if name.startswith("encoder.") else "decoder")
        decays = bool(mask[name].max() > 0)
        assert (g["weight_decay"] == 1e-4) == decays == (p.ndim >= 2), name
        assert g["lr"] == (0.02 if g["name"].startswith("encoder") else 0.01)


def test_optimizer_matches_optax(init):
    """Given the same gradients, three updates of the four SGD groups equal
    optax's multi_transform chain (weight decay, momentum trace, poly lr)
    to float32 rounding."""
    params, stats = init
    net = port_net(params, stats)
    tx = jts.make_optimizer(0.02, 0.01, max_iters=4)
    opt, sched = tts.make_optimizer(net, 0.02, 0.01, max_iters=4)
    jp = params
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), to_np(jp))
        g_sd = from_jax_variables({"params": grads, "batch_stats": to_np(stats)})
        upd, jstate = update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in net.named_parameters():
            p.grad = g_sd[name].clone()
        opt.step()
        sched.step()
    want = from_jax_variables({"params": to_np(jp), "batch_stats": to_np(stats)})
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n_steps,lr", [(1, 0.02), (3, 2e-4)])
def test_train_step_matches_jax(init, jax_steps, n_steps, lr):
    jl, tl, want, got = run_steps(init, jax_steps, n_steps, lr)
    d_p, d_m, d_v = compare(want, got)
    print(f"{n_steps} step(s) at lr {lr}: losses JAX {jl} port {tl}; params {d_p:.3g}, "
          f"running means {d_m:.3g}, running variances {d_v:.3g} relative")
    if n_steps == 1:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert d_p <= 2e-3 and d_m <= 1e-5 and d_v <= 1e-4
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        assert d_p <= 1e-3 and d_m <= 1e-3 and d_v <= 5e-3


def test_unbiased_running_variance_fails_the_check(init, jax_steps, monkeypatch):
    """The BatchNorm trap: nn.BatchNorm2d (momentum 0.1, its unbiased
    running variance) in place of the port's flax statistics. At 8x8 maps
    and batch 2 its stored variance is 128/127 of flax's share, and the
    one-step comparison sees it; the forward and the loss do not change."""
    monkeypatch.setattr(layers.BatchNorm2d, "forward", nn.BatchNorm2d.forward)
    jl, tl, want, got = run_steps(init, jax_steps, 1, 0.02)
    d_p, d_m, d_v = compare(want, got)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert d_v > 1e-4, d_v


def test_training_forward_uses_batch_statistics(init):
    """In training mode a layers.BatchNorm2d normalizes with the biased
    batch variance E[x^2] - E[x]^2 and stores 0.9 old + 0.1 batch."""
    bn = layers.BatchNorm2d(3)
    bn.train()
    x = torch.from_numpy(np.random.default_rng(5).normal(2.0, 3.0, (2, 3, 8, 8))
                         .astype(np.float32))
    y = bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    mean = x.mean(dim=(0, 2, 3))
    want = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-6, atol=1e-6)
