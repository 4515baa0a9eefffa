"""Port parity: every model-zoo encoder (iv_slam_tpu_torch.models.zoo)
against the JAX package's, on the CPU, in eval mode at 32x32 inputs and
batch 2, with the Flax variables (BatchNorm statistics and affine terms
perturbed) carried across by ``models.from_jax_variables``. Every returned
map is held to 1e-5 relative to its largest magnitude (measured: 1.3e-6 at
most; tests/test_torch_model_zoo.py says why not closer).

mobilenetv2dilated is held in tests/test_torch_fcn.py (its taps). The
training forwards are not compared here: at 32x32 the plain encoders'
last maps are 1x1 with batch 2, where a BatchNorm over two values is
ill-conditioned in float32. resnet101, resnet101dilated, resnext101 and
hrnetv2 take more than 20 s each on the JAX side (Flax's op-by-op init;
under jit, minutes of compiling) and are marked slow, as
tests/test_model_zoo.py marks its deep cases.
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu.models import zoo as jzoo
from iv_slam_tpu_torch.models import from_jax_variables
from iv_slam_tpu_torch.models import zoo
from test_torch_model_zoo import X32, close, flax_run, nchw, nhwc
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ENCODERS = ["resnet18", "resnet18dilated", "resnet50", "resnet50dilated"] + [
    pytest.param(a, marks=pytest.mark.slow)
    for a in ("resnet101", "resnet101dilated", "resnext101", "hrnetv2")]


@pytest.mark.parametrize("arch", ENCODERS)
def test_encoder_eval_matches_jax(arch):
    v, want, _, _ = flax_run(jzoo.build_encoder(arch), X32, train=False)
    enc = zoo.build_encoder(arch).eval()
    enc.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = enc(nchw(X32))
    assert len(got) == len(want) == len(zoo.encoder_channels(arch))
    errs = [close(nhwc(g), w) for g, w in zip(got, want)]
    print(f"{arch}: eval max relative error {max(errs):.3g}")
    assert np.isfinite(errs).all()
