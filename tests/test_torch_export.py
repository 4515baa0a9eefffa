"""The TorchScript export of the cost-map inference
(iv_slam_tpu_torch.models.export) on the CPU: the loaded module's uint8
cost map equals the eager ``inference_cost_map`` bit for bit, at the
image and net sizes of tests/test_torch_fcn.py, for the weights that
training writes (the flagship net after a training step, BatchNorm
statistics included). The JAX package exports StableHLO instead, so the
file itself has no JAX counterpart; its cost map is held against JAX's
through the eager map in tests/test_torch_fcn.py.
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch.models import IntrospectionNet, flax_init_, inference_cost_map, predict
from iv_slam_tpu_torch.models.export import export_inference, load_inference
from iv_slam_tpu_torch.train import train_state as tts
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

NET_HW, OUT_HW = (64, 64), (96, 128)


@pytest.fixture(scope="module")
def trained():
    """The flagship net after one train step, its head centred so that the
    sharpened map spans the uint8 range."""
    net = flax_init_(IntrospectionNet(), torch.Generator().manual_seed(3))
    state = tts.TrainState(net, *tts.make_optimizer(net, max_iters=10))
    rng = np.random.default_rng(0)
    tts.train_step(state, dict(image=rng.normal(size=(2,) + NET_HW + (3,)).astype(np.float32),
                               target=rng.uniform(size=(2, 8, 8, 1)).astype(np.float32),
                               mask=np.ones((2, 8, 8, 1), np.float32)))
    net.eval()
    img = torch.from_numpy(rng.integers(0, 256, OUT_HW + (3,), dtype=np.uint8))
    with torch.no_grad():
        pred = predict(net, img[None], NET_HW)
        q10, q50, q90 = np.percentile(pred.numpy(), [10, 50, 90])
        a = 0.3 / max(q90 - q10, 1e-6)
        net.decoder.conv_last.weight.mul_(a)
        net.decoder.conv_last.bias.copy_(0.5 + (net.decoder.conv_last.bias - q50) * a)
    return net, img


def test_exported_cost_map_equals_eager(trained, tmp_path):
    net, img = trained
    path = str(tmp_path / "sub" / "introspection.pt")
    blob = export_inference(net, path, OUT_HW, NET_HW)
    assert len(blob) > 1 << 20 and open(path, "rb").read() == blob
    run = load_inference(path, device="cpu")
    got = run(img)
    want = inference_cost_map(net, img, OUT_HW, NET_HW)
    assert got.dtype == torch.uint8 and got.shape == OUT_HW
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 100       # the map spans the range
    # the file is plain TorchScript: torch.jit.load reads it without the port
    mod = torch.jit.load(path, map_location="cpu")
    with torch.no_grad():
        assert torch.equal(mod(img), want)
    # a second image through the same graph (weights are constants in it)
    img2 = torch.flip(img, dims=[1]).contiguous()
    assert torch.equal(run(img2), inference_cost_map(net, img2, OUT_HW, NET_HW))


def test_load_inference_needs_a_device_without_cuda(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without CUDA")
    net, _ = trained
    path = str(tmp_path / "m.pt")
    export_inference(net, path, OUT_HW, NET_HW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_inference(path)
