"""The zoo and data-parallel training cells on the port's CPU path at a tiny
size: each runs, meets the run contract and is correct, and comes out not
correct under the control and the planted faults; the counts and the
reference's keys against the port's network. ``train.fcn_b8_dp4`` is not a
cell of BENCHMARK.json yet (PERF.md §7: on four cards its samples a second
spread beyond half their bound); the tiny checkout registers it."""

import json
import os

import pytest
import torch

from portbench.tests.conftest import _merge, make_tiny, run_cell

R101, DP4 = "train.r101_ppmds_b8", "train.fcn_b8_dp4"
TINY = {
    "configs/fcn_r101d_ppmds_train.json": {"input_hw": [64, 64], "batch_size": 2},
    "configs/fcn_mnv2_c1ds_train.json": {"input_hw": [64, 64], "batch_size": 2},
    "workloads/train.r101_ppmds_b8.json": {"pool": 8, "warmup_steps": 4},
    "workloads/train.fcn_b8_dp4.json": {"pool": 16, "warmup_steps": 4},
}


DP4_CELL = dict(name=DP4, config="fcn_mnv2_c1ds_train", traffic="fcn_b8_dp4", chips=4,
                why="4 NCCL ranks, one card each, Sync-BN")
DP4_METRICS = ("train_samples_per_s", "mfu_pct.train", "device_idle_pct.train")
DP4_READER = dict(name="allreduce_device_ms.train_dp4", unit="ms", better="lower",
                  source="device_trace", layer="data parallel",
                  moves="train_samples_per_s", workloads=[DP4])


def _register_dp4(root):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(DP4_CELL)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in DP4_METRICS:
            m["workloads"].append(DP4)
    bench["per_layer"].append(DP4_READER)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny(tmp_path):
    root = make_tiny(str(tmp_path / "checkout"))
    _register_dp4(root)
    for rel, upd in TINY.items():
        path = os.path.join(root, "portbench", rel)
        with open(path) as f:
            d = json.load(f)
        _merge(d, upd)
        with open(path, "w") as f:
            json.dump(d, f)
    return root


def _spec(root, cell):
    from portbench.lib import spec

    return spec.cell_spec(cell, root, os.path.join(root, "portbench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [R101, DP4])
def test_cell_runs_and_is_correct(tiny, cell, trace):
    rc, line = run_cell(tiny, cell, seconds=0.5, trace=trace)
    assert rc == 0 and line["correct"], line and line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    bench = json.load(open(os.path.join(tiny, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind] if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) <= names
    assert line["device"]["count"] == (4 if cell == DP4 else 1)
    if not trace:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    else:
        assert line["device"]["busy_s"] > 0
    if cell == DP4:
        assert line["checks"]["rank_weight_gap"]["value"] == 0.0


def _not_correct(line):
    return line is not None and not line["correct"]


@pytest.mark.parametrize("fault", ["control", "mask_off", "decoder_rate", "no_deep_sup"])
def test_r101_faults_are_not_correct(tiny, monkeypatch, fault):
    from iv_slam_tpu_torch.train import train_state

    from portbench.reference import resnet_ppm

    # the driver is loaded afresh from the tiny checkout, the reference it
    # imports is this process's module: the faults are planted there
    orig = resnet_ppm.train_steps
    if fault == "control":              # the reference in TF32
        monkeypatch.setattr(resnet_ppm, "train_steps",
                            lambda *a, **kw: orig(*a, **dict(kw, precision="tf32")))
    elif fault == "mask_off":           # one channel of one mask kept, not dropped
        from portbench.calibrate_zoo import one_channel_off

        def off(arch, recipe, params, batches, masks, *a, **kw):
            return orig(arch, recipe, params, batches, one_channel_off(masks), *a, **kw)
        monkeypatch.setattr(resnet_ppm, "train_steps", off)
    elif fault == "decoder_rate":       # the decoder at the encoder's rate
        monkeypatch.setattr(resnet_ppm, "train_steps", lambda arch, recipe, *a, **kw: orig(
            arch, dict(recipe, lr_decoder=recipe["lr"]), *a, **kw))
    else:                               # the program drops the deep-supervision term
        monkeypatch.setattr(train_state, "deep_sup_loss",
                            lambda p, p_ds, t, m, scale, ms=None: (
                                train_state.masked_mse(p, t, m, ms),) * 2)
    rc, line = run_cell(tiny, R101, seconds=0.3)
    assert rc == 0 and _not_correct(line), line and line["checks"]


def test_dp4_control_and_rank_local_bn_are_not_correct(tiny):
    """The program's 4 gloo ranks within the limits; the reference in TF32
    and the ranks' BatchNorms without the group beyond them."""
    from portbench import calibrate_zoo

    sp = _spec(tiny, DP4)
    lim = sp["workload"]["limits"]
    torch.set_num_threads(2)
    got = calibrate_zoo.dp4(sp["config"], sp["workload"], 2147483701, torch.device("cpu"))

    def over(reading):
        return [k for k in lim if k in reading and reading[k] > lim[k]]

    assert not over(got["program"]), got["program"]
    assert over(got["control"]) and over(got["local_bn"]), got


def test_counts_and_keys():
    """1.686 TFLOP a 512x512 training sample (counted apart with forward
    hooks on the port's network: 562.0 GFLOP a training forward), 70.4 M
    parameters, and every reference key names a tensor of the port's
    network of the same shape, one to one."""
    from iv_slam_tpu_torch.models.zoo import SegmentationModel

    from portbench.counts import resnet_ppm as counts
    from portbench.drivers.train_zoo import port_key
    from portbench.reference import resnet_ppm as ref

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    arch = json.load(open(os.path.join(here, "configs", "fcn_r101d_ppmds_train.json")))["fcn"]
    assert abs(counts.train_sample_flops(arch, (512, 512)) / 1.686e12 - 1) < 0.01
    assert abs(counts.forward_flops(arch, (512, 512), True) / 562.0e9 - 1) < 0.001
    shapes = ref.param_shapes(arch)
    n_params = sum(torch.Size(s).numel() for k, s in shapes.items()
                   if not k.endswith(("running_mean", "running_var")))
    assert abs(n_params / 70.4e6 - 1) < 0.001
    sd = SegmentationModel("resnet101dilated", "ppm_deepsup").state_dict()
    mapped = {port_key(k, arch["layers"]): s for k, s in shapes.items()}
    assert len(mapped) == len(shapes)
    assert set(mapped) == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert all(tuple(sd[k].shape) == tuple(s) for k, s in mapped.items())
