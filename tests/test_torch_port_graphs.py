"""CUDA-graph replay of the serving request (``utils/graphs.py``).

On the CPU: which calls may go through the graphs (none there), what
drops them, and the device constants that a capture needs cached. On a
card (marked ``card``, skipped without one): a graphed request against
the eager functions in every bit, at the tiny preset and at PRN-50 480x640
with seeded weights; what a caller may rely on; the counters, and the
im2col kernels of replayed requests counted in a device trace. This file
imports no JAX, so that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_port_graphs.py --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

from planerecnet_tpu_torch import config
from planerecnet_tpu_torch.config import MEANS, STD
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.ops import dcn
from planerecnet_tpu_torch.ops.image import fast_base_transform
from planerecnet_tpu_torch.ops.postprocess import (flat_strides,
                                                   postprocess_batch,
                                                   stride_table)
from planerecnet_tpu_torch.runner import PlaneRecNetRunner
from planerecnet_tpu_torch.tools import parse_trace
from planerecnet_tpu_torch.utils import graphs

TINY = config.PlaneRecNet_tiny_config


def _counts():
    return {f"{who}.{k}": getattr(fn, k)
            for who, fn in (("forward", PlaneRecNet.forward),
                            ("postprocess", PlaneRecNetRunner.postprocess))
            for k in ("eager", "captures", "replays")}


def _frames(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, h, w, 3) * 255).astype(np.float32)
            for _ in range(n)]


# --- CPU ---------------------------------------------------------------

def test_rule_takes_inference_calls_on_a_card_only():
    torch.manual_seed(0)
    model = PlaneRecNet(TINY).eval()
    card = types.SimpleNamespace(is_cuda=True)
    with torch.no_grad():
        assert model.graphed(card)
        assert not model.graphed(card, spatial=object())
        assert not model.graphed(torch.zeros(1, 32, 32, 3))
        model.train()
        assert not model.graphed(card)
        model.eval()
    assert not model.graphed(card)


@pytest.mark.parametrize("case", ["eval", "autograd", "train"])
def test_cpu_calls_capture_nothing(case):
    torch.manual_seed(0)
    model = PlaneRecNet(TINY).train(case == "train")
    before = _counts()
    x = torch.randn(2, 64, 64, 3)
    with torch.set_grad_enabled(case == "autograd"):
        for _ in range(3):
            model(x)
    assert _counts() == before
    assert model.graphs.last is None and not model.graphs._slots


def test_cpu_runner_requests_capture_nothing():
    runner = PlaneRecNetRunner(TINY, device="cpu")
    before = _counts()
    for frame in _frames(3, 32, 32, seed=0):
        runner.infer(frame)
    assert _counts() == before


def test_submodule_hooks_and_dispatch_modes_keep_calls_eager():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Passing(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    model = PlaneRecNet(TINY).eval()
    assert graphs.usable(model)
    handle = model.backbone.register_forward_hook(lambda *a: None)
    assert not graphs.usable(model)
    handle.remove()
    assert graphs.usable(model)
    top = model.register_forward_hook(lambda *a: None)
    assert graphs.usable(model)      # called by Module.__call__
    top.remove()
    with Passing():
        assert not graphs.usable(model)


def _one_slot(model):
    counter = types.SimpleNamespace(eager=0, captures=0, replays=0)
    model.graphs.run((), lambda t: t + 1, (torch.zeros(2),), counter)
    assert len(model.graphs._slots) == 1 and counter.eager == 1


@pytest.mark.parametrize("change", ["train", "to", "assign", "in_place"])
def test_what_drops_the_graphs(change):
    model = PlaneRecNet(TINY).eval()
    _one_slot(model)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    if change == "train":
        model.train()
    elif change == "to":
        model.to(torch.float32)
    elif change == "assign":
        model.load_state_dict(state, assign=True)
    else:
        model.load_state_dict(state)
    assert bool(model.graphs._slots) == (change == "in_place")


def test_follow_is_eager_until_its_call_replays():
    g = graphs.Graphs()
    counter = types.SimpleNamespace(eager=0, captures=0, replays=0)
    assert g.follow((), lambda t: t * 2, torch.ones(2), counter).tolist() \
        == [2, 2]                          # no call went through the cache
    assert counter.eager == 0
    out = g.run((), lambda t: t + 1, (torch.zeros(2),), counter)
    assert g.follow((), lambda t: t * 2, out, counter).tolist() == [2, 2]
    assert counter.eager == 2 and len(g.last.followers._slots) == 1


def test_graphs_keep_the_most_recent_keys():
    g = graphs.Graphs()
    counter = types.SimpleNamespace(eager=0, captures=0, replays=0)
    for n in range(graphs.KEEP + 2):
        g.run((), lambda t: t, (torch.zeros(n + 1),), counter)
    assert len(g._slots) == graphs.KEEP and counter.eager == graphs.KEEP + 2
    assert [k[1][0][0] for k in g._slots] == [
        (n + 1,) for n in range(2, graphs.KEEP + 2)]


@pytest.mark.parametrize("name", sorted(config._CONFIGS))
def test_stride_table_equals_flat_strides(name):
    sv = config._CONFIGS[name].solov2
    for nl in range(1, len(sv.num_grids) + 1):
        grids = tuple(sv.num_grids[:nl])
        strides = tuple(sv.fpn_instance_strides[:nl])
        got = stride_table(grids, strides, torch.device("cpu"))
        assert torch.equal(got, torch.from_numpy(flat_strides(grids,
                                                              strides)))
        assert stride_table(grids, strides, torch.device("cpu")) is got


def test_fast_base_transform_bits_unchanged():
    x = torch.from_numpy(_frames(1, 24, 40, seed=3)[0])
    want = ((x.float() - torch.tensor(MEANS, dtype=torch.float32))
            / torch.tensor(STD, dtype=torch.float32)).flip(-1)
    assert torch.equal(fast_base_transform(x), want)
    assert torch.equal(fast_base_transform(x), want)   # the cached constants


# --- card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _seeded(model, seed):
    """Non-trivial weights: the DCN offset and modulator convs N(0, 0.01)
    (zero at init) and BatchNorm running statistics away from 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name or "modulator_conv" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.01)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.5)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=g) * 1.5)


def _low(cfg):
    """Thresholds low enough that seeded weights give detections."""
    return cfg.copy(dict(solov2=cfg.solov2.copy(dict(score_thr=0.003,
                                                     update_thr=0.003))))


def _eager(runner, frame):
    """The request without graphs: the model's body and the eager
    post-processing, as ``infer`` ran them before graphs."""
    with torch.no_grad():
        x = runner._batch(frame)
        raw = runner.model._forward(fast_base_transform(x))
        return raw, postprocess_batch(raw, runner.cfg, x.shape[1:3])


def _host(tree):
    return graphs._map(lambda t: t.detach().cpu(), tree)


def _same(a, b):
    la, lb = graphs._leaves(a, []), graphs._leaves(b, [])
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x.cpu(), y.cpu())


CASES = {"tiny": (TINY, 64, 64, 3), "prn50": (config.PlaneRecNet_50_config,
                                              480, 640, 13)}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_requests_equal_eager_in_every_bit(card, case, tmp_path):
    cfg, h, w, dcn_layers = CASES[case]
    runner = PlaneRecNetRunner(_low(cfg), seed=0, device=card)
    _seeded(runner.model, seed=1)
    frames = _frames(5, h, w, seed=2)
    want = [_host(_eager(runner, f)) for f in frames]
    seen = []
    hook = runner.model.register_forward_hook(
        lambda mod, inp, out: seen.append(out))
    before, launches = _counts(), dcn.deform_im2col.launches
    outs = []
    for f in frames:
        outs.append(runner.infer(f))
        torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _counts().items()}
    assert counts == {"forward.eager": 1, "forward.captures": 1,
                      "forward.replays": 3, "postprocess.eager": 1,
                      "postprocess.captures": 1, "postprocess.replays": 3}
    assert dcn.deform_im2col.launches - launches == dcn_layers * 5
    hook.remove()
    assert len(seen) == 5
    # The kernels the card ran for two more (replayed) requests, counted in
    # a device trace, and the launch counter's count of them.
    launches = dcn.deform_im2col.launches
    trace = parse_trace.record(lambda: [runner.infer(f) for f in frames[:2]],
                               1, str(tmp_path), "replays", card)
    assert parse_trace.calls_of(trace, "dcn_im2col_kernel") == dcn_layers * 2
    assert dcn.deform_im2col.launches - launches == dcn_layers * 2
    for (raw, post), got_raw, got in zip(want, seen, outs):
        _same(got_raw, raw)        # each request's own, not overwritten
        _same(got, post)
    assert any(int(p["pred_valid"].sum()) for _, p in want)


@pytest.mark.card
def test_forward_raw_and_model_outputs_are_not_overwritten(card):
    runner = PlaneRecNetRunner(TINY, seed=0, device=card)
    _seeded(runner.model, seed=1)
    frames = _frames(4, 64, 64, seed=5)
    kept = []
    for f in frames:
        out = runner.forward_raw(fast_base_transform(torch.from_numpy(f)))
        kept.append((out, _host(out)))
    assert runner.model.graphs.last.graph is not None
    for out, copy in kept:
        _same(out, copy)


@pytest.mark.card
def test_weights_loaded_after_capture_are_seen(card, tmp_path):
    runner = PlaneRecNetRunner(_low(TINY), seed=0, device=card)
    _seeded(runner.model, seed=1)
    frame = _frames(1, 64, 64, seed=7)[0]
    for _ in range(3):
        runner.infer(frame)
    assert runner.model.graphs.last.graph is not None
    path = runner.save_weights(str(tmp_path / "w.npz"))
    other = PlaneRecNetRunner(_low(TINY), seed=4, device=card)
    _seeded(other.model, seed=9)
    runner.model.load_state_dict(other.model.state_dict())
    replays = PlaneRecNet.forward.replays
    _same(runner.infer(frame), _eager(other, frame)[1])
    assert PlaneRecNet.forward.replays == replays + 1
    runner.load_weights(path)
    _, want = _eager(runner, frame)
    _same(runner.infer(frame), want)
    assert PlaneRecNet.forward.replays == replays + 2


@pytest.mark.card
def test_training_then_eval_recaptures(card):
    runner = PlaneRecNetRunner(_low(TINY), seed=0, device=card)
    _seeded(runner.model, seed=1)
    frame = _frames(1, 64, 64, seed=8)[0]
    for _ in range(3):
        runner.infer(frame)
    model = runner.model.train()
    assert not model.graphs._slots
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    x = fast_base_transform(runner._batch(frame))
    loss = sum(t.float().square().mean() for t in graphs._leaves(model(x),
                                                                  []))
    loss.backward()
    opt.step()
    model.eval()
    before = _counts()
    _, want = _eager(runner, frame)
    outs = [runner.infer(frame) for _ in range(3)]
    counts = {k: v - before[k] for k, v in _counts().items()}
    assert counts["forward.eager"] == counts["forward.captures"] == 1
    assert counts["forward.replays"] == 1
    for out in outs:
        _same(out, want)
