"""CPU tests of ``benchmark/spans.py``: the attribution of a hand-built
trace, counted by hand, and the two passes over the tiny preset."""

from __future__ import annotations

import pytest

from benchmark import spans

NAMES = {"trainer.step", "trainer.forward", "trainer.backward",
         "backbone.recompute", "trainer.apply_grads", "trainer.finite_read"}


def _x(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """Two steps. Main thread (tid 1): step [0, 92] over forward [5, 40]
    and backward [45, 88]; step [98, 150] over apply_grads [115, 145]
    over finite_read [120, 140]. The autograd thread (tid 2): recompute
    [50, 70], inside the backward. Launches (call -> device event):
    forward: kernel [12, 22], memcpy [31, 35]; recompute: kernel [56, 76];
    the backward's own, from tid 2 outside the recompute: kernel [80, 85],
    and from tid 1 while tid 2 is in the recompute: kernel [86, 87];
    between the steps (call at 95): kernel [103, 105]; apply_grads:
    kernel [117, 120]; finite_read: memset [126, 128]; and a kernel [140,
    141] with no launching call."""
    ua = "user_annotation"
    return [
        _x(ua, "trainer.step", 0, 92), _x(ua, "trainer.forward", 5, 35),
        _x(ua, "trainer.backward", 45, 43),
        _x(ua, "backbone.recompute", 50, 20, tid=2),
        _x(ua, "trainer.step", 98, 52), _x(ua, "trainer.apply_grads", 115, 30),
        _x(ua, "trainer.finite_read", 120, 20),
        _x(ua, "Optimizer.step#Adam.step", 116, 3),       # not the program's
        _x("cpu_op", "aten::conv", 6, 30),
        _x("gpu_user_annotation", "trainer.forward", 12, 23, pid=0),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        _x("kernel", "k1", 12, 10, corr=1, pid=0),
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 1, corr=4),
        _x("gpu_memcpy", "Memcpy HtoD", 31, 4, corr=4, pid=0),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 1, tid=2, corr=2),
        _x("kernel", "k2", 56, 20, corr=2, pid=0),
        _x("cuda_driver", "cuLaunchKernel", 79, 1, tid=2, corr=3),
        _x("kernel", "k3", 80, 5, corr=3, pid=0),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=8),
        _x("kernel", "k8", 86, 1, corr=8, pid=0),
        _x("cuda_runtime", "cudaLaunchKernel", 95, 1, corr=7),
        _x("kernel", "k7", 103, 2, corr=7, pid=0),
        _x("cuda_runtime", "cudaLaunchKernel", 116, 1, corr=5),
        _x("kernel", "k5", 117, 3, corr=5, pid=0),
        _x("cuda_runtime", "cudaMemsetAsync", 125, 1, corr=6),
        _x("gpu_memset", "Memset", 126, 2, corr=6, pid=0),
        _x("cuda_runtime", "cudaStreamSynchronize", 130, 5),
        _x("kernel", "orphan", 140, 1, corr=99, pid=0),
    ]


def test_attribution_by_hand():
    t = spans.attribute(_trace(), NAMES)
    ms = 1e-3 / 2                       # microseconds over 2 units, in ms
    assert t["units"] == 2
    want = {  # name: (parent, wall, device, self device, idle, self idle)
        "trainer.step": (None, 144, 45, 0, 86, 21),
        "trainer.forward": ("trainer.step", 35, 14, 14, 21, 21),
        "trainer.backward": ("trainer.step", 43, 26, 6, 26, 26),
        "backbone.recompute": ("trainer.backward", 20, 20, 20, 0, 0),
        "trainer.apply_grads": ("trainer.step", 30, 5, 3, 18, 0),
        "trainer.finite_read": ("trainer.apply_grads", 20, 2, 2, 18, 18),
    }                                   # in us
    assert set(t["spans"]) == set(want)
    for name, (parent, wall, dev, self_dev, idle, self_idle) in want.items():
        row = t["spans"][name]
        assert row["parent"] == parent, name
        assert row["wall_ms"] == pytest.approx(wall * ms), name
        assert row["device_ms"] == pytest.approx(dev * ms), name
        assert row["self_device_ms"] == pytest.approx(self_dev * ms), name
        assert row["idle_ms"] == pytest.approx(idle * ms), name
        assert row["self_idle_ms"] == pytest.approx(self_idle * ms), name
    assert t["outside"]["device_ms"] == pytest.approx(3 * ms)   # k7, orphan
    assert t["outside"]["idle_ms"] == pytest.approx(16 * ms)    # [87, 103]
    assert t["device_ms"] == pytest.approx(48 * ms)
    assert t["idle_ms"] == pytest.approx(102 * ms)
    assert t["unmatched"] == 1
    assert t["launch_calls"] == 3.5     # 7 launch/copy/memset calls, 2 roots
    cov = spans.coverage(t, "trainer.step")
    assert cov["root_children_device"] == pytest.approx(1.0)
    assert cov["idle_in_spans"] == pytest.approx(86 / 102)
    # Paced, of each span's own time: the lesser of its profiled idle and
    # its host ms less the busy time inside (own wall less own idle).
    # The backward: own wall 43 - 20, idle 26, so busy 0: its host 10.
    # The finiteness read: the host waits 30, longer than its wall 20, on
    # a device busy 20 - 18: its profiled 18. apply_grads' own: wall 30 -
    # 20, idle 0: 0. The step: the sum, 28 us.
    spans.merge(t, {"trainer.apply_grads": {"host_ms": 40 * ms,
                                            "self_host_ms": 10 * ms},
                    "trainer.finite_read": {"host_ms": 30 * ms,
                                            "self_host_ms": 30 * ms},
                    "trainer.backward": {"host_ms": 10 * ms,
                                         "self_host_ms": 10 * ms}})
    paced = {n: r["paced_idle_ms"] / ms for n, r in t["spans"].items()}
    assert paced == pytest.approx({
        "trainer.step": 28, "trainer.forward": 0, "trainer.backward": 10,
        "backbone.recompute": 0, "trainer.apply_grads": 18,
        "trainer.finite_read": 18})
    assert t["spans"]["trainer.step"]["host_ms"] == 0
    got = spans.readings(t, "train", "remat")
    assert got["recompute_device_ms.remat"] == pytest.approx(20 * ms)
    assert got["backward_device_ms.remat"] == pytest.approx(6 * ms)
    assert got["apply_grads_idle_ms.remat"] == pytest.approx(18 * ms)
    assert got["launch_calls.remat"] == 3.5


def test_no_program_span_is_an_error():
    with pytest.raises(ValueError, match="no program span"):
        spans.attribute(_trace(), {"runner.request"})


def test_passes_over_the_tiny_preset(tmp_path):
    """The two passes on the CPU over the tiny preset's steps and
    requests on the harness's rendered rows: every span of the step and
    the request in the table, with host time, the root's self host time
    its duration less its children's; no device events on the CPU, so the
    window is idle; no file left behind."""
    import torch

    from benchmark import scenes
    from planerecnet_tpu_torch import trainer
    from planerecnet_tpu_torch.config import PlaneRecNet_tiny_config
    from planerecnet_tpu_torch.runner import PlaneRecNetRunner
    from planerecnet_tpu_torch.utils import timer

    torch.set_num_threads(2)
    cfg = PlaneRecNet_tiny_config.copy(dict(max_size=64))
    rows = scenes.make_rows(scenes.render_pool(7, 2, 64, 64), 2, 7)
    batch = scenes.collate(rows, cfg.max_instances,
                           cfg.dataset.depth_resolution)
    state = trainer.create_train_state(cfg, seed=0, device="cpu")
    t = spans.train(state, [batch], 0, {"span_steps": 1, "trace_steps": 2},
                    "cpu", tmp_path)
    assert t["units"] == 2 and state.step == 3
    s = t["spans"]
    assert set(s) == {
        "trainer.step", "trainer.upload", "trainer.forward", "trainer.loss",
        "trainer.backward", "trainer.apply_grads", "trainer.finite_read"}
    assert all(r["host_ms"] > 0 and r["wall_ms"] > 0
               and r["paced_idle_ms"] >= 0 for r in s.values())
    children = sum(r["host_ms"] for r in s.values()
                   if r["parent"] == "trainer.step")
    assert s["trainer.step"]["self_host_ms"] == pytest.approx(
        s["trainer.step"]["host_ms"] - children)
    assert t["device_ms"] == 0 and t["idle_ms"] > 0
    assert not timer.tracing(False)
    runner = PlaneRecNetRunner(cfg, seed=0, device="cpu")
    t = spans.serve(runner, [rows[0]["image"][None]], 0,
                    {"span_requests": 2, "trace_requests": 1}, "cpu",
                    tmp_path)
    assert t["units"] == 1
    assert set(t["spans"]) == {"runner.request", "runner.upload",
                               "runner.forward", "runner.postprocess"}
    assert list(tmp_path.iterdir()) == []
