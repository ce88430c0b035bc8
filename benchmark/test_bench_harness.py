"""CPU tests of the benchmark's harness, yardstick and counts.

A tiny benchmark (the program's tiny preset at 64x64, a train and a serve
cell, one new per-layer metric) is built in a temporary folder from new
files and entries alone, and its cells run end to end on the CPU against
the yardstick; the timed path is then broken underneath in the ways a
cell can be wrong, and ``correct`` must come out false.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import check, loop, trace, work
from benchmark.run import execute, forbidden_modules
from benchmark.spec import REPO, find_cell

HERE = Path(__file__).resolve().parent
SEED = 2 ** 31 + 11
TINY_LIMITS = {
    "train": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 2e-2,
              "stats_gap": 1e-3},
    "serve": {"raw_gap": 1e-4, "post_gap": 1e-5},
}
NEW_METRIC = '''"""Images a second of the window (a metric added as a file)."""


def read(ctx):
    return ctx["rate_img_per_s"]
'''


def tiny_benchmark(root: Path) -> Path:
    """A benchmark of two tiny cells in ``root``, made only of new files
    beside copies of this one's readers."""
    from planerecnet_tpu_torch.config import get_cfg

    bench = root / "tinybench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", bench / "metrics")
    (bench / "metrics" / "rate_again.train.py").write_text(NEW_METRIC)
    conf = json.loads((HERE / "configs" / "prn50.json").read_text())
    conf.update(name="tiny", config=dataclasses.asdict(
        get_cfg("PlaneRecNet_tiny_config")))
    (bench / "configs" / "tiny.json").write_text(json.dumps(conf))
    (bench / "traffic" / "train_tiny.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "height": 64, "width": 64, "pool": 2,
         "ring_batches": 3, "check_steps": 3, "trace_steps": 1,
         "span_steps": 1}))
    (bench / "traffic" / "serve_tiny.json").write_text(json.dumps(
        {"kind": "serve", "batch": 1, "height": 64, "width": 64, "pool": 2,
         "ring": 3, "warmup": 2, "check_requests": 2, "trace_requests": 2,
         "span_requests": 2}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["paths"] = ["tinybench"]
    spec["configs"] = [{"name": "tiny", "source": "test", "reduced": [],
                        "file": "tinybench/configs/tiny.json", "why": "t"}]
    spec["workloads"] = [
        {"name": "tiny_train", "config": "tiny", "traffic": "train_tiny",
         "chips": 1, "why": "t"},
        {"name": "tiny_serve", "config": "tiny", "traffic": "serve_tiny",
         "chips": 1, "why": "t"}]
    # The tiny cells stand for PRN-50's: they take its cells' metrics.
    tiny_of = {"prn50_train_b8": "tiny_train", "prn50_serve_b1": "tiny_serve"}
    for key in ("end_to_end", "per_layer"):
        kept = []
        for m in spec[key]:
            if "workloads" in m:
                m["workloads"] = [tiny_of[w] for w in m["workloads"]
                                  if w in tiny_of]
                if not m["workloads"]:
                    continue
            kept.append(m)
        spec[key] = kept
    spec["per_layer"].append(
        {"name": "rate_again.train", "unit": "img/s", "better": "higher",
         "source": "host_clock", "layer": "trainer",
         "moves": "train_img_per_s", "workloads": ["tiny_train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for kind, lim in TINY_LIMITS.items():
        (bench / "limits" / f"tiny_{kind}.json").write_text(json.dumps(lim))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_benchmark(tmp_path_factory.mktemp("bench"))


def run_tiny(tiny, name, trace=False, device="cpu", overrides=None):
    cell = find_cell(name, tiny)
    return execute(cell, SEED, 0.5, trace, device, time.perf_counter(),
                   overrides)


@pytest.mark.parametrize("name", ["prn50_train_b8", "prn50_serve_b1",
                                  "prn101_train_b40_remat"])
def test_cells_are_found_by_name(name):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = find_cell(name)
    assert cell.traffic["kind"] in ("train", "serve")
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                     "peak_mem_gib"}
    assert cell.per_layer and cell.limits
    wl = next(w for w in spec["workloads"] if w["name"] == name)
    assert cell.config["name"] == wl["config"]


@pytest.mark.parametrize("name", ["prn50", "prn101"])
def test_configuration_file_is_the_preset(name):
    from planerecnet_tpu_torch.config import (PlaneRecNetConfig,
                                              apply_overrides, get_cfg)

    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    preset = {"prn50": "PlaneRecNet_50_config",
              "prn101": "PlaneRecNet_101_config"}[name]
    assert apply_overrides(PlaneRecNetConfig(), conf["config"]) == \
        get_cfg(preset)


def test_weights_fit_the_program_and_repeat():
    from planerecnet_tpu_torch.config import get_cfg
    from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
    from benchmark.weights import make_weights

    cfg = get_cfg("PlaneRecNet_tiny_config")
    conf = json.loads((HERE / "configs" / "prn50.json").read_text())
    d = dataclasses.asdict(cfg)
    a = make_weights(d, conf["weights"], SEED, "cpu", True)
    b = make_weights(d, conf["weights"], SEED, "cpu", True)
    PlaneRecNet(cfg).load_state_dict(a)          # strict: same keys, shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = make_weights(d, conf["weights"], SEED + 1, "cpu", True)
    assert not torch.equal(a["backbone.conv1.weight"],
                           c["backbone.conv1.weight"])


def test_added_cell_metric_traffic_and_config_run_from_files(tiny):
    """The tiny cells are new files and entries only; the train cell runs
    end to end, the yardstick agrees, and the added metric is read."""
    r = run_tiny(tiny, "tiny_train", trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["rate_again.train"]["value"] > 0
    assert r["metrics"]["mfu.train"]["value"] > 0
    assert "optimizer_ms.train" in r["metrics"]
    # No card: the device's own numbers are not there to read.
    assert "device_idle_share.train" not in r["metrics"]


@pytest.mark.parametrize("name", ["tiny_train", "tiny_serve"])
def test_yardstick_agrees_with_the_program(tiny, name):
    r = run_tiny(tiny, name)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in
                                 find_cell(name, tiny).end_to_end}
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    ("tiny_train", "unchanged_state"), ("tiny_train", "half_batch"),
    ("tiny_serve", "altered_answer")])
def test_a_broken_timed_path_is_not_correct(tiny, name, fault):
    from benchmark.faults import FAULTS

    with FAULTS[fault]():
        assert not run_tiny(tiny, name)["correct"]


@pytest.mark.parametrize("name", ["tiny_train", "tiny_serve"])
def test_control_in_lower_precision_is_not_correct(tiny, name):
    from benchmark.control import CONTROL

    assert not run_tiny(tiny, name, overrides=CONTROL)["correct"]


def test_rate_is_all_work_over_the_whole_window():
    calls = []

    def call(i):
        calls.append(i)
        time.sleep(0.01 if i % 2 else 0.03)

    lat, window, host = loop.closed_loop(call, 0.2, lambda: None,
                                         each=False)
    assert lat == [] and window >= 0.2
    assert 0 <= host["cpu_s"] < window      # sleeping takes no processor
    assert window >= 0.02 * len(calls)
    assert loop.rate(8 * len(calls), window) == 8 * len(calls) / window


def test_p95_is_over_every_request():
    lat = [0.01] * 95 + [0.1] * 5
    # Over all 100 requests: 0.05 of the way from the 95th to the 96th
    # order statistic. The p95 of ten chunks' p95s would read 59.5 ms.
    assert loop.p95_ms(lat) == pytest.approx(14.5)
    lat, window, _ = loop.closed_loop(lambda i: time.sleep(0.002), 0.05,
                                      lambda: None, each=True)
    assert len(lat) >= 10 and sum(lat) <= window


def test_deformable_layer_against_an_f64_witness():
    """The program's deformable layer and the yardstick's, each in f32 at
    offsets spread 2.6 px, sit as close to the yardstick in f64 (the
    witness) as rounding allows: forward, every gradient, and the
    per-channel sums of the offsets' and modulators' gradients."""
    from benchmark import look
    from planerecnet_tpu_torch.config import get_cfg

    cfg = dataclasses.asdict(get_cfg("PlaneRecNet_tiny_config"))
    rows = look.dcn_layers(cfg, 2, 64, 64, 2.6, "cpu")
    keys = ("out", "dx", "doffset", "dmask", "dweight", "doffset_sum",
            "dmask_sum")
    for prog in (r for r in rows if r["side"] == "program"):
        assert all(prog[k] < 1e-5 for k in keys), prog


def test_kernel_bounds_match_hand_counts():
    s = dict(b=1, c=4, h=8, w=8, ho=8, wo=8)
    hbm = work.PEAKS["hbm_bytes_per_s"]
    # x 256, offsets 64*18, modulators 64*9, columns 64*36 floats.
    assert work.im2col_least_s(s) == pytest.approx(
        4 * (256 + 64 * 18 + 64 * 9 + 64 * 36) / hbm)
    # offsets, modulators, columns' gradient read; dx written.
    assert work.scatter_least_s(s) == pytest.approx(
        4 * (64 * 27 + 64 * 36 + 256) / hbm)
    d = dict(b=1, p=2, k=3, n=4, hw=5, levels=4)
    nbytes = 4 * (6 + 15 + 8 + 20 + 5 + 6 + 6 + 6 + 15)
    assert work.dice_lava_least_s(d) == pytest.approx(max(
        nbytes / hbm, 3 * 2 * 2 * 5 * 3 / work.PEAKS["tf32_flops_per_s"]))


def test_model_flops_match_a_count_by_layer():
    """Every convolution's 2*Cout*Cin/g*k*k*Ho*Wo, the deformable layers'
    column products and the depth decoder's mask products, counted from
    the layers' own shapes."""
    from planerecnet_tpu_torch.config import get_cfg
    from benchmark.reference.model import PlaneRecNet, DeformableConv2d

    cfg = dataclasses.asdict(get_cfg("PlaneRecNet_tiny_config"))
    with torch.device("meta"):
        net = PlaneRecNet(cfg)
    total = []

    def conv_hook(m, inp, out):
        total.append(2 * out.numel() * m.in_channels // m.groups
                     * m.kernel_size[0] * m.kernel_size[1])

    def dcn_hook(m, inp, out):
        total.append(2 * out.numel() * m.regular_conv.in_channels * 9)

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d) and not any(
                m is d.regular_conv for d in net.dcn_layers()):
            m.register_forward_hook(conv_hook)
        if isinstance(m, DeformableConv2d):
            m.register_forward_hook(dcn_hook)
    with torch.no_grad():
        out = net(torch.empty(2, 64, 64, 3, device="meta"))
    b, hm, wm, k = out["mask_pred"].shape
    cells = sum(s * s for s in cfg["solov2"]["num_grids"][:4])
    total.append(2 * b * cells * k * hm * wm)
    assert work.model_flops(cfg, 2, 64, 64, False) == sum(total)
    train = work.model_flops(cfg, 2, 64, 64, True)
    assert 2 * sum(total) < train < 3.5 * sum(total)


def test_trace_summary_and_idle_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0, "dur": 100, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 0,
           "dur": 40, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 60,
           "dur": 30, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 5}]
    s = trace.summarize(ev, units=1)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["kernels"]["k1"] == [2, pytest.approx(25e-6)]
    assert trace.kernel_time(s, ("k1", "k2")) == (3, pytest.approx(45e-6))
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::conv"] == pytest.approx(10e-6)     # 0-10
    assert gaps["aten::sum"] == pytest.approx(50e-6)      # 40-90
    assert gaps[trace.WINDOW] == pytest.approx(5e-6)      # 95-100


def test_the_import_check_compares_whole_top_level_names():
    mods = ["jax.numpy", "planerecnet_tpu.models", "flax",
            "planerecnet_tpu_torch.trainer", "jaxtyping", "numpy"]
    assert forbidden_modules(mods) == ["flax", "jax", "planerecnet_tpu"]
    assert forbidden_modules(["planerecnet_tpu_torch", "torch"]) == []


def test_gap_of_norms_takes_the_worst_leaf_over_the_median():
    ref = {"a": torch.ones(4), "b": torch.ones(4) * 1e-9, "c": torch.ones(4)}
    prog = {"a": torch.ones(4) * 1.01, "b": torch.ones(4) * 2e-9,
            "c": torch.ones(4)}
    gap, leaf = check.gap_of_norms(prog, ref)
    assert leaf == "a" and gap == pytest.approx(0.01, rel=1e-6)


def test_tiny_cells_on_the_card(tiny, card):
    for name in ("tiny_train", "tiny_serve"):
        assert run_tiny(tiny, name, device=card)["correct"]
