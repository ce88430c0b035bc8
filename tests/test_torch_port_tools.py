"""The port's profiling, benchmark and verification tools
(``planerecnet_tpu_torch/tools/``) on the CPU, against the JAX package's
tools where both compute the same thing.

- ``profile_train.synth_batch``: byte for byte the JAX tool's.
- ``roofline``: ``dcn_bytes`` equals the JAX tool's and the hand formula
  of ``tests/test_cli.py::test_roofline_dcn_byte_accounting``; the
  convolution and matmul FLOPs of the tiny forward equal a count from the
  model's own conv shapes (2 x output elements x weight elements per
  output channel), exactly.
- ``parse_trace`` on a synthetic chrome trace with known kernel events,
  and on a real CPU ``torch.profiler`` trace.
- ``profile_inference`` and ``profile_train`` at 1-2 iterations: their
  JSON, and the first step's losses of ``profile_train``'s steps equal
  ``trainer.grad_step``'s on the same state and batch (rel 1e-6).
- ``bench_optimizer``: each Adam variant's parameters after 3 updates
  equal the trainer's update within 1e-6; SGD's equal its formula.
- ``verify_released``: ``compare`` gives the JAX tool's verdicts on the
  same tables, in and out of budget; ``main`` runs the port's eval CLI on
  a synthetic ``.pth`` over a ``synth_scenes`` tree.
- Every tool that touches a device runs on ``cuda`` by default and
  raises where there is none.
"""

import copy
import gzip
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from planerecnet_tpu.config import PlaneRecNet_tiny_config as JTINY
from planerecnet_tpu_torch import config as tconfig
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.models.backbone import DeformableConv2d
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.tools import (bench_dice_kernel, bench_dispatch,
                                         bench_optimizer, parse_trace,
                                         profile_inference, profile_train,
                                         roofline, synth_scenes,
                                         verify_released)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py``, loaded under another module
    name (the port's tools share its names)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kwargs):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# ------------------------------------------------------------ profile_train


@pytest.mark.parametrize("b,h,w,seed", [(2, 64, 64, 0), (3, 48, 80, 5),
                                        (8, 640, 640, 1)])
def test_synth_batch_is_jax_byte_for_byte(b, h, w, seed):
    want = _jax_tool("profile_train").synth_batch(JTINY, b, h, w, seed)
    got = profile_train.synth_batch(tconfig.PlaneRecNet_tiny_config, b, h, w,
                                    seed)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


TRAIN_ARGS = ["--config", "PlaneRecNet_tiny_config", "--batch_size", "2",
              "--size", "64", "--iters", "1", "--warmup", "0", "--device",
              "cpu"]


def _perturb_offsets(model):
    """Seeded non-zero DCN offset and modulator weights (zero at init)."""
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name or "modulator_conv" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.01)


def _first_losses_of_trainer(flags, set_weights=None):
    """``trainer.grad_step``'s losses on the tool's first state and batch
    (the same seed), under the tool's config for ``flags``."""
    args = profile_train.parse_args(TRAIN_ARGS + flags)
    cfg = profile_train.config(args)
    state = trainer.create_train_state(cfg, seed=0, device="cpu")
    if set_weights is not None:
        set_weights(state.model)
    batch = trainer.unpack_wire_batch(
        cfg, profile_train.synth_batch(cfg, 2, 64, 64, seed=0), "cpu")
    losses, _ = trainer.grad_step(state, batch)
    return {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("flags", [[], ["--forward_only"],
                                   ["--losses", "ins,cat,dpt", "--no_opt"],
                                   ["--losses", "ins,cat,dpt,pln,lav"],
                                   ["--fused_loss", "off"],
                                   ["--remat", "on"], ["--no_remat"]])
def test_profile_train_losses_equal_trainer(flags):
    out = _quiet(profile_train.main, TRAIN_ARGS + flags)
    want = _first_losses_of_trainer(flags)
    assert set(out["first_losses"]) == set(want)
    for key, value in want.items():
        assert out["first_losses"][key] == pytest.approx(value, rel=1e-6,
                                                         abs=1e-7), key
    assert out["device"] == "cpu" and out["value"] > 0 and out["loss_finite"]
    assert out["peak_gib"] is None


def test_profile_train_set_weights_reaches_the_step():
    """The weights that a caller sets are those the timed step starts
    from: the first losses equal the trainer's on the same perturbed
    model, and differ from the initial weights' (the DCN offsets move)."""
    out = _quiet(profile_train.main, TRAIN_ARGS,
                 set_weights=_perturb_offsets)
    want = _first_losses_of_trainer([], _perturb_offsets)
    for key, value in want.items():
        assert out["first_losses"][key] == pytest.approx(value, rel=1e-6,
                                                         abs=1e-7), key
    initial = _first_losses_of_trainer([])
    assert any(initial[k] != want[k] for k in want)


def test_profile_train_split_timing_and_trace(tmp_path):
    out = _quiet(profile_train.main, TRAIN_ARGS + [
        "--split_timing", "--trace", str(tmp_path), "--no_dcn",
        "--net_grad_only", "--aux_losses"])
    assert set(out["split_ms"]) == {"forward_loss_ms", "backward_ms",
                                    "grad_ms", "update_ms"}
    assert all(v > 0 for v in out["split_ms"].values())
    assert os.path.exists(out["trace"])
    assert {"ins", "cat", "dpt", "total"} <= set(out["first_losses"])
    with open(tmp_path / "profile_step_kernels.json") as f:
        table = json.load(f)
    assert table["runs"] == 3 and table["wall_ms"] > 0


def test_profile_inference_json():
    models = []
    out = _quiet(profile_inference.main, [
        "--config", "PlaneRecNet_tiny_config", "--height", "64", "--width",
        "64", "--batch_size", "2", "--iters", "1", "--device", "cpu"],
        set_weights=models.append)
    assert len(models) == 1 and isinstance(models[0], torch.nn.Module)
    assert tuple(out["stages_ms"]) == profile_inference.STAGES
    assert all(v > 0 for v in out["stages_ms"].values())
    assert out["clock"] == "host" and out["device"] == "cpu"
    assert out["img_per_s"] == pytest.approx(2e3 / out["stages_ms"]["infer"])


# ------------------------------------------------------------------ roofline


@pytest.mark.parametrize("name,expect", [
    ("PlaneRecNet_50_config", 4 * 60 * 80 * 36 * 128 * 2
     + 6 * 30 * 40 * 36 * 256 * 2 + 3 * 15 * 20 * 36 * 512 * 2),
    ("PlaneRecNet_101_config", 2 * 60 * 80 * 36 * 128 * 2
     + 8 * 30 * 40 * 36 * 256 * 2 + 1 * 15 * 20 * 36 * 512 * 2)])
def test_dcn_bytes_matches_jax_and_hand_formula(name, expect):
    import argparse
    from planerecnet_tpu import config as jconfig
    args = argparse.Namespace(config=name, height=480, width=640,
                              gather_gbs=None)
    got = _quiet(roofline.dcn_bytes, tconfig.get_cfg(name), args)
    want = _quiet(_jax_tool("roofline").dcn_bytes, jconfig.get_cfg(name),
                  args)
    assert got == want == expect


def test_roofline_flops_of_tiny_forward_equal_conv_shapes():
    torch.manual_seed(0)
    model = PlaneRecNet(tconfig.PlaneRecNet_tiny_config).eval()
    hand = [0]

    def hook(mod, inputs, out):
        w = (mod.regular_conv.weight if isinstance(mod, DeformableConv2d)
             else mod.weight)
        hand[0] += 2 * out.numel() * w[0].numel()

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, DeformableConv2d)):
            mod.register_forward_hook(hook)
    x = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        acc = roofline.count(lambda: model(x))
    hand[0] //= 2                       # count() runs the forward twice
    by_op = acc.flops_by_op
    assert by_op["aten.convolution"] + by_op["aten.mm"] == hand[0]
    assert acc.by_kernel["deform_im2col"]["calls"] == 3
    assert acc.flops == sum(by_op.values()) + \
        acc.by_kernel["deform_im2col"]["flops"]
    assert acc.bytes > 0


def test_roofline_hooks_keep_the_wrappers_counters(monkeypatch):
    """While a hooked kernel runs, its module's name is its wrapper again,
    through which the wrapper adds to its launch count."""
    from planerecnet_tpu_torch.ops import dcn
    wrapper, seen = dcn.deform_im2col, []
    plain = dcn.deform_im2col_plain

    def spy(*args, **kwargs):
        seen.append(dcn.deform_im2col is wrapper)
        return plain(*args, **kwargs)

    monkeypatch.setattr(dcn, "deform_im2col_plain", spy)
    x = torch.randn(1, 5, 6, 4)
    off, mask = torch.zeros(1, 5, 6, 18), torch.ones(1, 5, 6, 9)
    acc = roofline.Accounting()
    with roofline.kernels(acc), acc:
        dcn.deform_im2col(x, off, mask)
        assert dcn.deform_im2col is not wrapper
    assert seen == [True] and dcn.deform_im2col is wrapper
    assert acc.by_kernel["deform_im2col"] == {
        "calls": 1, "flops": 9 * 30 * 36,
        "bytes": 4 * (x.numel() + off.numel() + mask.numel() + 30 * 36)}


def test_roofline_main_mfu_and_gather():
    out = _quiet(roofline.main, [
        "--config", "PlaneRecNet_tiny_config", "--height", "64", "--width",
        "64", "--batch_size", "1", "--imgs_per_s", "10", "--train",
        "--train_size", "64", "--train_ms", "100", "--peak_tflops", "1",
        "--peak_hbm_gbs", "100", "--gather", "--gather_rows", "64",
        "--gather_m", "256", "--gather_iters", "2", "--device", "cpu"])
    req, step = out["request"], out["step"]
    assert req["mfu"] == pytest.approx(req["flops"] * 10 / 1e12)
    assert req["hbm_share"] == pytest.approx(req["bytes"] * 10 / 1e11)
    assert step["mfu"] == pytest.approx(step["flops"] * 10 / 1e12)
    assert set(step["kernels"]) == {"deform_im2col", "dcn_input_grad",
                                    "dice_lava_fwd", "dice_lava_bwd"}
    assert step["kernels"]["deform_im2col"]["calls"] == 6
    assert out["gather"]["gbs"] > 0


def test_peaks_are_the_h100_data_sheet():
    h100 = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100 == {"hbm_bytes_per_s": 3.35e12, "float32": 67e12,
                    "tf32": 495e12, "bfloat16": 989e12}
    assert roofline.peaks_for("cpu") is None


# ---------------------------------------------------------------- parse_trace


def _event(name, cat, ts, dur, **kw):
    return dict(name=name, cat=cat, ph="X", ts=ts, dur=dur, pid=0, tid=7,
                **kw)


SYNTHETIC = [
    _event("host_op", "cpu_op", 0, 100),
    _event("kernA", "kernel", 10, 20),
    _event("kernA", "kernel", 40, 20),
    _event("kernB", "kernel", 50, 30),          # overlaps kernA's second
    _event("Memcpy HtoD", "gpu_memcpy", 90, 10),
    _event("Memset", "gpu_memset", 200, 0),
    dict(name="thread_name", ph="M", pid=0, tid=7),
    _event("cudaLaunchKernel", "cuda_runtime", 5, 2),
]


@pytest.mark.parametrize("form", ["dict", "gz", "dir"])
def test_parse_trace_on_known_events(tmp_path, form):
    trace = {"traceEvents": SYNTHETIC}
    if form == "dict":
        path = tmp_path / "t.json"
        path.write_text(json.dumps(trace))
    elif form == "gz":
        path = tmp_path / "t.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump(trace, f)
    else:
        (tmp_path / "sub").mkdir()
        (tmp_path / "sub" / "t.json").write_text(json.dumps(trace))
        (tmp_path / "profile_x_kernels.json").write_text("{}")
        path = tmp_path
    out = _quiet(parse_trace.main, [str(path), "--runs", "2"])
    # per run of 2: kernA 40 us in 2 calls, kernB 30, memcpy 10, memset 0
    assert [k["kernel"] for k in out["kernels"]] == [
        "kernA", "kernB", "Memcpy HtoD", "Memset"]
    assert [k["calls"] for k in out["kernels"]] == [1, 0.5, 0.5, 0.5]
    assert out["kernels"][0]["ms"] == pytest.approx(0.02)
    assert out["device_ms"] == pytest.approx(0.04)
    assert out["kernels"][0]["share"] == pytest.approx(0.5)
    # busy: [10, 30] + [40, 80] + [90, 100] = 70 us of a 200 us window
    assert out["busy_ms"] == pytest.approx(0.035)
    assert out["window_ms"] == pytest.approx(0.1)
    assert out["idle_share"] == pytest.approx(1 - 70 / 200)
    assert parse_trace.calls_of(out, "kern") == 1.5


def test_parse_trace_on_a_cpu_profiler_trace(tmp_path):
    x = torch.randn(64, 64)
    summary = parse_trace.record(lambda: (x @ x).sum(), 3, str(tmp_path),
                                 "mm", "cpu")
    assert summary["busy_ms"] == 0 and summary["kernels"] == []
    assert summary["window_ms"] > 0 and summary["idle_share"] == 1.0
    assert summary["wall_ms"] > 0 and summary["runs"] == 3
    again = _quiet(parse_trace.main, [str(tmp_path), "--runs", "3"])
    assert again["window_ms"] == pytest.approx(summary["window_ms"])
    with open(tmp_path / "profile_mm_kernels.json") as f:
        assert json.load(f)["trace"] == summary["trace"]
    events = parse_trace.load(summary["trace"])
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "")
               for e in events)


# ------------------------------------------------------------------ benches


def _updated(variant, steps=3):
    cfg = tconfig.PlaneRecNet_tiny_config
    state = bench_optimizer.make_state(cfg, "cpu")
    update = bench_optimizer.updater(variant, state)
    for _ in range(steps):
        update()
    return state


def test_bench_optimizer_variants_equal_trainer():
    """Three updates of each Adam variant against ``trainer.apply_grads``
    on the same parameters and gradients; SGD against p - lr g."""
    cfg = tconfig.PlaneRecNet_tiny_config
    ref = bench_optimizer.make_state(cfg, "cpu")
    p0 = [p.detach().clone() for p in ref.model.parameters()]
    total = torch.ones(())
    for _ in range(3):
        assert trainer.apply_grads(ref, total, [])
    want = [p.detach() for p in ref.model.parameters()]
    for variant in ("trainer", "foreach", "fused"):
        got = list(_updated(variant).model.parameters())
        for g, w in zip(got, want):
            torch.testing.assert_close(g.detach(), w, rtol=0, atol=1e-6,
                                       msg=variant)
    sgd = list(_updated("sgd").model.parameters())
    lr = sum(ref.schedule(i) for i in range(3))
    for g, p in zip(sgd, p0):
        torch.testing.assert_close(g.detach(), p - lr * 1e-3, rtol=0,
                                   atol=1e-6)


def test_bench_optimizer_main():
    out = _quiet(bench_optimizer.main, ["--config", "PlaneRecNet_tiny_config",
                                        "--iters", "1", "--device", "cpu"])
    for key in ("trainer_ms", "foreach_ms", "fused_ms", "sgd_ms",
                "apply_grads_ms", "sync_ms"):
        assert out[key] > 0, key
    assert out["leaves"] == len(list(PlaneRecNet(
        tconfig.PlaneRecNet_tiny_config).parameters()))


def test_bench_dice_kernel_and_dispatch():
    dice = _quiet(bench_dice_kernel.main, [
        "--b", "2", "--p", "8", "--k", "32", "--n", "4", "--hw", "64",
        "--iters", "1", "--device", "cpu"])
    for case in ("fused_fwd", "plain_fwd", "fused_fwd_bwd", "plain_fwd_bwd"):
        assert dice[f"{case}_ms"] > 0, case
    disp = _quiet(bench_dispatch.main, ["--leaves", "7", "--total_m", "0.01",
                                        "--iters", "2", "--device", "cpu"])
    assert disp["values"] == 7 * int(1e4 / 7)
    for case in ("scalar", "flat", "7_leaves_one_by_one",
                 "7_leaves_foreach"):
        assert disp[case]["wall_ms"] >= disp[case]["host_ms"] > 0, case


@pytest.mark.parametrize("tool,argv", [
    (profile_inference, ["--config", "PlaneRecNet_tiny_config"]),
    (profile_train, ["--config", "PlaneRecNet_tiny_config"]),
    (roofline, ["--config", "PlaneRecNet_tiny_config", "--gather"]),
    (bench_dice_kernel, []), (bench_dispatch, []),
    (bench_optimizer, ["--config", "PlaneRecNet_tiny_config"])])
def test_tools_default_to_cuda(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(tool.main, argv)


def test_verify_released_defaults_to_cuda(tmp_path, monkeypatch):
    """Its eval CLI runs on ``cuda`` unless ``--device cpu``."""
    from planerecnet_tpu_torch import eval as teval
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    seen = []

    def in_process(cmd):
        seen.append(cmd[cmd.index("--device") + 1])
        return teval.main(cmd[3:])

    monkeypatch.setattr(verify_released.subprocess, "call", in_process)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(verify_released.main, [
            "--pth", str(tmp_path / "PlaneRecNet_50_9_125000.pth"),
            "--images", str(tmp_path), "--annotations",
            str(tmp_path / "a.json")])
    assert seen == ["cuda"]


# ---------------------------------------------------------- verify_released


def _jax_compare(*args):
    return _quiet(_jax_tool("verify_released").compare, *args)


def test_verify_released_tables_are_jax():
    jvr = _jax_tool("verify_released")
    assert verify_released.PUBLISHED == jvr.PUBLISHED
    assert verify_released.BUDGETED == jvr.BUDGETED


def _perturbed():
    table = copy.deepcopy(verify_released.PUBLISHED)
    cases = {"same": table}
    for name, (group, key, factor) in {
            "rmse_in": ("depth", "rmse", 1.009),
            "rmse_out": ("depth", "rmse", 1.05),
            "mask_in": ("mask", "all", 0.995),
            "mask_out": ("mask", "all", 0.98),
            "info_off": ("box", "50", 1.5)}.items():
        t = copy.deepcopy(table)
        t[group][key] = t[group][key] * factor
        cases[name] = t
    missing = copy.deepcopy(table)
    del missing["depth"]["a3"]
    cases["missing"] = missing
    return cases


@pytest.mark.parametrize("case", ["same", "rmse_in", "rmse_out", "mask_in",
                                  "mask_out", "info_off", "missing"])
def test_verify_released_compare_is_jax(case):
    measured = _perturbed()[case]
    expected = verify_released.PUBLISHED
    got = _quiet(verify_released.compare, measured, expected, 1.0)
    assert got == _jax_compare(measured, expected, 1.0)
    assert got == (case in ("same", "rmse_in", "mask_in", "info_off"))


def test_verify_released_main_on_synthetic_pth(tmp_path, monkeypatch):
    """The procedure end to end: the config parsed from the ``.pth``'s
    name, the port's eval CLI (in-process) on a synthetic tree, the
    measured metrics written and the verdict given."""
    from planerecnet_tpu_torch import eval as teval
    from test_torch_port_convert import upstream_state_dict
    from test_torch_port_model import jax_variables, nest
    from test_torch_port_runner import _tiny_cfg

    pth = str(tmp_path / "PlaneRecNet_50_9_125000.pth")
    sd = upstream_state_dict(nest(jax_variables(_tiny_cfg())))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    root = synth_scenes.generate_dataset(str(tmp_path), 0, 0, 3, h=48, w=80,
                                         seed=2, min_area=30, progress=False)
    calls = []

    def in_process(cmd):
        assert cmd[1:3] == ["-m", "planerecnet_tpu_torch.eval"]
        calls.append(cmd)
        teval.main(cmd[3:])
        return 0

    monkeypatch.setattr(verify_released.subprocess, "call", in_process)
    overrides = {"max_size": 64, "max_instances": 4,
                 "solov2": {"num_grids": [10, 9, 6, 4], "max_candidates": 32,
                            "nms_pre": 32, "top_k": 8}}
    mjson = str(tmp_path / "measured.json")
    with redirect_stdout(io.StringIO()), pytest.raises(SystemExit) as exit_:
        verify_released.main([
            "--pth", pth, "--images", os.path.join(root, "scans"),
            "--annotations", os.path.join(root, "scannet_eval.json"),
            "--max_images", "2", "--metrics_json", mjson, "--device", "cpu",
            "--cfg_overrides", json.dumps(overrides),
            "--eval_args", "--score_threshold 0.01 --update_threshold 0.01"])
    assert exit_.value.code in (0, 1)
    cmd = calls[0]
    assert cmd[cmd.index("--config") + 1] == "PlaneRecNet_50_config"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    with open(mjson) as f:
        measured = json.load(f)
    assert {"mask", "box", "depth"} <= set(measured)
    assert set(measured["depth"]) >= {"abs_rel", "rmse", "a1"}
    table = {k: dict(measured[k]) for k in ("mask", "box", "depth")}
    assert _quiet(verify_released.compare, measured, table, 1.0)
    table["depth"]["rmse"] = float(table["depth"]["rmse"]) * 1.05 + 0.01
    assert not _quiet(verify_released.compare, measured, table, 1.0)
