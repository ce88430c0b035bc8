"""SOLOv2-R101-DCN in the port (``SOLOv2_R101_DCN_config``) against its plain
reference (``benchmark/reference/solov2.py``), on the CPU at a tiny size:
the same code with widths of 16-32 and one-block stages, the 80 classes
(80 logits; label 80 is the background) kept, seeded weights from the
benchmark's recipe.

Tolerances: both sides run f32 on the CPU with the same weights and
batch; they differ in how they sum (the port's dice/lava reductions and
grouped kernels, the reference's per-positive products and plain
gathers), so a forward output or a loss term agrees to ~1e-6 of its
scale and a gradient leaf to ~1e-5 of the median leaf's norm (measured
1e-7 and 2e-6): the bounds below are ten times that and more. bf16
compute moves every one of them by 1e-3 or more
(``test_bf16_fails_the_forward_bound``).

Also: the PlaneRecNet presets' forward, loss and Adam steps equal the
values recorded before the new fields existed; SOLOv2 trains through the
train CLI; the capacities of the benchmark's cell clip no positive; and
a 2-rank gloo rehearsal of the ``prn50_train_dp4`` driver's step holds
the port's data-parallel step against its reference, and the faults only
a rank can commit (its gradients left out of the sum, its BatchNorm
unsynced) fail the cell's ``replica_gap``. Marked ``card``:
the SOLOv2 step at 2x800x1344 against the reference, and the DCN kernels
at the instance towers' shapes against the plain DCN, on a card.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from planerecnet_tpu_torch import config, trainer
from planerecnet_tpu_torch.config import apply_overrides
from planerecnet_tpu_torch.losses.losses import _prepare_level

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from benchmark import scenes  # noqa: E402
from benchmark.kinds import train_solov2  # noqa: E402
from benchmark.reference import solov2 as ref  # noqa: E402

TINY = {"backbone": {"layers": [1, 1, 1, 1], "dcn_layers": [0, 1, 1, 1]},
        "fpn": {"num_features": 32},
        "solov2": {"num_kernels": 32, "num_masks": 32, "masks_channels": 32,
                   "instance_channels": 32, "num_instance_convs": 2,
                   "num_grids": [8, 8, 6, 4, 4], "nms_pre": 16, "top_k": 8,
                   "max_candidates": 32},
        "max_instances": 6, "max_positives": 54, "clip_grad_norm": 1.0}
SIZE = (96, 160)
FORWARD_TOL = 1e-5      # of the output's largest value
LOSS_TOL = 1e-5         # of the term
GRAD_TOL = 1e-4         # of the larger of the leaf's norm and the median's
WEIGHTS = {"offset_std_px": 2.6, "modulator_logit_std": 1.0,
           "serve_cate_bias": -2.0, "perturb_running_stats": False}


def _dict(cfg) -> dict:
    import dataclasses

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x
    return plain(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def tiny():
    cfg = apply_overrides(config.SOLOv2_R101_DCN_config, TINY)
    d = _dict(cfg)
    weights = train_solov2.make_weights(d, WEIGHTS, 7, "cpu")
    pool = train_solov2.render_pool(7, 3, *SIZE)
    rows = scenes.make_rows(pool, 4, 7)
    wires = []
    for i in range(2):
        wire = scenes.collate(rows[2 * i:2 * i + 2], cfg.max_instances,
                              1e-3)
        del wire["depth_q"]
        wire["classes"] = train_solov2.draw_classes(
            7 + i, wire["classes"].shape, 80, 0.3)
        wires.append(wire)
    return cfg, d, weights, wires


def _state(cfg, weights):
    state = trainer.create_train_state(cfg, seed=7, device="cpu")
    state.model.load_state_dict(weights)
    return state


def _reference(d, weights):
    return ref.Trainer(d, {k: v.clone() for k, v in weights.items()}, "cpu",
                       block=1)


def _dense(d, wire):
    return train_solov2.dense(wire, d["max_instances"], 1e-3, "cpu")


def _gap(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def test_forward_matches_reference(tiny):
    cfg, d, weights, wires = tiny
    state = _state(cfg, weights)
    x = trainer.unpack_wire_batch(cfg, wires[0], "cpu")["image"]
    with torch.no_grad():
        got = state.model(x)
        want = _reference(d, weights).net(x)
    assert "depth_pred" not in got
    for key in ("cate_preds", "kernel_preds"):
        assert len(got[key]) == len(want[key]) == 5
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape
            assert _gap(g, w) < FORWARD_TOL, key
    assert got["cate_preds"][0].shape[-1] == 80
    assert _gap(got["mask_pred"], want["mask_pred"]) < FORWARD_TOL


def test_bf16_fails_the_forward_bound(tiny):
    """The bounds see precision: bf16 compute breaks the forward's."""
    cfg, d, weights, wires = tiny
    state = _state(cfg.copy({"compute_dtype": "bfloat16"}), weights)
    x = trainer.unpack_wire_batch(cfg, wires[0], "cpu")["image"]
    with torch.no_grad():
        got = state.model(x)
        want = _reference(d, weights).net(x)
    assert max(_gap(g, w) for g, w in zip(got["kernel_preds"],
                                          want["kernel_preds"])) \
        > 10 * FORWARD_TOL


def _port_step(cfg, weights, wire):
    state = _state(cfg, weights)
    out, saved = trainer.grad_step(state, wire)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    trainer.apply_grads(state, out["total"], saved)
    return state, out, grads


def test_losses_and_gradients_match_reference(tiny):
    cfg, d, weights, wires = tiny
    _, out, grads = _port_step(cfg, weights, wires[0])
    want = _reference(d, weights).step(_dense(d, wires[0]))
    assert set(out) == {"ins", "cat", "total"}
    for k in ("ins", "cat", "total"):
        assert abs(float(out[k]) - float(want["losses"][k])) \
            <= LOSS_TOL * abs(float(want["losses"][k])), k
    assert set(grads) == set(want["grads"])
    norms = {k: float(v.norm()) for k, v in want["grads"].items()}
    med = float(np.median(list(norms.values())))
    for k, g in grads.items():
        gap = float((g - want["grads"][k]).norm())
        assert gap <= GRAD_TOL * max(norms[k], med), k


def test_sgd_steps_match_reference(tiny):
    """Two steps at the full lr (no warm-up): the clip (max_norm 1 here,
    so that it acts), weight decay, and the momentum buffer of the
    second. A parameter agrees to 1e-4 of its change plus its own f32
    rounding (1e-6 of its norm)."""
    cfg, d, weights, wires = tiny
    cfg = cfg.copy({"lr_warmup_until": 0})
    d = dict(d, lr_warmup_until=0)
    state = _state(cfg, weights)
    r = _reference(d, weights)
    for wire in wires:
        trainer.train_step(state, wire)
        out = r.step(_dense(d, wire))
        assert out["clip"] < 1.0
    assert isinstance(state.optimizer, torch.optim.SGD)
    port = dict(state.model.named_parameters())
    p0 = {k: v for k, v in weights.items()}
    for name, p in r.net.named_parameters():
        change = (p.detach() - p0[name]).norm()
        gap = (port[name].detach() - p.detach()).norm()
        bound = 1e-4 * float(change) + 1e-6 * float(p.detach().norm())
        assert gap <= bound, name


def test_frozen_stages_take_no_gradient_and_keep_no_record(tiny):
    cfg, d, weights, wires = tiny
    state = _state(cfg, weights)
    bb = state.model.backbone
    frozen = {id(p) for m in (bb.conv1, bb.bn1, bb.layers[0])
              for p in m.parameters()}
    outs = []
    hook = bb.layers[0][-1].register_forward_hook(
        lambda m, i, o: outs.append(o))
    _, saved = trainer.grad_step(state, wires[0])
    hook.remove()
    assert outs[0].grad_fn is None and not outs[0].requires_grad
    for p in state.model.parameters():
        assert (p.grad is None) == (id(p) in frozen)
        assert p.requires_grad == (id(p) not in frozen)
    assert not bb.bn1.training and not bb.layers[0][0].bn1.training
    # BatchNorm on its running statistics everywhere (norm_eval).
    assert not any(m.training for m in state.model.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    # The frozen stages take no update.
    before = {n: p.clone() for n, p in state.model.named_parameters()}
    trainer.train_step(state, wires[1])
    for n, p in state.model.named_parameters():
        assert torch.equal(p, before[n]) == (id(p) in frozen), n


def test_no_depth_decoder_and_no_depth_in_the_batch(tiny):
    cfg, d, weights, wires = tiny
    state = _state(cfg, weights)
    assert not hasattr(state.model, "depth_decoder")
    assert not any("depth" in n for n in state.model.state_dict())
    assert "depth_q" not in wires[0]
    out = trainer.train_step(state, wires[0])
    assert set(out) == {"ins", "cat", "total"}
    from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
    state.model.eval()
    with torch.no_grad():
        preds = state.model(torch.zeros(1, *SIZE, 3))
    post = postprocess_batch(preds, cfg, SIZE)
    assert "pred_depth" not in post and post["pred_masks"].shape[0] == 1


@pytest.mark.parametrize("allow", [False, True])
def test_tf32_switches_hold_through_forward_and_backward(tiny, allow):
    """``allow_tf32`` False (the SOLOv2 preset) turns cuDNN's and the
    matrix products' TF32 off in the forward and in the backward, and puts
    the switches back after the step; True leaves them as they were."""
    cfg, d, weights, wires = tiny
    assert config.SOLOv2_R101_DCN_config.allow_tf32 is False
    assert config.PlaneRecNet_50_config.allow_tf32 is True
    state = _state(cfg.copy({"allow_tf32": allow}), weights)
    seen = []

    def read(*_):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    conv = state.model.inst_head.cate_pred
    hooks = [conv.register_forward_hook(read),
             conv.register_full_backward_hook(read)]
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        trainer.train_step(state, wires[0])
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        for h in hooks:
            h.remove()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    assert len(seen) == 2 * len(cfg.solov2.num_grids)
    assert set(seen) == {(allow, allow)}
    assert after == (True, True)


def test_no_positive_is_clipped_at_the_cells_capacities():
    """At the cell's shapes (800x1344, grids 40-12, 20 instances, 180
    slots) a batch whose 20 instances all claim 9 cells of one level
    keeps every positive: the slots equal an uncapped assignment's."""
    cfg = config.SOLOv2_R101_DCN_config
    sv, n = cfg.solov2, cfg.max_instances
    assert cfg.max_positives >= 9 * n
    h, w = 800, 1344
    rng = np.random.RandomState(0)
    boxes = np.zeros((2, n, 4), np.float32)
    cx = rng.uniform(200, w - 200, (2, n)).astype(np.float32)
    cy = rng.uniform(200, h - 200, (2, n)).astype(np.float32)
    side = rng.uniform(100, 380, (2, n)).astype(np.float32)
    boxes[..., 0], boxes[..., 2] = cx - side / 2, cx + side / 2
    boxes[..., 1], boxes[..., 3] = cy - side / 2, cy + side / 2
    b = torch.from_numpy(boxes)
    valid = torch.ones(2, n, dtype=torch.bool)
    labels = torch.from_numpy(rng.randint(0, 80, (2, n)))
    sums = torch.full((2, n), 1000.0)
    for lvl in range(sv.num_instance_levels):
        args = (b, labels, valid, sums, torch.from_numpy(cx),
                torch.from_numpy(cy), (h, w), sv.num_grids[lvl],
                sv.fpn_scale_ranges[lvl], sv.sigma, cfg.num_classes)
        kept = _prepare_level(*args, cfg.max_positives)[4].sum(1)
        every = _prepare_level(*args, 9 * n)[4].sum(1)
        assert torch.equal(kept, every), lvl
    # Boxes of 360 px (their sigma-shrunk halves reach past a cell of the
    # 40-cell grid on every side) take 9 cells each: the capacity's 180.
    side = np.float32(360)
    boxes[..., 0], boxes[..., 2] = cx - side / 2, cx + side / 2
    boxes[..., 1], boxes[..., 3] = cy - side / 2, cy + side / 2
    full = _prepare_level(torch.from_numpy(boxes), labels, valid, sums,
                          torch.from_numpy(cx), torch.from_numpy(cy), (h, w),
                          40, (1, 2048), sv.sigma, cfg.num_classes,
                          cfg.max_positives)[4].sum(1)
    assert full.tolist() == [9 * n, 9 * n]


def test_a_later_instance_takes_a_shared_cell():
    """Two instances on one cell: the label is the later one's, as
    SOLOv2's loop writes it, on every run."""
    boxes = torch.tensor([[[0.0, 0.0, 64.0, 64.0], [0.0, 0.0, 64.0, 64.0]]])
    labels = torch.tensor([[3, 41]])
    c = torch.tensor([[32.0, 32.0]])
    lab, ins, *_ = _prepare_level(
        boxes, labels, torch.ones(1, 2, dtype=torch.bool),
        torch.ones(1, 2), c, c, (64, 64), 4, (1, 2048), 0.2, 80, 18)
    assert int(lab[0, 2 * 4 + 2]) == 41 and bool(ins[0, 2 * 4 + 2])
    assert int((lab != 80).sum()) == int(ins.sum())


def test_prn_presets_unchanged():
    """The PlaneRecNet presets' forward, two training steps (the loss
    terms, Adam) and the parameters after them, at 2x64x64 with seed 0,
    equal the values the port gave before the SOLOv2 fields existed
    (``torch_port_prn_goldens.json``; equal in every bit on one thread of
    the same CPU; 1e-6 leaves room for another CPU's kernels)."""
    goldens = json.loads((Path(__file__).with_name(
        "torch_port_prn_goldens.json")).read_text())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, want in goldens.items():
            cfg = apply_overrides(config.get_cfg(name),
                                  {"max_size": 64, "remat_backbone": False})
            pool = scenes.render_pool(5, 2, 64, 64)
            wire = scenes.collate(scenes.make_rows(pool, 2, 5),
                                  cfg.max_instances, 1e-3)
            st = trainer.create_train_state(cfg, seed=0, device="cpu")
            st.model.eval()
            with torch.no_grad():
                o = st.model(torch.linspace(-1, 1, 2 * 64 * 64 * 3)
                             .reshape(2, 64, 64, 3))
            leaves = [*o["cate_preds"], *o["kernel_preds"], o["mask_pred"],
                      o["depth_pred"]]
            st.model.train()
            got = {"forward": [float(t.double().sum()) for t in leaves],
                   "forward_abs": [float(t.double().abs().sum())
                                   for t in leaves],
                   "losses": {k: float(v) for k, v in
                              trainer.train_step(st, wire).items()},
                   "losses2": {k: float(v) for k, v in
                               trainer.train_step(st, wire).items()},
                   "params": float(sum(p.detach().double().sum()
                                       for p in st.model.parameters())),
                   "params_abs": float(sum(p.detach().double().abs().sum()
                                           for p in st.model.parameters())),
                   "exp_avg_sq": float(sum(
                       s["exp_avg_sq"].double().sum()
                       for s in st.optimizer.state.values()))}
            assert isinstance(st.optimizer, torch.optim.Adam)
            flat_g = np.asarray(_flat(got))
            flat_w = np.asarray(_flat(want))
            np.testing.assert_allclose(flat_g, flat_w, rtol=1e-6,
                                       atol=1e-9, err_msg=name)
    finally:
        torch.set_num_threads(threads)


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, list):
        return [v for e in x for v in _flat(e)]
    return [x]


def test_solov2_trains_through_the_train_cli(tmp_path, monkeypatch):
    """``--config SOLOv2_R101_DCN_config`` trains (SGD, no depth), saves,
    and resumes with its momentum buffers, through the train CLI."""
    from planerecnet_tpu_torch import train as ttrain
    from planerecnet_tpu_torch.tools import synth_scenes

    synth_scenes.generate_dataset(str(tmp_path), 4, 2, 3, h=48, w=80,
                                  seed=1, min_area=30, progress=False)
    monkeypatch.chdir(tmp_path)
    overrides = dict(TINY, max_size=64)

    def run(max_iter, extra=()):
        with redirect_stdout(io.StringIO()):
            return ttrain.main([
                "--config", "SOLOv2_R101_DCN_config", "--batch_size", "2",
                "--device", "cpu", "--no_tensorboard", "--no_autoscale",
                "--validation_size", "2", "--cfg_overrides",
                json.dumps(dict(overrides, max_iter=max_iter))] + list(extra))

    run(2)
    saved = sorted(tmp_path.rglob("*.npz"))
    assert saved
    with np.load(str(saved[-1])) as data:
        assert any(f.startswith("sgd/momentum_buffer/") for f in data.files)
        assert not any("depth_decoder" in f for f in data.files)
    run(3, ["--resume", "latest"])


def _rehearse(tmp_path, fault=None):
    """The ``prn50_train_dp4`` driver at a tiny size on 2 gloo ranks, in a
    process of its own with a time limit of its own; its verdict."""
    script = tmp_path / "rehearse.py"
    script.write_text(REHEARSAL)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    done = subprocess.run([sys.executable, str(script), str(tmp_path)]
                          + ([fault] if fault else []),
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=400)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_dp4_driver_rehearsal_on_two_cpu_ranks(tmp_path):
    """The port's data-parallel steps against the reference's
    (SyncBatchNorm's statistics, gradients summed over the ranks, Adam)
    within the cell's limits, and the ranks' models equal bit for bit."""
    r = _rehearse(tmp_path)
    assert r["ok"], r
    assert r["numbers"]["loss_gap"] < 1e-3
    assert r["numbers"]["stats_gap"] < 1e-3
    assert r["numbers"]["replica_gap"] == 0.0
    assert r["steps"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", ["no_allreduce", "local_batchnorm"])
def test_dp4_exchange_faults_are_not_correct(tmp_path, fault):
    """A rank whose gradients stay out of the sum, or whose BatchNorm
    trains on its own rows, leaves the ranks' models apart: the cell's
    ``replica_gap`` fails it, whatever the yardstick's numbers read."""
    r = _rehearse(tmp_path, fault)
    assert not r["ok"], r
    assert r["numbers"]["replica_gap"] > 10 * r["limits"]["replica_gap"]


REHEARSAL = '''
import json, sys, time
from pathlib import Path
from benchmark import check
from benchmark.kinds import train_dp
from benchmark.spec import find_cell

cell = find_cell("prn50_train_dp4")
cfg = cell.config["config"]
cfg.update({"backbone": dict(cfg["backbone"], layers=[1, 1, 1, 1],
                             dcn_layers=[0, 1, 1, 1]),
            "fpn": dict(cfg["fpn"], num_features=32),
            "depth": dict(cfg["depth"], num_features=32),
            "solov2": dict(cfg["solov2"], num_kernels=32, num_masks=32,
                           masks_channels=32, instance_channels=32,
                           num_instance_convs=1, num_grids=[8, 8, 4, 4]),
            "max_instances": 8, "max_positives": 32, "vnl_samples": 32})
cell.traffic.update(ranks=2, batch=2, height=64, width=64, pool=3,
                    ring_batches=3, check_steps=3, trace_steps=1)
fault = sys.argv[2] if len(sys.argv) > 2 else None
r = train_dp.run(cell, 3000019003, 1.0, False, "cpu", time.perf_counter(),
                 None, Path(sys.argv[1]), fault)
ok, _ = check.verdict(r["numbers"], cell.limits)
print(json.dumps({"ok": ok, "numbers": r["numbers"], "steps": r["steps"],
                  "failed": r["failed"], "limits": cell.limits}))
'''


# --- card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.card
def test_solov2_step_on_the_card_matches_reference(card):
    """The full configuration at 2x800x1344: the port's first step (TF32
    convolutions, the three CUDA kernels) against the reference's (f32,
    TF32 off): the losses within 1e-2, every moving gradient leaf within
    the cell's ``grad_gap`` limit."""
    from benchmark import check

    cfg = config.SOLOv2_R101_DCN_config
    d = _dict(cfg)
    weights = train_solov2.make_weights(d, WEIGHTS, 11, card)
    pool = train_solov2.render_pool(11, 2, 800, 1344)
    wire = scenes.collate(scenes.make_rows(pool, 2, 11), cfg.max_instances,
                          1e-3)
    del wire["depth_q"]
    wire["classes"] = train_solov2.draw_classes(11, wire["classes"].shape,
                                                80, 0.3)
    state = _state_on(cfg, weights, card)
    out, saved = trainer.grad_step(state, wire)
    grads = {n: p.grad.float().cpu() for n, p in
             state.model.named_parameters() if p.grad is not None}
    del state
    torch.cuda.empty_cache()
    with check.exact_f32():
        r = ref.Trainer(d, weights, card, block=1)
        want = r.step(train_solov2.dense(wire, cfg.max_instances, 1e-3,
                                         card))
    for k in ("ins", "cat"):
        assert abs(float(out[k]) - float(want["losses"][k])) \
            <= 1e-2 * abs(float(want["losses"][k])), k
    rg = {k: v.float().cpu() for k, v in want["grads"].items()}
    limit = json.loads((REPO / "benchmark" / "limits" /
                        "solov2_r101dcn_train_b8.json").read_text())
    gap, where = check.gap_of_norms(grads, rg, check.moving_leaves(rg))
    assert gap <= limit["grad_gap"], where


def _state_on(cfg, weights, device):
    state = trainer.create_train_state(cfg, seed=11, device=device)
    state.model.load_state_dict(weights)
    return state


TOWER_CASES = [(40, 258), (40, 512), (12, 258), (12, 512)]


@pytest.mark.card
@pytest.mark.parametrize("grid,channels", TOWER_CASES)
def test_dcn_kernels_at_tower_shapes(card, grid, channels):
    """The im2col and the scatter (atomic, and its fixed-order variant) at
    the instance towers' shapes: 8 maps of grid x grid with 258 or 512
    channels, offsets of 2.6 px, against their plain versions on the
    card. The columns are the same products (exact); the scatter sums in
    another order (1e-5 of the largest)."""
    from planerecnet_tpu_torch.ops import dcn, dcn_scatter

    g = torch.Generator(card).manual_seed(grid * 1000 + channels)
    x = torch.randn(8, grid, grid, channels, device=card, generator=g)
    off = 2.6 * torch.randn(8, grid, grid, 18, device=card, generator=g)
    mod = 2 * torch.rand(8, grid, grid, 9, device=card, generator=g)
    cols = dcn.deform_im2col(x, off, mod)
    assert _gap(cols, dcn.deform_im2col_plain(x, off, mod)) < 1e-6
    idx, wts = dcn.scatter_inputs(off, mod, grid, grid)
    dcols = torch.randn(8, idx.shape[1], channels, device=card, generator=g)
    want = dcn_scatter.dcn_input_grad_plain(idx, wts, dcols, grid, grid)
    for det in (False, True):
        got = dcn_scatter.dcn_input_grad(idx, wts, dcols, grid, grid,
                                         deterministic=det, stride=1)
        assert _gap(got, want) < 1e-5, det
