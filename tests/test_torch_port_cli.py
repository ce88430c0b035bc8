"""The port's train and eval CLIs on the CPU (``--device cpu``).

The tiny preset at 64x64 on a synthetic ScanNet tree (48x80 PNG frames,
written by the port's ``synth_scenes``): training saves, resumes from
``latest`` and from ``interrupt`` with the start iteration parsed from the
file name, and exits 75 under the host-RSS guard; a batch of 2 rescales
the schedule and freezes BatchNorm as the JAX CLI does; more ranks than
visible cards, ``--multihost`` without the launcher's ranks and an
unreadable backbone ``.pth`` raise. The eval CLI's threshold flags set the
fields the JAX CLI's set. The eval CLI on the trained checkpoint: device
metrics equal host metrics, batch 2 gives batch 1's tables (depth within
1e-5: the CPU convolutions sum a batch of one in another order), and the
``--output_coco_json`` dump decodes back to masks at the frames' size. The
JAX package's eval CLI reads the port's checkpoint and the port's reads a
JAX one: mAP tables within 1e-3 (points), depth metrics within 1e-4
relative of the other package's on the same weights.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from planerecnet_tpu.config import (PlaneRecNet_50_config,
                                    PlaneRecNet_tiny_config)
from planerecnet_tpu.data.coco import rle_to_mask as jax_rle_to_mask
from planerecnet_tpu.utils import checkpoint as jckpt
from planerecnet_tpu_torch import eval as teval
from planerecnet_tpu_torch import train as ttrain
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.data.coco import rle_to_mask
from planerecnet_tpu_torch.tools import synth_scenes
from planerecnet_tpu_torch.utils import SavePath
from test_torch_port_model import jax_variables, nest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import eval as jeval  # noqa: E402

torch.set_num_threads(2)
FRAME = (48, 80)
OVERRIDES = {"max_size": 64}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A directory holding ``scannet/`` (4 train, 2 valid, 3 eval frames),
    from which the presets' relative dataset paths resolve."""
    out = str(tmp_path_factory.mktemp("cli"))
    synth_scenes.generate_dataset(out, 4, 2, 3, h=FRAME[0], w=FRAME[1],
                                  seed=1, min_area=30, progress=False)
    return out


def _train(extra=(), max_iter=3):
    with redirect_stdout(io.StringIO()):
        return ttrain.main([
            "--config", "PlaneRecNet_tiny_config", "--batch_size", "2",
            "--device", "cpu", "--no_tensorboard", "--reproductablity",
            "--no_autoscale", "--validation_size", "2",
            "--cfg_overrides", json.dumps(dict(OVERRIDES, max_iter=max_iter))]
            + list(extra))


def _eval(weights, *extra, main=teval.main):
    with redirect_stdout(io.StringIO()):
        return main(["--trained_model", weights, "--max_images", "3",
                     "--score_threshold", "0.01", "--update_threshold",
                     "0.01", "--no_bar", "--seed", "4", "--cfg_overrides",
                     json.dumps(OVERRIDES)] + list(extra))


@pytest.fixture(scope="module")
def trained(workdir):
    """3 steps and a save, then a resume from ``latest`` to 5."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        first = _train()
        resumed = _train(["--resume", "latest"], max_iter=5)
    finally:
        os.chdir(cwd)
    return first, resumed


def test_train_saves_and_resumes_from_latest(trained, workdir):
    first, resumed = trained
    assert (first["start_iter"], first["iteration"]) == (0, 3)
    assert (resumed["start_iter"], resumed["iteration"]) == (3, 5)
    assert SavePath.from_str(first["checkpoint"]).iteration == 3
    assert SavePath.from_str(resumed["checkpoint"]).iteration == 5
    assert all(np.isfinite(v) for v in resumed["losses"].values())
    with np.load(os.path.join(workdir, resumed["checkpoint"])) as saved:
        assert int(saved["step"]) == 5 and int(saved["seed"]) == 42
        assert any(k.startswith("adam/exp_avg/") for k in saved.files)


def test_train_interrupt_and_resume(workdir, monkeypatch, tmp_path):
    """A KeyboardInterrupt in the first step writes ``*_interrupt``; the
    resume from ``interrupt`` starts at its iteration."""
    monkeypatch.chdir(workdir)
    folder = str(tmp_path / "weights") + "/"
    step = trainer.train_step
    calls = []

    def interrupted(state, batch):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return step(state, batch)
    monkeypatch.setattr(trainer, "train_step", interrupted)
    res = _train(["--save_folder", folder])
    assert res["iteration"] == 1 and "interrupt" in res["checkpoint"]
    assert SavePath.get_interrupt(folder) == res["checkpoint"]
    monkeypatch.setattr(trainer, "train_step", step)
    again = _train(["--save_folder", folder, "--resume", "interrupt"])
    assert (again["start_iter"], again["iteration"]) == (1, 3)


def test_train_host_rss_guard_exits_75(workdir, monkeypatch, tmp_path):
    monkeypatch.chdir(workdir)
    folder = str(tmp_path / "w") + "/"
    with pytest.raises(SystemExit) as exc:
        _train(["--save_folder", folder, "--max_host_rss_gb", "0.001"])
    assert exc.value.code == ttrain.RECYCLE_EXIT_CODE == 75
    latest = SavePath.get_latest(folder, "PlaneRecNet_tiny")
    assert SavePath.from_str(latest).iteration == 1


@pytest.mark.parametrize("extra,match", [
    (["--device", "cuda", "--n_devices", "2"],
     "asks for 2 cards, but 1 is visible"),
    (["--multihost"], "PRN_COORDINATOR_ADDRESS"),
], ids=["extra0-Queue 1 item 8", "extra1-Queue 1 item 8"])
def test_train_refuses_what_is_not_ported(extra, match, monkeypatch):
    """Data parallelism is ported (``tests/test_torch_port_parallel.py``,
    ``tests/test_torch_port_multicard.py``); ``--n_devices 2`` on a host
    with one card and ``--multihost`` without the launcher's ranks (no
    rank 0 to join) raise, naming the launcher."""
    monkeypatch.delenv("PRN_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=match + ".*run_multihost"):
        _train(extra)


def test_train_refuses_a_backbone_pth(workdir, monkeypatch, tmp_path):
    """The CLI loads a backbone .pth now (``utils/torch_convert.py``; the
    loading is held in ``tests/test_torch_port_convert.py``): one that
    does not load stops it, rather than training from fresh weights."""
    monkeypatch.chdir(workdir)
    (tmp_path / "resnet50-19c8e357.pth").write_bytes(b"")
    with pytest.raises(EOFError):
        _train(["--backbone_folder", str(tmp_path),
                "--save_folder", str(tmp_path / "w") + "/"])


class _Stop(Exception):
    pass


def test_train_autoscale_and_freeze_bn_match_jax(workdir, monkeypatch):
    """A batch of 2: lr, max_iter and lr_steps scaled by 2/8 and BatchNorm
    frozen, as the JAX CLI does (reference numbers from its formulas)."""
    monkeypatch.chdir(workdir)
    seen = {}

    def capture(cfg, **kw):
        seen["cfg"] = cfg
        raise _Stop
    monkeypatch.setattr(trainer, "create_train_state", capture)
    with pytest.raises(_Stop), redirect_stdout(io.StringIO()):
        ttrain.main(["--config", "PlaneRecNet_50_config", "--batch_size",
                     "2", "--device", "cpu", "--cfg_overrides",
                     json.dumps(OVERRIDES)])
    cfg, ref = seen["cfg"], PlaneRecNet_50_config
    assert cfg.lr == ref.lr * 0.25 and cfg.freeze_bn
    assert cfg.max_iter == int(ref.max_iter // 0.25)
    assert cfg.lr_steps == tuple(int(x // 0.25) for x in ref.lr_steps)


def test_eval_nms_overrides_match_jax():
    """No flag: the preset's thresholds; each flag sets its own field."""
    flags = ["--top_k", "17", "--nms_mode", "mask", "--score_threshold",
             "0.2", "--mask_threshold", "0.3", "--update_threshold", "0.4"]
    for argv in ([], flags):
        got = teval.apply_nms_overrides(
            teval.set_cfg("PlaneRecNet_50_config"), teval.parse_args(argv))
        want = jeval.apply_nms_overrides(
            jeval.set_cfg("PlaneRecNet_50_config"), jeval.parse_args(argv))
        for f in ("top_k", "nms_type", "score_thr", "mask_thr",
                  "update_thr"):
            assert getattr(got.solov2, f) == getattr(want.solov2, f), f


@pytest.mark.parametrize("cli", [ttrain, teval])
def test_cli_default_device_is_cuda(cli):
    """No --device: the card, or an error where there is none; never the
    CPU quietly."""
    assert cli.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"), \
                redirect_stdout(io.StringIO()):
            cli.main(["--config", "PlaneRecNet_tiny_config",
                      "--cfg_overrides", json.dumps(OVERRIDES)])


def test_eval_cli_metrics_paths_batches_and_coco_dump(trained, workdir,
                                                      monkeypatch, tmp_path):
    monkeypatch.chdir(workdir)
    weights = trained[1]["checkpoint"]
    dev = _eval(weights, "--device", "cpu", "--batch_size", "2")
    host = _eval(weights, "--device", "cpu", "--batch_size", "2",
                 "--host_metrics")
    one = _eval(weights, "--device", "cpu")
    assert dev["detections"] > 0
    assert dev["config"] == "PlaneRecNet_tiny_config"   # from the name
    for key in ("box", "mask", "depth", "detections"):
        assert host[key] == dev[key], key
    assert one["box"] == dev["box"] and one["mask"] == dev["mask"]
    np.testing.assert_allclose(list(one["depth"].values()),
                               list(dev["depth"].values()), rtol=1e-5,
                               atol=1e-7)
    bbox_file = str(tmp_path / "res" / "bbox.json")
    mask_file = str(tmp_path / "res" / "mask.json")
    assert _eval(weights, "--device", "cpu", "--output_coco_json",
                 "--bbox_det_file", bbox_file,
                 "--mask_det_file", mask_file) is None
    with open(bbox_file) as f:
        boxes = json.load(f)
    with open(mask_file) as f:
        masks = json.load(f)
    assert len(boxes) == len(masks) > 0
    scores = {}
    for b, m in zip(boxes, masks):
        assert set(b) == {"image_id", "category_id", "bbox", "score"}
        assert (b["image_id"], b["score"]) == (m["image_id"], m["score"])
        decoded = rle_to_mask(m["segmentation"])
        assert decoded.shape == FRAME
        np.testing.assert_array_equal(decoded,
                                      jax_rle_to_mask(m["segmentation"]))
        x, y, w, h = b["bbox"]
        assert -1 <= x <= FRAME[1] + 1 and -1 <= y <= FRAME[0] + 1
        scores.setdefault(b["image_id"], []).append(b["score"])
    for s in scores.values():
        assert s == sorted(s, reverse=True)


def _close(got, want):
    for kind in ("box", "mask"):
        np.testing.assert_allclose([got[kind][k] for k in want[kind]],
                                   list(want[kind].values()), rtol=0,
                                   atol=1e-3)
    np.testing.assert_allclose(list(got["depth"].values()),
                               list(want["depth"].values()), rtol=1e-4,
                               atol=0)


def test_checkpoints_cross_between_packages(trained, workdir, monkeypatch,
                                            tmp_path):
    """The JAX eval CLI on the port's train-state checkpoint, the port's
    on a JAX weights file: each agrees with the other package's CLI on the
    same file."""
    monkeypatch.chdir(workdir)
    port_ckpt = trained[1]["checkpoint"]
    jax_ckpt = str(tmp_path / "PlaneRecNet_tiny_0_0.npz")
    jckpt.save_weights(jax_ckpt, nest(jax_variables(
        PlaneRecNet_tiny_config.copy(OVERRIDES))))
    for weights in (port_ckpt, jax_ckpt):
        path = str(tmp_path / "jax_metrics.json")
        _eval(weights, "--batch_size", "3", "--metrics_json", path,
              main=jeval.main)
        with open(path) as f:
            want = json.load(f)
        got = _eval(weights, "--device", "cpu", "--batch_size", "3")
        _close({k: {str(i): v for i, v in got[k].items()}
                for k in ("box", "mask", "depth")}, want)
