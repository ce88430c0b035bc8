"""The port's closed loop (``planerecnet_tpu_torch/tools/closed_loop.py``).

The plumbing test drives the tool end to end on the CPU at the tiny
preset: synthetic scenes, the train CLI in a subprocess (relaunched after
its host-RSS guard exits 75), the eval CLI on every checkpoint, the curve
and the summary. The learning bar is the JAX package's
(``tests/test_closed_loop.py``), slow-marked as it is there.
"""

import json
import os

import pytest

from planerecnet_tpu_torch.tools import closed_loop

TINY = {"max_size": 64, "max_instances": 6, "max_positives": 16,
        "vnl_samples": 32, "lr_steps": [100000],
        "augment": {"photometric_distort": False}}


def test_closed_loop_plumbing(tmp_path):
    summary = closed_loop.main([
        "--workdir", str(tmp_path), "--config", "PlaneRecNet_tiny_config",
        "--train_images", "4", "--val_images", "0",
        "--eval_gen_images", "2", "--size", "64",
        "--iters", "4", "--ckpt_every", "2", "--batch_size", "2",
        "--eval_images", "2", "--cfg_overrides", json.dumps(TINY),
        "--device", "cpu",
        # Past this cap after every step: the CLI saves, exits 75 and is
        # relaunched with --resume latest, which adds a checkpoint at every
        # step to the two of --ckpt_every.
        "--max_host_rss_gb", "0.001"])
    assert [row["iter"] for row in summary["curve"]] == [1, 2, 3, 4]
    for row in summary["curve"]:
        assert os.path.exists(tmp_path / f"metrics_{row['iter']}.json")
        for key in ("mask_ap50", "mask_ap", "box_ap50", "abs_rel", "rmse",
                    "a1"):
            assert row[key] == row[key], f"NaN {key} at {row}"
    assert set(summary["offset_spread"]) == {1, 2, 3, 4}
    for spread in summary["offset_spread"].values():
        assert spread and all(v["std"] >= 0 for v in spread.values())
    with open(tmp_path / "closed_loop.json") as f:
        assert json.load(f)["curve"] == summary["curve"]
    for r in range(1, 5):   # one relaunch a step, the last one to save
        with open(tmp_path / f"train_r{r}.log") as f:
            assert "Resuming training from" in f.read()
    assert not os.path.exists(tmp_path / "train_r5.log")


@pytest.mark.slow
def test_closed_loop_miniature(tmp_path):
    overrides = dict(TINY, max_size=96)
    summary = closed_loop.main([
        "--workdir", str(tmp_path), "--config", "PlaneRecNet_tiny_config",
        "--train_images", "8", "--val_images", "0",
        "--eval_gen_images", "4", "--size", "96",
        "--iters", "120", "--ckpt_every", "60",
        "--batch_size", "2", "--eval_images", "4",
        "--cfg_overrides", json.dumps(overrides), "--device", "cpu"])

    curve = summary["curve"]
    assert [row["iter"] for row in curve] == [60, 120]
    for row in curve:
        for key in ("mask_ap50", "abs_rel", "rmse", "a1"):
            assert row[key] == row[key], f"NaN metric {key} at {row}"
    # The JAX package's lenient bar: depth error must improve across
    # checkpoints while overfitting 8 images.
    assert curve[-1]["abs_rel"] < curve[0]["abs_rel"] * 1.05, (
        f"depth abs_rel did not improve: {curve}")
    assert os.path.exists(tmp_path / "closed_loop.json")
