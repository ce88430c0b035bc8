"""The train CLI's ``--n_devices`` as the JAX CLI has it, on the CPU.

The JAX CLI trains on every device by default (``train.py``: ``n_dev =
args.n_devices or len(jax.devices())``). The port's counts the visible
cards on ``cuda`` (``torch.cuda.device_count()``) and 1 on the CPU, and
with N > 1 starts the N ranks itself (``train.ranks_to_start``,
``train._start_ranks``, through ``tools/run_multihost.py::launch``), over
gloo here.

* ``train.main(["--device", "cpu", "--n_devices", "2", ...])`` without
  ``--multihost``: the tiny preset at 64x64 on a synthetic tree, 2 steps
  with ``--reproductablity`` and no random augmentation, BatchNorm synced
  (6 images a rank). Its checkpoint equals the launcher's 2-rank run of
  the same arguments in every bit (the same program) and matches one
  rank of that program (``--multihost``, as
  ``tests/test_torch_port_parallel.py`` runs it) within the JAX
  multihost tolerance (rtol 2e-4, atol 2e-5, ``tests/test_multihost.py``);
  rank 0 alone writes, and ``main`` returns rank 0's result. A rank
  that fails fails the CLI with its exit code.
* The default: 4 on ``cuda`` with 4 cards visible (the launch stubbed),
  1 on the CPU; ``--n_devices 1`` is the one-process path; more cards
  than are visible raises, naming both counts.
* The launcher reports the exit code of the first rank to fail, not a
  rank it killed.
"""

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from planerecnet_tpu_torch import train as ttrain
from planerecnet_tpu_torch.ops import cuda_build
from planerecnet_tpu_torch.tools import run_multihost, synth_scenes

torch.set_num_threads(2)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)       # tests/test_multihost.py
LAUNCH_TIMEOUT = 120                       # seconds a launch may take
STEPS, BATCH = 2, 12                       # 6 images a rank on 2 ranks
OVERRIDES = {"max_size": 64, "max_iter": STEPS,
             "augment": {"photometric_distort": False,
                         "random_mirror": False, "random_flip": False}}


def _args(save):
    return ["--config", "PlaneRecNet_tiny_config", "--device", "cpu",
            "--cfg_overrides", json.dumps(OVERRIDES),
            "--save_folder", save + "/", "--log_folder", save + "_logs/",
            "--batch_size", str(BATCH), "--num_workers", "1",
            "--validation_epoch", "0", "--no_tensorboard",
            "--save_interval", "100", "--no_autoscale", "--reproductablity"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLI's own 2 ranks, and the launcher's 2 ranks and one rank of
    the same program (``--multihost``), from a
    directory holding ``scannet/`` (24 train frames at 48x80): {name:
    (checkpoint, main's result, rank logs)}."""
    work = str(tmp_path_factory.mktemp("multicard"))
    synth_scenes.generate_dataset(work, 24, 0, 0, h=48, w=80, seed=1,
                                  min_area=30, progress=False)
    cwd, threads = os.getcwd(), os.environ.get("OMP_NUM_THREADS")
    os.chdir(work)
    os.environ["OMP_NUM_THREADS"] = "2"      # every rank, every run
    out = {}
    try:
        with redirect_stdout(io.StringIO()):
            result = ttrain.main(_args("cli2") + ["--n_devices", "2"])
            run_multihost.launch(2, _args("launcher2"), platform="cpu",
                                 log_dir="launcher2_logs",
                                 timeout=LAUNCH_TIMEOUT)
            run_multihost.launch(1, _args("one"), platform="cpu",
                                 log_dir="one_logs", timeout=LAUNCH_TIMEOUT)
    finally:
        os.chdir(cwd)
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    for name, res in (("cli2", result), ("launcher2", None), ("one", None)):
        files = os.listdir(os.path.join(work, name))
        assert len(files) == 1, (name, files)          # one writer
        out[name] = (os.path.join(work, name, files[0]), res,
                     os.path.join(work, name + "_logs"))
    return out


def test_cli_ranks_equal_the_launchers_ranks(runs):
    with np.load(runs["cli2"][0]) as a, np.load(runs["launcher2"][0]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key


def test_cli_ranks_match_one_rank(runs):
    with np.load(runs["one"][0]) as a, np.load(runs["cli2"][0]) as b:
        assert set(a.files) == set(b.files)
        assert int(a["step"]) == int(b["step"]) == STEPS
        for key in a.files:
            if a[key].dtype.kind != "f":
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                np.testing.assert_allclose(b[key], a[key], err_msg=key,
                                           **JAX_TOL)


def test_cli_returns_rank0s_result_and_rank0_alone_writes(runs):
    ckpt, result, log_dir = runs["cli2"]
    assert (result["start_iter"], result["iteration"]) == (0, STEPS)
    work = os.path.dirname(os.path.dirname(ckpt))
    assert os.path.samefile(os.path.join(work, result["checkpoint"]), ckpt)
    assert all(np.isfinite(v) for v in result["losses"].values())
    assert set(result) == {"start_iter", "iteration", "mean_occupancy",
                           "checkpoint", "losses"}
    # Rank 0 wrote to the CLI's output; rank 1 to its log, none of rank
    # 0's lines.
    assert os.listdir(os.path.join(log_dir, "ranks")) == ["worker1.log"]
    with open(os.path.join(log_dir, "ranks", "worker1.log")) as f:
        rank1 = f.read()
    assert "Begin training!" not in rank1 and "Training complete" \
        not in rank1


def test_a_failing_rank_fails_the_cli(tmp_path, monkeypatch):
    """A global batch that 2 ranks do not divide: each rank raises, and
    the CLI exits with their code."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(SystemExit) as exc, redirect_stdout(io.StringIO()):
        ttrain.main(["--device", "cpu", "--n_devices", "2",
                     "--config", "PlaneRecNet_tiny_config",
                     "--batch_size", "3", "--no_tensorboard",
                     "--log_folder", str(tmp_path / "logs") + "/"])
    assert exc.value.code == 1


def _stub_launch(seen):
    def launch(nproc, args, platform, log_dir, extra_env, stream_rank0):
        seen.append(dict(nproc=nproc, args=args, platform=platform,
                         stream_rank0=stream_rank0))
        with open(extra_env[ttrain.RESULT_FILE_VAR], "w") as f:
            json.dump({"iteration": 7}, f)
        return []
    return launch


def test_default_is_every_visible_card_on_cuda(monkeypatch):
    """No ``--n_devices`` on ``cuda`` with 4 cards: 4 ranks, each told
    ``--n_devices 4``, the kernels built once first; rank 0's result is
    ``main``'s."""
    seen, built = [], []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run_multihost, "launch", _stub_launch(seen))
    monkeypatch.setattr(cuda_build, "build", lambda: built.append(1))
    argv = ["--config", "PlaneRecNet_tiny_config", "--batch_size", "8"]
    assert ttrain.main(argv) == {"iteration": 7}
    assert built == [1]
    assert seen == [dict(nproc=4, args=argv + ["--n_devices", "4"],
                         platform="cuda", stream_rank0=True)]


@pytest.mark.parametrize("device,visible,n_devices,want", [
    ("cuda", 4, None, 4), ("cuda", 1, None, 1), ("cuda", 0, None, 1),
    ("cuda", 4, 2, 2), ("cuda", 4, 1, 1), ("cpu", 4, None, 1),
    ("cpu", 0, 3, 3)])
def test_ranks_to_start_resolves_as_jax(monkeypatch, device, visible,
                                        n_devices, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    assert ttrain.ranks_to_start(device, n_devices) == want


@pytest.mark.parametrize("argv", [["--n_devices", "1"], ["--device", "cpu"]],
                         ids=["cuda-n1", "cpu-default"])
def test_one_rank_is_the_one_process_path(monkeypatch, argv):
    """``--n_devices 1`` on a 4-card host, and the CPU's default: no ranks
    are started; ``_train`` gets a one-rank mesh."""
    meshes = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run_multihost, "launch", None)
    monkeypatch.setattr(ttrain, "_train",
                        lambda args, mesh: meshes.append(mesh) or {})
    ttrain.main(argv)
    assert [(m.size, m.device.type) for m in meshes] == [
        (1, "cpu" if "cpu" in argv else "cuda")]


@pytest.mark.parametrize("visible", [0, 2])
def test_more_cards_than_visible_raise(monkeypatch, visible):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(run_multihost, "launch", None)
    with pytest.raises(ValueError, match=f"--n_devices 4 asks for 4 cards, "
                                         f"but {visible} are visible"):
        ttrain.main(["--n_devices", "4"])
    with pytest.raises(ValueError, match="at least 1"):
        ttrain.ranks_to_start("cpu", 0)


def test_launcher_reports_the_first_rank_to_fail():
    """Rank 1 fails at once; rank 0, which would run on, is killed: the
    code is rank 1's, not the kill's."""
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    fail = [sys.executable, "-c", "import sys; sys.exit(3)"]
    procs = [subprocess.Popen(sleep), subprocess.Popen(fail)]
    t0 = time.monotonic()
    assert run_multihost._wait(procs, timeout=LAUNCH_TIMEOUT) == 3
    assert procs[1].returncode == 3 and procs[0].returncode != 0
    assert time.monotonic() - t0 < 30
