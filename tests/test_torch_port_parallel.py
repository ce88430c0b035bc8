"""The port's data parallelism on the CPU: ranks over gloo.

The reference for 2 ranks is one rank of the same program in one process
over the same global batches, as ``tests/test_multihost.py`` holds the
JAX package's 2-process run against its 1-process run (a sharded ``jit``
over two devices).

* Through the launcher (``tools/run_multihost.py``), the tiny preset at
  64x64 on a synthetic ScanNet tree (48x80 frames), 2 steps with
  ``--reproductablity`` and no random augmentation (its generator is
  drawn in each rank's shard order, so it differs across topologies, as
  in the JAX test): 2 ranks against 1, once with BatchNorm frozen (a
  per-rank batch of 2) and once synced (6). The shards are disjoint, rank
  0 alone writes, and the 2-rank checkpoint loads in one process.
  Tolerance: the JAX multihost test's, rtol 2e-4 and atol 2e-5, on every
  float leaf of the checkpoint (measured: 0.15% of it with BatchNorm
  frozen, 14% synced, the conv biases in front of a BatchNorm, whose
  gradient is rounding noise that Adam turns into +-lr steps). With
  BatchNorm synced the statistics are summed in f64
  (``SyncBatchNorm2d``): summed in f32 they differ with the split of the
  batch, and at random init that rounding is amplified through the
  layers (the Adam moments then differ by up to 10% of their scale).
* ``SyncBatchNorm2d`` over 2 ranks equals ``nn.BatchNorm2d`` over the
  whole batch: output, input and parameter gradients, running statistics
  (1e-5).
* ``compute_losses`` with a mesh: on an uneven split of positives (3 and
  1 instances), the ranks' losses sum to the whole batch's (1e-6), where
  normalising by each rank's own counts, as plain DDP does, does not.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.config import PlaneRecNet_tiny_config, set_cfg
from planerecnet_tpu_torch.losses import compute_losses, sample_vnl_indices
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.parallel import mesh as pmesh
from planerecnet_tpu_torch.parallel import spmd
from planerecnet_tpu_torch.tools import synth_scenes
from planerecnet_tpu_torch.tools.run_multihost import _free_port, launch
from planerecnet_tpu_torch.utils.checkpoint import load_train_state

torch.set_num_threads(2)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
LAUNCH_TIMEOUT = 120  # seconds a launch may take
OVERRIDES = {"max_size": 64,
             "augment": {"photometric_distort": False,
                         "random_mirror": False, "random_flip": False}}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """``scannet/`` with 24 train frames, the presets' relative paths."""
    out = str(tmp_path_factory.mktemp("dp"))
    synth_scenes.generate_dataset(out, 24, 0, 0, h=48, w=80, seed=1,
                                  min_area=30, progress=False)
    return out


def _run(workdir, nproc, batch_size, steps):
    """Launch ``nproc`` ranks on the CPU; returns (checkpoint, logs)."""
    save = os.path.join(workdir, f"w{nproc}_{batch_size}")
    args = ["--config", "PlaneRecNet_tiny_config",
            "--cfg_overrides", json.dumps(dict(OVERRIDES, max_iter=steps)),
            "--save_folder", save + "/", "--batch_size", str(batch_size),
            "--num_workers", "1", "--validation_epoch", "0",
            "--no_tensorboard", "--save_interval", "100", "--no_autoscale",
            "--reproductablity"]
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with redirect_stdout(io.StringIO()):
            logs = launch(nproc, args, platform="cpu",
                          log_dir=save + "_logs", timeout=LAUNCH_TIMEOUT,
                          extra_env={"PRN_DEBUG_BATCH_SUM": "1",
                                     "OMP_NUM_THREADS": "2"})
    finally:
        os.chdir(cwd)
    files = os.listdir(save)
    assert len(files) == 1, files          # one writer
    return os.path.join(save, files[0]), logs


def _batch_sums(log):
    sums = {}
    with open(log) as f:
        for line in f:
            if "batch_sum" in line:
                it = int(line.split("iter")[1].split()[0])
                sums[it] = float(line.rsplit(" ", 1)[1])
    return sums


@pytest.mark.parametrize("batch_size,frozen", [(4, True), (12, False)],
                         ids=["bn_frozen", "bn_synced"])
def test_two_ranks_equal_one_rank(workdir, batch_size, frozen, steps=2):
    ckpt1, _ = _run(workdir, 1, batch_size, steps)
    ckpt2, logs = _run(workdir, 2, batch_size, steps)

    # Disjoint shards: the ranks' batches differ at every step.
    sums = [_batch_sums(log) for log in logs]
    assert sorted(sums[0]) == sorted(sums[1]) == list(range(steps))
    assert all(sums[0][i] != sums[1][i] for i in range(steps))
    with open(logs[1]) as f:
        rank1 = f.read()
    assert "Begin training!" not in rank1 and "Saving state" not in rank1
    assert ("Disabling batch norm" in rank1) == frozen

    a, b = np.load(ckpt1), np.load(ckpt2)
    assert set(a.files) == set(b.files)
    assert int(a["step"]) == int(b["step"]) == steps
    for key in a.files:
        if a[key].dtype.kind != "f":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            np.testing.assert_allclose(b[key], a[key], err_msg=key,
                                       **JAX_TOL)

    # The 2-rank checkpoint resumes in one process.
    cfg = set_cfg("PlaneRecNet_tiny_config").copy(dict(max_size=64,
                                                       freeze_bn=frozen))
    state = trainer.create_train_state(cfg, device="cpu")
    load_train_state(ckpt2, state)
    assert state.step == steps and not any(
        isinstance(m, spmd.SyncBatchNorm2d) for m in state.model.modules())
    np.testing.assert_array_equal(
        state.model.state_dict()["fpn.fpn_convs.0.weight"].numpy(),
        np.load(ckpt2)["params/fpn/fpn_conv0/kernel"].transpose(3, 2, 0, 1))


def test_n_devices_must_match_the_ranks(monkeypatch):
    """Without a process group there is one rank: ``--n_devices 2`` and a
    global batch the ranks do not divide raise; ``--multihost`` without
    the launcher's variables raises."""
    with pytest.raises(ValueError, match="process group has 1"):
        pmesh.make_mesh("cpu", n_data=2)
    mesh = pmesh.Mesh(size=4, rank=1, device=torch.device("cpu"))
    assert pmesh.shard_batch(mesh, 8) == 2
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_batch(mesh, 6)
    for var in ("PRN_COORDINATOR_ADDRESS", "PRN_NUM_PROCESSES",
                "PRN_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="PRN_COORDINATOR_ADDRESS"):
        spmd.initialize_distributed("cpu")


def _sync_bn_rank(rank, port, x, cot, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        torch.manual_seed(0)
        bn = torch.nn.BatchNorm2d(x.shape[1], momentum=0.3)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
        model = spmd.convert_sync_batchnorm(torch.nn.Sequential(bn))
        half = x.shape[0] // 2
        xr = x[rank * half:(rank + 1) * half].clone().requires_grad_(True)
        y = model(xr)
        (y * cot[rank * half:(rank + 1) * half]).sum().backward()
        sync = model[0]
        torch.save({"y": y.detach(), "dx": xr.grad, "dw": sync.weight.grad,
                    "db": sync.bias.grad, "mean": sync.running_mean,
                    "var": sync.running_var,
                    "n": sync.num_batches_tracked},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_sync_batchnorm_equals_batchnorm_over_the_global_batch(tmp_path):
    rng = np.random.RandomState(0)
    x = torch.tensor((rng.randn(4, 6, 5, 7) * 0.5 + rng.randn(6, 1, 1)
                      ).astype(np.float32))
    cot = torch.tensor(rng.randn(*x.shape).astype(np.float32))
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_sync_bn_rank,
                         args=(r, port, x, cot, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=LAUNCH_TIMEOUT)
        assert not p.is_alive() and p.exitcode == 0
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    torch.manual_seed(0)
    bn = torch.nn.BatchNorm2d(x.shape[1], momentum=0.3)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xf = x.clone().requires_grad_(True)
    y = bn(xf)
    (y * cot).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(torch.cat([g["dx"] for g in got]).numpy(),
                               xf.grad.numpy(), **tol)
    np.testing.assert_allclose((got[0]["dw"] + got[1]["dw"]).numpy(),
                               bn.weight.grad.numpy(), **tol)
    np.testing.assert_allclose((got[0]["db"] + got[1]["db"]).numpy(),
                               bn.bias.grad.numpy(), **tol)
    for g in got:
        np.testing.assert_allclose(g["mean"].numpy(),
                                   bn.running_mean.numpy(), **tol)
        np.testing.assert_allclose(g["var"].numpy(), bn.running_var.numpy(),
                                   **tol)
        assert int(g["n"]) == int(bn.num_batches_tracked) == 1


class _Mesh:
    """Two ranks in one process: ``all_sum`` returns the counts given."""

    def __init__(self, rank, counts=None):
        self.size, self.rank, self.counts, self.seen = 2, rank, counts, None

    def all_sum(self, t):
        self.seen = t.detach().clone()
        return t if self.counts is None else self.counts


def _uneven_batch():
    """Two 64x64 images: three valid instances in the first, one in the
    second, so the ranks' positive counts differ."""
    rng = np.random.RandomState(3)
    b, n, s = 2, 4, 64
    masks = np.zeros((b, n, s, s), np.float32)
    boxes = np.zeros((b, n, 4), np.float32)
    valid = np.zeros((b, n), bool)
    for i, j, (y0, x0, y1, x1) in [(0, 0, (4, 4, 30, 40)),
                                   (0, 1, (34, 8, 60, 28)),
                                   (0, 2, (36, 36, 60, 60)),
                                   (1, 0, (10, 20, 50, 44))]:
        masks[i, j, y0:y1, x0:x1] = 1
        boxes[i, j] = [x0, y0, x1, y1]
        valid[i, j] = True
    planes = np.zeros((b, n, 4), np.float32)
    planes[..., :3] = rng.randn(b, n, 3)
    planes[..., :3] /= np.linalg.norm(planes[..., :3], axis=-1,
                                      keepdims=True)
    k = np.tile(np.array([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    return {"image": torch.tensor(rng.randn(b, s, s, 3).astype(np.float32)),
            "depth": torch.tensor((rng.rand(b, s, s, 1) * 3 + 0.5
                                   ).astype(np.float32)),
            "masks": torch.tensor(masks), "boxes": torch.tensor(boxes),
            "classes": torch.zeros((b, n), dtype=torch.int32),
            "gt_valid": torch.tensor(valid),
            "plane_paras": torch.tensor(planes), "k_matrix": torch.tensor(k)}


def test_global_normalisers_sum_to_the_whole_batch_loss():
    cfg = PlaneRecNet_tiny_config.copy(dict(max_size=64, max_instances=4))
    torch.manual_seed(0)
    model = PlaneRecNet(cfg).eval()
    batch = _uneven_batch()
    with torch.no_grad():
        preds = model(batch["image"])

    def losses(rows, mesh):
        part = {k: (v[rows] if torch.is_tensor(v) else
                    [t[rows] for t in v]) for k, v in preds.items()}
        gen = torch.Generator().manual_seed(7)
        return compute_losses(cfg, part, {k: v[rows] for k, v in
                                          batch.items()},
                              generator=gen, mesh=mesh)

    whole = losses(slice(0, 2), None)
    local = [_Mesh(r) for r in range(2)]
    naive = [losses(slice(r, r + 1), local[r]) for r in range(2)]
    counts = local[0].seen + local[1].seen
    assert not torch.equal(local[0].seen, local[1].seen)   # uneven split
    ranks = [losses(slice(r, r + 1), _Mesh(r, counts)) for r in range(2)]
    for key, want in whole.items():
        got = ranks[0][key] + ranks[1][key]
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    # Plain DDP: each rank normalises by its own counts, the mean is taken.
    plain = {k: float(naive[0][k] + naive[1][k]) / 2 for k in whole}
    assert abs(plain["ins"] - float(whole["ins"])) > 1e-3 * abs(
        float(whole["ins"]))


@pytest.mark.parametrize("first", [0, 1, 2])
def test_vnl_rows_draw_the_global_batch(first):
    """A rank's triplets are the whole batch's draws at its rows."""
    rng = np.random.RandomState(first)
    masks = torch.tensor(rng.rand(3, 2, 8, 8) > 0.5)
    nonplanar = torch.tensor(rng.rand(3, 64) > 0.5)
    whole = sample_vnl_indices(torch.Generator().manual_seed(5), masks,
                               nonplanar, 16)
    part = sample_vnl_indices(torch.Generator().manual_seed(5),
                              masks[first:first + 1],
                              nonplanar[first:first + 1], 16,
                              rows=(first, 3))
    for key, value in whole.items():
        assert torch.equal(part[key], value[first:first + 1]), key
