"""The port's ``spatial`` mesh axis on the CPU: ranks over gloo.

The image height is split over the spatial ranks, and every exchange
that XLA SPMD inserts in the JAX package is written by hand
(``planerecnet_tpu_torch/parallel/halo.py``). Held here:

* The row-window ops, each on 2 and on 4 ranks against the unsplit op in
  one process: the output (put together from the ranks' rows, or whole on
  every rank), the input gradient (from the ranks' rows, or their sum
  where the input is whole on every rank) and the
  parameters' gradients (summed over the ranks, as DDP sums them), for a
  3x3 conv at stride 1 and 2, the stem's 7x7/s2, the stem's max pool, the
  reflection pad (on shards of one row too), the x2 and x0.5 bilinear
  resizes and one whose output does not split (the gather path), the
  GroupNorm, a training SyncBatchNorm on a row-sharded map (statistics
  over the world) and on a whole one (over the data axis), and a DCN
  layer at stride 1 and 2 with offsets of up to +-8 px (its samples land
  on other ranks' rows). Tolerance 1e-5 of each output's scale.
* ``deform_conv2d(row0=)`` in one process: the rows of a window are the
  whole convolution's, and the windows' input gradients add up to the
  whole one's.
* The tiny preset's forward at 2x64x64 on a (1, 2), a (1, 4) and a
  (2, 2) mesh (``jit_forward(spatial=True)``) against the JAX package's
  single-device ``apply`` on the same weights (carried across by
  ``utils/weights.py::from_jax_variables``): 1e-4, as
  ``tests/test_spmd.py``. On 4 ranks C5 (2 rows) is whole and C4 is cut
  into 1-row shards. The same at 2x32x32 on the (1, 4) and (2, 2) meshes,
  where the coarsest level is 1x1. In bf16 (``compute_dtype="bfloat16"``,
  the halo exchanges carrying bf16 rows) on the (1, 2) and (2, 2) meshes:
  against the JAX package's ``jit_forward(spatial=True)`` in bf16 on a
  (1, 2) grid of the virtual CPU mesh (each image's rows split in two, as
  on both of the port's grids), and against the port's unsplit bf16
  forward, within 3e-2 of each output's largest magnitude (the bf16
  tolerance of ``tests/test_torch_port_bf16.py``; each package rounds to
  bf16 at other places). Not on JAX's (2, 2) grid: there the JAX
  package's own bf16 outputs lie up to 0.17 of scale from its unsplit
  ones (mask_pred, kernel_preds; its (1, 2), (1, 4) and (2, 1) grids
  within 0.007), where the port's (2, 2) lies within 0.01 of its own.
* The tiny preset's training step on a (2, 2) and a (1, 4) mesh,
  BatchNorm training (synced), against the JAX package's unsharded step
  and the port's own (4, 1): losses rel 2e-4 / abs 1e-5 and parameters
  within 1e-4, as ``tests/test_trainer.py:172-195``; at that test's size
  and batch (4x32x32, ``_tiny_batch``), and at 4x64x64 on the batch
  recipe of ``tests/test_torch_port_trainer.py``. At 64x64, with
  BatchNorm frozen, every gradient leaf within 2e-4 of its scale of the
  port's one-process step (train-mode BatchNorm at this size makes the
  f32 gradient itself ill-conditioned, see
  ``tests/test_torch_port_trainer.py``). A (2, 2) checkpoint loads in one
  process.
* ``make_mesh`` refuses a grid that is not the world, and the spatial
  axis a height it cannot split.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp
from torch import nn

from planerecnet_tpu import trainer as jtrainer
from planerecnet_tpu.config import PlaneRecNet_tiny_config as JaxTiny
from planerecnet_tpu.models.planerecnet import PlaneRecNet as JaxPlaneRecNet
from planerecnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from planerecnet_tpu.parallel.spmd import jit_forward as jax_jit_forward
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.ops import dcn
from planerecnet_tpu_torch.parallel import mesh as pmesh
from planerecnet_tpu_torch.parallel.halo import Rows
from planerecnet_tpu_torch.tools.profile_spatial import split_run
from planerecnet_tpu_torch.tools.run_multihost import _free_port
from planerecnet_tpu_torch.utils import checkpoint
from planerecnet_tpu_torch.utils.weights import to_jax_variables
from test_torch_port_losses import jax_vnl_indices
from test_torch_port_model import images, jax_variables, nest, port_cfg
from test_trainer import _tiny_batch
from torch_spatial_ranks import OP_CASES, cotangent, op, op_input, rank_main
from torch_spatial_ranks import step as port_step

torch.set_num_threads(2)
LAUNCH_TIMEOUT = 120      # seconds the ranks of one spawn may take
OP_TOL = 1e-5             # of the output's (or gradient's) scale
FWD_TOL = dict(rtol=1e-4, atol=1e-4)           # tests/test_spmd.py
BF16_TOL = 3e-2           # of scale, tests/test_torch_port_bf16.py
LOSS_TOL = dict(rel=2e-4, abs=1e-5)            # tests/test_trainer.py
PARAM_TOL = 1e-4
LEAF_TOL = 2e-4
SIZE = 64
SMALL = 32                # the JAX test's size; its coarsest level is 1x1
FWD_CFGS = {n: JaxTiny.copy(dict(max_size=n)) for n in (SIZE, SMALL)}
BF16_CFG = FWD_CFGS[SIZE].copy(dict(compute_dtype="bfloat16"))
# The bf16 forward's grid on each spawn's ranks; the JAX package's, on
# which its bf16 outputs keep to its unsplit ones (module docstring).
BF16_GRIDS = {2: (1, 2), 4: (2, 2)}
JAX_BF16_GRID = (1, 2)
STEP_CFG = JaxTiny.copy(dict(max_instances=2, max_positives=16,
                             vnl_samples=32))


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= OP_TOL * scale, (what, err, scale)


def _step_cfgs():
    return {f: port_cfg(STEP_CFG.copy(dict(freeze_bn=f)))
            for f in (False, True)}


def _jax_step_state(flat):
    model = JaxPlaneRecNet(STEP_CFG)
    tree = nest(flat)
    return jtrainer.TrainState.create(
        apply_fn=model.apply, params=tree["params"],
        tx=jtrainer.make_optimizer(STEP_CFG, None, False),
        batch_stats=tree["batch_stats"],
        rng=jax.random.split(jax.random.PRNGKey(0))[1])


def _step_batch(size=SIZE):
    """At 64x64 ``tests/test_torch_port_trainer.py::_batch(seed=2)``'s
    recipe at 4 images; at 32x32 the JAX test's batch."""
    if size == SMALL:
        return _tiny_batch(4, SMALL, SMALL)
    batch = _tiny_batch(4, SIZE, SIZE)
    batch["masks"][1, 1, 30:60, 10:50] = 1
    batch["boxes"][1, 1] = [10, 30, 50, 60]
    batch["gt_valid"][1, 1] = True
    batch["image"] = np.random.RandomState(2).randn(
        4, SIZE, SIZE, 3).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _vnl(size=SIZE):
    """The VNL triplets the JAX step draws from its key."""
    state = _jax_step_state(jax_variables(STEP_CFG))
    return jax_vnl_indices(STEP_CFG, _step_batch(size),
                           jax.random.fold_in(state.rng, state.step))


@functools.lru_cache(maxsize=None)
def _jax_step(size=SIZE):
    """The JAX package's unsharded step at 4 x size^2: (losses, params)."""
    state = _jax_step_state(jax_variables(STEP_CFG))
    grads, new_bs, losses = jax.jit(functools.partial(
        jtrainer.grad_step, cfg=STEP_CFG))(state, _step_batch(size))
    state = jax.jit(jtrainer.apply_grads)(state, grads, new_bs,
                                          losses["total"])
    return ({k: float(v) for k, v in losses.items()},
            _flat_tree(state.params, "params"))


def _flat_tree(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat_tree(v, key) if hasattr(v, "items")
                   else {key: np.asarray(v)})
    return out


def _params(state_dict):
    return {k: v for k, v in to_jax_variables(state_dict).items()
            if k.startswith("params/")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """n -> the results of each rank of an n-rank spawn. Both spawns (2
    ranks, 4 ranks with the training steps and the 32x32 runs) start at
    the first request, and the JAX steps are computed while they run."""
    fwd = (port_cfg(FWD_CFGS[SIZE]), jax_variables(FWD_CFGS[SIZE]),
           images(seed=1))
    steps = (_step_cfgs(), jax_variables(STEP_CFG), _step_batch(), _vnl())
    small = ((port_cfg(FWD_CFGS[SMALL]), jax_variables(FWD_CFGS[SMALL]),
              images(size=SMALL, seed=1)),
             ({False: _step_cfgs()[False]}, jax_variables(STEP_CFG),
              _step_batch(SMALL), _vnl(SMALL)))
    bf16 = (port_cfg(BF16_CFG), jax_variables(FWD_CFGS[SIZE]),
            images(seed=1))
    ctx = mp.get_context("spawn")
    spawns = {}
    for n in (2, 4):
        out_dir = str(tmp_path_factory.mktemp(f"spatial{n}"))
        port = _free_port()
        procs = [ctx.Process(target=rank_main, args=(
            r, n, port, out_dir, fwd, steps if n == 4 else None,
            small if n == 4 else None, (BF16_GRIDS[n], bf16)))
            for r in range(n)]
        for p in procs:
            p.start()
        spawns[n] = (procs, out_dir)
    try:
        _jax_step()
        _jax_step(SMALL)
        _jax_forward_bf16(JAX_BF16_GRID)
        _port_forward_bf16()
    finally:
        results = {}
        for n, (procs, out_dir) in spawns.items():
            for p in procs:
                p.join(timeout=LAUNCH_TIMEOUT)
                if p.is_alive():
                    p.kill()
                    p.join()
            results[n] = ([p.exitcode for p in procs], out_dir)

    def get(n):
        codes, out_dir = results[n]
        assert codes == [0] * n, codes
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    return functools.lru_cache(maxsize=None)(get)


@functools.lru_cache(maxsize=None)
def _jax_forward(size=SIZE):
    model = JaxPlaneRecNet(FWD_CFGS[size])
    return jax.jit(lambda v, x: model.apply(v, x, train=False))(
        nest(jax_variables(FWD_CFGS[size])),
        jnp.asarray(images(size=size, seed=1)))


@functools.lru_cache(maxsize=None)
def _jax_forward_bf16(grid):
    """The JAX package's ``jit_forward(spatial=True)`` in bf16 on a
    (n_data, n_spatial) ``grid`` of the virtual CPU devices, as
    ``tests/test_spmd.py`` runs it (outputs f32, numpy)."""
    run = jax_jit_forward(BF16_CFG, jax_make_mesh(*grid), spatial=True)
    out = run(nest(jax_variables(FWD_CFGS[SIZE])), jnp.asarray(
        images(seed=1)))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), out)


@functools.lru_cache(maxsize=None)
def _port_forward_bf16():
    """The port's unsplit bf16 forward in this process (outputs f32)."""
    model = trainer.create_train_state(
        port_cfg(BF16_CFG), variables=jax_variables(FWD_CFGS[SIZE]),
        device="cpu").model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images(seed=1)))
    return {k: ([t.float().numpy() for t in v] if isinstance(v, list)
                else v.float().numpy()) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _one_process_step(freeze_bn):
    """The port's step in one process on the whole batch."""
    state = trainer.create_train_state(
        _step_cfgs()[freeze_bn], variables=jax_variables(STEP_CFG),
        device="cpu")
    return port_step(state, _step_batch(), _vnl())


# --- tests --------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(OP_CASES))
def test_row_window_op_matches_the_unsplit_op(ranks, name, n):
    got = [r["ops"][name] for r in ranks(n)]
    x = op_input(name).requires_grad_(True)
    m, y = op(name, x, None)
    (y * cotangent(name, y.shape)).sum().backward()
    sharded = {g["sharded"] for g in got}
    assert len(sharded) == 1
    if sharded.pop():
        _close(torch.cat([g["y"] for g in got], -2), y.detach(), "y")
    else:
        for g in got:
            _close(g["y"], y.detach(), "y")
    # A whole input is every rank's: its gradient is the ranks' sum.
    x_sharded = {g["x_sharded"] for g in got}
    assert len(x_sharded) == 1
    dx = (torch.cat([g["dx"] for g in got], -2) if x_sharded.pop()
          else sum(g["dx"] for g in got))
    _close(dx, x.grad, "dx")
    if m is not None:
        for k, p in m.named_parameters():
            _close(sum(g["params"][k] for g in got), p.grad, k)
    if isinstance(m, nn.BatchNorm2d):
        for g in got:
            _close(g["stats"]["mean"], m.running_mean, "running_mean")
            _close(g["stats"]["var"], m.running_var, "running_var")


def test_row_window_ops_cover_both_layouts(ranks):
    """On 4 ranks the x0.375 resize's output (6 rows) is whole, on 2 it is
    row-sharded; the 5-row output is whole on both."""
    assert not ranks(4)[0]["ops"]["resize_3_8"]["sharded"]
    assert ranks(2)[0]["ops"]["resize_3_8"]["sharded"]
    for n in (2, 4):
        assert not ranks(n)[0]["ops"]["resize_to_whole"]["sharded"]
        assert ranks(n)[0]["ops"]["conv3x3_s2"]["sharded"]
        assert ranks(n)[0]["ops"]["sync_batchnorm"]["x_sharded"]
        assert not ranks(n)[0]["ops"]["sync_batchnorm_whole"]["x_sharded"]


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv2d_row_windows_add_up(stride):
    """The rows of a window (``row0``) are the whole convolution's rows,
    and the windows' gradients add up to the whole one's."""
    rng = np.random.RandomState(stride)
    b, h, w, cin, cout = 2, 12, 7, 5, 4
    ho = (h + 2 - 3) // stride + 1
    wo = (w + 2 - 3) // stride + 1
    x = torch.tensor(rng.randn(b, h, w, cin).astype(np.float32))
    off = torch.tensor((rng.rand(b, ho, wo, 18) * 16 - 8).astype(np.float32))
    mask = torch.tensor(rng.rand(b, ho, wo, 9).astype(np.float32))
    weight = torch.tensor(rng.randn(3, 3, cin, cout).astype(np.float32))
    cot = torch.tensor(rng.randn(b, ho, wo, cout).astype(np.float32))

    def run(r0, r1):
        args = [t.clone().requires_grad_(True) for t in (x, off, mask,
                                                         weight)]
        args[1:3] = [a[:, r0:r1].detach().requires_grad_(True)
                     for a in args[1:3]]
        y = dcn.deform_conv2d(*args, stride=stride, padding=1, row0=r0)
        (y * cot[:, r0:r1]).sum().backward()
        return y.detach(), [a.grad for a in args]

    y, grads = run(0, ho)
    cuts = [0, 2, ho // 2, ho]
    parts = [run(r0, r1) for r0, r1 in zip(cuts, cuts[1:])]
    _close(torch.cat([p[0] for p in parts], 1), y, "y")
    for i, what in ((0, "dx"), (3, "dweight")):
        _close(sum(p[1][i] for p in parts), grads[i], what)
    for i, what in ((1, "doffset"), (2, "dmask")):
        _close(torch.cat([p[1][i] for p in parts], 1), grads[i], what)
    with pytest.raises(ValueError, match="outside"):
        dcn.deform_conv2d(x, off[:, :2], mask[:, :2], weight,
                          stride=stride, row0=ho - 1)


@pytest.mark.parametrize("n,run,size", [
    (2, "forward", SIZE), (4, "forward", SIZE), (4, "forward_2d", SIZE),
    (4, "forward", SMALL), (4, "forward_2d", SMALL),
    (2, "forward_bf16", SIZE), (4, "forward_2d_bf16", SIZE)],
    ids=["1x2", "1x4", "2x2", "1x4-32x32", "2x2-32x32", "1x2-bf16",
         "2x2-bf16"])
def test_spatial_forward_matches_jax(ranks, n, run, size):
    """``jit_forward(spatial=True)`` on a (1, 2), a (1, 4) and a (2, 2)
    mesh (one image a data index): every rank's outputs of the whole
    batch against the JAX package's single-device apply; in bf16, against
    the JAX package's split bf16 forward (``JAX_BF16_GRID``) and the
    port's unsplit bf16 forward, within ``BF16_TOL`` of each output's
    scale."""
    runs = [(r if size == SIZE else r["small"])[run] for r in ranks(n)]
    if run.endswith("_bf16"):
        wants = (_jax_forward_bf16(JAX_BF16_GRID), _port_forward_bf16())
        for got, want in ((g, w) for g in runs for w in wants):
            for key in ("cate_preds", "kernel_preds", "mask_pred",
                        "depth_pred"):
                pairs = (zip(got[key], want[key]) if isinstance(
                    got[key], list) else [(got[key], want[key])])
                for a, b in pairs:
                    assert a.shape == b.shape, key
                    scale = max(float(np.abs(b).max()), 1e-6)
                    assert float(np.abs(a - b).max()) <= BF16_TOL * scale, \
                        (key, float(np.abs(a - b).max()), scale)
        return
    want = _jax_forward(size)
    for got in runs:
        for key in ("cate_preds", "kernel_preds"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_allclose(a, np.asarray(b), err_msg=key,
                                           **FWD_TOL)
        for key in ("mask_pred", "depth_pred"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       err_msg=key, **FWD_TOL)


def test_profile_spatial_counts_the_exchanged_bytes(ranks, monkeypatch):
    """``tools/profile_spatial.py`` prices the exchanges of a real split:
    its own 2 ranks (the tiny preset at 2x64x64) count what the largest
    taker of the forward's ranks here took, in as many exchanges, and at
    least the other rank's half of the two outputs, gathered whole."""
    # One thread a rank, as the spawned ranks here: two ranks of the
    # default width contend for the cores (~20x slower).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = split_run("PlaneRecNet_tiny_config", SIZE, SIZE, 2, batch=2,
                    device="cpu")
    forward = [r["forward"] for r in ranks(2)]
    assert got["received_bytes"] == max(f["received_bytes"] for f in forward)
    assert {got["exchanges"]} == {f["exchanges"] for f in forward}
    outputs = _jax_forward()
    half = sum(np.asarray(outputs[k]).size // 2
               for k in ("mask_pred", "depth_pred"))
    assert got["received_bytes"] >= 4 * half
    assert got["value"] > 0


@pytest.mark.parametrize("mesh,size", [
    ((2, 2), SIZE), ((1, 4), SIZE), ((2, 2), SMALL), ((1, 4), SMALL)],
    ids=["2x2", "1x4", "2x2-32x32", "1x4-32x32"])
def test_spatial_step_matches_jax_and_data_parallel(ranks, mesh, size):
    want_losses, want_params = _jax_step(size)
    runs = [r if size == SIZE else r["small"] for r in ranks(4)]
    one = runs[0][(4, 1)][False]
    for got in (r[mesh][False] for r in runs):
        assert set(got[0]) == set(want_losses)
        for key, want in want_losses.items():
            assert got[0][key] == pytest.approx(want, **LOSS_TOL), key
            assert got[0][key] == pytest.approx(one[0][key], **LOSS_TOL), key
        params = _params(got[2])
        assert set(params) == set(want_params)
        for ref in (want_params, _params(one[2])):
            worst = max(float(np.abs(params[k] - np.asarray(ref[k])).max())
                        for k in params)
            assert worst < PARAM_TOL


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2), (1, 4)],
                         ids=["4x1", "2x2", "1x4"])
def test_spatial_step_gradients_match_one_process(ranks, mesh):
    """BatchNorm frozen: every gradient leaf, summed over the ranks, and
    the BatchNorm statistics of the BatchNorm-training step, against the
    port's step in one process."""
    frozen, training = _one_process_step(True), _one_process_step(False)
    for got in ranks(4):
        grads = got[mesh][True][1]
        for k, want in frozen[1].items():
            scale = max(float(want.abs().max()), 1e-6)
            err = float((grads[k] - want).abs().max())
            assert err <= LEAF_TOL * scale, (k, err, scale)
        stats = got[mesh][False][2]
        for k, want in training[2].items():
            if "running" in k:
                scale = max(float(want.abs().max()), 1e-6)
                err = float((stats[k] - want).abs().max())
                assert err <= LEAF_TOL * scale, (k, err, scale)


def test_spatial_checkpoint_loads_in_one_process(ranks):
    path = ranks(4)[0][(2, 2)]["checkpoint"]
    state = trainer.create_train_state(_step_cfgs()[False], device="cpu")
    checkpoint.load_train_state(path, state)
    assert state.step == 1
    want = ranks(4)[0][(2, 2)][False][2]
    for k, v in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):   # not saved
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_mesh_and_height_checks():
    """Without a process group there is one rank: a 1 x 2 mesh is refused;
    a 2-D mesh's data axis and pieces; heights that do not split."""
    with pytest.raises(ValueError, match="process group has 1"):
        pmesh.make_mesh("cpu", n_data=1, n_spatial=2)
    with pytest.raises(ValueError, match="process group has 1"):
        pmesh.make_mesh("cpu", n_spatial=2)
    mesh = pmesh.Mesh(size=8, rank=5, device=torch.device("cpu"),
                      n_spatial=4)
    assert (mesh.n_data, mesh.data_index, mesh.spatial_index) == (2, 1, 1)
    axis = mesh.data_axis()
    assert (axis.size, axis.rank, axis.n_spatial) == (2, 1, 1)
    assert pmesh.shard_batch(mesh, 6) == 3
    batch = {"image": np.arange(6 * 16 * 2 * 3).reshape(6, 16, 2, 3),
             "masks": np.zeros((6, 2, 16, 2)), "boxes": np.zeros((6, 2, 4))}
    piece = pmesh.local_rows(mesh, batch)
    np.testing.assert_array_equal(piece["image"], batch["image"][3:, 4:8])
    assert piece["masks"].shape == (3, 2, 4, 2)
    assert piece["boxes"].shape == (3, 2, 4)
    for h in (18, 8):    # not a multiple of 4; 2-row shards < the stem's 3
        with pytest.raises(ValueError, match="does not split"):
            pmesh.local_rows(mesh, dict(batch, image=np.zeros((6, h, 2, 3))))
        with pytest.raises(ValueError, match="does not split"):
            Rows(mesh, h, 2)
