"""The port's bf16 mode on the CPU: the four tests of ``tests/test_bf16.py``
for the port, and the port's bf16 forward against the JAX package's.

The bf16 mode runs the forward under ``torch.autocast`` (convolutions and
matrix products in bf16), the norms in f32 (``models/layers.py``), the
DCN offsets in f32 and the losses in f32; the parameters, BatchNorm
statistics and Adam's state stay f32. The JAX package's bf16 mode is
flax's ``dtype=bfloat16`` with f32 parameters and f32 norms.

Tolerances, as the JAX tests state them: bf16 against f32, depth within 5%
(mean relative) and category logits within 0.1 (mean absolute); "auto"
equal to f32 in every bit; the post-processing gate (top-5 masks matched
by IoU, each >= 0.97 and mean >= 0.98, equal classes, scores within 2e-2,
depth within 1% mean relative error); 20 bf16 training steps finite with
the last loss below 0.95 of the first. The port's bf16 forward against
JAX's on the same seeded variables: within 3e-2 of each output's largest
magnitude (measured 9.6e-3 to 1.9e-2, where each package's bf16 lies
9.0e-3 to 2.3e-2 from its own f32: the two round at different places, see
CHANGES.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import bf16_gate, gate_cfg
from planerecnet_tpu.config import PlaneRecNet_50_config as J50
from planerecnet_tpu.models.planerecnet import PlaneRecNet as JaxPlaneRecNet
from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.config import (PlaneRecNet_50_config,
                                          PlaneRecNet_tiny_config)
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
from planerecnet_tpu_torch.utils.weights import flatten_variables
from test_torch_port_model import jax_variables, nest, port_model
from test_trainer import _tiny_batch

torch.set_num_threads(2)
GRIDS = dict(num_grids=(10, 9, 6, 4))


def _cfg(dtype, base=PlaneRecNet_50_config, **kw):
    return base.copy(dict(max_size=64, compute_dtype=dtype,
                          solov2=base.solov2.copy(GRIDS), **kw))


def _model(dtype, seed=0):
    torch.manual_seed(seed)
    return PlaneRecNet(_cfg(dtype)).eval()


def _same_weights(dst, src):
    dst.load_state_dict(src.state_dict())
    return dst


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(np.array(x)))


def test_bf16_matches_f32_closely():
    m32 = _model("float32")
    mbf = _same_weights(_model("bfloat16"), m32)
    # A pure compute-dtype change: the same variables, all f32.
    assert list(m32.state_dict()) == list(mbf.state_dict())
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in mbf.state_dict().values())
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    out32, outbf = _forward(m32, x), _forward(mbf, x)
    assert outbf["cate_preds"][0].dtype == torch.bfloat16   # bf16 inside
    d32 = out32["depth_pred"].float().numpy()
    dbf = outbf["depth_pred"].float().numpy()
    assert np.abs(d32 - dbf).mean() / (np.abs(d32).mean() + 1e-6) < 0.05
    c32 = out32["cate_preds"][0].float().numpy()
    cbf = outbf["cate_preds"][0].float().numpy()
    assert np.abs(c32 - cbf).mean() < 0.1


def test_auto_dtype_is_f32():
    """"auto" is f32 in the port, on every device: its outputs equal the
    explicit f32 model's in every bit."""
    m32 = _model("float32")
    mauto = _same_weights(_model("auto"), m32)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    a, b = _forward(mauto, x), _forward(m32, x)
    for key in ("depth_pred", "mask_pred"):
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())


def test_bf16_postprocess_gate():
    """``tests/test_bf16.py``'s gate on the port, on its fixture: the JAX
    init's variables (``PRNGKey(0)``, carried across), a low-frequency
    input (8x10 noise upsampled) at 128x160, the dynamic-kernel head
    amplified 12x so that mask logits are confident, as after training."""
    h, w = 128, 160
    rng = np.random.RandomState(7)
    from planerecnet_tpu.ops.image import resize_bilinear as jresize
    x = np.asarray(jresize(jnp.asarray(rng.randn(1, 8, 10, 3) * 2,
                                       jnp.float32), (h, w)))
    variables = JaxPlaneRecNet(J50.copy(dict(compute_dtype="float32"))).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    flat = {k: np.asarray(v) for k, v in flatten_variables(
        jax.device_get(variables)).items()}
    flat["params/inst_head/kernel_pred/kernel"] = \
        flat["params/inst_head/kernel_pred/kernel"] * 12.0
    base = PlaneRecNet_50_config
    m32 = port_model(J50.copy(dict(compute_dtype="float32")), flat)
    mbf = port_model(J50.copy(dict(compute_dtype="bfloat16")), flat)
    p32, pbf = _forward(m32, x), _forward(mbf, x)
    cfg = gate_cfg(base, p32["cate_preds"])
    ious, iou_ok, _, _ = bf16_gate(postprocess_batch(p32, cfg, (h, w)),
                                   postprocess_batch(pbf, cfg, (h, w)))
    assert iou_ok, ious


def test_bf16_training_is_stable_without_loss_scaling():
    """20 bf16 steps on one batch of the tiny preset: every loss finite,
    the last total below 0.95 of the first (f32 parameters and Adam)."""
    cfg = PlaneRecNet_tiny_config.copy(dict(
        compute_dtype="bfloat16", max_instances=2, max_size=64))
    state = trainer.create_train_state(cfg, seed=1, device="cpu")
    batch = _tiny_batch(4, 64, 64)
    totals = []
    for i in range(20):
        losses = trainer.train_step(state, batch)
        assert all(torch.isfinite(v) for v in losses.values()), i
        totals.append(float(losses["total"]))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert totals[-1] < totals[0] * 0.95, totals


def test_bf16_forward_matches_jax_bf16():
    """The same seeded variables through both packages' bf16 forward."""
    jcfg = J50.copy(dict(max_size=64, compute_dtype="bfloat16",
                         solov2=J50.solov2.copy(GRIDS)))
    flat = jax_variables(jcfg.copy(dict(compute_dtype="float32")))
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    want = JaxPlaneRecNet(jcfg).apply(nest(flat), jnp.asarray(x),
                                      train=False)
    got = _forward(port_model(jcfg, flat), x)
    for key in ("cate_preds", "kernel_preds", "mask_pred", "depth_pred"):
        ws = want[key] if isinstance(want[key], list) else [want[key]]
        gs = got[key] if isinstance(got[key], list) else [got[key]]
        for wv, gv in zip(ws, gs):
            wv = np.asarray(jax.device_get(wv), np.float32)
            err = np.abs(gv.float().numpy() - wv).max()
            assert err <= 3e-2 * np.abs(wv).max(), (key, err)
