"""The port's spans (``planerecnet_tpu_torch/utils/timer.py``) on the CPU.

* Off (the default), ``span`` returns the shared no-op, nothing is
  recorded, and no ``record_function`` range is opened even while a
  profile records.
* On, two training steps of the tiny preset each give the span tree of
  ``trainer.train_step`` (two roots, every parent right); with
  remat one ``backbone.recompute`` a recomputed block, inside
  ``trainer.backward``, and none without; ``infer`` gives
  ``runner.request`` over upload, forward and post-processing.
* Under ``torch.profiler`` each span is a ``user_annotation`` of the
  trace, nested as recorded.
* Self time is the duration less the children's.
* Spans opened on other threads under one root all close, each under the
  root's innermost open span or its own thread's.
* Tracing on changes no number: losses, parameters, Adam's moments and
  the BatchNorm buffers after two steps, with remat and without, and
  ``infer``'s outputs, all in every bit.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from planerecnet_tpu_torch import trainer
from planerecnet_tpu_torch.config import PlaneRecNet_tiny_config
from planerecnet_tpu_torch.models import backbone
from planerecnet_tpu_torch.runner import PlaneRecNetRunner
from planerecnet_tpu_torch.utils import timer

torch.set_num_threads(2)
SIZE = 64
TINY_BLOCKS = 4           # the tiny preset's stage bottlenecks
STEP_TREE = [             # (name, parent's name), in the order they open
    ("trainer.step", None),
    ("trainer.upload", "trainer.step"),
    ("trainer.forward", "trainer.step"),
    ("heads.instance", "trainer.forward"),
    ("trainer.loss", "trainer.step"),
    ("loss.targets", "trainer.loss"),
    ("trainer.backward", "trainer.step"),
    ("trainer.apply_grads", "trainer.step"),
    ("trainer.finite_read", "trainer.apply_grads"),
]
REQUEST_TREE = [
    ("runner.request", None),
    ("runner.upload", "runner.request"),
    ("runner.forward", "runner.request"),
    ("heads.instance", "runner.forward"),
    ("runner.postprocess", "runner.request"),
]


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no records."""
    timer.tracing(False)
    timer.collect()
    yield
    timer.tracing(False)
    timer.collect()


def _cfg(remat=False):
    return PlaneRecNet_tiny_config.copy(dict(
        max_size=SIZE, lr=1e-3, lr_warmup_until=0, remat_backbone=remat))


def _batch(seed, b=2, h=SIZE, w=SIZE, n=4):
    """A wire batch: u8 BGR images, one box and mask an image."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((b, n, h, w), np.float32)
    masks[:, 0, 8:40, 8:40] = 1
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[:, 0] = [8, 8, 40, 40]
    gt_valid = np.zeros((b, n), bool)
    gt_valid[:, 0] = True
    planes = np.zeros((b, n, 4), np.float32)
    planes[..., 2] = 1.0
    return {
        "image": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        "depth": (rng.rand(b, h, w, 1) * 3 + 0.5).astype(np.float32),
        "masks": masks, "boxes": boxes,
        "classes": np.ones((b, n), np.int32), "gt_valid": gt_valid,
        "plane_paras": planes,
        "k_matrix": np.tile(np.array([[50., 0, w / 2], [0, 50., h / 2],
                                      [0, 0, 1]], np.float32), (b, 1, 1)),
    }


def _two_steps(remat):
    """A fresh state's two steps: (losses, state)."""
    state = trainer.create_train_state(_cfg(remat), seed=0, device="cpu")
    losses = [trainer.train_step(state, _batch(i)) for i in range(2)]
    return losses, state


def _tree(spans, i):
    s = spans[i]
    return (s.name, None if s.parent is None else spans[s.parent].name)


def _root(spans, i):
    """The index of span ``i``'s root."""
    while spans[i].parent is not None:
        i = spans[i].parent
    return i


def _frame():
    return np.random.RandomState(3).randint(
        0, 256, (1, SIZE, SIZE, 3)).astype(np.uint8)


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    """Off, even while a profile records, a step and a request open no
    ``record_function`` range for a span and record nothing; ``span`` is
    the shared no-op. On, the same patch fails the first span: it bites.
    (PyTorch's optimizer opens ranges of its own, which pass.)"""
    original = autograd_profiler.record_function
    names = {n for n, _ in STEP_TREE + REQUEST_TREE} | {
        "backbone.recompute", "a", "b"}

    def refuse(name, *args, **kwargs):
        if name in names:
            raise AssertionError("record_function entered")
        return original(name, *args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    assert timer.span("a") is timer.span("b") is timer._OFF
    with timer.span("a"), timer.span("b"):
        pass
    state = trainer.create_train_state(_cfg(True), seed=0, device="cpu")
    trainer.train_step(state, _batch(0))
    runner = PlaneRecNetRunner(_cfg(), seed=0, device="cpu")
    runner.infer(_frame())
    assert timer.collect() == []
    timer.tracing(True)
    with pytest.raises(AssertionError, match="record_function entered"):
        with timer.span("a"):
            pass


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_span_tree(remat, monkeypatch):
    """Two steps, each the tree of ``trainer.train_step`` under its own
    root; with remat one ``backbone.recompute`` a recomputed block, each
    inside ``trainer.backward``."""
    calls = []
    remat_fn = backbone._remat

    def counted(block, x, rows):
        calls.append(block)
        return remat_fn(block, x, rows)

    monkeypatch.setattr(backbone, "_remat", counted)
    timer.tracing(True)
    _two_steps(remat)
    spans = timer.collect()
    assert len(calls) == (2 * TINY_BLOCKS if remat else 0)
    recompute = [i for i, s in enumerate(spans)
                 if s.name == "backbone.recompute"]
    assert len(recompute) == len(calls)
    for i in recompute:
        assert _tree(spans, i) == ("backbone.recompute", "trainer.backward")
    rest = [i for i in range(len(spans)) if i not in recompute]
    assert [_tree(spans, i) for i in rest] == STEP_TREE * 2
    roots = [i for i in range(len(spans)) if spans[i].parent is None]
    assert [spans[i].name for i in roots] == ["trainer.step"] * 2
    for i, s in enumerate(spans):
        assert _root(spans, i) == max(r for r in roots if r <= i)
        assert s.thread == threading.get_ident()
        assert 0 <= s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_request_span_tree():
    """``infer``: one ``runner.request`` a request, over upload, forward
    and post-processing."""
    runner = PlaneRecNetRunner(_cfg(), seed=0, device="cpu")
    runner.infer(_frame())          # not traced: nothing recorded
    timer.tracing(True)
    for _ in range(2):
        runner.infer(_frame())
    spans = timer.collect()
    assert [_tree(spans, i) for i in range(len(spans))] == REQUEST_TREE * 2
    n = len(REQUEST_TREE)
    assert [_root(spans, i) for i in range(len(spans))] == [0] * n + [n] * n


def test_spans_are_user_annotations_under_the_profiler():
    """While a profile records, each span is a ``user_annotation`` of the
    trace, with the span's name, on the recording thread."""
    from torch.profiler import ProfilerActivity, profile

    state = trainer.create_train_state(_cfg(), seed=0, device="cpu")
    timer.tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, _batch(0))
    spans = timer.collect()
    names = {s.name for s in spans}
    got = sorted(e.name for e in prof.events() if e.name in names)
    assert got == sorted(s.name for s in spans)


def test_self_time_is_the_duration_less_the_children():
    spans = [timer.Span("root", None, 1, 0, 100),
             timer.Span("a", 0, 1, 10, 40),
             timer.Span("b", 1, 1, 15, 25),
             timer.Span("c", 0, 2, 50, 90)]
    assert timer.self_ns(spans) == [100 - 30 - 40, 30 - 10, 10, 40]
    timer.tracing(True)
    with timer.span("root"):
        with timer.span("a"):
            with timer.span("b"):
                pass
        with timer.span("c"):
            pass
    got = timer.collect()
    dur = [s.end_ns - s.start_ns for s in got]
    assert timer.self_ns(got) == [dur[0] - dur[1] - dur[3],
                                  dur[1] - dur[2], dur[2], dur[3]]
    assert [s.parent for s in got] == [None, 0, 1, 0]


def test_threads_under_one_root():
    """Threads that open spans while the main thread holds a root: every
    record closes, each thread's outer spans nest under the root's
    innermost open span and its inner ones under its own; no record is
    lost (a short switch interval forces interleaving)."""
    n_threads, n_spans = 8, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timer.tracing(True)
    try:
        def work():
            for _ in range(n_spans):
                with timer.span("outer"):
                    with timer.span("inner"):
                        pass

        with timer.span("root"):
            with timer.span("wait"):
                threads = [threading.Thread(target=work)
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = timer.collect()
    assert len(spans) == 2 + 2 * n_threads * n_spans
    for i, s in enumerate(spans):
        assert s.end_ns >= s.start_ns >= 0
        assert _root(spans, i) == 0
    for s in spans[2:]:
        p = spans[s.parent]
        if s.name == "outer":
            assert p.name == "wait"
        else:
            assert (p.name, p.thread) == ("outer", s.thread)


def _state_numbers(losses, state):
    out = {f"loss{i}/{k}": v.detach().clone()
           for i, step in enumerate(losses) for k, v in step.items()}
    out.update({f"param/{n}": p.detach().clone()
                for n, p in state.model.named_parameters()})
    out.update({f"buffer/{n}": b.detach().clone()
                for n, b in state.model.named_buffers()})
    for n, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"adam/{n}/{k}"] = torch.as_tensor(v).detach().clone()
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_tracing_changes_no_number(remat):
    """The same weights and batches, traced and not: every loss,
    parameter, Adam moment and BatchNorm buffer after two steps in every
    bit."""
    off = _state_numbers(*_two_steps(remat))
    timer.tracing(True)
    on = _state_numbers(*_two_steps(remat))
    assert timer.collect()
    assert set(on) == set(off)
    assert any(k.startswith("adam/") for k in off)
    assert any(k.endswith("running_var") for k in off)
    for k, v in off.items():
        assert torch.equal(on[k], v), k


def test_tracing_changes_no_output():
    runner = PlaneRecNetRunner(_cfg(), seed=0, device="cpu")
    off = runner.infer(_frame())
    timer.tracing(True)
    on = runner.infer(_frame())
    assert timer.collect()
    assert set(on) == set(off)
    for k, v in off.items():
        assert torch.equal(on[k], v), k
