"""CUDA-graph replay of fixed-shape device work: the port's counterpart of
the one compiled program that ``jax.jit`` keeps per input shape.

A ``Graphs`` cache holds one ``Slot`` per key: the caller's key and the
shapes, strides, dtypes and devices of the call's tensors. The first call
at a key runs eagerly, which settles cuDNN's choices and builds the
kernels: it is the warm-up on a side stream that ``torch.cuda.graphs``
documents. The second captures a CUDA graph of the call and replays it;
every later call copies its inputs into the graph's static inputs and
replays. A replay leaves out only the host's per-launch work
(Python dispatch, cuDNN's per-call set-up, the allocator): the same
kernels run in the same order and read the parameters and buffers in
place, so an in-place ``load_state_dict`` is seen by the next replay. The
outputs are cloned after each replay, so that a later call never
overwrites what an earlier one returned, unless the caller takes the
graph's own (``copy=False``). Work that reads a call's outputs follows
it (``Graphs.follow``): its graph reads the first graph's own outputs.

Captured work may neither read a device value on the host nor copy from
pageable host memory; either makes the capture raise. Device constants
are cached per device instead (``ops/image.py``, ``ops/postprocess.py``).

The kernels' launch counters (``deform_im2col.launches`` and the others)
count a replayed call as they count an eager one: the launches recorded
at capture are added at each replay, and the capture's own are taken
back.

Every call on a card, eager, capturing or replaying, runs on one side
stream a device (``_stream``), ordered after the caller's stream and
before the caller's later work. A capture cannot run on the default
stream, and each new stream takes a cuBLAS workspace of its own (32 MiB
on an H100: a warm-up stream and a capture stream raised a request's
peak memory by 67 MiB): with one stream for all of it, the eager call's
workspace is the capture's and no other is allocated.

Each cache counts its calls on a counter (a function whose ``eager``,
``captures`` and ``replays`` attributes it increments): ``eager`` the
first call at a key, ``captures`` the second, ``replays`` every later one.
"""

from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.nn.modules import module as _module

from planerecnet_tpu_torch.ops import dcn, dcn_scatter, dice_lava
from planerecnet_tpu_torch.utils.timer import span

# Graphs are kept for this many keys, the most recently used: a served
# stream has one frame shape, an evaluation two (its last batch may be
# smaller). Each graph holds a private memory pool as large as one eager
# pass's intermediates, which a shape not seen again would keep reserved:
# PRN-50's forward and post-processing graphs at 1x480x640 reserve 662 MiB
# together on an H100.
KEEP = 3

# The kernel wrappers whose launch counters a replay carries on.
_COUNTED = (dcn.deform_im2col, dcn_scatter.dcn_input_grad,
            dice_lava.dice_lava_fwd, dice_lava.dice_lava_bwd)


def _launch_counts() -> Dict[Tuple[Callable, str], int]:
    return {(f, k): v for f in _COUNTED for k, v in vars(f).items()
            if isinstance(v, int)}


def _map(fn, tree):
    """``fn`` over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _signature(args) -> Tuple:
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                 for t in _leaves(args, []))


def numerics() -> Tuple:
    """The global switches that decide which kernels a call takes: a graph
    captured under one setting is not replayed under another."""
    return (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_inference_mode_enabled())


@functools.lru_cache(maxsize=None)
def _stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def _side_stream(args):
    """Run the body on ``_stream`` of the device of ``args``'s first
    tensor, between the caller's stream's work before and after it; on
    the CPU, as it is."""
    device = _leaves(args, [])[0].device
    if device.type != "cuda":
        yield
        return
    side, caller = _stream(device), torch.cuda.current_stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        yield
    caller.wait_stream(side)


class Slot:
    """One key's work. ``graph`` is None until the second call captures
    it; ``followers`` holds the graphs of the work that reads this one's
    outputs (``Graphs.follow``)."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs = self.outputs = None
        self.launches: Dict[Tuple[Callable, str], int] = {}
        self.followers = Graphs(static=True)

    def capture(self, fn: Callable, args: Tuple, static: bool):
        """Capture ``fn(*args)``; with ``static`` the graph reads ``args``
        themselves (another graph's outputs), else copies of them."""
        before = _launch_counts()
        with span("runner.capture"):
            try:
                self.inputs = args if static else _map(torch.clone, args)
                graph = torch.cuda.CUDAGraph()
                side = torch.cuda.current_stream()       # ``_stream``
                with torch.cuda.graph(graph, stream=side):
                    self.outputs = fn(*self.inputs)
                self.launches = {k: n - before[k]
                                 for k, n in _launch_counts().items()
                                 if n != before[k]}
                self.graph = graph
            finally:
                for (f, k), n in before.items():
                    setattr(f, k, n)

    def replay(self, args: Tuple, copy: bool):
        """Load ``args`` into the static inputs (those that are not the
        static inputs themselves), replay, and return the outputs: a copy
        with ``copy``, else the graph's own, which the next replay
        overwrites."""
        for static, t in zip(_leaves(self.inputs, []), _leaves(args, [])):
            if static is not t:
                static.copy_(t)
        self.graph.replay()
        for (f, k), n in self.launches.items():
            setattr(f, k, getattr(f, k) + n)
        return _map(torch.clone, self.outputs) if copy else self.outputs


class Graphs:
    """The slots of the ``KEEP`` most recently used keys. ``last`` is the
    slot of the latest call; its owner sets it to None for a call that
    does not go through the cache. With ``static``, the calls' arguments
    are another graph's outputs (``Slot.followers``): a capture reads
    them in place."""

    def __init__(self, static: bool = False):
        self._slots: "OrderedDict[Tuple, Slot]" = OrderedDict()
        self._static = static
        self.last: Optional[Slot] = None

    def clear(self):
        """Drop every graph (and its memory pool) and start over."""
        self._slots.clear()
        self.last = None

    def run(self, key: Tuple, fn: Callable, args: Tuple, counter,
            copy: bool = True):
        """``fn(*args)``, eager, captured or replayed by the count of
        calls at ``key`` and the tensors' signature (module docstring).
        ``copy=False``: a replay returns the graph's own outputs."""
        key = (key, _signature(args))
        slot = self._slots.get(key)
        with _side_stream(args):
            if slot is None:
                slot = self.last = self._slots[key] = Slot()
                if len(self._slots) > KEEP:
                    self._slots.popitem(last=False)
                counter.eager += 1
                return fn(*args)
            self._slots.move_to_end(key)
            self.last = slot
            if slot.graph is None:
                slot.capture(fn, args, self._static)
                counter.captures += 1
            else:
                counter.replays += 1
            return slot.replay(args, copy)

    def follow(self, key: Tuple, fn: Callable, outputs, counter):
        """``fn(outputs)``, where ``outputs`` are what the latest call
        returned: where that call replayed a graph, through its slot's
        ``followers`` (eager, captured or replayed as ``run``), reading
        the graph's own outputs; eager where it did not go through the
        cache."""
        slot = self.last
        if slot is None:
            return fn(outputs)
        return slot.followers.run(
            key, fn, (outputs if slot.graph is None else slot.outputs,),
            counter)


def _hooked(module: torch.nn.Module) -> bool:
    """Whether a forward hook watches a submodule of ``module``: a walk of
    the submodule tree (a third of the time ``modules()`` takes, which
    builds every name)."""
    for m in module._modules.values():
        if m is not None and (m._forward_hooks or m._forward_pre_hooks
                              or _hooked(m)):
            return True
    return False


def usable(module: torch.nn.Module) -> bool:
    """Whether ``module``'s calls may go through a cache: no dispatch
    mode is active (it would see no operation of a replay) and no
    forward hook watches a submodule (a replay would not call it)."""
    return not (torch._C._len_torch_dispatch_stack()
                or _module._global_forward_hooks
                or _module._global_forward_pre_hooks or _hooked(module))
