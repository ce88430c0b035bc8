"""Faults planted in the program's timed path, under which ``correct`` has
to come out false: a step that leaves the state unchanged, half of the
batch left out (the mean taken over the rest), and an answer altered
where it is produced. Each is a context manager that patches the
program's module for its duration. The benchmark's runs never plant one;
the tests and ``benchmark/control.py --fault`` do."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, replacement):
    saved = getattr(module, name)
    setattr(module, name, replacement(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def unchanged_state():
    """Every step applies no update (the counters still advance)."""
    from planerecnet_tpu_torch import trainer

    def replacement(_):
        def apply_grads(state, total, saved_bn):
            state.step += 1
            state.updates += 1
            return True
        return apply_grads

    return _patched(trainer, "apply_grads", replacement)


def half_batch():
    """Each step trains on the first half of its rows alone."""
    from planerecnet_tpu_torch import trainer

    def replacement(unpack):
        def half(cfg, batch, device):
            out = unpack(cfg, batch, device)
            n = out["image"].shape[0] // 2
            return {k: v[:n] for k, v in out.items()}
        return half

    return _patched(trainer, "unpack_wire_batch", replacement)


def altered_answer():
    """Every request's depth comes out 0.1% deeper."""
    from planerecnet_tpu_torch import runner

    def replacement(post):
        def altered(*args, **kw):
            out = post(*args, **kw)
            out["pred_depth"] = out["pred_depth"] * 1.001
            return out
        return altered

    return _patched(runner, "postprocess_batch", replacement)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
