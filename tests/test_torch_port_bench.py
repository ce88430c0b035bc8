"""The port's ``bench`` prints the JAX ``bench.py``'s one JSON line: the
same keys, on the CPU at the runner tests' tiny size."""

import json

import pytest

import bench as jax_bench
import planerecnet_tpu.config as jax_config
from planerecnet_tpu_torch import bench
from planerecnet_tpu_torch import config as port_config
from test_torch_port_model import port_cfg
from test_torch_port_runner import _tiny_cfg

ARGS = ["--iters", "2", "--warmup", "1", "--height", "64", "--width", "64",
        "--sync_iters", "1", "--batch_size", "2"]


@pytest.fixture
def tiny(monkeypatch):
    cfg = _tiny_cfg()
    monkeypatch.setattr(jax_config, "set_cfg", lambda name: cfg)
    monkeypatch.setattr(port_config, "set_cfg", lambda name: port_cfg(cfg))
    return cfg


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_json_has_the_jax_keys(tiny, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["bench.py"] + ARGS)
    jax_bench.main()
    want = last_json(capsys)
    got = bench.main(ARGS + ["--device", "cpu"])
    assert last_json(capsys) == got
    assert list(got) == list(want)
    assert got["unit"] == want["unit"] == "images/sec"
    assert got["value"] > 0 and got["sync_roundtrip_ms"] > 0
    # PRN-50 (cut to 64 px): the upstream model's 19.1 FPS on an RTX 3090;
    # "auto" runs in f32 on the CPU in both.
    assert got["baseline"] == want["baseline"] == 19.1
    # From the unrounded rate: within the rounding of "value".
    assert abs(got["vs_baseline"] - got["value"] / 19.1) < 1e-3
    assert got["metric"] == want["metric"]


def test_bench_without_a_published_baseline(monkeypatch, capsys):
    cfg = port_cfg(_tiny_cfg()).copy(dict(name="PlaneRecNet_tiny"))
    monkeypatch.setattr(port_config, "set_cfg", lambda name: cfg)
    got = bench.main(ARGS + ["--device", "cpu", "--sync_iters", "0"])
    assert got["baseline"] is None and got["vs_baseline"] is None
    assert "sync_roundtrip_ms" not in got
