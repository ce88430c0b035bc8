"""Where the deterministic scatter's time goes at the PRN-50 training
shapes: torch.profiler's device time by kernel, then variants of the
source (each a list of text replacements) built with nvcc and timed with
CUDA events, with their dx bits against the CPU plain version. Each
variant's ptxas report goes to OUT_DIR (default logs/probe).

    python3 _archive/scatter_det/probe.py [OUT_DIR]
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from planerecnet_tpu_torch.ops import cuda_build, dcn  # noqa: E402
from planerecnet_tpu_torch.ops import dcn_scatter as ds  # noqa: E402

SRC = (ROOT / "planerecnet_tpu_torch/csrc/dcn_scatter.cu").read_text()
OUT = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "logs" / "probe"
VARIANTS = json.loads((Path(__file__).parent / "variants.json").read_text())


def build(name, edits):
    src = SRC
    timed = "prn_probe_phases" in "".join(n for _, n in edits)
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: edit not found: {old[:60]!r}")
        src = src.replace(old, new)
    d = Path(tempfile.mkdtemp())
    (d / "v.cu").write_text(src)
    lib = d / "v.so"
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib), str(d / "v.cu")], capture_output=True,
                       text=True)
    (OUT / f"{name}.ptxas.txt").write_text(r.stdout + r.stderr)
    if r.returncode:
        print(f"[probe] {name}: build failed\n{r.stderr[-3000:]}")
        return None
    so = ctypes.CDLL(str(lib))
    so.prn_dcn_scatter_det_f32.argtypes = ([ctypes.c_void_p] * 7
                                           + [ctypes.c_int] * 8
                                           + [ctypes.c_void_p])
    so.prn_dcn_scatter_det_f32.restype = ctypes.c_int
    so.timed = timed
    return so


def runner(so, idx, cw, dcols, h, w, tiles_by_stride):
    b, r, c = dcols.shape
    plan = ds.det_plan(b, r, h, w, c)
    stride = ds.row_geometry(r, h, w)[2]
    if f"tile{stride}" in tiles_by_stride:
        plan = plan._replace(tile_h=tiles_by_stride[f"tile{stride}"][0],
                             tile_w=tiles_by_stride[f"tile{stride}"][1])
    if "group_div" in tiles_by_stride:
        plan = plan._replace(group=-(-plan.group
                                     // tiles_by_stride["group_div"]))
    tiles = plan.tiles(b, h, w)
    count = torch.zeros(tiles + 1, dtype=torch.int32, device="cuda")
    start = torch.empty(tiles * ds.DET_ROW_CAP, dtype=torch.int32,
                        device="cuda")
    pairs = torch.empty((4 * b * r, 2), dtype=torch.int32, device="cuda")
    dx = torch.empty((b, h, w, c), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        count.zero_()
        err = so.prn_dcn_scatter_det_f32(
            idx.data_ptr(), cw.data_ptr(), dcols.data_ptr(), dx.data_ptr(),
            count.data_ptr(), start.data_ptr(), pairs.data_ptr(), b, r, h, w,
            c, *plan, stream)
        assert err == 0, err
        return dx
    run.plan = plan
    return run


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cases = []
    for i in range(len(cs.DCN_SHAPES_TRAIN)):
        h, w, cin, stride, _ = cs.DCN_SHAPES_TRAIN[i]
        _, off, mask, _, _, ho, wo = cs.dcn_inputs(h, w, 8, stride,
                                                   torch.float32, seed=20 + i)
        idx, cw = dcn.scatter_inputs(off, mask, h, w, stride=stride)
        g = torch.Generator(device="cuda").manual_seed(40 + i)
        dcols = torch.randn(cs.BATCH, ho * wo * 9, cin, device="cuda",
                            generator=g)
        cpu = ds.dcn_input_grad_plain(idx.cpu(), cw.cpu(), dcols.cpu(), h, w)
        cases.append((f"{h}x{w}x{cin}/s{stride}", idx, cw, dcols, h, w, cpu))
    # The wrapper as shipped, under torch.profiler.
    for name, idx, cw, dcols, h, w, _ in cases[:2]:
        fn = lambda: ds.dcn_input_grad(idx, cw, dcols, h, w,  # noqa: E731
                                       deterministic=True)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = e.cuda_time_total
            if dev > 0 and e.device_type.name == "CUDA":
                rows.append((dev / 5 / 1e3, e.key[:90]))
        for ms, key in sorted(rows, reverse=True)[:8]:
            print(f"[probe] {name} profile {ms:.4f} ms {key}")
        print(f"[probe] {name} wrapper {cs.cuda_time_ms(fn):.4f} ms")
    for vname, spec in VARIANTS.items():
        so = build(vname, spec["edits"])
        if so is None:
            continue
        for name, idx, cw, dcols, h, w, cpu in cases:
            run = runner(so, idx, cw, dcols, h, w, spec)
            if so.timed:
                buf = (ctypes.c_ulonglong * 8)()
                so.prn_probe_phases(buf)
                run()
                torch.cuda.synchronize()
                so.prn_probe_phases(buf)
                blocks = run.plan.blocks(*dcols.shape[:1], h, w,
                                         dcols.shape[2])
                print(f"[probe] {vname} {name} {run.plan}: cycles a block "
                      f"by phase (collect, order, entries, slices) "
                      f"{[round(buf[k] / blocks) for k in range(4)]}")
            got = run().cpu()
            differ = int((got.view(torch.int32) != cpu.view(torch.int32)).sum())
            ms = cs.cuda_time_ms(run)
            print(f"[probe] {vname} {name}: {ms:.4f} ms, {differ} bits "
                  f"differ", flush=True)


if __name__ == "__main__":
    main()
