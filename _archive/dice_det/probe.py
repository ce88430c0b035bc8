"""Time variants of the deterministic dice/lava kernels on one card.

    python3 _archive/dice_det/probe.py VARIANTS.json [OUT_DIR]

Each variant is {"name", "edits": [[old, new], ...], "units": n (optional,
the plan's DET_UNITS)}: the text edits are applied to
``csrc/dice_lava.cu``, every variant is built at once (one nvcc each) and
then timed in turns, twice, at PRN-50's and the base preset's training
shapes (``chip_smoke.DICE``, ``DICE_BASE``): ms a launch of each
deterministic variant through the wrapper, beside the atomic kernel of
the unedited source. The outputs of a variant are not checked: these are
measurements of where the time goes, not candidates, except that the
first round prints each variant's share of dk's error allowance
(``chip_smoke.dice_errors``' measure) against the plain backward. A variant with
"phases" ("bwd", or "fwd" for the forward's) has clock64 ticks in a tile loop (its edits add
``g_phase`` and ``prn_probe_read``/``prn_probe_reset``): after the timing
one more deterministic launch of that pass prints the cycles a tile of each
phase, as thread 0 of every block saw them.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from planerecnet_tpu_torch.ops import cuda_build  # noqa: E402
from planerecnet_tpu_torch.ops import dice_lava as dl  # noqa: E402


def build_all(variants, work):
    src = (cuda_build.CSRC_DIR / "dice_lava.cu").read_text()
    procs = {}
    for v in variants:
        text = src
        for old, new in v.get("edits", []):
            assert text.count(old) >= 1, (v["name"], old)
            text = text.replace(old, new)
        cu = os.path.join(work, f"{v['name']}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(work, f"{v['name']}.so")
        procs[v["name"]] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[probe] {name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        spills = cs.dice_spills(log)
        print(f"[probe] {name}: built; spills {sorted(spills.items())}",
              flush=True)
        libs[name] = so
    return libs


def load(so):
    """The variant's library with the argument types of dl._library."""
    real = dl._library.__wrapped__
    saved = cuda_build.library
    cuda_build.library = lambda name: ctypes.CDLL(so)
    try:
        return real()
    finally:
        cuda_build.library = saved


def phases(lib, run, name):
    """Cycles a tile of each ticked phase over one launch of ``run``."""
    import torch
    real = dl._library
    dl._library = lambda: lib
    try:
        torch.cuda.synchronize()
        lib.prn_probe_reset()
        run()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 16)()
        lib.prn_probe_read(out)
    finally:
        dl._library = real
    tiles = max(out[15], 1)
    print(f"[probe] {name} phases, cycles a tile over {tiles} tiles: "
          + ", ".join(f"{i}: {out[i] / tiles:.0f}" for i in range(9)),
          flush=True)


def main():
    variants = json.load(open(sys.argv[1]))
    out_dir = sys.argv[2] if len(sys.argv) > 2 else None
    cs.phase_device()
    with tempfile.TemporaryDirectory() as work:
        libs = build_all(variants, work)
        loaded = {n: load(so) for n, so in libs.items()}
    results = {}
    real_lib = dl._library
    for shape_name, d in (("K128", cs.DICE), ("K256", cs.DICE_BASE)):
        ins, gs = cs.dice_inputs(50, **d)
        want_dk = dl.fused_dice_lava_bwd_plain(*ins, *gs)[0]
        for rnd in range(2):
            for v in variants:
                if v["name"] not in loaded:
                    continue
                dl._library = lambda lib=loaded[v["name"]]: lib
                dl.DET_UNITS = v.get("units", 128)
                dl.det_plan.cache_clear()
                try:
                    if rnd == 0:
                        dk = dl.dice_lava_bwd(*ins, *gs, deterministic=True)[0]
                        tol = cs.TOL[torch.float32]
                        share = float(((dk - want_dk).abs() / (
                            tol * (want_dk.abs().max() + want_dk.abs())
                            + 1e-30)).max())
                        print(f"[probe] {shape_name} {v['name']}: dk_det "
                              f"uses {share:.3f} of its allowance",
                              flush=True)
                    fwd = cs.cuda_time_ms(lambda: dl.dice_lava_fwd(
                        *ins, deterministic=True), iters=10)
                    bwd = cs.cuda_time_ms(lambda: dl.dice_lava_bwd(
                        *ins, *gs, deterministic=True), iters=10)
                    if v["name"] == variants[0]["name"]:
                        afwd = cs.cuda_time_ms(lambda: dl.dice_lava_fwd(
                            *ins), iters=10)
                        abwd = cs.cuda_time_ms(lambda: dl.dice_lava_bwd(
                            *ins, *gs), iters=10)
                        print(f"[probe] {shape_name} round {rnd} atomic: "
                              f"fwd {afwd:.4f} bwd {abwd:.4f}", flush=True)
                finally:
                    dl._library = real_lib
                print(f"[probe] {shape_name} round {rnd} {v['name']}: "
                      f"fwd_det {fwd:.4f} bwd_det {bwd:.4f} ms a launch",
                      flush=True)
                if v.get("phases") == "fwd" and rnd == 0:
                    phases(loaded[v["name"]], lambda: dl.dice_lava_fwd(
                        *ins, deterministic=True), v["name"])
                elif v.get("phases") and rnd == 0:
                    phases(loaded[v["name"]], lambda: dl.dice_lava_bwd(
                        *ins, *gs, deterministic=True), v["name"])
                results.setdefault(f"{shape_name}/{v['name']}", []).append(
                    (fwd, bwd))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "probe.json"), "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
