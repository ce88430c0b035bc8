"""Compare the SASS of the dice/lava kernels of two trees.

    python3 _archive/dice_det/sass_same.py OTHER_TREE

Compiles ``planerecnet_tpu_torch/csrc/dice_lava.cu`` of this tree and of
OTHER_TREE to cubins with the flags of ``ops/cuda_build.py`` (``-cubin``
for ``-shared``), disassembles them with ``cuobjdump -sass`` and prints,
for each kernel of either, whether its instructions are the same in both.
Exits 1 if an atomic (``DET=false``) instance differs.
"""
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())
from planerecnet_tpu_torch.ops import cuda_build  # noqa: E402

FLAGS = [f for f in cuda_build.NVCC_FLAGS
         if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]


def sass(tree, out_dir, tag):
    cubin = os.path.join(out_dir, f"{tag}.cubin")
    subprocess.run([cuda_build._nvcc(), *FLAGS, "-cubin", "-o", cubin,
                    os.path.join(tree, "planerecnet_tpu_torch", "csrc",
                                 "dice_lava.cu")], check=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # a kernel by its template arguments: the mangled name also
            # holds a hash of the file, which differs between two trees
            k = re.search(r"dice_lava_(fwd|bwd)_kernelILi\d+ELb[01]E",
                          m.group(1))
            name = k.group(0) if k else m.group(1)
            funcs[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            # the instruction, without its address and encoding
            funcs[name].append(re.sub(r"/\*.*?\*/", "", line).strip())
    return funcs


def main():
    other = sys.argv[1]
    with tempfile.TemporaryDirectory() as d:
        here, there = sass(".", d, "here"), sass(other, d, "other")
    bad = 0
    for name in sorted(set(here) | set(there)):
        k = re.search(r"dice_lava_(fwd|bwd)_kernelILi(\d+)ELb([01])E", name)
        label = (f"{k.group(1)} K={k.group(2)} DET={k.group(3)}" if k
                 else name)
        if name not in here or name not in there:
            print(f"[sass] {label}: only in "
                  f"{'this tree' if name in here else other}")
            continue
        same = here[name] == there[name]
        print(f"[sass] {label}: {len(here[name])} / {len(there[name])} "
              f"instructions, {'identical' if same else 'DIFFERENT'}")
        if k and k.group(3) == "0" and not same:
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
