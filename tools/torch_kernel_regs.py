"""Build the port's kernels and print each kernel's registers and the build
time.

    python3 tools/torch_kernel_regs.py [ROOT ...]

For each ROOT (default: this checkout), a checkout of the repo, it builds
ROOT/pathintegralgroundstate_torch/csrc with that checkout's own
utils/build.py (one nvcc per source, all started together, -Xptxas -v),
into ROOT/build/, and prints the wall time of the build and one line per
kernel instantiation: its template arguments, registers per thread, shared
memory and spills (utils/build.ptxas_summary).  Two roots, e.g. an earlier
commit unpacked with `git archive <commit> | tar -x -C build/parent`, give
the two builds side by side on one machine.  Needs nvcc (the CUDA
toolkit); no GPU is used.
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from pathintegralgroundstate_torch.utils.build import ptxas_summary  # noqa


def _build_module(root):
    path = os.path.join(root, "pathintegralgroundstate_torch", "utils",
                        "build.py")
    spec = importlib.util.spec_from_file_location(
        f"_pigs_build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [HERE]
    for root in roots:
        mod = _build_module(root)
        lib, seconds, log = mod.build()
        cu, _ = mod.sources()
        print(f"[regs] {root}: {len(cu)} sources, build {seconds:.1f} s "
              f"(0.0: already built) -> {lib}")
        for line in ptxas_summary(log):
            print(f"[regs]   {line}")


if __name__ == "__main__":
    main()
