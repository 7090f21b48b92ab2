"""Times the two ways of building the CUDA sources into one library.

    python3 -m pea_diffusion_tpu_torch.tools.build_timing [--rounds N]

Each round times one nvcc over every ``csrc/*.cu`` source at once, then
``kernel_build.build()`` from an empty ``build/kernels/`` (one nvcc per
source, all started together, then a link), and prints both wall times.
Needs nvcc; leaves the library that ``build()`` made in place.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import time

from ..ops import kernel_build


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    one_lib = kernel_build.BUILD_DIR.parent / "build_timing_one.so"
    for i in range(args.rounds):
        t = time.time()
        subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-shared",
                        "-o", str(one_lib), *map(str, kernel_build.sources())],
                       check=True, capture_output=True)
        one = time.time() - t
        shutil.rmtree(kernel_build.BUILD_DIR, ignore_errors=True)
        t = time.time()
        kernel_build.build()
        parallel = time.time() - t
        print(f"[build timing] round {i}: one nvcc over all sources {one:.2f} s; "
              f"one nvcc per source in parallel, then a link {parallel:.2f} s", flush=True)
    one_lib.unlink()


if __name__ == "__main__":
    main()
