"""Mutation check of the kernel-vs-plain comparison in ``chip_smoke.py``.

    python3 -m pea_diffusion_tpu_torch.tools.kernel_mutants

For each deliberate fault below it copies the package and ``chip_smoke.py``
into ``build/mutants/<n>/`` at the root of the checkout, plants the fault in
the copy's ``csrc/attention_fwd.cu``, and runs the copy's kernel phase (the
comparison only, no timing) in a process of its own, so that each mutant
builds and loads its own library. It prints each case's relative error and
whether the comparison failed the run, as it must for a fault it is meant to
catch. Needs a CUDA card and nvcc; exits non-zero if a mutant that must be
caught is not.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MASK = "if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;"

# (what, text in the source, its replacement, must the check catch it?)
MUTANTS = [
    ("K/V tile 17 dropped (S > 1088 only)", MASK,
     "if ((ragged && n0 + j * 8 + t * 2 + (e & 1) >= p.skv) || tile == 17) x = kNegInf;",
     True),
    ("KV mask off by one (a zero-filled column counted)", MASK,
     MASK.replace(">= p.skv", "> p.skv"), False),
    ("running sum not rescaled when the max grows",
     "l_run[r] = l_run[r] * corr[r] + l_tile[r];", "l_run[r] = l_run[r] + l_tile[r];",
     True),
]

_RUN = """
import sys
import torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke
chip_smoke.time_ms = lambda *args, **kwargs: 0.0
try:
    chip_smoke.kernel_phases(torch, F)
except AssertionError as e:
    print("CAUGHT:", e)
else:
    print("NOT CAUGHT")
"""


def main() -> int:
    missed = []
    for n, (what, old, new, must) in enumerate(MUTANTS):
        root = REPO / "build" / "mutants" / str(n)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "pea_diffusion_tpu_torch", root / "pea_diffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", root)
        src = root / "pea_diffusion_tpu_torch" / "csrc" / "attention_fwd.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {what!r}: its target is not in the source once")
        src.write_text(text.replace(old, new))
        proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                              capture_output=True, text=True)
        print(f"--- mutant {n}: {what} (must be caught: {must})")
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.startswith(("[kernel]", "CAUGHT", "NOT CAUGHT")) or "Error" in line:
                print(line)
        if must and "CAUGHT:" not in proc.stdout:
            missed.append(what)
    print(f"mutants that must be caught and were not: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
