"""Mutation check of the kernel-vs-plain comparison in ``chip_smoke.py``.

    python3 -m pea_diffusion_tpu_torch.tools.kernel_mutants [N ...]

For each deliberate fault below it copies the package and ``chip_smoke.py``
into ``build/mutants/<n>/`` at the root of the checkout, plants the fault in
the copy's ``csrc/`` sources, and runs the copy's kernel phase (the
comparison only, no timing) in a process of its own, so that each mutant
builds and loads its own library. It prints each case's relative error and
whether the comparison failed the run, as it must for a fault it is meant to
catch. Needs a CUDA card and nvcc; exits non-zero if a mutant that must be
caught is not. Numbers N run those mutants alone (0-based, in the order of
MUTANTS).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MASK = "if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;"
FWD, BWD, COMMON = "attention_fwd.cu", "attention_bwd.cu", "attention_common.cuh"
GN = "groupnorm.cu"
B4_P = "const float pr = exp2f(x - ls[col]);"
# D = 40: the zeroing of shared-memory columns 40-47, and the guard that
# makes load_a_fragments give 0 for them instead of reading past the row
PAD_ZERO = ("      *reinterpret_cast<uint4*>(smem + (c / per_row) * k_ld<D>() + D + "
            "(c % per_row) * 8) =\n          make_uint4(0u, 0u, 0u, 0u);\n")
PAD_UNZEROED = (COMMON, PAD_ZERO, "      (void)per_row;\n")
A_PAST_D = (COMMON, "const bool hi = kk * 16 + 8 < D;", "const bool hi = true;")

# (what, [(source, text in it, its replacement)], must the check catch it?)
MUTANTS = [
    ("K/V tile 17 dropped (S > 1088 only)", [(FWD, MASK,
     "if ((ragged && n0 + j * 8 + t * 2 + (e & 1) >= p.skv) || tile == 17) x = kNegInf;")],
     True),
    ("KV mask off by one (a zero-filled column counted)",
     [(FWD, MASK, MASK.replace(">= p.skv", "> p.skv"))], False),
    ("running sum not rescaled when the max grows",
     [(FWD, "l_run[r] = l_run[r] * corr[r] + l_tile[r];", "l_run[r] = l_run[r] + l_tile[r];")],
     True),
    ("B4 skips Q tile 17 of its walk (Sq > 1088 only)",
     [(BWD, B4_P, "const float pr = tile == 17 ? 0.f : exp2f(x - ls[col]);")], True),
    # K and V rows past skv are zero-filled, so a counted padded column adds
    # P * 0 to dQ, and B4 never stores the padded rows: the output cannot
    # change, and the mask is a second guard
    ("backward KV mask dropped in B4 and B5 (zero-filled columns counted)",
     [(BWD, "        if (kv_masked[e >> 1]) x = kNegInf;\n", ""),
      (BWD, "        if (n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;\n", "")],
     False),
    # D = 40. Left unzeroed, the pad columns of the shared-memory tiles keep
    # what an earlier kernel left there. B3 and B5 multiply them (K, V) with
    # Q / dO fragments that load_a_fragments zeroes, so only a NaN or Inf
    # there would show; B4 takes both operands of S^T = K Q^T and dP^T =
    # V dO^T from shared-memory tiles, so the stale values meet each other
    # and dK / dV change. The fragments reading past D (the next row's first
    # 8 values) meet zeroed K / V columns in B3 and B5, and B4 does not read
    # fragments from device memory: that guard cannot change the output on
    # its own (it keeps the last row's read inside the tensor); both faults
    # at once put stale values times Q into every score of B3 and B5.
    ("D=40: shared-memory pad columns 40-47 left unzeroed", [PAD_UNZEROED], True),
    ("D=40: load_a_fragments reads columns 40-47 (the next row) as Q / dO", [A_PAST_D],
     False),
    ("D=40: both of the above", [PAD_UNZEROED, A_PAST_D], True),
    # GroupNorm. Each kernel row is checked contiguous (the slab of a group)
    # and channels-last (the per-channel sums folded per group), so the
    # group's channel range is cut short by one in both statistics kernels.
    ("B6/B6-b: the group's statistics skip its last channel (cg - 1)",
     [(GN, "const int total = p.cg * per_row;  // the group's channels, one slab",
       "const int total = (p.cg - 1) * per_row;"),
      (GN, "k < (g + 1) * p.cg; ++k", "k < (g + 1) * p.cg - 1; ++k")], True),
    ("B6-b: t left out of the sums of squares (the variance)",
     [(GN, "      s2 += v * v;\n", "      s2 += (v - tv) * (v - tv);\n"),
      (GN, "s2[m][e] += v * v;", "s2[m][e] += (v - tv[m][e]) * (v - tv[m][e]);")], True),
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


def main(argv=None) -> int:
    chosen = {int(a) for a in (sys.argv[1:] if argv is None else argv)}
    missed = []
    for n, (what, edits, must) in enumerate(MUTANTS):
        if chosen and n not in chosen:
            continue
        root = REPO / "build" / "mutants" / str(n)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "pea_diffusion_tpu_torch", root / "pea_diffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", root)
        for name, old, new in edits:
            src = root / "pea_diffusion_tpu_torch" / "csrc" / name
            text = src.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"mutant {what!r}: its target is not in {name} once")
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
