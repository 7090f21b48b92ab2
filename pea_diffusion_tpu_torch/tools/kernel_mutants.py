"""Mutation check of the kernel-vs-plain comparison in ``chip_smoke.py``.

    python3 -m pea_diffusion_tpu_torch.tools.kernel_mutants [N ...]

For each deliberate fault below it copies the package and ``chip_smoke.py``
into ``build/mutants/<n>/`` at the root of the checkout, plants the fault in
the copy's ``csrc/`` sources, and runs the copy's kernel phase and sweep
phase (the comparisons; only the sweep's variants are timed) in a process
of its own, so that each mutant builds and loads its own library; JOBS
mutants run at once on the one card. It prints each case's relative error
and whether the comparison failed the run (an assertion or any other error
the phases raise, as the smoke would), as it must for a fault it is meant to
catch. Needs a CUDA card and nvcc; exits non-zero if a mutant that must be
caught is not. Numbers N run those mutants alone (0-based, in the order of
MUTANTS).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MASK = "if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;"
FWD, BWD, COMMON = "attention_fwd.cu", "attention_bwd.cu", "attention_common.cuh"
SM90 = "attention_fwd_sm90_body.cuh"  # the wgmma body of B1 (D = 64) and B3
SM90_COMMON = "sm90_common.cuh"  # its primitives, shared with the backward's
SM90_BWD = "attention_bwd_sm90_body.cuh"  # the wgmma body of B4 and B5
JOBS = 4  # mutants at once: each builds on the host's cores, then checks on the card
GN = "groupnorm.cu"  # B6/B6-b's three_pass variant
GN_P = "groupnorm_sm90.cu"  # their persistent variant, the one the paths ship
B4_P = "const float pr = exp2f(x - ls[col]);"
# D = 40: the zeroing of shared-memory columns 40-47, and the guard that
# makes load_a_fragments give 0 for them instead of reading past the row
PAD_ZERO = ("      *reinterpret_cast<uint4*>(smem + (c / per_row) * k_ld<D>() + D + "
            "(c % per_row) * 8) =\n          make_uint4(0u, 0u, 0u, 0u);\n")
PAD_UNZEROED = (COMMON, PAD_ZERO, "      (void)per_row;\n")
A_PAST_D = (COMMON, "const bool hi = kk * 16 + 8 < D;", "const bool hi = true;")
# D = 160: B4's dV pass accumulates its 20 output n-tiles in pairs
DV_NTILES = "for (int j = 0; j < kDTiles; j += 2) mma_ntiles<T, D>(acc, pa[kk], rhs + off, j, lm_mat);"

# The wgmma body (B1 at D = 64, B3): its tensor maps flattened to 2-D over
# [B*S, H*D] (a 3-D map with a unit batch dimension and the batch folded
# into the row coordinate), so that a box past a batch's last row reads the
# next batch's rows instead of zeros
FLAT_MAP = [
    (SM90, "dtype, batch, p.sq, feat", "dtype, 1, batch * p.sq, feat"),
    (SM90, "dtype, batch, p.skv, feat", "dtype, 1, batch * p.skv, feat", 2),
    (SM90, "head * kD, q0, bidx, kQAtom);", "head * kD, bidx * p.sq + q0, 0, kQAtom);"),
    (SM90, "head * kD, s * kBN, bidx);", "head * kD, bidx * p.skv + s * kBN, 0);"),
    (SM90, "head * kD, row, bidx);", "head * kD, bidx * p.skv + row, 0);"),
]
SM90_MASK = (SM90, "      if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) x = kNegInf;\n", "")

# (what, [(source, text in it, its replacement[, how often the text occurs,
# default once])], must the check catch it?)
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
     [(BWD, "        if (kv_masked[e >> 1]) x = kNegInf;\n", "", 2),
      (BWD, "        if (n0 + j * 8 + t * 2 + (e & 1) >= p.skv) x = kNegInf;\n", "", 2)],
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
    # GroupNorm's three_pass variant (groupnorm.cu), checked at every row
    # through group_norm_variant. Each
    # kernel row is checked contiguous (the slab of a group) and
    # channels-last (the per-channel sums folded per group), so the group's
    # channel range is cut short by one in both statistics kernels.
    ("B6/B6-b: the group's statistics skip its last channel (cg - 1)",
     [(GN, "const int total = p.cg * per_row;  // the group's channels, one slab",
       "const int total = (p.cg - 1) * per_row;"),
      (GN, "k < (g + 1) * p.cg; ++k", "k < (g + 1) * p.cg - 1; ++k")], True),
    ("B6-b: t left out of the sums of squares (the variance)",
     [(GN, "      s2 += v * v;\n", "      s2 += (v - tv) * (v - tv);\n"),
      (GN, "s2[m][e] += v * v;", "s2[m][e] += (v - tv[m][e]) * (v - tv[m][e]);")], True),
    # D = 160 splits B4 into a dV pass and a dK pass (grid z): a dV pass
    # that stops at half of D leaves dV's columns 80-159 at 0
    ("B4 at D=160: the dV pass drops the second half of dV's columns",
     [(BWD, DV_NTILES, DV_NTILES.replace("j < kDTiles;", "j < (kDkPass ? kDTiles : kDTiles / 2);"))],
     True),
    # S1: the three-stage variants fill stage (tile + 2) % 3 but read stage
    # tile % 2, so the third stage is never read (two-stage kernels, the
    # shipped B1 and B3 among them, are unchanged)
    ("S1: three-stage variants read stage tile % 2 (the third stage never read)",
     [(FWD, "const uint16_t* ks = smem + (tile % kST) * 2 * kTile;",
       "const uint16_t* ks = smem + (tile % 2) * 2 * kTile;")], True),
    ("wgmma body (B1, B3, and B5's dQ += dS.K): the last k-step of P.V dropped",
     [(SM90_COMMON, "for (int kk = 0; kk < kBN / 16; ++kk) WgmmaRS<T, kD>::run(",
       "for (int kk = 0; kk < kBN / 16 - 1; ++kk) WgmmaRS<T, kD>::run(")], True),
    # The next batch's rows that a flattened map reads past a ragged tail
    # are real values, but as K/V columns >= skv they get -1e30 (P = 0, and
    # 0 times a finite V row adds 0) and as Q rows >= sq they are never
    # stored: the 3-D map's zero fill is a second guard behind the mask, so
    # the flattening alone cannot change the output
    ("wgmma body (B1, B3): 2-D tensor maps over [B*S, H*D]", FLAT_MAP, False),
    # without the mask, the zero-filled K rows of a ragged tail score 0
    # (not -1e30) and enter the row sums: zero fill is not a mask
    ("wgmma body (B1, B3): KV mask dropped (zero-filled columns counted)", [SM90_MASK], True),
    ("wgmma body (B1, B3): 2-D tensor maps and the KV mask dropped", FLAT_MAP + [SM90_MASK],
     True),
    # B3 on the wgmma body. (a) D = 40 takes three k-steps of Q.K^T, the
    # third over columns 32-47: two leave columns 32-39 out of every score
    ("wgmma bodies at D=40: the last Q.K^T-shaped k-step dropped (2 k-steps, not 3)",
     [(SM90_COMMON, "constexpr int kKSteps = (kD + 15) / 16;",
       "constexpr int kKSteps = kD == 40 ? 2 : (kD + 15) / 16;")], True),
    # (b) the maps' inner extent padded to whole atoms (64 at D = 40, 128 at
    # 80, 192 at 160) over rows of D columns: the pad columns of Q and K read
    # the next row's first values instead of zeros, and enter the scores
    ("B3 (wgmma): tensor maps with the padded inner extent (pad columns read the next row)",
     [(SM90, "feat, feat,", "(feat + 63) / 64 * 64, feat,", 3)], True),
    ("B3 (wgmma): lse stored in the log2 domain (m + log(l), no ln 2)",
     [(SM90, "m_run[r] * kLn2 + logf(l_run[r])", "m_run[r] + logf(l_run[r])")], True),
    # (d) D = 160's rows span three atoms; Q.K^T stops after the second
    ("wgmma bodies at D=160: Q.K^T-shaped products skip the third atom (columns 128-159)",
     [(SM90_COMMON, "for (int kk = 0; kk < kKSteps; ++kk) {",
       "for (int kk = 0; kk < (kD == 160 ? 8 : kKSteps); ++kk) {")], True),
    # B4 and B5 on the wgmma body. (a) B4 takes each score's lse from the Q
    # row of its column; read by the thread's K/V row instead, every P^T is
    # off by exp(lse_column - lse_row)
    ("B4 (wgmma): lse read by the row, not by the column",
     [(SM90_BWD, "pr[e] = exp2f(x - ls[c] * kLog2e);",
       "pr[e] = exp2f(x - ls[(threadIdx.x % 32 / 4 + 8 * (e >> 1)) % kBM] * kLog2e);")], True),
    ("B5 (wgmma): the delta subtraction dropped (dS = P * dP)",
     [(SM90_BWD, "ds[e] = exp2f(x - lse2[e >> 1]) * (dp[j * 4 + e] - delta[e >> 1]);",
       "ds[e] = exp2f(x - lse2[e >> 1]) * dp[j * 4 + e];")], True),
    ("B4 (wgmma): the last k-step of dV += P^T.dO dropped",
     [(SM90_BWD, "WgmmaRS<T, kD>::run(dv, pa[kk], desc_do + 128 * kk);",
       "if (kk < kBM / 16 - 1) WgmmaRS<T, kD>::run(dv, pa[kk], desc_do + 128 * kk);")], True),
    # (d) D = 160's rows span three atoms: dK's dP^T = V.dO^T stops after
    # the second, so dS^T, and with it dK, misses columns 128-159
    ("B4 (wgmma) at D=160: dK's dP^T = V.dO^T skips the third atom",
     [(SM90_BWD, "issue_qk<T, kD, kBM, kKAtom, kQAtom>(dpt, desc_v, desc_sw128(do_addr));",
       "issue_qk<T, (kD == 160 ? 128 : kD), kBM, kKAtom, kQAtom>(dpt, desc_v, "
       "desc_sw128(do_addr));")], True),
    # (e) as mutant 17 for the backward's maps: the pad columns of D = 40
    # read the next row's first values, which the third k-step multiplies
    ("B4/B5 (wgmma): tensor maps with the padded inner extent",
     [(SM90_BWD, "return encode(map, ptr, dtype, bh, rows, kD, kD, box_rows);",
       "return encode(map, ptr, dtype, bh, rows, atoms(kD) * kAtomCols, kD, box_rows);")],
     True),
    # K and V rows past skv are zero-filled: a counted column scores 0, so
    # P is not 0 there, but dS times K's zero row adds 0 to dQ, and B5 never
    # stores past sq: the mask is a second guard that no output can show
    ("B5 (wgmma): KV mask dropped (zero-filled columns counted)",
     [(SM90_BWD, "      if (ragged && n0 + j * 8 + t * 2 + (e & 1) >= skv) x = kNegInf;\n", "")],
     False),
    # B6/B6-b's persistent variant. (a) Without the wait at the grid
    # barrier a block folds partial sums other blocks have not written yet:
    # the previous launch's, of another map, in the same work buffer
    ("persistent B6/B6-b: the grid barrier skipped",
     [(GN_P, "      while (static_cast<unsigned>(ld_acquire(barrier) >> 32) == gen) "
             "__nanosleep(32);\n",
       "      (void)gen;\n")], True),
    # (b) a group's statistics without the first covering block's rows:
    # small at 132 blocks a sample, half the data where two blocks cover a
    # (sample, group) slab (contiguous rows)
    ("persistent B6/B6-b: the first covering block's partial left out of each fold",
     [(GN_P, "const int blk = lo + lane + 32 * k;", "const int blk = lo + 1 + lane + 32 * k;")],
     True),
    # (c) the apply pass reads the next slot's tile (a block with one tile
    # reads its own)
    ("persistent B6/B6-b: the apply pass reads the neighbouring slot's tile",
     [(GN_P, "const Pack<T, V>* tile = slot(s);\n    Pack<T, V>* out",
       "const Pack<T, V>* tile = slot((s + 1) % slots);\n    Pack<T, V>* out")], True),
    ("persistent B6-b: t left out of the statistics",
     [(GN_P, "const float v = to_float(pk.v[e]) + (kNhwc ? tv[e] : tr);",
       "const float v = to_float(pk.v[e]);")], True),
]

_RUN = """
import sys
import torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke
chip_smoke.time_ms = lambda *args, **kwargs: 0.0
chip_smoke.queued_ms = lambda *args, **kwargs: 0.0
try:
    chip_smoke.kernel_phases(torch, F)
    chip_smoke.sweep_phase(torch, F)
except Exception as e:
    print("CAUGHT:", type(e).__name__, e)
else:
    print("NOT CAUGHT")
"""


def plant(n: int) -> Path:
    """A copy of the package and chip_smoke.py under build/mutants/<n>/ with
    mutant n's fault planted in its CUDA sources."""
    what, edits, _ = MUTANTS[n]
    root = REPO / "build" / "mutants" / str(n)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "pea_diffusion_tpu_torch", root / "pea_diffusion_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", root)
    for name, old, new, *count in edits:
        src = root / "pea_diffusion_tpu_torch" / "csrc" / name
        text = src.read_text()
        times = count[0] if count else 1
        if text.count(old) != times:
            raise RuntimeError(f"mutant {what!r}: its target is not in {name} {times}x")
        src.write_text(text.replace(old, new))
    return root


def run(n: int) -> str:
    """Mutant n's comparison run in a process of its own: its output."""
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=plant(n), capture_output=True,
                          text=True)
    return proc.stdout + proc.stderr


def main(argv=None) -> int:
    chosen = {int(a) for a in (sys.argv[1:] if argv is None else argv)}
    numbers = [n for n in range(len(MUTANTS)) if not chosen or n in chosen]
    missed = []
    with ThreadPoolExecutor(JOBS) as pool:
        for n, out in zip(numbers, pool.map(run, numbers)):
            what, _, must = MUTANTS[n]
            print(f"--- mutant {n}: {what} (must be caught: {must})")
            for line in out.splitlines():
                if line.startswith(("[kernel]", "CAUGHT", "NOT CAUGHT")) or "Error" in line:
                    print(line)
            if must and "CAUGHT:" not in out:
                missed.append(what)
    print(f"mutants that must be caught and were not: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
