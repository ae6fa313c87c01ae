"""Substitution matrices — normal, bisulfite, SLAM-seq.

Reference analog: the score-matrix setup spread across CS/kernels/Config in
the reference (SURVEY.md §2 components 22/23): --bs-mapping selects one of
two asymmetric matrices by strand; --slam-seq tweaks T->C tolerance.  Here
the matrix is a kernel *argument* (an [8, 8] int32 array), not a compile-time
constant, so every mode shares one compiled kernel.

Matrix layout: S[q_code, r_code] for codes A0 C1 G2 T3 N4 (5..7 unused, kept
so the flat lookup index q*8+r is a cheap shift-or).  Any pairing involving
N/pad scores as a mismatch so alignments cannot gain through N runs or
chromosome-gap padding.
"""

from __future__ import annotations

import numpy as np

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.io.encode import CODE_A, CODE_C, CODE_G, CODE_T


def score_matrix(cfg: NgmConfig, strand: int = 0) -> np.ndarray:
    """[8, 8] int32 substitution matrix for the configured mode.

    strand matters only for bisulfite mode: 0 = C->T-converted (top/OT)
    strand, 1 = G->A-converted (bottom/OB) strand.
    """
    m = np.full((8, 8), -cfg.mismatch_penalty, dtype=np.int32)
    for c in (CODE_A, CODE_C, CODE_G, CODE_T):
        m[c, c] = cfg.match_bonus
    if cfg.bs_mapping:
        # bisulfite: unmethylated C reads as T. On the original-top strand a
        # read T over a reference C is expected, scored as a (slightly
        # discounted) match; symmetric G->A on the bottom strand.
        tol = max(1, cfg.match_bonus - 1)
        if strand == 0:
            m[CODE_T, CODE_C] = tol
        else:
            m[CODE_A, CODE_G] = tol
    if cfg.slam_seq:
        # SLAM-seq: 4sU labeling reads T sites as C. slam_seq=1 tolerates
        # (score 0), slam_seq=2 rewards as a discounted match.
        m[CODE_C, CODE_T] = 0 if cfg.slam_seq == 1 else max(1, cfg.match_bonus - 1)
    return m


def matrices_are_simple(mats: np.ndarray) -> bool:
    """True when every matrix is pure match/mismatch: S[c,c] = match for
    ACGT, every other entry one shared mismatch value.

    The DEFAULT mode (no bisulfite/SLAM asymmetry) always qualifies, and the
    SW kernels then compute substitution scores with a single equality
    compare instead of 5 per-code coefficient planes (~10 fewer elementwise
    ops per DP cell).  Checked once on the host; a static jit flag selects
    the path.
    """
    flat = np.asarray(mats).reshape(-1, 8, 8)
    m0 = flat[0]
    match = m0[0, 0]
    mis = m0[0, 1]
    want = np.full((8, 8), mis, dtype=m0.dtype)
    for c in range(4):
        want[c, c] = match
    return all(np.array_equal(m, want) for m in flat)
