"""IUPAC alphabet, translation, and unit-cost scoring tables.

Semantics mirror the reference BURST implementation exactly
(burst.c:164-192 score table, :1237-1329 setScore,
:1206-1232 translation, :168 reverse-complement map), re-expressed as
numpy arrays that feed the TPU kernels.

Code space (4-bit):
    0 '.' pad / invalid byte   (never matches anything; cost 255)
    1 A   2 C   3 G   4 T/U   5 N/X
    6 K   7 M   8 R   9 Y   10 S  11 W  12 B  13 V  14 H  15 D
"""
from __future__ import annotations

import numpy as np

PAD = 0
NCODE = 5
NUM_CODES = 16

# Letter for each code (canonical, upper case); code 0 prints '.'.
CODE2CHAR = np.frombuffer(b".ACGTNKMRYSWBVHD", dtype=np.uint8).copy()

# Reverse-complement map over codes (burst.c:168 RVT).
#          .  A  C  G  T  N  K  M  R  Y  S  W  B  V  H  D
RVT = np.array([0, 4, 3, 2, 1, 5, 7, 6, 9, 8, 10, 11, 13, 12, 15, 14],
               dtype=np.uint8)

# Base (Z-independent) mismatch table, SCORENVedN at burst.c:172-190:
# row = query code, col = reference code. -1 rows/cols (code 0) become 255.
# Entries are 0 (compatible -> no cost) or 1 (mismatch -> unit cost).
_BASE = [
    #  .  A  C  G  T  N  K  M  R  Y  S  W  B  V  H  D
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # .
    [-1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0, 0, 0],  # A
    [-1, 1, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1],  # C
    [-1, 1, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0],  # G
    [-1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 0],  # T/U
    [-1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],  # N/X
    [-1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 0],  # K
    [-1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 1, 0, 0, 1],  # M
    [-1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 1, 0],  # R
    [-1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 0, 1, 0, 1],  # Y
    [-1, 1, 0, 0, 1, 0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 1],  # S
    [-1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0],  # W
    [-1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1],  # B
    [-1, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 1],  # V
    [-1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1],  # H
    [-1, 0, 1, 0, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 0],  # D
]


def score_matrix(n_penalize: int = 1) -> np.ndarray:
    """16x16 uint8 unit-cost table. score[q, r] in {0, Z, 1, 255}.

    n_penalize (Z): when nonzero (default, like reference '-n' semantics),
    N/X in either the query or the reference costs Z against every letter
    (burst.c:1256-1285). With Z=0 ('-y'), N/X matches everything at cost 0.
    Code 0 (pad) always costs 255 in either operand.
    """
    z = int(n_penalize)
    m = np.array(_BASE, dtype=np.int32)
    if z:
        m[1:, NCODE] = z      # every query letter vs reference N
        m[NCODE, 1:] = z      # query N vs every reference letter
    m[m == -1] = 255
    out = np.zeros((16, 16), dtype=np.uint8)
    out[:, :] = 255           # reference pad column
    out[: m.shape[0], :] = m.astype(np.uint8)
    return out


def xalpha_score_matrix() -> np.ndarray:
    """Exact-match scoring over raw bytes for '-x' mode: 0 if equal else 1.

    In xalpha mode the reference skips translation and compares raw symbols
    (burst.c:696-697 DIAGSC_XALPHA). We model it as identity scoring applied
    to untranslated byte values; kernels receive a per-pair equality test
    rather than this table (bytes exceed 16 codes), so this is advisory.
    """
    m = np.full((256, 256), 1, dtype=np.uint8)
    np.fill_diagonal(m, 0)
    m[0, :] = 255
    m[:, 0] = 255
    return m


def char2num_table() -> np.ndarray:
    """256-entry ASCII -> 4-bit code LUT (burst.c:1287-1307).

    Unknown letters map to N (5); non-letters map to pad (0).
    """
    t = np.zeros(256, dtype=np.uint8)
    for lo, hi, v in ((65, 91, NCODE), (97, 123, NCODE)):
        t[lo:hi] = v
    for ch, code in zip(b"ACGTUKMRYSWBVHD", (1, 2, 3, 4, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)):
        t[ch] = code
        t[ch + 32] = code  # lower case
    return t


CHAR2NUM = char2num_table()


def translate(seq_bytes: np.ndarray) -> np.ndarray:
    """Translate ASCII uint8 array -> 4-bit codes."""
    return CHAR2NUM[seq_bytes]


def translate_str(s: str | bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return translate(np.frombuffer(s, dtype=np.uint8))


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement a code array (burst.c:3101-3102)."""
    return RVT[codes[::-1]]


def codes_to_str(codes: np.ndarray) -> str:
    return CODE2CHAR[codes].tobytes().decode()
