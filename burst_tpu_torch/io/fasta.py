"""FASTA parsing, mirroring the reference parsers' behavior.

* `parse_fasta` -- line-oriented parser used for references
  (burst.c:484-535 parse_tl_fasta): multi-line sequences, blank/space
  lines skipped, consecutive headers collapse to the last one wins?
  (reference: a header directly after a header is ignored), file ending
  on a header drops that record.

* `parse_fasta_fast` -- strict 2-line parser used for queries
  (burst.c:636-690 parse_tl_faster): errors out unless the file is
  strictly alternating header/sequence lines.

Both return (headers: list[bytes], seqs: list[np.uint8 array of ASCII]).
"""
from __future__ import annotations

import numpy as np


def _open_checked(path: str):
    import os
    import sys
    if not os.path.exists(path):
        # reference error shape (burst.c:488): message + exit code 2
        sys.stderr.write(f"Cannot open FASTA file: {path}.\n")
        sys.exit(2)
    return open(path, "rb")


def parse_fasta(path: str):
    headers: list[bytes] = []
    seqs: list[bytearray] = []
    last_hd = False
    with _open_checked(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if last_hd:
                    continue  # reference ignores repeated headers
                last_hd = True
                headers.append(line[1:])
                seqs.append(bytearray())
            elif line == b"" or line.startswith(b" "):
                continue
            else:
                last_hd = False
                if not headers:
                    raise ValueError("FASTA: sequence before any header")
                seqs[-1].extend(line)
    if last_hd:
        print("WARNING: file ends on header. Skipping last sequence.")
        headers.pop()
        seqs.pop()
    return headers, [np.frombuffer(bytes(s), dtype=np.uint8) for s in seqs]


def parse_fasta_fast(path: str):
    """Strict 2-line FASTA (the reference's query fast path)."""
    with _open_checked(path) as f:
        data = f.read()
    if not data.startswith(b">"):
        raise ValueError("ERROR: Malformatted FASTA file.")
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 2:
        raise ValueError("ERROR: line count != '>' * 2")
    headers, seqs = [], []
    for i in range(0, len(lines), 2):
        h = lines[i]
        if not h.startswith(b">"):
            raise ValueError("ERROR: line count != '>' * 2")
        headers.append(h[1:].rstrip(b"\r"))
        seqs.append(np.frombuffer(lines[i + 1].rstrip(b"\r"), dtype=np.uint8))
    return headers, seqs


def write_fasta(path: str, headers, seqs):
    with open(path, "wb") as f:
        for h, s in zip(headers, seqs):
            if isinstance(h, str):
                h = h.encode()
            if isinstance(s, np.ndarray):
                s = s.tobytes()
            elif isinstance(s, str):
                s = s.encode()
            f.write(b">" + h + b"\n" + s + b"\n")
