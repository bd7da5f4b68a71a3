"""Taxonomy map: 2-column TSV parsing and exact-header lookup.

Mirrors burst.c:447-479 (parse_taxonomy) and
:409-440 (taxa_lookup_generic / taxa_lookup_ncbi).
"""
from __future__ import annotations

import bisect


class Taxonomy:
    def __init__(self, pairs: list[tuple[bytes, bytes]], ncbi: bool = False):
        # reference qsorts by header with strcmp (burst.c:5146-5148)
        pairs = sorted(pairs, key=lambda p: p[0])
        self.heads = [p[0] for p in pairs]
        self.taxa = [p[1] for p in pairs]
        self.ncbi = ncbi

    @classmethod
    def parse(cls, path: str, ncbi: bool = False) -> "Taxonomy":
        pairs = []
        import os
        import sys
        if not os.path.exists(path):
            # reference error shape (burst.c:452) + exit code 2
            sys.stderr.write(f"Cannot open TAXONOMY file: {path}.\n")
            sys.exit(2)
        with open(path, "rb") as f:
            for n, raw in enumerate(f):
                line = raw.rstrip(b"\r\n")
                if not line:
                    continue
                if b"\t" not in line:
                    raise ValueError(f"ERROR: invalid taxonomy [{n}]")
                head, rest = line.split(b"\t", 1)
                tax = rest.split(b"\t", 1)[0]
                pairs.append((head, tax))
        if not pairs:
            raise ValueError("ERROR: invalid taxonomy")
        return cls(pairs, ncbi)

    def __len__(self):
        return len(self.heads)

    def lookup(self, key: bytes) -> bytes:
        """Exact-match lookup; NCBI mode skips 4 chars of the key and
        accepts a version-less accession match terminated by '.'."""
        if self.ncbi:
            k = key[4:]
            i = bisect.bisect_left(self.heads, k)
            for j in (i, i - 1, i + 1):
                if 0 <= j < len(self.heads):
                    h = self.heads[j]
                    if k == h or (k.startswith(h) and
                                  len(k) > len(h) and k[len(h):len(h)+1] == b"."):
                        return self.taxa[j]
            # fall back to prefix scan around insertion point
            lo = bisect.bisect_left(self.heads, k[: max(1, len(k))])
            for j in range(max(0, lo - 2), min(len(self.heads), lo + 3)):
                h = self.heads[j]
                if k == h or (k.startswith(h) and k[len(h):len(h)+1] == b"."):
                    return self.taxa[j]
            return b""
        i = bisect.bisect_left(self.heads, key)
        if i < len(self.heads) and self.heads[i] == key:
            return self.taxa[i]
        return b""
