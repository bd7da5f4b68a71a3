"""The plain reference against brute force on tiny inputs: the candidate
filter misses no pod, the vectorised DP equals a cell-by-cell one with
the same tie rules, and its distance equals a textbook semi-global edit
distance."""
import numpy as np
import pytest

from harness import reference as refmod

CFG = dict(thres=0.94, max_len_q=60, rebase_amt=80)


def _edit(rng, seq, n):
    s = list(seq)
    for _ in range(n):
        op = rng.integers(0, 3)
        p = int(rng.integers(0, len(s)))
        if op == 0:
            s[p] = int(rng.integers(1, 5))
        elif op == 1:
            s.insert(p, int(rng.integers(1, 5)))
        elif len(s) > 20:
            del s[p]
    return np.array(s, dtype=np.uint8)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    anc = rng.integers(0, 4, size=(3, 700), dtype=np.uint8)
    refs = np.repeat(anc, 2, axis=0)
    refs[1, rng.integers(0, 700, 20)] = rng.integers(0, 4, 20)
    refs[3, rng.integers(0, 700, 20)] = rng.integers(0, 4, 20)
    heads = [f"r{i}".encode() for i in range(len(refs))]
    ref = refmod.Reference(refs, CFG, heads, None, "cpu")
    reads = []
    for i in range(36):
        r = int(rng.integers(0, len(refs)))
        st = int(rng.integers(0, 700 - 60))
        c = refs[r, st:st + 60] + 1
        c = _edit(rng, c, int(rng.integers(0, 5)))
        if i % 2:
            c = refmod.RC_CODE[c[::-1]]
        if i % 9 == 0:
            c[int(rng.integers(0, len(c)))] = 5
        reads.append(c)
    reads.append(rng.integers(1, 5, 60).astype(np.uint8))   # no hit
    reads.append(refs[2, 100:111] + 1)                      # under k
    return ref, reads


def semi_global(q, u):
    """Least edit distance of all of q against any substring of u."""
    prev = np.zeros(len(u) + 1, dtype=np.int64)
    for y, a in enumerate(q, 1):
        cur = np.empty_like(prev)
        cur[0] = y
        for x in range(1, len(u) + 1):
            c = 0 if (a == u[x - 1] and a <= 4) else 1
            cur[x] = min(prev[x - 1] + c, prev[x] + 1, cur[x - 1] + 1)
        prev = cur
    return int(prev[1:].min())


def slow_dp(q, u):
    """BURST's tie rules cell by cell: (ed, gap_q, gap_r, final_pos)."""
    X = len(u)
    s = [0] * (X + 1)
    g = [0] * (X + 1)
    r = [0] * (X + 1)
    for y, a in enumerate(q, 1):
        bs, bg, br = [y], [0], [y]
        for x in range(1, X + 1):
            c = 0 if (a == u[x - 1] and a <= 4) else 1
            so, go, ro = s[x - 1] + c, g[x - 1], r[x - 1]
            su, gu, ru = s[x] + 1, g[x], r[x] + 1
            if su < so or (su == so and gu > go):
                bs.append(su), bg.append(gu), br.append(ru)
            else:
                bs.append(so), bg.append(go), br.append(ro)
        ns, ng, nr = [], [], []
        for x in range(X + 1):
            best = None
            for xp in range(x, -1, -1):          # nearest first wins ties
                k = (bs[xp] + x - xp, -(bg[xp] + x - xp))
                if best is None or k < best[0]:
                    best = (k, xp)
            (sv, gv), xp = best
            ns.append(sv), ng.append(-gv), nr.append(br[xp])
        s, g, r = ns, ng, nr
    last = s[1:]
    m = min(last)
    gm = max(g[x + 1] for x in range(X) if last[x] == m)
    cols = [x + 1 for x in range(X) if last[x] == m and g[x + 1] == gm]
    return m, gm, r[cols[0]], cols[-1]


def test_dp_matches_cell_by_cell(case):
    ref, reads = case
    strands = [reads[i] for i in range(0, 12)]
    units = np.array([(i * 7) % (ref.n_refs * ref.U) for i in range(12)])
    srow = np.arange(12)
    got = ref.dp(strands, srow, units)
    for i in range(12):
        r, s, n = ref.unit_at(int(units[i]))
        u = ref.R[r, s:s + n].numpy() + 1
        want = slow_dp(strands[i], u)
        if want[0] <= 20:
            assert tuple(got[i]) == want, i
        assert min(got[i][0], 99) == min(semi_global(strands[i], u), 99)


def test_candidates_miss_no_pod(case):
    ref, reads = case
    got = ref.pods(reads)
    n_units = ref.n_refs * ref.U
    for c, (e, pods) in zip(reads, got):
        found = {(p.unit, p.rc): p.ed for p in pods}
        for rc, q in ((False, c), (True, refmod.RC_CODE[c[::-1]])):
            for un in range(n_units):
                r, s, n = ref.unit_at(un)
                d = semi_global(q, ref.R[r, s:s + n].numpy() + 1)
                if d <= e:
                    assert found.get((un, rc)) == d
                else:
                    assert (un, rc) not in found


def test_units_follow_the_quick_shear(case):
    ref, _ = case
    # ov = int(60 / 0.94) = 63, stride max(63, 80) = 80, width 143:
    # starts 0, 80, ..., while under 700 - 63
    assert (ref.ov, ref.stride, ref.width, ref.U) == (63, 80, 143, 8)
    r, s, n = ref.unit_span(np.arange(8))
    assert s.tolist() == list(range(0, 640, 80))
    assert n.tolist() == [143] * 7 + [140]


def test_lca_tolerates_a_tenth():
    t = [b"k__B;p__P1;c__C1"] * 9 + [b"k__B;p__P2;c__C2"]
    assert refmod.lca(t, 10) == b"k__B;p__P1;c__C1"
    assert refmod.lca(t[:8] + t[-1:] * 2, 10) == b"k__B"
    assert refmod.lca([b"k__A;p__X"], 10) == b"k__A;p__X"
    assert refmod.lca([b"k__A", b"k__B"], 10) == b""


class _Units:
    """A stand-in for the reference's units: unit u of reference u // U
    at offset 1,000 u, with a given content."""
    U = 3

    def __init__(self, content):
        self.content = content

    def unit_content(self, u):
        return self.content[u]

    def unit_at(self, u):
        return u // self.U, 1000 * u, 500


def _walk(groups, votes):
    """BURST's winner walk over pods in the given order, each pod's
    references in its expansion order (burst.c:4755-4779)."""
    best = best_pod = None
    for j, refs in groups:
        for r in refs:
            if best is None or j == best_pod or votes[r] > votes[best] or \
                    (votes[r] == votes[best] and r < best):
                best, best_pod = r, j
    return best


def test_capitalist_winners_every_walk_order():
    """The references `capitalist_winners` allows are exactly those that
    some order of the pods (and of a group's members after its lowest)
    gives, on random tie sets with identical units."""
    import itertools
    rng = np.random.default_rng(11)
    many = 0
    for _ in range(300):
        n = int(rng.integers(1, 7))
        units = sorted(rng.choice(30, size=n, replace=False).tolist())
        content = {u: bytes([int(rng.integers(0, 3))]) for u in units}
        ref = _Units(content)
        pods = [refmod.Pod(u, False, 1, 0, 0, 100) for u in units]
        refs = {u // ref.U for u in units}
        if len(refs) < n:       # one reference twice: not this test's case
            continue
        votes = {r: int(rng.integers(1, 4)) for r in refs}
        groups: dict[bytes, list[int]] = {}
        for u in units:
            groups.setdefault(content[u], []).append(u // ref.U)
        gl = list(groups.values())
        want = set()
        for order in itertools.permutations(range(len(gl))):
            tails = [itertools.permutations(gl[j][1:]) for j in order]
            for rest in itertools.product(*tails):
                want.add(_walk([(j, [gl[j][0], *t])
                                for j, t in zip(order, rest)], votes))
        got = refmod.capitalist_winners(ref, pods, 100, votes)
        assert got == want, (gl, votes)
        many += len(want) > 1
        if all(len(g) == 1 for g in gl):
            assert got == {max(refs, key=lambda r: (votes[r], -r))}
    assert many > 10
