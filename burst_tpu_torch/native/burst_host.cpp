// burst_host: native host-runtime kernels of the aligner (this package's
// own copy of burst_tpu/native/burst_host.cpp, same entry points).
//
// The device owns the DP compute; everything around it that the reference
// implements as C+OpenMP host code (k-mer scour + candidate selection,
// burst.c:4077-4136; per-unit pigeonhole prefilter; blast6 row
// formatting, burst.c:4553-4562) is implemented here natively too.
// Loaded via ctypes (see native/__init__.py); the vectorized numpy
// implementations remain as fallback when no compiler is available.
//
// Build: g++ -O2 -fopenmp -shared -fPIC -o burst_host.so burst_host.cpp
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

namespace {

// postings lookup. Dense path: tab[w] = 0 absent; top-bit-set =
// single posting with the id inline; count field (bits 27-30) nonzero
// = (start, count) inline for shallow words (count 2-15, start <
// 2^27) -- one cache miss resolves the word without the dependent
// (start, count) pair load, and family-DB words are almost all
// shallow; else rank+1 into the interleaved pair array. Large spans
// (k=15) use an open-addressing hash with the same value encoding;
// the final fallback is binary search over the sorted nonzero words.
struct Postings {
    const uint32_t* tab; long span;
    const int64_t* nzw; long n_nz;
    const int64_t* pairs;          // [2*n_nz] interleaved start,count
    const uint32_t* ids;
    const int64_t* hkey; const uint32_t* hval; long hmask;

    long hslot(int64_t w) const {
        return (long)(((uint64_t)w * 0x9E3779B97F4A7C15ull) >> 17)
               & hmask;
    }

    // dense-table decode: count-inline encoding (span <= 2^26 keeps
    // every rank within the 27-bit field)
    int64_t decode(uint32_t v, int64_t* s, int64_t* id) const {
        if (v & 0x80000000u) {
            *s = -1;
            *id = (int64_t)(v & 0x7FFFFFFFu);
            return 1;
        }
        long c = (v >> 27) & 0xF;
        if (c) {
            *s = (int64_t)(v & 0x07FFFFFFu);
            return c;
        }
        long r = (long)(v & 0x07FFFFFFu) - 1;
        *s = pairs[2 * r];
        return pairs[2 * r + 1];
    }

    // hash decode: ranks can exceed 27 bits (k=15 multi-GB builds),
    // so the original 31-bit rank+1 encoding stays
    int64_t decode_hash(uint32_t v, int64_t* s, int64_t* id) const {
        if (v & 0x80000000u) {
            *s = -1;
            *id = (int64_t)(v & 0x7FFFFFFFu);
            return 1;
        }
        long r = (long)v - 1;
        *s = pairs[2 * r];
        return pairs[2 * r + 1];
    }

    // returns count; count==1 with *s == -1 means *id holds the
    // posting inline
    int64_t find(int64_t w, int64_t* s, int64_t* id) const {
        if (tab) {
            if (w >= span) return 0;
            uint32_t v = tab[w];
            if (!v) return 0;
            return decode(v, s, id);
        }
        if (hkey) {
            long i = hslot(w);
            while (hkey[i] != -1) {
                if (hkey[i] == w) return decode_hash(hval[i], s, id);
                i = (i + 1) & hmask;
            }
            return 0;
        }
        const int64_t* lo = std::lower_bound(nzw, nzw + n_nz, w);
        if (lo == nzw + n_nz || *lo != w) return 0;
        long ix = (long)(lo - nzw);
        *s = pairs[2 * ix];
        return pairs[2 * ix + 1];
    }
};

struct Cand { int64_t hits; int64_t touch; int64_t clump; };

// stage-cycle accounting, enabled by BURST_SCOUR_PROF=1 (printed to
// stderr at the end of each scour_run); negligible overhead when off
static bool g_prof = []() {
    const char* e = getenv("BURST_SCOUR_PROF");
    return e && e[0] == '1';
}();
static inline uint64_t rdtsc() {
    return g_prof ? __builtin_ia32_rdtsc() : 0;
}

}  // namespace

extern "C" {

// Open-addressing hash build for large-span postings (k=15): same
// value encoding as the dense table (inline single posting or rank+1).
// cap must be a power of two > n.
void hash_build(const int64_t* nzw, const int64_t* pairs,
                const uint32_t* ids, long n,
                int64_t* hkey, uint32_t* hval, long cap)
{
    long mask = cap - 1;
    for (long i = 0; i < cap; ++i) hkey[i] = -1;
    for (long r = 0; r < n; ++r) {
        int64_t w = nzw[r];
        uint32_t v;
        if (pairs[2 * r + 1] == 1 &&
            ids[pairs[2 * r]] < 0x80000000u)
            v = 0x80000000u | ids[pairs[2 * r]];
        else
            v = (uint32_t)(r + 1);
        long i = (long)(((uint64_t)w * 0x9E3779B97F4A7C15ull) >> 17)
                 & mask;
        while (hkey[i] != -1) i = (i + 1) & mask;
        hkey[i] = w;
        hval[i] = v;
    }
}

// ---------------------------------------------------------------- scour
// Bunch-level k-mer scour + candidate selection + member expansion.
// Semantics mirror engine.accel_candidates (see its docstring for the
// burst.c citations): per bunch, the union of member k-mer words in
// ascending word order, per-word weight = MAX multiplicity over
// members, postings walked in word order accumulating per-clump hits
// (saturated at 0xFFFF) with first-touch ranking; bunch candidates =
// clumps with hits > mm_bunch[g] ordered by (hits desc, first-touch
// asc); member lists = bunch candidates with hits > mm_inner[j].
//
// Results are held in growable buffers between the _run and _fetch
// calls. thread_local: serving's align_stream pipelines batches on
// worker threads (each thread does its own run+sizes+fetch), so a
// process-global here would let one batch's run clobber another's
// results between its run and fetch (observed as mismatched
// mflat/mcnt sizes in _assemble_visits). The OpenMP workers inside
// scour_run write into a run-local ScourResult (disjoint indices)
// that is moved into the caller thread's slot at the end.
struct ScourResult {
    std::vector<int64_t> bflat, bhits, mflat;
    std::vector<int64_t> bcnt, mcnt, ukeys;
};
static thread_local ScourResult g_scour;

// With u_ids != NULL the unit-level pigeonhole prefilter runs fused in
// the same pass (reusing each member's sorted word multiset): per clear
// member j, per-unit hit counts over the unit-granular postings, keys
// j*tot_units+u emitted (ascending) for units with hits > mm_inner[j].
long scour_run(
    const uint8_t* qmat, long qstride, const int64_t* qlens,
    long b0, long b1, long qbunch, int k,
    const int64_t* aq_off, const int64_t* aq_words,
    const int64_t* aq_mult,
    const uint32_t* tab, long span,
    const int64_t* nzw, long n_nz,
    const int64_t* pairs, const uint32_t* ids,
    const int64_t* hkey, const uint32_t* hval, long hcap,
    long n_clumps,
    const int64_t* mm_bunch, const int64_t* mm_inner,
    const uint32_t* u_tab, long u_span,
    const int64_t* u_nzw, long u_n_nz,
    const int64_t* u_pairs, const uint32_t* u_ids,
    const int64_t* u_hkey, const uint32_t* u_hval, long u_hcap,
    long tot_units,
    long vecsz,
    long threads)
{
    long n_bunches = (b1 + qbunch - 1) / qbunch;
    ScourResult res;   // run-local; OMP workers write disjoint slots
    res.bcnt.assign(n_bunches, 0);
    res.mcnt.assign(b1, 0);
    Postings post{tab, span, nzw, n_nz, pairs, ids,
                  hkey, hval, hcap - 1};
    Postings upost{u_tab, u_span, u_nzw, u_n_nz, u_pairs, u_ids,
                   u_hkey, u_hval, u_hcap - 1};
    bool do_unit = u_ids != nullptr;

    int nt = threads > 0 ? (int)threads : omp_get_max_threads();
    std::vector<std::vector<int64_t>> t_bflat(nt), t_bhits(nt),
        t_mflat(nt), t_ukeys(nt);
    uint64_t c_words = 0, c_find = 0, c_flat = 0, c_acc = 0,
             c_sel = 0, c_emit = 0;

#pragma omp parallel num_threads(nt)
    {
        int tid = omp_get_thread_num();
        std::vector<int32_t> hits(n_clumps, 0);
        std::vector<int32_t> uh(do_unit ? tot_units : 0, 0);
        std::vector<int64_t> utouched; utouched.reserve(256);
        std::vector<int64_t> touched; touched.reserve(1024);
        // packed (word<<8 | member-in-bunch); qbunch <= 255; each
        // occurrence contributes multiplicity 1 (clear members), so
        // per-(word,member) counts are run lengths after sorting
        std::vector<int64_t> wm; wm.reserve(512);
        std::vector<Cand> cand; cand.reserve(256);
        // run-collapsed per-word data (staged for memory parallelism)
        std::vector<int64_t> uw, uwt, umemb, umcnt;
        std::vector<int64_t> ps, pc, pid, ups, upc, upid;
        // flattened postings + per-span meta for the prefetch-ahead
        // accumulate (fast1 path)
        std::vector<uint32_t> fu; fu.reserve(4096);
        std::vector<int32_t> fc; fc.reserve(256);
        std::vector<int64_t> fm; fm.reserve(256);
        // generic-path flattened unit spans + per-member word buckets
        std::vector<uint32_t> fuu; fuu.reserve(4096);
        std::vector<int64_t> fuo;
        std::vector<std::vector<int64_t>> mwl(
            (size_t)std::max<long>(qbunch, 1));

#pragma omp for schedule(static)
        for (long g = 0; g < n_bunches; ++g) {
            uint64_t t0p = rdtsc();
            long j_lo = g * qbunch;
            long j_hi = std::min(b1, j_lo + qbunch);
            bool any_ambig = j_lo < b0;
            wm.clear();
            for (long j = j_lo; j < j_hi; ++j) {
                int64_t mrel = j - j_lo;
                if (j < b0) {
                    // ambiguous member: precomputed unique words+mults;
                    // replicate small multiplicities so run lengths
                    // stay the counts (mults from expansion are tiny)
                    for (int64_t a = aq_off[j]; a < aq_off[j + 1]; ++a)
                        for (int64_t rep = 0; rep < aq_mult[a]; ++rep)
                            wm.push_back((aq_words[a] << 8) | mrel);
                } else {
                    const uint8_t* q = qmat + j * qstride;
                    long len = qlens[j];
                    if (len < k) continue;
                    int64_t w = 0;
                    int64_t mask = ((int64_t)1 << (2 * k)) - 1;
                    for (long t = 0; t < k - 1; ++t)
                        w = (w << 2) | (int64_t)(q[t] - 1);
                    for (long t = k - 1; t < len; ++t) {
                        w = ((w << 2) | (int64_t)(q[t] - 1)) & mask;
                        wm.push_back((w << 8) | mrel);
                    }
                }
            }
            (void)any_ambig;
            if (wm.empty()) continue;
            std::sort(wm.begin(), wm.end());
            // run-collapse into unique words with per-member counts
            uw.clear(); uwt.clear(); umemb.clear(); umcnt.clear();
            {
                size_t i = 0;
                while (i < wm.size()) {
                    int64_t w = wm[i] >> 8;
                    int64_t best_m = 0;
                    size_t nm0 = umemb.size();
                    while (i < wm.size() && (wm[i] >> 8) == w) {
                        int64_t mr = wm[i] & 0xFF;
                        int64_t cnt = 0;
                        while (i < wm.size() && (wm[i] >> 8) == w &&
                               (wm[i] & 0xFF) == mr) { ++cnt; ++i; }
                        umemb.push_back((mr << 32) | cnt);
                        if (cnt > best_m) best_m = cnt;
                    }
                    uw.push_back(w);
                    uwt.push_back(best_m);
                    umcnt.push_back((int64_t)(umemb.size() - nm0));
                }
            }
            size_t nw = uw.size();
            uint64_t t1p = rdtsc();
            // single-walk fast path: with the unit index active and
            // one clear member per bunch, the unit postings drive BOTH
            // tables -- clump hits accumulate once per distinct clump
            // per word (unit ids are clump-grouped ascending, matching
            // the ACX clump-posting order, so first-touch ranks agree)
            bool fast1 = do_unit && qbunch == 1 && vecsz > 0 &&
                         j_lo >= b0;
            // vecsz is 16 in practice (the reference's clump width);
            // a shift avoids a ~25-cycle idiv on every posting
            const int vshift =
                (vecsz > 0 && (vecsz & (vecsz - 1)) == 0)
                ? __builtin_ctzll((unsigned long long)vecsz) : -1;
            touched.clear();
            if (fast1) {
                ups.assign(nw, 0); upc.assign(nw, 0); upid.assign(nw, 0);
                for (size_t i = 0; i < nw; ++i) {
                    if (upost.tab) __builtin_prefetch(&upost.tab[uw[i]]);
                    else if (upost.hkey)
                        __builtin_prefetch(
                            &upost.hkey[upost.hslot(uw[i])]);
                }
                for (size_t i = 0; i < nw; ++i) {
                    int64_t s = 0, idv = 0;
                    int64_t c = upost.find(uw[i], &s, &idv);
                    ups[i] = s; upc[i] = c; upid[i] = idv;
                    if (c && s >= 0) __builtin_prefetch(&u_ids[s]);
                }
                uint64_t t2p = rdtsc();
                // Flatten the postings spans into one buffer, span
                // D ahead prefetched while span i streams out: the
                // u_ids loads overlap instead of serializing their
                // cache misses (the postings array is hundreds of MB;
                // every span is a miss).
                fu.clear(); fc.clear(); fm.clear();
                const size_t D = 8;
                for (size_t i = 0; i < nw; ++i) {
                    if (i + D < nw && upc[i + D] && ups[i + D] >= 0) {
                        const uint32_t* p0 = &u_ids[ups[i + D]];
                        for (long o = 0; o < upc[i + D]; o += 16)
                            __builtin_prefetch(p0 + o);
                    }
                    int64_t c = upc[i];
                    if (!c) continue;
                    if (ups[i] < 0) {
                        fu.push_back((uint32_t)upid[i]);
                    } else {
                        const uint32_t* p0 = &u_ids[ups[i]];
                        fu.insert(fu.end(), p0, p0 + c);
                    }
                    fc.push_back((int32_t)c);
                    fm.push_back(uwt[i]);
                }
                uint64_t t3p = rdtsc();
                // Accumulate with the counter lines prefetched PF
                // entries ahead: uh (one line per distinct unit) and
                // hits (per clump) are multi-MB tables, and the
                // dependent-walk form stalls on every increment.
                utouched.clear();
                const size_t PF = 24;
                size_t gi = 0;
                const size_t tot = fu.size();
                for (size_t si = 0; si < fc.size(); ++si) {
                    int64_t m = fm[si];
                    int64_t last_cl = -1;
                    for (int32_t p = 0; p < fc[si]; ++p, ++gi) {
                        if (gi + PF < tot) {
                            long un = (long)fu[gi + PF];
                            __builtin_prefetch(&uh[un]);
                            __builtin_prefetch(&hits[vshift >= 0
                                ? (un >> vshift) : (un / vecsz)]);
                        }
                        int64_t u = (int64_t)fu[gi];
                        if (!uh[u]) utouched.push_back(u);
                        uh[u] = (int32_t)std::min<int64_t>(
                            (int64_t)uh[u] + m, 0x7FFFFFFF);
                        int64_t cl = vshift >= 0 ? (u >> vshift)
                                                 : (u / vecsz);
                        if (cl != last_cl) {
                            if (!hits[cl]) touched.push_back(cl);
                            int64_t h = (int64_t)hits[cl] + m;
                            hits[cl] = (int32_t)std::min<int64_t>(
                                h, 0xFFFF);
                            last_cl = cl;
                        }
                    }
                }
                uint64_t t4p = rdtsc();
                if (g_prof) {
                    c_words += t1p - t0p; c_find += t2p - t1p;
                    c_flat += t3p - t2p; c_acc += t4p - t3p;
                }
            } else {
            // stage: batched postings lookups (independent accesses
            // overlap their cache misses; the dependent walk-as-you-
            // look-up form stalls on every table probe). ps == -1
            // flags an inline single posting held in pid.
            ps.assign(nw, 0); pc.assign(nw, 0); pid.assign(nw, 0);
            for (size_t i = 0; i < nw; ++i) {
                if (post.tab) __builtin_prefetch(&post.tab[uw[i]]);
                else if (post.hkey)
                    __builtin_prefetch(&post.hkey[post.hslot(uw[i])]);
            }
            for (size_t i = 0; i < nw; ++i) {
                int64_t s = 0, idv = 0;
                int64_t c = post.find(uw[i], &s, &idv);
                ps[i] = s; pc[i] = c; pid[i] = idv;
                if (c && s >= 0) __builtin_prefetch(&ids[s]);
            }
            if (do_unit) {
                ups.assign(nw, 0); upc.assign(nw, 0); upid.assign(nw, 0);
                for (size_t i = 0; i < nw; ++i) {
                    if (upost.tab) __builtin_prefetch(&upost.tab[uw[i]]);
                    else if (upost.hkey)
                        __builtin_prefetch(
                            &upost.hkey[upost.hslot(uw[i])]);
                }
                for (size_t i = 0; i < nw; ++i) {
                    int64_t s = 0, idv = 0;
                    int64_t c = upost.find(uw[i], &s, &idv);
                    ups[i] = s; upc[i] = c; upid[i] = idv;
                    if (c && s >= 0) __builtin_prefetch(&u_ids[s]);
                }
            }
            // clump hit accumulation in word order: flatten the
            // spans (span D ahead prefetched), then accumulate with
            // the counter lines prefetched PF entries ahead -- same
            // scheme as the fast path
            fu.clear(); fc.clear(); fm.clear();
            {
                const size_t D = 8;
                for (size_t i = 0; i < nw; ++i) {
                    if (i + D < nw && pc[i + D] && ps[i + D] >= 0) {
                        const uint32_t* p0 = &ids[ps[i + D]];
                        for (long o = 0; o < pc[i + D]; o += 16)
                            __builtin_prefetch(p0 + o);
                    }
                    int64_t c = pc[i];
                    if (!c) continue;
                    if (ps[i] < 0) {
                        fu.push_back((uint32_t)pid[i]);
                    } else {
                        const uint32_t* p0 = &ids[ps[i]];
                        fu.insert(fu.end(), p0, p0 + c);
                    }
                    fc.push_back((int32_t)c);
                    fm.push_back(uwt[i]);
                }
                const size_t PF = 24;
                size_t gi = 0;
                const size_t tot = fu.size();
                for (size_t si = 0; si < fc.size(); ++si) {
                    int64_t m = fm[si];
                    for (int32_t p = 0; p < fc[si]; ++p, ++gi) {
                        if (gi + PF < tot)
                            __builtin_prefetch(&hits[fu[gi + PF]]);
                        int64_t cl = (int64_t)fu[gi];
                        if (!hits[cl]) touched.push_back(cl);
                        int64_t h = (int64_t)hits[cl] + m;
                        hits[cl] = (int32_t)std::min<int64_t>(h, 0xFFFF);
                    }
                }
            }
            }
            // candidates: hits > mm_bunch, (hits desc, touch-order asc)
            uint64_t t5p = rdtsc();
            int64_t thr = mm_bunch[g];
            cand.clear();
            for (size_t t = 0; t < touched.size(); ++t) {
                int64_t cl = touched[t];
                if (hits[cl] > thr)
                    cand.push_back(Cand{hits[cl], (int64_t)t, cl});
            }
            std::sort(cand.begin(), cand.end(),
                      [](const Cand& a, const Cand& b) {
                          if (a.hits != b.hits) return a.hits > b.hits;
                          return a.touch < b.touch;
                      });
            res.bcnt[g] = (long)cand.size();
            for (auto& cc : cand) {
                t_bflat[tid].push_back(cc.clump);
                t_bhits[tid].push_back(cc.hits);
            }
            // member expansion
            for (long j = j_lo; j < j_hi; ++j) {
                long cnt = 0;
                for (auto& cc : cand)
                    if (cc.hits > mm_inner[j]) {
                        t_mflat[tid].push_back(cc.clump);
                        ++cnt;
                    }
                res.mcnt[j] = cnt;
            }
            for (int64_t cl : touched) hits[cl] = 0;
            uint64_t t6p = rdtsc();
            if (g_prof) c_sel += t6p - t5p;
            // fused unit-level prefilter (clear members only) over the
            // same run-collapsed words. Only the PASSING units need
            // sorting for the ascending-key contract -- a handful per
            // read -- not the whole touched list (hundreds); sorting
            // everything was the single hottest stage of the scour.
            if (fast1) {
                int64_t thrU = mm_inner[j_lo];
                size_t k0 = t_ukeys[tid].size();
                for (int64_t u : utouched) {
                    if (uh[u] > thrU)
                        t_ukeys[tid].push_back(j_lo * tot_units + u);
                    uh[u] = 0;
                }
                std::sort(t_ukeys[tid].begin() + k0,
                          t_ukeys[tid].end());
                if (g_prof) c_emit += rdtsc() - t6p;
            } else if (do_unit && std::max(j_lo, b0) < j_hi) {
                // flatten each word's unit postings ONCE (they are
                // re-walked per member below) and bucket the (word,
                // count) entries per member: the old form rescanned
                // every word's member list for every member
                // (O(words x members)) and re-missed the postings
                // array on every member's walk
                fuo.assign(nw + 1, 0);
                fuu.clear();
                const size_t D = 8;
                for (size_t i = 0; i < nw; ++i) {
                    if (i + D < nw && upc[i + D] && ups[i + D] >= 0) {
                        const uint32_t* p0 = &u_ids[ups[i + D]];
                        for (long o = 0; o < upc[i + D]; o += 16)
                            __builtin_prefetch(p0 + o);
                    }
                    int64_t c = upc[i];
                    if (c) {
                        if (ups[i] < 0) {
                            fuu.push_back((uint32_t)upid[i]);
                        } else {
                            const uint32_t* p0 = &u_ids[ups[i]];
                            fuu.insert(fuu.end(), p0, p0 + c);
                        }
                    }
                    fuo[i + 1] = (int64_t)fuu.size();
                }
                for (long r = 0; r < qbunch; ++r) mwl[r].clear();
                {
                    size_t mix = 0;
                    for (size_t i = 0; i < nw; ++i)
                        for (int64_t t = 0; t < umcnt[i]; ++t, ++mix)
                            mwl[umemb[mix] >> 32].push_back(
                                ((int64_t)i << 32) |
                                (umemb[mix] & 0xFFFFFFFF));
                }
                for (long j = std::max(j_lo, b0); j < j_hi; ++j) {
                    long mrel = j - j_lo;
                    utouched.clear();
                    const int64_t PF = 16;
                    auto& lst = mwl[mrel];
                    for (size_t e = 0; e < lst.size(); ++e) {
                        size_t i = (size_t)(lst[e] >> 32);
                        int64_t m = lst[e] & 0xFFFFFFFF;
                        if (e + 1 < lst.size())
                            __builtin_prefetch(
                                &fuu[fuo[lst[e + 1] >> 32]]);
                        for (int64_t p = fuo[i]; p < fuo[i + 1]; ++p) {
                            if (p + PF < fuo[i + 1])
                                __builtin_prefetch(&uh[fuu[p + PF]]);
                            int64_t u = (int64_t)fuu[p];
                            if (!uh[u]) utouched.push_back(u);
                            uh[u] = (int32_t)std::min<int64_t>(
                                (int64_t)uh[u] + m, 0x7FFFFFFF);
                        }
                    }
                    // emit the PASSING units sorted (ascending-key
                    // contract); resets stay walk-ordered
                    int64_t thr2 = mm_inner[j];
                    size_t k0 = t_ukeys[tid].size();
                    for (int64_t u : utouched) {
                        if (uh[u] > thr2)
                            t_ukeys[tid].push_back(j * tot_units + u);
                        uh[u] = 0;
                    }
                    std::sort(t_ukeys[tid].begin() + k0,
                              t_ukeys[tid].end());
                }
            }
        }
    }
    // static scheduling gives each thread a contiguous bunch block in
    // order, so concatenating thread buffers restores global order
    for (int t = 0; t < nt; ++t) {
        res.bflat.insert(res.bflat.end(), t_bflat[t].begin(),
                         t_bflat[t].end());
        res.bhits.insert(res.bhits.end(), t_bhits[t].begin(),
                         t_bhits[t].end());
        res.mflat.insert(res.mflat.end(), t_mflat[t].begin(),
                         t_mflat[t].end());
        res.ukeys.insert(res.ukeys.end(), t_ukeys[t].begin(),
                         t_ukeys[t].end());
    }
    if (g_prof)
        fprintf(stderr, "[scour prof] words=%.0fM find=%.0fM flat=%.0fM"
                " acc=%.0fM sel=%.0fM emit=%.0fM cycles\n",
                c_words / 1e6, c_find / 1e6, c_flat / 1e6, c_acc / 1e6,
                c_sel / 1e6, c_emit / 1e6);
    g_scour = std::move(res);   // publish to this caller thread's slot
    return 0;
}

void scour_sizes(int64_t* out3)
{
    out3[0] = (int64_t)g_scour.bflat.size();
    out3[1] = (int64_t)g_scour.mflat.size();
    out3[2] = (int64_t)g_scour.ukeys.size();
}

void scour_fetch(int64_t* bflat, int64_t* bhits, int64_t* bcnt,
                 int64_t* mflat, int64_t* mcnt, int64_t* ukeys)
{
    std::memcpy(bflat, g_scour.bflat.data(),
                g_scour.bflat.size() * sizeof(int64_t));
    std::memcpy(bhits, g_scour.bhits.data(),
                g_scour.bhits.size() * sizeof(int64_t));
    std::memcpy(bcnt, g_scour.bcnt.data(),
                g_scour.bcnt.size() * sizeof(int64_t));
    std::memcpy(mflat, g_scour.mflat.data(),
                g_scour.mflat.size() * sizeof(int64_t));
    std::memcpy(mcnt, g_scour.mcnt.data(),
                g_scour.mcnt.size() * sizeof(int64_t));
    if (ukeys)
        std::memcpy(ukeys, g_scour.ukeys.data(),
                    g_scour.ukeys.size() * sizeof(int64_t));
    std::vector<int64_t>().swap(g_scour.bflat);
    std::vector<int64_t>().swap(g_scour.bhits);
    std::vector<int64_t>().swap(g_scour.mflat);
    std::vector<int64_t>().swap(g_scour.ukeys);
}

// ------------------------------------------------- unit-level prefilter
// Per clear unibin: per-unit q-gram hit counts over the unit-granular
// postings; emit sorted keys j*tot_units + u for units passing
// hits > mm_inner[j] (sound pigeonhole at unit granularity).
static std::vector<int64_t> g_ukeys;

long unit_prefilter_run(
    const uint8_t* qmat, long qstride, const int64_t* qlens,
    long b0, long b1, int k,
    const uint32_t* tab, long span,
    const int64_t* nzw, long n_nz,
    const int64_t* pairs, const uint32_t* ids,
    const int64_t* hkey, const uint32_t* hval, long hcap,
    long tot_units, const int64_t* mm_inner, long threads)
{
    g_ukeys.clear();
    Postings post{tab, span, nzw, n_nz, pairs, ids, hkey, hval,
                  hcap - 1};
    int nt = threads > 0 ? (int)threads : omp_get_max_threads();
    std::vector<std::vector<int64_t>> t_keys(nt);

#pragma omp parallel num_threads(nt)
    {
        int tid = omp_get_thread_num();
        std::vector<int32_t> uh(tot_units, 0);
        std::vector<int64_t> touched; touched.reserve(256);
        std::vector<int64_t> words; words.reserve(512);

#pragma omp for schedule(static)
        for (long j = b0; j < b1; ++j) {
            const uint8_t* q = qmat + j * qstride;
            long len = qlens[j];
            if (len < k) continue;
            words.clear();
            int64_t w = 0;
            int64_t mask = ((int64_t)1 << (2 * k)) - 1;
            for (long t = 0; t < k - 1; ++t)
                w = (w << 2) | (int64_t)(q[t] - 1);
            for (long t = k - 1; t < len; ++t) {
                w = ((w << 2) | (int64_t)(q[t] - 1)) & mask;
                words.push_back(w);
            }
            std::sort(words.begin(), words.end());
            touched.clear();
            size_t i = 0;
            while (i < words.size()) {
                int64_t wv = words[i];
                int64_t m = 0;
                while (i < words.size() && words[i] == wv) { ++m; ++i; }
                int64_t s = 0, idv = 0;
                int64_t c = post.find(wv, &s, &idv);
                if (!c) continue;
                if (s < 0) {
                    if (!uh[idv]) touched.push_back(idv);
                    uh[idv] = (int32_t)std::min<int64_t>(
                        (int64_t)uh[idv] + m, 0x7FFFFFFF);
                    continue;
                }
                for (int64_t p = s; p < s + c; ++p) {
                    int64_t u = ids[p];
                    if (!uh[u]) touched.push_back(u);
                    uh[u] = (int32_t)std::min<int64_t>(
                        (int64_t)uh[u] + m, 0x7FFFFFFF);
                }
            }
            std::sort(touched.begin(), touched.end());
            int64_t thr = mm_inner[j];
            for (int64_t u : touched) {
                if (uh[u] > thr)
                    t_keys[tid].push_back(j * tot_units + u);
                uh[u] = 0;
            }
        }
    }
    for (int t = 0; t < nt; ++t)
        g_ukeys.insert(g_ukeys.end(), t_keys[t].begin(), t_keys[t].end());
    return (long)g_ukeys.size();
}

void unit_prefilter_fetch(int64_t* out)
{
    std::memcpy(out, g_ukeys.data(), g_ukeys.size() * sizeof(int64_t));
    std::vector<int64_t>().swap(g_ukeys);
}

// ------------------------------------------------- visit-pair expansion
// engine.expand_visit_pairs inner loop: expand per-row clump visit
// lists into (row, unit) pairs with the sound lane-level pruning
// applied (keep unfiltered rows, BadList clumps, and pairs passing the
// per-unit pigeonhole -- pass_keys is the sorted j*tot_units+u list).
// The numpy form materializes |visits|*VECSZ lane arrays (tens of
// millions of int64 at amplicon candidate densities) before filtering;
// this walks once to count and once to fill.
static long expand_pairs_walk(
    const int64_t* offs, const int64_t* flat, long nj, long tot_units,
    long vecsz, const uint8_t* filtered, const uint8_t* bad_clump,
    const int64_t* pass_keys, long n_pass,
    int64_t* pj, int64_t* pp)
{
    long n = 0;
    long seg_lo = 0;
    for (long j = 0; j < nj; ++j) {
        bool filt = filtered && filtered[j];
        // pass_keys segment for row j (keys ascending; rows ascending)
        long seg_hi = seg_lo;
        if (filt) {
            const int64_t up = (int64_t)(j + 1) * tot_units;
            seg_hi = (long)(std::lower_bound(pass_keys + seg_lo,
                                             pass_keys + n_pass, up)
                            - pass_keys);
        }
        for (int64_t v = offs[j]; v < offs[j + 1]; ++v) {
            const int64_t base = flat[v] * vecsz;
            bool bad = bad_clump && bad_clump[flat[v]];
            for (long l = 0; l < vecsz; ++l) {
                const int64_t u = base + l;
                if (u >= tot_units) break;
                if (filt && !bad) {
                    const int64_t key = (int64_t)j * tot_units + u;
                    const int64_t* lo = std::lower_bound(
                        pass_keys + seg_lo, pass_keys + seg_hi, key);
                    if (lo == pass_keys + seg_hi || *lo != key)
                        continue;
                }
                if (pj) { pj[n] = j; pp[n] = u; }
                ++n;
            }
        }
        if (filt) seg_lo = seg_hi;
    }
    return n;
}

extern "C" {

long expand_pairs_count(
    const int64_t* offs, const int64_t* flat, long nj, long tot_units,
    long vecsz, const uint8_t* filtered, const uint8_t* bad_clump,
    const int64_t* pass_keys, long n_pass)
{
    return expand_pairs_walk(offs, flat, nj, tot_units, vecsz,
                             filtered, bad_clump, pass_keys, n_pass,
                             nullptr, nullptr);
}

long expand_pairs_fill(
    const int64_t* offs, const int64_t* flat, long nj, long tot_units,
    long vecsz, const uint8_t* filtered, const uint8_t* bad_clump,
    const int64_t* pass_keys, long n_pass, int64_t* pj, int64_t* pp)
{
    return expand_pairs_walk(offs, flat, nj, tot_units, vecsz,
                             filtered, bad_clump, pass_keys, n_pass,
                             pj, pp);
}

}  // extern "C"

// ----------------------------------------------- duplicate suppression
// The reference's DUPE_HUNT (burst.c:4563-4580): within each group
// (query), an entry is suppressed iff some PRIOR KEPT entry has the
// same mapped ref and an overlapping start window:
//   (u32)(s + ql2) > st  &&  s < (u32)(st + ql2)
// Kept entries append to the window list; suppressed ones do not.
void dupe_filter(const int64_t* offs, long n_groups,
                 const int64_t* mapped, const uint32_t* start,
                 const int64_t* ql2s, uint8_t* keep)
{
#pragma omp parallel
    {
        std::vector<int64_t> refs;
        std::vector<uint32_t> starts;
#pragma omp for schedule(static)
        for (long g = 0; g < n_groups; ++g) {
            refs.clear();
            starts.clear();
            uint32_t ql2 = (uint32_t)ql2s[g];
            for (int64_t e = offs[g]; e < offs[g + 1]; ++e) {
                uint32_t st = start[e];
                bool seen = false;
                for (size_t p = 0; p < refs.size(); ++p)
                    if (refs[p] == mapped[e] &&
                        (uint32_t)(starts[p] + ql2) > st &&
                        starts[p] < (uint32_t)(st + ql2)) {
                        seen = true;
                        break;
                    }
                if (seen) {
                    keep[e] = 0;
                } else {
                    keep[e] = 1;
                    refs.push_back(mapped[e]);
                    starts.push_back(st);
                }
            }
        }
    }
}

// ------------------------------------------------- CAPITALIST pass 3
// Per query group, walk the kept entries in order and pick the winner
// exactly like burst.c:4755-4779: the first entry wins initially; a
// later entry replaces it when its bin has more votes, ties with a
// lower bin id, or belongs to the currently-best pod (the reference
// re-walks the winning pod's duplicate expansion, so its last
// expanded ref wins). Returns the winning entry index per group
// (-1 for empty groups).
void capitalist_select(const int64_t* offs, long n_groups,
                       const int64_t* pod, const int64_t* mapped,
                       const int64_t* counts, int64_t* best_entry)
{
#pragma omp parallel for schedule(static)
    for (long g = 0; g < n_groups; ++g) {
        int64_t best = -1;
        int64_t best_pod = -1, best_map = -1;
        for (int64_t e = offs[g]; e < offs[g + 1]; ++e) {
            if (best < 0 || pod[e] == best_pod ||
                counts[mapped[e]] > counts[best_map] ||
                (counts[mapped[e]] == counts[best_map] &&
                 mapped[e] < best_map)) {
                best = e;
                best_pod = pod[e];
                best_map = mapped[e];
            }
        }
        best_entry[g] = best;
    }
}

// ----------------------------------------------------------- Peq build
// Myers bit tables (kernels/myers.build_peq semantics): bit y of word w
// of plane c set iff query row y is a zero-cost match against reference
// code c, or y >= qlen (wildcard pad rows match everything, incl. 0).
// zmask[code] = 16-bit mask over c of zero-cost matches.
void build_peq16(const uint8_t* qmat, long qstride, const int64_t* qlens,
                 long B, int W, const uint16_t* zmask, uint32_t* out)
{
    long m_pad = (long)W * 32;
#pragma omp parallel for schedule(static)
    for (long b = 0; b < B; ++b) {
        const uint8_t* q = qmat + b * qstride;
        long len = qlens[b] < m_pad ? qlens[b] : m_pad;
        uint32_t* dst = out + b * 16 * W;
        for (int w = 0; w < W; ++w) {
            uint32_t cur[16] = {0};
            long y_lo = (long)w * 32;
            long y_hi = y_lo + 32;
            long y_real = len < y_hi ? (len > y_lo ? len : y_lo) : y_hi;
            for (long y = y_lo; y < y_real; ++y) {
                uint16_t m = zmask[q[y]];
                uint32_t bit = 1u << (y - y_lo);
                for (int c = 0; c < 16; ++c)
                    if (m & (1u << c)) cur[c] |= bit;
            }
            // wildcard pad rows: all planes
            if (y_real < y_hi) {
                uint32_t padbits = ~0u;
                if (y_real > y_lo)
                    padbits <<= (y_real - y_lo);
                for (int c = 0; c < 16; ++c) cur[c] |= padbits;
            }
            for (int c = 0; c < 16; ++c) dst[c * W + w] = cur[c];
        }
    }
}

// ------------------------------------------------------- b6 formatting
// One blast6 row (PRINT_MATCH, burst.c:4553-4562): tab-separated
// q, r, %f score*100, alnlen, mism, gap, 1, qlen, st, ed, totED, ix
// [, tax]. st prints the uint32 value as signed %d; the rest unsigned.
// Returns bytes written, or -(estimated bytes needed) if cap is too
// small (caller re-calls with a bigger buffer).
long b6_format(
    const char* qblob, const int64_t* qoff, const int64_t* qrow,
    const char* rblob, const int64_t* roff, const int64_t* rrow,
    const float* score, const uint32_t* al_len, const uint32_t* num_mis,
    const uint32_t* num_gap, const uint32_t* qlen,
    const int32_t* st_ix, const uint32_t* ed_ix, const uint32_t* mism,
    const int64_t* last,
    const char* tblob, const int64_t* toff, const int64_t* trow,
    long n, char* out, long cap)
{
    long pos = 0;
    for (long i = 0; i < n; ++i) {
        int64_t qr = qrow[i], rr = rrow[i];
        long ql = (long)(qoff[qr + 1] - qoff[qr]);
        long rl = (long)(roff[rr + 1] - roff[rr]);
        long tl = 0;
        if (tblob) tl = (long)(toff[trow[i] + 1] - toff[trow[i]]);
        if (pos + ql + rl + tl + 256 > cap)
            return -(pos + (n - i) * (ql + rl + tl + 256) + 256);
        std::memcpy(out + pos, qblob + qoff[qr], ql); pos += ql;
        out[pos++] = '\t';
        std::memcpy(out + pos, rblob + roff[rr], rl); pos += rl;
        out[pos++] = '\t';
        pos += std::snprintf(out + pos, cap - pos,
                             "%f\t%u\t%u\t%u\t1\t%u\t%d\t%u\t%u\t%ld",
                             (double)(score[i] * 100.0f), al_len[i],
                             num_mis[i], num_gap[i], qlen[i], st_ix[i],
                             ed_ix[i], mism[i], (long)last[i]);
        if (tblob) {
            out[pos++] = '\t';
            std::memcpy(out + pos, tblob + toff[trow[i]], tl); pos += tl;
        }
        out[pos++] = '\n';
    }
    return pos;
}

}  // extern "C"

// ------------------------------------------------- accelerator build
// Two-pass clump-postings construction, the native analog of the
// reference's make_accelerator (burst.c:3304-3532): pass 1 counts
// postings per k-mer word, pass 2 fills clump ids at per-word offsets.
// Iterating clumps in ascending id keeps every word's posting list
// clump-ascending -- exactly the serialized .acx order -- without the
// O(total-windows) global sort the numpy path pays.
//
// Pure-ACGT clumps are recomputed from the packed letters both passes
// (cheap rolling-word sweep; no giant temporaries). Clumps with IUPAC
// letters take their pre-deduped, sorted word lists from the caller
// (mwords/moffs; ambiguity expansion stays in Python -- it is rare and
// branchy). A clump id appears once per distinct word (within-clump
// dedupe via sort+unique of a small per-clump scratch).

static void clump_uwords(
    const uint8_t* cat, const int64_t* uoffs, const int64_t* cu_offs,
    long c, int k, std::vector<int64_t>& scratch)
{
    scratch.clear();
    const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
    for (int64_t u = cu_offs[c]; u < cu_offs[c + 1]; ++u) {
        const uint8_t* s = cat + uoffs[u];
        long len = (long)(uoffs[u + 1] - uoffs[u]);
        int64_t w = 0;
        for (long t = 0; t < len; ++t) {
            w = ((w << 2) | (int64_t)(s[t] - 1)) & mask;
            if (t >= k - 1) scratch.push_back(w);
        }
    }
    std::sort(scratch.begin(), scratch.end());
    scratch.erase(std::unique(scratch.begin(), scratch.end()),
                  scratch.end());
}

extern "C" {

// Pass 1: counts[w] += 1 per (word, clump) incidence. counts is
// caller-zeroed uint32[4^k]. Returns total postings.
int64_t accel_count(
    const uint8_t* cat, const int64_t* uoffs, const int64_t* cu_offs,
    const int64_t* mwords, const int64_t* moffs,
    long tot_rc, int k, uint32_t* counts)
{
    int64_t total = 0;
    std::vector<int64_t> scratch;
    for (long c = 0; c < tot_rc; ++c) {
        if (moffs[c + 1] > moffs[c]) {
            for (int64_t i = moffs[c]; i < moffs[c + 1]; ++i)
                ++counts[mwords[i]];
            total += moffs[c + 1] - moffs[c];
        } else if (cu_offs[c + 1] > cu_offs[c]) {
            clump_uwords(cat, uoffs, cu_offs, c, k, scratch);
            for (int64_t w : scratch) ++counts[w];
            total += (int64_t)scratch.size();
        }
    }
    return total;
}

// Pass 2: ids[cur[w]++] = clump. cur is the exclusive per-word start
// offset array (int64[4^k], caller-initialized from the pass-1 counts
// cumsum); it is advanced in place.
// Zero-padded row matrix from concatenated ragged rows: one memcpy
// per row into out[i*wmax : i*wmax+len_i] (caller zeroes out).
void pad_rows(const uint8_t* cat, const int64_t* offs, long n,
              long wmax, uint8_t* out)
{
    for (long i = 0; i < n; ++i)
        std::memcpy(out + i * wmax, cat + offs[i],
                    (size_t)(offs[i + 1] - offs[i]));
}

void accel_fill(
    const uint8_t* cat, const int64_t* uoffs, const int64_t* cu_offs,
    const int64_t* mwords, const int64_t* moffs,
    long tot_rc, int k, int64_t* cur, uint32_t* ids)
{
    std::vector<int64_t> scratch;
    for (long c = 0; c < tot_rc; ++c) {
        if (moffs[c + 1] > moffs[c]) {
            for (int64_t i = moffs[c]; i < moffs[c + 1]; ++i)
                ids[cur[mwords[i]]++] = (uint32_t)c;
        } else if (cu_offs[c + 1] > cu_offs[c]) {
            clump_uwords(cat, uoffs, cu_offs, c, k, scratch);
            for (int64_t w : scratch) ids[cur[w]++] = (uint32_t)c;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------- host DP kernels
// CPU twins of the device kernels: what chip_smoke.py holds the CUDA
// kernels against (kernels/host.py). Bit-identical to kernels/myers.py
// and kernels/rescore.py.
//
// Both kernels have two cores: a scalar one (any compiler/ISA) and an
// AVX-512 one processing 16 pairs per vector -- the across-pair
// "inter-sequence" layout, the CPU analog of the Pallas kernels' pair
// batch dimension. The vector cores are bit-exact to the scalar ones
// (same integer recurrences lane-wise) and are fuzzed through the same
// tests; groups of 16 go vector, the remainder scalar.

static void myers_pair_scalar(
    const uint32_t* peq, const uint8_t* tile,
    long B, long b, long W, long Lp, int32_t* out)
{
    uint32_t VP[32], VN[32], Ph[32], Mh[32], Xv[32];
    for (long w = 0; w < W; ++w) { VP[w] = 0xFFFFFFFFu; VN[w] = 0; }
    int32_t score = (int32_t)(W * 32), best = score;
    int32_t first = 0, last = 0;
    for (long j = 0; j < Lp; ++j) {
        const uint32_t* eq = peq + (long)tile[j] * W;
        uint32_t carry = 0;
        for (long w = 0; w < W; ++w) {
            uint32_t Eq = eq[w];
            Xv[w] = Eq | VN[w];
            uint32_t a = Eq & VP[w];
            uint32_t s1 = a + VP[w];
            uint32_t c1 = s1 < a;
            uint32_t s2 = s1 + carry;
            uint32_t c2 = s2 < s1;
            uint32_t Xh = (s2 ^ VP[w]) | Eq;
            Ph[w] = VN[w] | ~(Xh | VP[w]);
            Mh[w] = VP[w] & Xh;
            carry = c1 | c2;
        }
        score += (int32_t)(Ph[W - 1] >> 31)
               - (int32_t)(Mh[W - 1] >> 31);
        if (score < best) first = (int32_t)(j + 1);
        if (score <= best) { best = score; last = (int32_t)(j + 1); }
        uint32_t pc = 0, mc = 0;
        for (long w = 0; w < W; ++w) {
            uint32_t phs = (Ph[w] << 1) | pc;
            uint32_t mhs = (Mh[w] << 1) | mc;
            pc = Ph[w] >> 31; mc = Mh[w] >> 31;
            VP[w] = mhs | ~(Xv[w] | phs);
            VN[w] = phs & Xv[w];
        }
    }
    out[b] = best;
    out[B + b] = first;
    out[2 * B + b] = last;
}

#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define BURST_HOST_AVX512 1

// 16 pairs at once; codes = [Lp][16] u32 pre-transposed tile columns,
// base[lane] = pidx*C*W element offsets into peq_all (caller checks
// the total peq element count fits int32 for the gathers).
static void myers_pairs_avx16(
    const uint32_t* peq_all, const uint32_t* codes,
    const int32_t* base, long B, long b0, long W, long Lp,
    int32_t* out)
{
    __m512i VP[32], VN[32];
    const __m512i ones = _mm512_set1_epi32(-1);
    for (long w = 0; w < W; ++w) {
        VP[w] = ones;
        VN[w] = _mm512_setzero_si512();
    }
    const __m512i vbase = _mm512_loadu_si512(base);
    const __m512i vW = _mm512_set1_epi32((int)W);
    const __m512i one = _mm512_set1_epi32(1);
    __m512i score = _mm512_set1_epi32((int)(W * 32));
    __m512i best = score;
    __m512i first = _mm512_setzero_si512();
    __m512i last = _mm512_setzero_si512();
    for (long j = 0; j < Lp; ++j) {
        __m512i code = _mm512_loadu_si512(codes + j * 16);
        __m512i eqix = _mm512_add_epi32(
            vbase, _mm512_mullo_epi32(code, vW));
        // single fused pass over words: the add-carry chain (Myers
        // horizontal deltas) and the shift-carry chain (VP/VN update)
        // both run ascending w, so Ph/Mh/Xv never need to be
        // materialized as arrays -- at W=10 (292bp reads) the
        // two-loop form spilled 30 zmm temporaries per column
        __mmask16 carry = 0;
        __m512i pc = _mm512_setzero_si512();
        __m512i mc = _mm512_setzero_si512();
        __m512i ph_top = _mm512_setzero_si512();
        __m512i mh_top = _mm512_setzero_si512();
        for (long w = 0; w < W; ++w) {
            __m512i Eq = _mm512_i32gather_epi32(
                _mm512_add_epi32(eqix, _mm512_set1_epi32((int)w)),
                (const int*)peq_all, 4);
            __m512i vp = VP[w], vn = VN[w];
            __m512i Xv = _mm512_or_si512(Eq, vn);
            __m512i a = _mm512_and_si512(Eq, vp);
            __m512i s1 = _mm512_add_epi32(a, vp);
            __mmask16 c1 = _mm512_cmplt_epu32_mask(s1, a);
            __m512i s2 = _mm512_mask_add_epi32(s1, carry, s1, one);
            __mmask16 c2 = _mm512_mask_cmplt_epu32_mask(carry, s2, s1);
            __m512i Xh = _mm512_or_si512(
                _mm512_xor_si512(s2, vp), Eq);
            __m512i Ph = _mm512_or_si512(vn, _mm512_andnot_si512(
                _mm512_or_si512(Xh, vp), ones));
            __m512i Mh = _mm512_and_si512(vp, Xh);
            carry = c1 | c2;
            __m512i phs = _mm512_or_si512(_mm512_slli_epi32(Ph, 1), pc);
            __m512i mhs = _mm512_or_si512(_mm512_slli_epi32(Mh, 1), mc);
            pc = _mm512_srli_epi32(Ph, 31);
            mc = _mm512_srli_epi32(Mh, 31);
            VP[w] = _mm512_or_si512(mhs, _mm512_andnot_si512(
                _mm512_or_si512(Xv, phs), ones));
            VN[w] = _mm512_and_si512(phs, Xv);
            if (w == W - 1) { ph_top = pc; mh_top = mc; }
        }
        score = _mm512_add_epi32(score, ph_top);
        score = _mm512_sub_epi32(score, mh_top);
        __m512i jj = _mm512_set1_epi32((int)(j + 1));
        __mmask16 strict = _mm512_cmplt_epi32_mask(score, best);
        __mmask16 upd = _mm512_cmple_epi32_mask(score, best);
        first = _mm512_mask_mov_epi32(first, strict, jj);
        last = _mm512_mask_mov_epi32(last, upd, jj);
        best = _mm512_mask_mov_epi32(best, upd, score);
    }
    alignas(64) int32_t tb[16], tf[16], tl[16];
    _mm512_store_si512(tb, best);
    _mm512_store_si512(tf, first);
    _mm512_store_si512(tl, last);
    for (int l = 0; l < 16; ++l) {
        out[b0 + l] = tb[l];
        out[B + b0 + l] = tf[l];
        out[2 * B + b0 + l] = tl[l];
    }
}
#endif  // AVX512

extern "C" {

// Phase A: bit-parallel Myers/Hyyro glocal scan over (query, tile)
// pairs -- myers.myers_min_ed_gather_pos semantics. peq_all is
// [NQ, C, W] uint32 (C codes: 16 nucleotide / 256 Xalpha), tiles_all
// [NT, Lp] uint8; out is packed [3, B] int32 (min ED, first best
// column, last best column; columns 1-based in padded coordinates).
// W <= 32 (queries <= 1024 rows; the engine's buckets guarantee it).
void myers_pairs(const uint32_t* peq_all, const uint8_t* tiles_all,
                 const int32_t* pidx, const int32_t* tidx,
                 long B, long C, long W, long Lp, int32_t* out,
                 long nq_total)
{
    if (W > 32) { for (long b = 0; b < 3 * B; ++b) out[b] = -1; return; }
#ifdef BURST_HOST_AVX512
    // int32 gather-offset envelope: every peq element offset
    // (nq_total*C*W) must fit in int32
    bool vec_ok = nq_total > 0 &&
        nq_total * C * W < (long)0x7FFFFF00;
    long Bv = vec_ok ? (B & ~15L) : 0;
#pragma omp parallel
    {
        std::vector<uint32_t> codes((size_t)Lp * 16);
        alignas(64) int32_t base[16];
#pragma omp for schedule(dynamic, 1)
        for (long g = 0; g < Bv / 16; ++g) {
            long b0 = g * 16;
            for (int l = 0; l < 16; ++l) {
                base[l] = (int32_t)((long)pidx[b0 + l] * C * W);
                const uint8_t* t =
                    tiles_all + (int64_t)tidx[b0 + l] * Lp;
                for (long j = 0; j < Lp; ++j)
                    codes[(size_t)j * 16 + l] = t[j];
            }
            myers_pairs_avx16(peq_all, codes.data(), base, B, b0,
                              W, Lp, out);
        }
    }
#else
    long Bv = 0;
#endif
#pragma omp parallel for schedule(dynamic, 64)
    for (long b = Bv; b < B; ++b)
        myers_pair_scalar(peq_all + (int64_t)pidx[b] * C * W,
                          tiles_all + (int64_t)tidx[b] * Lp,
                          B, b, W, Lp, out);
}

}  // extern "C"

// Phase B: tie-aware rescore DP over winner pairs -- the sequential
// form of kernels/rescore.py make_rescore (burst.c:713-886 dual-
// objective semantics). The device kernel's Hillis-Steele left-gap
// chain becomes a plain left-to-right running merge here: at each
// column the chain candidate (prev + (1,1,0)) competes with the
// diag/up base under (score asc, gapQ desc, origin-x desc) -- on full
// ties the base (larger origin) wins, matching the packed-key payload
// order. No width/row limits (the device fast path's 13-bit packing
// envelope does not apply).
// out: packed [4, B] int32 (ED<=255, gapQ, gapR, final_pos). With x0
// non-null the DP runs on the [Lw-1]-column window starting at x0[b]
// (clamped gather, as kernels/rescore._window_tiles); final_pos is
// window-local.

static void rescore_pair_scalar(
    const uint32_t* peq, const uint8_t* tile,
    long B, long b, long W, long L, long rows,
    int32_t qlen, int32_t bad, int32_t* out,
    int32_t* sc, int32_t* sh, int32_t* shr,
    int32_t* nsc, int32_t* nsh, int32_t* nshr)
{
    const int32_t DEADv = 511;
    // row 1, special-cased exactly like the reference: shiftQ
    // starts where a cost-1 cell follows a cost-0 left cell
    sc[0] = (1 >= bad) ? DEADv : 1;
    sh[0] = 0; shr[0] = 1;
    int32_t left_raw = 1;
    for (long x = 1; x <= L; ++x) {
        int c = tile[x - 1];
        int match = peq[(long)c * W] & 1u;
        int32_t d = match ? 0 : (c == 0 ? DEADv : 1);
        sh[x] = (d == 1 && left_raw == 0) ? 1 : 0;
        shr[x] = 0;
        left_raw = d;
        sc[x] = (d >= bad) ? DEADv : d;
    }
    for (int32_t y = 2; y <= (int32_t)rows; ++y) {
        const long yy = y - 1;
        const long w = yy >> 5;
        const uint32_t bit = 1u << (yy & 31);
        // chain state = running best origin (unclamped score)
        int32_t cs = y, cg = 0, cr = y;
        nsc[0] = y; nsh[0] = 0; nshr[0] = y;
        for (long x = 1; x <= L; ++x) {
            int c = tile[x - 1];
            int match = (peq[(long)c * W + w] & bit) != 0;
            int32_t d = match ? 0 : (c == 0 ? DEADv : 1);
            int32_t sO = sc[x - 1] + d;
            if (sO > DEADv + 1) sO = DEADv + 1;
            int32_t sU = sc[x] + 1;
            if (sU > DEADv + 1) sU = DEADv + 1;
            bool takeU = (sU < sO) ||
                         (sU == sO && sh[x] > sh[x - 1]);
            int32_t bs = takeU ? sU : sO;
            int32_t bg = takeU ? sh[x] : sh[x - 1];
            int32_t br = takeU ? shr[x] + 1 : shr[x - 1];
            int32_t cand_s = cs + 1, cand_g = cg + 1;
            if (cand_s < bs ||
                (cand_s == bs && cand_g > bg)) {
                cs = cand_s; cg = cand_g;   // cr carries over
            } else {
                cs = bs; cg = bg; cr = br;
            }
            nsc[x] = (cs >= bad) ? DEADv : cs;
            nsh[x] = cg;
            nshr[x] = cr;
        }
        std::swap(sc, nsc); std::swap(sh, nsh); std::swap(shr, nshr);
    }
    // final lane reduction over columns 1..L
    int32_t best_s = DEADv + 1;
    for (long x = 1; x <= L; ++x)
        if (sc[x] < best_s) best_s = sc[x];
    int32_t best_g = -1;
    for (long x = 1; x <= L; ++x)
        if (sc[x] == best_s && sh[x] > best_g) best_g = sh[x];
    int32_t first_col = 0, last_col = 0;
    for (long x = 1; x <= L; ++x)
        if (sc[x] == best_s && sh[x] == best_g) {
            if (!first_col) first_col = (int32_t)x;
            last_col = (int32_t)x;
        }
    out[b] = best_s < 255 ? best_s : 255;
    out[B + b] = best_g;
    out[2 * B + b] = shr[first_col];
    out[3 * B + b] = last_col - ((int32_t)rows - qlen);
}

#ifdef BURST_HOST_AVX512
// 16 pairs per call, lane-interleaved state ([L1][16] int32 planes).
// eqc = [W][L][16] pre-gathered Peq columns, padm = per-column pad
// masks, both built by the caller from the transposed codes. The
// integer recurrence is the scalar core lane-wise; bit-exact.
static void rescore_pairs_avx16(
    const uint32_t* eqc, const uint16_t* padm,
    const int32_t* qlens, const int32_t* max_ed,
    long B, long b0, long W, long L, long rows, int32_t* out,
    int32_t* st /* 6 * (L+1) * 16 scratch */)
{
    const long L1 = L + 1;
    const __m512i one = _mm512_set1_epi32(1);
    const __m512i vDEAD = _mm512_set1_epi32(511);
    const __m512i vDEAD1 = _mm512_set1_epi32(512);
    const __m512i vbad = _mm512_add_epi32(
        _mm512_loadu_si512(max_ed + b0), one);
    int32_t *sc = st, *sh = st + L1 * 16, *shr = st + 2 * L1 * 16;
    int32_t *nsc = st + 3 * L1 * 16, *nsh = st + 4 * L1 * 16,
            *nshr = st + 5 * L1 * 16;
    // row 1
    {
        __m512i v = _mm512_mask_mov_epi32(
            one, _mm512_cmple_epi32_mask(vbad, one), vDEAD);
        _mm512_storeu_si512(sc, v);
        _mm512_storeu_si512(sh, _mm512_setzero_si512());
        _mm512_storeu_si512(shr, one);
        __m512i left_raw = one;
        for (long x = 1; x <= L; ++x) {
            __m512i eqv = _mm512_loadu_si512(eqc + (x - 1) * 16);
            __mmask16 match = _mm512_test_epi32_mask(eqv, one);
            __m512i d = _mm512_mask_mov_epi32(one, padm[x - 1], vDEAD);
            d = _mm512_maskz_mov_epi32(~match, d);
            __mmask16 g1 = _mm512_cmpeq_epi32_mask(d, one) &
                _mm512_cmpeq_epi32_mask(left_raw,
                                        _mm512_setzero_si512());
            _mm512_storeu_si512(sh + x * 16,
                                _mm512_maskz_mov_epi32(g1, one));
            _mm512_storeu_si512(shr + x * 16, _mm512_setzero_si512());
            left_raw = d;
            __m512i v2 = _mm512_mask_mov_epi32(
                d, _mm512_cmple_epi32_mask(vbad, d), vDEAD);
            _mm512_storeu_si512(sc + x * 16, v2);
        }
    }
    for (int32_t y = 2; y <= (int32_t)rows; ++y) {
        const long yy = y - 1;
        const uint32_t* eqw = eqc + (yy >> 5) * L * 16;
        const __m512i bitv = _mm512_set1_epi32(1 << (yy & 31));
        const __m512i vy = _mm512_set1_epi32(y);
        __m512i cs = vy, cg = _mm512_setzero_si512(), cr = vy;
        _mm512_storeu_si512(nsc, vy);
        _mm512_storeu_si512(nsh, _mm512_setzero_si512());
        _mm512_storeu_si512(nshr, vy);
        // x-1 state starts at the previous row's boundary column
        __m512i sc_l = _mm512_loadu_si512(sc);
        __m512i sh_l = _mm512_loadu_si512(sh);
        __m512i shr_l = _mm512_loadu_si512(shr);
        for (long x = 1; x <= L; ++x) {
            __m512i eqv = _mm512_loadu_si512(eqw + (x - 1) * 16);
            __mmask16 match = _mm512_test_epi32_mask(eqv, bitv);
            __m512i d = _mm512_mask_mov_epi32(one, padm[x - 1], vDEAD);
            d = _mm512_maskz_mov_epi32(~match, d);
            __m512i sc_x = _mm512_loadu_si512(sc + x * 16);
            __m512i sh_x = _mm512_loadu_si512(sh + x * 16);
            __m512i shr_x = _mm512_loadu_si512(shr + x * 16);
            __m512i sO = _mm512_min_epi32(
                _mm512_add_epi32(sc_l, d), vDEAD1);
            __m512i sU = _mm512_min_epi32(
                _mm512_add_epi32(sc_x, one), vDEAD1);
            __mmask16 takeU = _mm512_cmplt_epi32_mask(sU, sO) |
                (_mm512_cmpeq_epi32_mask(sU, sO) &
                 _mm512_cmpgt_epi32_mask(sh_x, sh_l));
            __m512i bs = _mm512_mask_mov_epi32(sO, takeU, sU);
            __m512i bg = _mm512_mask_mov_epi32(sh_l, takeU, sh_x);
            __m512i br = _mm512_mask_mov_epi32(
                shr_l, takeU, _mm512_add_epi32(shr_x, one));
            __m512i cand_s = _mm512_add_epi32(cs, one);
            __m512i cand_g = _mm512_add_epi32(cg, one);
            __mmask16 takeC = _mm512_cmplt_epi32_mask(cand_s, bs) |
                (_mm512_cmpeq_epi32_mask(cand_s, bs) &
                 _mm512_cmpgt_epi32_mask(cand_g, bg));
            cs = _mm512_mask_mov_epi32(bs, takeC, cand_s);
            cg = _mm512_mask_mov_epi32(bg, takeC, cand_g);
            cr = _mm512_mask_mov_epi32(br, takeC, cr);
            __m512i store_s = _mm512_mask_mov_epi32(
                cs, _mm512_cmple_epi32_mask(vbad, cs), vDEAD);
            _mm512_storeu_si512(nsc + x * 16, store_s);
            _mm512_storeu_si512(nsh + x * 16, cg);
            _mm512_storeu_si512(nshr + x * 16, cr);
            sc_l = sc_x; sh_l = sh_x; shr_l = shr_x;
        }
        std::swap(sc, nsc); std::swap(sh, nsh); std::swap(shr, nshr);
    }
    // final lane reduction over columns 1..L (per lane, scalar)
    for (int l = 0; l < 16; ++l) {
        int32_t best_s = 512;
        for (long x = 1; x <= L; ++x)
            if (sc[x * 16 + l] < best_s) best_s = sc[x * 16 + l];
        int32_t best_g = -1;
        for (long x = 1; x <= L; ++x)
            if (sc[x * 16 + l] == best_s && sh[x * 16 + l] > best_g)
                best_g = sh[x * 16 + l];
        int32_t first_col = 0, last_col = 0;
        for (long x = 1; x <= L; ++x)
            if (sc[x * 16 + l] == best_s && sh[x * 16 + l] == best_g) {
                if (!first_col) first_col = (int32_t)x;
                last_col = (int32_t)x;
            }
        long b = b0 + l;
        out[b] = best_s < 255 ? best_s : 255;
        out[B + b] = best_g;
        out[2 * B + b] = shr[first_col * 16 + l];
        out[3 * B + b] = last_col - ((int32_t)rows - qlens[b]);
    }
}
#endif  // AVX512

extern "C" {

void rescore_pairs(const uint32_t* peq_all, const uint8_t* tiles_all,
                   const int32_t* pidx, const int32_t* tidx,
                   const int32_t* qlens, const int32_t* max_ed,
                   const int32_t* x0, long B, long C, long W,
                   long Lp_all, long Lw, long rows, int32_t* out,
                   long nq_total)
{
    const long L = x0 ? (Lw - 1) : Lp_all;
    const long L1 = L + 1;
#ifdef BURST_HOST_AVX512
    bool vec_ok = nq_total > 0 && W <= 32 &&
        nq_total * C * W < (long)0x7FFFFF00;
    long Bv = vec_ok ? (B & ~15L) : 0;
#pragma omp parallel
    {
        std::vector<uint32_t> codes((size_t)L * 16);
        std::vector<uint32_t> eqc((size_t)W * L * 16);
        std::vector<uint16_t> padm(L);
        std::vector<int32_t> st(6 * (size_t)L1 * 16);
#pragma omp for schedule(dynamic, 1)
        for (long g = 0; g < Bv / 16; ++g) {
            long b0 = g * 16;
            for (int l = 0; l < 16; ++l) {
                const uint8_t* t =
                    tiles_all + (int64_t)tidx[b0 + l] * Lp_all;
                if (x0) {
                    long base = x0[b0 + l];
                    for (long x = 0; x < L; ++x) {
                        long ix = base + x;
                        if (ix > Lp_all - 1) ix = Lp_all - 1;
                        codes[(size_t)x * 16 + l] = t[ix];
                    }
                } else {
                    for (long x = 0; x < L; ++x)
                        codes[(size_t)x * 16 + l] = t[x];
                }
            }
            for (long x = 0; x < L; ++x)
                padm[x] = _mm512_cmpeq_epi32_mask(
                    _mm512_loadu_si512(codes.data() + x * 16),
                    _mm512_setzero_si512());
            const __m512i vW = _mm512_set1_epi32((int)W);
            alignas(64) int32_t basev[16];
            for (int l = 0; l < 16; ++l)
                basev[l] = (int32_t)((long)pidx[b0 + l] * C * W);
            const __m512i vbase = _mm512_loadu_si512(basev);
            for (long x = 0; x < L; ++x) {
                __m512i eqix = _mm512_add_epi32(vbase,
                    _mm512_mullo_epi32(
                        _mm512_loadu_si512(codes.data() + x * 16), vW));
                for (long w = 0; w < W; ++w)
                    _mm512_storeu_si512(
                        eqc.data() + ((size_t)w * L + x) * 16,
                        _mm512_i32gather_epi32(
                            _mm512_add_epi32(eqix,
                                _mm512_set1_epi32((int)w)),
                            (const int*)peq_all, 4));
            }
            rescore_pairs_avx16(eqc.data(), padm.data(), qlens,
                                max_ed, B, b0, W, L, rows, out,
                                st.data());
        }
    }
#else
    long Bv = 0;
#endif
#pragma omp parallel
    {
        std::vector<int32_t> sc(L1), sh(L1), shr(L1);
        std::vector<int32_t> nsc(L1), nsh(L1), nshr(L1);
        std::vector<uint8_t> tl(x0 ? L : 0);
#pragma omp for schedule(dynamic, 16)
        for (long b = Bv; b < B; ++b) {
            const uint32_t* peq = peq_all + (int64_t)pidx[b] * C * W;
            const uint8_t* tile =
                tiles_all + (int64_t)tidx[b] * Lp_all;
            if (x0) {
                long base = x0[b];
                for (long x = 0; x < L; ++x) {
                    long ix = base + x;
                    if (ix > Lp_all - 1) ix = Lp_all - 1;
                    tl[x] = tile[ix];
                }
                tile = tl.data();
            }
            int32_t* scp = sc.data();
            int32_t* shp = sh.data();
            int32_t* shrp = shr.data();
            int32_t* nscp = nsc.data();
            int32_t* nshp = nsh.data();
            int32_t* nshrp = nshr.data();
            rescore_pair_scalar(peq, tile, B, b, W, L, rows,
                                qlens[b], max_ed[b] + 1, out,
                                scp, shp, shrp, nscp, nshp, nshrp);
        }
    }
}

}  // extern "C"

// ------------------------------------------------- EM swap descent
// One round of the -cr cluster-refinement swap descent
// (fingerprint.em_refine, re-expressing burst.c:2515-2602): for each
// paired pair of 16-row clusters, exhaustively try swapping each row
// of cluster 1 with each remaining row of cluster 2, accepting a swap
// iff it strictly lowers the summed union popcount. Pairs are
// disjoint, so processing order cannot change the result. P holds
// 32-byte fingerprints (16 rows per cluster); ix is the permutation
// swapped alongside; rows >= tot_r are zero padding and excluded.

static inline long pop32(const uint8_t* row) {
    uint64_t w;
    long s = 0;
    for (int t = 0; t < 4; ++t) {
        std::memcpy(&w, row + 8 * t, 8);
        s += __builtin_popcountll(w);
    }
    return s;
}

extern "C" {

void em_swap_pairs(uint8_t* P, const int64_t* pairs, long n_pairs,
                   int64_t* clus_pop, int64_t* ix, long tot_r)
{
    uint8_t ex1[32], ex2[32], un[32], tmp[32];
    for (long ip = 0; ip < n_pairs; ++ip) {
        const int64_t c1 = pairs[2 * ip], c2 = pairs[2 * ip + 1];
        const long c1o = (long)c1 << 4, c2o = (long)c2 << 4;
        const long r1 = std::min(tot_r, c1o + 16);
        const long r2 = std::min(tot_r, c2o + 16);
        for (long k = c1o; k < r1; ++k) {
            // ex1 = OR of cluster-1 rows except k
            std::memset(ex1, 0, 32);
            for (long t = c1o; t < c1o + 16; ++t) {
                if (t == k) continue;
                const uint8_t* rw = P + 32 * t;
                for (int b = 0; b < 32; ++b) ex1[b] |= rw[b];
            }
            long m = c2o;
            while (m < r2) {
                const int64_t cur = clus_pop[c1] + clus_pop[c2];
                long hit = -1;
                long n1 = 0, n2 = 0;
                for (long mi = m; mi < r2; ++mi) {
                    // new cluster-1 union: ex1 | row mi
                    const uint8_t* rm = P + 32 * mi;
                    for (int b = 0; b < 32; ++b)
                        un[b] = ex1[b] | rm[b];
                    long v1 = pop32(un);
                    // new cluster-2 union: OR of cluster-2 rows except
                    // mi, with row k in its place
                    std::memcpy(ex2, P + 32 * k, 32);
                    for (long t = c2o; t < c2o + 16; ++t) {
                        if (t == mi) continue;
                        const uint8_t* rw = P + 32 * t;
                        for (int b = 0; b < 32; ++b) ex2[b] |= rw[b];
                    }
                    long v2 = pop32(ex2);
                    if (v1 + v2 < cur) { hit = mi; n1 = v1; n2 = v2;
                                         break; }
                }
                if (hit < 0) break;
                std::memcpy(tmp, P + 32 * k, 32);
                std::memcpy(P + 32 * k, P + 32 * hit, 32);
                std::memcpy(P + 32 * hit, tmp, 32);
                clus_pop[c1] = n1;
                clus_pop[c2] = n2;
                const int64_t ti = ix[k];
                ix[k] = ix[hit];
                ix[hit] = ti;
                // ex1 changed only through row k's content? no: row k
                // itself is excluded from ex1, so ex1 is unchanged --
                // but recompute to mirror the vectorized reference
                // exactly (rows c1o..r1 outside k are untouched)
                std::memset(ex1, 0, 32);
                for (long t = c1o; t < c1o + 16; ++t) {
                    if (t == k) continue;
                    const uint8_t* rw = P + 32 * t;
                    for (int b = 0; b < 32; ++b) ex1[b] |= rw[b];
                }
                m = hit + 1;
            }
        }
    }
}

}  // extern "C"
