// Copied from khoice_tpu/native/ms_engine.cpp.
// Matching-statistics / MEM-locate engine (C++, host side).
//
// Plays the role of the reference's external SPUMONI + r-index binaries
// (matching statistics per base, reference exp_type_5.smk:115-133; MEM
// locate with one best hit, exp_type_7.smk:244-256). FM/r-index queries are
// pointer-chasing and not TPU-shaped (SURVEY.md section 7.2), so this stays
// a native CPU component, exposed to Python over a C ABI via ctypes.
//
// Index: plain suffix array via prefix-doubling with radix sort
// (O(n log n)); queries: per-position longest-match via interval-narrowing
// binary search over the SA. Exact, deterministic.
//
// Build: g++ -O3 -shared -fPIC ms_engine.cpp -o libkhoice_ms.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {

struct Index {
    std::vector<uint8_t> text;   // with trailing 0 sentinel
    std::vector<int64_t> sa;     // suffix array over text
};

// Suffix array by prefix doubling with LSD radix sort on (rank, next-rank).
static void build_sa(const std::vector<uint8_t>& s, std::vector<int64_t>& sa) {
    const int64_t n = (int64_t)s.size();
    sa.resize(n);
    std::vector<int64_t> rank_(n), tmp(n), cnt;
    for (int64_t i = 0; i < n; i++) { sa[i] = i; rank_[i] = s[i]; }

    auto radix_pass = [&](const std::vector<int64_t>& key,
                          const std::vector<int64_t>& in,
                          std::vector<int64_t>& out, int64_t kmax) {
        cnt.assign(kmax + 2, 0);
        for (int64_t i = 0; i < n; i++) cnt[key[in[i]] + 1]++;
        for (int64_t i = 1; i <= kmax + 1; i++) cnt[i] += cnt[i - 1];
        for (int64_t i = 0; i < n; i++) out[cnt[key[in[i]]]++] = in[i];
    };

    std::vector<int64_t> key2(n), order(n);
    for (int64_t len = 1;; len <<= 1) {
        int64_t kmax = *std::max_element(rank_.begin(), rank_.end());
        // secondary key: rank of i+len (0 for past-the-end, ranks shifted +1)
        for (int64_t i = 0; i < n; i++)
            key2[i] = (i + len < n) ? rank_[i + len] + 1 : 0;
        radix_pass(key2, sa, order, kmax + 1);
        radix_pass(rank_, order, sa, kmax);
        // re-rank
        tmp[sa[0]] = 0;
        for (int64_t i = 1; i < n; i++) {
            const int64_t a = sa[i], b = sa[i - 1];
            const bool same = rank_[a] == rank_[b] && key2[a] == key2[b];
            tmp[a] = tmp[b] + (same ? 0 : 1);
        }
        rank_.swap(tmp);
        if (rank_[sa[n - 1]] == n - 1) break;
    }
}

// Longest common prefix length between query q[0..m) and text suffix at t,
// capped at m.
static inline int64_t match_len(const Index& ix, int64_t t,
                                const uint8_t* q, int64_t m) {
    const int64_t n = (int64_t)ix.text.size();
    int64_t l = 0;
    while (l < m && t + l < n && ix.text[t + l] == q[l]) l++;
    return l;
}

// For pattern q[0..m): length of the longest prefix occurring in text, and
// (optionally) one text position where the full m-length pattern occurs.
static int64_t longest_prefix(const Index& ix, const uint8_t* q, int64_t m,
                              int64_t* hit_pos) {
    const int64_t n = (int64_t)ix.sa.size();
    // Narrow the SA interval character by character.
    int64_t lo = 0, hi = n;  // current interval [lo, hi) matching q[0..l)
    int64_t l = 0;
    if (hit_pos) *hit_pos = -1;
    while (l < m) {
        const uint8_t c = q[l];
        // lower bound: first suffix with text[sa+l] >= c within [lo, hi)
        int64_t a = lo, b = hi;
        while (a < b) {
            int64_t mid = (a + b) >> 1;
            int64_t p = ix.sa[mid] + l;
            uint8_t tc = (p < (int64_t)ix.text.size()) ? ix.text[p] : 0;
            if (tc < c) a = mid + 1; else b = mid;
        }
        int64_t new_lo = a;
        // upper bound: first suffix with text[sa+l] > c
        b = hi;
        while (a < b) {
            int64_t mid = (a + b) >> 1;
            int64_t p = ix.sa[mid] + l;
            uint8_t tc = (p < (int64_t)ix.text.size()) ? ix.text[p] : 0;
            if (tc <= c) a = mid + 1; else b = mid;
        }
        int64_t new_hi = a;
        if (new_lo >= new_hi) break;
        lo = new_lo; hi = new_hi; l++;
    }
    if (l == m && hit_pos && lo < hi) *hit_pos = ix.sa[lo];
    return l;
}

// ---------------------------------------------------------------------------
// Batch matching statistics via a generalized suffix array (int32 alphabet).
//
// Per-position restart queries are O(ms_i * log n) EACH (the round-1 engine,
// VERDICT item 6); for SPUMONI's real workload (GB-scale fwd+rc text,
// 10k reads per run, exp_type_5.smk:115-133) that is hours.  Instead, ONE
// suffix array over  text ++ sep ++ read_0 ++ sep ++ read_1 ...  with a
// UNIQUE separator symbol per boundary (so no LCP can cross a boundary),
// plus a Kasai LCP pass and two linear sweeps, yields every MS value of
// every read in O((n + m) log (n + m)) total:
//   MS[i] = max( minLCP chain to nearest preceding text suffix in SA order,
//                minLCP chain to nearest following text suffix ).
// ---------------------------------------------------------------------------

static void build_sa32(const std::vector<int32_t>& s, std::vector<int32_t>& sa) {
    const int64_t n = (int64_t)s.size();
    sa.resize(n);
    std::vector<int32_t> rank_(n), tmp(n), key2(n), order(n);
    std::vector<int32_t> cnt;
    {
        // initial rank: compress symbol values (they can be sparse/large)
        std::vector<int64_t> idx(n);
        for (int64_t i = 0; i < n; i++) idx[i] = i;
        std::sort(idx.begin(), idx.end(),
                  [&](int64_t a, int64_t b) { return s[a] < s[b]; });
        int32_t r = 0;
        rank_[idx[0]] = 0;
        for (int64_t i = 1; i < n; i++) {
            if (s[idx[i]] != s[idx[i - 1]]) r++;
            rank_[idx[i]] = r;
        }
        for (int64_t i = 0; i < n; i++) sa[i] = (int32_t)i;
    }

    auto radix_pass = [&](const std::vector<int32_t>& key,
                          const std::vector<int32_t>& in,
                          std::vector<int32_t>& out, int64_t kmax) {
        cnt.assign(kmax + 2, 0);
        for (int64_t i = 0; i < n; i++) cnt[key[in[i]] + 1]++;
        for (int64_t i = 1; i <= kmax + 1; i++) cnt[i] += cnt[i - 1];
        for (int64_t i = 0; i < n; i++) out[cnt[key[in[i]]]++] = in[i];
    };

    for (int64_t len = 1;; len <<= 1) {
        int64_t kmax = *std::max_element(rank_.begin(), rank_.end());
        for (int64_t i = 0; i < n; i++)
            key2[i] = (i + len < n) ? rank_[i + len] + 1 : 0;
        radix_pass(key2, sa, order, kmax + 1);
        radix_pass(rank_, order, sa, kmax);
        tmp[sa[0]] = 0;
        for (int64_t i = 1; i < n; i++) {
            const int32_t a = sa[i], b = sa[i - 1];
            const bool same = rank_[a] == rank_[b] && key2[a] == key2[b];
            tmp[a] = tmp[b] + (same ? 0 : 1);
        }
        rank_.swap(tmp);
        if (rank_[sa[n - 1]] == (int32_t)(n - 1)) break;
    }
}

// Kasai LCP: lcp[r] = LCP(suffix SA[r-1], suffix SA[r]); lcp[0] = 0.
static void build_lcp32(const std::vector<int32_t>& s,
                        const std::vector<int32_t>& sa,
                        std::vector<int32_t>& lcp) {
    const int64_t n = (int64_t)s.size();
    std::vector<int32_t> rank_(n);
    for (int64_t r = 0; r < n; r++) rank_[sa[r]] = (int32_t)r;
    lcp.assign(n, 0);
    int64_t h = 0;
    for (int64_t i = 0; i < n; i++) {
        if (rank_[i] > 0) {
            int64_t j = sa[rank_[i] - 1];
            while (i + h < n && j + h < n && s[i + h] == s[j + h]) h++;
            lcp[rank_[i]] = (int32_t)h;
            if (h > 0) h--;
        } else {
            h = 0;
        }
    }
}

}  // namespace

extern "C" {

// Batch MS: text[0..n), reads concatenated in `reads` with boundaries
// offs[0..n_reads] (offs[0]=0, offs[n_reads]=total read bytes). Writes
// out_ms[j] for every read byte j in concatenated order:
//   out_ms[j] = longest prefix of that read suffix occurring in text
// (suffix taken WITHIN its read only — separators make this exact).
void ms_batch(const uint8_t* text, int64_t n,
              const uint8_t* reads, const int64_t* offs, int64_t n_reads,
              int32_t* out_ms) {
    const int64_t m = offs[n_reads];
    const int64_t INF = ((int64_t)1) << 60;
    // symbols: text bytes and read bytes as (byte + n_reads + 2) so every
    // separator value 1..n_reads+1 is unique and below all data symbols;
    // trailing global sentinel 0.
    const int32_t shift = (int32_t)(n_reads + 2);
    std::vector<int32_t> s;
    s.reserve(n + m + n_reads + 1);
    for (int64_t i = 0; i < n; i++) s.push_back((int32_t)text[i] + shift);
    std::vector<int64_t> read_start_pos(n_reads);
    for (int64_t r = 0; r < n_reads; r++) {
        s.push_back((int32_t)(r + 1));  // unique separator
        read_start_pos[r] = (int64_t)s.size();
        for (int64_t j = offs[r]; j < offs[r + 1]; j++)
            s.push_back((int32_t)reads[j] + shift);
    }
    s.push_back(0);  // global sentinel

    std::vector<int32_t> sa, lcp;
    build_sa32(s, sa);
    build_lcp32(s, sa, lcp);
    const int64_t N = (int64_t)s.size();

    // map S position -> output index (or -1 for text/separator positions)
    std::vector<int64_t> out_idx(N, -1);
    for (int64_t r = 0; r < n_reads; r++)
        for (int64_t j = offs[r]; j < offs[r + 1]; j++)
            out_idx[read_start_pos[r] + (j - offs[r])] = j;

    std::vector<int64_t> best(N, 0);
    // forward sweep: min-LCP chain from the nearest PRECEDING text suffix
    int64_t d = -1;
    for (int64_t r = 0; r < N; r++) {
        if (r > 0 && d >= 0) d = std::min(d, (int64_t)lcp[r]);
        if ((int64_t)sa[r] < n) d = INF;  // text suffix resets the chain
        else if (d >= 0 && out_idx[sa[r]] >= 0) best[r] = d;
    }
    // backward sweep: chain from the nearest FOLLOWING text suffix
    d = -1;
    for (int64_t r = N - 1; r >= 0; r--) {
        if (r + 1 < N && d >= 0) d = std::min(d, (int64_t)lcp[r + 1]);
        if ((int64_t)sa[r] < n) d = INF;
        else if (d >= 0 && out_idx[sa[r]] >= 0)
            best[r] = std::max(best[r], d);
    }
    for (int64_t r = 0; r < N; r++) {
        const int64_t oi = out_idx[sa[r]];
        if (oi >= 0) out_ms[oi] = (int32_t)std::min(best[r], (int64_t)0x7FFFFFFF);
    }
}

void* ms_build(const uint8_t* text, int64_t n) {
    Index* ix = new Index();
    ix->text.assign(text, text + n);
    ix->text.push_back(0);  // sentinel smaller than any symbol
    build_sa(ix->text, ix->sa);
    return ix;
}

void ms_free(void* h) { delete (Index*)h; }

// Matching statistics: out_ms[i] = longest prefix of q[i..m) found in text.
void ms_query(void* h, const uint8_t* q, int64_t m, int32_t* out_ms) {
    Index* ix = (Index*)h;
    for (int64_t i = 0; i < m; i++) {
        out_ms[i] = (int32_t)longest_prefix(*ix, q + i, m - i, nullptr);
    }
}

// First occurrence of the full pattern, or -1 (ri-align -m 1 role).
int64_t ms_locate(void* h, const uint8_t* q, int64_t m) {
    Index* ix = (Index*)h;
    int64_t pos = -1;
    int64_t l = longest_prefix(*ix, q, m, &pos);
    return (l == m) ? pos : -1;
}

int64_t ms_text_len(void* h) { return (int64_t)((Index*)h)->text.size() - 1; }

}  // extern "C"
