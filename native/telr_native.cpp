// telr_jax native host runtime: fast sequence IO + minimizer sketching.
//
// The device compute path is JAX + CUDA (wave_cuda.cu); this module is the
// C++ host-side data layer replacing the role of samtools/seqtk/Biopython parsing in the
// reference toolchain (reference TELR_input.py:329-361,
// TELR_assembly.py:418-431) and the index-build inner loop (minimizer
// extraction feeding kernels/index.py).
//
// Exposed as a plain C ABI consumed via ctypes (telr_jax/io/native.py);
// all buffers are caller-allocated numpy arrays.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtelr_native.so telr_native.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <cmath>
#include <thread>
#include <algorithm>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// sequence encoding
// ---------------------------------------------------------------------------

// ASCII -> code (A=0 C=1 G=2 T=3, other=4), case-insensitive
static int8_t LUT[256];
static bool lut_init = false;

static void init_lut() {
    if (lut_init) return;
    memset(LUT, 4, sizeof(LUT));
    LUT[(unsigned)'A'] = 0; LUT[(unsigned)'a'] = 0;
    LUT[(unsigned)'C'] = 1; LUT[(unsigned)'c'] = 1;
    LUT[(unsigned)'G'] = 2; LUT[(unsigned)'g'] = 2;
    LUT[(unsigned)'T'] = 3; LUT[(unsigned)'t'] = 3;
    lut_init = true;
}

void telr_encode(const char* seq, int64_t n, int8_t* out) {
    init_lut();
    for (int64_t i = 0; i < n; i++) out[i] = LUT[(unsigned char)seq[i]];
}

// ---------------------------------------------------------------------------
// fasta scanning: find record boundaries in a loaded buffer
// ---------------------------------------------------------------------------

// Scans a fasta buffer; writes per-record (header_start, header_end,
// seq_len) into offsets (3*max_records int64) and encodes all residues
// concatenated into codes (which must hold >= n bytes).  seq_starts gets
// the per-record offset into codes.  Returns the number of records, or -1
// if max_records is too small.
int64_t telr_scan_fasta(const char* buf, int64_t n,
                        int64_t* header_start, int64_t* header_end,
                        int64_t* seq_start, int64_t* seq_len,
                        int8_t* codes, int64_t max_records) {
    init_lut();
    int64_t nrec = 0;
    int64_t cpos = 0;
    int64_t i = 0;
    while (i < n) {
        if (buf[i] != '>') { i++; continue; }
        if (nrec >= max_records) return -1;
        int64_t hs = i + 1;
        while (i < n && buf[i] != '\n') i++;
        int64_t he = i;
        header_start[nrec] = hs;
        header_end[nrec] = he;
        seq_start[nrec] = cpos;
        i++;  // skip newline
        while (i < n && buf[i] != '>') {
            char c = buf[i];
            if (c != '\n' && c != '\r') codes[cpos++] = LUT[(unsigned char)c];
            i++;
        }
        seq_len[nrec] = cpos - seq_start[nrec];
        nrec++;
    }
    return nrec;
}

// ---------------------------------------------------------------------------
// minimizer sketching (canonical, invertible-hash, leftmost-tie window min)
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27; x *= 0x94D049BB133111EBULL;
    x ^= x >> 31;
    return x;
}

// Computes canonical minimizers of codes[0..n); writes positions, hashes,
// strands.  Returns count (<= n).  Semantics match
// telr_jax/kernels/minimizer.py: invalid (ambiguous or palindromic) k-mers
// are never selected; ties keep the leftmost; consecutive duplicate
// selections are collapsed.
int64_t telr_minimizers(const int8_t* codes, int64_t n, int32_t k, int32_t w,
                        int64_t* pos_out, uint64_t* hash_out,
                        int8_t* strand_out) {
    if (n < k) return 0;
    const int64_t m = n - k + 1;
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    std::vector<uint64_t> hcan(m);
    std::vector<int8_t> strand(m);
    const uint64_t INVALID = ~0ULL;

    uint64_t fwd = 0, rc = 0;
    int64_t bad_run = 0;  // positions since last ambiguous base
    for (int64_t i = 0; i < n; i++) {
        int8_t c = codes[i];
        if (c >= 4) {
            bad_run = 0;
            fwd = 0; rc = 0;
        } else {
            bad_run++;
            fwd = ((fwd << 2) | (uint64_t)c) & mask;
            rc = (rc >> 2) | (((uint64_t)(3 - c)) << (2 * (k - 1)));
        }
        int64_t p = i - k + 1;
        if (p < 0) continue;
        if (bad_run < k) { hcan[p] = INVALID; strand[p] = 0; continue; }
        uint64_t hf = splitmix64(fwd);
        uint64_t hr = splitmix64(rc);
        if (hf == hr) { hcan[p] = INVALID; strand[p] = 0; continue; }
        hcan[p] = hf < hr ? hf : hr;
        strand[p] = hr < hf ? 1 : 0;
    }

    // sliding window minimum (monotonic deque), leftmost tie
    std::vector<int64_t> deque(m);
    int64_t head = 0, tail = 0;
    int64_t count = 0;
    int64_t last_sel = -1;
    const int64_t nwin = (m >= w) ? (m - w + 1) : 1;
    const int64_t weff = (m >= w) ? w : m;
    for (int64_t i = 0; i < m; i++) {
        while (tail > head && hcan[deque[tail - 1]] > hcan[i]) tail--;
        deque[tail++] = i;
        int64_t wstart = i - weff + 1;
        if (deque[head] < wstart) head++;
        if (i >= weff - 1) {
            int64_t sel = deque[head];
            if (sel != last_sel && hcan[sel] != INVALID) {
                pos_out[count] = sel;
                hash_out[count] = hcan[sel];
                strand_out[count] = strand[sel];
                count++;
                last_sel = sel;
            }
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// wavefront schedule walk (see telr_jax/kernels/wavefront.py)
// ---------------------------------------------------------------------------

// Given the parity-free target band base per step (target_m, S+1 entries)
// and the sequences, emit drift bits and entering window codes.
// m0 (even, caller-chosen) is the base at s=0.  Returns 0.
int32_t telr_wave_schedule(const int8_t* q, int64_t lq,
                           const int8_t* t, int64_t lt,
                           const int64_t* target_m, int64_t S,
                           int64_t m0, int32_t width,
                           int8_t* drift_out, int8_t* qin_out,
                           int8_t* tin_out) {
    int64_t m_prev = m0;
    int64_t i0 = (0 - m0) / 2;
    int64_t j0 = (0 + m0) / 2;
    for (int64_t s = 1; s <= S; s++) {
        int64_t m;
        if (target_m[s] >= m_prev + 1) m = m_prev + 1;
        else if (target_m[s] <= m_prev - 1) m = m_prev - 1;
        else m = m_prev + ((target_m[s] - m_prev) >= 0 ? 1 : -1);
        int8_t d = (int8_t)(m - m_prev);
        drift_out[s - 1] = d;
        qin_out[s - 1] = 4;
        tin_out[s - 1] = 4;
        if (d == -1) {
            i0 += 1;
            int64_t idx = i0 - 1;
            if (idx >= 0 && idx < lq) qin_out[s - 1] = q[idx];
        } else {
            j0 += 1;
            int64_t idx = j0 - 1 + (width - 1);
            if (idx >= 0 && idx < lt) tin_out[s - 1] = t[idx];
        }
        m_prev = m;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// minimizer-index lookup (see telr_jax/kernels/index.py MinimizerIndex)
// ---------------------------------------------------------------------------

// Batched equal-range search over the sorted index hash array, accelerated
// by a caller-built prefix table: pref[b] = first position whose hash has
// top `pbits` bits >= b (pref has 2^pbits + 1 entries, pref[2^pbits] = n).
// splitmix64 output is uniform, so each bucket holds ~n/2^pbits entries and
// the binary search touches one hot cache region instead of log2(n) cold
// lines.  Writes lo_out[i], cnt_out[i] per query hash.
void telr_index_lookup(const uint64_t* hashes, int64_t n,
                       const int64_t* pref, int32_t pbits,
                       const uint64_t* qh, int64_t m,
                       int64_t* lo_out, int64_t* cnt_out) {
    const int shift = 64 - pbits;
    for (int64_t i = 0; i < m; i++) {
        const uint64_t h = qh[i];
        const uint64_t b = h >> shift;
        int64_t lo = pref[b], hi = pref[b + 1];
        // lower_bound
        while (lo < hi) {
            int64_t mid = lo + ((hi - lo) >> 1);
            if (hashes[mid] < h) lo = mid + 1; else hi = mid;
        }
        lo_out[i] = lo;
        // equal run (multiplicities are tiny except repeat hashes; scan,
        // falling back to galloping upper_bound for high-copy hashes)
        int64_t hi2 = lo;
        int64_t bucket_end = pref[b + 1];
        while (hi2 < bucket_end && hashes[hi2] == h) {
            hi2++;
            if (hi2 - lo >= 16) {  // gallop
                int64_t step = 16;
                while (hi2 + step < bucket_end && hashes[hi2 + step] == h) {
                    hi2 += step;
                    step <<= 1;
                }
                int64_t g_lo = hi2, g_hi = bucket_end;
                while (g_lo < g_hi) {
                    int64_t mid = g_lo + ((g_hi - g_lo) >> 1);
                    if (hashes[mid] == h) g_lo = mid + 1; else g_hi = mid;
                }
                hi2 = g_lo;
                break;
            }
        }
        cnt_out[i] = hi2 - lo;
    }
}

// ---------------------------------------------------------------------------
// anchor-chaining DP (see telr_jax/kernels/chain.py — same objective)
// ---------------------------------------------------------------------------

// Anchors must be pre-sorted by (tpos, qpos).  Writes per-anchor best
// score f and parent index (-1 = chain start).  O(n * lookback).
void telr_chain_dp(const int64_t* q, const int64_t* t, int64_t n,
                   int32_t k, int64_t max_gap, int64_t max_target_skew,
                   int32_t lookback, double gap_cap,
                   double* f, int64_t* parent) {
    for (int64_t i = 0; i < n; i++) {
        f[i] = (double)k;
        parent[i] = -1;
    }
    for (int64_t i = 1; i < n; i++) {
        int64_t j0 = i - lookback;
        if (j0 < 0) j0 = 0;
        double best = -1e300;
        int64_t best_j = -1;
        for (int64_t j = j0; j < i; j++) {
            int64_t dq = q[i] - q[j];
            int64_t dt = t[i] - t[j];
            if (dq < 1 || dt < 0 || dq > max_gap || dt > max_gap ||
                (dt - dq) > max_target_skew)
                continue;
            int64_t a = dq < dt ? dq : dt;
            if (a > k) a = k;
            int64_t dd = dq - dt;
            if (dd < 0) dd = -dd;
            double beta = 0.0;
            if (dd > 0) {
                beta = 0.01 * k * (double)dd +
                       0.5 * std::log2((double)dd + 1.0);
                if (beta > gap_cap) beta = gap_cap;
            }
            double cand = f[j] + (double)a - beta;
            if (cand > best) {
                best = cand;
                best_j = j;
            }
        }
        if (best_j >= 0 && best > f[i]) {
            f[i] = best;
            parent[i] = best_j;
        }
    }
}

// Greedy chain extraction from the chaining-DP output (the back half of
// kernels/chain.py chain_anchors): visit anchors by descending score,
// walk parent links until a used anchor, keep paths of >= min_anchors.
// Ties sort by ascending index (deterministic).  Writes the flat anchor
// index list (forward order per chain) + per-chain (start, len, score).
// Returns the number of chains (<= max_chains).
int64_t telr_chain_extract(const double* f, const int64_t* parent, int64_t n,
                           double min_score, int64_t min_anchors,
                           int64_t max_chains,
                           int64_t* idx_out, int64_t* chain_start,
                           int64_t* chain_len, double* chain_score) {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; i++) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (f[a] != f[b]) return f[a] > f[b];
        return a < b;
    });
    std::vector<uint8_t> used(n, 0);
    std::vector<int64_t> path;
    path.reserve(64);
    int64_t nchains = 0, w = 0;
    for (int64_t oi = 0; oi < n && nchains < max_chains; oi++) {
        int64_t i = order[oi];
        if (used[i] || f[i] < min_score) continue;
        path.clear();
        int64_t cur = i;
        while (cur != -1 && !used[cur]) {
            path.push_back(cur);
            cur = parent[cur];
        }
        if ((int64_t)path.size() < min_anchors) {
            for (int64_t p : path) used[p] = 1;
            continue;
        }
        chain_start[nchains] = w;
        chain_len[nchains] = (int64_t)path.size();
        chain_score[nchains] = f[i];
        for (int64_t k = (int64_t)path.size() - 1; k >= 0; k--) {
            used[path[k]] = 1;
            idx_out[w++] = path[k];
        }
        nchains++;
    }
    return nchains;
}

}  // extern "C" — POA uses C++ containers internally

// ---------------------------------------------------------------------------
// banded partial-order consensus (the wtpoa-cns role,
// reference TELR_assembly.py:225-247).
//
// The pileup vote (assembly/device_vote.py) converges to a ~94%-identity
// fixed point on deletion-heavy ONT noise: bases missing from the BACKBONE
// can only return through gated insertion events, and sub-threshold events
// stay lost forever.  A partial-order graph has no backbone bias — every
// read's variant becomes a node and the heaviest path is the consensus —
// which is exactly why the reference polishes with wtpoa-cns.
//
// abPOA-style banding: every node carries an approximate backbone column;
// a read (fit-aligned: read global, graph free at both ends) only visits
// nodes whose column is within W of its expected position.  Topological
// order is a doubly-linked list; new nodes insert right after their
// alignment predecessor, which preserves order validity.
// ---------------------------------------------------------------------------

namespace poa {

struct Edge { int32_t to; int32_t w; };

struct Graph {
    std::vector<int8_t> base;
    std::vector<int32_t> col;       // approximate backbone column (band key)
    std::vector<int32_t> nweight;   // read-path visits
    std::vector<std::vector<Edge>> preds;   // incoming edges
    std::vector<int32_t> nxt, prv;  // topo order linked list
    int32_t head = -1, tail = -1;

    int32_t add_node(int8_t b, int32_t c) {
        base.push_back(b);
        col.push_back(c);
        nweight.push_back(0);
        preds.push_back({});
        nxt.push_back(-1);
        prv.push_back(-1);
        return (int32_t)base.size() - 1;
    }
    void insert_after(int32_t v, int32_t after) {
        if (after < 0) {  // new head
            nxt[v] = head; prv[v] = -1;
            if (head >= 0) prv[head] = v;
            head = v;
            if (tail < 0) tail = v;
            return;
        }
        nxt[v] = nxt[after]; prv[v] = after;
        if (nxt[after] >= 0) prv[nxt[after]] = v;
        nxt[after] = v;
        if (after == tail) tail = v;
    }
    void bump_edge(int32_t u, int32_t v) {
        for (auto& e : preds[v])
            if (e.to == u) { e.w++; return; }
        preds[v].push_back({u, 1});
    }
};

static const int32_t NEG = -(1 << 28);

// Fit-align one read segment to the graph and weave it in.
// col0 = backbone column where the read segment starts.  alt_at maps
// (backbone column, base) -> existing mismatch-ALT node; ins_after maps
// (pred node, base) -> existing insertion node (POA merging).
static void poa_add_read(Graph& g, const int8_t* read, int64_t m,
                         int64_t col0, int64_t col1, int32_t W,
                         int32_t ma, int32_t mi,
                         int32_t go, int32_t ge,
                         std::unordered_map<int64_t, int32_t>& alt_at,
                         std::unordered_map<int64_t, int32_t>& ins_after) {
    const int32_t band = 2 * W + 1;
    const int32_t n = (int32_t)g.base.size();
    // expected read position of a node column: linear map of the read
    // segment onto its backbone span [col0, col1) — an indel-imbalanced
    // read drifts systematically off the slope-1 diagonal, and the band
    // must follow the drift, not the raw column
    const double scale = col1 > col0 ? (double)m / (double)(col1 - col0)
                                     : 1.0;
    // band row per node: j in [jlo(v), jlo(v)+band), clipped to [0, m]
    auto jlo = [&](int32_t v) -> int64_t {
        int64_t ctr = (int64_t)((g.col[v] - col0) * scale + 0.5);
        int64_t lo = ctr - W;
        if (lo > (int64_t)m + 1 - band) lo = (int64_t)m + 1 - band;
        if (lo < 0) lo = 0;
        return lo;
    };
    const int64_t rowsz = band;
    std::vector<int32_t> H((size_t)n * rowsz, NEG), D((size_t)n * rowsz, NEG);
    std::vector<int32_t> I((size_t)n * rowsz, NEG);
    // dirH: 0=start, 1=diag, 2=from-D, 3=from-I; dirD: 1=open, 2=extend;
    // dirI: 1=open, 2=extend
    std::vector<uint8_t> dirH((size_t)n * rowsz, 0),
        dirD((size_t)n * rowsz, 0), dirI((size_t)n * rowsz, 0);
    std::vector<uint8_t> predH((size_t)n * rowsz, 0),
        predD((size_t)n * rowsz, 0);
    auto idx = [&](int32_t v, int64_t j) -> int64_t {
        return (int64_t)v * rowsz + (j - jlo(v));
    };
    auto inband = [&](int32_t v, int64_t j) -> bool {
        int64_t lo = jlo(v);
        return j >= lo && j < lo + band && j <= m;
    };
    // nodes outside the read's column reach never participate
    auto active = [&](int32_t v) -> bool {
        return g.col[v] >= col0 - W - 1 && g.col[v] <= col1 + W + 1;
    };

    for (int32_t v = g.head; v >= 0; v = g.nxt[v]) {
        if (!active(v)) continue;
        int64_t lo = jlo(v);
        for (int64_t j = lo; j < lo + band && j <= m; j++) {
            int32_t bestH = NEG, bestD = NEG, bestI = NEG;
            uint8_t dH = 0, dD = 1, dI = 1, pH = 0, pD = 0;
            if (j == 0) { bestH = 0; dH = 0; }
            // D: skip node v (no read base) coming from a predecessor
            uint8_t pi = 0;
            for (auto& e : g.preds[v]) {
                int32_t u = e.to;
                if (active(u) && inband(u, j)) {
                    int64_t iu = idx(u, j);
                    int32_t open_ = H[iu] - go - ge;
                    int32_t ext_ = D[iu] - ge;
                    if (open_ > bestD) { bestD = open_; dD = 1; pD = pi; }
                    if (ext_ > bestD) { bestD = ext_; dD = 2; pD = pi; }
                }
                pi++;
            }
            if (bestD > bestH) { bestH = bestD; dH = 2; }
            if (j > 0) {
                // diag: consume read base j-1 at node v
                int8_t rb = read[j - 1];
                int32_t sc = (rb == g.base[v] && rb < 4) ? ma
                             : (rb >= 4 || g.base[v] >= 4) ? -1 : -mi;
                pi = 0;
                for (auto& e : g.preds[v]) {
                    int32_t u = e.to;
                    if (active(u) && inband(u, j - 1)) {
                        int32_t cand = H[idx(u, j - 1)] + sc;
                        if (cand > bestH) { bestH = cand; dH = 1; pH = pi; }
                    }
                    pi++;
                }
                // I: consume read base j-1 without a node (within row)
                if (j - 1 >= lo) {
                    int64_t ip = idx(v, j - 1);
                    int32_t open_ = H[ip] - go - ge;
                    int32_t ext_ = I[ip] - ge;
                    if (open_ >= ext_) { bestI = open_; dI = 1; }
                    else { bestI = ext_; dI = 2; }
                }
                if (bestI > bestH) { bestH = bestI; dH = 3; }
            }
            int64_t iv = idx(v, j);
            H[iv] = bestH; D[iv] = bestD; I[iv] = bestI;
            dirH[iv] = dH; dirD[iv] = dD; dirI[iv] = dI;
            predH[iv] = pH; predD[iv] = pD;
        }
    }

    // best end: H[v][m] over active nodes whose band contains m
    int32_t bv = -1; int32_t bs = NEG;
    for (int32_t v = 0; v < n; v++) {
        if (active(v) && inband(v, m) && H[idx(v, m)] > bs) {
            bs = H[idx(v, m)];
            bv = v;
        }
    }
    if (bv < 0 || bs <= 0) return;  // read could not be fit — skip it

    // traceback -> per-read-base steps (node id, or -1 for insertion)
    struct Step { int32_t node; int64_t j; };
    std::vector<Step> path;
    int32_t v = bv; int64_t j = m; int state = 0;  // 0=H 1=D 2=I
    while (j > 0 || state != 0) {
        int64_t iv = idx(v, j);
        if (state == 0) {
            uint8_t d = dirH[iv];
            if (d == 0) break;                    // free start
            if (d == 1) {
                path.push_back({v, j});
                v = g.preds[v][predH[iv]].to;
                j -= 1;
            } else if (d == 2) state = 1;
            else state = 2;
        } else if (state == 1) {
            uint8_t d = dirD[iv];
            int32_t u = g.preds[v][predD[iv]].to;
            if (d == 1) state = 0;
            v = u;
        } else {
            uint8_t d = dirI[iv];
            path.push_back({-1, j});
            j -= 1;
            if (d == 1) state = 0;
        }
    }

    // weave in forward order
    int32_t prev_node = -1;
    for (auto it = path.rbegin(); it != path.rend(); ++it) {
        int8_t rb = read[it->j - 1];
        int32_t cur = -1;
        if (it->node >= 0 && g.base[it->node] == rb) {
            cur = it->node;                       // match
        } else if (it->node >= 0) {
            // mismatch: merge with an existing ALT node at this column
            int64_t key = ((int64_t)g.col[it->node] << 3) | rb;
            auto f = alt_at.find(key);
            if (f != alt_at.end()) cur = f->second;
            else {
                cur = g.add_node(rb, g.col[it->node]);
                g.insert_after(cur, g.prv[it->node] >= 0
                                        ? g.prv[it->node] : -1);
                alt_at.emplace(key, cur);
            }
        } else {
            // insertion: merge with an existing ins node after prev
            int64_t key = ((int64_t)(prev_node + 1) << 3) | rb | (1LL << 62);
            auto f = ins_after.find(key);
            if (f != ins_after.end()) cur = f->second;
            else {
                int32_t c = prev_node >= 0 ? g.col[prev_node]
                                           : (int32_t)col0;
                cur = g.add_node(rb, c);
                g.insert_after(cur, prev_node >= 0 ? prev_node : -1);
                ins_after.emplace(key, cur);
            }
        }
        g.nweight[cur] += 1;
        if (prev_node >= 0 && prev_node != cur) g.bump_edge(prev_node, cur);
        prev_node = cur;
    }
}

// consensus: heaviest path under MAJORITY-RELATIVE edge scoring, then trim
// tips whose node weight < min_cov.  A raw edge-weight sum lets a k-node
// insertion detour (w reads, k+1 edges) outscore the direct edge once
// (k+1)*w exceeds it — sub-majority read noise then bloats the consensus
// (measured: 109 inserted bases / 6kb at 15x ONT).  Scoring each edge as
// 2*w - local_coverage makes an edge profitable only with majority
// support, so detours must OUT-VOTE the direct edge per transition.
static int64_t poa_consensus_path(Graph& g, int32_t bb_len,
                                  int32_t min_cov,
                                  int8_t* out, int64_t cap) {
    int32_t n = (int32_t)g.base.size();
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> from(n, -1);
    int32_t best = -1; int64_t bs = -1;
    for (int32_t v = g.head; v >= 0; v = g.nxt[v]) {
        for (auto& e : g.preds[v]) {
            int32_t u = e.to;
            int32_t cov = g.nweight[u] > g.nweight[v] ? g.nweight[u]
                                                      : g.nweight[v];
            int64_t cand = score[u] + 2 * (int64_t)e.w - cov;
            // ties (ubiquitous where local coverage is 1-2: every
            // single-read variant scores 2w-cov = 0, same as the
            // incumbent) resolve toward the BACKBONE chain — the
            // incumbent consensus already carries the pileup vote's
            // all-reads evidence — then toward the heavier node
            bool take = false;
            if (cand > score[v]) take = true;
            else if (cand == score[v]) {
                if (from[v] < 0) take = true;   // extend beats fresh start
                else {
                    bool u_bb = (u == v - 1 && v < bb_len);
                    bool f_bb = (from[v] == v - 1 && v < bb_len);
                    if (u_bb && !f_bb) take = true;
                    else if (u_bb == f_bb
                             && g.nweight[u] > g.nweight[from[v]])
                        take = true;
                }
            }
            if (take) { score[v] = cand; from[v] = u; }
        }
        if (score[v] > bs) { bs = score[v]; best = v; }
    }
    std::vector<int32_t> path;
    // iteration cap: merged alt nodes can in pathological cases create a
    // backward edge (see poa_add_read) — never walk longer than n
    for (int32_t v = best; v >= 0 && (int64_t)path.size() <= n;
         v = from[v])
        path.push_back(v);
    // forward order
    int64_t lo = 0, hi = (int64_t)path.size();
    // trim tips below min_cov
    while (hi > lo && g.nweight[path[(size_t)(hi - 1)]] < min_cov) hi--;
    while (lo < hi && g.nweight[path[(size_t)lo]] < min_cov) lo++;
    int64_t k = 0;
    for (int64_t i = hi - 1; i >= lo && k < cap; i--)
        out[k++] = g.base[path[(size_t)i]];
    return k;
}

}  // namespace poa

extern "C" {

// Banded partial-order consensus of read segments against a backbone.
// reads_flat/read_off: concatenated oriented read segments; read_col0[i] =
// backbone column where segment i starts.  Returns consensus length
// written to cons_out (<= cons_cap), or -1 on failure.
int64_t telr_poa_consensus(const int8_t* backbone, int64_t bb_len,
                           const int8_t* reads_flat,
                           const int64_t* read_off,
                           const int64_t* read_col0,
                           const int64_t* read_col1, int64_t n_reads,
                           int32_t W, int32_t ma, int32_t mi, int32_t go,
                           int32_t ge, int32_t min_cov,
                           int8_t* cons_out, int64_t cons_cap) {
    poa::Graph g;
    int32_t prev = -1;
    for (int64_t i = 0; i < bb_len; i++) {
        int32_t v = g.add_node(backbone[i], (int32_t)i);
        g.insert_after(v, prev);
        if (prev >= 0) g.bump_edge(prev, v);
        // backbone edges start at weight 1 from bump; reset to 0 so the
        // consensus is carried by READ support, not the backbone itself
        if (prev >= 0) g.preds[v][0].w = 0;
        prev = v;
    }
    std::unordered_map<int64_t, int32_t> alt_at, ins_after;
    for (int64_t r = 0; r < n_reads; r++) {
        const int8_t* seg = reads_flat + read_off[r];
        int64_t m = read_off[r + 1] - read_off[r];
        if (m <= 0) continue;
        poa::poa_add_read(g, seg, m, read_col0[r], read_col1[r], W,
                          ma, mi, go, ge, alt_at, ins_after);
    }
    return poa::poa_consensus_path(g, (int32_t)bb_len, min_cov,
                                   cons_out, cons_cap);
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// banded affine-gap DP (see telr_jax/kernels/dp.py _banded_dp_single)
// ---------------------------------------------------------------------------
//
// Bit-exact C++ replica of the XLA-scan banded DP — the host fallback
// engine playing the role minimap2's SIMD ksw2 kernel plays in the
// reference toolchain (reference TELR_alignment.py:31-82).  The device
// compute path is the CUDA wavefront kernel (native/wave_cuda.cu); this
// serves CPU runs (tests, CPU-only users) and small dispatches where a
// device launch costs more than the DP.

static inline int32_t imax32(int32_t a, int32_t b) { return a > b ? a : b; }

}  // extern "C" (templates need C++ linkage)

// The hot row passes live in their own functions.  GCC 12's
// if-converter refuses these loops in most surrounding contexts
// ("relevant phi not supported" — the outcome flips with unrelated
// code motion), so on AVX-512 hosts the passes are written directly in
// intrinsics (W is always a multiple of 16 by the caller's bucketing);
// the scalar templates remain as the portable fallback.

#ifdef __AVX512F__
#include <immintrin.h>

static void dp_pass1_avx512(const int32_t* hprev, const int32_t* iprev,
                            const int32_t* trow, int32_t* i_cur,
                            int32_t* iext, int32_t* dg, int32_t* hnod,
                            int32_t W, int32_t qi, int32_t go, int32_t ge,
                            int32_t ma, int32_t mi, int32_t amb, bool loc) {
    const int32_t NEG = -(1 << 30);
    const int32_t NEGH = NEG / 2;
    const __m512i vNEG = _mm512_set1_epi32(NEG);
    const __m512i vNEGH = _mm512_set1_epi32(NEGH);
    const __m512i voge = _mm512_set1_epi32(go + ge);
    const __m512i vge = _mm512_set1_epi32(ge);
    const __m512i vqi = _mm512_set1_epi32(qi);
    const __m512i vma = _mm512_set1_epi32(ma);
    const __m512i vmi = _mm512_set1_epi32(-mi);
    const __m512i vamb = _mm512_set1_epi32(amb);
    const __m512i v3 = _mm512_set1_epi32(3);
    const __m512i vone = _mm512_set1_epi32(1);
    const __m512i vzero = _mm512_setzero_si512();
    const bool q_amb = (qi == 4);
    for (int32_t p = 0; p < W; p += 16) {
        __m512i h_up = _mm512_loadu_si512(hprev + p + 1);
        __mmask16 m1 = _mm512_cmpgt_epi32_mask(h_up, vNEGH);
        __m512i i_open = _mm512_mask_sub_epi32(vNEG, m1, h_up, voge);
        __m512i i_up = _mm512_loadu_si512(iprev + p + 1);
        __mmask16 m2 = _mm512_cmpgt_epi32_mask(i_up, vNEGH);
        __m512i i_ext = _mm512_mask_sub_epi32(vNEG, m2, i_up, vge);
        __m512i ic = _mm512_max_epi32(i_open, i_ext);
        _mm512_storeu_si512(i_cur + p, ic);
        __mmask16 ne = _mm512_cmpneq_epi32_mask(ic, i_open);
        __mmask16 gt = _mm512_cmpgt_epi32_mask(ic, vNEGH);
        _mm512_storeu_si512(iext + p,
                            _mm512_maskz_mov_epi32((__mmask16)(ne & gt),
                                                   vone));
        __m512i tc = _mm512_loadu_si512(trow + p);
        __mmask16 meq = _mm512_cmpeq_epi32_mask(tc, vqi);
        __m512i s = _mm512_mask_mov_epi32(vmi, meq, vma);
        __mmask16 mamb = _mm512_cmpgt_epi32_mask(tc, v3);
        s = q_amb ? vamb : _mm512_mask_mov_epi32(s, mamb, vamb);
        __m512i h_diag = _mm512_loadu_si512(hprev + p);
        __mmask16 m3 = _mm512_cmpgt_epi32_mask(h_diag, vNEGH);
        __m512i d = _mm512_mask_add_epi32(vNEG, m3, h_diag, s);
        _mm512_storeu_si512(dg + p, d);
        __m512i hn = _mm512_max_epi32(d, ic);
        if (loc) hn = _mm512_max_epi32(hn, vzero);
        _mm512_storeu_si512(hnod + p, hn);
    }
}

static void dp_pass2_avx512(const int32_t* mx, const int32_t* hnod,
                            const int32_t* dg, const int32_t* iext,
                            int32_t* dbyte, int32_t* hrow, int32_t W,
                            int32_t p_lo, int32_t p_hi, int32_t go,
                            int32_t ge, bool loc) {
    const int32_t NEG = -(1 << 30);
    const int32_t NEGH = NEG / 2;
    const __m512i vNEG = _mm512_set1_epi32(NEG);
    const __m512i vNEGH = _mm512_set1_epi32(NEGH);
    const __m512i vge = _mm512_set1_epi32(ge);
    const __m512i voge = _mm512_set1_epi32(go + ge);
    const __m512i vthr = _mm512_set1_epi32(NEGH + go + ge);
    const __m512i vlo = _mm512_set1_epi32(p_lo);
    const __m512i vhi = _mm512_set1_epi32(p_hi);
    const __m512i vone = _mm512_set1_epi32(1);
    const __m512i vtwo = _mm512_set1_epi32(2);
    const __m512i vthree = _mm512_set1_epi32(3);
    const __m512i vfour = _mm512_set1_epi32(4);
    const __m512i vzero = _mm512_setzero_si512();
    __m512i vp = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7,
                                   8, 9, 10, 11, 12, 13, 14, 15);
    const __m512i v16 = _mm512_set1_epi32(16);
    for (int32_t p = 0; p < W; p += 16, vp = _mm512_add_epi32(vp, v16)) {
        __m512i m_ex = _mm512_loadu_si512(mx + p);
        // gep = ge * (p - 1) per lane
        __m512i gep = _mm512_mullo_epi32(
            _mm512_sub_epi32(vp, vone), vge);
        __mmask16 mgt = _mm512_cmpgt_epi32_mask(m_ex, vNEGH);
        __m512i dc = _mm512_mask_sub_epi32(vNEG, mgt, m_ex, gep);
        __mmask16 in_t = _mm512_cmpge_epi32_mask(vp, vlo)
                         & _mm512_cmple_epi32_mask(vp, vhi);
        dc = _mm512_mask_mov_epi32(vNEG, in_t, dc);
        __m512i prev_hnod = _mm512_loadu_si512(hnod + p - 1);
        __mmask16 mo = _mm512_cmpgt_epi32_mask(prev_hnod, vthr);
        __m512i open_cand = _mm512_mask_sub_epi32(vNEG, mo, prev_hnod,
                                                  voge);
        __mmask16 dext = _mm512_cmpneq_epi32_mask(dc, open_cand)
                         & _mm512_cmpgt_epi32_mask(dc, vNEGH);
        __m512i hn = _mm512_loadu_si512(hnod + p);
        __m512i hc = _mm512_max_epi32(hn, dc);
        __mmask16 eq0 = _mm512_cmpeq_epi32_mask(hc, _mm512_loadu_si512(
            dg + p));
        __mmask16 eqd = _mm512_cmpeq_epi32_mask(hc, dc);
        __m512i choice = _mm512_mask_mov_epi32(vtwo, eqd, vone);
        choice = _mm512_maskz_mov_epi32((__mmask16)~eq0, choice);
        if (loc) {
            __mmask16 z = _mm512_cmpeq_epi32_mask(hc, vzero);
            choice = _mm512_mask_mov_epi32(choice, z, vthree);
        }
        __m512i byte = _mm512_or_si512(
            choice,
            _mm512_or_si512(
                _mm512_maskz_mov_epi32(dext, vfour),
                _mm512_slli_epi32(_mm512_loadu_si512(iext + p), 3)));
        _mm512_storeu_si512(dbyte + p, byte);
        _mm512_storeu_si512(hrow + p, hc);
    }
}
#endif  // __AVX512F__

template <bool LOC>
__attribute__((noinline))
static void dp_pass1(const int32_t* __restrict__ hprev,
                     const int32_t* __restrict__ iprev,
                     const int32_t* __restrict__ trow,
                     int32_t* __restrict__ i_cur,
                     int32_t* __restrict__ iext,
                     int32_t* __restrict__ dg,
                     int32_t* __restrict__ hnod,
                     int32_t W, int32_t qi,
                     int32_t go, int32_t ge, int32_t ma, int32_t mi,
                     int32_t amb) {
    const int32_t NEG = -(1 << 30);
    const int32_t NEGH = NEG / 2;
    const int32_t q_amb = (qi == 4) ? -1 : 0;
    for (int32_t p = 0; p < W; p++) {
        int32_t h_up = hprev[p + 1];
        int32_t i_open = (h_up > NEGH) ? h_up - go - ge : NEG;
        int32_t i_up = iprev[p + 1];
        int32_t i_ext = (i_up > NEGH) ? i_up - ge : NEG;
        int32_t ic = i_open > i_ext ? i_open : i_ext;
        i_cur[p] = ic;
        // two single-compare ternaries &'d together: the direct
        // (a != b) & (c > d) bool expression defeats if-conversion
        int32_t ine = (ic == i_open) ? 0 : 1;
        int32_t igt = (ic > NEGH) ? 1 : 0;
        iext[p] = ine & igt;
        int32_t tc = trow[p];
        int32_t s = (tc == qi) ? ma : -mi;
        s = (q_amb | (tc >= 4)) ? amb : s;
        int32_t h_diag = hprev[p];
        int32_t d = (h_diag > NEGH) ? h_diag + s : NEG;
        dg[p] = d;
        int32_t hn = d > ic ? d : ic;
        if (LOC) hn = hn < 0 ? 0 : hn;
        hnod[p] = hn;
    }
}

template <bool LOC>
__attribute__((noinline))
static void dp_pass2(const int32_t* __restrict__ mx,
                     const int32_t* __restrict__ hnod,
                     const int32_t* __restrict__ dg,
                     const int32_t* __restrict__ iext,
                     int32_t* __restrict__ dbyte,
                     int32_t* __restrict__ hrow,
                     int32_t W, int32_t p_lo, int32_t p_hi,
                     int32_t go, int32_t ge) {
    const int32_t NEG = -(1 << 30);
    const int32_t NEGH = NEG / 2;
    for (int32_t p = 0; p < W; p++) {
        int32_t m_ex = mx[p];
        int32_t dc = (m_ex > NEGH) ? m_ex - ge * (p - 1) : NEG;
        bool in_t = (p >= p_lo) & (p <= p_hi);
        dc = in_t ? dc : NEG;
        int32_t prev_hnod = hnod[p - 1];   // [-1] slot holds NEG
        // open_cand mirrors h_nod[p-1]-go-ge with -inf at p==0; the
        // sentinel guard keeps the subtraction from drifting the
        // -inf the XLA version materializes exactly
        int32_t open_cand = (prev_hnod > NEGH + go + ge)
                                ? prev_hnod - go - ge : NEG;
        int32_t dne = (dc == open_cand) ? 0 : 1;
        int32_t dgt = (dc > NEGH) ? 1 : 0;
        int32_t dext = dne & dgt;
        int32_t hn = hnod[p];
        int32_t hc = hn > dc ? hn : dc;
        int32_t choice = (hc == dg[p]) ? 0 : ((hc == dc) ? 1 : 2);
        if (LOC) choice = (hc == 0) ? 3 : choice;
        dbyte[p] = choice | (dext << 2) | (iext[p] << 3);
        hrow[p] = hc;
    }
}

template <int MODE>
static void banded_dp_one_t(const int8_t* q, int32_t lq_pad,
                          const int8_t* t, int32_t lt_pad,
                          const int32_t* off, int32_t qlen, int32_t tlen,
                          int32_t W,
                          int32_t ma, int32_t mi, int32_t go, int32_t ge,
                          int32_t amb, uint8_t* dirs, int32_t* out5) {
    const int32_t NEG = -(1 << 30);
    const int32_t NEGH = NEG / 2;
    constexpr int32_t GLOBAL_M = 0, LOCAL_M = 2;
    constexpr int32_t mode = MODE;
    // padded carries: hp/ip[1..W] hold the previous row, NEG elsewhere,
    // so the shifted reads hp[d_i+p] / hp[d_i+p+1] are branchless
    // (d_i in [0, W] -> indexes in [0, 2W+1])
    std::vector<int32_t> hp(2 * W + 2, NEG), ip(2 * W + 2, NEG);
    std::vector<int32_t> i_cur(W), dg(W), hrow(W), iext(W);
    // hnodv[-1] slot = NEG so the p-1 read needs no guard (a guarded
    // load defeats if-conversion and the whole pass stays scalar)
    std::vector<int32_t> hnodv(W + 1, NEG);
    int32_t* hnod = hnodv.data() + 1;
    std::vector<int32_t> gbuf(W), mx(W), dbyte(W);
    // padded target MATCH SCORES per code (sc[c] for this row's query
    // base is recomputed each row; tb holds the code widened to int32 so
    // the hot loop stays single-width and auto-vectorizes)
    std::vector<int32_t> tb((int64_t)tlen + W + 2, 5);
    int32_t treal = tlen < lt_pad ? tlen : lt_pad;
    for (int32_t x = 0; x < treal; x++) tb[x + 1] = t[x];

    // row 0 init
    for (int32_t p = 0; p < W; p++) {
        int64_t j0 = (int64_t)off[0] + p;
        int32_t v;
        if (mode == LOCAL_M) v = 0;
        else v = (j0 == 0) ? 0 : (int32_t)(-(go + (int64_t)ge * j0));
        hp[p + 1] = (j0 <= tlen) ? v : NEG;
    }

    int32_t best = (mode == GLOBAL_M) ? NEG : 0;
    int32_t besti = 0, bestp = 0;
    int32_t rows = lq_pad < qlen ? lq_pad : qlen;
    constexpr bool local = (mode == LOCAL_M);

    for (int32_t i = 1; i <= rows; i++) {
        int32_t qi = q[i - 1];
        int32_t off_i = off[i];
        int32_t d_i = off[i] - off[i - 1];
        uint8_t* drow = dirs + (int64_t)(i - 1) * W;
        const int32_t* hprev = hp.data() + d_i;   // hprev[p+1] = up, [p] = diag
        const int32_t* iprev = ip.data() + d_i;
        const int32_t* trow = tb.data() + off_i;  // trow[p] = code at j=off_i+p

        // in-range band positions: j in [1, tlen] <=> p in [p_lo, p_hi]
        int32_t p_lo = off_i >= 1 ? 0 : 1 - off_i;
        int64_t ph = (int64_t)tlen - off_i;
        int32_t p_hi = ph >= W ? W - 1 : (ph < -1 ? -1 : (int32_t)ph);

        constexpr bool loc = local;
#ifdef __AVX512F__
        dp_pass1_avx512(hprev, iprev, trow, i_cur.data(), iext.data(),
                        dg.data(), hnod, W, qi, go, ge, ma, mi, amb,
                        local);
#else
        dp_pass1<local>(hprev, iprev, trow, i_cur.data(), iext.data(),
                        dg.data(), hnod, W, qi, go, ge, ma, mi, amb);
#endif
        // out-of-range / j==0 fixes (at most two short tails + one cell)
        for (int32_t p = 0; p < p_lo && p < W; p++) hnod[p] = NEG;
        for (int32_t p = p_hi + 1; p < W; p++) if (p >= 0) hnod[p] = NEG;
        if (off_i == 0) {
            int32_t ic = i_cur[0];
            hnod[0] = local ? imax32(ic, 0) : ic;
        }

        // horizontal affine.  Only the prefix max over g carries a loop
        // dependency; everything else is an independent vector pass, so
        // the serial loop is kept to 2 ops/cell.
        // g[p] = hnod[p] + ge*p - go - ge (NEG-guarded)  [vector]
#pragma GCC ivdep
        for (int32_t p = 0; p < W; p++) {
            int32_t hn = hnod[p];
            gbuf[p] = (hn > NEGH) ? hn + ge * p - go - ge : NEG;
        }
        // m_excl[p] = max over g[p'] for p' < p                [serial]
        {
            int32_t m_run = NEG;
            for (int32_t p = 0; p < W; p++) {
                mx[p] = m_run;
                m_run = m_run > gbuf[p] ? m_run : gbuf[p];
            }
        }
        // dc / dext / hc / choice / dirs                       [vector]
        const bool has_zero = (off_i == 0);
#ifdef __AVX512F__
        dp_pass2_avx512(mx.data(), hnod, dg.data(), iext.data(),
                        dbyte.data(), hrow.data(), W, p_lo, p_hi,
                        go, ge, local);
#else
        dp_pass2<local>(mx.data(), hnod, dg.data(), iext.data(),
                        dbyte.data(), hrow.data(), W, p_lo, p_hi, go, ge);
#endif
        if (has_zero) {
            // the j==0 cell: vertical-only, choice I, no D
            int32_t hc = hnod[0];
            dbyte[0] = 2 | (iext[0] << 3);
            if (loc && hc == 0) dbyte[0] = 3 | (iext[0] << 3);
            hrow[0] = hc;
        }
        for (int32_t p = 0; p < W; p++) drow[p] = (uint8_t)dbyte[p];
        // row best (first max wins), only over in-band cells: a plain
        // max reduction vectorizes; the first-index lookup is a short
        // early-exit scan afterwards
        {
            int32_t rb = NEG;
            int32_t pa = has_zero ? 0 : p_lo;
            for (int32_t p = pa; p <= p_hi; p++)
                rb = hrow[p] > rb ? hrow[p] : rb;
            if (rb > best) {
                int32_t rbp = pa;
                while (rbp <= p_hi && hrow[rbp] != rb) rbp++;
                best = rb; besti = i; bestp = rbp;
            }
        }
        // publish this row as the padded previous-row carries
        memcpy(hp.data() + 1, hrow.data(), (size_t)W * sizeof(int32_t));
        memcpy(ip.data() + 1, i_cur.data(), (size_t)W * sizeof(int32_t));
    }

    int64_t p_end = (int64_t)tlen - off[lq_pad];
    out5[0] = (p_end >= 0 && p_end < W) ? hp[(int32_t)p_end + 1] : NEG;
    out5[1] = best;
    out5[2] = besti;
    out5[3] = bestp;
}

// Host-side traceback walk (see telr_jax/kernels/dp.py traceback):
// follows direction bytes from (si, sj) back to the alignment start,
// emitting run-length-encoded ops (0=M, 1=D, 2=I) in REVERSE order
// (caller reverses).  Returns the number of runs, or -1 if the walk
// leaves the band.  end cell is written to ij_out[0..1].
// ij_out[0..1] = path start cell; ij_out[2] = minimum distance of the walk
// from a CONSTRAINING band edge (0 = the path touched the outermost band
// cell where the band actually clips the matrix — callers retry at a wider
// band).  An edge is constraining only where matrix cells lie beyond it:
// the left edge when off[i] > 0, the right when off[i] + W <= lt.
extern "C" int64_t telr_traceback(const uint8_t* dirs, int32_t W,
                       const int32_t* off, int32_t si, int32_t sj,
                       int32_t mode, int32_t lt, uint8_t* ops_out,
                       int32_t* lens_out, int64_t max_ops,
                       int32_t* ij_out) {
    const int32_t LOCAL_M = 2;
    int64_t n = 0;
    int32_t i = si, j = sj;
    int32_t state = 0;  // 0=H 1=D 2=I
    int32_t margin = W;
    auto push = [&](uint8_t op) -> bool {
        if (n > 0 && ops_out[n - 1] == op) { lens_out[n - 1]++; return true; }
        if (n >= max_ops) return false;
        ops_out[n] = op; lens_out[n] = 1; n++;
        return true;
    };
    while (i > 0 || j > 0) {
        if (i == 0) {
            if (!push(1)) return -1;   // leading D run along row 0
            j--;
            continue;
        }
        int32_t p = j - off[i];
        if (p < 0 || p >= W) return -1;
        if (off[i] > 0 && p < margin) margin = p;
        if (off[i] + W <= lt && (W - 1 - p) < margin) margin = W - 1 - p;
        uint8_t byte = dirs[(int64_t)(i - 1) * W + p];
        uint8_t choice = byte & 3;
        if (state == 0) {
            if (mode == LOCAL_M && choice == 3) break;
            if (j == 0 || choice == 2) { state = 2; continue; }
            if (choice == 0) {
                if (!push(0)) return -1;
                i--; j--;
                continue;
            }
            if (choice == 1) { state = 1; continue; }
            return -1;  // STOP outside LOCAL
        } else if (state == 1) {
            if (!push(1)) return -1;
            j--;
            if (!(byte & 4)) state = 0;
        } else {
            if (!push(2)) return -1;
            i--;
            if (!(byte & 8)) state = 0;
        }
    }
    ij_out[0] = i; ij_out[1] = j; ij_out[2] = margin;
    return n;
}

// matches along a cigar path (PAF residue matches; plain equality, the
// same semantics as kernels/dp.py count_matches)
extern "C" int64_t telr_count_matches(const int8_t* q, int64_t lq,
                           const int8_t* t, int64_t lt,
                           const uint8_t* ops, const int32_t* lens,
                           int64_t n, int64_t qstart, int64_t tstart) {
    int64_t qi = qstart, tj = tstart, m = 0;
    for (int64_t k = 0; k < n; k++) {
        int32_t ln = lens[k];
        if (ops[k] == 0) {
            for (int32_t x = 0; x < ln; x++) {
                if (qi + x < lq && tj + x < lt && q[qi + x] == t[tj + x]) m++;
            }
            qi += ln; tj += ln;
        } else if (ops[k] == 2) {
            qi += ln;
        } else {
            tj += ln;
        }
    }
    return m;
}

static void banded_dp_one(const int8_t* q, int32_t lq_pad,
                          const int8_t* t, int32_t lt_pad,
                          const int32_t* off, int32_t qlen, int32_t tlen,
                          int32_t W, int32_t mode,
                          int32_t ma, int32_t mi, int32_t go, int32_t ge,
                          int32_t amb, uint8_t* dirs, int32_t* out5) {
    if (mode == 0)
        banded_dp_one_t<0>(q, lq_pad, t, lt_pad, off, qlen, tlen, W,
                           ma, mi, go, ge, amb, dirs, out5);
    else if (mode == 1)
        banded_dp_one_t<1>(q, lq_pad, t, lt_pad, off, qlen, tlen, W,
                           ma, mi, go, ge, amb, dirs, out5);
    else
        banded_dp_one_t<2>(q, lq_pad, t, lt_pad, off, qlen, tlen, W,
                           ma, mi, go, ge, amb, dirs, out5);
}

extern "C" {

void telr_banded_dp_batch(const int8_t* q, const int8_t* t,
                          const int32_t* off, const int32_t* qlen,
                          const int32_t* tlen, int32_t B, int32_t lq_pad,
                          int32_t lt_pad, int32_t W, int32_t mode,
                          int32_t ma, int32_t mi, int32_t go, int32_t ge,
                          int32_t amb, uint8_t* dirs, int32_t* out /*B*4*/) {
    auto run_range = [&](int32_t b0, int32_t b1) {
        for (int32_t b = b0; b < b1; b++) {
            banded_dp_one(q + (int64_t)b * lq_pad, lq_pad,
                          t + (int64_t)b * lt_pad, lt_pad,
                          off + (int64_t)b * (lq_pad + 1), qlen[b], tlen[b],
                          W, mode, ma, mi, go, ge, amb,
                          dirs + (int64_t)b * lq_pad * W,
                          out + (int64_t)b * 4);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int32_t nthr = (int32_t)(hw ? hw : 1);
    // under a multiprocess read fan-out every worker runs its own DP
    // batches; TELR_DP_THREADS=1 avoids oversubscription
    const char* env = getenv("TELR_DP_THREADS");
    if (env && atoi(env) > 0 && atoi(env) < nthr) nthr = atoi(env);
    if (nthr > B) nthr = B;
    if (nthr <= 1 || B < 2) { run_range(0, B); return; }
    std::vector<std::thread> pool;
    int32_t per = (B + nthr - 1) / nthr;
    for (int32_t k = 0; k < nthr; k++) {
        int32_t b0 = k * per, b1 = b0 + per < B ? b0 + per : B;
        if (b0 >= b1) break;
        pool.emplace_back(run_range, b0, b1);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched wavefront op-code decode (see wave_align.py _decode_chunk):
// unpack the device's 4-codes-per-byte packed op stream, strip the no-op
// code 3, reverse into alignment order, run-length-encode, and prepend the
// boundary lead I(fi)/D(fj) runs — all per pair, threaded over the batch;
// a linear byte scan is memory-bound.  Two-pass API: count run totals, then fill concatenated
// (ops, lens) arrays at caller-computed offsets — Python slices per-pair
// views out of the concatenation with zero copies.
//
// packed_t layout: (n, s4) row-major, as the device emits it, so each
// pair's byte stream is linear here.  Code k of pair j = bits 2*(k&3) of
// packed_t[j*s4 + (k>>2)], k ascending = walk order (alignment order is
// k DESCENDING).  op codes: 0=M, 1=D, 2=I, 3=no-op.

namespace {

// walk pair j's packed column in descending k, emitting runs
template <typename EMIT>
static inline void wave_walk_pair(const uint8_t* packed_t, int64_t s4,
                                  int64_t j, EMIT&& emit) {
    const uint8_t* row = packed_t + j * s4;
    int cur = -1;
    int32_t run = 0;
    for (int64_t r = s4 - 1; r >= 0; r--) {
        uint8_t byte = row[r];
        if (byte == 0xFF) continue;              // four no-ops
        for (int k = 3; k >= 0; k--) {
            int code = (byte >> (2 * k)) & 3;
            if (code == 3) continue;
            if (code == cur) { run++; continue; }
            if (run) emit(cur, run);
            cur = code; run = 1;
        }
    }
    if (run) emit(cur, run);
}

struct WaveLead { int ops[2]; int32_t lens[2]; int n; };

static inline WaveLead wave_lead(int32_t fi, int32_t fj, int32_t lead) {
    WaveLead L; L.n = 0;
    if (lead) {
        if (fi > 0) { L.ops[L.n] = 2; L.lens[L.n] = fi; L.n++; }  // I
        if (fj > 0) { L.ops[L.n] = 1; L.lens[L.n] = fj; L.n++; }  // D
    }
    return L;
}

static void wave_decode_range(const uint8_t* packed, int64_t s4, int64_t n,
                              const int32_t* fi, const int32_t* fj,
                              const int32_t* bad, int32_t lead,
                              const int64_t* offsets, int32_t* nruns,
                              uint8_t* ops_out, int32_t* lens_out,
                              int64_t j0, int64_t j1) {
    for (int64_t j = j0; j < j1; j++) {
        if (bad[j]) { if (nruns) nruns[j] = 0; continue; }
        WaveLead L = wave_lead(fi[j], fj[j], lead);
        if (nruns) {                     // count pass
            int32_t cnt = 0;
            bool first = true; int first_op = -1;
            wave_walk_pair(packed, s4, j, [&](int op, int32_t) {
                if (first) { first_op = op; first = false; }
                cnt++;
            });
            cnt += L.n;
            if (L.n && !first && L.ops[L.n - 1] == first_op) cnt--;
            nruns[j] = cnt;
            continue;
        }
        // fill pass
        int64_t at = offsets[j];
        for (int k = 0; k < L.n; k++) {
            ops_out[at] = (uint8_t)L.ops[k]; lens_out[at] = L.lens[k]; at++;
        }
        bool first = true;
        wave_walk_pair(packed, s4, j, [&](int op, int32_t run) {
            if (first && L.n && L.ops[L.n - 1] == op) {
                lens_out[at - 1] += run;   // merge lead boundary
            } else {
                ops_out[at] = (uint8_t)op; lens_out[at] = run; at++;
            }
            first = false;
        });
    }
}

static void wave_decode_threaded(const uint8_t* packed, int64_t s4,
                                 int64_t n, const int32_t* fi,
                                 const int32_t* fj, const int32_t* bad,
                                 int32_t lead, const int64_t* offsets,
                                 int32_t* nruns, uint8_t* ops_out,
                                 int32_t* lens_out) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthr = (int64_t)(hw ? hw : 1);
    const char* env = getenv("TELR_DP_THREADS");
    if (env && atoi(env) > 0 && atoi(env) < nthr) nthr = atoi(env);
    if (nthr > n) nthr = n;
    if (nthr <= 1) {
        wave_decode_range(packed, s4, n, fi, fj, bad, lead, offsets,
                          nruns, ops_out, lens_out, 0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t per = (n + nthr - 1) / nthr;
    for (int64_t k = 0; k < nthr; k++) {
        int64_t j0 = k * per, j1 = j0 + per < n ? j0 + per : n;
        if (j0 >= j1) break;
        pool.emplace_back(wave_decode_range, packed, s4, n, fi, fj, bad,
                          lead, offsets, nruns, ops_out, lens_out, j0, j1);
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void telr_wave_decode_count(const uint8_t* packed, int64_t s4, int64_t n,
                            const int32_t* fi, const int32_t* fj,
                            const int32_t* bad, int32_t lead,
                            int32_t* nruns) {
    wave_decode_threaded(packed, s4, n, fi, fj, bad, lead, nullptr,
                         nruns, nullptr, nullptr);
}

void telr_wave_decode_fill(const uint8_t* packed, int64_t s4, int64_t n,
                           const int32_t* fi, const int32_t* fj,
                           const int32_t* bad, int32_t lead,
                           const int64_t* offsets, uint8_t* ops_out,
                           int32_t* lens_out) {
    wave_decode_threaded(packed, s4, n, fi, fj, bad, lead, offsets,
                         nullptr, ops_out, lens_out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched wavefront batch preparation (see wave_align.py
// prepare_wavefront_batch): the parity walk + wire packing (meta bytes,
// initial q/t windows, scalar row) for one pair, as a single GIL-free
// call, threaded over pairs.

namespace {

static void wave_prepare_one(const int8_t* q, int64_t lq,
                             const int8_t* t, int64_t lt,
                             const int64_t* target_m, int64_t m0,
                             int64_t W, int64_t S_pad,
                             int8_t* meta_row, int8_t* qw_row,
                             int8_t* tw_row, int32_t* scal4) {
    const int64_t S = lq + lt;
    const int8_t PAD = (int8_t)(1 | (4 << 1) | (4 << 4));
    int64_t m_prev = m0;
    int64_t i0 = (0 - m0) / 2;
    int64_t j0 = (0 + m0) / 2;
    const int64_t i0_start = i0, j0_start = j0;
    for (int64_t s = 1; s <= S; s++) {
        int64_t m;
        if (target_m[s] >= m_prev + 1) m = m_prev + 1;
        else if (target_m[s] <= m_prev - 1) m = m_prev - 1;
        else m = m_prev + ((target_m[s] - m_prev) >= 0 ? 1 : -1);
        int8_t d = (int8_t)(m - m_prev);
        int qi = 4, ti = 4;
        if (d == -1) {
            i0 += 1;
            int64_t idx = i0 - 1;
            if (idx >= 0 && idx < lq) qi = q[idx] & 7;
        } else {
            j0 += 1;
            int64_t idx = j0 - 1 + (W - 1);
            if (idx >= 0 && idx < lt) ti = t[idx] & 7;
        }
        meta_row[s - 1] = (int8_t)((d > 0 ? 1 : 0) | (qi << 1) | (ti << 4));
        m_prev = m;
    }
    for (int64_t s = S; s < S_pad; s++) meta_row[s] = PAD;
    for (int64_t p = 0; p < W; p++) {
        int64_t qidx = i0_start - 1 - p;
        qw_row[p] = (qidx >= 0 && qidx < lq) ? q[qidx] : (int8_t)4;
        int64_t tidx = j0_start - 1 + p;
        tw_row[p] = (tidx >= 0 && tidx < lt) ? t[tidx] : (int8_t)4;
    }
    scal4[0] = (int32_t)lq;
    scal4[1] = (int32_t)lt;
    scal4[2] = (int32_t)i0_start;
    scal4[3] = (int32_t)j0_start;
}

}  // namespace

extern "C" void telr_wave_prepare_batch(
    const int64_t* q_ptrs, const int64_t* q_lens,
    const int64_t* t_ptrs, const int64_t* t_lens,
    const int64_t* tm_ptrs, const int64_t* m0s,
    int64_t n_pairs, int64_t W, int64_t S_pad,
    int8_t* meta /* rows: idx*S_pad */,
    int8_t* qw /* rows: idx*W */,
    int8_t* tw /* rows: idx*W */,
    int32_t* scal /* rows: idx*4 */) {
    auto run_range = [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++) {
            wave_prepare_one(
                (const int8_t*)q_ptrs[i], q_lens[i],
                (const int8_t*)t_ptrs[i], t_lens[i],
                (const int64_t*)tm_ptrs[i], m0s[i], W, S_pad,
                meta + i * S_pad, qw + i * W, tw + i * W, scal + i * 4);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthr = (int64_t)(hw ? hw : 1);
    const char* env = getenv("TELR_DP_THREADS");
    if (env && atoi(env) > 0 && atoi(env) < nthr) nthr = atoi(env);
    if (nthr > n_pairs) nthr = n_pairs;
    if (nthr <= 1) { run_range(0, n_pairs); return; }
    std::vector<std::thread> pool;
    int64_t per = (n_pairs + nthr - 1) / nthr;
    for (int64_t k = 0; k < nthr; k++) {
        int64_t a = k * per, b = a + per < n_pairs ? a + per : n_pairs;
        if (a >= b) break;
        pool.emplace_back(run_range, a, b);
    }
    for (auto& th : pool) th.join();
}
