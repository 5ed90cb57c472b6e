// Honest CPU baseline: the reference's search worker loop, implemented in
// C++ and threaded exactly like the reference (static read chunks,
// src/hixf/search/do_parallel.hpp:19-36 called from
// src/main/taxor_search.cpp:325).  This is what `tools/bench.py` measures
// as `baseline_proxy` at 32 threads — a native-speed stand-in for the
// un-buildable reference binary (its seqan3/chopper deps are fetched from
// the network at build time).
//
// Per read (src/main/taxor_search.cpp:196-313):
//   1. open-canonical-syncmer scan (syncmer.cpp:80-155; shared scanner in
//      syncmer_scan.cpp) + dedup,
//   2. per-read threshold from a precomputed per-hash-count table (the
//      kmer/syncmer/percentage models depend on the count only),
//   3. HIXF membership: recursive bulk_contains_impl
//      (hierarchical_interleaved_xor_filter.hpp:304-340) — per-IXF
//      interleaved bulk_count (3 probes x contiguous bin row, XOR-compare),
//      split-run summation, descent into merged bins with sum >= threshold,
//   4. keep hits >= 0.8 * max count (taxor_search.cpp:285).
//
// The inner bulk_count loop is written the way the seqan3-fork kernel is
// shaped (one hash -> 3 contiguous fingerprint rows over all bins) so the
// compiler can vectorize it; built -O3 -march=native, i.e. at least as
// strong as the reference's -Ofast build.
//
// hixf_membership runs step 3 alone for the host oracle of the search
// (HIXF.membership): the same walk, its (user bin, count) pairs returned;
// hixf_walk the same walk, the IXFs it visits returned (HIXF.walk).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" long syncmer_scan(const uint8_t* codes, long n, int k, int s,
                             int t, uint64_t* out);

namespace {

inline uint64_t murmur64(uint64_t h) {
    h ^= h >> 33;
    h *= UINT64_C(0xff51afd7ed558ccd);
    h ^= h >> 33;
    h *= UINT64_C(0xc4ceb9fe1a85ec53);
    h ^= h >> 33;
    return h;
}

inline uint64_t rotl64(uint64_t n, unsigned c) {
    c &= 63;
    return (n << c) | (n >> ((-c) & 63));
}

inline uint32_t reduce32(uint32_t hash, uint32_t n) {
    return (uint32_t)(((uint64_t)hash * n) >> 32);
}

struct HixfView {
    const uint8_t* fp;          // concatenated fingerprint tables
    const int64_t* fp_off;      // [n_ixfs+1] offsets into fp (bytes)
    const int64_t* bins;        // [n_ixfs]
    const int64_t* block_len;   // [n_ixfs]
    const uint64_t* seeds;      // [n_ixfs]
    const int64_t* bin_off;     // [n_ixfs+1] offsets into user_of/next_ixf
    const int32_t* user_of;     // [sum bins] user bin id, -1 = merged
    const int32_t* next_ixf;    // [sum bins] child ixf id (valid iff merged)
    int n_ixfs;
};

struct Scratch {
    std::vector<uint64_t> hashes;
    std::vector<uint32_t> counts;
    std::vector<int32_t> pair_user;
    std::vector<int64_t> pair_count;
    bool record_visits = false;  // hixf_walk: keep each IXF entered
    std::vector<int32_t> visited;
};

// counting_agent::bulk_count over one interleaved IXF: per hash, XOR the
// three probed fingerprint rows against the key fingerprint across all
// bins at once (the interleaved layout makes each probe one contiguous
// row read).
void bulk_count(const HixfView& hx, int ixf, const uint64_t* hashes,
                long n_hashes, uint32_t* counts) {
    const int64_t b = hx.bins[ixf];
    const int64_t bl = hx.block_len[ixf];
    const uint64_t seed = hx.seeds[ixf];
    const uint8_t* fp = hx.fp + hx.fp_off[ixf];
    std::memset(counts, 0, sizeof(uint32_t) * (size_t)b);
    for (long i = 0; i < n_hashes; i++) {
        uint64_t mixed = murmur64(hashes[i] + seed);
        uint8_t f = (uint8_t)(mixed ^ (mixed >> 32));
        size_t h0 = reduce32((uint32_t)mixed, (uint32_t)bl);
        size_t h1 = reduce32((uint32_t)rotl64(mixed, 21), (uint32_t)bl) + bl;
        size_t h2 = reduce32((uint32_t)rotl64(mixed, 42), (uint32_t)bl) + 2 * bl;
        const uint8_t* r0 = fp + h0 * b;
        const uint8_t* r1 = fp + h1 * b;
        const uint8_t* r2 = fp + h2 * b;
        for (int64_t j = 0; j < b; j++) {
            counts[j] += (uint8_t)(r0[j] ^ r1[j] ^ r2[j] ^ f) == 0;
        }
    }
}

// bulk_contains_impl (hierarchical_interleaved_xor_filter.hpp:304-340)
void contains_impl(const HixfView& hx, int ixf, const uint64_t* hashes,
                   long n_hashes, int64_t threshold_lo, bool thr_impossible,
                   Scratch& sc, size_t counts_base) {
    if (sc.record_visits) sc.visited.push_back(ixf);
    const int64_t nb = hx.bins[ixf];
    // per-level slice of one big counts scratch (recursion-safe)
    if (sc.counts.size() < counts_base + (size_t)nb)
        sc.counts.resize(counts_base + (size_t)nb);
    uint32_t* counts = sc.counts.data() + counts_base;
    bulk_count(hx, ixf, hashes, n_hashes, counts);
    const int32_t* users = hx.user_of + hx.bin_off[ixf];
    const int32_t* next = hx.next_ixf + hx.bin_off[ixf];
    int64_t total = 0;
    for (int64_t b = 0; b < nb; b++) {
        total += counts[b];
        int32_t u = users[b];
        if (u < 0) {  // merged bin
            if (!thr_impossible && total >= threshold_lo) {
                contains_impl(hx, next[b], hashes, n_hashes, threshold_lo,
                              thr_impossible, sc, counts_base + (size_t)nb);
                // the child's resize may have moved the scratch
                counts = sc.counts.data() + counts_base;
            }
            total = 0;
        } else if (b + 1 == nb || users[b + 1] != u) {  // end of split run
            if (!thr_impossible && total >= threshold_lo) {
                sc.pair_user.push_back(u);
                sc.pair_count.push_back(total);
            }
            total = 0;
        }
    }
}

}  // namespace

extern "C" {

// The host oracle of one hash list (hixf/container.HIXF.membership): the
// (user bin, count) pairs of contains_impl in its emission order.  Writes
// at most cap pairs and returns how many there are; impossible: no count
// reaches the threshold (it is past int64).
long hixf_membership(const uint8_t* fp, const int64_t* fp_off, int n_ixfs,
                     const int64_t* bins, const int64_t* block_len,
                     const uint64_t* seeds, const int64_t* bin_off,
                     const int32_t* user_of, const int32_t* next_ixf,
                     const uint64_t* hashes, long n_hashes,
                     long long threshold, int impossible, int32_t* out_user,
                     int64_t* out_count, long cap) {
    HixfView hx{fp, fp_off, bins, block_len, seeds, bin_off,
                user_of, next_ixf, n_ixfs};
    Scratch sc;
    contains_impl(hx, 0, hashes, n_hashes, (int64_t)threshold,
                  impossible != 0, sc, 0);
    const long n = (long)sc.pair_user.size();
    for (long i = 0; i < n && i < cap; i++) {
        out_user[i] = sc.pair_user[(size_t)i];
        out_count[i] = sc.pair_count[(size_t)i];
    }
    return n;
}

// The IXFs the walk of one hash list visits (HIXF.walk), in the order it
// enters them: the root, then every child of a merged bin whose run sum
// reaches the threshold.  Writes at most cap ids and returns how many
// there are.
long hixf_walk(const uint8_t* fp, const int64_t* fp_off, int n_ixfs,
               const int64_t* bins, const int64_t* block_len,
               const uint64_t* seeds, const int64_t* bin_off,
               const int32_t* user_of, const int32_t* next_ixf,
               const uint64_t* hashes, long n_hashes, long long threshold,
               int impossible, int32_t* out_ixf, long cap) {
    HixfView hx{fp, fp_off, bins, block_len, seeds, bin_off,
                user_of, next_ixf, n_ixfs};
    Scratch sc;
    sc.record_visits = true;
    contains_impl(hx, 0, hashes, n_hashes, (int64_t)threshold,
                  impossible != 0, sc, 0);
    const long n = (long)sc.visited.size();
    for (long i = 0; i < n && i < cap; i++) out_ixf[i] = sc.visited[(size_t)i];
    return n;
}

// Returns 0 on success.  out_best_user[i] = -1 when read i has no hit.
// thr_table: uint64 per deduped hash count (0..thr_cap); values >= 2^63
// encode the size_t-wrapped "impossible" threshold.
int ref_baseline_search(
    const uint8_t* codes, const int64_t* read_off, long n_reads,
    int k, int s, int t,
    const uint8_t* fp, const int64_t* fp_off, int n_ixfs,
    const int64_t* bins, const int64_t* block_len, const uint64_t* seeds,
    const int64_t* bin_off, const int32_t* user_of, const int32_t* next_ixf,
    const uint64_t* thr_table, long thr_cap,
    int32_t* out_best_user, int32_t* out_best_count, int32_t* out_npass,
    int n_threads) {
    HixfView hx{fp, fp_off, bins, block_len, seeds, bin_off,
                user_of, next_ixf, n_ixfs};
    if (n_threads < 1) n_threads = 1;

    auto worker = [&](long start, long end) {
        Scratch sc;
        for (long r = start; r < end; r++) {
            const uint8_t* seq = codes + read_off[r];
            long len = read_off[r + 1] - read_off[r];
            sc.hashes.resize((size_t)std::max<long>(len, 1));
            long cnt = (len >= k)
                           ? syncmer_scan(seq, len, k, s, t, sc.hashes.data())
                           : 0;
            // dedup (the reference inserts into a hash set)
            std::sort(sc.hashes.begin(), sc.hashes.begin() + cnt);
            long n_uniq =
                std::unique(sc.hashes.begin(), sc.hashes.begin() + cnt) -
                sc.hashes.begin();
            long tc = n_uniq <= thr_cap ? n_uniq : thr_cap;
            uint64_t thr = thr_table[tc];
            bool impossible = thr >= (UINT64_C(1) << 63);
            sc.pair_user.clear();
            sc.pair_count.clear();
            if (n_uniq > 0)
                contains_impl(hx, 0, sc.hashes.data(), n_uniq,
                              (int64_t)thr, impossible, sc, 0);
            // keep hits >= 0.8 * max (taxor_search.cpp:285)
            int64_t best = 0;
            int32_t best_u = -1;
            for (size_t i = 0; i < sc.pair_user.size(); i++) {
                if (sc.pair_count[i] > best) {
                    best = sc.pair_count[i];
                    best_u = sc.pair_user[i];
                }
            }
            int32_t npass = 0;
            for (size_t i = 0; i < sc.pair_user.size(); i++)
                npass += (double)sc.pair_count[i] >= 0.8 * (double)best;
            out_best_user[r] = best_u;
            out_best_count[r] = (int32_t)best;
            out_npass[r] = npass;
        }
    };

    if (n_threads == 1) {
        worker(0, n_reads);
        return 0;
    }
    std::vector<std::thread> threads;
    long chunk = (n_reads + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; i++) {
        long lo = i * chunk;
        long hi = std::min<long>(n_reads, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
