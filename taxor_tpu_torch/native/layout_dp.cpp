// Hierarchical-binning layout DP — native core (VERDICT r4 item 3).
//
// The reference consumes chopper's hierarchical_binning DP
// (src/main/taxor_build.cpp:197-228); our semantically
// equivalent DP lives in hixf/binning.py.  At tens of thousands of user
// bins the Python/numpy inner loops dominated the whole build, so the
// three O(n*W*m)/O(tmax*n*W) kernels move
// here, next to the other native host loops (xor_peel.cpp etc):
//
//   hll_union_band  — ubT[j][d] = HLL union estimate of user bins
//                     (j-d .. j), monotonized along d (a superset union
//                     can never shrink; estimator dips are noise).  The
//                     monotone band is what makes the DP merge walk's
//                     early exit EXACT.  Computed once per layout and
//                     shared by every tmax candidate and every
//                     recursion level (children are contiguous slices
//                     of the parent order, so their band is a row slice
//                     of the parent's).
//   layout_dp       — the split/merge DP + backtrack (binning._dp_layout
//                     semantics, same transition order and tie-breaks).
//   rearrange_chain — greedy HLL-Jaccard nearest-neighbor chaining
//                     (binning.rearrange_bins semantics).
//
// All estimates use the same double-precision HLL formula as
// hixf/hll.py (alpha*m^2 / sum(2^-reg), linear counting below 2.5m).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

const double INF = std::numeric_limits<double>::infinity();

inline double hll_est(double S, long zeros, double m) {
    double alpha = 0.7213 / (1.0 + 1.079 / m);
    double e = alpha * m * m / S;
    if (e <= 2.5 * m && zeros > 0) e = m * std::log(m / (double)zeros);
    return e;
}

}  // namespace

extern "C" {

// pregs: [n, m] row-major, pregs[j][r] = 2^-register_r of bin j (exact
// powers of two).  counts: [n] exact per-bin cardinalities.  Output
// ubT: [n, W] row-major; ubT[j][d] = union estimate of bins (j-d..j),
// d = 0 entry is max(count_j, est_j) (binning._union_matrix diagonal),
// entries with d > j stay untouched (caller pre-fills if it cares).
void hll_union_band(const double* pregs, const double* counts, long n,
                    long m, long W, double* ubT, int nthreads) {
    auto worker = [&](long j0, long j1) {
        std::vector<double> acc((size_t)m);
        for (long j = j0; j < j1; j++) {
            const double* pj = pregs + (size_t)j * m;
            std::memcpy(acc.data(), pj, (size_t)m * sizeof(double));
            double S = 0.0;
            long zeros = 0;
            for (long r = 0; r < m; r++) {
                S += acc[r];
                zeros += acc[r] == 1.0;
            }
            double e = hll_est(S, zeros, (double)m);
            double prev = std::max(counts[j], e);
            ubT[(size_t)j * W + 0] = prev;
            long dmax = std::min(W - 1, j);
            for (long d = 1; d <= dmax; d++) {
                const double* pk = pregs + (size_t)(j - d) * m;
                S = 0.0;
                zeros = 0;
                for (long r = 0; r < m; r++) {
                    // larger register => smaller 2^-reg: union (register
                    // max) is the elementwise MIN of the pow2 values
                    double v = std::min(acc[r], pk[r]);
                    acc[r] = v;
                    S += v;
                    zeros += v == 1.0;
                }
                e = hll_est(S, zeros, (double)m);
                if (e < prev) e = prev;  // monotonize along d
                ubT[(size_t)j * W + d] = e;
                prev = e;
            }
        }
    };
    if (nthreads <= 1 || n < 64) {
        worker(0, n);
        return;
    }
    std::vector<std::thread> ts;
    long chunk = (n + nthreads - 1) / nthreads;
    for (int t = 1; t < nthreads; t++) {
        long j0 = t * chunk, j1 = std::min(n, j0 + chunk);
        if (j0 < j1) ts.emplace_back(worker, j0, j1);
    }
    worker(0, std::min(n, chunk));
    for (auto& t : ts) t.join();
}

// The split/merge DP (binning._dp_layout).  ubT as produced by
// hll_union_band ([n, W] row-major; rows may be a slice of a larger
// band — entries at d > local j are never read because the global
// window (j-d..j) coincides with the local one on contiguous slices).
//
// Matches the numpy oracle exactly given the same band: transition
// order (base rows, then per i: splits then merges), tie-breaking
// (first minimum in ascending i' / ascending j'), strict improvement
// against the current cell.  The merge walk visits j' DESCENDING
// (d ascending) and replaces on <=, which keeps the smallest j' among
// ties; the monotone band makes "stop once U > best" exact.
//
// Outputs: placements as parallel arrays (caller allocates n entries):
//   kind 0 => split: a = user bin j, b = first technical bin, c = #bins
//   kind 1 => merge: a = j_from, b = j_to, c = technical bin
// in backtrack (reverse) order; Python reverses.  Returns the number of
// placements, or -1 on backtrack failure.  out_max_size gets M*.
long layout_dp(const double* counts, long n, const double* ubT, long W,
               long tmax, long max_split, double* out_max_size,
               int32_t* out_kind, int32_t* out_a, int32_t* out_b,
               int32_t* out_c, int nthreads) {
    // rows beyond n*max_split are unreachable (every user bin split to
    // its cap cannot fill more technical bins) — capping saves memory
    // without changing the argmin below
    long rows = std::min(tmax, n * max_split);
    if (rows < 1) rows = 1;
    std::vector<double> M((size_t)rows * n, INF);
    std::vector<int8_t> bk((size_t)rows * n, -1);
    std::vector<int32_t> ba((size_t)rows * n, -1);

    // base: user bin 0 split across technical bins 0..i
    for (long i = 0; i < std::min(rows, max_split); i++) {
        M[(size_t)i * n] = std::ceil(counts[0] / (double)(i + 1));
        bk[(size_t)i * n] = 0;
        ba[(size_t)i * n] = 0;
    }
    // base: user bins 0..j all merged into technical bin 0.  The FULL
    // span (j == n-1) is excluded: a one-bin layout holding everything
    // recurses into a child identical to its parent (the monotone band
    // makes it TIE the optimum whenever unions plateau — near-identical
    // or heavily-scaled inputs — and first-min tie-breaking then picks
    // it, an infinite recursion).  It is also pointless: same max size,
    // one extra level of indirection.
    long jmax0 = std::min(n - 1, W);
    for (long j = 1; j < jmax0; j++) {
        M[j] = ubT[(size_t)j * W + j];
        bk[j] = 1;
        ba[j] = 0;
    }

    std::vector<double> sbest((size_t)n);
    std::vector<int32_t> sarg((size_t)n);
    for (long i = 1; i < rows; i++) {
        const double* mprev = M.data() + (size_t)(i - 1) * n;
        double* mrow = M.data() + (size_t)i * n;
        int8_t* krow = bk.data() + (size_t)i * n;
        int32_t* arow = ba.data() + (size_t)i * n;
        long ip_lo = std::max(1L, i - max_split + 1);

        auto split_worker = [&](long j0, long j1) {
            for (long j = j0; j < j1; j++) sbest[j] = INF;
            // i'-outer keeps the M[(i'-1)] row accesses sequential;
            // ascending i' with strict < == numpy argmin's first-min
            for (long ip = ip_lo; ip <= i; ip++) {
                const double* mp = M.data() + (size_t)(ip - 1) * n;
                double nb = (double)(i - ip + 1);
                for (long j = j0; j < j1; j++) {
                    double cand = std::ceil(counts[j] / nb);
                    double a = mp[j - 1];
                    if (a > cand) cand = a;
                    if (cand < sbest[j]) {
                        sbest[j] = cand;
                        sarg[j] = (int32_t)ip;
                    }
                }
            }
            for (long j = j0; j < j1; j++) {
                if (sbest[j] < mrow[j]) {
                    mrow[j] = sbest[j];
                    krow[j] = 0;
                    arow[j] = sarg[j];
                }
            }
            // merges: best j' for max(M[i-1][j'-1], U[j'..j])
            for (long j = j0; j < j1; j++) {
                long dmax = std::min(W - 1, j - 1);
                const double* ub = ubT + (size_t)j * W;
                double bestm = INF;
                long bestjp = -1;
                for (long d = 0; d <= dmax; d++) {
                    double u = ub[d];
                    if (u > bestm) break;  // monotone band: no later
                    // candidate can reach bestm again
                    double cand = mprev[j - 1 - d];
                    if (cand < u) cand = u;
                    if (cand <= bestm) {  // <=: smaller j' wins ties
                        bestm = cand;
                        bestjp = j - d;
                    }
                }
                if (bestm < mrow[j]) {
                    mrow[j] = bestm;
                    krow[j] = 1;
                    arow[j] = (int32_t)bestjp;
                }
            }
        };
        if (nthreads <= 1 || n < 512) {
            split_worker(1, n);
        } else {
            std::vector<std::thread> ts;
            long span = n - 1;
            long chunk = (span + nthreads - 1) / nthreads;
            for (int t = 1; t < nthreads; t++) {
                long j0 = 1 + t * chunk, j1 = std::min(n, j0 + chunk);
                if (j0 < j1) ts.emplace_back(split_worker, j0, j1);
            }
            split_worker(1, std::min(n, 1 + chunk));
            for (auto& t : ts) t.join();
        }
    }

    // best final row (first minimum, like np.argmin)
    long besti = 0;
    double bestv = M[(size_t)0 * n + (n - 1)];
    for (long i = 1; i < rows; i++) {
        double v = M[(size_t)i * n + (n - 1)];
        if (v < bestv) {
            bestv = v;
            besti = i;
        }
    }
    *out_max_size = bestv;
    long cnt = 0;
    long i = besti, j = n - 1;
    while (j >= 0) {
        int8_t kind = bk[(size_t)i * n + j];
        int32_t arg = ba[(size_t)i * n + j];
        if (kind == 0) {
            out_kind[cnt] = 0;
            out_a[cnt] = (int32_t)j;
            out_b[cnt] = arg;          // start technical bin
            out_c[cnt] = (int32_t)(i - arg + 1);  // bins spanned
            cnt++;
            i = arg - 1;
            j = j - 1;
        } else if (kind == 1) {
            out_kind[cnt] = 1;
            out_a[cnt] = arg;          // j_from
            out_b[cnt] = (int32_t)j;   // j_to
            out_c[cnt] = (int32_t)i;   // technical bin
            cnt++;
            i = i - 1;
            j = arg - 1;
        } else {
            return -1;
        }
    }
    return cnt;
}

// Greedy similarity chain (binning.rearrange_bins): starting from
// `start`, repeatedly append the unplaced bin with the highest
// HLL-Jaccard similarity to the last placed one.  pregs are the f32
// 2^-register values (exact — registers are <= 55); the union sum
// accumulates in double like the numpy oracle.  First-max tie-break
// (np.argmax) == strict > over ascending i.
void rearrange_chain(const float* pregs, const double* ests, long n,
                     long m, long start, int32_t* order_out,
                     int nthreads) {
    std::vector<uint8_t> placed((size_t)n, 0);
    long cur = start;
    order_out[0] = (int32_t)cur;
    placed[cur] = 1;
    long nt = std::max(1, nthreads);
    std::vector<double> tbest((size_t)nt);
    std::vector<long> targ((size_t)nt);
    for (long step = 1; step < n; step++) {
        const float* pc = pregs + (size_t)cur * m;
        for (long t = 0; t < nt; t++) {
            tbest[t] = -INF;
            targ[t] = -1;
        }
        auto worker = [&](int t, long i0, long i1) {
            double best = -INF;
            long bi = -1;
            for (long i = i0; i < i1; i++) {
                if (placed[i]) continue;
                const float* pi = pregs + (size_t)i * m;
                double S = 0.0;
                long zeros = 0;
                for (long r = 0; r < m; r++) {
                    float v = pc[r] < pi[r] ? pc[r] : pi[r];
                    S += (double)v;
                    zeros += v == 1.0f;
                }
                double u = hll_est(S, zeros, (double)m);
                double denom = u > 1e-9 ? u : 1e-9;
                double jac = (ests[cur] + ests[i] - u) / denom;
                if (jac > best) {
                    best = jac;
                    bi = i;
                }
            }
            tbest[t] = best;
            targ[t] = bi;
        };
        if (nt == 1 || n < 256) {
            worker(0, 0, n);
        } else {
            std::vector<std::thread> ts;
            long chunk = (n + nt - 1) / nt;
            for (int t = 1; t < nt; t++) {
                long i0 = t * chunk, i1 = std::min(n, i0 + chunk);
                if (i0 < i1)
                    ts.emplace_back(worker, t, i0, i1);
                else {
                    tbest[t] = -INF;
                    targ[t] = -1;
                }
            }
            worker(0, 0, std::min(n, chunk));
            for (auto& t : ts) t.join();
        }
        double best = -INF;
        long bi = -1;
        for (int t = 0; t < nt; t++) {
            // strictly-greater merge keeps the lowest-index maximum
            // (thread 0 owns the lowest index range)
            if (targ[t] >= 0 && tbest[t] > best) {
                best = tbest[t];
                bi = targ[t];
            }
        }
        order_out[step] = (int32_t)bi;
        placed[bi] = 1;
        cur = bi;
    }
}

}  // extern "C"
