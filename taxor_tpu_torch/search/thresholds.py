"""Per-read minimum-match-count threshold models.

Reproduces src/hixf/search/threshold.hpp:51-81 and its four models:

  - percentage: floor(count * p)                    (threshold.hpp:78)
  - k-mer model (Blanca et al.): count - CI_high - floor(count*0.0039)
    where CI is the 95% confidence interval on the number of mutated
    k-mers (kmer_model.cpp:10-26, threshold.hpp:53,62-65).  C++ quirk:
    the subtraction happens in size_t, so a negative result wraps to a
    huge value — i.e. "no read can pass"; we replicate with INF_THRESHOLD.
  - syncmer model: empirical 21x10 min-match-ratio table indexed by read
    accuracy (80..100%) x even k (12..30) (syncmer_model.hpp:14-50).
  - FracMinHash containment CI (fracminhash_model.cpp:23-33).

Model selection (threshold.hpp:22-49): explicit percentage in (0,1] wins;
else syncmer scheme -> syncmer model; else window==k -> k-mer model; else
fracminhash.  The inverse normal CDF uses the Abramowitz-Stegun rational
approximation (gaussian_inverse.cpp:12-53).

These are scalar per-read host computations (float64, matching the C++
doubles); the search pipeline vectorizes them with numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

INF_THRESHOLD = 1 << 63  # stands in for the size_t wraparound

# matching_ratios table (syncmer_model.hpp:14-36): rows = read accuracy
# 80%..100% (21 rows), cols = kmer sizes 12,14,...,30 (10 cols).
_MATCHING_RATIOS = np.array([
    [0.552077, 0.195989, 0.151428, 0.118475, 0.0946177, 0.0797244, 0.0604658, 0.0480255, 0.0367569, 0.0252911],
    [0.552385, 0.207533, 0.161204, 0.127368, 0.103704, 0.0881939, 0.0689396, 0.0556991, 0.044185, 0.0298818],
    [0.552239, 0.220393, 0.17382, 0.139866, 0.113736, 0.0966358, 0.0783558, 0.0639223, 0.0523452, 0.0389549],
    [0.552682, 0.236329, 0.188152, 0.152267, 0.126191, 0.106106, 0.0876917, 0.0730642, 0.0621864, 0.0489249],
    [0.553172, 0.254091, 0.202686, 0.165344, 0.137087, 0.116649, 0.098822, 0.0831266, 0.0703342, 0.0582562],
    [0.553716, 0.271183, 0.219848, 0.181959, 0.152163, 0.130048, 0.110622, 0.0942414, 0.0810792, 0.0688187],
    [0.554532, 0.292154, 0.240059, 0.199738, 0.168952, 0.144956, 0.122726, 0.105878, 0.0940805, 0.0777557],
    [0.557957, 0.313553, 0.260912, 0.220014, 0.186567, 0.16101, 0.137399, 0.119867, 0.10453, 0.0900014],
    [0.563925, 0.338316, 0.283689, 0.2401, 0.206963, 0.179541, 0.155347, 0.135128, 0.121575, 0.104741],
    [0.568519, 0.364594, 0.310373, 0.267578, 0.231083, 0.20088, 0.174376, 0.153111, 0.139339, 0.120042],
    [0.579726, 0.395595, 0.338947, 0.295287, 0.258713, 0.22876, 0.200759, 0.175309, 0.161306, 0.139616],
    [0.599258, 0.430241, 0.371291, 0.325596, 0.289651, 0.257329, 0.228011, 0.201799, 0.186956, 0.164794],
    [0.611572, 0.468953, 0.410482, 0.363923, 0.325828, 0.293046, 0.26167, 0.235216, 0.216716, 0.192162],
    [0.624341, 0.510411, 0.452122, 0.407016, 0.370022, 0.334601, 0.303413, 0.275232, 0.254563, 0.227871],
    [0.655724, 0.555245, 0.498564, 0.453201, 0.416285, 0.381883, 0.352291, 0.322556, 0.299739, 0.271481],
    [0.694872, 0.608367, 0.552085, 0.509395, 0.471692, 0.437803, 0.405938, 0.377117, 0.354352, 0.325132],
    [0.742071, 0.669034, 0.613738, 0.57366, 0.539215, 0.50832, 0.476855, 0.449152, 0.42683, 0.397277],
    [0.795543, 0.733694, 0.68341, 0.647737, 0.617382, 0.588448, 0.56083, 0.533714, 0.514757, 0.486399],
    [0.853121, 0.802585, 0.763169, 0.733734, 0.708902, 0.684331, 0.660171, 0.637633, 0.621567, 0.596993],
    [0.918163, 0.882314, 0.854479, 0.835831, 0.819643, 0.804269, 0.788526, 0.771895, 0.763059, 0.742114],
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
])


def rational_approximation(t: float) -> float:
    """Abramowitz-Stegun 26.2.23 (gaussian_inverse.cpp:12-21)."""
    c = (2.515517, 0.802853, 0.010328)
    d = (1.432788, 0.189269, 0.001308)
    return t - ((c[2] * t + c[1]) * t + c[0]) / (
        ((d[2] * t + d[1]) * t + d[0]) * t + 1.0
    )


def normal_cdf_inverse(p: float) -> float:
    if p <= 0.0 or p >= 1.0:
        raise ValueError(f"Invalid input argument ({p})")
    if p < 0.5:
        return -rational_approximation(math.sqrt(-2.0 * math.log(p)))
    return rational_approximation(math.sqrt(-2.0 * math.log(1.0 - p)))


_SIZE_T_SENTINEL = 1 << 63


def _cast_size_t(x: float) -> int:
    """``static_cast<size_t>(double)`` as the reference binary computes it.

    The cast is UB in C++ for NaN / negative / out-of-range values; the
    behavior below is the measured runtime lowering of g++ -O2 on x86-64
    (verified against the golden fixtures generated from the reference's
    kmer_model.cpp / fracminhash_model.cpp):

      nan, x <= -2^63  ->  0x8000000000000000 sentinel
      x in (-2^63, 0)  ->  two's-complement wrap of trunc(x)
      x >= 2^64        ->  0

    Every "weird" branch yields a value far above any possible hit count
    or far below any threshold use — semantically "impossible"/"zero".
    """
    if math.isnan(x):
        return _SIZE_T_SENTINEL
    t = math.trunc(x)
    if t < -(1 << 63):
        return _SIZE_T_SENTINEL
    if t >= 1 << 64:
        return 0
    return t % (1 << 64)


def _ieee_div(a: float, b: float) -> float:
    """C double division: x/0 -> +-inf, 0/0 -> nan (Python raises instead)."""
    if b == 0.0:
        if a == 0.0 or math.isnan(a):
            return math.nan
        return math.inf if a > 0.0 else -math.inf
    return a / b


def _ieee_sqrt(x: float) -> float:
    """C sqrt: negative -> nan (Python raises a domain error instead)."""
    if math.isnan(x) or x < 0.0:
        return math.nan
    return math.sqrt(x)


def expected_nmut_kmer(r: float, k: int, count: int) -> float:
    q = 1.0 - (1.0 - r) ** k
    return count * q


def variance_nmut_kmer(r: float, k: int, count: int) -> float:
    """Closed-form variance of the mutated-k-mer count
    (kmer_model.cpp:35-42).  IEEE semantics throughout: r=0 produces
    0*inf = NaN exactly as the reference's C double math does."""
    q = 1.0 - (1.0 - r) ** k
    return (
        count * (1.0 - q) * (q * (2.0 * k + _ieee_div(2.0, r) - 1.0) - 2.0 * k)
        + k * (k - 1.0) * (1.0 - q) ** 2
        + _ieee_div(2.0 * (1.0 - q), r**2) * ((1.0 + (k - 1.0) * (1.0 - q)) * r - q)
    )


def nmut_kmer_ci(r: float, k: int, count: int, confidence: float = 0.95):
    """(low, high) CI on mutated k-mers (kmer_model.cpp:10-26), with the
    reference's size_t casts (sentinel on NaN/negative, see _cast_size_t)."""
    q = 1.0 - (1.0 - r) ** k
    var = variance_nmut_kmer(r, k, count)
    z = normal_cdf_inverse(1.0 - (1.0 - confidence) / 2.0)
    lowf = count * q - z * _ieee_sqrt(var)
    highf = count * q + z * _ieee_sqrt(var)
    low = math.nan if math.isnan(lowf) else math.floor(lowf)
    high = math.nan if math.isnan(highf) else math.ceil(highf)
    return _cast_size_t(low), _cast_size_t(high)


def syncmer_match_ratio(k: int, error_rate: float) -> float:
    """Table lookup (syncmer_model.hpp:38-50): row = ceil((1-e)*100 - 80),
    col = k-10 - (k-10)/2 - 1 with C++ integer division."""
    row = math.ceil((1.0 - error_rate) * 100.0 - 80.0)
    col = (k - 10) - (k - 10) // 2 - 1
    return float(_MATCHING_RATIOS[row][col])


def containment_index_ci(r: float, k: int, count: int, scaling: float,
                         confidence: float = 0.95):
    """FracMinHash containment CI (fracminhash_model.cpp:9-33).

    IEEE division throughout: count == 0 (read shorter than k) makes the
    count**2 / count**3 denominators 0.0, and the reference's C double
    math yields inf/NaN which the caller's size_t cast maps to the
    'impossible' sentinel — it must not raise ZeroDivisionError here."""
    exp_ci = (1.0 - r) ** k
    nmut = expected_nmut_kmer(r, k, count)
    nmut_sq = nmut**2 + variance_nmut_kmer(r, k, count)
    term3 = _ieee_div(variance_nmut_kmer(r, k, count), float(count**2))
    term2 = count * nmut - nmut_sq
    denominator = scaling * count**3 * (1.0 - (1.0 - scaling) ** count) ** 2
    term1 = _ieee_div(1.0 - scaling, denominator)
    var = term1 * term2 + term3
    z = normal_cdf_inverse(1.0 - (1.0 - confidence) / 2.0)
    return exp_ci - z * _ieee_sqrt(var), exp_ci + z * _ieee_sqrt(var)


@dataclass
class Thresholder:
    """threshold::threshold (threshold.hpp:12-104)."""

    kmer_size: int
    error_rate: float
    kind: str  # 'percentage' | 'syncmer_model' | 'kmer_model' | 'fracminhash'
    percentage: float = 0.0

    @staticmethod
    def make(kmer_size: int, window_size: int, error_rate: float,
             percentage: float, use_syncmer: bool,
             fracminhash: bool = False) -> "Thresholder":
        kmers_per_window = window_size - kmer_size + 1
        if 0.0 < percentage <= 1.0:
            kind = "percentage"
        elif use_syncmer:
            kind = "syncmer_model"
        elif kmers_per_window == 1 and not fracminhash:
            kind = "kmer_model"
        else:
            kind = "fracminhash"
        return Thresholder(kmer_size=kmer_size, error_rate=error_rate,
                           kind=kind, percentage=percentage)

    def get(self, minimiser_count: int, scaling_factor: float) -> int:
        """threshold.get (threshold.hpp:51-81).  Returns the minimum hit
        count; INF_THRESHOLD encodes the size_t-wraparound 'impossible'."""
        fp_correction = int(minimiser_count * 0.0039)
        if self.kind == "syncmer_model":
            ratio = syncmer_match_ratio(self.kmer_size, self.error_rate)
            return int(minimiser_count * ratio)
        if self.kind == "kmer_model":
            _, hi = nmut_kmer_ci(self.error_rate, self.kmer_size,
                                 minimiser_count, 0.95)
            # exact size_t wrap of threshold.hpp:64-65 — wrapped values are
            # >= 2^63, far above any possible count, i.e. "impossible"
            return (minimiser_count - hi - fp_correction) % (1 << 64)
        if self.kind == "fracminhash":
            clow, _ = containment_index_ci(self.error_rate, self.kmer_size,
                                           minimiser_count, scaling_factor,
                                           0.95)
            val = _cast_size_t(clow * minimiser_count)
            return (val - fp_correction) % (1 << 64)
        return int(minimiser_count * self.percentage)


def _scaling_ratio(hash_count: int, seq_len: int, kmer_size: int) -> float:
    """(double)hash_count / ((double)len - k + 1.0) with C double
    semantics (taxor_search.cpp:263): seq_len == k-1 yields 0/0 = NaN
    (hash_count is always 0 for such reads), which the fracminhash model
    propagates to the size_t sentinel — 'no read can pass', exactly as
    the reference binary computes it.  Only that model consumes the
    ratio."""
    denom = float(seq_len) - float(kmer_size) + 1.0
    if denom == 0.0:
        return float("nan") if hash_count == 0 else float("inf")
    return float(hash_count) / denom


def _read_threshold(thresholder, hash_count, seq_len, kmer_size):
    """The per-read threshold exactly as the host prepare computes it."""
    return int(thresholder.get(
        hash_count, _scaling_ratio(hash_count, seq_len, kmer_size)))


def e2e_thresholds(thresholder, counts, lens, kmer_size) -> np.ndarray:
    """int64 [R]: the threshold of each read of the fused result (its
    hash count, its length), memoized on that pair, the only inputs the
    models consume; exact host float64 math."""
    thr_cache = getattr(thresholder, "_e2e_thr_cache", None)
    if thr_cache is None:
        thr_cache = thresholder._e2e_thr_cache = {}
    thr = np.empty(len(lens), dtype=np.int64)
    for r, key in enumerate(zip(np.asarray(counts).tolist(), lens)):
        t = thr_cache.get(key)
        if t is None:
            t = thr_cache[key] = _read_threshold(
                thresholder, key[0], key[1], kmer_size)
        # size_t-wrapped "impossible" thresholds are >= 2^63 and would
        # overflow int64; any value above every possible count is
        # equivalent for the comparisons that use them
        thr[r] = min(t, 2**62)
    return thr


INT32_MAX = 2**31 - 1


def count_thresholds(thresholder, hcap: int) -> np.ndarray:
    """int32 [hcap + 1]: ``thresholder.get(c, 0.0)`` for every hash count
    c = 0 .. hcap, clamped to [0, INT32_MAX] (the size_t-wrapped
    "impossible" values become INT32_MAX): the count-indexed descent
    table of the count-only models (percentage, syncmer model, k-mer
    model).  Computed over all counts at once in float64, each operation
    the scalar path's in the same order (numpy's +, -, *, / and sqrt are
    IEEE-exact as Python's floats are), so the values are the scalar
    loop's; a minimiser read of a 1 Mb bucket asks for ~10^6 of them."""
    c = np.arange(hcap + 1, dtype=np.int64)
    cf = c.astype(np.float64)
    if thresholder.kind == "syncmer_model":
        ratio = syncmer_match_ratio(thresholder.kmer_size,
                                    thresholder.error_rate)
        thr = np.trunc(cf * ratio).astype(np.int64)
    elif thresholder.kind == "percentage":
        thr = np.trunc(cf * thresholder.percentage).astype(np.int64)
    elif thresholder.kind == "kmer_model":
        thr = _kmer_model_thresholds(thresholder.error_rate,
                                     thresholder.kmer_size, c)
    else:
        raise ValueError(f"count_thresholds: the {thresholder.kind} model "
                         "depends on more than the hash count")
    return np.clip(thr, 0, INT32_MAX).astype(np.int32)


def _kmer_model_thresholds(r: float, k: int, c: np.ndarray) -> np.ndarray:
    """int64: the k-mer model's threshold (Thresholder.get) of each count
    c < 2^31, with the wrapped ones as INT32_MAX.  nmut_kmer_ci's high
    bound and the size_t arithmetic of threshold.hpp:62-65, vectorised:
    the count enters the variance only through its first product, the rest
    are the scalar path's constants."""
    cf = c.astype(np.float64)
    q = 1.0 - (1.0 - r) ** k
    slope = q * (2.0 * k + _ieee_div(2.0, r) - 1.0) - 2.0 * k
    var = (cf * (1.0 - q) * slope + k * (k - 1.0) * (1.0 - q) ** 2
           + _ieee_div(2.0 * (1.0 - q), r**2)
           * ((1.0 + (k - 1.0) * (1.0 - q)) * r - q))
    z = normal_cdf_inverse(1.0 - (1.0 - 0.95) / 2.0)
    with np.errstate(invalid="ignore"):
        # NaN where var < 0 (as _ieee_sqrt) or r = 0 (0 * inf)
        high = np.ceil(cf * q + z * np.sqrt(var))
    # _cast_size_t casts NaN to 2^63, above every count: a wrapped
    # threshold.  Else high >= 0 and, the counts being < 2^31, far below
    # 2^63, so its other casts (negative, 2^63 and more) cannot occur.
    nan = np.isnan(high)
    fp = np.trunc(cf * 0.0039).astype(np.int64)
    d = c - np.where(nan, 0.0, high).astype(np.int64) - fp
    # d <= c < 2^31; d < 0 is the size_t wrap of threshold.hpp:64-65
    return np.where(nan | (d < 0), INT32_MAX, d)


def device_thresholds(thresholder, counts, lens, kmer_size) -> np.ndarray:
    """int32 [R]: the per-read descent's thresholds, e2e_thresholds
    clamped to [0, INT32_MAX] as the count-indexed table is
    (count_thresholds): the size_t-wrapped and NaN
    "impossible" sentinels, and reads of length k - 1, become INT32_MAX,
    above every run sum.  A read of length 0 is batch padding: INT32_MAX,
    it descends nowhere."""
    lens = np.asarray(lens, dtype=np.int64)
    thr = np.full(lens.shape[0], INT32_MAX, dtype=np.int64)
    real = np.flatnonzero(lens > 0)
    thr[real] = e2e_thresholds(thresholder, np.asarray(counts)[real],
                               lens[real].tolist(), kmer_size)
    return np.clip(thr, 0, INT32_MAX).astype(np.int32)
