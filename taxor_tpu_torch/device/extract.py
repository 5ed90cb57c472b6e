"""Syncmer extraction + dedup + wyhash: CUDA kernel K1 and its plain twin.

Counterpart of ``taxor_tpu/device/pallas_extract.py`` (the Pallas
``_extract_kernel`` with the ``pallas_sort._bitonic_body`` network).
The kernel (``csrc/extract.cu``) runs the reference's stateful tracker
position-parallel and exact (windows classified in parallel, tied runs
replayed in the kernel: ``csrc/tracker.cuh``), so it needs neither the
TPU kernel's tie flag nor the tie-rescue sub-batch of ``device/e2e.py``:
n_emit is always the true count.  Both kernels come in two instances,
picked from s (``smer_bits``): 32-bit canonical s-mers for s <= 15, as
the TPU kernel's int32 lanes had them, and 64-bit ones for 16 <= s <= 31,
so that every syncmer scheme the CLI builds (k <= 30) runs on the card;
each wrapper counts its launches by instance in ``SMER_BITS``.

Contract of ``syncmer_hashes`` for packed reads uint8 [R, L/4]
(``pack_reads`` layout) and lengths int32 [R]:

  hi, lo    int32 [R, hcap]  bit patterns of wyhash64(canonical k-mer),
                             slots in ascending canonical-k-mer order
  valid     bool  [R, hcap]  first occurrence of its k-mer (hi = lo = 0
                             where False)
  n_unique  int32 [R]        distinct k-mers over ALL emissions
  n_emit    int32 [R]        emissions before dedup (> hcap: the read
                             falls back to the host oracle)

Slot j holds the j-th smallest emitted k-mer, duplicates included, which
is what ``syncmer_kmers`` -> ``dedup_kmers`` -> ``wyhash64`` gives.

A read longer than L_CAP runs as pieces (``pieces`` = P > 1): packed
[R, pieces_len(P) / 4] holds each whole read, K1 takes piece j of read r
(L_CAP bases from base j * PIECE_STRIDE) as row r * P + j of its outputs,
[R * P, hcap] with hcap the piece's, and n_emit counts the emissions of
the windows that piece owns (``hash/device_syncmer.piece_owned``): the
pieces' owned emissions are the whole read's, each once, tied runs across
a cut included (csrc/tracker.cuh ``holder_at``).  Its twin runs the
tracker over the whole read (``syncmer_kmers_pieces``).
``device/sort.union_pieces`` joins a read's pieces.

``syncmer_track`` is the first kernel of the split engine
(device/e2e.USE_FUSED_EXTRACT = False): the same tracker, writing the
per-position contract of ``syncmer_kmers`` (canonical k-mer int64 [R, L]
and emission mask bool [R, L]) for the dedup kernel K3 (device/sort.py).

``minimizer_kmers`` is CUDA kernel K5 (``csrc/minimizer.cu``), the
minimiser and plain k-mer extraction of the non-syncmer schemes with the
FracMinHash keep, with the contract of its twin ``minimizer_hashes_plain``
(``hash/device_syncmer.minimizer_kmers_plain`` followed by
``scaling_keep``): per END position the emitted value as int32 hi/lo
[R, L] (0 where nothing is emitted; no wyhash, duplicates kept), valid
bool [R, L] (emitted and kept), n_emit int32 [R] (emissions before the
keep) and n_unique int32 [R] (the valid slots).  Its hashes probe at full
width, H = L (the JAX package's hcap = L for these schemes).  K5 takes a
row of any length that is a multiple of 16 (its launcher cuts a long row
into spans and sums their counts).
"""

from __future__ import annotations

import torch

from ..hash.device_syncmer import (L_CAP, PIECE_STRIDE, dedup_kmers,
                                   minimizer_kmers_plain, pieces_len,
                                   sort_width, syncmer_kmers,
                                   syncmer_kmers_pieces)
from ..hash.minimizer import adjust_seed
from ..utils.u64 import INT64_MIN, i64, join32, split32, wyhash64
from . import cuda_build

# dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 227 * 1024


def smer_bits(s: int) -> int:
    """The s-mer word of the K1 and syncmer_track instance that takes
    s-mers of length s: 32 bits for s <= 15, 64 for 16 <= s <= 31."""
    return 32 if s <= 15 else 64


def hashes_of_kmers(srt: torch.Tensor, valid: torch.Tensor):
    """(hi, lo) int32 bit patterns of wyhash64 of the sorted k-mers, 0
    where a slot holds no first occurrence: K1's hash output."""
    return split32(torch.where(valid, wyhash64(srt), torch.zeros_like(srt)))


def scaling_keep(hi, lo, scale_thresh: int) -> torch.Tensor:
    """Keep mask of FracMinHash scaling: wyhash64 of the value <= T as
    uint64 (T = schemes.scaling_threshold_u64, the exact integer form of
    the reference's double compare).  For syncmers the value is K1's
    hash, hashed again, as the host's scaling_filter does."""
    v = wyhash64(join32(hi, lo))
    return (v ^ INT64_MIN) <= (i64(scale_thresh) ^ INT64_MIN)


def _kmers_plain(packed, lengths, k: int, s: int, t: int, pieces: int):
    """(kmer, emit) of the rows K1 and syncmer_track take: the whole
    reads, or each read's pieces."""
    if pieces > 1:
        return syncmer_kmers_pieces(packed, lengths, k, s, t, pieces)
    return syncmer_kmers(packed, lengths, k, s, t)


def syncmer_hashes_plain(packed, lengths, k: int, s: int, t: int,
                         hcap: int, pieces: int = 1):
    """Plain PyTorch twin of K1 (same contract)."""
    kmer, emit = _kmers_plain(packed, lengths, k, s, t, pieces)
    srt, valid, n_unique, n_emit = dedup_kmers(kmer, emit, hcap)
    return (*hashes_of_kmers(srt, valid), valid, n_unique, n_emit)


def _check_packed(name: str, packed: torch.Tensor,
                  lengths: torch.Tensor) -> tuple[int, int]:
    """Validates a kernel's packed reads; returns (R, L)."""
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {packed.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"{name}: packed must be uint8 [R, L/4]")
    R, L = packed.shape[0], packed.shape[1] * 4
    if (lengths.dtype != torch.int32 or lengths.shape != (R,)
            or lengths.device != packed.device):
        raise ValueError(f"{name}: lengths must be int32 [R] on the "
                         "reads' device")
    if not (packed.is_contiguous() and lengths.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if L % 16 or packed.data_ptr() % 4:
        raise ValueError(f"{name}: L must be a multiple of 16 bases on "
                         "4-byte aligned rows")
    return R, L


def _check_reads(name: str, packed: torch.Tensor, lengths: torch.Tensor,
                 k: int, s: int, t: int) -> tuple[int, int]:
    """Validates a syncmer kernel's packed reads and scheme; (R, L)."""
    R, L = _check_packed(name, packed, lengths)
    if not (2 <= s <= 31 and s < k <= 32 and 1 <= t <= k - s + 1):
        raise ValueError(f"{name}: unsupported scheme k={k} s={s} t={t}")
    return R, L


def _rows(name: str, L: int, pieces: int) -> tuple[int, int]:
    """(Lp, stride) of the rows a kernel takes from reads of L bases as
    ``pieces`` pieces: (L, 0) for whole rows, else (L_CAP,
    PIECE_STRIDE) on reads of pieces_len(pieces) bases."""
    if pieces == 1:
        return L, 0
    if pieces < 1 or L != pieces_len(pieces):
        raise ValueError(f"{name}: {pieces} pieces take reads of "
                         f"{pieces_len(max(1, pieces))} bases, not {L}")
    return L_CAP, PIECE_STRIDE


def syncmer_hashes(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                   s: int, t: int, hcap: int, pieces: int = 1):
    """K1 on a CUDA tensor, its plain twin on a CPU tensor; with pieces >
    1 on the pieces of each read ([R * pieces, hcap] rows)."""
    if packed.device.type == "cpu":
        return syncmer_hashes_plain(packed, lengths, k, s, t, hcap, pieces)
    R, L = _check_reads("syncmer_hashes", packed, lengths, k, s, t)
    if hcap <= 0:
        raise ValueError(f"syncmer_hashes: hcap must be positive, not {hcap}")
    Lp, stride = _rows("syncmer_hashes", L, pieces)
    W = sort_width(Lp, k, s, t)
    dev = packed.device
    rows = R * pieces
    hi = torch.empty((rows, hcap), dtype=torch.int32, device=dev)
    lo = torch.empty_like(hi)
    valid = torch.empty((rows, hcap), dtype=torch.bool, device=dev)
    n_unique = torch.empty(rows, dtype=torch.int32, device=dev)
    n_emit = torch.empty_like(n_unique)
    lib = cuda_build.lib()
    scratch = None
    if lib.syncmer_extract_smem(Lp, s, W, 1) > SMEM_LIMIT:
        scratch = torch.empty((rows, W), dtype=torch.int64, device=dev)
    err = lib.launch_syncmer_extract(
        packed.data_ptr(), lengths.data_ptr(), R, L, pieces, Lp, stride, k,
        s, t, hcap, W, None if scratch is None else scratch.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), n_unique.data_ptr(),
        n_emit.data_ptr(), cuda_build.stream_of(packed))
    cuda_build.check(err, "launch_syncmer_extract")
    if R:
        cuda_build.count_launch(syncmer_hashes, tally=syncmer_hashes.SMER_BITS,
                                variant=smer_bits(s))
    return hi, lo, valid, n_unique, n_emit


syncmer_hashes.LAUNCHES = 0
syncmer_hashes.SMER_BITS = {}  # launches by instance: {32 | 64: n}


def syncmer_track(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                  s: int, t: int, pieces: int = 1):
    """(kmer int64 [R, L], emit bool [R, L]) of ``syncmer_kmers``: the
    tracker kernel on a CUDA tensor, the plain twin on a CPU tensor; with
    pieces > 1, [R * pieces, L_CAP] rows of each read's pieces
    (``syncmer_kmers_pieces``)."""
    if packed.device.type == "cpu":
        return _kmers_plain(packed, lengths, k, s, t, pieces)
    R, L = _check_reads("syncmer_track", packed, lengths, k, s, t)
    Lp, stride = _rows("syncmer_track", L, pieces)
    kmer = torch.empty((R * pieces, Lp), dtype=torch.int64,
                       device=packed.device)
    emit = torch.empty((R * pieces, Lp), dtype=torch.bool,
                       device=packed.device)
    err = cuda_build.lib().launch_syncmer_track(
        packed.data_ptr(), lengths.data_ptr(), R, L, pieces, Lp, stride, k,
        s, t, kmer.data_ptr(), emit.data_ptr(), cuda_build.stream_of(packed))
    cuda_build.check(err, "launch_syncmer_track")
    if R:
        cuda_build.count_launch(syncmer_track, tally=syncmer_track.SMER_BITS,
                                variant=smer_bits(s))
    return kmer, emit


syncmer_track.LAUNCHES = 0
syncmer_track.SMER_BITS = {}


def minimizer_hashes_plain(packed, lengths, k: int, window: int,
                           scale_thresh: int = 0):
    """Plain PyTorch twin of K5 (same contract): ``minimizer_kmers_plain``
    followed by ``scaling_keep`` where scale_thresh is set."""
    hi, lo, valid, n_emit = minimizer_kmers_plain(packed, lengths, k, window)
    if scale_thresh:
        valid = valid & scaling_keep(hi, lo, scale_thresh)
    return hi, lo, valid, n_emit, valid.sum(dim=1, dtype=torch.int32)


def minimizer_kmers(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                    window: int, scale_thresh: int = 0):
    """(hi, lo, valid, n_emit, n_unique) of ``minimizer_hashes_plain``: K5
    on a CUDA tensor, the plain twin on a CPU tensor.  scale_thresh: the
    FracMinHash threshold (schemes.scaling_threshold_u64), 0 for none."""
    if packed.device.type == "cpu":
        return minimizer_hashes_plain(packed, lengths, k, window,
                                      scale_thresh)
    R, L = _check_packed("minimizer_kmers", packed, lengths)
    if not (2 <= k <= 32 and window >= k):
        raise ValueError(f"minimizer_kmers: unsupported scheme k={k} "
                         f"window={window}")
    if not 0 <= scale_thresh < 1 << 64:
        raise ValueError(f"minimizer_kmers: scale_thresh {scale_thresh} is "
                         "no uint64")
    dev = packed.device
    hi = torch.empty((R, L), dtype=torch.int32, device=dev)
    lo = torch.empty_like(hi)
    valid = torch.empty((R, L), dtype=torch.bool, device=dev)
    n_emit = torch.empty(R, dtype=torch.int32, device=dev)
    n_unique = torch.empty_like(n_emit)
    err = cuda_build.lib().launch_minimizer(
        packed.data_ptr(), lengths.data_ptr(), R, L, k, window - k + 1,
        adjust_seed(k), scale_thresh, hi.data_ptr(), lo.data_ptr(),
        valid.data_ptr(), n_emit.data_ptr(), n_unique.data_ptr(),
        cuda_build.stream_of(packed))
    cuda_build.check(err, "launch_minimizer")
    if R:
        cuda_build.count_launch(minimizer_kmers)
    return hi, lo, valid, n_emit, n_unique


minimizer_kmers.LAUNCHES = 0
