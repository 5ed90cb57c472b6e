"""Per-read sorts: the dedup kernel K3 and the pair-sort kernel K4, each
beside its plain PyTorch twin.

Counterpart of ``taxor_tpu/device/pallas_sort.py``:

  - ``dedup_fused`` (K3, ``csrc/dedup.cu``, the port of ``_dedup_kernel``):
    kmer int64 [R, L] and emit bool [R, L] (``syncmer_kmers``' contract)
    -> (kmer int64 [R, hcap] ascending as uint64, the all-ones SENTINEL
    past the emissions; valid bool [R, hcap], the first occurrence of a
    value that is not the sentinel; n_unique int32 [R] over all emissions;
    n_emit int32 [R]).  These are the outputs of
    ``hash/device_syncmer.dedup_kmers``.  The sort holds at most
    ``dedup_width(L, min_gap)`` emissions: a row with more (an input that
    breaks ``min_gap``) keeps its first ones in position order and reports
    n_emit = ``OVERFLOW``, which sends the read to the host oracle.
    The split engine (``device/e2e.py``) dedups through it.
  - ``sort_pairs`` (K4, ``csrc/sort_pairs.cu``, the port of
    ``_sort_kernel``): an ascending lexicographic row sort of (hi, lo) u32
    pairs given as int32 bit patterns, [R, W] -> [R, W].  ``dedup_pairs``
    dedups through it, the JAX package's ``sort_impl="pallas"`` route.
    The search sorts with it in ``union_pieces``;
  - ``unique_pairs`` (K6, ``csrc/unique.cu``; no TPU kernel): the first
    occurrences of sorted (hi, lo) rows, each row's first n_valid slots.

``union_pieces`` joins the pieces of reads longer than L_CAP
(``extract.syncmer_hashes`` with pieces > 1: K1 on each piece) into one
row a read, which the JAX package got from the host scanner's np.unique:
the valid hashes of the read's pieces side by side, every other slot the
all-ones sentinel, K4 sorts the row and K6 keeps each value once.  A
real hash can equal the sentinel, so K6 reads only the first n_valid
sorted slots, and never compares a hash with the sentinel.

Both kernels sort a row of up to ``REG_SORT_MAX`` keys in registers, on
the network of ``csrc/regsort.cuh`` (E keys a thread; warp shuffles; a
shared-memory transpose there and back a merge for the strides across
warps).  A wider row: K4 sorts each chunk of ``REG_SORT_MAX`` keys on
the same network into a scratch row, then merges the sorted runs in
log2(Wp / REG_SORT_MAX) merge-path passes with many blocks a row,
between two scratch rows the wrapper allocates; K3 (the split engine
only) sorts in one global scratch row on the shared-memory network of
``csrc/bitonic.cuh``.

A CUDA tensor goes to the kernel, a CPU tensor to the twin; any other
device raises.
"""

from __future__ import annotations

import torch

from ..hash.device_syncmer import dedup_kmers
from ..utils.u64 import join32, split32, usort_rows
from . import cuda_build

# n_emit of a row with more emissions than the dedup buffer holds
OVERFLOW = 2**30
# the widest row K3 and K4 sort in registers (csrc/regsort.cuh); K4 sorts
# a wider one in chunks of this width and merges them (two scratch rows),
# K3 in a global scratch row
REG_SORT_MAX = 16384


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def dedup_width(L: int, min_gap: int) -> int:
    """K3's buffer: a power of two covering every emission of a row of L
    positions whose emissions are at least min_gap apart."""
    return _pow2((L - 1) // min_gap + 1)


def dedup_fused_plain(kmer: torch.Tensor, emit: torch.Tensor, hcap: int,
                      min_gap: int = 1):
    """Plain PyTorch twin of K3 (same contract): the torch route of
    ``dedup_kmers`` over the first ``dedup_width`` emissions."""
    Wb = dedup_width(kmer.shape[1], min_gap)
    kept = emit & (torch.cumsum(emit, dim=1) <= Wb)
    srt, valid, n_unique, _ = dedup_kmers(kmer, kept, hcap)
    n = emit.sum(dim=1)
    return (srt, valid, n_unique,
            torch.where(n > Wb, OVERFLOW, n).to(torch.int32))


def dedup_fused(kmer: torch.Tensor, emit: torch.Tensor, hcap: int,
                min_gap: int = 1):
    """K3 on a CUDA tensor, its plain twin on a CPU tensor."""
    if kmer.device.type == "cpu":
        return dedup_fused_plain(kmer, emit, hcap, min_gap)
    if kmer.device.type != "cuda":
        raise ValueError(f"dedup_fused: unsupported device {kmer.device}")
    if kmer.dtype != torch.int64 or kmer.dim() != 2:
        raise ValueError("dedup_fused: kmer must be int64 [R, L]")
    R, L = kmer.shape
    if (emit.dtype != torch.bool or emit.shape != kmer.shape
            or emit.device != kmer.device):
        raise ValueError("dedup_fused: emit must be bool [R, L] on kmer's "
                         "device")
    if not (kmer.is_contiguous() and emit.is_contiguous()):
        raise ValueError("dedup_fused: inputs must be contiguous")
    if L < 1 or hcap < 1 or min_gap < 1:
        raise ValueError(f"dedup_fused: needs L, hcap and min_gap >= 1 "
                         f"(L={L}, hcap={hcap}, min_gap={min_gap})")
    Wb = dedup_width(L, min_gap)
    dev = kmer.device
    out = torch.empty((R, hcap), dtype=torch.int64, device=dev)
    valid = torch.empty((R, hcap), dtype=torch.bool, device=dev)
    n_unique = torch.empty(R, dtype=torch.int32, device=dev)
    n_emit = torch.empty_like(n_unique)
    scratch = None
    if Wb > REG_SORT_MAX:
        scratch = torch.empty((R, Wb), dtype=torch.int64, device=dev)
    err = cuda_build.lib().launch_dedup(
        kmer.data_ptr(), emit.data_ptr(), R, L, hcap, Wb,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        valid.data_ptr(), n_unique.data_ptr(), n_emit.data_ptr(),
        cuda_build.stream_of(kmer))
    cuda_build.check(err, "launch_dedup")
    if R:
        cuda_build.count_launch(dedup_fused)
    return out, valid, n_unique, n_emit


dedup_fused.LAUNCHES = 0


def sort_pairs_plain(hi: torch.Tensor, lo: torch.Tensor):
    """Plain PyTorch twin of K4: the rows of (hi, lo) sorted as uint64
    keys (hi << 32) | lo."""
    return split32(usort_rows(join32(hi, lo)))


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor):
    """K4 on a CUDA tensor, its plain twin on a CPU tensor."""
    if hi.device.type == "cpu":
        return sort_pairs_plain(hi, lo)
    if hi.device.type != "cuda":
        raise ValueError(f"sort_pairs: unsupported device {hi.device}")
    if (hi.dtype != torch.int32 or lo.dtype != torch.int32 or hi.dim() != 2
            or lo.shape != hi.shape or lo.device != hi.device):
        raise ValueError("sort_pairs: hi and lo must be int32 [R, W] on one "
                         "device")
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("sort_pairs: inputs must be contiguous")
    R, W = hi.shape
    Wp = _pow2(W)
    out_hi = torch.empty_like(hi)
    out_lo = torch.empty_like(lo)
    scratch = None
    if Wp > REG_SORT_MAX:  # the merge passes' ping-pong
        scratch = torch.empty((2, R, Wp), dtype=torch.int64, device=hi.device)
    err = cuda_build.lib().launch_sort_pairs(
        hi.data_ptr(), lo.data_ptr(), R, W, Wp,
        None if scratch is None else scratch.data_ptr(), out_hi.data_ptr(),
        out_lo.data_ptr(), cuda_build.stream_of(hi))
    cuda_build.check(err, "launch_sort_pairs")
    if R and W:
        cuda_build.count_launch(sort_pairs)
    return out_hi, out_lo


sort_pairs.LAUNCHES = 0


def dedup_pairs(kmer: torch.Tensor, emit: torch.Tensor, hcap: int):
    """``dedup_kmers`` with its row sort done by ``sort_pairs`` (K4 on a
    CUDA tensor).  It sorts the whole masked row where the JAX package
    sorts its lossless block compaction; the first hcap slots are the
    same."""
    return dedup_kmers(kmer, emit, hcap,
                       sort_rows=lambda v: join32(*sort_pairs(*split32(v))))


def unique_pairs_plain(hi: torch.Tensor, lo: torch.Tensor,
                       n_valid: torch.Tensor):
    """Plain PyTorch twin of K6: (hi, lo int32 [R, W] where valid, 0
    elsewhere; valid bool [R, W], the slots j < n_valid[r] whose key
    differs from slot j - 1's; n_unique int32 [R]) of rows sorted as
    uint64 keys."""
    key = join32(hi, lo)
    j = torch.arange(key.shape[1], device=key.device)
    prev = torch.cat([key[:, :1], key[:, :-1]], dim=1)
    valid = (j < n_valid.to(torch.int64)[:, None]) & ((j == 0) | (key != prev))
    zero = torch.zeros_like(hi)
    return (torch.where(valid, hi, zero), torch.where(valid, lo, zero), valid,
            valid.sum(dim=1, dtype=torch.int32))


def unique_pairs(hi: torch.Tensor, lo: torch.Tensor, n_valid: torch.Tensor):
    """K6 on a CUDA tensor, its plain twin on a CPU tensor."""
    if hi.device.type == "cpu":
        return unique_pairs_plain(hi, lo, n_valid)
    if hi.device.type != "cuda":
        raise ValueError(f"unique_pairs: unsupported device {hi.device}")
    if (hi.dtype != torch.int32 or lo.dtype != torch.int32 or hi.dim() != 2
            or lo.shape != hi.shape or lo.device != hi.device):
        raise ValueError("unique_pairs: hi and lo must be int32 [R, W] on "
                         "one device")
    R, W = hi.shape
    if (n_valid.dtype != torch.int32 or n_valid.shape != (R,)
            or n_valid.device != hi.device):
        raise ValueError("unique_pairs: n_valid must be int32 [R] on the "
                         "rows' device")
    if not all(x.is_contiguous() for x in (hi, lo, n_valid)):
        raise ValueError("unique_pairs: inputs must be contiguous")
    if R > 65535:
        raise ValueError(f"unique_pairs: {R} rows, past the grid's 65,535")
    out_hi = torch.empty_like(hi)
    out_lo = torch.empty_like(lo)
    valid = torch.empty((R, W), dtype=torch.bool, device=hi.device)
    n_unique = torch.empty(R, dtype=torch.int32, device=hi.device)
    err = cuda_build.lib().launch_unique_pairs(
        hi.data_ptr(), lo.data_ptr(), n_valid.data_ptr(), R, W,
        out_hi.data_ptr(), out_lo.data_ptr(), valid.data_ptr(),
        n_unique.data_ptr(), cuda_build.stream_of(hi))
    cuda_build.check(err, "launch_unique_pairs")
    if R and W:
        cuda_build.count_launch(unique_pairs)
    return out_hi, out_lo, valid, n_unique


unique_pairs.LAUNCHES = 0


def union_rows(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
               pieces: int):
    """K4's input of ``union_pieces``: (hi, lo int32 [R, pieces * hcap],
    each read's pieces side by side, the valid hashes kept and every
    other slot the all-ones sentinel; n_valid int32 [R])."""
    rows, hcap = hi.shape
    R = rows // pieces
    sent = torch.full_like(hi, -1)
    return (torch.where(valid, hi, sent).reshape(R, pieces * hcap),
            torch.where(valid, lo, sent).reshape(R, pieces * hcap),
            valid.reshape(R, pieces * hcap).sum(dim=1, dtype=torch.int32))


def union_pieces(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                 n_emit: torch.Tensor, pieces: int):
    """The reads' hashes from their pieces' (K1's piece rows: hi, lo,
    valid [R * pieces, hcap], n_emit [R * pieces]): (hi, lo, valid
    [R, pieces * hcap] in ascending hash order, each value once; n_unique
    int32 [R], the distinct hashes; n_emit int32 [R], the sum of the
    pieces' owned emissions, or OVERFLOW where a piece emitted more than
    its hcap slots hold, which sends the read to the host oracle).  K4
    and K6 on CUDA tensors, their twins on CPU tensors."""
    hcap = hi.shape[1]
    h, lo_, n_valid = union_rows(hi, lo, valid, pieces)
    out_hi, out_lo, out_valid, n_unique = unique_pairs(*sort_pairs(h, lo_),
                                                       n_valid)
    ne = n_emit.reshape(h.shape[0], pieces)
    n = torch.where((ne > hcap).any(dim=1), OVERFLOW,
                    ne.sum(dim=1, dtype=torch.int32))
    return out_hi, out_lo, out_valid, n_unique, n.to(torch.int32)
