"""Syncmer extraction + dedup + wyhash: CUDA kernel K1 and its plain twin.

Counterpart of ``taxor_tpu/device/pallas_extract.py`` (the Pallas
``_extract_kernel`` with the ``pallas_sort._bitonic_body`` network).
The kernel (``csrc/extract.cu``) runs the reference's exact stateful
tracker, so it needs neither the TPU kernel's tie flag nor the tie-rescue
sub-batch of ``device/e2e.py``: n_emit is always the true count.

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

``syncmer_track`` is the first kernel of the split engine
(device/e2e.USE_FUSED_EXTRACT = False): the same tracker, writing the
per-position contract of ``syncmer_kmers`` (canonical k-mer int64 [R, L]
and emission mask bool [R, L]) for the dedup kernel K3 (device/sort.py).
"""

from __future__ import annotations

import torch

from ..hash.device_syncmer import dedup_kmers, max_emissions, syncmer_kmers
from ..utils.u64 import split32, wyhash64
from . import cuda_build

# dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 227 * 1024


def sort_width(L: int, k: int, s: int, t: int) -> int:
    """Power-of-two sort-buffer width covering every possible emission."""
    return 1 << max(0, max_emissions(L, k, s, t) - 1).bit_length()


def hashes_of_kmers(srt: torch.Tensor, valid: torch.Tensor):
    """(hi, lo) int32 bit patterns of wyhash64 of the sorted k-mers, 0
    where a slot holds no first occurrence: K1's hash output."""
    return split32(torch.where(valid, wyhash64(srt), torch.zeros_like(srt)))


def syncmer_hashes_plain(packed, lengths, k: int, s: int, t: int,
                         hcap: int):
    """Plain PyTorch twin of K1 (same contract)."""
    kmer, emit = syncmer_kmers(packed, lengths, k, s, t)
    srt, valid, n_unique, n_emit = dedup_kmers(kmer, emit, hcap)
    return (*hashes_of_kmers(srt, valid), valid, n_unique, n_emit)


def _check_reads(name: str, packed: torch.Tensor, lengths: torch.Tensor,
                 k: int, s: int, t: int) -> tuple[int, int]:
    """Validates a kernel's packed reads and scheme; returns (R, L)."""
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
    if not (2 <= s <= 15 and s < k <= 32 and 1 <= t <= k - s + 1):
        raise ValueError(f"{name}: unsupported scheme k={k} s={s} t={t}")
    return R, L


def syncmer_hashes(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                   s: int, t: int, hcap: int):
    """K1 on a CUDA tensor, its plain twin on a CPU tensor."""
    if packed.device.type == "cpu":
        return syncmer_hashes_plain(packed, lengths, k, s, t, hcap)
    R, L = _check_reads("syncmer_hashes", packed, lengths, k, s, t)
    if hcap <= 0:
        raise ValueError(f"syncmer_hashes: hcap must be positive, not {hcap}")
    W = sort_width(L, k, s, t)
    dev = packed.device
    hi = torch.empty((R, hcap), dtype=torch.int32, device=dev)
    lo = torch.empty_like(hi)
    valid = torch.empty((R, hcap), dtype=torch.bool, device=dev)
    n_unique = torch.empty(R, dtype=torch.int32, device=dev)
    n_emit = torch.empty_like(n_unique)
    scratch = None
    if L // 4 + 144 + 8 * W > SMEM_LIMIT:  # csrc/extract.cu header_bytes
        scratch = torch.empty((R, W), dtype=torch.int64, device=dev)
    lib = cuda_build.lib()
    err = lib.launch_syncmer_extract(
        packed.data_ptr(), lengths.data_ptr(), R, L, k, s, t, hcap, W,
        None if scratch is None else scratch.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), n_unique.data_ptr(),
        n_emit.data_ptr(), cuda_build.stream_of(packed))
    cuda_build.check(err, "launch_syncmer_extract")
    if R:
        cuda_build.count_launch(syncmer_hashes)
    return hi, lo, valid, n_unique, n_emit


syncmer_hashes.LAUNCHES = 0


def syncmer_track(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                  s: int, t: int):
    """(kmer int64 [R, L], emit bool [R, L]) of ``syncmer_kmers``: the
    tracker kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if packed.device.type == "cpu":
        return syncmer_kmers(packed, lengths, k, s, t)
    R, L = _check_reads("syncmer_track", packed, lengths, k, s, t)
    kmer = torch.empty((R, L), dtype=torch.int64, device=packed.device)
    emit = torch.empty((R, L), dtype=torch.bool, device=packed.device)
    err = cuda_build.lib().launch_syncmer_track(
        packed.data_ptr(), lengths.data_ptr(), R, L, k, s, t,
        kmer.data_ptr(), emit.data_ptr(), cuda_build.stream_of(packed))
    cuda_build.check(err, "launch_syncmer_track")
    if R:
        cuda_build.count_launch(syncmer_track)
    return kmer, emit


syncmer_track.LAUNCHES = 0
