// K4: row-wise ascending lexicographic sort of (hi, lo) u32 pairs.
//
// Replaces the TPU kernel taxor_tpu/device/pallas_sort.py:62 _sort_kernel
// (launched by sort_pairs, pallas_call at :184), which ran the bitonic
// network over a [rows, W] VMEM tile.  Here each row's pairs become u64
// keys (hi << 32) | lo, padded with the all-ones sentinel to Wp, a power
// of two; equal keys are indistinguishable, so the sort needs no
// stability.  Two routes, by Wp:
//   - Wp <= 16,384: one block a row, the register network of regsort.cuh
//     (sort_pairs_kernel), E = 16 keys a thread (32 at Wp = 16,384), Wp/E
//     threads.  Register 4c + q of thread t takes pair (c*Ta + t)*4 + q
//     of the row: a warp's 16-byte loads of hi and of lo are neighbours
//     (any placement of the keys sorts alike), all issued before the
//     first key is formed (word by word where W is no multiple of 4:
//     the same loop, compiled apart, as a run-time test in it cost 10%).
//     The row sorts in registers; the first W keys go back, split into
//     hi and lo, through one more round trip in shared memory, so that
//     a warp's 16-byte stores are neighbours too
//     (writing thread t's sorted pairs t*E .. from its registers spread
//     a warp's stores 4E bytes apart: on the H100 0.048 against
//     0.026 ms for the loads and stores alone, PERF.md §6).
//   - Wp > 16,384: the merge route of sort_merge.cu: the same network
//     sorts each chunk of 16,384 keys into a scratch row, then merge-path
//     passes with many blocks a row merge the sorted runs.
// The register route's kernel is pairsort.cuh's, which both sources
// include.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6
// has the runs).  Its bound (chip_smoke.py phase 10) is one read and one
// write of 8 bytes a pair: 0.0200 ms at [512, 8,192].  The shared-memory
// network before this design took 91 passes over 8,192 keys a row, each
// reading and writing 128 KB of shared memory with a barrier: 0.275 ms.
// This one takes ~0.125 ms on the device, and what holds it is moving
// keys between threads, not the bytes: a row's 35 shuffle strides issue
// 17,920 warp shuffles (at one a clock an SM, ~35 us over the 3.9 rows
// an SM takes), its 9 round trips through shared memory (8 for the
// strides across warps, 1 out) 1.1 MB, and with 64 registers a thread
// two 512-thread blocks share an SM, in step, so their loads and stores
// (0.026 ms alone) barely overlap the sort.  Taking out the shuffle
// strides, the transposes or the register strides (wrong results, for
// the count) took 0.054, 0.027 and 0.036 ms off; E = 32 on 256 threads
// was slower (0.165 ms a call against 0.142).

#include "pairsort.cuh"

// The merge route (sort_merge.cu).
extern "C" int launch_sort_merge(const void* hi, const void* lo, int R,
                                 int W, int Wp, void* scratch, void* out_hi,
                                 void* out_lo, void* stream);

// scratch: two [R, Wp] u64 rows a read where Wp > 16,384 (the merge
// route's ping-pong), else null.
extern "C" int launch_sort_pairs(const void* hi, const void* lo, int R,
                                 int W, int Wp, void* scratch, void* out_hi,
                                 void* out_lo, void* stream) {
  if (R == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (Wp > 16384)
    return launch_sort_merge(hi, lo, R, W, Wp, scratch, out_hi, out_lo,
                             stream);
  if (Wp <= 8192)
    return launch_registers<16, false>(hi, lo, R, W, Wp, 1, out_hi, out_lo,
                                       nullptr, s);
  return launch_registers<32, false>(hi, lo, R, W, Wp, 1, out_hi, out_lo,
                                     nullptr, s);
}
