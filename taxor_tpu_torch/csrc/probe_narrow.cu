// K2n: the probe/count of narrow tables (Bpad <= 512 bins) over a stack of
// G subgroup tables with a per-(g, r) activity mask, summed in the kernel
// into each subgroup's runs of bins:
//
// out[j, r] = active[g, r] * sum over b in [run_s[j], run_e[j]) of
//             #{ valid h in read r :
//                T_g[p0(h), b] ^ T_g[p1(h), b] ^ T_g[p2(h), b] == fprint(h) }
//
// for the runs j in [run_off[g], run_off[g + 1]) of subgroup g (a CSR:
// the runs of one subgroup are contiguous; run_s / run_e are columns of
// its table), int32 [n_runs, R].  Without runs (run_off null) every bin
// is a run of one and out is the dense int32 [G, R, Bpad] counts of K2's
// contract (the flat fused step and the probe checks).
//
// Replaces taxor_tpu/device/pallas_probe.py _kernel_repl (launched by
// _probe_call_repl) together with what follows it in the JAX descent
// (taxor_tpu/device/e2e.py, the lax.scan body over a stacked group): the
// counts of one subgroup, then their HIGHEST-precision one-hot matmul into
// run sums.  The TPU probed every (subgroup, read) pair with zero trip
// counts for inactive reads; its replicated rows and sublane layout are
// not reproduced.
//
// The grid is (subgroup g, chunk of reads), never (read, subgroup): a
// descent group is mostly inactive (0.43% of its pairs in the widest
// group of the hierarchical cell).  A block walks its chunk in rounds of
// kThreads reads: each warp ballots its reads' active bits and the block
// compacts the active reads into a list in shared memory (no host sync).
// The inactive reads of the round get their zeros (coalesced along the
// reads of one run), the active ones are probed.  Two modes, chosen by
// the shape and the card's shared memory a block alone
// (probe_narrow_mode):
//
//  - smem: the subgroup's whole [S, Bpad] table and the block's scratch
//    fit one block's dynamic shared memory (S <= 411 at 512 bins on an
//    H100, the widest group's 216 x 512 = 110,592 bytes).  A block with
//    an active read copies the table once with cp.async (a block with
//    none loads nothing) and takes one active read at a time, its slots
//    spread over the warps: warp w takes the rounds w, w + kWarps, ... of
//    32 slots, the valid ones compacted by ballot into the warp's
//    staging, lane = hash-lane x CHp + chunk (a row is CH = Bpad / 16
//    chunks of 16 bytes, CHp the power of two >= CH; lanes past CH only
//    join the shuffles), so a 512-byte row is one conflict-free pass of
//    the warp and a hash costs 3 shared loads a lane.  Zero bytes of the
//    XOR add into four packed byte counters a lane, flushed into 16 int32
//    counts before a byte can reach 256; xor shuffles sum the hash-lanes,
//    as in probe_slab.cu, and shared memory the warps.
//  - rows: the table stays in L2/HBM (the 64-bin root, 31.8 MB; the
//    [8, 10548, 512] level, 5.4 MB a table; the flat narrow tables).  The
//    whole block probes one active read, and a chunk is one read (as
//    many as gridDim.y allows), as K2n did before:
//    stage_probes stages kTile hashes, HL hash-lanes x WL word-lanes read
//    the rows as 32-bit words (word-lane w owns bins 4w..4w+3), int32
//    counts summed over the hash-lanes through shared memory.
//
// Then the runs: one warp turns the read's per-bin counts into an
// exclusive prefix over the bins in shared memory (P[k] = sum of bins <
// k) and run j's sum is P[run_e] - P[run_s].  Per-bin counts are exact,
// a sum is at most hcap x 512 < 2^31, nothing is summed by atomics, so
// the result is deterministic.  Invalid slots are never staged, so a
// fingerprint-0 slot never counts.
//
// What bounds it on the H100.  smem mode: the table copies (S x Bpad
// bytes for each block that has an active read) and 3 x Bpad bytes of
// shared-memory rows a valid hash of an active read.  rows mode: 3 rows x
// Bpad bytes a valid hash from L2 and their dependent load latency, which
// the hash-lanes hide.  Both: the zeros of the inactive pairs, 4 x
// n_runs x R bytes in all (the dense [G, R, Bpad] counts and their int64
// cumulative sum, which the descent took before, are gone).

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "probe_stage.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps; also the reads of one round
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // hashes staged per round (rows mode)
constexpr int kMaxBpad = 512;
constexpr int kFlush = 255;  // a lane's hashes between flushes (smem mode)
constexpr unsigned kAll = 0xFFFFFFFFu;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Dynamic shared memory of a block, in order: the table (smem mode), the
// control words (the round's ballots and its list of active reads), then
// the mode's scratch: rows mode the hash-lanes' partial counts (kThreads
// int4), the staged probes (4 x kTile int), stage_probes' warp counts and
// one prefix P [Bpad + 1]; smem mode, for each warp, 32 staged probes
// (uint4) and its own P (its partial counts; warp 0's takes the sum).
constexpr size_t kCtrlBytes = align16(4 * (kWarps + kThreads));

__host__ __device__ inline size_t pref_bytes(int Bpad) {
  return align16(4 * ((size_t)Bpad + 1));
}

__host__ __device__ inline size_t warp_bytes(int Bpad) {
  return 32 * 16 + pref_bytes(Bpad);
}

__host__ __device__ inline size_t table_bytes(bool smem, int S, int Bpad) {
  return smem ? align16((size_t)S * Bpad) : 0;
}

size_t block_bytes(bool smem, int S, int Bpad) {
  const size_t scratch =
      smem ? kWarps * warp_bytes(Bpad)
           : 16 * kThreads + 16 * kTile + align16(4 * kWarps) +
                 pref_bytes(Bpad);
  return table_bytes(smem, S, Bpad) + kCtrlBytes + scratch;
}

__device__ __forceinline__ int log2_ceil(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

// What a block knows of its subgroup's output.
struct Out {
  int32_t* base;        // out + run_off[g] * R (dense: g * R * Bpad)
  const int64_t* s;     // the subgroup's runs (null: one-bin runs)
  const int64_t* e;
  int nj;               // its runs (dense: Bpad)
  int R;
};

// One warp: P[1..Bpad] holds a read's per-bin counts; makes P the
// exclusive prefix over the bins (P[0] = 0, P[k] = bins < k).
__device__ __forceinline__ void warp_prefix(int* P, int Bpad, int lane) {
  const int seg = (Bpad + 31) >> 5;  // bins a lane, <= 16
  const int a = min(Bpad, lane * seg), e = min(Bpad, a + seg);
  int s = 0;
  for (int k = a; k < e; ++k) s += P[1 + k];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += t;
  }
  int run = incl - s;
  for (int k = a; k < e; ++k) {
    run += P[1 + k];
    P[1 + k] = run;
  }
  if (lane == 0) P[0] = 0;
}

// Run sums of read r from its prefix P, by `n` threads numbered t.
__device__ __forceinline__ void write_runs(const Out& o, const int* P, int r,
                                           int t, int n) {
  for (int j = t; j < o.nj; j += n)
    o.base[(size_t)j * o.R + r] = P[o.e[j]] - P[o.s[j]];
}

// smem mode: the block probes active read r against the table in shared
// memory, warp w taking the read's rounds of 32 slots w, w + kWarps, ...,
// and writes its run sums (or, dense, its counts).  Each warp leaves its
// partial counts in its own P; warp 0's P takes their sum.
__device__ void smem_read(const uint8_t* __restrict__ table, int Bpad,
                          const int32_t* __restrict__ hi,
                          const int32_t* __restrict__ lo,
                          const uint8_t* __restrict__ valid, int H, int r,
                          uint64_t seed, uint32_t bl, uint8_t* scratch,
                          const Out& o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t wb = warp_bytes(Bpad);
  uint4* staged = reinterpret_cast<uint4*>(scratch + warp * wb);
  int* Pw = reinterpret_cast<int*>(scratch + warp * wb + 32 * 16);
  int* P = reinterpret_cast<int*>(scratch + 32 * 16);  // warp 0's
  const int CH = Bpad >> 4, sh = log2_ceil(CH), HL = 32 >> sh;
  const int c = lane & ((1 << sh) - 1), hl = lane >> sh;
  const uint8_t* mine = table + 16 * c;
  const size_t row0 = (size_t)r * H;
  int cnt[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) cnt[j] = 0;
  uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0;
  int m = 0;  // the most hashes a lane counted since its last flush
  for (int h0 = 32 * warp; h0 < H; h0 += 32 * kWarps) {
    const int j = h0 + lane;
    const bool v = j < H && valid[row0 + j];
    const unsigned b = __ballot_sync(kAll, v);
    if (v) {
      const uint64_t key = ((uint64_t)(uint32_t)hi[row0 + j] << 32) |
                           (uint32_t)lo[row0 + j];
      uint32_t p0, p1, p2, fp;
      taxor::probe_slots(key, seed, bl, p0, p1, p2, fp);
      staged[__popc(b & ((1u << lane) - 1))] =
          make_uint4(p0 * Bpad, p1 * Bpad, p2 * Bpad, fp * 0x01010101u);
    }
    __syncwarp();
    const int n = __popc(b);
    if (c < CH) {
#pragma unroll 4
      for (int e = hl; e < n; e += HL) {
        const uint4 q = staged[e];
        const uint4 x = *reinterpret_cast<const uint4*>(mine + q.x);
        const uint4 y = *reinterpret_cast<const uint4*>(mine + q.y);
        const uint4 z = *reinterpret_cast<const uint4*>(mine + q.z);
        k0 += taxor::zero_bytes(x.x ^ y.x ^ z.x ^ q.w);
        k1 += taxor::zero_bytes(x.y ^ y.y ^ z.y ^ q.w);
        k2 += taxor::zero_bytes(x.z ^ y.z ^ z.z ^ q.w);
        k3 += taxor::zero_bytes(x.w ^ y.w ^ z.w ^ q.w);
      }
    }
    m += (n + HL - 1) / HL;  // warp-uniform
    if (m > kFlush - 32) {   // the next round adds at most 32
      taxor::flush_bytes(cnt, k0);
      taxor::flush_bytes(cnt + 4, k1);
      taxor::flush_bytes(cnt + 8, k2);
      taxor::flush_bytes(cnt + 12, k3);
      k0 = k1 = k2 = k3 = 0;
      m = 0;
    }
    __syncwarp();  // staged is rewritten next round
  }
  taxor::flush_bytes(cnt, k0);
  taxor::flush_bytes(cnt + 4, k1);
  taxor::flush_bytes(cnt + 8, k2);
  taxor::flush_bytes(cnt + 12, k3);
  for (int off = 1 << sh; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < 16; ++q)
      cnt[q] += __shfl_xor_sync(kAll, cnt[q], off);
  if (hl == 0 && c < CH) {
#pragma unroll
    for (int q = 0; q < 16; ++q) Pw[1 + 16 * c + q] = cnt[q];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Bpad; t += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w)
      sum += reinterpret_cast<const int*>(scratch + w * wb + 32 * 16)[1 + t];
    P[1 + t] = sum;
  }
  __syncthreads();
  if (o.s == nullptr) {  // dense: the read's counts
    for (int t = threadIdx.x; t < Bpad; t += kThreads)
      o.base[(size_t)r * Bpad + t] = P[1 + t];
  } else {
    if (warp == 0) warp_prefix(P, Bpad, lane);
    __syncthreads();
    write_runs(o, P, r, threadIdx.x, kThreads);
  }
  __syncthreads();  // the scratch is rewritten by the next read
}

// rows mode: the whole block probes active read r with the table's rows
// read from L2/HBM and writes its run sums (or, dense, its counts).
__device__ void rows_read(const uint8_t* __restrict__ table, int Bpad,
                          const int32_t* __restrict__ hi,
                          const int32_t* __restrict__ lo,
                          const uint8_t* __restrict__ valid, int H, int r,
                          uint64_t seed, uint32_t bl, uint8_t* scratch,
                          const Out& o) {
  int4* part = reinterpret_cast<int4*>(scratch);
  int* p0 = reinterpret_cast<int*>(scratch + 16 * kThreads);
  int* p1 = p0 + kTile;
  int* p2 = p1 + kTile;
  uint32_t* f4 = reinterpret_cast<uint32_t*>(p2 + kTile);
  int* warp_n = reinterpret_cast<int*>(f4 + kTile);
  int* P = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(warp_n) +
                                  align16(4 * kWarps));
  const uint32_t* words = reinterpret_cast<const uint32_t*>(table);
  const int B4 = Bpad >> 2, sh = log2_ceil(B4), HL = kThreads >> sh;
  const int word = threadIdx.x & ((1 << sh) - 1), hlane = threadIdx.x >> sh;
  const size_t row0 = (size_t)r * H;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  int h = 0;  // next slot of the read to stage
  while (h < H) {
    const int n = taxor::stage_probes<kThreads, kTile>(
        hi, lo, valid, row0, H, h, seed, bl, p0, p1, p2, f4, warp_n);
    if (word < B4) {
#pragma unroll 4
      for (int e = hlane; e < n; e += HL) {
        const uint32_t x = words[(size_t)p0[e] * B4 + word] ^
                           words[(size_t)p1[e] * B4 + word] ^
                           words[(size_t)p2[e] * B4 + word] ^ f4[e];
        c0 += (x & 0xFFu) == 0;
        c1 += (x & 0xFF00u) == 0;
        c2 += (x & 0xFF0000u) == 0;
        c3 += (x & 0xFF000000u) == 0;
      }
    }
    __syncthreads();  // the tile is restaged next round
  }
  part[threadIdx.x] = make_int4(c0, c1, c2, c3);
  __syncthreads();
  if (threadIdx.x < B4) {  // threadIdx.x < B4 <= WL: hash-lane 0
    int4 s = part[threadIdx.x];
    for (int l = 1; l < HL; ++l) {
      const int4 q = part[(l << sh) + threadIdx.x];
      s.x += q.x;
      s.y += q.y;
      s.z += q.z;
      s.w += q.w;
    }
    if (o.s == nullptr) {
      reinterpret_cast<int4*>(o.base + (size_t)r * Bpad)[threadIdx.x] = s;
    } else {
      int* d = P + 1 + 4 * threadIdx.x;
      d[0] = s.x;
      d[1] = s.y;
      d[2] = s.z;
      d[3] = s.w;
    }
  }
  __syncthreads();
  if (o.s != nullptr) {
    if (threadIdx.x < 32) warp_prefix(P, Bpad, threadIdx.x);
    __syncthreads();
    write_runs(o, P, r, threadIdx.x, kThreads);
    __syncthreads();  // part and P are rewritten by the next read
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) probe_narrow_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, int R, int H,
    const uint8_t* __restrict__ tables, int S, int Bpad,
    const uint8_t* __restrict__ active, uint64_t seed, uint32_t bl,
    const int64_t* __restrict__ run_off, const int64_t* __restrict__ run_s,
    const int64_t* __restrict__ run_e, int reads_per_block,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.x;
  const size_t tb = table_bytes(kSmem, S, Bpad);
  unsigned* ballots = reinterpret_cast<unsigned*>(smem + tb);
  int* list = reinterpret_cast<int*>(ballots + kWarps);
  uint8_t* scratch = smem + tb + kCtrlBytes;
  const uint8_t* table = tables + (size_t)g * S * Bpad;
  Out o;
  o.R = R;
  if (run_off == nullptr) {
    o.base = out + (size_t)g * R * Bpad;
    o.s = o.e = nullptr;
    o.nj = Bpad;
  } else {
    const int64_t j0 = run_off[g];
    o.base = out + (size_t)j0 * R;
    o.s = run_s + j0;
    o.e = run_e + j0;
    o.nj = (int)(run_off[g + 1] - j0);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * reads_per_block;
  const int r1 = min(R, r0 + reads_per_block);
  bool loaded = false;
  for (int base = r0; base < r1; base += kThreads) {
    const int n = min(kThreads, r1 - base);
    const int r = base + threadIdx.x;
    const bool a = threadIdx.x < n &&
                   (active == nullptr || active[(size_t)g * R + r]);
    const unsigned b = __ballot_sync(kAll, a);
    if (lane == 0) ballots[warp] = b;
    __syncthreads();
    int off = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      const int k = __popc(ballots[q]);
      off += q < warp ? k : 0;
      total += k;
    }
    if (a) list[off + __popc(b & ((1u << lane) - 1))] = r;
    if (total < n) {  // zeros for the round's inactive reads
      if (o.s == nullptr) {
        const int B4 = Bpad >> 2;
        for (int i = threadIdx.x; i < n * B4; i += kThreads) {
          const int t = i / B4;
          if (!((ballots[t >> 5] >> (t & 31)) & 1u))
            reinterpret_cast<int4*>(o.base + (size_t)(base + t) * Bpad)
                [i - t * B4] = make_int4(0, 0, 0, 0);
        }
      } else {
        for (int i = threadIdx.x; i < n * o.nj; i += kThreads) {
          const int j = i / n, t = i - j * n;
          if (!((ballots[t >> 5] >> (t & 31)) & 1u))
            o.base[(size_t)j * R + base + t] = 0;
        }
      }
    }
    if (kSmem && total > 0 && !loaded) {  // block-uniform
      const int n16 = (int)(((size_t)S * Bpad) >> 4);
      for (int i = threadIdx.x; i < n16; i += kThreads)
        taxor::cp_async16(smem + 16 * i, table + 16 * (size_t)i);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                       : "memory");
      loaded = true;
    }
    __syncthreads();  // the list and the table are in place
    for (int i = 0; i < total; ++i) {
      if (kSmem)
        smem_read(smem, Bpad, hi, lo, valid, H, list[i], seed, bl, scratch,
                  o);
      else
        rows_read(table, Bpad, hi, lo, valid, H, list[i], seed, bl, scratch,
                  o);
    }
    __syncthreads();  // the ballots and the list are rewritten next round
  }
}

// What a launch of one kernel needs of the card, asked once for each
// (device, mode, S, Bpad) and kept: the host's launch path sets the time
// of a small group's launch.  optin: the device's opt-in shared memory a
// block, to which the kernel's dynamic limit is raised once (so that no
// later shape finds it lower); wave: the blocks of one wave (smem mode).
struct Plan {
  int optin;
  long wave;
};

std::mutex plan_mu;
std::map<std::tuple<int, bool, int, int>, Plan> plans;

template <bool kSmem>
cudaError_t plan_of(int S, int Bpad, Plan& plan) {
  const auto kern = probe_narrow_kernel<kSmem>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, kSmem, S, Bpad);
  std::lock_guard<std::mutex> lock(plan_mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    plan = it->second;
    return cudaSuccess;
  }
  int optin = 0, sms = 0, occ = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = block_bytes(kSmem, S, Bpad);
  if (err == cudaSuccess && kSmem && smem <= (size_t)optin)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  plan.optin = optin;
  plan.wave = (long)sms * (occ > 0 ? occ : 1);
  plans[key] = plan;
  return cudaSuccess;
}

template <bool kSmem>
cudaError_t launch(const int32_t* hi, const int32_t* lo, const uint8_t* valid,
                   int R, int H, const uint8_t* tables, int G, int S,
                   int Bpad, const uint8_t* active, uint64_t seed,
                   uint32_t bl, const int64_t* run_off, const int64_t* run_s,
                   const int64_t* run_e, int32_t* out, cudaStream_t stream) {
  Plan plan;
  cudaError_t err = plan_of<kSmem>(S, Bpad, plan);
  if (err != cudaSuccess) return err;
  const size_t smem = block_bytes(kSmem, S, Bpad);
  if (smem > (size_t)plan.optin) return cudaErrorInvalidValue;
  // chunks of reads a subgroup.  rows mode: one read a block (as many as
  // gridDim.y allows), as K2n launched before, so that the scheduler
  // spreads the reads' uneven probe work over the SMs and no block walks
  // its reads one after another.  smem mode: as many as fill one wave of
  // blocks, each of at least kWarps reads (each copies the table).
  long chunks = R < 65535 ? R : 65535;
  if (kSmem) {
    const long most = (R + kWarps - 1) / kWarps;
    chunks = (plan.wave + G - 1) / G;
    chunks = chunks < 1 ? 1 : chunks > most ? most : chunks;
  }
  const int per = (int)((R + chunks - 1) / chunks);
  const dim3 grid(G, (R + per - 1) / per);  // gridDim.y <= 65535
  probe_narrow_kernel<kSmem><<<grid, kThreads, smem, stream>>>(
      hi, lo, valid, R, H, tables, S, Bpad, active, seed, bl, run_off, run_s,
      run_e, per, out);
  return cudaGetLastError();
}

}  // namespace

// K2n's mode for tables [S, Bpad] on CUDA device `device`: 1 (smem) where
// a whole table and the block's scratch fit one block's dynamic shared
// memory, else 0 (rows); -1 on a CUDA error.  A function of the shape and
// of the card alone.
extern "C" int probe_narrow_mode(int S, int Bpad, int device) {
  if (S <= 0 || Bpad <= 0 || Bpad > kMaxBpad || Bpad % 16) return 0;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return block_bytes(true, S, Bpad) <= (size_t)optin ? 1 : 0;
}

// tables: G contiguous uint8 [S, Bpad] tables, Bpad a multiple of 16 up to
// 512, 16-byte aligned; active: uint8 [G, R] or null (every read active);
// run_off int64 [G + 1], run_s / run_e int64 [n_runs] (columns of their
// subgroup's table): out int32 [n_runs, R]; run_off null: out int32
// [G, R, Bpad], the per-bin counts.  mode: 1 smem (refused where
// probe_narrow_mode says 0), 0 rows.
extern "C" int launch_probe_narrow(const void* hi, const void* lo,
                                   const void* valid, int R, int H,
                                   const void* tables, int G, int S, int Bpad,
                                   const void* active, uint64_t seed,
                                   uint32_t block_length, const void* run_off,
                                   const void* run_s, const void* run_e,
                                   int n_runs, int mode, void* out,
                                   void* stream) {
  if (Bpad <= 0 || Bpad > kMaxBpad || Bpad % 16 || S <= 0 ||
      reinterpret_cast<uintptr_t>(tables) % 16 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0 || G == 0 || (run_off != nullptr && n_runs == 0)) return 0;
  const auto* h = static_cast<const int32_t*>(hi);
  const auto* l = static_cast<const int32_t*>(lo);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* t = static_cast<const uint8_t*>(tables);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* ro = static_cast<const int64_t*>(run_off);
  const auto* rs = static_cast<const int64_t*>(run_s);
  const auto* re = static_cast<const int64_t*>(run_e);
  auto* o = static_cast<int32_t*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(mode == 1 ? launch<true>(h, l, v, R, H, t, G, S, Bpad, a,
                                        seed, block_length, ro, rs, re, o,
                                        st)
                         : launch<false>(h, l, v, R, H, t, G, S, Bpad, a,
                                         seed, block_length, ro, rs, re, o,
                                         st));
}
