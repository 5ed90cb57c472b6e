#!/usr/bin/env python3
"""Smoke test of taxor_tpu_torch on one CUDA GPU (built for the H100).

    python3 chip_smoke.py                 # full size, ~8 min on an H100
    python3 chip_smoke.py --genomes 600 --reads 512 --hier-genomes 200 \
        --minimizer-genomes 200 --hier-reads 512 \
        --atscale-reads 2048                    # quick start check
    python3 chip_smoke.py --only-routes   # the kernel build and phase 17

Phases (any failure exits non-zero):
  1. card and build: prints nvidia-smi's name and power limit, starts
     the background builds (below), builds
     the CUDA kernels from taxor_tpu_torch/csrc (the search's library and
     the diagnostic library of csrc/diag/, every nvcc started together)
     and times the build;
  2. K1 (syncmer extraction) against its plain twin, bit-exact, at every
     length bucket 256..32768 on random, homopolymer-run, tandem-repeat,
     N-containing and two-letter-alphabet reads, a read whose first
     window is tied and a homopolymer over the whole bucket, plus a gap-1
     scheme whose sort buffer spills to global memory; on the same reads
     the split engine's kernels
     (phase 9): syncmer_track against ``syncmer_kmers`` and K3 (dedup)
     against its twin with hcap above and below the emission count;
  3. the probe (K2, or K2n for tables of at most 512 bins) against its
     plain twin, bit-exact, at the flat geometries of the reference's
     five probe kernels, with invalid slots whose fingerprint is 0 and
     per-bin counts above 256; K2 through the variant its shape picks
     (the slab route where a bin slab of the table fits a block's shared
     memory, 16 bins or more, or a thin slab of 8 or 4 bins for reads of
     8,192 slots or more; else the rows route) and through every other
     variant that fits (the slab route at its widest fit, its split
     variant, and the rows route, forced); the slab and rows routes must
     each have been picked by a shape (reads of 2,048 slots take no thin
     slab) and a thin slab forced;
  4. the flat main path: a flat k=22/s=12 syncmer index of synthetic
     30 kb genomes built with ``taxor_tpu_torch.cli build``, ONT-like
     reads (log-normal lengths clipped to 500-30,000 bases, 4%
     substitutions) plus reads over L_CAP, searched with
     ``taxor_tpu_torch.cli search --engine device``; K1, K2's slab
     route, K4 and K6 must have launched, every read over L_CAP must have
     taken the fused step in pieces (``ROUTES['long_fused']``, none
     hashed on the host), and the TSV must equal ``--engine host`` byte
     for byte on a subset and the long reads; then the same search with
     the split engine (``device.e2e.USE_FUSED_EXTRACT = False``), whose
     TSV must equal the K1 TSV on every read, with syncmer_track, K3, K4
     and K6 launched and K1 not; then (4b) the long reads' routes timed;
  5. K1 and K2 timed against their twins at the flat path's shapes (K2
     through its slab and rows routes, with its valid hashes, row bytes
     and GB/s of rows, and through thin slabs of 8 and 4 bins and the
     split variant forced: the slab record's ``flat_forced``), and K1 on
     a batch tied in every window (its worst case);
  6. K2n and K2 over stacked tables (G = 1 and 8) with a mixed activity
     mask against their twin, bit-exact, at 16..512 bins (K2n, in both
     modes where its smem mode fits) and 4,096 bins (K2, through every
     variant), with fingerprint-0 slots, counts above 256 and a read
     inactive everywhere; K2 on a stack of two [30,000, 528] tables with
     a mask and reads of 8,192 slots (the thin slab of 4 bins its shape
     takes, and the split variant); then K2n's run sums
     (probe_run_sums_grouped)
     against their twin, bit-exact, in both modes, at G = 1, 8 and 72
     (tables of 216 slots like the widest descent group's), 16, 100 and
     512 bins, activity 0%, ~0.5%, 60% and 100%, one-bin runs, runs over
     many bins, a run over a whole subgroup, a subgroup without runs and
     run sums above 256, each call one K2n launch; and the run sums of
     1,000- and 4,096-bin groups, one K2 launch each (dense counts and
     their segment sums: a group past K2n's 512 bins);
  7. the hierarchical main path: the same recipe on an index of
     ``--hier-genomes`` genomes built with ``--layout auto --tmax 64`` (a
     64-bin root; **cut** from 8,192 genomes to 4,096 to make room for
     phase 15 in the time limit: it halves phase 7's build, ~165 s at
     8,192; phase 13a keeps 8,192 on data of its own); K1, the grouped
     probe (K2n in both modes:
     smem on stacked groups, rows on the root) must have launched, the
     reads over L_CAP the fused step in pieces and no probe the per-IXF
     traversal, the TSV must equal ``--engine host`` on a subset and the
     long reads, and 99% of the
     classified reads must name their source genome; then the split
     engine on the same reads, as in phase 4; then (7b) an index whose
     root has 529 technical bins (a hand-written layout, as the default
     --tmax gives roots past 512 bins), whose root group must take K2 and
     whose grouped step and per-IXF traversal on the card must equal the
     CPU twins; then (7c) the long reads' routes timed as in 4b;
  8. every group of one descent batch at the hierarchical path's L=8192
     (R=512) and L=4096 (R=1,024) buckets, with the descent's own
     activity masks: (a) the dense K2n counts [G, R, Bpad] and their
     int64 segment sums, what the descent took before K2n summed the
     runs, against (b) the run-sum launch, each as the descent calls it
     (cuda_ms) and on the device alone (tools/time_sort.device_ms: the
     launches queued behind a sleep kernel, so the host's gaps are not
     timed), each group's shape, active pairs, runs and mode logged;
     K2n's run sums timed against their twin on the root and the widest
     group, K2 (the variant each shape
     picks) on the root and the first stacked level;
  9. K4 (pair sort) against its twin, bit-exact, at W = 1, 2, 31, 100,
     128, 1024, 8192, 16384 (the register network at E = 16 and 32) and
     16,385, 32,768, 65,536, 100,000, 262,144, 524,288 and 1,048,576
     (the merge route: chunks of 16,384 sorted on the network, then
     merge-path passes; 2^20 keys the union of 32 pieces of a narrow
     syncmer scheme), with duplicated keys, keys with the top bit of hi set, keys
     equal to the sentinel, a row of equal keys and a row of sentinels;
     the merge route timed on random keys at [8, 262,144] and [4,
     524,288], a call and on the device alone, beside its twin and
     ``torch.sort`` (K4's record: ``merge_shapes``); K3 against its
     twin at every buffer of its register route (Wb = 256-16,384; rows
     of L = 1,000, no multiple of 16 bytes, take byte loads) and the
     global-scratch route (gap 1 at L = 32,768), on rows of 0, 1,
     31-33, 32E +- 1, Wb and Wb + 1 emissions (n_emit = 2**30), of
     all-equal k-mers and of k-mers equal to the sentinel; and,
     after phase 4, K3 against ``sort.dedup_pairs`` (K4) on the flat
     path's L=8192 reads.  Since the long reads take the fused step in
     pieces, K4 sorts their union on the main paths (phase 18 checks it
     at those widths, 16,384 keys on the register route and 262,144 on
     the merge route);
 10. syncmer_track, K3 and K4 timed against their twins, K4 against
     ``torch.sort`` of the combined key, and the split engine's
     extraction against K1, at the flat path's L=8192 bucket; K3 and K4
     also on the device alone (device_ms); syncmer_track also on phase
     5's batch tied in every window;
 11. the tools' four diagnostic kernels (csrc/diag/) against their plain
     twins, bit-exact: probe_bounds in its five modes and
     probe_experiment in both position layouts, 1, 2 and 4 reads a
     thread, 4, 8 and 16 ALU rounds and the position-word flood (K = 2,
     4, 8), at R=256 with reads of no hash and past their row of words,
     on the TPU tools' geometry (2,419 slots x 512 bins), the flat
     cell's table, a ragged last slab (100 bins), slabs of 16 bins
     (10,000 slots), a table past the shared memory (20,000 slots) and
     rows of words that 16-byte loads
     cannot take; each through the route its shape
     picks (ROUTES checked) and, where that is the slab route, through
     the rows route too; on tables where every hash hits every bin
     (counts up to 512 a read, and 2,048 on slabs of 128 bins); then
     extract_stage in all ten stages for the schemes STAGE_SCHEMES at
     every length bucket 256..32768 on phase 2's kinds of reads (its
     tied reads drive the walking thread's slide-outs), with its shared
     memory held to ``diag.stage_smem``; and window_shift for all 16
     phases and a reordered list with a repeat on the same reads' stream
     words, and on rows of L/16 - 3 words (no multiple of 4);
 12. the tooling path, with every launch count set to 0 just before it:
     ``tools.bench`` on its primary config (viral_flat_256) with its
     parity gate (twelve scheme/layout families, device TSV == host TSV;
     narrow_syncmer's reads must all fit its hash capacity),
     ``tools.probe_bounds``, ``tools.probe_experiments`` (its three
     experiment lists) and ``tools.profile_phases`` at the JAX tools'
     sizes (R=8192, H=512, nvalid=173; build_problem's 8,192 reads), and
     ``tools.debug_extract --stage all`` and ``tools.debug_min``, and
     ``cli prewarm`` and ``cli search --profile-trace`` on a small flat
     index (the trace's kernels on the card are counted); both probe
     tools must stay on their slab routes; then the four
     diagnostic kernels timed against their twins, the two probe
     diagnostics also on the device alone and through their rows route
     at the same shape, window_shift also on the device alone, and
     extract_stage in stages sf, chi, erm, emit and pre, pre on a batch
     tied in every window and on one read alone (its serial chain), each
     a call and on the device alone (the record's ``stages``).  Their
     records count the tooling path's launches (``launches_in``:
     "tools"), with phase 11's apart as ``check_launches``, and the two
     probe diagnostics' launches by route (``routes``,
     ``check_routes``); every parity family's device search must have
     taken the fused step (``parity_routes``);
 13. the minimiser and plain k-mer schemes (K5) on the card: (c) K5
     against its twin, bit-exact, at every length bucket 256..32768 on
     phase 2's kinds of reads for (k, window) = (20, 20), (20, 26),
     (18, 26) and (32, 40), without the FracMinHash keep and with the
     keeps of scalings 2, 3 and 1,000 (the twin followed by the keep as
     tensor ops); then at rows past K5's span of 32,768 positions (a
     cluster a span): the first bucket past L_CAP (65,504) and the ~1 Mb
     bucket (1,047,584), for (20, 20), (20, 26) and (32, 40) at scalings
     1 and 3, on reads with N runs, homopolymers and tandem repeats
     across every span boundary; (a) ``--minimizer-genomes`` genomes
     (8,192) and ``--hier-reads`` reads of phase 7's recipe, drawn apart from
     phase 7's, under the bench's hier_scaled_minimizer scheme whole
     (k = 20, --window-size 26, --scaling 3, --layout auto --tmax 64)
     searched with ``--engine device``: its fracminhash thresholds take
     the per-read descent (each read's hash count copied to the host
     after K5, its exact threshold computed there and uploaded), K5 and
     K2n must launch, every read must take the fused step, the 16 of 40
     kb ``long_fused`` (K5 on their whole bucket), none the host-hash
     route, and the TSV must equal
     ``--engine host`` on the first CHECK_READS reads and the long
     ones; the share of classified reads that name their source genome
     is logged.  All of its reads.  The share of active (subgroup, read)
     pairs must be below 1 and equal the share that a CPU walk of the
     same thresholds gives (``HIXF.walk``, the host oracle's C++ walk,
     on the host's hashes of every fused read; the ~3% of the reads
     that the scaled scheme leaves so few hashes that their threshold is
     0 walk every IXF); the same reads are searched again with the JAX
     step's descend-all mode forced (every pair active; no search path
     takes it), whose TSV must equal the per-read one on every read;
     both runs' walls, truncation fallbacks and the per-read mode's
     copy-and-threshold host seconds are logged; (b) plain k-mers (k =
     window = 20) on a flat index of 1,024 genomes (K5 at w' = 1, K2
     on a table of ~40,000
     slots: its rows route) with 4,096 reads plus the long ones (data
     of its own, as (a)'s), checked
     as (a).  **Cut:** from the flat cell's 4,096 genomes and 8,192
     reads, for the script's time limit; (e) the hier_scaled_minimizer
     scheme whole (k = 20, --window-size 26, --scaling 3: the FracMinHash
     keep in K5) on a flat index of (b)'s genomes, searched and
     checked as (a) with (b)'s reads; (d) K5 timed against its twin at
     the L=8192 bucket (R=512) of (a)'s reads, a call and on the device
     alone, for (a)'s scheme with no keep, for plain k-mers and for (a)'s
     scheme with its keep; the keep as tensor ops on K5's output there,
     a call, held to K5's keep and the keep on the CPU;
     K2 at (b)'s own shape (that bucket's reads through K5, H = L hash
     slots, on (b)'s table: a thin slab of 4 bins), bit-exact to its twin
     on every read of the batch and timed beside the rows route and the
     split variant (the slab record's ``kmer_thin``; the rows route
     there: the K2 rows record's ``kmer_flat``), then the slab route
     forced on a table past the L2 (120,000 x 1,024, a slab of 1 bin,
     ``kmer_thin``'s ``tall_forced``) and on phase 6's stack (``stack``),
     each beside the rows route; every group of one batch of (a)'s index
     at L=8192 in both modes, the per-read mode's activity (from the
     batch's own thresholds) and descend-all's (every pair), each
     run-sum launch a call and on the device alone, bit-exact to its
     twin, against its bound (the K2n record's ``per_read_groups`` and
     ``descend_all_groups``), and each mode's whole step a call
     (``minimizer_batch``).  K5's
     record counts the launches of (a), (b) and (e); K2's and K2n's add
     theirs;
 14. the sharded engine on the card, through ``search --engine sharded
     --distributed`` (device/sharding.py, device/distributed.py): each
     rank is a process of this script (``--rank FILE``) that runs
     ``taxor_tpu_torch.cli.main`` with the argv of ``python -m
     taxor_tpu_torch.cli search ...`` and writes its launch counts,
     routes, wall, peak device memory and collective seconds (CUDA
     events around each all_gather and all_reduce) to FILE; ranks that
     share the card run their collectives on gloo, one rank on NCCL.
     (a) phase 4's flat cell, all its reads, 4 ranks on a 2 x 2 mesh; (b)
     phase 7's hierarchy, all its reads, 4 ranks on a 2 x 2 mesh; (c)
     phase 13a's scaled minimiser hierarchy (per-read), 2 ranks with
     --mesh-bins 2; (d) phase 4's flat cell on one rank (NCCL); (e)
     ``tools.dryrun_multichip`` over 4 ranks.  Every rank must exit 0,
     each TSV must equal the phase's single-device ``--engine device``
     TSV byte for byte on every read, and K1 and K2 ((a), (d); K2n on a
     quick start's flat shard of at most 512 bins), K1 and K2n ((b)), K5
     and K2n ((c)) must launch in the ranks.  The kernels
     records' ``sharded_launches`` sum the ranks' launches of (a)-(d);
 15. the at-scale path: (a) K2n's rows mode (run sums and dense counts)
     and K2's rows route against their twins, bit-exact, on stacks of
     more than 2^31 bytes (tools/synth.big_table_problem: [1, 3 x 2^24,
     64], every hash's third row past byte 2^31, and [2, 3 x 2^20, 512],
     half of the valid hashes planted in every bin), each timed beside
     its twin (the K2n and K2 rows records' ``past_2_31_bytes``); (b)
     the port's at-scale demo (``tools/at_scale_demo.py``: the JAX
     demo's recipe of log-normal genomes of 30 kb - 5 Mb in homology
     clusters, a k=22/s=12 syncmer index built with ``--layout auto
     --tmax 4096``, mixed-length reads of 500 b - 8 kb from FASTQ.gz) at
     one block of 1,024 genomes (0.4 GB, 112 IXFs in 3 levels under a
     64-bin root) and ``--atscale-reads`` reads: gen, build, search on
     the card and parity; the launches counted are the demo's own
     around its three searches of the reads (``search_launches``: the
     cold search and both warm passes, not the burst after them).  The
     index must be hierarchical, the root group must take K2n's rows
     mode and a group below it the smem mode, K1 and both K2n modes
     must launch, the parity TSV must equal
     ``--engine host`` byte for byte, and 99% of the classified reads
     must name their source genome.  Each stage's record is logged
     (``phase 15 <stage>: {...}``).  **Cut:** the demo's 18 GB recipe to
     its first block, for the script's time limit (the full recipe is
     the demo's five stages in turn, its module docstring);
 16. the layout cost model of ``--layout-cost device``
     (hixf/device_cost.py) on the card: (a) its host copies of K2's and
     K2n's routing rules equal the card's (probe.slab_bins,
     its fit, probe.narrow_mode) on
     device_cost.routing_grid(): S 1-200,000 with every width's limits,
     Bpad 16-4,096 in steps of 16; (b)
     ``tools.bench_gather_scale`` at its default shapes: every route
     bit-exact to its twin, each call's time beside the model's
     prediction, which must fall within MODEL_SLACK (30%) of it, or
     HOST_SLACK (50%) where the model's host floor bounds it; (c) at
     CHOICE_GENOMES (1,024) genomes of phase 7's recipe and on phase 7's
     own data and cpu index: flat, the cpu model's and the device
     model's layout at --tmax 64, each one's fused step timed on the
     L=8192 bucket (R = 512, ``DeviceHIXF.e2e_async``, CUDA events)
     beside the model's ms a read (layouts equal but for the order of
     their bins share one timing); the device layout must be the
     fastest or within CHOICE_SLACK (10%) of it, and its TSV equal to
     ``--engine host`` on the first CHECK_READS reads and the long ones;
     (d) ``tools.layout_invariance`` at 100 species and 400 reads on the
     card, its table (with the device_model row) logged.  The launches
     of phase 16 are counted in no record;
 17. the routes of the device search that no main path takes, on
     ROUTE_CLUSTERS (12) species of ROUTE_STRAINS (80) strains each
     (the species' random 30 kb ancestor with 0.5% substitutions) and
     ROUTE_SINGLES (64) unrelated genomes, with ROUTE_READS (4,096)
     reads of phase 4's recipe and the long ones; every search through
     ``cli search --engine device`` with the launch counts set to 0 just
     before and read just after, its TSV equal to ``--engine host`` byte
     for byte on every read (every read that took a fallback among
     them): (a) k = 22, s = 12 syncmers, --layout flat (K1, K2's slab
     route), as built and from a copy saved with suggested_topk = 16 and
     searched through ``pipeline.run_search`` in batches of ROUTE_BATCH
     (256) reads (the CLI has no batch flag; its 1,024 would start four
     of five batches together at k = 16): the copy's top-k ladder must
     climb 16 -> 64 -> 256 (``topk_escalations`` >= 2, truncated reads
     decided by the host oracle); (b) the same scheme with --scaling 3,
     --layout flat (K1, the FracMinHash keep as tensor ops, K2's slab
     route); (c) (b)'s scheme with --layout auto --tmax 64 (the
     count-table descent on K2n, its thresholds indexed by the count
     kept: fewer than all (subgroup, read) pairs active), a hierarchy of
     more than one IXF.  (b) and (c) must keep ~1/3 of (a)'s hashes
     (0.28-0.39 on the reads both classify).  Its launches join the
     kernels records' main-path launches.
     ``--only-routes`` runs the kernel build and phase 17 alone;
 18. syncmer reads past L_CAP: (a) on phase (b)'s reads of 2 pieces
     and its 0.5-1 Mb reads (32 pieces), K1's and syncmer_track's piece
     rows against their twins (``syncmer_hashes_plain``,
     ``syncmer_kmers_pieces``), then K4 and K6 against theirs, all
     bit-exact, at the union's widths (16,384 and 262,144 keys: K4's
     register and global-scratch routes), with an all-ones hash counted
     in n_valid in the first row and two in the last (K6 must keep one
     in each), each timed beside its twin and, for K4, ``torch.sort`` of
     the combined key, for K6, ``torch.sort`` then
     ``torch.unique_consecutive`` of the row (the kernels line: K1's and
     syncmer_track's ``piece_widths``, K4's ``long_widths``, K6's
     ``widths``); (b) on phase 15b's at-scale
     block (1,024 genomes of 30 kb to 5 Mb, its index), LONG_TAIL_READS
     (4,096) reads of log-normal lengths (median 8 kb, sigma 1.0, up to
     1 Mb, not clipped) and ULTRA_LONG_READS (8) of 0.5-1 Mb, each from a
     genome at least as long, 4% substitutions: ``cli search --engine
     device`` with the launch counts set to 0 just before, every read
     past L_CAP routed ``long_fused`` and none hashed on the host, the
     TSV equal to ``--engine host`` on every long read and on the first
     CHECK_READS others; its ``.time`` split, the host seconds of the cut
     and the pack (``dsync.bucket_len`` and ``pack_reads`` by bucket);
     the old route of phases 4b and 7c (``search_hashes``,
     ``pipeline._device_dispatch``) against the new
     (``DeviceHIXF.e2e_async`` on the piece bucket) on its long reads;
 19. minimiser and plain k-mer reads past L_CAP: on (a) phase 13a's
     scaled minimiser hierarchy (per-read descent) and (b) phase 13b's
     plain k-mer flat index (K2's thin slabs), each with TAIL_READS_19
     (512) reads of phase 18's length recipe and ULTRA_LONG_READS (8) of
     0.5-1 Mb drawn from the index's own genomes taken as circular (a
     read past 30 kb repeats its genome: **cut**, the phase builds no
     index of its own), 4% substitutions: ``cli search --engine
     device`` with the launch counts set to 0 just before, K5 and the
     probe kernel must launch, every read past L_CAP ``long_fused`` and
     none hashed on the host, the TSV equal to ``--engine host`` on
     every read past L_CAP; wall, routes and peak device memory, and the
     peak of one fused step of 16 reads of the 1,047,584 bucket; the
     host-hash route (``search_hashes``, ``pipeline._device_dispatch``)
     against the fused step on the path's 16 reads of 40 kb and on two
     0.5-1 Mb reads.  Its launches join the kernels records' main-path
     launches; K5's record holds its ``long_reads``;
 20. syncmer schemes past the 32-bit s-mer: (a) K1 and syncmer_track
     through the instance each s picks (64-bit s-mers for s >= 16)
     against their twins, bit-exact, for (k, s) = (22, 16), (28, 18),
     (18, 16), (30, 29) and (16, 14) at every length bucket 256..32768
     on phase 2's reads, at the scheme's hash capacity (no random read
     past it), and on piece rows of reads of 2 and 32 pieces; (b) ``cli
     search --engine device`` with the launch counts set to 0 just
     before, on a flat k = 28, s = 18 index of phase 4's genomes with its
     reads (8,192 + 16 of 40 kb), a ``--tmax 64`` hierarchy of the same
     scheme on the first 1,024 of them with their reads and the long ones
     (then again with the split engine, whose TSV must be equal), and a
     flat k = 16, s = 14 index of phase 13b's genomes with its reads
     (4,096 + 16): every read fused (the long ones in pieces), none
     hashed on the host, none past the hash capacity, K1's 64-bit
     instance alone on the wide scheme, the TSV equal to ``--engine
     host`` on every read; then the narrow index once more on its first
     512 reads and the long ones with the hash capacity held at 128
     slots a row (the floor of the JAX package's rule): every read
     extracted on the card, past its capacity and decided again by the
     host oracle (hcap_overflow == host_fallback == reads), the TSV
     equal to ``--engine host`` on every read; (c) the 64-bit instances
     timed against their twins at L=8192 with their bounds (the kernels
     line's ``syncmer_extract_s64`` and ``syncmer_track_s64``), K1 on an
     all-tied batch, and the 16 reads of 40 kb on the host-hash route
     (the parent's rule for s >= 16) against the fused step.  The
     indexes build in the background (``smer_wide`` from phase 4 on,
     ``smer_narrow`` from phase 13b on).

Every kernel's record holds its least time on the card (``bound_ms``):
the larger of its bytes (each input read once, each output written
once) over the H100's 3.35 TB/s and its operations over the peak rate
for their type (the H100's dense peak rates; 64-bit key compares and
the tracker's integer operations, which have no entry, at the 67
TFLOP/s scalar fp32 rate; ``tracker_ops`` counts them).

The host builds that phases 13a, 13b/13e, 15b, 16c, 17 and 20 search (their
data, the indexes, the at-scale demo's gen and build stages) run from the
start in processes of this script of their own (``--prebuild``, PREBUILDS)
at the lowest CPU priority, while the card runs the phases before them;
phase 16's timed gates run after all of them have ended.  The order of
the phases: 1-4, 5 and 10, 14a/d/e, 6, 7, 8, 13c, 13a, 13d, 14b, 14c,
19a, 13b, 13e, 19b, 20, 15, 18, 16 (16c on phase 7's data, then on its
own), 17, 11, 12.

The second-to-last line of stdout is nvidia-smi's name and power limit;
the last line is {"ok": true, "device": {"platform": "gpu", ...}}.  The
line before them holds the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
K, S = 22, 12  # the reference's published syncmer scheme
# extract_stage's schemes (k, s, t) in phase 11: the published one, the
# widest window (w = 18), the shortest s-mer (s = 2, t = w = 14), t = w = 11
STAGE_SCHEMES = ((22, 12, 5), (32, 15, 1), (15, 2, 14), (21, 11, 11))
GENOME_LEN = 30000
LONG_READS = 16  # of 40 kb: over L_CAP, the fused step in pieces
TMAX = 64  # technical bins per IXF of the hierarchical index
CHECK_READS = 1024  # first reads held byte-equal to --engine host
SEED = 20261016
HBM_BPS = 3.35e12  # H100 SXM device memory rate
PEAK_SCALAR = 67e12  # fp32 outside the tensor cores: integer/compare work
PEAK_INT8 = 1979e12  # int8 (fingerprint bytes)
SMEM_BPS = 128 * 132 * 1.98e9  # H100 shared memory: 128 B a clock an SM


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(label: str):
    """Logs the wall seconds of the block."""
    t0 = time.perf_counter()
    yield
    log(f"{label}: {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------------ K1 --
def k1_reads(rng, L: int) -> list[bytes]:
    """Random reads of the bucket plus the tracker's hard cases: tied
    window minima (homopolymer runs, a tandem repeat, two-letter
    alphabets, a first window tied at every offset, a homopolymer over
    the whole bucket), N codes, and reads without a k-mer."""
    half = max(1, L // 2)
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(half, L + 1)))]
            .tobytes() for _ in range(10)]
    seqs.append(ACGT[rng.integers(0, 4, L)].tobytes())  # full bucket
    arr = ACGT[rng.integers(0, 4, L)].copy()
    for _ in range(max(1, L // 256)):  # homopolymer runs: tied minima
        off = int(rng.integers(0, L - 40))
        arr[off:off + int(rng.integers(13, 40))] = ACGT[rng.integers(0, 4)]
    seqs.append(arr.tobytes())
    unit = ACGT[rng.integers(0, 4, int(rng.integers(2, 7)))].tobytes()
    seqs.append((unit * (L // len(unit) + 1))[:L])  # tandem repeat
    arr = ACGT[rng.integers(0, 4, L - 7)].copy()
    arr[rng.integers(0, L - 7, L // 50)] = ord("N")  # ambiguity codes
    seqs.append(arr.tobytes())
    seqs += [b"", ACGT[rng.integers(0, 4, K - 1)].tobytes()]  # no k-mer
    for pair in (b"AC", b"AT", b"CG"):  # two letters: ties everywhere
        two = np.frombuffer(pair, np.uint8)
        seqs.append(two[rng.integers(0, 2, int(rng.integers(half, L + 1)))]
                    .tobytes())
    seqs.append(b"A" * (K + 2)  # the first window tied at every offset
                + ACGT[rng.integers(0, 4, L - K - 2)].tobytes())
    seqs.append(ACGT[int(rng.integers(0, 4))].tobytes() * L)  # all tied
    return seqs


def assert_equal(torch, label: str, names, got, want) -> None:
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs from the twin")


def check_k1(torch, dsync, extract, sort, rng) -> None:
    """K1, and the split engine's syncmer_track and K3, against their
    twins on the same reads."""
    dev = torch.device("cuda")
    cases = [(L, K, S, (K - S + 1) // 2) for L in
             (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)]
    cases.append((32768, 14, 12, 1))  # gap 1: 256 KB sort buffer in global
    for L, k, s, t in cases:
        seqs = k1_reads(rng, L)
        packed, lengths = dsync.pack_reads(seqs, L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        hcap = dsync.hash_cap(L, k, s, t)
        got = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
        want = extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap)
        assert_equal(torch, f"K1 L={L} k={k} s={s}", ("hi", "lo", "valid",
                     "n_unique", "n_emit"), got, want)
        log(f"K1 L={L} k={k} s={s} t={t}: bit-exact vs twin on {len(seqs)} "
            f"reads (n_emit max {int(got[4].max())}, hcap {hcap}, sort width "
            f"{extract.sort_width(L, k, s, t)})")
        kmer, emit = extract.syncmer_track(pk, ln, k, s, t)
        assert_equal(torch, f"syncmer_track L={L} k={k} s={s}",
                     ("kmer", "emit"), (kmer, emit),
                     dsync.syncmer_kmers(pk, ln, k, s, t))
        gap = dsync.emission_min_gap(k, s, t)
        for hc in (hcap, hcap // 8):
            assert_equal(torch, f"K3 L={L} k={k} s={s} hcap={hc}",
                         ("kmer", "valid", "n_unique", "n_emit"),
                         sort.dedup_fused(kmer, emit, hc, gap),
                         sort.dedup_fused_plain(kmer, emit, hc, gap))
        Wb = sort.dedup_width(L, gap)
        where = ("global scratch" if Wb > sort.REG_SORT_MAX
                 else "registers")
        log(f"syncmer_track + K3 L={L} k={k} s={s} t={t}: bit-exact vs "
            f"twins ({int(emit.sum())} emissions; K3 at hcap {hcap} and "
            f"{hcap // 8}, buffer {Wb} in {where})")


# ------------------------------------------------------------------ K2 --
def check_k2(torch, probe, rng) -> int:
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero_fp = pool[fingerprint8(mix_split(pool, seed)) == 0]
    # (label, reference kernel at this geometry, block_length, bins)
    geoms = [("bl<=1023, B<4096", "_kernel_p10x2", 1000, 1000),
             ("bl>1023, B<4096", "_kernel_p16", 5000, 2000),
             ("B>=4096", "_kernel_wide_p16", 2000, 5000),
             ("S+1>65536", "_kernel", 30000, 64),
             ("S+1>65536, B>=4096", "_kernel_wide", 22000, 4096)]
    R, H = 8, 2048
    variants = probe.k2_counts.VARIANTS
    start = dict(variants)
    picked = set()  # the variants the shapes took
    thin = set()  # the thin slabs forced
    for label, ref, bl, B in geoms:
        S_ = 3 * bl
        Bp = probe.pad_bins(B)
        table = rng.integers(0, 256, (S_, Bp), dtype=np.uint8)
        table[:, ::7] = 0  # zero columns: every fingerprint-0 hash hits
        keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
        keys[0] = zero_fp[:H]  # read 0 counts > 256 in the zero columns
        valid = rng.random((R, H)) < 0.7
        valid[1] = False
        hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (hi, lo, valid)]
        tbl = torch.from_numpy(table).to(dev)
        n2, n2n = probe.k2_counts.LAUNCHES, probe.k2n_counts.LAUNCHES
        before = dict(variants)
        got = probe.probe_counts(*args, tbl, seed, bl)
        want = probe.probe_counts_plain(*args, tbl, seed, bl)
        torch.cuda.synchronize()
        grew = {v: n - before.get(v, 0) for v, n in variants.items()
                if n != before.get(v, 0)}
        one = (list(grew.values()) == [1] if probe.k2_counts.LAUNCHES > n2
               else not grew)
        if (probe.k2_counts.LAUNCHES + probe.k2n_counts.LAUNCHES
                != n2 + n2n + 1 or not one):
            raise AssertionError(
                f"probe {label}: one call launched K2 "
                f"{probe.k2_counts.LAUNCHES - n2} and K2n "
                f"{probe.k2n_counts.LAUNCHES - n2n} times, K2 variants "
                f"{grew}; expected one launch of one kernel")
        kernel = "K2n" if probe.k2n_counts.LAUNCHES > n2n else \
            f"K2 ({next(iter(grew))})"
        if grew:
            picked |= set(grew)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {label}: counts differ from the "
                                 "twin")
        if int(got.max()) <= 256 or int(got[1].abs().sum()) != 0:
            raise AssertionError(f"K2 {label}: case did not exercise "
                                 "counts > 256 / all-invalid reads")
        also = []
        if kernel.startswith("K2 "):  # the same counts through the others
            for v in k2_forced(probe, S_, Bp, bl, dev, next(iter(grew))):
                if not torch.equal(probe.k2_counts(*args, tbl[None], None,
                                                   seed, bl, variant=v)[0],
                                   want):
                    raise AssertionError(f"K2 ({v}) {label}: counts differ "
                                         "from the twin")
                w = probe.slab_bins(S_, Bp, H, dev, fit=True)
                if v == "slab" and w < 16:
                    thin.add(w)
                also.append(f"slab of {w}" if v == "slab" else v)
        log(f"{kernel} {label} (S={S_}, Bpad={Bp}; TPU {ref}): bit-exact vs "
            f"twin, max count {int(got.max())}"
            + (f"; K2 ({', '.join(also)}) bit-exact too" if also else ""))
    ran = {v: n - start.get(v, 0) for v, n in variants.items()}
    if not (ran.get("slab", 0) > 0 and ran.get("rows", 0) > 0) or not thin:
        raise AssertionError(f"phase 3 did not run both K2 routes and a thin "
                             f"slab: {ran}, thin slabs {thin}")
    if picked != {"slab", "rows"}:  # 2,048 slots a read: no thin slab
        raise AssertionError(f"phase 3: the shapes picked {picked}")
    log(f"phase 3: K2 launches by variant {ran}; thin slabs of "
        f"{sorted(thin)} bins forced")
    return ran["rows"]


def k2_forced(probe, S: int, Bpad: int, bl: int, dev, took: str) -> list:
    """K2's variants other than ``took`` that fit tables [S, Bpad], to be
    forced on the same inputs: the slab route at the widest slab that
    fits (a thin one where no 16-bin slab fits), the split variant where
    a cluster holds its 16-bin slab, the rows route always."""
    fits = {"slab": probe.slab_bins(S, Bpad, 0, dev, fit=True) > 0,
            "split": probe.split_cluster(S, Bpad, bl, dev) > 0,
            "rows": True}
    return [v for v, ok in fits.items() if ok and v != took]


def check_grouped(torch, probe, rng) -> int:
    """K2n and K2 over G stacked tables with a mixed activity mask;
    returns the launches of K2's rows route."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    seed = int(rng.integers(0, 2**63))
    bl, R, H = 3000, 16, 2048
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero_fp = pool[fingerprint8(mix_split(pool, seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero_fp[:H]  # read 0 counts > 256 in the zero columns
    valid = rng.random((R, H)) < 0.7
    valid[1] = False  # no valid slot
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (hi, lo, valid)]
    start = dict(probe.k2_counts.VARIANTS)
    for Bp in (16, 64, 128, 512, 4096):
        kernel = (probe.k2n_counts if Bp <= probe.NARROW_MAX_BINS
                  else probe.k2_counts)
        for G in (1, 8):
            tables = rng.integers(0, 256, (G, 3 * bl, Bp), dtype=np.uint8)
            tables[:, :, ::7] = 0
            active = rng.random((G, R)) < 0.5
            active[:, 0] = True
            active[:, R - 1] = False  # a read inactive everywhere
            tb = torch.from_numpy(tables).to(dev)
            act = torch.from_numpy(active).to(dev)
            n = kernel.LAUNCHES
            got = probe.probe_counts_grouped(*args, tb, act, seed, bl)
            want = probe.probe_counts_grouped_plain(*args, tb, act, seed, bl)
            torch.cuda.synchronize()
            if kernel.LAUNCHES != n + 1 or not torch.equal(got, want):
                raise AssertionError(f"grouped probe Bpad={Bp} G={G}: "
                                     "kernel differs from the twin")
            if kernel is probe.k2_counts:
                for v in k2_forced(probe, 3 * bl, Bp, bl, dev, "slab"):
                    if not torch.equal(probe.k2_counts(
                            *args, tb, act, seed, bl, variant=v), want):
                        raise AssertionError(f"grouped K2 ({v}) Bpad={Bp} "
                                             f"G={G}: kernel differs from "
                                             "the twin")
            k2n_modes = []
            if kernel is probe.k2n_counts:  # each mode that fits
                k2n_modes = ["rows"] + (
                    ["smem"] if probe.narrow_mode(3 * bl, Bp, dev) == "smem"
                    else [])
                for mode in k2n_modes:
                    if not torch.equal(probe.k2n_counts(
                            *args, tb, act, seed, bl, mode=mode), want):
                        raise AssertionError(
                            f"grouped K2n ({mode}) Bpad={Bp} G={G}: kernel "
                            "differs from the twin")
            if (int(got[:, 0].max()) <= 256
                    or int(got[:, R - 1].abs().sum()) != 0):
                raise AssertionError(f"grouped probe Bpad={Bp} G={G}: case "
                                     "did not exercise counts > 256 / "
                                     "inactive reads")
            name = (f"K2n ({' and '.join(k2n_modes)})"
                    if kernel is probe.k2n_counts else
                    f"K2 (slab of {probe.slab_bins(3 * bl, Bp, H, dev)} "
                    "bins, and split and rows)")
            log(f"{name} grouped Bpad={Bp} G={G} (S={3 * bl}, R={R}, H={H}, "
                f"{int(active.sum())}/{G * R} active): bit-exact vs twin, "
                f"max count {int(got.max())}")
    # a generator of its own, so that the data drawn later stay as they were
    check_thin_stack(torch, probe, np.random.default_rng(SEED + 61))
    ran = {v: n - start.get(v, 0) for v, n in probe.k2_counts.VARIANTS.items()}
    if not all(ran.get(v, 0) > 0 for v in ("slab", "split", "rows")):
        raise AssertionError(f"phase 6 did not run every K2 variant: {ran}")
    log(f"phase 6: K2 launches by variant {ran}")
    return ran["rows"]


# the thin slabs' grouped case: a stack of two [30,000, 528] tables (no
# 16-bin slab fits; thin slabs of 4 bins), R reads of H slots with NVALID
# valid (phase 13b's batch), a mask like the descent's of a group past
# 512 bins
STACK_BL, STACK_BINS, STACK_R, STACK_H, STACK_NVALID = 10_000, 528, 512, \
    8192, 5712


def stack_problem(torch, rng):
    """(hi, lo, valid, tables [2, 30,000, 528], active, seed, bl): random
    keys, the first 5,712 slots of a read valid, read 0's all valid and
    of fingerprint 0 (counts above 256 in the zero columns), a mixed
    mask."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    R, H, bl = STACK_R, STACK_H, STACK_BL
    seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 1 << 22, dtype=np.uint64)
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = pool[fingerprint8(mix_split(pool, seed)) == 0][:H]
    valid = np.zeros((R, H), dtype=bool)
    valid[:, :STACK_NVALID] = True
    valid[0] = True
    tables = rng.integers(0, 256, (2, 3 * bl, STACK_BINS), dtype=np.uint8)
    tables[:, :, ::7] = 0
    active = rng.random((2, R)) < 0.6
    active[:, 0], active[:, R - 1] = True, False
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return (*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in (hi, lo, valid, tables, active)), seed, bl)


def check_thin_stack(torch, probe, rng) -> None:
    """Phase 6: stack_problem through the route its shape takes (a thin
    slab of 4 bins; thin slabs divide Bpad, so none is ragged) and its
    split variant forced, bit-exact."""
    x = stack_problem(torch, rng)
    want = probe.probe_counts_grouped_plain(*x)
    before = probe.k2_counts.VARIANTS.get("slab", 0)
    got = probe.probe_counts_grouped(*x)
    W = probe.slab_bins(*x[3].shape[1:], STACK_H, x[3].device)
    split = probe.k2_counts(*x, variant="split")
    torch.cuda.synchronize()
    if probe.k2_counts.VARIANTS.get("slab", 0) != before + 1 or W != 4:
        raise AssertionError(f"phase 6: the stack {list(x[3].shape)} did not "
                             f"take a thin slab of 4 bins ({W})")
    for name, y in (("slab", got), ("split", split)):
        if not torch.equal(y, want):
            raise AssertionError(f"phase 6: K2 ({name}) on the stack "
                                 f"{list(x[3].shape)} differs from the twin")
    if int(got[:, 0].max()) <= 256 or int(got[:, STACK_R - 1].abs().sum()):
        raise AssertionError("phase 6: the stack case did not exercise "
                             "counts > 256 / inactive reads")
    log(f"K2 (slab of {W} bins, and split) on the stack {list(x[3].shape)} "
        f"with {int(x[4].sum())}/{x[4].numel()} active: bit-exact vs twin, "
        f"max count {int(got.max())}")


def run_csr(rng, G: int, bins: int):
    """int64 (run_off [G + 1], run_s, run_e): one-bin runs and runs over
    many bins with unused columns between them; subgroup 0 one run over
    all of its bins, subgroup 1 (where there is one) no run."""
    offs, starts, ends = [0], [], []
    for g in range(G):
        if g == 0:
            starts.append(0)
            ends.append(bins)
        elif g != 1:
            col = 0
            while col < bins:
                e = min(bins, col + int(rng.choice([1, 1, 2, 5, 16, 60])))
                starts.append(col)
                ends.append(e)
                col = e + int(rng.integers(0, 3))
        offs.append(len(starts))
    return tuple(np.array(x, dtype=np.int64) for x in (offs, starts, ends))


def check_run_sums(torch, probe, rng) -> None:
    """Phase 6, K2n's run sums: probe_run_sums_grouped against its twin,
    bit-exact, in both modes (and the mode the shape picks), each call
    one K2n launch."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    seed = int(rng.integers(0, 2**63))
    # S = 216 slots, the widest group's; read 0's 2,304 valid slots
    # make each warp of the smem mode flush its byte counters mid-read at
    # 512 bins
    bl, R, H = 72, 64, 2304
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero_fp = pool[fingerprint8(mix_split(pool, seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero_fp[:H]  # read 0: run sums above 256 in zero columns
    valid = rng.random((R, H)) < 0.7
    valid[0], valid[1] = True, False  # read 1: no valid slot
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (hi, lo, valid)]
    kern = probe.k2n_counts
    start = dict(kern.MODES)
    n_calls = 0
    t0 = time.perf_counter()
    for G in (1, 8, 72):
        for bins in (16, 100, 512):
            Bp = probe.pad_bins(bins)
            tables = np.zeros((G, 3 * bl, Bp), dtype=np.uint8)
            tables[:, :, :bins] = rng.integers(0, 256, (G, 3 * bl, bins))
            tables[:, :, ::7] = 0
            tb = torch.from_numpy(tables).to(dev)
            runs = [torch.from_numpy(x).to(dev) for x in run_csr(rng, G, bins)]
            picked = probe.narrow_mode(3 * bl, Bp, dev)
            if picked != "smem":
                raise AssertionError(f"K2n run sums: [{3 * bl}, {Bp}] "
                                     f"tables take {picked}, not smem")
            for share in (0.0, 0.005, 0.6, 1.0):
                active = rng.random((G, R)) < share
                if share:
                    active[0, 0] = True  # read 0 in the run over all bins
                act = torch.from_numpy(active).to(dev)
                want = probe.probe_run_sums_grouped_plain(
                    *args, tb, act, *runs, seed, bl)
                for mode in ("smem", "rows", None):
                    n, before = kern.LAUNCHES, dict(kern.MODES)
                    got = (probe.probe_run_sums_grouped(
                        *args, tb, act, *runs, seed, bl) if mode is None
                        else probe.k2n_run_sums(*args, tb, act, *runs,
                                                seed, bl, mode=mode))
                    torch.cuda.synchronize()
                    grew = {m: c - before.get(m, 0)
                            for m, c in kern.MODES.items()
                            if c != before.get(m, 0)}
                    if kern.LAUNCHES != n + 1 or grew != {mode or picked: 1}:
                        raise AssertionError(
                            f"K2n run sums G={G} bins={bins} share={share} "
                            f"mode={mode}: {kern.LAUNCHES - n} launches, "
                            f"modes {grew}; expected one launch")
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K2n run sums ({mode or picked}) G={G} "
                            f"bins={bins} activity {share}: kernel differs "
                            "from the twin")
                    n_calls += 1
                big = int(want[0, 0])  # run 0: all of subgroup 0's bins
                if (share and big <= 256) or int(want[:, 1].abs().sum()) \
                        or (not share and int(want.abs().sum())):
                    raise AssertionError(
                        f"K2n run sums G={G} bins={bins} share={share}: "
                        "case did not exercise sums > 256 / an invalid read "
                        "/ zeros")
            log(f"K2n run sums G={G}, [{3 * bl}, {Bp}] ({bins} bins), "
                f"{runs[1].shape[0]} runs, R={R}, H={H}: bit-exact vs twin "
                f"in smem and rows mode at activity 0, 0.5%, 60% and 100% "
                f"(run over all bins {big})")
    ran = {m: c - start.get(m, 0) for m, c in kern.MODES.items()}
    # a group wider than NARROW_MAX_BINS (an IXF of more than 512 bins,
    # in a group of its own): K2's dense counts and their segment sums;
    # its own generator, so that the indexes drawn later stay as they were
    wrng = np.random.default_rng(SEED + 6)
    for G, bins in ((1, 1000), (2, 4096)):
        Bp = probe.pad_bins(bins)
        tables = np.zeros((G, 3 * bl, Bp), dtype=np.uint8)
        tables[:, :, :bins] = wrng.integers(0, 256, (G, 3 * bl, bins))
        tables[:, :, ::7] = 0
        tb = torch.from_numpy(tables).to(dev)
        runs = [torch.from_numpy(x).to(dev) for x in run_csr(wrng, G, bins)]
        active = wrng.random((G, R)) < 0.6
        active[0, 0] = True
        act = torch.from_numpy(active).to(dev)
        want = probe.probe_run_sums_grouped_plain(*args, tb, act, *runs, seed,
                                                  bl)
        n2, n = probe.k2_counts.LAUNCHES, kern.LAUNCHES
        got = probe.probe_run_sums_grouped(*args, tb, act, *runs, seed, bl)
        torch.cuda.synchronize()
        if probe.k2_counts.LAUNCHES != n2 + 1 or kern.LAUNCHES != n:
            raise AssertionError(
                f"run sums of a {bins}-bin group: {probe.k2_counts.LAUNCHES - n2}"
                f" K2 and {kern.LAUNCHES - n} K2n launches; expected one K2")
        if not torch.equal(got, want) or int(want[0, 0]) <= 256:
            raise AssertionError(f"run sums of a {bins}-bin group (K2 + "
                                 "segment sums) differ from the twin")
    log("phase 6: run sums of 1,000- and 4,096-bin groups (K2's dense "
        "counts + segment sums, one K2 launch each) bit-exact vs twin")
    log(f"phase 6: K2n run sums, {n_calls} calls of one launch each, "
        f"launches by mode {ran}, {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- K3, K4 --
def check_sorts(torch, sort, rng) -> dict:
    """K4 at four widths, and K3 on a row that breaks min_gap, from the
    main rng (the draws of the main paths that follow stay as they
    were); then, from a generator of their own, K4 at every width of
    time_sort.PAIR_WIDTHS (the merge route's MERGE_WIDTHS among them) and
    K3 at every emission count of time_sort.emission_counts, through
    every branch of their register network, K4's merge route and K3's
    global-scratch route; then K4's merge route timed on random keys at
    MERGE_SHAPES beside its twin and ``torch.sort`` (returned by shape,
    for K4's record)."""
    from taxor_tpu_torch.tools import time_sort

    dev = torch.device("cuda")
    R = 64
    for W in (100, 128, 8192, 32768):
        hi = rng.integers(-4, 4, (R, W), dtype=np.int32)
        lo = rng.integers(-2**31, 2**31, (R, W), dtype=np.int32)
        hi[:, 1::2] = hi[:, ::2][:, :W // 2]  # every key twice
        lo[:, 1::2] = lo[:, ::2][:, :W // 2]
        hi[:, ::7] = -1  # keys equal to the all-ones sentinel
        lo[:, ::7] = -1
        args = [torch.from_numpy(x).to(dev) for x in (hi, lo)]
        assert_equal(torch, f"K4 W={W}", ("hi", "lo"),
                     sort.sort_pairs(*args), sort.sort_pairs_plain(*args))
    L, gap = 8192, 5
    kmer = torch.from_numpy(rng.integers(0, 2**62, (4, L))).to(dev)
    emit = torch.zeros((4, L), dtype=torch.bool, device=dev)
    emit[:, ::gap] = True
    emit[1, 1::gap] = True  # twice the emissions min_gap allows
    got = sort.dedup_fused(kmer, emit, 2048, gap)
    assert_equal(torch, "K3 min_gap overflow", ("kmer", "valid",
                 "n_unique", "n_emit"), got,
                 sort.dedup_fused_plain(kmer, emit, 2048, gap))
    n = (L - 1) // gap + 1
    if got[3].tolist() != [n, sort.OVERFLOW, n, n]:
        raise AssertionError(f"K3 min_gap overflow: n_emit {got[3]}")
    log(f"K3 min_gap overflow: n_emit {got[3].tolist()} (2**30 on the row "
        "that breaks the gap)")

    own = np.random.default_rng(SEED + 9)
    for W in time_sort.PAIR_WIDTHS:
        args = [torch.from_numpy(x.view(np.int32)).to(dev)
                for x in time_sort.pair_rows(own, R, W)]
        assert_equal(torch, f"K4 W={W}", ("hi", "lo"),
                     sort.sort_pairs(*args), sort.sort_pairs_plain(*args))
    log(f"K4 [{R}, W] at W = {list(time_sort.PAIR_WIDTHS)}: bit-exact vs "
        f"twin (duplicated keys, keys with the top bit of hi set, sentinel "
        f"keys, a row of equal keys, a row of sentinels, a row of three "
        f"distinct keys, a row of long equal runs; W > "
        f"{sort.REG_SORT_MAX} on the merge route)")
    for L, gap in ((1000, 5), (2048, 1), (8192, 5), (16384, 5),
                   (32768, 5), (32768, 2), (32768, 1)):
        counts = time_sort.emission_counts(L, gap)
        km, em = time_sort.emission_rows(own, L, counts, gap)
        kmer = torch.from_numpy(km.view(np.int64)).to(dev)
        emit = torch.from_numpy(em).to(dev)
        for hcap in (2048, 100):
            got = sort.dedup_fused(kmer, emit, hcap, gap)
            assert_equal(torch, f"K3 L={L} min_gap={gap} hcap={hcap}",
                         ("kmer", "valid", "n_unique", "n_emit"), got,
                         sort.dedup_fused_plain(kmer, emit, hcap, gap))
        Wb = sort.dedup_width(L, gap)
        n_over = int((got[3] == sort.OVERFLOW).sum())
        if n_over != (Wb < L) or int(got[2][-2]) != 1:
            raise AssertionError(f"K3 L={L} min_gap={gap}: n_emit "
                                 f"{got[3].tolist()}, n_unique "
                                 f"{got[2].tolist()}")
        log(f"K3 L={L} min_gap={gap} (buffer {Wb}, "
            f"{'global scratch' if Wb > sort.REG_SORT_MAX else 'registers'}"
            f"): bit-exact vs twin at {counts} emissions, all-equal and "
            f"sentinel k-mers, hcap 2048 and 100")
    merge = {}
    for R, W in MERGE_SHAPES:
        keys = torch.from_numpy(own.integers(-2**63, 2**63 - 1, (R, W),
                                             dtype=np.int64)).to(dev)
        hi, lo = (keys >> 32).to(torch.int32), keys.to(torch.int32)
        merge[f"{R}x{W}"] = k4_record(torch, sort, hi, lo)
        log(f"K4 merge route at [{R}, {W}]: {json.dumps(merge[f'{R}x{W}'])}"
            f"; {card_line()}")
    return merge


# K4's merge route timed at these [R, W] (phase 9): the union's width of 32
# pieces, and of 64
MERGE_SHAPES = ((8, 262144), (4, 524288))


def k4_ops(R: int, W: int) -> float:
    """Compare-exchanges of K4 on [R, W]: the bitonic network over pow2(W)
    keys a row (the register route), or over each chunk of REG_SORT_MAX
    keys and one compare an output in each of the log2(Wp / REG_SORT_MAX)
    merge passes (the merge route)."""
    from taxor_tpu_torch.device import sort

    Wp = 1 << max(0, W - 1).bit_length()
    if Wp <= sort.REG_SORT_MAX:
        return sort_ops([W] * R)
    chunks = Wp // sort.REG_SORT_MAX
    passes = chunks.bit_length() - 1
    return (R * chunks * sort_ops([sort.REG_SORT_MAX])
            + float(R) * Wp * passes)


def k4_record(torch, sort, hi, lo) -> dict:
    """K4 on the rows hi, lo against its twin, bit-exact: a call and on the
    device alone beside its twin, ``torch.sort`` of the combined key, its
    bound (16 bytes a key in and out) and its route."""
    from taxor_tpu_torch.tools.time_sort import device_ms
    from taxor_tpu_torch.utils.u64 import INT64_MIN, join32

    R, W = hi.shape
    keys = join32(hi, lo) ^ INT64_MIN
    ms, plain_ms, err, _ = time_pair(
        torch, lambda: sort.sort_pairs(hi, lo),
        lambda: sort.sort_pairs_plain(hi, lo), 3)
    return dict(reads=R, width=W, route="registers"
                if W <= sort.REG_SORT_MAX else "merge", ms=ms,
                dev_ms=device_ms(lambda: sort.sort_pairs(hi, lo)),
                plain_ms=plain_ms, max_abs_err=err,
                library_ms=cuda_ms(lambda: torch.sort(keys, dim=1), 3),
                **bound(16 * R * W, k4_ops(R, W), PEAK_SCALAR))


# ------------------------------------------------------- main path data --
def make_genomes(rng, root: str, n: int, glen: int) -> tuple[str, str, list]:
    return write_genomes(root, (ACGT[rng.integers(0, 4, glen)].tobytes()
                                for _ in range(n)))


def write_genomes(root: str, seqs) -> tuple[str, str, list]:
    """The genomes' FASTA files and taxonomy TSV under root; returns (the
    TSV, the genome directory, [(accession, sequence)])."""
    gdir = os.path.join(root, "genomes")
    os.makedirs(gdir)
    rows, genomes = [], []
    for i, seq in enumerate(seqs):
        acc = f"GCF_{i:06d}.1"
        genomes.append((acc, seq))
        with open(os.path.join(gdir, f"{acc}_genomic.fna"), "wb") as fh:
            fh.write(b">" + acc.encode() + b" chromosome\n" + seq + b"\n")
        rows.append(f"{acc}\t{100000 + i}\tftp://x/{acc}_genomic.fna\t"
                    f"Organism {i}\tk__Bacteria;p__P{i % 7};g__G{i % 97};"
                    f"s__Species {i}\t2;{200 + i % 7};{300 + i % 97};"
                    f"{100000 + i}")
    tsv = os.path.join(root, "taxonomy.tsv")
    with open(tsv, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return tsv, gdir, genomes


def mutate(rng, arr: np.ndarray, rate: float) -> bytes:
    n_err = rng.binomial(arr.shape[0], rate)
    pos = rng.choice(arr.shape[0], size=n_err, replace=False)
    arr[pos] = ACGT[rng.integers(0, 4, n_err)]
    return arr.tobytes()


def make_reads(rng, genomes, n_reads: int, n_long: int):
    """ONT-like reads: log-normal lengths (median 4 kb) clipped to
    500-30,000, 4% substitutions (Taxor's default --error-rate); long
    reads of 40 kb wrap around a circular genome."""
    glen = len(genomes[0][1])
    lens = np.clip(rng.lognormal(np.log(4000), 0.9, n_reads), 500,
                   min(30000, glen)).astype(int)
    recs = []
    for j, ln in enumerate(lens):
        g = int(rng.integers(0, len(genomes)))
        acc, seq = genomes[g]
        off = int(rng.integers(0, glen - ln + 1))
        arr = np.frombuffer(seq, np.uint8)[off:off + ln].copy()
        recs.append((f"read{j}_{acc}", mutate(rng, arr, 0.04)))
    for j in range(n_long):
        acc, seq = genomes[int(rng.integers(0, len(genomes)))]
        full = np.frombuffer(seq * (40000 // glen + 2), np.uint8)
        off = int(rng.integers(0, glen))
        arr = full[off:off + 40000].copy()
        recs.append((f"long{j}_{acc}", mutate(rng, arr, 0.04)))
    return recs


def write_fasta(path: str, recs) -> None:
    with open(path, "wb") as fh:
        for rid, seq in recs:
            fh.write(b">" + rid.encode() + b"\n" + seq + b"\n")


def tsv_rows(path: str, ids: set | None = None) -> list[str]:
    with open(path) as fh:
        lines = fh.read().splitlines()[1:]
    if ids is None:
        return lines
    return [x for x in lines if x.split("\t", 1)[0] in ids]


def reset_counts() -> None:
    """Every launch count, the descent's activity and host thresholds and
    the pipeline's routes to 0."""
    from taxor_tpu_torch.device import launches as launch_counts
    from taxor_tpu_torch.device.e2e import THRESHOLDS
    from taxor_tpu_torch.device.hixf_search import ACTIVITY
    from taxor_tpu_torch.search import pipeline

    ACTIVITY.reset()
    THRESHOLDS.reset()
    launch_counts.reset()
    pipeline.ROUTES.reset()


def cli_build(work: str, tsv: str, gdir: str, flags: list[str],
              layout: str, label: str):
    """``cli build`` of an index with the scheme ``flags`` and --layout
    ``layout`` (--tmax TMAX for "auto") in work; returns (its file, the
    loaded index)."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.hixf.index import load_index

    idx = os.path.join(work, f"{label}.taxor.npz")
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)  # the build writes its layout file (binning.out) here
    try:
        rc = cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                       gdir, "--output-filename", idx, *flags, "--layout",
                       layout, "--threads", str(os.cpu_count() or 1)]
                      + (["--tmax", str(TMAX)] if layout == "auto" else []))
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"[{label}] build failed ({rc})")
    index = load_index(idx)
    ixfs = index.hixf.ixfs
    log(f"[{label}] build: {time.perf_counter() - t0:.1f} s, {len(ixfs)} "
        f"IXF(s), root S={ixfs[0].fingerprints.shape[0]} x "
        f"B={ixfs[0].fingerprints.shape[1]} (block_length "
        f"{ixfs[0].block_length}), fingerprints "
        f"{sum(x.fingerprints.nbytes for x in ixfs) / 1e6:.1f} MB")
    return idx, index


def device_search(torch, idx: str, reads: str, out: str, label: str,
                  batch_size: int = 0) -> tuple[dict, dict, float, float]:
    """``cli search --engine device`` with every launch count set to 0
    just before and read just after; (launches, routes, wall s, peak
    device MiB).  batch_size: search through the function the CLI calls,
    ``pipeline.run_search``, with the CLI's settings but batches of this
    many reads (the CLI's are 1,024)."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.device import launches as launch_counts
    from taxor_tpu_torch.search import pipeline

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if batch_size:
        pipeline.run_search(pipeline.SearchConfig(
            index_file=idx, query_file=reads, report_file=out,
            threads=os.cpu_count() or 1, engine="device", write_time=True,
            batch_size=batch_size), device="cuda")
        rc = 0
    else:
        rc = cli.main(["search", "--index-file", idx, "--query-file", reads,
                       "--output-file", out, "--engine", "device",
                       "--device", "cuda", "--write-time", "--threads",
                       str(os.cpu_count() or 1)])
    wall = time.perf_counter() - t0
    launches = launch_counts.read()
    routes = dict(pipeline.ROUTES.counts)
    if rc != 0:
        raise RuntimeError(f"[{label}] device search failed ({rc})")
    return launches, routes, wall, torch.cuda.max_memory_allocated() / 2**20


def host_parity(work: str, idx: str, recs, n_reads: int, out_dev: str,
                label: str) -> tuple[set, list]:
    """The device TSV equals ``--engine host`` byte for byte on the first
    CHECK_READS reads and the long ones; returns (their ids, the host
    rows)."""
    from taxor_tpu_torch import cli

    sub = recs[:min(CHECK_READS, n_reads)] + recs[n_reads:]
    sub_fa = os.path.join(work, f"{label}_subset.fasta")
    write_fasta(sub_fa, sub)
    out_host = os.path.join(work, f"{label}_host.tsv")
    t0 = time.perf_counter()
    rc = cli.main(["search", "--index-file", idx, "--query-file", sub_fa,
                   "--output-file", out_host, "--engine", "host",
                   "--device", "cuda", "--threads",
                   str(os.cpu_count() or 1)])
    if rc != 0:
        raise RuntimeError(f"[{label}] host search failed ({rc})")
    ids = {rid for rid, _ in sub}
    dev_rows, host_rows = tsv_rows(out_dev, ids), tsv_rows(out_host)
    if dev_rows != host_rows:
        bad = next(i for i, (a, b) in enumerate(zip(dev_rows, host_rows))
                   if a != b) if len(dev_rows) == len(host_rows) else -1
        raise AssertionError(f"[{label}] device TSV differs from host TSV "
                             f"(row {bad}, {len(dev_rows)} vs "
                             f"{len(host_rows)} rows)")
    log(f"[{label}] parity: device TSV == host TSV byte for byte on "
        f"{len(sub)} reads ({len(host_rows)} rows; host engine "
        f"{time.perf_counter() - t0:.1f} s)")
    return ids, host_rows


def accuracy(out_dev: str, recs) -> tuple[int, int]:
    """(classified reads, those whose first row names their source
    genome)."""
    first = {}
    for row in tsv_rows(out_dev):
        rid, acc = row.split("\t", 2)[:2]
        first.setdefault(rid, acc)
    hits = [rid for rid, _ in recs if first.get(rid, "-") != "-"]
    return len(hits), sum(first[rid] == rid.split("_", 1)[1] for rid in hits)


def main_path(torch, work: str, rng, n_genomes: int, n_reads: int,
              layout: str) -> dict:
    """Build an index of n_genomes with --layout ``layout``, search
    n_reads + LONG_READS through the device engine with the launch
    counts set to 0 just before, check the TSV against --engine host on
    a subset and the classifications against the source genomes."""
    from taxor_tpu_torch.device import e2e

    t0 = time.perf_counter()
    tsv, gdir, genomes = make_genomes(rng, work, n_genomes, GENOME_LEN)
    recs = make_reads(rng, genomes, n_reads, LONG_READS)
    reads = os.path.join(work, "reads.fasta")
    write_fasta(reads, recs)
    log(f"[{layout}] data: {n_genomes} genomes x {GENOME_LEN} b, {n_reads} "
        f"reads ({sum(len(s) for _, s in recs[:n_reads]) / 1e6:.1f} Mb) + "
        f"{LONG_READS} x 40 kb, made in {time.perf_counter() - t0:.1f} s")
    idx, index = cli_build(work, tsv, gdir,
                           ["--kmer-size", str(K), "--syncmer-size", str(S),
                            "--use-syncmer"], layout, layout)

    # ---- the main path, counted
    out_dev = os.path.join(work, "device.tsv")
    launches, routes, wall, peak = device_search(torch, idx, reads, out_dev,
                                                 layout)
    if launches["K1"] <= 0 or launches["K2"] + launches["K2n"] <= 0 \
            or launches["K4"] <= 0 or launches["K6"] <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if routes["long_fused"] != LONG_READS or routes["host_hashes"] != 0:
        raise AssertionError(f"[{layout}] routes {routes}: every read past "
                             "L_CAP must take the fused step in pieces")
    if layout == "flat" and launches["K2 slab"] <= 0:
        raise AssertionError(f"the flat path did not take K2's slab route: "
                             f"{launches}")
    if layout == "auto" and (launches["K2n smem"] <= 0
                             or launches["K2n rows"] <= 0):
        raise AssertionError(f"the hierarchical path did not run both K2n "
                             f"modes: {launches}")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    n_total = len(recs)
    log(f"[{layout}] main path: {n_total} reads in {wall:.2f} s wall = "
        f"{n_total / wall:.1f} reads/s; .time [{phases}]; launches "
        f"{launches}; routes {routes} (host-oracle fallback "
        f"{routes['host_fallback'] / n_total:.4f}); peak device memory "
        f"{peak:.1f} MiB")

    # ---- byte parity with the host engine on a subset
    ids, host_rows = host_parity(work, idx, recs, n_reads, out_dev, layout)

    # ---- the split engine on the same reads, counted
    out_split = os.path.join(work, "split.tsv")
    e2e.USE_FUSED_EXTRACT = False
    try:
        split, split_routes, wall_split, split_peak = device_search(
            torch, idx, reads, out_split, layout)
    finally:
        e2e.USE_FUSED_EXTRACT = True
    if split["K1"] != 0 or split["track"] <= 0 or split["K3"] <= 0 \
            or split["K4"] <= 0 or split["K6"] <= 0:
        raise AssertionError(f"split engine: wrong kernels launched {split}")
    if split_routes["long_fused"] != LONG_READS:
        raise AssertionError(f"split engine: routes {split_routes}")
    with open(out_dev, "rb") as fa, open(out_split, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("split-engine TSV differs from the K1 TSV")
    if tsv_rows(out_split, ids) != host_rows:
        raise AssertionError("split-engine TSV differs from the host TSV")
    log(f"[{layout}] split engine: {n_total} reads in {wall_split:.2f} s "
        f"wall = {n_total / wall_split:.1f} reads/s; TSV == K1 TSV on every "
        f"read and == host on {len(ids)}; launches {split}; routes "
        f"{split_routes}; peak device memory {split_peak:.1f} MiB")

    # ---- the result is right: a classified read names its source genome
    hits, right = accuracy(out_dev, recs)
    if right < 0.99 * hits:
        raise AssertionError(f"only {right} of {hits} classified reads "
                             "name their source genome")
    log(f"[{layout}] accuracy: {hits}/{n_total} reads classified, "
        f"{right} of them to their source genome")
    return {"index": index, "recs": recs, "launches": launches,
            "split": split, "routes": routes, "peak_mib": peak,
            "split_peak_mib": split_peak, "tsv": tsv, "gdir": gdir,
            "reads": reads, "n_reads": n_reads, "idx": idx,
            "device_tsv": out_dev}


def hier_report(torch, state) -> None:
    """The hierarchical path's shape and descent activity; asserts a
    hierarchy with a stacked group and the grouped probe, and that no
    probe ran on the per-IXF traversal (every read, those past L_CAP in
    pieces, took the fused step; phase 7b drives the traversal)."""
    from taxor_tpu_torch.device import hixf_search

    dh = hixf_search.DeviceHIXF.from_hixf(state["index"].hixf, "cuda")
    Gs = [g["tables"].shape[0] for g in dh.groups]
    depth = max(dh._depths().values())
    launches = state["launches"]
    counts_route = (launches["K2 routes"].get("host_hashes", 0)
                    + launches["K2n routes"].get("host_hashes", 0))
    log(f"[auto] tree: {len(dh.ixfs)} IXFs, depth {depth}; {sum(Gs)} probe "
        f"subgroups in {len(Gs)} launches per batch, stacked groups G="
        f"{[G for G in Gs if G > 1]}, tables "
        f"{[tuple(g['tables'].shape) for g in dh.groups]}; active "
        f"(subgroup, read) pairs {hixf_search.ACTIVITY.share():.4f}; "
        f"probe launches on the per-IXF traversal {counts_route}")
    if len(dh.ixfs) <= 1 or max(Gs) < 2:
        raise AssertionError("the hierarchical cell has no hierarchy or no "
                             "stacked group")
    from taxor_tpu_torch.device import probe

    modes = [probe.narrow_mode(*g["tables"].shape[1:], "cuda")
             for g in dh.groups]
    log(f"[auto] K2n mode of each group: "
        f"{[(tuple(g['tables'].shape), int(g['run_s'].shape[0]), m) for g, m in zip(dh.groups, modes)]}"
        f" (shape, runs, mode); main-path launches by mode: smem "
        f"{launches['K2n smem']}, rows {launches['K2n rows']}")
    if modes[0] != "rows" or not any(
            m == "smem" for G, m in zip(Gs, modes) if G > 1):
        raise AssertionError(f"K2n modes: root {modes[0]}, stacked groups "
                             f"{modes[1:]}; expected rows on the root and "
                             "smem on a stacked group")
    fused = (launches["K2 routes"].get("fused", 0)
             + launches["K2n routes"].get("fused", 0))
    if fused <= 0 or counts_route != 0 \
            or state["routes"]["host_hashes"] != 0:
        raise AssertionError(f"the probe took a route other than the fused "
                             f"step: {launches}")
    state["dh"] = dh


def check_wide_root(torch, work: str) -> None:
    """Phase 7b: a hierarchical index whose root has 529 technical bins
    (a hand-written layout over 540 genomes of 600 b, as a build at the
    default --tmax gives roots past 512 bins): its descent group takes
    K2's dense counts and their segment sums on the card, in the grouped
    step and in the per-IXF traversal, equal to the CPU twins."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device import probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.hash.schemes import search_hashes
    from taxor_tpu_torch.search.thresholds import Thresholder
    from taxor_tpu_torch.tools import synth

    rng = np.random.default_rng(SEED + 7)
    os.makedirs(work)
    tsv, gdir, genomes = synth.make_ref_set(work, rng, n_species=540,
                                            genome_len=600)
    files = [os.path.join(gdir, f"{acc}_genomic.fna") for acc in genomes]
    layout = os.path.join(work, "wide.out")
    root_bins = synth.write_wide_root_layout(files, layout)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=K, syncmer_size=S, use_syncmer=True, layout_file=layout,
        resume=True))
    seqs = list(genomes.values())
    reads = [synth.simulate_read(rng, seqs[i], 400, 0.02)
             for i in [0, 1, *range(520, 540), *rng.integers(1, 520, 100)]]
    packed, lengths = dsync.pack_reads(reads, 512)
    th = Thresholder.make(K, K, 0.04, -1.0, True)
    dhs = [DeviceHIXF.from_hixf(index.hixf, d) for d in ("cpu", "cuda")]
    shapes = [tuple(g["tables"].shape) for g in dhs[1].groups]
    if shapes[0][2] <= probe.NARROW_MAX_BINS:
        raise AssertionError(f"wide root: groups {shapes}")
    before = dict(probe.k2_counts.ROUTES)
    out = [dh.e2e_async(packed, lengths, index.scheme, th)() for dh in dhs]
    for a, b in zip(out[0][:4], out[1][:4]):
        if not np.array_equal(a, b):
            raise AssertionError("wide root: the grouped step on the card "
                                 "differs from the CPU twins")
    hl = search_hashes(reads, index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    hi, lo, valid = probe.pack_hash_lists(hl, max(h.shape[0] for h in hl))
    dense = [dh.counts(hi, lo, valid, thr) for dh in dhs]
    if not all(np.array_equal(a, b) for a, b in zip(*dense)):
        raise AssertionError("wide root: the per-IXF traversal on the card "
                             "differs from the CPU twins")
    grew = {r: n - before.get(r, 0) for r, n in probe.k2_counts.ROUTES.items()}
    if grew.get("fused") != 1 or grew.get("host_hashes") != 1 \
            or not (out[1][0][:, 0] > 0).all():
        raise AssertionError(f"wide root: K2 launches by route {grew}")
    log(f"phase 7b: a {root_bins}-bin root (groups {shapes}): {len(reads)} "
        f"reads, grouped step and per-IXF traversal on K2 + segment sums "
        f"equal to the CPU twins")


def time_pair(torch, fn, plain, reps: int):
    """(kernel ms, plain ms, max abs err), each the best of two means,
    timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, 1)
    m1 = cuda_ms(fn, reps)
    m2 = cuda_ms(fn, reps)
    p2 = cuda_ms(plain, 1)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
              for a, b in zip(got, want))
    if err != 0.0:
        raise AssertionError("a kernel differs from its twin")
    return min(m1, m2), min(p1, p2), err, (m1, m2, p1, p2)


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of nbytes over the
    memory rate and ops over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / peak * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def tracker_ops(k: int, s: int) -> int:
    """Integer operations a base of the position-parallel tracker
    (csrc/tracker.cuh) takes: ~12 for the canonical s-mer (a funnel
    shift, a bit reversal and a pair swap, the complement, the min), 4 a
    window element for the scan (two compares, the minimum and an argmin
    selected), ~6 to classify the window and ballot it: 62 at w = 11.  A
    64-bit s-mer (s >= 16) takes ~22 (two funnel shifts and reversals,
    the 64-bit shift, complement and min) and 6 a window element (its
    compares take two words)."""
    if s >= 16:
        return 22 + 6 * (k - s + 1) + 6
    return 12 + 4 * (k - s + 1) + 6


# a canonical k-mer: two funnel shifts, two 2-bit reversals and their
# 64-bit shift, the complement and mask, the min
KMER_OPS = 14


def sort_ops(n) -> float:
    """Compare-exchanges of bitonic networks over pow2(n) keys, per row."""
    P = [1 << max(0, x - 1).bit_length() for x in n]
    return float(sum(p // 2 * (p.bit_length() - 1) * p.bit_length() // 2
                     for p in P))


def bucket_reads(recs, L: int) -> list[bytes]:
    """POS_BUDGET / L reads of the L bucket, as the pipeline batches them."""
    from taxor_tpu_torch.search.pipeline import POS_BUDGET

    seqs = [s for _, s in recs if L // 2 < len(s) <= L]
    n = POS_BUDGET // L
    return (seqs * (n // max(1, len(seqs)) + 1))[:n]


def time_kernels(torch, state) -> list[dict]:
    """K1 and K2 against their twins at the flat path's L=8192 bucket."""
    from taxor_tpu_torch.device import extract, probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_extract import all_tied_reads

    dev = torch.device("cuda")
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    t = (K - S + 1) // 2
    ln = torch.from_numpy(lengths).to(dev)
    hcap = dsync.hash_cap(L, K, S, t)
    dh = DeviceHIXF.from_hixf(state["index"].hixf, dev)
    k1 = lambda: extract.syncmer_hashes(pk, ln, K, S, t, hcap)  # noqa: E731
    k1p = lambda: extract.syncmer_hashes_plain(pk, ln, K, S, t,  # noqa: E731
                                               hcap)
    hi, lo, valid, _, n_emit = k1()
    R, H = hi.shape
    S_, Bp = dh.table.shape
    W = extract.sort_width(L, K, S, t)
    bounds = {
        # packed + lengths in; hi, lo, valid, n_unique, n_emit out; the
        # tracker's operations a base, a k-mer an emission, the sort
        # network, one hash a slot
        "syncmer_extract": bound(
            pk.numel() + 4 * R + 9 * R * H + 8 * R,
            float(ln.sum()) * tracker_ops(K, S)
            + float(n_emit.sum()) * KMER_OPS
            + sort_ops(n_emit.clamp(max=W).tolist()) + R * H,
            PEAK_SCALAR),
        # hashes in, the table once, counts out; one fingerprint-byte
        # compare per valid hash and bin (either variant of K2)
        "probe_count": bound(9 * R * H + S_ * Bp + 4 * R * Bp,
                             float(valid.sum()) * Bp, PEAK_INT8)}
    bounds["probe_count_rows"] = bounds["probe_count"]
    tables = dh.table[None]
    k2 = lambda: probe.probe_counts(hi, lo, valid, dh.table,  # noqa: E731
                                    dh.seed, dh.block_length)
    k2r = lambda: probe.k2_counts(hi, lo, valid, tables, None,  # noqa: E731
                                  dh.seed, dh.block_length,
                                  variant="rows")[0]
    k2p = lambda: probe.probe_counts_plain(hi, lo, valid,  # noqa: E731
                                           dh.table, dh.seed,
                                           dh.block_length)
    n_valid = int(valid.sum())
    row_bytes = 3 * n_valid * Bp  # the table rows the probe reads
    rows = []
    for name, src, rep, fn, plain, reps in (
            ("syncmer_extract", "taxor_tpu_torch/csrc/extract.cu",
             "taxor_tpu/device/pallas_extract.py:160", k1, k1p, 5),
            ("probe_count", "taxor_tpu_torch/csrc/probe_slab.cu",
             "taxor_tpu/device/pallas_probe.py:257", k2, k2p, 20),
            ("probe_count_rows", "taxor_tpu_torch/csrc/probe.cu",
             "taxor_tpu/device/pallas_probe.py:257", k2r, k2p, 20)):
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        log(f"time {name} at R={len(seqs)}, L={L}, H={hcap}, table "
            f"{tuple(dh.table.shape)}: kernel {each[0]:.4f}/{each[1]:.4f} "
            f"ms, plain {each[2]:.3f}/{each[3]:.3f} ms")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bounds[name],
                     "library_ms": None})
        if name.startswith("probe_count"):
            rows[-1].update(valid_hashes=n_valid, row_bytes=row_bytes,
                            rows_gbps=row_bytes / ms / 1e6)
    rows[1]["slab_bins"] = probe.slab_bins(S_, Bp, H, dev)
    # thin slabs of 8 and 4 bins and the split variant forced on the
    # same table (the slab record's flat_forced)
    forced = {"table": [S_, Bp], "valid_hashes": n_valid,
              "slab_ms": rows[1]["ms"], "rows_ms": rows[2]["ms"]}
    k2s = (hi, lo, valid, tables, None, dh.seed, dh.block_length)
    for v, fn in (("thin8", lambda: probe._launch(*k2s, 8)[0]),
                  ("thin4", lambda: probe._launch(*k2s, 4)[0]),
                  ("split", lambda: probe.k2_counts(*k2s,
                                                    variant="split")[0])):
        forced[f"{v}_ms"], forced["plain_ms"], _, each = time_pair(
            torch, fn, k2p, 10)
        log(f"time K2 ({v}, forced) at the flat table [{S_}, {Bp}]: kernel "
            f"{each[0]:.4f}/{each[1]:.4f} ms, plain {each[2]:.3f}/"
            f"{each[3]:.3f} ms; bit-exact vs twin")
    rows[1]["flat_forced"] = forced
    log(f"time K2 at the flat table [{S_}, {Bp}]: {n_valid} valid hashes "
        f"({n_valid / R:.1f} a read), {row_bytes / 1e9:.3f} GB of rows; slab "
        f"route ({rows[1]['slab_bins']} bins a slab) {rows[1]['ms']:.4f} ms "
        f"= {rows[1]['rows_gbps']:.1f} GB/s of rows from shared memory; rows "
        f"route {rows[2]['ms']:.4f} ms = {rows[2]['rows_gbps']:.1f} GB/s "
        f"from L2; bound {rows[1]['bound_ms']:.4f} ms "
        f"({rows[1]['bound_by']})")
    state["k1_ms"] = rows[0]["ms"]

    # the worst case: every window of every read tied
    tied = all_tied_reads(np.random.default_rng(SEED + 5), L, len(seqs))
    tpk, tln = (torch.from_numpy(x).to(dev)
                for x in dsync.pack_reads(tied, L))
    state["all_tied"] = (tpk, tln)
    worst, _, _, each = time_pair(
        torch, lambda: extract.syncmer_hashes(tpk, tln, K, S, t, hcap),
        lambda: extract.syncmer_hashes_plain(tpk, tln, K, S, t, hcap), 3)
    rows[0]["all_tied_ms"] = worst
    log(f"time syncmer_extract worst case, R={len(tied)} reads tied in "
        f"every window (homopolymers, tandem repeats of period 2-5) at "
        f"L={L}: kernel {each[0]:.4f}/{each[1]:.4f} ms "
        f"({worst / rows[0]['ms']:.1f}x the flat path's reads), plain "
        f"{each[2]:.3f}/{each[3]:.3f} ms; bit-exact vs twin")
    return rows


def time_split(torch, state) -> list[dict]:
    """K3 against the pair-sort route (K4) on the flat path's L=8192
    reads; then syncmer_track, K3 and K4 timed against their twins, K4
    against torch.sort of the combined key, and the split engine's
    extraction against K1 (phase 10)."""
    from taxor_tpu_torch.device import extract, sort
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_sort import device_ms
    from taxor_tpu_torch.utils.u64 import INT64_MIN, join32, split32

    dev = torch.device("cuda")
    L = 8192
    t = (K - S + 1) // 2
    gap = dsync.emission_min_gap(K, S, t)
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    hcap = dsync.hash_cap(L, K, S, t)
    R = len(seqs)
    kmer, emit = extract.syncmer_track(pk, ln, K, S, t)
    fused = sort.dedup_fused(kmer, emit, hcap, gap)
    sort.sort_pairs.LAUNCHES = 0
    pairs = sort.dedup_pairs(kmer, emit, hcap)
    state["k4_check"] = sort.sort_pairs.LAUNCHES
    assert_equal(torch, "K3 vs the pair-sort route", ("kmer", "valid",
                 "n_unique", "n_emit"), fused, pairs)
    if state["k4_check"] != 1:
        raise AssertionError(f"dedup_pairs launched K4 {state['k4_check']} "
                             "times, not once")
    log(f"K3 == sort.dedup_pairs (K4 over [{R}, {L}]) on the flat path's "
        f"L={L} reads")

    hi, lo = split32(torch.where(emit, kmer, torch.full_like(kmer, -1)))
    keys = join32(hi, lo) ^ INT64_MIN
    n_emit = fused[3]
    Wb = sort.dedup_width(L, gap)
    # the k-mers K3 needs: the first Wb emissions of a row, as the
    # 32-byte sectors (the memory's least transfer) that hold one,
    # counted from this batch
    needed = emit & (emit.cumsum(1) <= Wb)
    sectors = float(needed.view(R, L // 4, 4).any(2).sum())
    Wp = L
    cases = (
        ("syncmer_track", "taxor_tpu_torch/csrc/extract.cu",
         "taxor_tpu/hash/device_syncmer.py:279 (XLA scan, no Pallas "
         "kernel)", lambda: extract.syncmer_track(pk, ln, K, S, t),
         lambda: dsync.syncmer_kmers(pk, ln, K, S, t), None, 5,
         # packed + lengths in, kmer + emit out; the tracker's operations
         # a base and a k-mer a position
         bound(pk.numel() + 4 * R + 9 * R * L,
               float(ln.sum()) * tracker_ops(K, S) + R * L * KMER_OPS,
               PEAK_SCALAR)),
        ("dedup", "taxor_tpu_torch/csrc/dedup.cu",
         "taxor_tpu/device/pallas_sort.py:68",
         lambda: sort.dedup_fused(kmer, emit, hcap, gap),
         lambda: sort.dedup_fused_plain(kmer, emit, hcap, gap), None, 20,
         # emit read whole and the needed k-mers' sectors in; kmer,
         # valid, counts out; a scan of the row and the sort network over
         # the emissions
         bound(R * L + 32 * sectors + 9 * R * hcap + 8 * R,
               R * L + sort_ops(n_emit.clamp(max=Wb).tolist()),
               PEAK_SCALAR)),
        ("sort_pairs", "taxor_tpu_torch/csrc/sort_pairs.cu",
         "taxor_tpu/device/pallas_sort.py:62",
         lambda: sort.sort_pairs(hi, lo),
         lambda: sort.sort_pairs_plain(hi, lo),
         lambda: torch.sort(keys, dim=1), 20,
         bound(16 * R * L, sort_ops([Wp] * R), PEAK_SCALAR)))
    rows = []
    for name, src, rep, fn, plain, library, reps, bnd in cases:
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        lib_ms = None if library is None else cuda_ms(library, reps)
        log(f"time {name} at R={R}, L={L}, hcap={hcap}: kernel "
            f"{each[0]:.4f}/{each[1]:.4f} ms, plain {each[2]:.3f}/"
            f"{each[3]:.3f} ms, library {lib_ms}, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bnd, "library_ms": lib_ms})
        if name != "syncmer_track":  # K3, K4: the kernel alone, host gaps out
            rows[-1]["device_ms"] = device_ms(fn, reps, rounds=1)
            log(f"time {name} on the device alone: "
                f"{rows[-1]['device_ms']:.4f} ms")

    tpk, tln = state["all_tied"]
    assert_equal(torch, "syncmer_track on reads tied everywhere",
                 ("kmer", "emit"), extract.syncmer_track(tpk, tln, K, S, t),
                 dsync.syncmer_kmers(tpk, tln, K, S, t))
    rows[0]["all_tied_ms"] = cuda_ms(
        lambda: extract.syncmer_track(tpk, tln, K, S, t), 3)
    log(f"time syncmer_track worst case (phase 5's {tpk.shape[0]} reads "
        f"tied everywhere) at L={L}: {rows[0]['all_tied_ms']:.4f} ms; "
        "bit-exact vs twin")

    def split_extract():
        km, em = extract.syncmer_track(pk, ln, K, S, t)
        srt, valid, _, _ = sort.dedup_fused(km, em, hcap, gap)
        return extract.hashes_of_kmers(srt, valid)

    split_ms = cuda_ms(split_extract, 5)
    log(f"time split extraction (syncmer_track + K3 + wyhash) at R={R}, "
        f"L={L}: {split_ms:.4f} ms vs K1 {state['k1_ms']:.4f} ms")
    return rows


def narrow_bound(hi, valid, tables, act, n_runs: int) -> dict:
    """K2n's least time for one run-sum launch: the hashes (9 bytes a
    slot) of the reads with an active pair and the mask read once, the
    tables of the subgroups with an active read, the [n_runs, R] sums
    written once; one fingerprint-byte compare per valid hash of an
    active (subgroup, read) pair and bin."""
    G, S_, Bp = tables.shape
    R, H = hi.shape
    active_hashes = float((act.long() * valid.sum(1)[None]).sum())
    reads = int(act.any(0).sum())
    loaded = int(act.any(1).sum())
    return bound(9 * reads * H + G * R + loaded * S_ * Bp + 4 * n_runs * R,
                 active_hashes * Bp, PEAK_INT8)


def time_hier(torch, state) -> list[dict]:
    """Phase 8: every group of one descent batch at the hierarchical
    path's L=8192 and L=4096 buckets, with the descent's own activity
    masks: (a) the dense K2n counts and their int64 segment sums against
    (b) the run-sum launch, timed a, b, b, a by cuda_ms and again by
    device_ms, both bit-exact to the twin;
    K2n's record (the root and the widest group at L=8192, against the
    twin) and K2 (the variant each shape picks) on the root and the first
    stacked level."""
    from taxor_tpu_torch.search.thresholds import (Thresholder,
                                                   count_thresholds)
    from taxor_tpu_torch.device import extract, probe
    from taxor_tpu_torch.device.e2e import descend
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_sort import device_ms

    dev = torch.device("cuda")
    dh = state["dh"]
    th = Thresholder.make(K, K, 0.04, -1.0, True)
    stacked = next(i for i, g in enumerate(dh.groups)
                   if g["tables"].shape[0] > 1)
    widest = max(range(len(dh.groups)),
                 key=lambda i: dh.groups[i]["tables"].shape[0])
    per_group, record = [], None
    for L in (8192, 4096):
        seqs = bucket_reads(state["recs"], L)
        packed, lengths = dsync.pack_reads(seqs, L)
        hcap = dsync.hash_cap(L, K, S, (K - S + 1) // 2)
        hi, lo, valid, n_unique, _ = extract.syncmer_hashes(
            torch.from_numpy(packed).to(dev),
            torch.from_numpy(lengths).to(dev), K, S, (K - S + 1) // 2, hcap)
        thr = torch.from_numpy(count_thresholds(th, hcap)).to(dev)[
            n_unique.clamp(0, hcap).long()]
        R = hi.shape[0]
        for gi, g in enumerate(dh.groups):
            act = descend(dh.groups, len(dh.bfs_order), hi, lo, valid, thr,
                          upto=gi)
            tables = g["tables"]
            runs = (g["run_off"], g["run_s"], g["run_e"])
            run_g = probe.run_groups(g["run_off"])
            a = (hi, lo, valid, tables, act)
            sk = (g["seed"], g["bl"])
            dense = lambda: probe.segment_sums(  # noqa: E731
                probe.k2n_counts(*a, *sk), run_g, g["run_s"], g["run_e"])
            fused = lambda: probe.probe_run_sums_grouped(  # noqa: E731
                *a, *runs, *sk)
            plain = lambda: probe.probe_run_sums_grouped_plain(  # noqa: E731
                *a, *runs, *sk)
            want = plain()
            assert_equal(torch, f"group {gi} at L={L}", ("dense", "fused"),
                         (dense(), fused()), (want, want))
            a1, b1 = cuda_ms(dense, 10), cuda_ms(fused, 20)
            b2, a2 = cuda_ms(fused, 20), cuda_ms(dense, 10)
            da1, db1 = device_ms(dense, 10, 1), device_ms(fused, 20, 1)
            db2, da2 = device_ms(fused, 20, 1), device_ms(dense, 10, 1)
            n_runs = int(g["run_s"].shape[0])
            row = {"L": L, "R": R, "shape": list(tables.shape),
                   "active_pairs": int(act.sum()), "pairs": act.numel(),
                   "n_runs": n_runs,
                   "mode": probe.narrow_mode(*tables.shape[1:], dev),
                   "dense_ms": min(a1, a2), "ms": min(b1, b2),
                   "dense_device_ms": min(da1, da2),
                   "device_ms": min(db1, db2),
                   **narrow_bound(hi, valid, tables, act, n_runs)}
            per_group.append(row)
            log(f"time group {gi} at L={L}, R={R}: tables "
                f"{tuple(tables.shape)}, {row['active_pairs']}/"
                f"{row['pairs']} (subgroup, read) pairs active, {n_runs} "
                f"runs, K2n mode {row['mode']}: (a) dense counts + segment "
                f"sums {a1:.4f}/{a2:.4f} ms, (b) run sums {b1:.4f}/{b2:.4f} "
                f"ms; on the device alone (a) {da1:.4f}/{da2:.4f} ms, (b) "
                f"{db1:.4f}/{db2:.4f} ms; bound of (b) {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']})")
            if L != 8192:
                continue
            if gi in (0, widest):
                ms, plain_ms, err, each = time_pair(torch, fused, plain, 20)
                log(f"time probe_count_narrow (run sums) on group {gi} at "
                    f"L={L}: kernel {each[0]:.4f}/{each[1]:.4f} ms, plain "
                    f"{each[2]:.3f}/{each[3]:.3f} ms")
                if gi == 0:
                    record = {
                        "name": "probe_count_narrow", "route": "cuda",
                        "source": "taxor_tpu_torch/csrc/probe_narrow.cu",
                        "replaces": "taxor_tpu/device/pallas_probe.py:578",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **narrow_bound(hi, valid, tables, act, n_runs),
                        "library_ms": None, "shape": list(tables.shape),
                        "mode": row["mode"]}
                else:
                    record.update(
                        widest_shape=list(tables.shape), widest_ms=ms,
                        widest_plain_ms=plain_ms, widest_mode=row["mode"],
                        widest_bound_ms=row["bound_ms"],
                        widest_bound_by=row["bound_by"],
                        max_abs_err=max(record["max_abs_err"], err))
            if gi in (0, stacked):
                b = probe.slab_bins(*tables.shape[1:], a[0].shape[1], dev)
                ms, _, _, each = time_pair(
                    torch, lambda: probe.k2_counts(*a, *sk),  # noqa: B023
                    lambda: probe.probe_counts_grouped_plain(  # noqa: B023
                        *a, *sk), 20)
                log(f"time probe_count ({f'slab of {b} bins' if b else 'rows'}"
                    f") dense counts on group {gi} at L={L}: kernel "
                    f"{each[0]:.4f}/{each[1]:.4f} ms")
    record["groups"] = per_group
    return [record]


# ------------------------------------------------------------ phase 13 --
# phase 13d's table past the L2 for a forced slab: 120,000 slots x
# 1,024 bins (123 MB), phase 13b's batch of 5,712 valid slots a read
TALL_SLOTS, TALL_NVALID = 120_000, 5712
# the bench's hier_scaled_minimizer family's scheme (phases 13a and 13e)
MM_K, MM_WINDOW, MM_SCALING = 20, 26, 3
K5_SCHEMES = ((20, 20), (20, 26), (18, 26), (32, 40))  # (k, window)
K5_SCALINGS = (2, 3, 1000)  # phase 13c's FracMinHash keeps
BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# the keep of one emission: wyhash64's 64 x 64 -> 128-bit multiply (seven
# 32-bit multiply-adds), the XOR of its halves and the 64-bit compare
KEEP_OPS = 11


def k5_ops(k: int, window: int) -> int:
    """Integer operations a position of K5 takes before the keep: ~16 for
    the canonical value (funnel shifts of the aligned words and their
    2-bit reversal, the complement and mask, the 64-bit shift, two XORs
    with the seed, the 64-bit minimum); for w' > 1 the window pass, w' + 8
    64-bit minima a thread's run of four positions (window_split: w' - 4
    over the values left of the run, 3 taking in the three oldest, 2
    prefix minima of its own values, 3 merging them, and the four
    emitted minima), 4 operations each, so w' + 8 a position, and ~8 for
    the emission test: 39 at w' = 7, 16 at w' = 1."""
    wp = window - k + 1
    return 16 if wp == 1 else 16 + (wp + 8) + 8


def check_k5(torch, dsync, extract, rng) -> dict:
    """Phase 13c: K5 against its twin, bit for bit (0 where nothing is
    emitted), at every length bucket on phase 2's kinds of reads, for each
    (k, window) of K5_SCHEMES: plain k-mers (w' = 1), windowed minimisers
    and k = 32 (the seed's top bit set); without the FracMinHash keep
    (valid = emit, n_unique = n_emit) and with it for each scaling of
    K5_SCALINGS (the twin followed by the keep as tensor ops); then at
    K5_LONG_BUCKETS, rows of more than one span, for K5_LONG_SCHEMES at
    scalings 1 and 3, and K5 at (20, 26) with no keep timed there (a call
    and on the device alone, beside its twin and its bound): returned by
    bucket, for K5's record."""
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    names = ("hi", "lo", "valid", "n_emit", "n_unique")
    for L in BUCKETS:
        packed, lengths = dsync.pack_reads(k1_reads(rng, L), L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        n_emit, kept = [], []
        for k, window in K5_SCHEMES:
            hi, lo, emit, ne = dsync.minimizer_kmers_plain(pk, ln, k, window)
            assert_equal(torch, f"K5 L={L} k={k} window={window}", names,
                         extract.minimizer_kmers(pk, ln, k, window),
                         (hi, lo, emit, ne, ne))
            n_emit.append(int(ne.sum()))
            for sc in K5_SCALINGS:
                thresh = scaling_threshold_u64(sc)
                valid = emit & extract.scaling_keep(hi, lo, thresh)
                nu = valid.sum(dim=1, dtype=torch.int32)
                assert_equal(torch, f"K5 L={L} k={k} window={window} "
                             f"scaling {sc}", names,
                             extract.minimizer_kmers(pk, ln, k, window,
                                                     thresh),
                             (hi, lo, valid, ne, nu))
                kept.append(int(nu.sum()))
        log(f"K5 L={L}: bit-exact vs twin on {pk.shape[0]} reads for (k, "
            f"window) {list(K5_SCHEMES)}, with no keep and the keeps of "
            f"scalings {list(K5_SCALINGS)} (emissions {n_emit}; kept by "
            f"scheme and scaling {kept})")
    from taxor_tpu_torch.tools.time_sort import device_ms

    own = np.random.default_rng(SEED + 5)  # the main draws stay as they were
    long_rows = {}
    for L in K5_LONG_BUCKETS:
        packed, lengths = dsync.pack_reads(span_reads(own, L), L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        n_emit = []
        for k, window in K5_LONG_SCHEMES:
            for sc in (1, 3):
                thresh = scaling_threshold_u64(sc) if sc > 1 else 0
                got = extract.minimizer_kmers(pk, ln, k, window, thresh)
                assert_equal(torch, f"K5 L={L} k={k} window={window} "
                             f"scaling {sc}", names, got,
                             extract.minimizer_hashes_plain(
                                 pk, ln, k, window, thresh))
                n_emit.append(int(got[3].sum()))
        R = pk.shape[0]
        ms, plain_ms, err, _ = time_pair(
            torch, lambda: extract.minimizer_kmers(pk, ln, MM_K, MM_WINDOW),
            lambda: extract.minimizer_hashes_plain(pk, ln, MM_K, MM_WINDOW),
            3)
        long_rows[f"L{L}"] = dict(
            reads=R, width=L, window=MM_WINDOW, ms=ms,
            dev_ms=device_ms(lambda: extract.minimizer_kmers(
                pk, ln, MM_K, MM_WINDOW)), plain_ms=plain_ms,
            max_abs_err=err,
            # packed + lengths in; hi, lo, valid, n_emit, n_unique out
            **bound(pk.numel() + 4 * R + 9 * R * L + 8 * R,
                    float(R * L) * k5_ops(MM_K, MM_WINDOW), PEAK_SCALAR))
        log(f"K5 L={L} (spans of {K5_SPAN}): bit-exact vs "
            f"twin on {R} reads with N runs and homopolymers across every "
            f"span boundary, for (k, window) {list(K5_LONG_SCHEMES)} at "
            f"scalings 1 and 3 (emissions {n_emit}); timed at ({MM_K}, "
            f"{MM_WINDOW}): {json.dumps(long_rows[f'L{L}'])}; {card_line()}")
    log(f"phase 13c: K5 checked in {time.perf_counter() - t0:.1f} s")
    return long_rows


# phase 13c's rows past K5's span: the first bucket past L_CAP and the
# bucket of reads of 0.5-1 Mb; w' = 1, w' = 7 and k = 32
K5_LONG_BUCKETS = (65504, 1047584)
K5_LONG_SCHEMES = ((20, 20), (20, 26), (32, 40))
# end positions of one K5 cluster (csrc/minimizer.cu kSpan): the span
# boundaries the reads of span_reads put their ties across
K5_SPAN = 32768


def span_reads(rng, L: int) -> list[bytes]:
    """16 reads of bucket L, past K5's span: random reads of L/2 to L
    bases; reads with an N run, a homopolymer or a tandem repeat across
    every span boundary (the windows tied there); one just past L_CAP;
    one of the full bucket."""
    from taxor_tpu_torch.hash.device_syncmer import L_CAP

    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(L // 2, L)))]
            .tobytes() for _ in range(8)]
    for fill in (b"N", b"A", b"T", b"AC", b"ACG"):
        arr = ACGT[rng.integers(0, 4, L - 5)].copy()
        for b in range(K5_SPAN, L, K5_SPAN):
            arr[b - 45:b + 35] = np.frombuffer(fill * 80, np.uint8)[:80]
        seqs.append(arr.tobytes())
    seqs.append(ACGT[rng.integers(0, 4, L_CAP + 5)].tobytes())
    seqs.append(ACGT[rng.integers(0, 4, L)].tobytes())
    return seqs + [b""]


def kmer_data(rng, work: str, n_genomes: int, n_reads: int) -> dict:
    """Phase 13a's or 13b's data: n_genomes genomes of phase 7's kind and
    n_reads reads of its recipe plus LONG_READS over L_CAP."""
    os.makedirs(work)
    tsv, gdir, genomes = make_genomes(rng, work, n_genomes, GENOME_LEN)
    recs = make_reads(rng, genomes, n_reads, LONG_READS)
    reads = os.path.join(work, "reads.fasta")
    write_fasta(reads, recs)
    return {"tsv": tsv, "gdir": gdir, "reads": reads, "recs": recs,
            "n_reads": n_reads}


def nonsyncmer_path(torch, work: str, label: str, data: dict,
                    need) -> dict:
    """Phase 13a/13b: the minimiser or plain k-mer index ``label`` that a
    background build made of ``data``'s genomes (``data["idx"]``),
    ``cli search --engine device`` of its reads with
    the launch counts set to 0 just before and read just after; the
    kernels ``need`` must have launched, every read must take the fused
    step, the reads over L_CAP too (``long_fused``: K5 on their whole
    bucket), none the host-hash route, and the TSV must equal ``--engine
    host`` on the first CHECK_READS reads and the long ones.  The share
    of classified reads that name their source genome is logged, not
    gated, and so are the activity share and the per-read mode's
    copy-and-threshold host seconds."""
    from taxor_tpu_torch.device.e2e import THRESHOLDS
    from taxor_tpu_torch.device.hixf_search import ACTIVITY
    from taxor_tpu_torch.hixf.index import load_index

    recs, n_reads = data["recs"], data["n_reads"]
    idx = data["idx"][label]
    index = load_index(idx)
    out_dev = os.path.join(work, f"{label}_device.tsv")
    launches, routes, wall, peak = device_search(
        torch, idx, data["reads"], out_dev, label)
    active = ACTIVITY.share()
    thresholds = THRESHOLDS.summary()
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"[{label}] the path skipped one of {need}: "
                             f"{launches}")
    if (routes["fused"] != len(recs) or routes["host_hashes"] != 0
            or routes["long_fused"] != len(recs) - n_reads):
        raise AssertionError(f"[{label}] routes {routes}: expected every "
                             f"read fused, the {len(recs) - n_reads} past "
                             "L_CAP long_fused, none host-hashed")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    log(f"[{label}] main path: {len(recs)} reads in {wall:.2f} s wall = "
        f"{len(recs) / wall:.1f} reads/s; .time [{phases}]; launches "
        f"{launches}; routes {routes}; active (subgroup, read) pairs "
        f"{active:.4f}; per-read thresholds {thresholds}; peak device "
        f"memory {peak:.1f} MiB")
    host_parity(work, idx, recs, n_reads, out_dev, label)
    hits, right = accuracy(out_dev, recs)
    log(f"[{label}] accuracy (reported, not gated): {hits}/{len(recs)} "
        f"reads classified, {right} of them ({right / max(1, hits):.4f}) to "
        f"their source genome")
    return {"index": index, "recs": recs, "n_reads": n_reads,
            "launches": launches, "routes": routes, "peak_mib": peak,
            "wall": wall,
            "active_share": active, "thresholds": thresholds, "idx": idx,
            "device_tsv": out_dev,
            "reads": data["reads"]}


MM_FLAGS = ["--kmer-size", str(MM_K), "--window-size", str(MM_WINDOW),
            "--scaling", str(MM_SCALING)]
KMER_FLAGS = ["--kmer-size", str(MM_K), "--window-size", str(MM_K)]


def build_minimizer(work: str, genomes: int, reads: int) -> dict:
    """Phase 13a's data (phase 7's recipe on data of its own), its index
    under the bench family's whole scheme, --layout auto, and the
    activity share a CPU walk of its reads gives (``walk_share``; a
    background build)."""
    from taxor_tpu_torch.hash import schemes

    data = kmer_data(np.random.default_rng(SEED + 14), work, genomes, reads)
    idx, index = cli_build(work, data["tsv"], data["gdir"], MM_FLAGS,
                           "auto", "minimizer")
    data["idx"] = {"minimizer": idx}
    t0 = time.perf_counter()
    schemes.NUM_THREADS = os.cpu_count() or 1
    # every read takes the fused step, the 16 of 40 kb too
    data["walk_share"] = walk_share(index, [s for _, s in data["recs"]])
    log(f"[minimizer] CPU walk of the per-read thresholds: active share "
        f"{data['walk_share']:.6f} over {len(data['recs'])} reads "
        f"({time.perf_counter() - t0:.1f} s)")
    return data


def build_kmer(work: str, genomes: int, reads: int) -> dict:
    """Phase 13b's data and its flat plain k-mer index, and phase 13e's
    flat index of the same genomes under 13a's scheme (a background
    build)."""
    data = kmer_data(np.random.default_rng(SEED + 13), work, genomes, reads)
    data["idx"] = {
        label: cli_build(work, data["tsv"], data["gdir"], flags, "flat",
                         label)[0]
        for label, flags in (("kmer", KMER_FLAGS), ("scaled", MM_FLAGS))}
    return data


def time_k5(torch, state) -> dict:
    """Phase 13d: K5 against its twin at the minimiser path's L=8192
    bucket (R=512), a call and on the device alone, for the path's scheme
    with no keep, for plain k-mers and for the path's scheme with its
    FracMinHash keep (scaling MM_SCALING), through
    ``tools.time_minimizer.measure``; then the keep as tensor ops on K5's
    output (``time_keep``), the reference for the scaled times."""
    from taxor_tpu_torch.device import extract
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64
    from taxor_tpu_torch.tools import time_minimizer as tm

    dev = torch.device("cuda")
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    R = pk.shape[0]
    if (tm.K, tm.CASES) != (MM_K, (("w7", MM_WINDOW, 1), ("w1", MM_K, 1),
                                   ("w7_scaled", MM_WINDOW, MM_SCALING))):
        raise AssertionError("tools.time_minimizer times another scheme")
    got = tm.measure(pk, ln, dev)
    if not all(got["equal"].values()):
        raise AssertionError(f"K5 differs from its twin: {got['equal']}")
    row = {"name": "minimizer_kmers", "route": "cuda",
           "source": "taxor_tpu_torch/csrc/minimizer.cu",
           "replaces": "taxor_tpu/hash/device_syncmer.py:636 (XLA, no "
                       "Pallas kernel)", "library_ms": None,
           "shape": [R, L], "window": MM_WINDOW,
           "max_abs_err": got["max_abs_err"]}
    n_emit = got["emissions"]["w7"]  # the scaled case's, before the keep
    for key, (name, window, scaling) in zip(("", "plain_kmer_", "scaled_"),
                                            tm.CASES):
        # packed + lengths in; hi, lo, valid, n_emit, n_unique out; the
        # keep's operations an emission
        b = bound(pk.numel() + 4 * R + 9 * R * L + 8 * R,
                  float(R * L) * k5_ops(MM_K, window)
                  + (n_emit * KEEP_OPS if scaling > 1 else 0), PEAK_SCALAR)
        log(f"time minimizer_kmers (K5) k={MM_K} window={window} scaling "
            f"{scaling} at R={R}, L={L}: kernel {got[f'{name}_ms']:.4f} ms "
            f"a call, {got[f'{name}_device_ms']:.4f} on the device alone; "
            f"plain {got[f'{name}_plain_ms']:.3f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); "
            f"{got['emissions'][name]} valid slots")
        row[f"{key}ms"] = got[f"{name}_ms"]
        row[f"{key}device_ms"] = got[f"{name}_device_ms"]
        row[f"{key}plain_ms"] = got[f"{name}_plain_ms"]
        if key:
            row[f"{key}bound_ms"] = b["bound_ms"]
        else:
            row.update(b)
    row["scaling_keep_ms"] = time_keep(
        torch, extract, pk, ln, scaling_threshold_u64(MM_SCALING))
    return row


def time_keep(torch, extract, packed, lengths, thresh: int) -> float:
    """Phase 13d: the FracMinHash keep as tensor ops
    (``extract.scaling_keep``, what followed K5 before K5 took the keep)
    on K5's output of the path's scheme, ms a call; its mask must equal
    K5's own keep and the keep on the CPU."""
    hi, lo, emit, _, _ = extract.minimizer_kmers(packed, lengths, MM_K,
                                                 MM_WINDOW)
    keep = extract.scaling_keep(hi, lo, thresh)
    if not torch.equal(keep.cpu(), extract.scaling_keep(hi.cpu(), lo.cpu(),
                                                        thresh)):
        raise AssertionError("the FracMinHash keep on the card differs "
                             "from the keep on the CPU")
    fused = extract.minimizer_kmers(packed, lengths, MM_K, MM_WINDOW,
                                    thresh)[2]
    if not torch.equal(fused, keep & emit):
        raise AssertionError("K5's FracMinHash keep differs from the keep "
                             "as tensor ops")
    ms1 = cuda_ms(lambda: extract.scaling_keep(hi, lo, thresh), 20)
    ms2 = cuda_ms(lambda: extract.scaling_keep(hi, lo, thresh), 20)
    log(f"time FracMinHash keep as tensor ops (scaling {MM_SCALING}) on "
        f"K5's [{hi.shape[0]}, {hi.shape[1]}] values: {ms1:.4f}/{ms2:.4f} "
        f"ms a call over all {hi.numel()} slots; {int(fused.sum())} of "
        f"{int(emit.sum())} emitted values kept; equal to K5's keep and to "
        f"the CPU's")
    return min(ms1, ms2)


def k2_bound(R: int, H: int, tables, n_valid: int) -> dict:
    """K2's least time: hashes in, the tables once, counts out; one
    fingerprint-byte compare per valid hash (of an active pair) and bin."""
    G, S_, Bp = tables.shape
    return bound(9 * R * H + G * S_ * Bp + 4 * G * R * Bp,
                 float(n_valid) * Bp, PEAK_INT8)


def time_variants(torch, label: str, fn, plain, variants: dict,
                  reps: int) -> dict:
    """{name: kernel ms} of K2 ``variants`` ({name: fn() of the variant})
    on one shape, each held bit-exact to ``plain`` and timed against it
    (time_pair); the route ``fn`` first, as "route", with the plain ms."""
    out = {}
    for name, f in {"route": fn, **variants}.items():
        ms, plain_ms, _, each = time_pair(torch, f, plain, reps)
        out[name] = ms
        out.setdefault("plain_ms", plain_ms)
        log(f"time K2 {label} {name}: kernel {each[0]:.4f}/{each[1]:.4f} "
            f"ms, plain {each[2]:.3f}/{each[3]:.3f} ms; bit-exact vs twin")
    return out


def time_k2_kmer(torch, state) -> tuple[dict, dict]:
    """Phase 13d: K2 at phase 13b's own shape: the L=8192 bucket of its
    reads through K5 (plain k-mers: H = L hash slots, hundreds of hits a
    bin on a read's source genome), probed as the path probes them on
    its flat table, too tall for a 16-bin slab (a thin slab of 4 bins);
    bit-exact to the twin on every read of the batch, then timed against
    it beside the rows route and the split variant forced on the same
    inputs; then the slab route forced on a table past the L2
    (TALL_SLOTS x 1,024 bins, random keys of phase 13b's batch size: a
    slab of 1 bin, which the rule leaves on the rows route) and on phase
    6's stack of two [30,000, 528] tables with a mask, each beside the
    rows route and held to the twin.  Returns the slab route's record at
    13b's shape and the rows route's."""
    from taxor_tpu_torch.device import e2e, probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync

    dev = torch.device("cuda")
    dh = DeviceHIXF.from_hixf(state["index"].hixf, dev)
    L = 8192
    packed, lengths = (torch.from_numpy(x).to(dev) for x in dsync.pack_reads(
        bucket_reads(state["recs"], L), L))
    hi, lo, valid, _, _ = e2e._hashes(packed, lengths, "minimizer", MM_K, 0,
                                      0, MM_K, L, 0)
    R, H = hi.shape
    S_, Bp = dh.table.shape
    tables = dh.table[None]
    sb = (dh.seed, dh.block_length)
    fn = lambda: probe.probe_counts(hi, lo, valid, dh.table,  # noqa: E731
                                    *sb)
    plain = lambda: probe.probe_counts_plain(  # noqa: E731
        hi, lo, valid, dh.table, *sb)
    W = probe.slab_bins(S_, Bp, H, dev)
    before = probe.k2_counts.VARIANTS.get("slab", 0)
    got = fn()
    if probe.k2_counts.VARIANTS.get("slab", 0) != before + 1 or W != 4:
        raise AssertionError(f"K2 at phase 13b's table {(S_, Bp)} did not "
                             f"take a thin slab of 4 bins ({W})")
    assert_equal(torch, f"K2 (slab of {W} bins) at phase 13b's shape R={R}, "
                 f"H={H}", ("counts",), (got,), (plain(),))
    top = int(got.max())
    if top <= 256:
        raise AssertionError(f"K2 at phase 13b's shape: max count {top}, "
                             f"no count past 256")

    def forced(v, *args):
        return lambda: probe.k2_counts(*args, variant=v)[0]

    k2 = (hi, lo, valid, tables, None, *sb)
    kmer = time_variants(torch, f"at phase 13b's shape {(S_, Bp)}", fn,
                         plain, {"rows": forced("rows", *k2),
                                 "split": forced("split", *k2)}, 10)
    n_valid = int(valid.sum())
    b = k2_bound(R, H, tables, n_valid)
    log(f"time probe_count (K2 slab, {W} bins a slab) at phase 13b's shape "
        f"R={R}, L=H={H}, table {(S_, Bp)}: bit-exact vs twin on every read "
        f"(max count {top}, {n_valid} valid hashes); {kmer['route']:.4f} ms "
        f"against the rows route's {kmer['rows']:.4f} and the split "
        f"variant's {kmer['split']:.4f}; plain {kmer['plain_ms']:.3f} ms; "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    rec = {"R": R, "H": H, "table": [S_, Bp], "slab_bins": W,
           "ms": kmer["route"], "plain_ms": kmer["plain_ms"],
           "max_abs_err": 0.0, "max_count": top, "valid_hashes": n_valid,
           **b, "rows_ms": kmer["rows"], "split_ms": kmer["split"]}
    rows_rec = {"R": R, "H": H, "table": [S_, Bp], "ms": kmer["rows"],
                "plain_ms": kmer["plain_ms"], "max_abs_err": 0.0,
                "max_count": top, "valid_hashes": n_valid, **b}
    del got, dh, tables
    # a table past the L2, forced
    rng = np.random.default_rng(SEED + 62)
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    tv = torch.zeros((R, H), dtype=torch.bool, device=dev)
    tv[:, :TALL_NVALID] = True
    th, tl = (torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
              for x in ((keys >> np.uint64(32)).astype(np.uint32),
                        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    tall = torch.randint(0, 256, (1, TALL_SLOTS, 1024), dtype=torch.uint8,
                         device=dev, generator=torch.Generator(
                             device=dev).manual_seed(SEED + 62))
    tsb = (int(rng.integers(0, 2**63)), TALL_SLOTS // 3)
    targs = (th, tl, tv, tall, None, *tsb)
    tplain = lambda: probe.probe_counts_grouped_plain(  # noqa: E731
        *targs)[0]
    tall_ms = time_variants(torch, f"past the L2 {list(tall.shape)}",
                            forced("rows", *targs), tplain,
                            {"slab": forced("slab", *targs)}, 5)
    rec["tall_forced"] = {
        "table": list(tall.shape), "R": R, "H": H,
        "slab_fit": probe.slab_bins(TALL_SLOTS, 1024, H, dev, fit=True),
        "slab_ms": tall_ms["slab"], "rows_ms": tall_ms["route"],
        "plain_ms": tall_ms["plain_ms"],
        **k2_bound(R, H, tall, R * TALL_NVALID)}
    del tall, targs
    # phase 6's stack of two tables with a mask
    x = stack_problem(torch, np.random.default_rng(SEED + 61))
    sp = lambda: probe.probe_counts_grouped_plain(*x)  # noqa: E731
    stack = time_variants(
        torch, f"on the stack {list(x[3].shape)}",
        lambda: probe.probe_counts_grouped(*x), sp,
        {"rows": lambda: probe.k2_counts(*x, variant="rows"),
         "split": lambda: probe.k2_counts(*x, variant="split")}, 10)
    pairs = x[4].long() * x[2].sum(1)[None]
    rec["stack"] = {"tables": list(x[3].shape),
                    "active": int(x[4].sum()), "slab_ms": stack["route"],
                    "rows_ms": stack["rows"], "split_ms": stack["split"],
                    "plain_ms": stack["plain_ms"],
                    **k2_bound(STACK_R, STACK_H, x[3], int(pairs.sum()))}
    return rec, rows_rec


def walk_share(index, seqs) -> float:
    """The share of active (subgroup, read) pairs that a CPU walk of the
    per-read thresholds gives for the reads ``seqs`` (each its own
    batch row): the host's hashes and exact thresholds
    (search/thresholds.device_thresholds), the IXFs the host oracle's
    C++ walk visits (``HIXF.walk``), and the subgroup of the descent's
    groups (``DeviceHIXF.groups``, on the CPU) that holds each; over every
    subgroup of every group a read."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash.schemes import search_hashes
    from taxor_tpu_torch.search.thresholds import (Thresholder,
                                                   device_thresholds)

    sch = index.scheme
    th = Thresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0,
                          sch.use_syncmer)
    hl = search_hashes(seqs, sch)
    thr = device_thresholds(th, [h.shape[0] for h in hl],
                            [len(s) for s in seqs], sch.kmer_size).tolist()
    dh = DeviceHIXF.from_hixf(index.hixf, "cpu")
    pos = {ixf: p for p, ixf in enumerate(dh.bfs_order)}
    sub_of = np.empty(len(dh.bfs_order), dtype=np.int64)
    n_subs = 0
    for g in dh.groups:
        sub_of[g["member_bfs"].numpy()] = n_subs + g["member_sub"].numpy()
        n_subs += g["tables"].shape[0]
    sub_of = sub_of[[pos[i] for i in range(len(dh.bfs_order))]]  # by IXF

    def active(rows) -> int:
        return sum(np.unique(sub_of[index.hixf.walk(hl[r], thr[r])]).size
                   for r in rows)

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        n_active = sum(ex.map(active, np.array_split(
            np.arange(len(seqs)), 8 * (os.cpu_count() or 1))))
    return n_active / (n_subs * len(seqs))


def minimizer_descents(torch, work: str, state: dict, walk: float) -> dict:
    """Phase 13a after its search: the per-read descent's activity share
    must be below 1 and equal ``walk``, the share a CPU walk of the same
    thresholds gives on every fused read (``walk_share``, computed by the
    background build); the same reads searched again with the
    JAX step's descend-all mode forced (``DeviceHIXF.e2e_async`` with
    descend_all=True: no search path takes it) must write the per-read
    TSV byte for byte, with every pair active.  Logs both runs' walls and
    fallbacks and the per-read mode's copy-and-threshold host seconds;
    returns both runs' records."""
    import functools

    from taxor_tpu_torch.device.e2e import THRESHOLDS
    from taxor_tpu_torch.device.hixf_search import ACTIVITY, DeviceHIXF

    label = "minimizer"
    if not state["active_share"] < 1.0 or state["active_share"] != walk:
        raise AssertionError(f"[{label}] the per-read descent's active "
                             f"share {state['active_share']} is not the CPU "
                             f"walk's {walk} below 1")
    log(f"[{label}] per-read active share {state['active_share']:.6f} == "
        f"the CPU walk's")
    per_read = dict(state["routes"], wall=state["wall"],
                    thresholds=state["thresholds"])
    out_all = os.path.join(work, f"{label}_descend_all.tsv")
    real = DeviceHIXF.e2e_async
    DeviceHIXF.e2e_async = functools.partialmethod(real, descend_all=True)
    try:
        _, routes, wall, peak = device_search(torch, state["idx"],
                                              state["reads"], out_all,
                                              f"{label} descend-all")
    finally:
        DeviceHIXF.e2e_async = real
    share = ACTIVITY.share()
    with open(out_all, "rb") as fa, open(state["device_tsv"], "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"[{label}] the descend-all TSV differs "
                                 f"from the per-read TSV")
    if share != 1.0 or THRESHOLDS.batches:
        raise AssertionError(f"[{label}] descend-all left pairs inactive "
                             f"({share}) or computed per-read thresholds")
    all_rec = dict(routes, wall=wall, peak_mib=peak)
    for mode, rec in (("per-read", per_read), ("descend-all", all_rec)):
        log(f"[{label}] {mode}: wall {rec['wall']:.2f} s; fallbacks "
            f"{rec['host_fallback']}/{rec['fused']} "
            f"({rec['host_fallback'] / rec['fused']:.4%}: truncated "
            f"{rec['truncated']}, hcap overflow {rec['hcap_overflow']}); "
            f"top-k escalations {rec['topk_escalations']}"
            + (f"; copy and thresholds {rec['thresholds']}"
               if "thresholds" in rec else "; active share 1.0"))
    log(f"[{label}] descend-all TSV == per-read TSV byte for byte on every "
        f"read")
    return {"per_read": per_read, "descend_all": all_rec,
            "walk_share": walk}


def time_descents(torch, state) -> dict:
    """Phase 13d: every group of one batch of the minimiser hierarchy at
    L=8192 (R=512) in both modes of its fracminhash thresholds: the
    per-read mode's activity (the descent with the thresholds of the
    batch's hash counts, copied to the host and computed there,
    ``e2e.descend(..., upto=g)``) and descend-all's, every pair active.
    Each group's run-sum launch a call (cuda_ms) and on the device alone
    (device_ms), bit-exact to the twin on 16 reads (per-read: the 16 with
    the most active pairs there); then each mode's whole step a call
    (``DeviceHIXF.e2e_step``, CUDA events around it, the per-read mode's
    copy and host thresholds included)."""
    import functools

    from taxor_tpu_torch.device import e2e, probe
    from taxor_tpu_torch.device.hixf_search import _scale_thresh
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.search.thresholds import (Thresholder,
                                                   device_thresholds)
    from taxor_tpu_torch.tools.time_sort import device_ms

    from taxor_tpu_torch.device.hixf_search import DeviceHIXF

    dev = torch.device("cuda")
    index = state["index"]
    dh = DeviceHIXF.from_hixf(index.hixf, dev)
    sch = index.scheme
    th = Thresholder.make(sch.kmer_size, sch.window_size, 0.04, -1.0,
                          sch.use_syncmer)
    L = 8192
    packed, lengths = dsync.pack_reads(bucket_reads(state["recs"], L), L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    hi, lo, valid, n_unique, _ = e2e._hashes(
        pk, ln, "minimizer", MM_K, 0, 0, MM_WINDOW, L, _scale_thresh(sch))
    thr = e2e.read_thresholds(functools.partial(
        device_thresholds, th, kmer_size=sch.kmer_size), n_unique, lengths)
    R = hi.shape[0]
    n_nodes = len(dh.bfs_order)
    rows = {"per_read": [], "descend_all": []}
    for gi, g in enumerate(dh.groups):
        tables = g["tables"]
        runs = (g["run_off"], g["run_s"], g["run_e"])
        sk = (g["seed"], g["bl"])
        n_runs = int(g["run_s"].shape[0])
        Bp = tables.shape[2]
        for mode, act in (
                ("per_read", e2e.descend(dh.groups, n_nodes, hi, lo, valid,
                                         thr, upto=gi)),
                ("descend_all", torch.ones((tables.shape[0], R),
                                           dtype=torch.bool, device=dev))):
            fused = lambda: probe.probe_run_sums_grouped(  # noqa: E731
                hi, lo, valid, tables, act, *runs, *sk)
            got = fused()
            pick = torch.argsort(act.sum(0), descending=True,
                                 stable=True)[:16]
            want = probe.probe_run_sums_grouped_plain(
                hi[pick], lo[pick], valid[pick], tables, act[:, pick], *runs,
                *sk)
            assert_equal(torch, f"{mode} group {gi}", ("sums",),
                         (got[:, pick],), (want,))
            first = cuda_ms(fused, 1)
            reps = max(1, min(20, int(40.0 / max(first, 1e-3))))
            a1, a2 = cuda_ms(fused, reps), cuda_ms(fused, reps)
            d1, d2 = device_ms(fused, reps, 1), device_ms(fused, reps, 1)
            row = {"L": L, "R": R, "shape": list(tables.shape),
                   "active_pairs": int(act.sum()), "pairs": act.numel(),
                   "n_runs": n_runs,
                   "mode": (probe.narrow_mode(*tables.shape[1:], dev)
                            if Bp <= probe.NARROW_MAX_BINS else "K2"),
                   "ms": min(a1, a2), "device_ms": min(d1, d2),
                   **narrow_bound(hi, valid, tables, act, n_runs)}
            rows[mode].append(row)
            log(f"time {mode} group {gi} at L={L}, R={R}: tables "
                f"{tuple(tables.shape)}, {row['active_pairs']}/"
                f"{row['pairs']} pairs active, {n_runs} runs, mode "
                f"{row['mode']}: run sums {a1:.4f}/{a2:.4f} ms a call, "
                f"{d1:.4f}/{d2:.4f} on the device alone; bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    batch = {}
    for mode, da in (("per_read", False), ("descend_all", True)):
        step, _, got = dh.e2e_step(sch, th, 16, L, descend_all=da)
        if got != mode:
            raise AssertionError(f"e2e_step took {got}, not {mode}")
        run = lambda: step(pk, ln, lengths)  # noqa: E731
        step_ms = min(cuda_ms(run, 5), cuda_ms(run, 5))
        batch[mode] = {
            "device_ms": sum(r["device_ms"] for r in rows[mode]),
            "ms": sum(r["ms"] for r in rows[mode]),
            "bound_ms": sum(r["bound_ms"] for r in rows[mode]),
            "active_pairs": sum(r["active_pairs"] for r in rows[mode]),
            "pairs": sum(r["pairs"] for r in rows[mode]),
            "step_ms": step_ms}
        log(f"time {mode} batch at L={L}, R={R}: run sums "
            f"{batch[mode]['device_ms']:.4f} ms on the device, "
            f"{batch[mode]['ms']:.4f} a call, bound "
            f"{batch[mode]['bound_ms']:.4f}; {batch[mode]['active_pairs']}/"
            f"{batch[mode]['pairs']} pairs active; the whole step "
            f"{step_ms:.4f} ms a call; {int(valid.sum())} valid hashes")
    return {"per_read_groups": rows["per_read"],
            "descend_all_groups": rows["descend_all"],
            "minimizer_batch": batch}


# -------------------------------------------------- diagnostic kernels --
DIAG = {  # record name -> (wrapper name in device/diag.py, source, TPU kernel)
    "probe_bounds": ("probe_bounds", "taxor_tpu_torch/csrc/diag/probe_bounds.cu",
                     "bench_probe_bounds.py:33"),
    "probe_experiments": ("probe_experiment",
                          "taxor_tpu_torch/csrc/diag/probe_experiments.cu",
                          "bench_probe_r4.py:61"),
    "extract_stages": ("extract_stage",
                       "taxor_tpu_torch/csrc/diag/extract_stages.cu",
                       "tools/debug_extract.py:27"),
    "window_shift": ("window_shift",
                     "taxor_tpu_torch/csrc/diag/extract_stages.cu",
                     "tools/debug_min.py:22"),
}


def diag_counts(diag, zero: bool = False) -> dict:
    """{record name: launches} of the diagnostic wrappers (set to 0, and
    their ROUTES emptied)."""
    out = {}
    for name, (fn, _, _) in DIAG.items():
        wrapper = getattr(diag, fn)
        out[name] = wrapper.LAUNCHES
        if zero:
            wrapper.LAUNCHES = 0
            getattr(wrapper, "ROUTES", {}).clear()
    return out


def diag_routes(diag) -> dict:
    """{record name: {route: launches}} of the wrappers with routes."""
    return {name: dict(getattr(diag, fn).ROUTES)
            for name, (fn, _, _) in DIAG.items()
            if hasattr(getattr(diag, fn), "ROUTES")}


def check_probe_diags(torch, diag, label: str, table, bl: int, rand16, w16,
                      w10, n_hash, runs, modes=None) -> int:
    """probe_bounds (each of ``modes``, all by default) and
    probe_experiment (``runs``) on one table against their twins,
    bit-exact, through the route the shape picks and, where that is the
    slab route, through the rows route too; each launch's route is
    asserted from ROUTES, and the counts must agree in every layout.
    Returns the largest count."""
    S1, B = table.shape
    b = diag.slab_bins(S1, B, diag.smem_per_block(table.device))
    routes = [(False, "slab" if b else "rows")] + (
        [(True, "rows")] if b else [])
    top, first = 0, None
    for mode in modes or diag.PROBE_BOUNDS_MODES:
        want = diag.probe_bounds_plain(table, rand16, n_hash, mode)
        for rows, took in routes:
            before = diag.probe_bounds.ROUTES.get(took, 0)
            got = diag.probe_bounds(table, rand16, n_hash, mode, _rows=rows)
            assert diag.probe_bounds.ROUTES[took] == before + 1, took
            assert_equal(torch, f"probe_bounds {mode} ({label}, {took})",
                         ("counts",), (got,), (want,))
    for kw in runs:
        w = w10 if kw.get("layout") == "p10" else w16
        want = diag.probe_experiment_plain(table, w, n_hash, block_length=bl,
                                           **kw)
        for rows, took in routes if "flood_k" not in kw else [(False,
                                                               "flood")]:
            before = diag.probe_experiment.ROUTES.get(took, 0)
            got = diag.probe_experiment(table, w, n_hash, block_length=bl,
                                        _rows=rows, **kw)
            assert diag.probe_experiment.ROUTES[took] == before + 1, took
            assert_equal(torch, f"probe_experiment {kw} ({label}, {took})",
                         ("counts", "extra"), got, want)
        if "flood_k" not in kw:  # the same counts in every layout
            first = want[0] if first is None else first
            top = max(top, int(want[0].max()))
            assert_equal(torch, f"twin vs twin: probe_experiment_plain {kw} "
                         f"== its first run", ("counts",), (want[0],),
                         (first,))
    log(f"probe_bounds ({len(modes or diag.PROBE_BOUNDS_MODES)} modes) and "
        f"probe_experiment ({len(runs)} runs) on the {label} [{S1}, {B}] "
        f"(bl {bl}), R={n_hash.shape[0]}, n_hash 0..{int(n_hash.max())}: "
        f"routes {[t for _, t in routes]} (slab of {b} bins) bit-exact vs "
        f"twins, every layout alike, max count {top}")
    return top


def check_diag(torch, flat_table, flat_bl: int, rng) -> None:
    """Phase 11: every diagnostic kernel against its twin, bit-exact."""
    from taxor_tpu_torch.device import cuda_build, diag
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe
    from taxor_tpu_torch.tools.debug_min import stream_words

    dev = torch.device("cuda")
    R, H = 256, 512
    t0 = time.perf_counter()
    rand_tool = torch.from_numpy(pb.tool_table(rng)).to(dev)
    rand_16 = torch.from_numpy(pb.tool_table(rng, 10000, 64)).to(dev)
    rand_tall = torch.from_numpy(pb.tool_table(rng, 20000, 64)).to(dev)
    # the tools' geometry and the flat cell's table (slabs of 64 bins), a
    # ragged last slab of 36 bins (4-byte copies), slabs of 16 bins, and a
    # table past the shared memory (the rows route, picked by the shape)
    for label, table, bl in (("tool geometry", rand_tool, pe.BL_TOOL),
                             ("flat cell", flat_table, flat_bl),
                             ("ragged slab", rand_tool[:, :100].contiguous(),
                              pe.BL_TOOL),
                             ("16-bin slabs", rand_16, 3333),
                             ("tall table", rand_tall, 6666)):
        S1, B = table.shape
        n_np = rng.integers(0, H + 1, R).astype(np.int32)
        n_np[:8] = H  # full reads, one with no hash, one past its row
        n_np[8] = 0
        n_np[9] = H + 100
        n_hash = torch.from_numpy(n_np).to(dev)
        rand16 = torch.from_numpy(pb.make_inputs(rng, R, H, S1)).to(dev)
        w16, w10 = (torch.from_numpy(x).to(dev)
                    for x in pe.make_inputs(rng, R, H, S1, bl))
        check_probe_diags(torch, diag, label, table, bl, rand16, w16, w10,
                          n_hash, pe.CHECK_RUNS)
    # rows of words that 16-byte loads cannot take: H = 516 (129
    # fingerprint words), p16 rows of 2H + 2 words 4 bytes past alignment
    Hu = 516
    w16, w10 = pe.make_inputs(rng, R, Hu, 2419, pe.BL_TOOL)
    buf = torch.zeros(R * (2 * Hu + 2) + 1, dtype=torch.int32, device=dev)
    w16o = buf[1:].view(R, -1)
    w16o[:, :2 * Hu] = torch.from_numpy(w16).to(dev)
    n_hash = torch.from_numpy(rng.integers(0, Hu + 1, R).astype(
        np.int32)).to(dev)
    check_probe_diags(torch, diag, "unaligned words", rand_tool, pe.BL_TOOL,
                      w16o, w16o, torch.from_numpy(w10).to(dev), n_hash,
                      pe.CHECK_RUNS, modes=("p16",))
    # counts above 255: every hash hits every bin, up to 512 a read (a
    # read-lane writes its counts after 252 hashes, then adds to them
    # twice); 2,048 hashes on slabs of 128 bins (4 hash-lanes of 1,020
    # hashes a flush round)
    for (S1, B, bl, Hz), n in (((2419, 512, pe.BL_TOOL, 512),
                                (512, 300, 256, 255, 0)),
                               ((1500, 256, 499, 2048),
                                (2048, 1021, 1020, 7))):
        table, w16, w10 = (torch.from_numpy(x).to(dev) for x in
                           pe.zero_hit_inputs(rng, S1, B, bl, len(n), Hz))
        n_hash = torch.tensor(n, dtype=torch.int32, device=dev)
        top = check_probe_diags(torch, diag, f"zero-hit table, n {n}", table,
                                bl, w16, w16, w10, n_hash, pe.CHECK_RUNS[:7],
                                modes=("p16", "load1"))
        if top != max(n):
            raise AssertionError(f"zero-hit counts reach {top}, not {max(n)}")
    lib = cuda_build.diag_lib()
    for L in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        seqs = k1_reads(rng, L)
        packed, lengths = dsync.pack_reads(seqs, L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        for i, stage in enumerate(diag.STAGES):  # the wrapper's mirror
            if lib.extract_stage_smem(L, i) != diag.stage_smem(L, stage):
                raise AssertionError(f"stage_smem({L}, {stage}) differs "
                                     f"from the kernel's")
        emitted = []
        for k, s, t in STAGE_SCHEMES:
            want = diag.extract_stages_plain(pk, ln, k, s, t)
            for stage in diag.STAGES:
                assert_equal(torch, f"extract_stage {stage} (k={k}, s={s}, "
                             f"t={t}) L={L}", (stage,),
                             (diag.extract_stage(pk, ln, k, s, t, stage),),
                             (want[stage],))
            emitted.append(int(want["emit"].sum()))
        x = torch.from_numpy(stream_words(packed)).to(dev)
        for phases in (range(16), [15, 3, 11, 0, 3]):
            assert_equal(torch, f"window_shift {list(phases)} L={L}",
                         ("words",), (diag.window_shift(x, phases),),
                         (diag.window_shift_plain(x, phases),))
        xo = x[:, :x.shape[1] - 3].contiguous()  # Wd no multiple of 4
        assert_equal(torch, f"window_shift Wd={xo.shape[1]}", ("words",),
                     (diag.window_shift(xo),),
                     (diag.window_shift_plain(xo, range(16)),))
        log(f"extract_stage (10 stages, schemes {STAGE_SCHEMES}) and "
            f"window_shift (16 phases, a reordered list, Wd = L/16 and "
            f"L/16 - 3) L={L}: bit-exact vs twins on {len(seqs)} reads "
            f"({emitted} emissions)")
    log(f"phase 11: diagnostic kernels checked in "
        f"{time.perf_counter() - t0:.1f} s")


def cli_tools(torch, work: str) -> dict:
    """``cli prewarm`` and ``cli search --profile-trace`` on a flat index
    of build_problem(64 genomes of 20 kb, 2,048 reads of 2 kb); returns
    their seconds."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.tools import synth

    _, tsv, gdir, reads = synth.build_problem(
        n_species=64, genome_len=20000, n_reads=2048, read_len=2000,
        root=work)
    idx = os.path.join(work, "tools.taxor.npz")
    cwd = os.getcwd()
    os.chdir(work)  # the build writes its layout file (binning.out) here
    try:
        rc = cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                       gdir, "--output-filename", idx, "--kmer-size",
                       str(K), "--syncmer-size", str(S), "--use-syncmer",
                       "--layout", "flat"])
    finally:
        os.chdir(cwd)
    secs = {}
    t0 = time.perf_counter()
    rc |= cli.main(["prewarm", "--index-file", idx, "--lengths",
                    "1024,2048,4096", "--device", "cuda"])
    secs["prewarm"] = time.perf_counter() - t0
    trace = os.path.join(work, "trace")
    t0 = time.perf_counter()
    rc |= cli.main(["search", "--index-file", idx, "--query-file", reads,
                    "--output-file", os.path.join(work, "traced.tsv"),
                    "--engine", "device", "--device", "cuda",
                    "--profile-trace", trace])
    secs["search --profile-trace"] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError("cli build, prewarm or traced search failed")
    with open(os.path.join(trace, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    on_card = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in on_card})
    log(f"cli prewarm {secs['prewarm']:.1f} s; search --profile-trace "
        f"{secs['search --profile-trace']:.1f} s, trace of {len(events)} "
        f"events, {len(on_card)} kernels on the card "
        f"({sum(e.get('dur', 0) for e in on_card) / 1e3:.3f} ms), e.g. "
        f"{[n[:60] for n in names[:4]]}")
    return secs


def tool_path(torch, work: str) -> tuple[dict, dict]:
    """Phase 12: the tooling path through its entry points, the launch
    counts of every kernel set to 0 just before and read just after;
    returns the diagnostic launches, and those by route."""
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.device import launches as launch_counts
    from taxor_tpu_torch.tools import (bench, debug_extract, debug_min,
                                       probe_bounds, probe_experiments,
                                       profile_phases)

    reset_counts()
    diag_counts(diag, zero=True)
    secs = {}
    t0 = time.perf_counter()
    result, rc = bench.run(["--configs", bench.PRIMARY])
    secs["bench"] = time.perf_counter() - t0
    cfg = result["detail"]["configs"][0]
    log(f"tools.bench ({secs['bench']:.1f} s): rc {rc}; {bench.PRIMARY}: "
        f"device compute {cfg.get('device_compute_reads_per_s')} reads/s "
        f"({cfg.get('ms_per_pass')} ms a pass), full pipeline "
        f"{result['full_pipeline_reads_per_s']} reads/s, native baseline "
        f"{cfg.get('baseline_1thread_reads_per_s')} reads/s a thread, "
        f"fallback {cfg.get('host_fallback_fraction')}; parity "
        f"{result['parity']}")
    if rc != 0 or not result["parity_ok"] or result["skipped"] \
            or result["parity"] != {f: True for f in bench.FAMILIES}:
        raise AssertionError(f"tools.bench failed: rc {rc}, {result}")
    routes = result["parity_routes"]
    log(f"tools.bench parity: device routes by family {routes}")
    if any(routes[f]["fused"] <= 0 for f in bench.FAMILIES):
        raise AssertionError(f"a parity family took no fused step: {routes}")
    t0 = time.perf_counter()
    bounds = probe_bounds.run("cuda")
    secs["probe_bounds"] = time.perf_counter() - t0
    exps = {}
    t0 = time.perf_counter()
    for name in probe_experiments.LISTS:
        exps[name] = probe_experiments.run(name, "cuda")
    secs["probe_experiments"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases = profile_phases.profile("cuda")
    secs["profile_phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if debug_extract.main(["--stage", "all", "--device", "cuda"]) != 0 \
            or debug_min.main(["--device", "cuda"]) != 0:
        raise AssertionError("debug_extract or debug_min found a difference")
    secs["debug"] = time.perf_counter() - t0
    secs.update(cli_tools(torch, work))
    counts = diag_counts(diag)
    routes = diag_routes(diag)
    launches = launch_counts.read()
    log(f"tool path: probe_bounds ns/hash "
        f"{ {k: round(v['ns_per_hash'], 4) for k, v in bounds.items()} }")
    for name, rows in exps.items():
        log(f"tool path: probe_experiments {name}: "
            f"{[(r['mode'], r['U'], r['nops'], round(r['ms'], 4)) for r in rows]}")
    log(f"tool path: profile_phases ms {json.dumps(phases)}")
    log(f"tool path: seconds {({k: round(v, 1) for k, v in secs.items()})}; "
        f"diagnostic launches {counts}, by route {routes}; search kernel "
        f"launches {launches}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the tooling path skipped a diagnostic kernel: "
                             f"{counts}")
    if set(routes["probe_bounds"]) != {"slab"} \
            or set(routes["probe_experiments"]) != {"slab", "flood"}:
        raise AssertionError(f"the probe tools left their slab route: "
                             f"{routes}")
    return counts, routes


def time_stages(torch, seqs, pk, ln, words) -> tuple[dict, float]:
    """extract_stage in stages sf, chi, erm, emit and pre on the batch
    (packed pk, lengths ln of seqs), pre on as many reads tied in every
    window (``pre_tied``) and on the batch's longest read alone
    (``pre_one``: one read's serial chain of tracker steps, the floor of
    emit and pre), and window_shift on the stream words, through
    ``tools.time_stages.measure``: each held to its twin, then timed a
    call and on the device alone.  Returns the stages' times beside
    their bytes bounds, and window_shift's device time."""
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import time_stages as ts
    from taxor_tpu_torch.tools.time_extract import all_tied_reads

    R, L = pk.shape[0], pk.shape[1] * 4
    tied = [torch.from_numpy(x).to(pk.device) for x in dsync.pack_reads(
        all_tied_reads(np.random.default_rng(SEED + 13), L, R), L)]
    one = max(range(R), key=lambda r: len(seqs[r]))
    got = ts.measure({"": (pk, ln), "_tied": tied,
                      "_one": (pk[one:one + 1], ln[one:one + 1])}, words,
                     pk.device)
    if not all(got["equal"].values()):
        raise AssertionError(f"extract_stage or window_shift differs from "
                             f"its twin: {got['equal']}")
    out = {}
    for name in (*ts.STAGES, "pre_tied", "pre_one"):
        rows = 1 if name == "pre_one" else R
        out[name] = {"ms": got[f"{name}_ms"],
                     "device_ms": got[f"{name}_device_ms"], **bound(
                         (L // 4 + 4 + (1 if name == "emit" else 8) * L)
                         * rows, 0.0, PEAK_SCALAR)}
        log(f"time extract_stage {name} ({rows} reads, L={L}): a call "
            f"{out[name]['ms']:.4f} ms, device {out[name]['device_ms']:.4f}"
            f" ms, bound {out[name]['bound_ms']:.4f} ms")
    out["pre_one"]["length"] = int(ln[one])
    return out, got["window_shift_device_ms"]


def time_diag(torch, state) -> list[dict]:
    """The four diagnostic kernels against their twins: the probe
    variants at the JAX tools' geometry (R=8192, H=512, 176 hashes a
    read, 2,419 slots x 512 bins), the stage dump (stage ``pre``, the
    tracker; then five stages and two more batches, ``time_stages``) and
    the window shift (also on the device alone) at the flat path's
    L=8192 bucket.  The two probe diagnostics, which take their slab
    route there, are also timed on the device alone (device_ms) and
    through their rows route at the same shape, a call and on the device
    alone, beside the floor of their shared-memory row reads."""
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe
    from taxor_tpu_torch.tools.debug_min import stream_words
    from taxor_tpu_torch.tools.time_sort import device_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    R, H, n = pb.R_TOOL, pb.H_TOOL, pb.n_probed(pb.NVALID)
    table = torch.from_numpy(pb.tool_table(rng)).to(dev)
    S1, B = table.shape
    w16 = torch.from_numpy(pb.make_inputs(rng, R, H, S1)).to(dev)
    w10 = torch.from_numpy(pe.make_inputs(rng, R, H, S1, pe.BL_TOOL)[1]).to(
        dev)
    n_hash = torch.full((R,), n, dtype=torch.int32, device=dev)
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    words = torch.from_numpy(stream_words(packed)).to(dev)
    Rs, Wd = words.shape
    t = (K - S + 1) // 2
    probe_out = 4 * R * B + S1 * B + 4 * R  # counts out, table, n_hash
    cases = (
        ("probe_bounds", f"p16 at R={R}, n={n}, table [{S1}, {B}]",
         lambda: diag.probe_bounds(table, w16, n_hash, "p16"),
         lambda: diag.probe_bounds_plain(table, w16, n_hash, "p16"), 20,
         # the position words of the probed hashes; one fingerprint-byte
         # compare per hash and bin
         bound(8 * R * n + probe_out, float(R * n * B), PEAK_INT8)),
        ("probe_experiments", f"p10, one read a thread, at R={R}, n={n}",
         lambda: diag.probe_experiment(table, w10, n_hash, "p10",
                                       block_length=pe.BL_TOOL),
         lambda: diag.probe_experiment_plain(table, w10, n_hash, "p10",
                                             block_length=pe.BL_TOOL), 20,
         bound(5 * R * n + probe_out + 4 * R, float(R * n * B), PEAK_INT8)),
        ("extract_stages", f"stage pre at R={Rs}, L={L}",
         lambda: diag.extract_stage(pk, ln, K, S, t, "pre"),
         lambda: diag.extract_stage_plain(pk, ln, K, S, t, "pre"), 5,
         # packed + lengths in, 8 bytes a position out; a tracker step
         # per base
         bound(pk.numel() + 4 * Rs + 8 * Rs * L, float(ln.sum()),
               PEAK_SCALAR)),
        ("window_shift", f"16 phases of [{Rs}, {Wd}] stream words",
         lambda: diag.window_shift(words),
         lambda: diag.window_shift_plain(words, range(16)), 50,
         bound(4 * Rs * Wd * 17 + 64, 16.0 * Rs * Wd, PEAK_SCALAR)),
    )
    # the floor no slab design gets under: 3 rows x B bytes a probed hash
    # from shared memory, at 128 B a clock an SM, 132 SMs, 1.98 GHz
    smem_floor_ms = 3 * B * R * n / SMEM_BPS * 1e3
    slab = diag.slab_bins(S1, B, diag.smem_per_block(dev))
    rows = []
    for name, shape, fn, plain, reps, bnd in cases:
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        log(f"time {name} ({shape}): kernel {each[0]:.4f}/{each[1]:.4f} ms, "
            f"plain {each[2]:.3f}/{each[3]:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": DIAG[name][1],
                     "replaces": DIAG[name][2], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bnd, "library_ms": None})
        if name == "extract_stages":
            rows[-1]["stages"], shift_dev = time_stages(torch, seqs, pk, ln,
                                                        words)
        if name == "window_shift":
            rows[-1]["device_ms"] = shift_dev
            log(f"time window_shift: device {shift_dev:.4f} ms")
        if name not in ("probe_bounds", "probe_experiments"):
            continue
        # on the device alone, and the rows route at the same shape, each
        # held to the same twin: slab, rows, rows, slab
        rows_fn = {"probe_bounds": lambda: diag.probe_bounds(
            table, w16, n_hash, "p16", _rows=True),
            "probe_experiments": lambda: diag.probe_experiment(
                table, w10, n_hash, "p10", block_length=pe.BL_TOOL,
                _rows=True)}[name]
        dev_ms = [device_ms(fn, reps, rounds=1)]
        rows_ms, _, _, rows_each = time_pair(torch, rows_fn, plain, reps)
        rows_dev = [device_ms(rows_fn, reps, rounds=1),
                    device_ms(rows_fn, reps, rounds=1)]
        dev_ms.append(device_ms(fn, reps, rounds=1))
        rows[-1].update(
            slab_bins=slab, device_ms=min(dev_ms), rows_ms=rows_ms,
            rows_device_ms=min(rows_dev),
            times={"slab_call": each[:2], "slab_device": dev_ms,
                   "rows_call": rows_each[:2], "rows_device": rows_dev})
        log(f"time {name}: slab route ({slab} bins) a call "
            f"{each[0]:.4f}/{each[1]:.4f} ms, device {dev_ms[0]:.4f}/"
            f"{dev_ms[1]:.4f} ms; rows route a call {rows_each[0]:.4f}/"
            f"{rows_each[1]:.4f} ms, device {rows_dev[0]:.4f}/"
            f"{rows_dev[1]:.4f} ms; shared-memory floor "
            f"{smem_floor_ms:.4f} ms")
    return rows


# ------------------------------------------------------------ phase 14 --
RANK_TIMEOUT = 420  # seconds a sharded search's ranks may take


def rank_main(counts_file: str, argv: list[str]) -> int:
    """One rank of a phase 14 search: ``cli.main(argv)`` (the argv of
    ``python -m taxor_tpu_torch.cli search ...``) with every launch count
    set to 0 just before, then this rank's launches, routes, wall, peak
    device memory and collective seconds written to counts_file."""
    import torch

    from taxor_tpu_torch import cli
    from taxor_tpu_torch.device import launches as launch_counts
    from taxor_tpu_torch.device import sharding
    from taxor_tpu_torch.search import pipeline

    reset_counts()
    sharding.COLLECTIVES.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    rec = {"rc": rc, "wall_s": wall,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "launches": launch_counts.read(),
           "routes": dict(pipeline.ROUTES.counts),
           "collectives": sharding.COLLECTIVES.summary()}
    with open(counts_file, "w") as fh:
        json.dump(rec, fh)
    return rc


def run_ranks(cmds, logs, timeout: float) -> list[int]:
    """Start every command at once, each logging to its file; wait for
    all, and stop the others as soon as one fails.  Return codes."""
    procs = []
    try:
        for cmd, path in zip(cmds, logs):
            with open(path, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def sharded_search(work: str, label: str, state: dict, ranks: int,
                   mesh: list[str], need, card: str) -> dict:
    """``cli search --engine sharded --distributed`` of ``state``'s index
    and reads in ``ranks`` processes on the card (gloo where they share
    it, NCCL for one rank: distributed.collective_backend), each through
    ``rank_main``; every rank must exit 0, the kernels ``need`` must have
    launched in the ranks, and rank 0's TSV must equal the phase's
    single-device ``--engine device`` TSV byte for byte.  Logs the
    backend, the mesh and each rank's launches, wall, peak device memory
    and collective seconds a batch (CUDA events around each all_gather
    and all_reduce)."""
    from taxor_tpu_torch.tools.dryrun_multichip import free_port

    port = free_port()
    out = os.path.join(work, f"{label}_sharded.tsv")
    threads = str(max(1, (os.cpu_count() or 1) // ranks))
    cmds, logs, files = [], [], []
    for r in range(ranks):
        files.append(os.path.join(work, f"{label}_rank{r}.json"))
        logs.append(os.path.join(work, f"{label}_rank{r}.log"))
        cmds.append([sys.executable, os.path.abspath(__file__), "--rank",
                     files[-1], "search", "--index-file", state["idx"],
                     "--query-file", state["reads"], "--output-file", out,
                     "--engine", "sharded", "--distributed",
                     "--coordinator-address", f"127.0.0.1:{port}",
                     "--num-processes", str(ranks), "--process-id", str(r),
                     *mesh, "--device", "cuda", "--threads", threads,
                     "--write-time"])
    t0 = time.perf_counter()
    rcs = run_ranks(cmds, logs, RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    if any(rcs):
        raise RuntimeError(f"[{label}] sharded search: rank return codes "
                           f"{rcs}\n" + "\n".join(
                               f"--- rank {r}\n{tail(p)}"
                               for r, p in enumerate(logs)))
    recs = []
    for path in files:
        with open(path) as fh:
            recs.append(json.load(fh))
    total = {k: sum(r["launches"][k] for r in recs)
             for k, v in recs[0]["launches"].items() if isinstance(v, int)}
    if any(total[k] <= 0 for k in need):
        raise AssertionError(f"[{label}] the ranks skipped one of {need}: "
                             f"{total}")
    with open(out, "rb") as fa, open(state["device_tsv"], "rb") as fb:
        got, want = fa.read(), fb.read()
    if got != want:
        a, b = got.splitlines(), want.splitlines()
        bad = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        raise AssertionError(f"[{label}] sharded TSV differs from the device "
                             f"TSV at row {bad} ({len(a)} vs {len(b)} rows)")
    backend = next(line for line in tail(logs[0], 10**6).splitlines()
                   if "collectives on" in line)
    log(f"[{label}] sharded search, {ranks} rank(s) {' '.join(mesh)}: "
        f"{len(want.splitlines()) - 1} rows == the device TSV byte for "
        f"byte; {wall:.2f} s wall for all ranks (start-up included); "
        f"{backend.strip()}; launches summed over the ranks {total}; {card}")
    for r, rec in enumerate(recs):
        c = rec["collectives"]
        dev_s = c["device_s"] or 0.0
        log(f"[{label}]   rank {r}: {c['mesh']}; wall {rec['wall_s']:.2f} s; "
            f"peak device memory {rec['peak_mib']:.1f} MiB; launches "
            f"{ {k: v for k, v in rec['launches'].items() if v} }; routes "
            f"{rec['routes']}; collectives {c['calls']} calls over "
            f"{c['batches']} batches: {dev_s:.4f} s on the card (CUDA "
            f"events), {c['host_s']:.4f} s host, "
            f"{dev_s / max(1, c['batches']) * 1e3:.3f} ms a batch; {card}")
    return {"launches": total, "ranks": recs, "wall": wall}


def flat_probe(state: dict, nb: int) -> str:
    """The probe kernel of a flat index's bins shard: K2 past 512 bins,
    else K2n (a quick-start flat index of fewer than 513 genomes)."""
    from taxor_tpu_torch.device.probe import LANE, NARROW_MAX_BINS, pad_bins

    bins = state["index"].hixf.ixfs[0].fingerprints.shape[1]
    return "K2" if pad_bins(bins, LANE * nb) // nb > NARROW_MAX_BINS \
        else "K2n"


def dryrun_on_card(card: str) -> None:
    """Phase 14e: tools.dryrun_multichip over 4 ranks on the card."""
    res = subprocess.run(
        [sys.executable, "-m", "taxor_tpu_torch.tools.dryrun_multichip",
         "--ranks", "4", "--device", "cuda"], capture_output=True, text=True,
        timeout=RANK_TIMEOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise RuntimeError(f"dryrun_multichip failed ({res.returncode}):\n"
                           + res.stdout[-2000:] + res.stderr[-3000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if not (out.get("count_step") and out.get("fused_step")):
        raise AssertionError(f"dryrun_multichip: {out}")
    log(f"phase 14e: dryrun_multichip over 4 ranks: {out}; {card}")


# ------------------------------------------------------------ phase 15 --
# stacks of tables past 2^31 bytes (15a): one [3 x 2^24, 64] table, every
# hash's third row past byte 2^31, and two [3 x 2^20, 512] tables, the
# second's rows past it (the at-scale root, [1, 37.7 M, 64], is 2.4 GB)
BIG_TABLES = ((1, 3 * 2**24, 64), (2, 3 * 2**20, 512))
ATSCALE_SEQ_GB = 0.001  # the demo's one block of 1,024 genomes: 3 levels


def check_big_tables(torch, probe) -> list[dict]:
    """Phase 15a: K2n's rows mode (run sums and dense counts) and K2's
    rows route against their twins, bit-exact, on stacks of more than
    2^31 bytes (tools/synth.big_table_problem: half of the valid hashes
    planted in every bin), each timed beside its twin."""
    from taxor_tpu_torch.tools import synth

    out = []
    for G, S, Bp in BIG_TABLES:
        p = synth.big_table_problem("cuda", G, S, Bp, seed=G)
        args = (p["hi"], p["lo"], p["valid"], p["tables"], p["active"])
        sb = (p["seed"], p["block_length"])
        runs = p["runs"]
        if probe.narrow_mode(S, Bp, "cuda") != "rows" or probe.slab_bins(
                S, Bp, p["hi"].shape[1], "cuda"):
            raise AssertionError(f"[{G}, {S}, {Bp}] takes no rows route")
        plain = {
            "K2n rows (run sums)": lambda: probe.probe_run_sums_grouped_plain(
                *args, *runs, *sb),
            "K2n rows (counts)": lambda: probe.probe_counts_grouped_plain(
                *args, *sb)}
        plain["K2 rows"] = plain["K2n rows (counts)"]
        kern = {
            "K2n rows (run sums)": lambda: probe.k2n_run_sums(
                *args, *runs, *sb, mode="rows"),
            "K2n rows (counts)": lambda: probe.k2n_counts(*args, *sb,
                                                          mode="rows"),
            "K2 rows": lambda: probe.k2_counts(*args, *sb, variant="rows")}
        rec = dict(shape=[G, S, Bp], table_bytes=p["tables"].numel(),
                   reads=int(p["hi"].shape[0]),
                   valid_hashes=int(p["valid"].sum()))
        for name, fn in kern.items():
            ms, plain_ms, err, _ = time_pair(torch, fn, plain[name], 3)
            rec[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)
        want = plain["K2n rows (counts)"]()
        if int(want[:, 0].min()) <= 0:  # read 0: active, hashes planted
            raise AssertionError("phase 15a: a planted read counts 0")
        log(f"phase 15a: {rec}")
        out.append(rec)
        del p, args, want
        torch.cuda.empty_cache()
    return out


def atscale_demo(work: str, n_reads: int):
    """Phase 15b's ``at_scale_demo.Demo``: one block of 1,024 genomes and
    n_reads reads under work."""
    from taxor_tpu_torch.tools import at_scale_demo as demo

    os.makedirs(work, exist_ok=True)
    return demo.Demo(work=work, result=os.path.join(work, "atscale.json"),
                     seq_gb=ATSCALE_SEQ_GB, n_reads=n_reads, device="cuda")


def build_atscale(work: str, reads: int) -> dict:
    """Phase 15b's background build: the demo's gen and build stages."""
    from taxor_tpu_torch.tools import at_scale_demo as demo

    d = atscale_demo(work, reads)
    return {"gen": demo.gen(d), "build": demo.build(d)}


def atscale_path(torch, work: str, n_reads: int, built: dict) -> dict:
    """Phase 15b: the port's at-scale demo (tools/at_scale_demo.py) at
    one block of 1,024 genomes and n_reads reads, gen -> build (``built``:
    their records, from ``build_atscale`` in the background) ->
    search -> parity.  The search's launches are the demo's own count
    around its three ``search_single`` calls (``search_launches``: the
    cold one and both warm ones; not the burst that follows them).
    Asserts a hierarchy of depth >= 2, K1 and K2n's rows mode on the
    root, K2n's smem mode on a group below it, the parity TSV byte for
    byte and 99% of the classified reads naming their source."""
    from taxor_tpu_torch.tools import at_scale_demo as demo

    d = atscale_demo(work, n_reads)
    gen, build = built["gen"], built["build"]
    if build["n_ixfs"] < 2 or build["depth"] < 2:
        raise AssertionError(f"phase 15: the index is not hierarchical: "
                             f"{build}")
    reset_counts()
    search = demo.search(d)
    launches = search["search_launches"]
    try:
        parity = demo.parity(d)
    except SystemExit as exc:
        raise AssertionError(f"phase 15: {exc}") from None
    routes = [g["route"] for g in search["groups"]]
    if (routes[0] != "K2n rows" or "K2n smem" not in routes[1:]
            or launches["K1"] <= 0 or launches["K2n rows"] <= 0
            or launches["K2n smem"] <= 0):
        raise AssertionError(f"phase 15: routes {routes}, launches "
                             f"{launches}")
    if search["correct_of_classified"] < 0.99:
        raise AssertionError(f"phase 15: {search['correct_of_classified']} "
                             "of the classified reads name their source")
    for key, rec in (("gen", gen), ("build", build), ("search", search),
                     ("parity", parity)):
        log(f"phase 15 {key}: {json.dumps(rec)}")
    return {"launches": launches, "search": search, "build": build}


# ------------------------------------------------------------ phase 18 --
LONG_TAIL_READS = 4096  # log-normal lengths, median 8 kb, sigma 1.0
LONG_TAIL_MAX = 1_000_000
ULTRA_LONG_READS = 8  # of 0.5-1 Mb
# reads of the P = 2 piece bucket whose routes phase 18 times
ROUTE_SAMPLE = 64


def long_tail_reads(rng, gdir: str) -> list[tuple[str, bytes]]:
    """Phase 18's reads from the genomes of gdir: LONG_TAIL_READS of
    log-normal lengths (median 8 kb, sigma 1.0, up to LONG_TAIL_MAX, not
    clipped below) and ULTRA_LONG_READS of 0.5-1 Mb, each from a random
    genome at least as long, 4% substitutions; the reads up to L_CAP
    first, then the longer ones."""
    from taxor_tpu_torch.hash import device_syncmer as dsync

    genomes = []
    for name in sorted(os.listdir(gdir)):
        with open(os.path.join(gdir, name), "rb") as fh:
            head, seq = fh.read().split(b"\n", 1)
        genomes.append((head[1:].split()[0].decode(),
                        np.frombuffer(seq.replace(b"\n", b""), np.uint8)))
    genomes.sort(key=lambda g: g[1].shape[0])
    glens = np.array([g[1].shape[0] for g in genomes])
    lens = np.minimum(rng.lognormal(np.log(8000), 1.0, LONG_TAIL_READS),
                      LONG_TAIL_MAX).astype(int)
    lens = np.concatenate([np.maximum(lens, 1), rng.integers(
        500_000, 1_000_001, ULTRA_LONG_READS)])
    recs = []
    for j, n in enumerate(lens.tolist()):
        first = int(np.searchsorted(glens, n))  # the genomes long enough
        acc, seq = genomes[int(rng.integers(first, len(genomes)))]
        off = int(rng.integers(0, seq.shape[0] - n + 1))
        recs.append((f"tail{j}_{acc}", mutate(rng, seq[off:off + n].copy(),
                                              0.04)))
    return ([r for r in recs if len(r[1]) <= dsync.L_CAP]
            + [r for r in recs if len(r[1]) > dsync.L_CAP])


def long_routes(torch, index, seqs, label: str) -> dict:
    """The reads past L_CAP of ``seqs`` on both routes of an index, called
    directly (tools/time_long_reads.py, best of 3): the host-hash route
    (``search_hashes`` on one thread, the thresholds, ``pack_hash_lists``,
    the upload, the probe through ``pipeline._device_dispatch``: top-k,
    or the per-IXF traversal's launches and round trips) against the
    fused step (``pack_reads`` into the bucket, ``DeviceHIXF.e2e_async``:
    a syncmer read in pieces, a minimiser or plain k-mer read whole)."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import schemes
    from taxor_tpu_torch.search.thresholds import Thresholder
    from taxor_tpu_torch.tools import time_long_reads as tl

    dev = torch.device("cuda")
    sch = index.scheme
    th = Thresholder.make(kmer_size=sch.kmer_size,
                          window_size=sch.window_size, error_rate=0.04,
                          percentage=-1.0, use_syncmer=sch.use_syncmer)
    dh = DeviceHIXF.from_hixf(index.hixf, dev)
    threads, schemes.NUM_THREADS = schemes.NUM_THREADS, 1
    try:
        host = tl.best([tl.host_route(dh, index, seqs, th, dev)
                        for _ in range(3)])
        fused = tl.best([tl.fused_route(dh, index, seqs, th, dev)
                         for _ in range(3)])
    finally:
        schemes.NUM_THREADS = threads
    n = len(seqs)
    rec = {"reads": n, "bases": sum(len(q) for q in seqs),
           "host": {**host, **tl.per_read_ms(host, n)},
           "fused": {**fused, **tl.per_read_ms(fused, n)}}
    log(f"[{label}] long reads on both routes, a read: host-hash route "
        f"{sum(v for k, v in rec['host'].items() if k.endswith('_ms_a_read')):.4f}"
        f" ms ({json.dumps(rec['host'])}); fused step "
        f"{sum(v for k, v in rec['fused'].items() if k.endswith('_ms_a_read')):.4f}"
        f" ms ({json.dumps(rec['fused'])}); {card_line()}")
    return rec


def union_inputs(torch, seqs):
    """K1's and syncmer_track's piece rows of the reads of one piece
    bucket, each held to its twin (``syncmer_hashes_plain`` and
    ``syncmer_kmers_pieces`` on the same inputs) and timed beside it;
    then K4's and K6's inputs as the main path gives them
    (``sort.union_pieces``): the piece hashes laid out [R, P * 8,192] by
    ``sort.union_rows``, with an all-ones hash counted in n_valid in the
    first row (a padding slot) and in the last (a real hash overwritten:
    two all-ones keys there), sorted by K4 for K6.  Returns (hi, lo,
    sorted hi, sorted lo, n_valid, {"K1": record, "track": record})."""
    from taxor_tpu_torch.device import extract, sort
    from taxor_tpu_torch.hash import device_syncmer as dsync

    dev = torch.device("cuda")
    L = dsync.bucket_len(max(len(q) for q in seqs))
    P = dsync.bucket_pieces(L)
    pk, ln = (torch.from_numpy(x).to(dev) for x in dsync.pack_reads(seqs, L))
    t = (K - S + 1) // 2
    hp = dsync.hash_cap(dsync.L_CAP, K, S, t)
    R = len(seqs)
    hi, lo, valid, _, n_emit = extract.syncmer_hashes(pk, ln, K, S, t, hp,
                                                      pieces=P)
    # the bases each piece row covers
    j = torch.arange(P, device=dev)[None, :]
    bases = float((ln.to(torch.int64)[:, None] - j * dsync.PIECE_STRIDE)
                  .clamp(0, dsync.L_CAP).sum())
    W = extract.sort_width(dsync.L_CAP, K, S, t)
    rows = R * P
    recs = {}
    for name, fn, plain, bnd in (
            ("K1", lambda: extract.syncmer_hashes(pk, ln, K, S, t, hp,
                                                  pieces=P),
             lambda: extract.syncmer_hashes_plain(pk, ln, K, S, t, hp,
                                                  pieces=P),
             # as phase 5's record: packed + lengths in, the piece rows'
             # hashes and counts out; the tracker a base, a k-mer an owned
             # emission, the sort network, one hash a slot
             bound(pk.numel() + 4 * R + 9 * rows * hp + 8 * rows,
                   bases * tracker_ops(K, S) + float(n_emit.sum()) * KMER_OPS
                   + sort_ops(n_emit.clamp(max=W).tolist()) + rows * hp,
                   PEAK_SCALAR)),
            ("track", lambda: extract.syncmer_track(pk, ln, K, S, t,
                                                    pieces=P),
             lambda: dsync.syncmer_kmers_pieces(pk, ln, K, S, t, P),
             # packed + lengths in, kmer + emit of every row position out
             bound(pk.numel() + 4 * R + 9 * rows * dsync.L_CAP,
                   bases * tracker_ops(K, S)
                   + rows * dsync.L_CAP * KMER_OPS, PEAK_SCALAR))):
        ms, plain_ms, err, _ = time_pair(torch, fn, plain, 3)
        recs[name] = dict(reads=R, pieces=P, rows=rows, ms=ms,
                          plain_ms=plain_ms, max_abs_err=err, **bnd,
                          library_ms=None)
    h, lo_, n_valid = sort.union_rows(hi, lo, valid, P)
    n_valid = n_valid.clone()
    n_valid[0] += 1  # the all-ones padding slot after the row's valid ones
    slot = int(torch.nonzero(valid.reshape(R, -1)[-1])[0])
    h[-1, slot] = -1  # a real hash overwritten with the all-ones key
    lo_[-1, slot] = -1
    n_valid[-1] += 1
    sh, sl = sort.sort_pairs(h, lo_)
    return h, lo_, sh, sl, n_valid, recs


def time_union(torch, samples: dict) -> dict:
    """Phase 18a: K1's and syncmer_track's piece rows, K4 and K6 against
    their twins, bit-exact, at the widths of samples {label: reads of one
    piece bucket}, each timed beside its twin; K4 beside ``torch.sort``
    of the combined key, K6 beside ``torch.sort`` then
    ``torch.unique_consecutive`` of the rows.  Returns {"K1", "track",
    "K4": records by width, "K6": K6's kernel record}."""
    from taxor_tpu_torch.device import sort
    from taxor_tpu_torch.utils.u64 import INT64_MIN, join32

    k4, k6, widths = {}, None, {}
    pieces = {"K1": {}, "track": {}}
    for label, seqs in samples.items():
        h, lo, sh, sl, n_valid, recs = union_inputs(torch, seqs)
        R, W = h.shape
        for name, rec in recs.items():
            pieces[name][f"P{rec['pieces']}"] = rec
        log(f"phase 18a [{label}]: piece rows bit-exact vs twins: K1 "
            f"{json.dumps(recs['K1'])}; syncmer_track "
            f"{json.dumps(recs['track'])}")
        k4[f"W{W}"] = k4_record(torch, sort, h, lo)
        skeys = join32(sh, sl) ^ INT64_MIN
        ms, plain_ms, err, _ = time_pair(
            torch, lambda: sort.unique_pairs(sh, sl, n_valid),
            lambda: sort.unique_pairs_plain(sh, sl, n_valid), 5)
        out_hi, out_lo, out_valid, _ = sort.unique_pairs(sh, sl, n_valid)
        ones = ((out_hi == -1) & (out_lo == -1) & out_valid).sum(dim=1)
        if int(ones[0]) != 1 or int(ones[-1]) != 1:
            raise AssertionError(f"[{label}] K6 kept {ones[0]} and "
                                 f"{ones[-1]} all-ones hashes, not 1 each")
        rec = dict(reads=R, width=W, valid=int(n_valid.sum()), ms=ms,
                   plain_ms=plain_ms, max_abs_err=err,
                   library_ms=cuda_ms(lambda: torch.unique_consecutive(
                       torch.sort(skeys, dim=1).values), 3),
                   # sorted pairs and counts in, pairs, valid, counts out;
                   # a compare a slot
                   **bound(8 * R * W + 4 * R + 9 * R * W + 4 * R,
                           float(R * W), PEAK_SCALAR))
        log(f"phase 18a [{label}]: K4 at [{R}, {W}] {json.dumps(k4[f'W{W}'])}"
            f"; K6 {json.dumps(rec)}; bit-exact vs twins, an all-ones hash "
            "kept once in the first and the last row")
        widths[f"W{W}"] = rec
        if k6 is None or W > k6["width"]:  # the record: the widest rows
            k6 = dict(rec)
    k6.update(widths=widths, name="unique_pairs", route="cuda",
              source="taxor_tpu_torch/csrc/unique.cu",
              replaces="taxor_tpu/hash/schemes.py:121 (np.unique of the "
                       "host scanner's hashes of a read past L_CAP; no TPU "
                       "kernel)")
    return {**pieces, "K4": k4, "K6": k6}


def long_tail_path(torch, work: str, atscale_work: str) -> dict:
    """Phase 18b: the long-tail reads on phase 15b's at-scale index (the
    module docstring)."""
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.hixf.index import load_index

    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    recs = long_tail_reads(np.random.default_rng(SEED + 18),
                           os.path.join(atscale_work, "genomes"))
    n_short = sum(len(q) <= dsync.L_CAP for _, q in recs)
    longs = [q for _, q in recs[n_short:]]
    reads = os.path.join(work, "long_tail.fasta")
    write_fasta(reads, recs)
    bases = sum(len(q) for _, q in recs)
    log(f"[long tail] data: {len(recs)} reads ({bases / 1e6:.1f} Mb), "
        f"{len(longs)} past L_CAP ({sum(map(len, longs)) / bases:.3f} of "
        f"the bases, the longest {max(map(len, longs))}), made in "
        f"{time.perf_counter() - t0:.1f} s")
    # the host's cut and pack of the long reads, bucket by bucket
    t0 = time.perf_counter()
    buckets: dict = {}
    for q in longs:
        buckets.setdefault(dsync.bucket_len(len(q)), []).append(q)
    cut_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for L, qs in buckets.items():
        dsync.pack_reads(qs, L)
    pack_s = time.perf_counter() - t0
    cut = {"cut_s": cut_s, "pack_s": pack_s,
           "pack_ms_a_read": pack_s * 1e3 / len(longs),
           "buckets": {dsync.bucket_pieces(L): len(qs)
                       for L, qs in sorted(buckets.items())}}
    log(f"[long tail] host cut and pack of {len(longs)} reads: "
        f"{json.dumps(cut)}")

    idx = os.path.join(atscale_work, "index.npz")
    out_dev = os.path.join(work, "device.tsv")
    launches, routes, wall, peak = device_search(torch, idx, reads, out_dev,
                                                 "long tail")
    if (routes["long_fused"] != len(longs) or routes["host_hashes"] != 0
            or routes["fused"] != len(recs)):
        raise AssertionError(f"[long tail] routes {routes}: every read past "
                             "L_CAP must take the fused step in pieces")
    if any(launches[k] <= 0 for k in ("K1", "K4", "K6", "K2n")):
        raise AssertionError(f"[long tail] a kernel never launched: "
                             f"{launches}")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    log(f"[long tail] {len(recs)} reads in {wall:.2f} s wall = "
        f"{len(recs) / wall:.1f} reads/s; .time [{phases}]; launches "
        f"{launches}; routes {routes}; peak device memory {peak:.1f} MiB")
    host_parity(work, idx, recs, n_short, out_dev, "long tail")
    index = load_index(idx)
    p2 = [q for q in longs if dsync.piece_count(len(q)) == 2]
    rec = {"reads": len(recs), "past_l_cap": len(longs), "wall_s": wall,
           "time": phases, "launches": launches, "routes": routes,
           "peak_mib": peak, "cut_pack": cut,
           "routes_p2": long_routes(torch, index, p2[:ROUTE_SAMPLE],
                                    "long tail, 2 pieces"),
           "routes_ultra": long_routes(torch, index,
                                       longs[-ULTRA_LONG_READS:],
                                       "long tail, 0.5-1 Mb")}
    rec["union_samples"] = {"2 pieces": p2[:ROUTE_SAMPLE],
                            "0.5-1 Mb": longs[-ULTRA_LONG_READS:]}
    return rec


# ------------------------------------------------------------ phase 19 --
TAIL_READS_19 = 512  # phase 18's length recipe, from 30 kb genomes


def circular_tail_reads(rng, gdir: str) -> list[tuple[str, bytes]]:
    """Phase 19's reads from the genomes of gdir: TAIL_READS_19 of phase
    18's log-normal lengths (median 8 kb, sigma 1.0, up to LONG_TAIL_MAX)
    and ULTRA_LONG_READS of 0.5-1 Mb, each from a random genome taken as
    circular (a read past its 30 kb repeats it), 4% substitutions; the
    reads up to L_CAP first, then the longer ones."""
    from taxor_tpu_torch.hash import device_syncmer as dsync

    names = sorted(os.listdir(gdir))
    lens = np.minimum(rng.lognormal(np.log(8000), 1.0, TAIL_READS_19),
                      LONG_TAIL_MAX).astype(int)
    lens = np.concatenate([np.maximum(lens, 1), rng.integers(
        500_000, 1_000_001, ULTRA_LONG_READS)])
    genomes: dict = {}
    recs = []
    for j, n in enumerate(lens.tolist()):
        name = names[int(rng.integers(0, len(names)))]
        if name not in genomes:
            with open(os.path.join(gdir, name), "rb") as fh:
                head, seq = fh.read().split(b"\n", 1)
            genomes[name] = (head[1:].split()[0].decode(), np.frombuffer(
                seq.replace(b"\n", b""), np.uint8))
        acc, seq = genomes[name]
        off = int(rng.integers(0, seq.shape[0]))
        arr = np.tile(seq, n // seq.shape[0] + 2)[off:off + n].copy()
        recs.append((f"tail{j}_{acc}", mutate(rng, arr, 0.04)))
    return ([r for r in recs if len(r[1]) <= dsync.L_CAP]
            + [r for r in recs if len(r[1]) > dsync.L_CAP])


def long_nonsyncmer(torch, work: str, label: str, state: dict,
                    gdir: str) -> dict:
    """Phase 19: minimiser or plain k-mer reads past L_CAP on the index of
    phase 13a or 13b (``state``, nonsyncmer_path's), drawn from its own
    genomes (gdir): ``cli search --engine device`` with the launch counts
    set to 0 just before and read just after, K5 and a probe kernel must
    launch, every read must take the fused step, every read past L_CAP
    counted ``long_fused`` and none hashed on the host, and the TSV must
    equal ``--engine host`` on every read past L_CAP; wall, routes, peak
    device memory; then the fused step of 16 reads of the ~1 Mb bucket
    (the 0.5-1 Mb reads twice) with its peak device memory; then both
    routes timed (``long_routes``) on the path's 16 reads of 40 kb and on
    two of the 0.5-1 Mb reads."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.search.thresholds import Thresholder

    os.makedirs(work, exist_ok=True)
    recs = circular_tail_reads(np.random.default_rng(SEED + 19), gdir)
    n_short = sum(len(q) <= dsync.L_CAP for _, q in recs)
    longs = recs[n_short:]
    reads = os.path.join(work, f"{label}_tail.fasta")
    write_fasta(reads, recs)
    bases = sum(len(q) for _, q in recs)
    out_dev = os.path.join(work, f"{label}_tail_device.tsv")
    tag = f"{label} tail"
    launches, routes, wall, peak = device_search(torch, state["idx"], reads,
                                                 out_dev, tag)
    if (routes["fused"] != len(recs) or routes["long_fused"] != len(longs)
            or routes["host_hashes"] != 0):
        raise AssertionError(f"[{tag}] routes {routes}: every read past "
                             "L_CAP must take the fused step whole")
    probe_key = "K2n" if len(state["index"].hixf.ixfs) > 1 else "K2"
    if launches["K5"] <= 0 or launches[probe_key] <= 0:
        raise AssertionError(f"[{tag}] a kernel never launched: {launches}")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    log(f"[{tag}] {len(recs)} reads ({bases / 1e6:.1f} Mb), {len(longs)} "
        f"past L_CAP ({sum(len(q) for _, q in longs) / bases:.3f} of the "
        f"bases, the longest {max(len(q) for _, q in longs)}) in "
        f"{wall:.2f} s wall; .time [{phases}]; launches {launches}; routes "
        f"{routes}; peak device memory {peak:.1f} MiB; {card_line()}")
    host_parity(work, state["idx"], longs, 0, out_dev, tag)
    # 16 reads of the ~1 Mb bucket, a whole sub-batch, on the card
    index = state["index"]
    sch = index.scheme
    th = Thresholder.make(kmer_size=sch.kmer_size,
                          window_size=sch.window_size, error_rate=0.04,
                          percentage=-1.0, use_syncmer=sch.use_syncmer)
    ultra = [q for _, q in longs[-ULTRA_LONG_READS:]] * 2
    L = dsync.bucket_len(1_000_000)
    packed, lengths = dsync.pack_reads(ultra, L)
    dh = DeviceHIXF.from_hixf(index.hixf, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dh.e2e_async(packed, lengths, sch, th)()
    torch.cuda.synchronize()
    batch_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"[{tag}] the fused step of {len(ultra)} reads of the {L} bucket: "
        f"peak device memory {batch_mib:.1f} MiB above the index")
    check_long_probe(torch, dh, packed, lengths, sch, tag)
    del dh
    rec = {"reads": len(recs), "bases": bases, "past_l_cap": len(longs),
           "wall_s": wall, "time": phases, "launches": launches,
           "routes": routes, "peak_mib": peak,
           "ultra_batch_peak_mib": batch_mib,
           "routes_40kb": long_routes(
               torch, index, [q for _, q in state["recs"][state["n_reads"]:]],
               f"{label}, 40 kb"),
           "routes_ultra": long_routes(
               torch, index, [q for _, q in longs[-2:]],
               f"{label}, 0.5-1 Mb")}
    return rec


def check_long_probe(torch, dh, packed, lengths, sch, tag: str) -> None:
    """The probe at a batch of H = L hash slots past L_CAP (K5's rows of
    the batch) against its twin on the card, bit-exact: K2 on a flat
    table (the route its shape picks), or on a hierarchy the run sums of
    the root group and of the first group of the other K2n mode, every
    read active in the first two subgroups of each (the twin probes only
    active pairs)."""
    from taxor_tpu_torch.device import extract, probe
    from taxor_tpu_torch.device.hixf_search import _scale_thresh

    dev = torch.device("cuda")
    pk, ln = (torch.from_numpy(x).to(dev) for x in (packed, lengths))
    hi, lo, valid, _, n_unique = extract.minimizer_kmers(
        pk, ln, sch.kmer_size, sch.window_size, _scale_thresh(sch))
    R, H = hi.shape
    if dh.flat_fast_path:
        got = probe.probe_counts(hi, lo, valid, dh.table, dh.seed,
                                 dh.block_length)
        assert_equal(torch, f"[{tag}] K2 at R={R}, H={H}", ("counts",),
                     (got,), (probe.probe_counts_plain(
                         hi, lo, valid, dh.table, dh.seed,
                         dh.block_length),))
        log(f"[{tag}] K2 at R={R}, H={H} ({int(n_unique.sum())} valid "
            f"slots) on {list(dh.table.shape)} bit-exact vs twin, the "
            f"largest count {int(got.max())}")
        return
    modes = {}
    for g in dh.groups:
        S, Bp = g["tables"].shape[1:]
        mode = probe.narrow_mode(S, Bp, dev) if Bp <= 512 else "K2"
        if mode in modes:
            continue
        modes[mode] = g
        tables = g["tables"]
        act = torch.zeros((tables.shape[0], R), dtype=torch.bool, device=dev)
        act[:2] = True
        args = (hi, lo, valid, tables, act, g["run_off"], g["run_s"],
                g["run_e"], g["seed"], g["bl"])
        got = probe.probe_run_sums_grouped(*args)
        assert_equal(torch, f"[{tag}] run sums ({mode}) at R={R}, H={H}",
                     ("sums",), (got,),
                     (probe.probe_run_sums_grouped_plain(*args),))
        log(f"[{tag}] run sums of a group {list(tables.shape)} ({mode}) at "
            f"R={R}, H={H} bit-exact vs twin, the largest {int(got.max())}")
        if len(modes) == 2:
            break


# ------------------------------------------------------------ phase 16 --
SYNCMER_FLAGS = ["--kmer-size", str(K), "--syncmer-size", str(S),
                 "--use-syncmer"]
# phase 16c's second reference set (phase 7's recipe), besides phase 7's
CHOICE_GENOMES, CHOICE_READS = 1024, 2048
# phase 16c's layouts: name -> (--layout, further build flags)
LAYOUTS = {"flat": ("flat", []), "cpu": ("auto", []),
           "device": ("auto", ["--layout-cost", "device",
                               "--output-verbose-statistics"])}
# the device model's layout may take at most this much longer than the
# fastest of the three layouts (16c), and its predictions of
# bench_gather_scale's calls must fall within MODEL_SLACK of them (16b);
# HOST_SLACK for the calls the host's launch path bounds, whose time the
# host's speed moves (on one machine, in one process, the empty group's
# probe call took 0.028-0.044 ms and its descent step 0.19-0.36 ms, in
# runs of calls at either speed)
CHOICE_SLACK = 1.10
MODEL_SLACK = 0.30
HOST_SLACK = 0.50


# phase 16a's hash slots a read: either side of the thin slabs' least
ROUTE_SLOTS = (2048, 8191, 8192, 32768)


def check_routing(torch, probe) -> None:
    """Phase 16a: the layout cost model's host copies of K2's and K2n's
    routing rules (hixf/device_cost.py: slab_bins at ROUTE_SLOTS hash
    slots a read, slab_fit and narrow_mode, with the H100's opt-in shared
    memory a block as a constant) equal the card's (probe.slab_bins and
    its fit, probe.narrow_mode) on device_cost.routing_grid()."""
    from taxor_tpu_torch.hixf import device_cost

    dev = torch.device("cuda")
    optin = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)
    grid = device_cost.routing_grid()
    bad = [(s, b) for s, b in grid
           if probe.narrow_mode(s, b, dev) != device_cost.narrow_mode(s, b)
           or any(probe.slab_bins(s, b, h, dev)
                  != device_cost.slab_bins(s, b, h) for h in ROUTE_SLOTS)
           or probe.slab_bins(s, b, 0, dev, fit=True)
           != device_cost.slab_fit(s, b)]
    if bad or optin not in (None, device_cost.SMEM_OPTIN):
        raise AssertionError(f"phase 16a: the host routing rules differ "
                             f"from the card's at {bad[:10]} ({len(bad)} "
                             f"points); opt-in shared memory {optin}")
    slots = sorted({s for s, _ in grid})
    log(f"phase 16a: host slab_bins, slab_fit and narrow_mode == the "
        f"card's at "
        f"{len(grid)} (S, Bpad) points (S {slots[0]}-{slots[-1]}, Bpad "
        f"16-4096); opt-in shared memory a block {optin} B")


def check_fit(torch) -> dict:
    """Phase 16b: tools.bench_gather_scale at its default shapes: every
    route bit-exact to its twin, each call's time beside the model's
    prediction, which must fall within MODEL_SLACK of it (HOST_SLACK
    where the model's host floor bounds the call)."""
    from taxor_tpu_torch.tools import bench_gather_scale

    out = bench_gather_scale.run(argparse.Namespace(
        shapes="default", seed=0, device="cuda"))
    off = []
    for name, rec in out["shapes"].items():
        for rt, r in rec["routes"].items():
            log(f"phase 16b: {name} {rec['tables']} {rt}: {r['ms']:.4f} ms "
                f"a call ({r['device_ms']:.4f} on the device), model "
                f"{r['model_ms']:.4f} ms"
                f"{' (host floor)' if r['host_bound'] else ''}; == twin: "
                f"{r['equal']}")
            slack = HOST_SLACK if r["host_bound"] else MODEL_SLACK
            if abs(r["model_ms"] - r["ms"]) > slack * r["ms"]:
                off.append((name, rt, r["ms"], r["model_ms"]))
    if not out["equal"]:
        raise AssertionError("phase 16b: a route differs from its twin")
    if off:
        raise AssertionError(f"phase 16b: the model misses these calls by "
                             f"more than {MODEL_SLACK:.0%} (host-bound "
                             f"{HOST_SLACK:.0%}): {off}")
    return out


def build_layouts(work: str, label: str, tsv: str, gdir: str,
                  names) -> dict:
    """Phase 16c's indexes of one reference set under work: {name: its
    file} for the LAYOUTS ``names``."""
    os.makedirs(work, exist_ok=True)
    return {name: cli_build(work, tsv, gdir, SYNCMER_FLAGS + LAYOUTS[name][1],
                            LAYOUTS[name][0], f"{label}_{name}")[0]
            for name in names}


def build_choice(work: str, genomes: int, reads: int) -> dict:
    """Phase 16c's second reference set and its three layouts (a
    background build)."""
    data = new_reference_set(np.random.default_rng(SEED + 16), work,
                             genomes, reads)
    data["idx"] = build_layouts(work, f"g{genomes}", data["tsv"],
                                data["gdir"], LAYOUTS)
    return data


def build_hier_layouts(work: str, label: str, tsv: str, gdir: str) -> dict:
    """Phase 16c's flat and device layouts of phase 7's genomes (a
    background build; phase 7's own index is the cpu layout)."""
    return {"idx": build_layouts(work, label, tsv, gdir, ("flat", "device"))}


def layout_key(index) -> str:
    """A digest of what a search reads of an index, blind to the order of
    each IXF's bins: the hash scheme and, from the root down, each IXF's
    block length and seed and the sorted digests of its bins, a bin's
    fingerprint column with its user bin's file or its child IXF's digest.
    Two builds that place the same bins in another order do the same work
    on the card."""
    import hashlib

    hixf = index.hixf

    def ixf_key(i: int) -> bytes:
        ixf = hixf.ixfs[i]
        cols = []
        for b in range(ixf.bin_count):
            user = int(hixf.bin_to_user[i][b])
            below = (hixf.user_bin_filenames[user].encode() if user >= 0
                     else ixf_key(int(hixf.next_ixf_id[i][b])))
            cols.append(hashlib.sha256(np.ascontiguousarray(
                ixf.fingerprints[:, b]).tobytes() + below).digest())
        head = repr((ixf.slots, ixf.block_length, ixf.seed)).encode()
        return hashlib.sha256(head + b"".join(sorted(cols))).digest()

    return hashlib.sha256(repr(index.scheme).encode()
                          + ixf_key(0)).hexdigest()


def layout_choice(torch, work: str, label: str, data: dict) -> dict:
    """Phase 16c: three layouts of one reference set (data: tsv, gdir,
    recs, n_reads, and idx: {"flat", "cpu", "device": the index file},
    built already): flat, the cpu model's and the device model's at
    --tmax TMAX.  Each one's fused step on the L=8192 bucket (R = 512 reads,
    DeviceHIXF.e2e_async with its collect, CUDA events, the least of four
    means of 20 calls in turns a, b, c, c, b, a, a, b, c, c, b, a) beside
    the device model's ms a read of its probe launches
    (device_cost.hixf_ms_per_read); the device layout must be the fastest
    or within CHOICE_SLACK of it, and its TSV equal to --engine host on
    the first CHECK_READS reads and the long ones.  Layouts equal but for
    the order of their bins (``layout_key``) are one layout: they share
    one step and its times, so that two timings of the same layout never
    stand for two layouts."""
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.hixf import device_cost
    from taxor_tpu_torch.hixf.index import load_index
    from taxor_tpu_torch.search.thresholds import Thresholder

    os.makedirs(work, exist_ok=True)
    built = {name: (data["idx"][name], load_index(data["idx"][name]))
             for name in LAYOUTS}
    th = Thresholder.make(K, K, 0.04, -1.0, True)
    seqs = bucket_reads(data["recs"], 8192)
    packed, lengths = dsync.pack_reads(seqs, 8192)
    steps, rows, same, first = {}, {}, {}, {}
    for name, (_, index) in built.items():
        same[name] = first.setdefault(layout_key(index), name)
        if same[name] == name:
            same[name] = None
            dh = DeviceHIXF.from_hixf(index.hixf, "cuda")
            steps[name] = (lambda dh=dh, sc=index.scheme:  # noqa: E731
                           dh.e2e_async(packed, lengths, sc, th)())
        levels = device_cost.hixf_levels(index.hixf)
        rows[name] = {
            "ixfs": len(index.hixf.ixfs),
            "launches": [[x["route"], x["shape"]] for x in
                         device_cost.batch_launches(levels)],
            "model_ms_per_read": device_cost.hixf_ms_per_read(index.hixf)}
    times = {n: [] for n in steps}
    for name in (list(steps) + list(steps)[::-1]) * 2:
        times[name].append(cuda_ms(steps[name], 20))
    for name, row in rows.items():
        timed = same[name] or name
        row["ms"] = min(times[timed])
        row["ms_per_read"] = row["ms"] / len(seqs)
        if same[name]:
            row["same_as"] = same[name]
        log(f"phase 16c [{label}] {name}: {row['ixfs']} IXF(s), launches "
            f"{row['launches']}; model {row['model_ms_per_read'] * 1e3:.3f} "
            f"us a read, measured {row['ms']:.4f} ms a batch of "
            f"{len(seqs)} = {row['ms_per_read'] * 1e3:.3f} us a read "
            f"({'/'.join(f'{t:.4f}' for t in times[timed])} ms"
            f"{f'; the {timed} layout itself' if same[name] else ''})")
    best = min(r["ms"] for r in rows.values())
    if rows["device"]["ms"] > CHOICE_SLACK * best:
        raise AssertionError(f"phase 16c [{label}]: the device model's "
                             f"layout is not within {CHOICE_SLACK} of the "
                             f"fastest: {rows}")
    idx = built["device"][0]
    recs, n_reads = data["recs"], data["n_reads"]
    sub = os.path.join(work, f"{label}_device_subset.fasta")
    write_fasta(sub, recs[:min(CHECK_READS, n_reads)] + recs[n_reads:])
    out_dev = os.path.join(work, f"{label}_device.tsv")
    device_search(torch, idx, sub, out_dev, f"{label}_device")
    host_parity(work, idx, recs, n_reads, out_dev, f"{label}_device")
    return rows


def new_reference_set(rng, work: str, n_genomes: int, n_reads: int) -> dict:
    """Phase 7's recipe (genomes of GENOME_LEN, ONT-like reads and
    LONG_READS reads of 40 kb) under work."""
    os.makedirs(work, exist_ok=True)
    tsv, gdir, genomes = make_genomes(rng, work, n_genomes, GENOME_LEN)
    return {"tsv": tsv, "gdir": gdir, "n_reads": n_reads,
            "recs": make_reads(rng, genomes, n_reads, LONG_READS)}


def invariance_on_card() -> str:
    """Phase 16d: tools.layout_invariance at 100 species and 400 reads
    on the card; its table must have the device_model row."""
    from taxor_tpu_torch.tools import layout_invariance

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "taxor_tpu_torch", "_build")
    tmp = tempfile.mkdtemp(prefix="layout_inv_", dir=root)
    try:
        text = layout_invariance.table(layout_invariance.run(
            100, 400, device="cuda", tmp=tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "\ndevice_model " not in text:
        raise AssertionError("phase 16d: no device_model row")
    for line in text.splitlines():
        if not line.startswith("  diff"):
            log(f"phase 16d: {line}")
    return text


# ------------------------------------------------------------ phase 17 --
# phase 17's reference set: ROUTE_CLUSTERS species of ROUTE_STRAINS
# strains each (the species' ancestor with ROUTE_DIVERGENCE substitutions),
# as RefSeq holds many strains of one species, and ROUTE_SINGLES genomes
# of no cluster; ROUTE_READS reads of phase 4's recipe and LONG_READS
ROUTE_CLUSTERS, ROUTE_STRAINS, ROUTE_SINGLES = 12, 80, 64
ROUTE_DIVERGENCE = 0.005
ROUTE_READS = 4096
ROUTE_SCALING = 3  # 17b and 17c: --scaling 3 keeps ~1/3 of the hashes
# batches of the top-k copy's search: 17 of them, so that batches start
# after each step of the ladder (the CLI's 1,024 give 5, and the first
# four start together at k = 16)
ROUTE_BATCH = 256


def strain_set(rng, work: str) -> dict:
    """Phase 17's genomes (ROUTE_CLUSTERS x ROUTE_STRAINS strains, then
    ROUTE_SINGLES unrelated ones, all of GENOME_LEN) and reads."""
    os.makedirs(work)
    seqs = []
    for _ in range(ROUTE_CLUSTERS):
        ancestor = ACGT[rng.integers(0, 4, GENOME_LEN)]
        seqs += [mutate(rng, ancestor.copy(), ROUTE_DIVERGENCE)
                 for _ in range(ROUTE_STRAINS)]
    seqs += [ACGT[rng.integers(0, 4, GENOME_LEN)].tobytes()
             for _ in range(ROUTE_SINGLES)]
    tsv, gdir, genomes = write_genomes(work, seqs)
    recs = make_reads(rng, genomes, ROUTE_READS, LONG_READS)
    reads = os.path.join(work, "reads.fasta")
    write_fasta(reads, recs)
    return {"tsv": tsv, "gdir": gdir, "reads": reads, "recs": recs}


def hash_counts(path: str) -> dict:
    """{read id: QHASH_COUNT} of a TSV's classified reads."""
    counts = {}
    for row in tsv_rows(path):
        cols = row.split("\t")
        if len(cols) == 10:
            counts.setdefault(cols[0], int(cols[6]))
    return counts


def route_search(torch, work: str, label: str, idx: str, data: dict, need,
                 batch_size: int = 0, host_tsv: str = "") -> dict:
    """One search of phase 17 through ``device_search``, the kernels
    ``need`` launched, every read fused (those past L_CAP in pieces);
    its TSV must equal ``--engine host`` byte for byte
    on every read (those that took a fallback among them), run here or
    given as ``host_tsv``."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.device.hixf_search import ACTIVITY
    from taxor_tpu_torch.search import pipeline

    out_dev = os.path.join(work, f"{label}_device.tsv")
    launches, routes, wall, peak = device_search(torch, idx, data["reads"],
                                                 out_dev, label, batch_size)
    active = ACTIVITY.share()
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"[{label}] the search skipped one of {need}: "
                             f"{launches}")
    if (routes["fused"] != ROUTE_READS + LONG_READS
            or routes["long_fused"] != LONG_READS
            or routes["host_hashes"] != 0):
        raise AssertionError(f"[{label}] routes {routes}: expected every "
                             f"read fused, those past L_CAP in pieces")
    t0 = time.perf_counter()
    if not host_tsv:
        host_tsv = os.path.join(work, f"{label}_host.tsv")
        rc = cli.main(["search", "--index-file", idx, "--query-file",
                       data["reads"], "--output-file", host_tsv, "--engine",
                       "host", "--device", "cuda", "--threads",
                       str(os.cpu_count() or 1)])
        if rc != 0:
            raise RuntimeError(f"[{label}] host search failed ({rc})")
    with open(out_dev, "rb") as fa, open(host_tsv, "rb") as fb:
        if fa.read() != fb.read():
            dev_rows, host_rows = tsv_rows(out_dev), tsv_rows(host_tsv)
            bad = next((i for i, (a, b) in enumerate(zip(dev_rows,
                                                         host_rows))
                        if a != b), min(len(dev_rows), len(host_rows)))
            raise AssertionError(f"[{label}] device TSV differs from host "
                                 f"TSV at row {bad} ({len(dev_rows)} vs "
                                 f"{len(host_rows)} rows)")
    n = len(data["recs"])
    log(f"[{label}] {n} reads in {wall:.2f} s wall; launches {launches}; "
        f"routes {routes} (host-oracle fallback "
        f"{routes['host_fallback'] / n:.4f}); "
        f"active (subgroup, read) pairs {active:.4f}; peak device memory "
        f"{peak:.1f} MiB; TSV == --engine host byte for byte on all {n} "
        f"reads (host engine {time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "routes": routes,
            "active_share": active, "wall": wall, "device_tsv": out_dev,
            "host_tsv": host_tsv}


def build_routes(work: str) -> dict:
    """Phase 17's strain set and its indexes (a background build): 17a
    k = 22, s = 12 syncmers flat, 17b the same with --scaling 3 flat, 17c
    17b's scheme --layout auto --tmax 64."""
    t0 = time.perf_counter()
    data = strain_set(np.random.default_rng(SEED + 17), work)
    log(f"[routes] data: {ROUTE_CLUSTERS} species x {ROUTE_STRAINS} "
        f"strains ({ROUTE_DIVERGENCE:.1%} substitutions from the species' "
        f"ancestor) + {ROUTE_SINGLES} genomes x {GENOME_LEN} b, "
        f"{ROUTE_READS} reads + {LONG_READS} x 40 kb, made in "
        f"{time.perf_counter() - t0:.1f} s")
    scaled = SYNCMER_FLAGS + ["--scaling", str(ROUTE_SCALING)]
    data["idx"] = {
        label: cli_build(work, data["tsv"], data["gdir"], flags, layout,
                         label)[0]
        for label, flags, layout in (("17a", SYNCMER_FLAGS, "flat"),
                                     ("17b", scaled, "flat"),
                                     ("17c", scaled, "auto"))}
    return data


def routes_path(torch, work: str, data: dict) -> dict:
    """Phase 17: the routes of the device search no main path takes, on
    strains of one species (data: ``build_routes``'s): (a) k = 22,
    s = 12 syncmers, --layout flat,
    as built, then from a copy saved with suggested_topk = 16, which must
    escalate 16 -> 64 -> 256 (truncated reads go to the host oracle);
    (b) the same scheme with --scaling 3, --layout flat (K1, the keep as
    tensor ops, K2's slab route); (c) (b)'s scheme with --layout auto
    --tmax 64 (the count-table descent on K2n, thresholds indexed by the
    count kept).  (b) and (c) must keep ~1/3 of (a)'s hashes.  Returns
    the searches' records."""
    import dataclasses

    from taxor_tpu_torch.hixf.index import load_index, save_index

    runs = {}
    idx = data["idx"]["17a"]
    index = load_index(idx)
    log(f"[17a] suggested_topk of the index as built: "
        f"{index.suggested_topk}")
    runs["17a"] = route_search(torch, work, "17a", idx, data,
                               ("K1", "K2 slab"))
    copy = os.path.join(work, "17a_topk16.taxor.npz")
    save_index(copy, dataclasses.replace(index, suggested_topk=16))
    del index
    runs["17a topk16"] = esc = route_search(
        torch, work, "17a topk16", copy, data, ("K1", "K2 slab"),
        batch_size=ROUTE_BATCH, host_tsv=runs["17a"]["host_tsv"])
    # from k = 16, two steps of the ladder end it at 256
    if esc["routes"]["topk_escalations"] < 2 \
            or esc["routes"]["truncated"] <= 0:
        raise AssertionError(f"[17a topk16] the top-k ladder did not climb "
                             f"16 -> 64 -> 256: routes {esc['routes']}")
    runs["17b"] = route_search(torch, work, "17b", data["idx"]["17b"],
                               data, ("K1", "K2 slab"))
    idx = data["idx"]["17c"]
    if len(load_index(idx).hixf.ixfs) <= 1:
        raise AssertionError("[17c] the scaled index is not hierarchical")
    runs["17c"] = route_search(torch, work, "17c", idx, data, ("K1", "K2n"))
    if not 0.0 < runs["17c"]["active_share"] < 1.0:
        raise AssertionError(f"[17c] not the count-table descent: active "
                             f"pairs {runs['17c']['active_share']}")
    whole = hash_counts(runs["17a"]["device_tsv"])
    for label in ("17b", "17c"):
        kept = hash_counts(runs[label]["device_tsv"])
        both = kept.keys() & whole.keys()
        share = sum(kept[r] for r in both) / sum(whole[r] for r in both)
        runs[label]["kept_share"] = share
        log(f"[{label}] hashes kept by the FracMinHash keep: {share:.4f} of "
            f"17a's on the {len(both)} reads both classify")
        if not 0.28 < share < 0.39:
            raise AssertionError(f"[{label}] kept {share:.4f} of the hashes, "
                                 f"not ~1/{ROUTE_SCALING}")
    return runs


def only_routes(torch, cuda_build, root: str, card: str) -> int:
    """``--only-routes``: the search's kernels built, then phase 17 alone;
    its searches' launches, routes and ladders as one JSON line."""
    t0 = time.perf_counter()
    cuda_build.lib()
    log(f"build: search kernels compiled and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    work = tempfile.mkdtemp(prefix="chip_smoke_routes_", dir=root)
    try:
        with phase("phase 17"):
            routes = os.path.join(work, "routes")
            runs = routes_path(torch, routes, build_routes(routes))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"phase 17": {
        label: {k: v for k, v in r.items() if not k.endswith("_tsv")}
        for label, r in runs.items()}}))
    print(card)
    return 0


# ------------------------------------------------------------ phase 20 --
# syncmer schemes past the 32-bit s-mer: K1's and syncmer_track's 64-bit
# instances (16 <= s <= 31; (30, 29) the widest the CLI builds) and a
# narrow scheme (k - s + 1 = 3) at its own hash capacity
WIDE_SCHEMES = ((22, 16), (28, 18), (18, 16), (30, 29), (16, 14))
WIDE_K, WIDE_S = 28, 18
NARROW_K, NARROW_S = 16, 14
WIDE_FLAGS = ["--kmer-size", str(WIDE_K), "--syncmer-size", str(WIDE_S),
              "--use-syncmer"]
NARROW_FLAGS = ["--kmer-size", str(NARROW_K), "--syncmer-size",
                str(NARROW_S), "--use-syncmer"]
WIDE_HIER_GENOMES = 1024  # the hierarchy's: the first of phase 4's
K1_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
RANDOM_K1_READS = 11  # k1_reads' reads of random bases come first
OVERFLOW_READS = 512  # the overflow search's: phase 13b's first reads


def k1_and_twins(torch, dsync, extract, pk, ln, k: int, s: int, t: int,
                 hcap: int, pieces: int = 1):
    """(K1's outputs, syncmer_track's, K1's twin's, syncmer_track's
    twin's) on the same rows; the twins from one tracker pass."""
    got = extract.syncmer_hashes(pk, ln, k, s, t, hcap, pieces=pieces)
    track = extract.syncmer_track(pk, ln, k, s, t, pieces=pieces)
    kmer, emit = extract._kmers_plain(pk, ln, k, s, t, pieces)
    srt, valid, n_unique, n_emit = dsync.dedup_kmers(kmer, emit, hcap)
    want = (*extract.hashes_of_kmers(srt, valid), valid, n_unique, n_emit)
    return got, track, want, (kmer, emit)


def check_wide_k1(torch, dsync, extract, rng) -> dict:
    """Phase 20a: K1 and syncmer_track through the instance each s picks
    against their twins, bit-exact, for WIDE_SCHEMES at every length
    bucket on phase 2's reads, at the scheme's hash capacity, with no
    random read past it; then on piece rows of reads of 2 and 32 pieces
    (tools/synth.reads_across_cuts: tied stretches and Ns across every
    cut, tied stretches past a piece)."""
    from taxor_tpu_torch.tools import synth

    dev = torch.device("cuda")
    names = ("hi", "lo", "valid", "n_unique", "n_emit", "kmer", "emit")
    out = {}
    for k, s in WIDE_SCHEMES:
        t = (k - s + 1) // 2
        rec = {"instance": extract.smer_bits(s), "buckets": {},
               "pieces": {}}
        for L in K1_BUCKETS:
            seqs = k1_reads(rng, L)
            pk, ln = (torch.from_numpy(x).to(dev)
                      for x in dsync.pack_reads(seqs, L))
            hcap = dsync.hash_cap(L, k, s, t)
            got, track, want, twin = k1_and_twins(torch, dsync, extract, pk,
                                                  ln, k, s, t, hcap)
            assert_equal(torch, f"K1 and syncmer_track L={L} k={k} s={s}",
                         names, (*got, *track), (*want, *twin))
            worst = int(got[4][:RANDOM_K1_READS].max())
            if worst > hcap:
                raise AssertionError(f"K1 L={L} k={k} s={s}: a random read "
                                     f"emits {worst} > hcap {hcap}")
            rec["buckets"][L] = {"hcap": hcap, "random_n_emit_max": worst,
                                 "n_emit_max": int(got[4].max())}
        for P in (2, 32):
            L = dsync.pieces_len(P)
            seqs = [q[:L] for q in synth.reads_across_cuts(
                rng, k, lengths=(L - 5,))]
            pk, ln = (torch.from_numpy(x).to(dev)
                      for x in dsync.pack_reads(seqs, L))
            hp = dsync.hash_cap(dsync.L_CAP, k, s, t)
            got, track, want, twin = k1_and_twins(torch, dsync, extract, pk,
                                                  ln, k, s, t, hp, P)
            assert_equal(torch, f"K1 and syncmer_track, {P} pieces, k={k} "
                         f"s={s}", names, (*got, *track), (*want, *twin))
            rec["pieces"][P] = {"reads": len(seqs), "rows": len(seqs) * P,
                                "hcap": hp}
        log(f"K1 and syncmer_track ({rec['instance']}-bit s-mers) k={k} s={s}"
            f" t={t}: bit-exact vs twins at every bucket 256-32768 and on "
            f"piece rows of 2 and 32 pieces; {json.dumps(rec)}")
        out[f"{k}/{s}"] = rec
    return out


def build_wide(work: str, tsv: str, gdir: str) -> dict:
    """Phase 20's k = WIDE_K, s = WIDE_S indexes of phase 4's genomes (a
    background build): flat on all of them, --layout auto --tmax 64 on
    the first WIDE_HIER_GENOMES."""
    os.makedirs(work)
    sub = os.path.join(work, "taxonomy.tsv")
    with open(tsv) as fh, open(sub, "w") as out:
        out.writelines(fh.readlines()[:WIDE_HIER_GENOMES])
    return {"flat": cli_build(work, tsv, gdir, WIDE_FLAGS, "flat",
                              "wide_flat")[0],
            "hier": cli_build(work, sub, gdir, WIDE_FLAGS, "auto",
                              "wide_hier")[0]}


def build_narrow(work: str, tsv: str, gdir: str) -> dict:
    """Phase 20's flat k = NARROW_K, s = NARROW_S index of phase 13b's
    genomes (a background build)."""
    os.makedirs(work)
    return {"flat": cli_build(work, tsv, gdir, NARROW_FLAGS, "flat",
                              "narrow_flat")[0]}


def smer_search(torch, work: str, label: str, idx: str, recs,
                n_long: int, wide: bool, split: bool = False) -> dict:
    """Phase 20b: ``cli search --engine device`` of recs with every launch
    count set to 0 just before: every read fused (the n_long past L_CAP
    in pieces), none hashed on the host, none past the hash capacity, K1
    (its 64-bit instance alone for a wide scheme), the probe, K4 and K6
    launched; the TSV equal to ``--engine host`` on every read, and for
    ``split`` the split engine's TSV equal on every read, with
    syncmer_track (its 64-bit instance for a wide scheme) and K3."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.device import e2e

    reads = os.path.join(work, f"{label}.fasta")
    write_fasta(reads, recs)
    out_dev = os.path.join(work, f"{label}_device.tsv")
    launches, routes, wall, peak = device_search(torch, idx, reads, out_dev,
                                                 label)
    n = len(recs)
    if routes["fused"] != n or routes["long_fused"] != n_long \
            or routes["host_hashes"] != 0 or routes["hcap_overflow"] != 0:
        raise AssertionError(f"[{label}] routes {routes}: every read must "
                             "take the fused step, none past its capacity")
    if launches["K1"] <= 0 or launches["K2"] + launches["K2n"] <= 0 \
            or launches["K4"] <= 0 or launches["K6"] <= 0 \
            or launches["K1 s64"] != (launches["K1"] if wide else 0):
        raise AssertionError(f"[{label}] main path skipped a kernel: "
                             f"{launches}")
    out_host = os.path.join(work, f"{label}_host.tsv")
    t0 = time.perf_counter()
    rc = cli.main(["search", "--index-file", idx, "--query-file", reads,
                   "--output-file", out_host, "--engine", "host",
                   "--device", "cuda", "--threads", str(os.cpu_count() or 1)])
    host_s = time.perf_counter() - t0
    if rc != 0 or tsv_rows(out_dev) != tsv_rows(out_host):
        raise AssertionError(f"[{label}] device TSV differs from the host "
                             f"TSV (host rc {rc})")
    hits, right = accuracy(out_dev, recs)
    if right < 0.99 * hits:
        raise AssertionError(f"[{label}] only {right} of {hits} classified "
                             "reads name their source genome")
    rec = {"reads": n, "long_reads": n_long, "wall_s": wall,
           "host_engine_s": host_s, "peak_mib": peak, "routes": routes,
           "launches": launches, "classified": hits, "right": right}
    if split:
        out_split = os.path.join(work, f"{label}_split.tsv")
        e2e.USE_FUSED_EXTRACT = False
        try:
            sl, sr, swall, _ = device_search(torch, idx, reads, out_split,
                                             f"{label} split")
        finally:
            e2e.USE_FUSED_EXTRACT = True
        if sl["K1"] != 0 or sl["track"] <= 0 or sl["K3"] <= 0 \
                or sl["track s64"] != (sl["track"] if wide else 0) \
                or sr["host_hashes"] != 0 or sr["hcap_overflow"] != 0:
            raise AssertionError(f"[{label}] split engine: {sl} {sr}")
        with open(out_dev, "rb") as fa, open(out_split, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"[{label}] split-engine TSV differs "
                                     "from the K1 TSV")
        rec["split"] = {"wall_s": swall, "launches": sl, "routes": sr}
    log(f"[{label}] {n} reads ({n_long} past L_CAP) in {wall:.2f} s wall: "
        f"TSV == --engine host on every read (host {host_s:.1f} s)"
        f"{', == the split engine' if split else ''}; {hits} classified, "
        f"{right} to their source genome; routes {routes}; launches "
        f"{launches}; peak {peak:.1f} MiB")
    return rec


def overflow_search(torch, work: str, idx: str, recs, n_reads: int,
                    host_tsv: str) -> dict:
    """Phase 20b's fallback route: the narrow index searched once more,
    on its first OVERFLOW_READS reads and the long ones, with
    ``hixf_search.hash_cap`` held at 128 slots a row (a piece's row too),
    the floor of the JAX package's rule and below the ~170 emissions of
    the shortest read (500 bases) at this scheme's density of ~1/3.  So
    every read is extracted and probed on the card (K1), overflows
    (n_emit > hcap) and is decided again by the host oracle: every read
    fused and counted in hcap_overflow and host_fallback, none hashed on
    the host, and the TSV equal to ``--engine host`` on every read."""
    from taxor_tpu_torch.device import hixf_search
    from taxor_tpu_torch.hash import device_syncmer as dsync

    sub = recs[:min(OVERFLOW_READS, n_reads)] + recs[n_reads:]
    n, n_long = len(sub), len(recs) - n_reads
    reads = os.path.join(work, "narrow_overflow.fasta")
    write_fasta(reads, sub)
    out = os.path.join(work, "narrow_overflow_device.tsv")
    rule = hixf_search.hash_cap
    hixf_search.hash_cap = lambda L, k, s, t: 128 * dsync.bucket_pieces(L)
    try:
        launches, routes, wall, _ = device_search(torch, idx, reads, out,
                                                  "narrow_overflow")
    finally:
        hixf_search.hash_cap = rule
    if routes["fused"] != n or routes["long_fused"] != n_long \
            or routes["host_hashes"] != 0 or routes["hcap_overflow"] != n \
            or routes["host_fallback"] != n or launches["K1"] <= 0:
        raise AssertionError(f"[narrow_overflow] routes {routes}, launches "
                             f"{launches}: every read must be extracted on "
                             "the card, overflow and fall back to the host")
    if tsv_rows(out) != tsv_rows(host_tsv, {rid for rid, _ in sub}):
        raise AssertionError("[narrow_overflow] device TSV differs from the "
                             "host TSV")
    log(f"[narrow_overflow] {n} reads ({n_long} past L_CAP) at 128 hash "
        f"slots a row in {wall:.2f} s wall: every read overflowed on the "
        f"card and fell back to the host oracle, TSV == --engine host on "
        f"every read; routes {routes}; launches {launches}")
    return {"reads": n, "long_reads": n_long, "wall_s": wall,
            "routes": routes, "launches": launches}


def time_wide(torch, recs) -> list[dict]:
    """Phase 20c: the 64-bit instances of K1 and syncmer_track at the wide
    flat path's L=8192 bucket against their twins, each with its bound,
    and K1 on phase 5's all-tied kind of batch."""
    from taxor_tpu_torch.device import extract
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_extract import all_tied_reads

    dev = torch.device("cuda")
    L, k, s = 8192, WIDE_K, WIDE_S
    t = (k - s + 1) // 2
    seqs = bucket_reads(recs, L)
    pk, ln = (torch.from_numpy(x).to(dev) for x in dsync.pack_reads(seqs, L))
    hcap = dsync.hash_cap(L, k, s, t)
    R = len(seqs)
    W = dsync.sort_width(L, k, s, t)
    n_emit = extract.syncmer_hashes(pk, ln, k, s, t, hcap)[4]
    cases = (
        ("syncmer_extract_s64", "taxor_tpu/device/pallas_extract.py:160",
         lambda: extract.syncmer_hashes(pk, ln, k, s, t, hcap),
         lambda: extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap),
         # as phase 5's K1 record, with the 64-bit tracker's operations
         bound(pk.numel() + 4 * R + 9 * R * hcap + 8 * R,
               float(ln.sum()) * tracker_ops(k, s)
               + float(n_emit.sum()) * KMER_OPS
               + sort_ops(n_emit.clamp(max=W).tolist()) + R * hcap,
               PEAK_SCALAR)),
        ("syncmer_track_s64",
         "taxor_tpu/hash/device_syncmer.py:279 (XLA scan, no Pallas "
         "kernel)", lambda: extract.syncmer_track(pk, ln, k, s, t),
         lambda: dsync.syncmer_kmers(pk, ln, k, s, t),
         bound(pk.numel() + 4 * R + 9 * R * L,
               float(ln.sum()) * tracker_ops(k, s) + R * L * KMER_OPS,
               PEAK_SCALAR)))
    rows = []
    for name, rep, fn, plain, bnd in cases:
        ms, plain_ms, err, each = time_pair(torch, fn, plain, 5)
        log(f"time {name} (k={k}, s={s}) at R={R}, L={L}, H={hcap}: kernel "
            f"{each[0]:.4f}/{each[1]:.4f} ms, plain {each[2]:.3f}/"
            f"{each[3]:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}); {card_line()}")
        rows.append({"name": name, "route": "cuda",
                     "source": "taxor_tpu_torch/csrc/extract.cu",
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bnd, "library_ms": None,
                     "scheme": [k, s, t], "shape": [R, L, hcap]})
    tied = all_tied_reads(np.random.default_rng(SEED + 20), L, R)
    tpk, tln = (torch.from_numpy(x).to(dev)
                for x in dsync.pack_reads(tied, L))
    worst, _, _, each = time_pair(
        torch, lambda: extract.syncmer_hashes(tpk, tln, k, s, t, hcap),
        lambda: extract.syncmer_hashes_plain(tpk, tln, k, s, t, hcap), 3)
    rows[0]["all_tied_ms"] = worst
    log(f"time syncmer_extract_s64 worst case, R={R} reads tied in every "
        f"window at L={L}: kernel {each[0]:.4f}/{each[1]:.4f} ms, plain "
        f"{each[2]:.3f}/{each[3]:.3f} ms; bit-exact vs twin")
    return rows


def wide_path(torch, work: str, flat: dict, kmer_in: dict, wide: dict,
              narrow: dict, k1_checks: dict) -> tuple[dict, list[dict]]:
    """Phase 20b-d on the background builds: the wide flat and
    hierarchical searches on phase 4's data, the narrow flat search on
    phase 13b's and its overflow route (``overflow_search``, whose
    launches the main paths' counts leave out), the 64-bit instances
    timed, and phase 4's reads of 40 kb
    on both routes of the wide flat index (the host-hash route is the one
    the parent's rule sent every read of this scheme down)."""
    from taxor_tpu_torch.hixf.index import load_index

    os.makedirs(work)
    recs, n4 = flat["recs"], flat["n_reads"]
    runs = {"wide_flat": smer_search(torch, work, "wide_flat", wide["flat"],
                                     recs, len(recs) - n4, True)}
    # phase 4's reads of the hierarchy's genomes and every long read
    first = {f"GCF_{i:06d}.1" for i in range(WIDE_HIER_GENOMES)}
    hier_recs = [r for r in recs[:n4] if r[0].split("_", 1)[1] in first]
    runs["wide_hier"] = smer_search(
        torch, work, "wide_hier", wide["hier"], hier_recs + recs[n4:],
        len(recs) - n4, True, split=True)
    nrecs = kmer_in["recs"]
    runs["narrow_flat"] = smer_search(
        torch, work, "narrow_flat", narrow["flat"], nrecs,
        len(nrecs) - kmer_in["n_reads"], False)
    runs["narrow_flat"]["overflow"] = overflow_search(
        torch, work, narrow["flat"], nrecs, kmer_in["n_reads"],
        os.path.join(work, "narrow_flat_host.tsv"))
    rows = time_wide(torch, recs)
    index = load_index(wide["flat"])
    routes40 = long_routes(torch, index, [q for _, q in recs[n4:]],
                           "wide flat")
    for row in rows:
        row["checks"] = k1_checks
    rows[0]["long_reads_40kb"] = routes40
    return runs, rows


# ------------------------------------------------- background builds --
# What phases 13a, 13b/13e, 15b, 16c, 17 and 20 search is built on the host
# while the card runs the phases before them: each job is a process of
# this script (``--prebuild JOB WORK PARAMS``) at the lowest CPU priority,
# so the phases in front keep the cores they ask for, and writes its
# records to WORK/JOB.pkl.
PREBUILDS = {"minimizer": build_minimizer, "kmer": build_kmer,
             "atscale": build_atscale, "choice": build_choice,
             "hier_layouts": build_hier_layouts, "routes": build_routes,
             "smer_wide": build_wide, "smer_narrow": build_narrow}


def prebuild_main(job: str, work: str, params: str) -> int:
    """One background build: PREBUILDS[job] under WORK/JOB."""
    os.nice(19)
    out = PREBUILDS[job](os.path.join(work, job), **json.loads(params))
    with open(os.path.join(work, f"{job}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    return 0


class Background:
    """The background builds of one run under work."""

    def __init__(self, work: str):
        self.work, self.procs = work, {}

    def start(self, job: str, **params) -> None:
        with open(os.path.join(self.work, f"{job}.log"), "w") as fh:
            self.procs[job] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--prebuild",
                 job, self.work, json.dumps(params)],
                stdout=fh, stderr=subprocess.STDOUT)

    def result(self, job: str):
        """Wait for job, echo its log, return its records."""
        t0 = time.perf_counter()
        rc = self.procs.pop(job).wait()
        log(tail(os.path.join(self.work, f"{job}.log"), 20000).rstrip())
        if rc != 0:
            raise RuntimeError(f"background build {job} failed ({rc})")
        log(f"background build {job}: waited {time.perf_counter() - t0:.1f}"
            f" s for it")
        with open(os.path.join(self.work, f"{job}.pkl"), "rb") as fh:
            return pickle.load(fh)

    def stop(self) -> None:
        """Kill every job still running."""
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        self.procs.clear()


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:  # one rank of a phase 14 search
        return rank_main(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--prebuild"]:  # one background build
        return prebuild_main(*sys.argv[2:5])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genomes", type=int, default=4096,
                    help="reference genomes of 30 kb in the flat index")
    ap.add_argument("--reads", type=int, default=8192,
                    help="ONT-like reads of the flat path (plus 16 of 40 kb)")
    ap.add_argument("--hier-genomes", type=int, default=4096,
                    help="reference genomes of 30 kb in the hierarchical "
                         "index (phases 7, 8 and 14b; 8,192 before phase "
                         "15 came)")
    ap.add_argument("--minimizer-genomes", type=int, default=8192,
                    help="reference genomes of 30 kb in phase 13a's scaled "
                         "minimiser hierarchy (phases 13a, 13d and 14c), "
                         "with --hier-reads reads")
    ap.add_argument("--hier-reads", type=int, default=16384,
                    help="ONT-like reads of the hierarchical path (plus 16 "
                         "of 40 kb)")
    ap.add_argument("--kmer-genomes", type=int, default=1024,
                    help="reference genomes of 30 kb in phase 13b's flat "
                         "plain k-mer index")
    ap.add_argument("--kmer-reads", type=int, default=4096,
                    help="ONT-like reads of phase 13b (plus 16 of 40 kb)")
    ap.add_argument("--atscale-reads", type=int, default=20000,
                    help="reads of phase 15's at-scale demo")
    ap.add_argument("--only-routes", action="store_true",
                    help="build the search's kernels and run phase 17 alone "
                         "(its records as one JSON line; no kernels line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from taxor_tpu_torch.device import cuda_build, extract, probe, sort
    from taxor_tpu_torch.hash import device_syncmer as dsync

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "taxor_tpu_torch", "_build")
    os.makedirs(root, exist_ok=True)
    if args.only_routes:
        return only_routes(torch, cuda_build, root, card)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
    bg = Background(work)
    try:
        # the host's builds of the later phases, while the card works
        bg.start("minimizer", genomes=args.minimizer_genomes,
                 reads=args.hier_reads)
        bg.start("atscale", reads=args.atscale_reads)
        bg.start("kmer", genomes=args.kmer_genomes, reads=args.kmer_reads)
        bg.start("choice", genomes=CHOICE_GENOMES, reads=CHOICE_READS)
        bg.start("routes")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:  # every nvcc of both libraries
            for built in [ex.submit(cuda_build.lib),
                          ex.submit(cuda_build.diag_lib)]:
                built.result()
        log(f"build: search and diagnostic kernels compiled and loaded in "
            f"{time.perf_counter() - t0:.1f} s")

        rng = np.random.default_rng(SEED)
        with phase("phase 2 (K1, syncmer_track and K3 checks)"):
            check_k1(torch, dsync, extract, sort, rng)
        with phase("phase 3"):
            k2_rows_checks = check_k2(torch, probe, rng)
        with phase("phase 9 (K3 and K4 checks)"):
            k4_merge = check_sorts(torch, sort, rng)
        with phase("phase 4"):
            flat = main_path(torch, os.path.join(work, "flat"), rng,
                             args.genomes, args.reads, "flat")
            bg.start("smer_wide", tsv=flat["tsv"], gdir=flat["gdir"])
        with phase("phase 4b (the long reads' routes)"):
            flat["long_routes"] = long_routes(
                torch, flat["index"],
                [q for _, q in flat["recs"][flat["n_reads"]:]], "flat")
        with phase("phases 5 and 10"):
            kernels = time_kernels(torch, flat)
            kernels += time_split(torch, flat)
        # ---- phase 14: the sharded engine on phase 4's flat cell
        t14 = time.perf_counter()
        with phase("phase 14a"):
            sharded = [sharded_search(
                os.path.join(work, "flat"), "flat 2x2", flat, 4,
                ["--mesh-reads", "2", "--mesh-bins", "2"],
                ("K1", flat_probe(flat, 2)), card)]
        with phase("phase 14d"):
            sharded.append(sharded_search(
                os.path.join(work, "flat"), "flat 1 rank", flat, 1, [],
                ("K1", flat_probe(flat, 1)), card))
        with phase("phase 14e"):
            dryrun_on_card(card)
        t14 = time.perf_counter() - t14
        with phase("phase 6"):
            k2_rows_checks += check_grouped(torch, probe, rng)
            check_run_sums(torch, probe, rng)
        with phase("phase 7"):
            hier = main_path(torch, os.path.join(work, "hier"), rng,
                             args.hier_genomes, args.hier_reads, "auto")
            g_hier = f"g{args.hier_genomes}"
            bg.start("hier_layouts", label=g_hier, tsv=hier["tsv"],
                     gdir=hier["gdir"])
            hier_report(torch, hier)
            check_wide_root(torch, os.path.join(work, "wide"))
        with phase("phase 7c (the long reads' routes)"):
            hier["long_routes"] = long_routes(
                torch, hier["index"],
                [q for _, q in hier["recs"][hier["n_reads"]:]], "auto")
        with phase("phase 8"):
            kernels += time_hier(torch, hier)

        # ---- phase 13: K5, minimisers and plain k-mers, both descents
        t13 = time.perf_counter()
        with phase("phase 13c"):
            k5_long = check_k5(torch, dsync, extract, rng)
        # 13a: phase 7's recipe on data of its own, under the bench
        # family's whole scheme (scaling 3)
        with phase("phase 13a"):
            mm_in = bg.result("minimizer")
            mm = nonsyncmer_path(torch, os.path.join(work, "minimizer"),
                                 "minimizer", mm_in, ("K5", "K2n"))
            mm_modes = minimizer_descents(
                torch, os.path.join(work, "minimizer"), mm,
                mm_in["walk_share"])
        with phase("phase 13d (K5, the keep, both descents)"):
            kernels.append(time_k5(torch, mm))
            narrow = next(r for r in kernels
                          if r["name"] == "probe_count_narrow")
            narrow.update(time_descents(torch, mm))
            narrow["minimizer_search"] = mm_modes
        # ---- phase 14 on phase 7's and phase 13a's hierarchies
        t0 = time.perf_counter()
        with phase("phase 14b"):
            sharded.append(sharded_search(
                os.path.join(work, "hier"), "hier 2x2", hier, 4,
                ["--mesh-reads", "2", "--mesh-bins", "2"], ("K1", "K2n"),
                card))
        with phase("phase 14c"):
            sharded.append(sharded_search(
                os.path.join(work, "minimizer"), "minimizer 1x2", mm, 2,
                ["--mesh-bins", "2"], ("K5", "K2n"), card))
        t14 += time.perf_counter() - t0
        log(f"phase 14: {t14:.1f} s")
        with phase("phase 19a (minimiser reads past L_CAP, 13a's index)"):
            tail19 = {"minimizer": long_nonsyncmer(
                torch, os.path.join(work, "minimizer"), "minimizer", mm,
                mm_in["gdir"])}
        shutil.rmtree(os.path.join(work, "minimizer"), ignore_errors=True)
        with phase("phase 13b"):
            kmer_in = bg.result("kmer")
            bg.start("smer_narrow", tsv=kmer_in["tsv"],
                     gdir=kmer_in["gdir"])
            kmer = nonsyncmer_path(torch, os.path.join(work, "kmer"), "kmer",
                                   kmer_in, ("K5", "K2"))
        with phase("phase 13d (K2 at 13b's shape)"):
            slab, rows = (next(r for r in kernels if r["name"] == n)
                          for n in ("probe_count", "probe_count_rows"))
            slab["kmer_thin"], rows["kmer_flat"] = time_k2_kmer(torch, kmer)
        # 13e: the same scheme on a flat layout of 13b's genomes
        with phase("phase 13e"):
            scaled = nonsyncmer_path(torch, os.path.join(work, "kmer"),
                                     "scaled", kmer_in, ("K5", "K2"))
        log(f"phase 13: {time.perf_counter() - t13:.1f} s")
        with phase("phase 19b (plain k-mer reads past L_CAP, 13b's index)"):
            tail19["kmer"] = long_nonsyncmer(
                torch, os.path.join(work, "kmer"), "kmer", kmer,
                kmer_in["gdir"])
        # ---- phase 20: syncmer schemes past the 32-bit s-mer, on phase
        # 4's and 13b's data
        with phase("phase 20a (K1's and syncmer_track's instances)"):
            k1_wide = check_wide_k1(torch, dsync, extract, rng)
        with phase("phase 20 (wide and narrow syncmer schemes)"):
            wide_runs, wide_rows = wide_path(
                torch, os.path.join(work, "smer"), flat, kmer_in,
                bg.result("smer_wide"), bg.result("smer_narrow"), k1_wide)
            kernels += wide_rows
        for d in ("flat", "kmer", "smer", "smer_wide", "smer_narrow"):
            shutil.rmtree(os.path.join(work, d), ignore_errors=True)
        # ---- phase 15: tables past 2^31 bytes, the at-scale demo
        with phase("phase 15a (tables past 2^31 bytes)"):
            big = check_big_tables(torch, probe)
        with phase("phase 15b (the at-scale demo)"):
            atscale = atscale_path(torch, os.path.join(work, "atscale"),
                                   args.atscale_reads, bg.result("atscale"))
        with phase("phase 18 (syncmer reads past L_CAP)"):
            tail = long_tail_path(torch, os.path.join(work, "long_tail"),
                                  os.path.join(work, "atscale"))
            union = time_union(torch, tail.pop("union_samples"))
            kernels.append(union["K6"])
        shutil.rmtree(os.path.join(work, "long_tail"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "atscale"), ignore_errors=True)
        # ---- phase 16: the layout cost model on the card, timed with
        # every background build done
        built = {job: bg.result(job)
                 for job in ("hier_layouts", "choice", "routes")}
        t16 = time.perf_counter()
        with phase("phase 16a"):
            check_routing(torch, probe)
        with phase("phase 16b"):
            fit = check_fit(torch)
        choice = {}
        with phase(f"phase 16c ({args.hier_genomes} genomes)"):
            # on phase 7's data, its index the cpu layout
            choice[args.hier_genomes] = layout_choice(
                torch, os.path.join(work, "g_hier"), g_hier,
                dict(hier, idx={**built["hier_layouts"]["idx"],
                                "cpu": hier["idx"]}))
        shutil.rmtree(os.path.join(work, "hier"), ignore_errors=True)
        with phase(f"phase 16c ({CHOICE_GENOMES} genomes)"):
            choice[CHOICE_GENOMES] = layout_choice(
                torch, os.path.join(work, "choice"), f"g{CHOICE_GENOMES}",
                built["choice"])
        with phase("phase 16d"):
            invariance_on_card()
        t16 = time.perf_counter() - t16
        log(f"phase 16: {t16:.1f} s; " + json.dumps({
            "fit": {n: {rt: [r["ms"], r["model_ms"]]
                        for rt, r in rec["routes"].items()}
                    for n, rec in fit["shapes"].items()},
            "choice": choice}))
        shutil.rmtree(os.path.join(work, "choice"), ignore_errors=True)
        # ---- phase 17: the routes no main path takes
        with phase("phase 17"):
            route_runs = routes_path(torch, os.path.join(work, "routes"),
                                     built["routes"])
    finally:
        bg.stop()
        shutil.rmtree(work, ignore_errors=True)
    runs = [flat["launches"], flat["split"], hier["launches"], hier["split"],
            mm["launches"], kmer["launches"], scaled["launches"],
            atscale["launches"], tail["launches"]]
    runs += [r["launches"] for r in tail19.values()]  # phase 19
    runs += [r["launches"] for r in route_runs.values()]  # phase 17
    runs += [r["launches"] for r in wide_runs.values()]  # phase 20
    runs.append(wide_runs["wide_hier"]["split"]["launches"])
    for row in kernels:  # launches on the main paths, both engines
        key = {"syncmer_extract": "K1", "probe_count": "K2 slab",
               "probe_count_rows": "K2 rows", "probe_count_narrow": "K2n",
               "syncmer_track": "track", "dedup": "K3",
               "sort_pairs": "K4", "minimizer_kmers": "K5",
               "unique_pairs": "K6", "syncmer_extract_s64": "K1 s64",
               "syncmer_track_s64": "track s64"}[row["name"]]
        row["launches"] = sum(run[key] for run in runs)
        row["launches_in"] = "main paths"
        # phase 14: summed over the ranks of its four sharded searches
        row["sharded_launches"] = sum(run["launches"].get(key, 0)
                                      for run in sharded)
        if key in ("K2n", "K2 rows"):  # phase 15a
            row["past_2_31_bytes"] = [
                {n: v for n, v in b.items()
                 if not n.startswith("K2") or n.startswith(key)}
                for b in big]
        if key == "K2n":
            row["modes"] = {m: sum(run[f"K2n {m}"] for run in runs)
                            for m in ("smem", "rows")}
            row["atscale_launches"] = {
                m: atscale["launches"][f"K2n {m}"] for m in ("smem", "rows")}
            row["peak_mib"] = {"hierarchical": hier["peak_mib"],
                               "hierarchical split": hier["split_peak_mib"],
                               "minimizer": mm["peak_mib"],
                               "minimizer descend-all":
                                   mm_modes["descend_all"]["peak_mib"]}
        if key == "K4":  # the long reads' union; at its widths (phase 18a)
            row["check_launches"] = flat["k4_check"]  # sort.dedup_pairs
            row["long_widths"] = union["K4"]
            row["merge_shapes"] = k4_merge  # phase 9's random keys
        if key == "K5":  # rows past one span (13c); phase 19's long reads
            row["long_rows"] = k5_long
            row["long_reads"] = {
                lab: {k: r[k] for k in ("reads", "past_l_cap", "wall_s",
                                        "peak_mib", "ultra_batch_peak_mib")}
                      | {"launches": r["launches"]["K5"]}
                for lab, r in tail19.items()}
        if key in ("K1", "track"):  # piece rows of reads past L_CAP (18a)
            row["piece_widths"] = union[key]
        if key in ("K1 s64", "track s64"):  # phase 20's searches
            row["searches"] = {
                lab: {x: r[x] for x in ("reads", "long_reads", "wall_s",
                                        "routes")}
                     | {"launches": r["launches"][key]}
                for lab, r in wide_runs.items()}
        if key == "K2 rows" and row["launches"] == 0:  # no table too tall
            row["launches_in"] = "not on a main path"
            row["check_launches"] = k2_rows_checks  # phases 3 and 6

    # ---- phases 11 and 12: the diagnostic kernels and the tooling path
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF

    dh = DeviceHIXF.from_hixf(flat["index"].hixf, "cuda")
    diag_counts(diag, zero=True)
    with phase("phase 11"):
        check_diag(torch, dh.table, dh.block_length,
                   np.random.default_rng(SEED + 11))
    checks = diag_counts(diag)
    check_routes = diag_routes(diag)
    del dh
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir=root)
    try:
        tools, tool_routes = tool_path(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 12: tooling path in {time.perf_counter() - t0:.1f} s")
    with phase("phase 12 (the diagnostic kernels timed)"):
        diag_rows = time_diag(torch, flat)
    for row in diag_rows:
        row.update(launches=tools[row["name"]], launches_in="tools",
                   tool_launches=tools[row["name"]],
                   check_launches=checks[row["name"]])
        if row["name"] in tool_routes:  # launches by route
            row.update(routes=tool_routes[row["name"]],
                       check_routes=check_routes[row["name"]])
        kernels.append(row)
    if any(r["launches"] <= 0 for r in kernels
           if r["launches_in"] != "not on a main path"):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
