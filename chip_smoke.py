#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py [--scale N] [--seed S] [--reps R]``

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``); exit non-zero when
   torch sees no CUDA device;
2. build every CUDA kernel of the port from the sources in the checkout;
3. engine phase: ``lubm_like(--scale)`` loaded, inferred and queried on
   the ``torch`` backend (``eval_mode="full"``) five times: ``infer1``
   and ``query1`` with raw resident columns (``compress=False``), the
   same two with the reference's default compressed tier
   (``compress=True``), and ``query1`` compressed with
   ``sort_mode="sketch"`` (the device sketch); each run's decoded-fact
   checksum, ``facts_inferred`` and every query's row set equal to the
   port's ``numpy`` backend on the same facts, and each compressed run's
   coded resident bytes below its raw ones; the sort kernels' launches
   counted by log2 of the padded length (``engine_sort_sizes``).
   ``Ops.unique_mask`` once at
   full width against ``NumpyOps.unique_mask``; the probe's launches by
   (log2 n, log2 m) and the unique mask's by log2 n over all of that
   (``engine_probe_sizes``).  Every kernel launched
   on that path; then one more raw and one more compressed ``infer1``
   run under ``torch.profiler`` for the device busy time;
   demand phase: ``infer1`` with ``eval_mode="demand"`` on the same
   facts, never inferred: ``LUBM_QUERIES`` and four point queries, each
   row set equal to the numpy engine's, no fallback to ``infer()``, the
   sort and probe kernels launched; serving phase: a ``FactServer`` over
   ``query1`` (``eval_mode="delta"``, compressed), 2 writer threads
   appending new students (each append re-infers) and 4 reader threads
   mixing batchable point queries across tenants with ``LUBM_QUERIES``,
   then a burst of 20 point reads released together with the writers
   idle, which must coalesce (more reads than device calls): qps,
   p50/p99 by mode and query, the batcher's coalescing, every batched
   read and the first, a middle and the last result of each other query
   equal to a numpy engine stepped through the write history to the
   result's token, the probe and merge-rank kernels launched; the same
   workload again under ``torch.profiler`` for the card's busy share;
   then ``python -m repro_torch.launch.serve`` (through ``runpy`` in a
   child that reports its kernel launches) under ``delta`` and
   ``demand`` (each must exit 0 and print its ``served ... qps`` line).
   Then the sharded phase (``shards=4``, each run's launches counted
   from its load to its last query): ``infer1`` full over the facts
   above with the frontier exchange's device transport over
   ``[cuda:0] * 4`` (every flush on the device; checksum,
   ``facts_inferred`` and row sets equal to numpy); ``query1``
   compressed with the sketch planner, ``eval_mode="delta"``, on the
   default transport (the host permute on one card, every flush saying
   so), one appended batch of new students and a second ``infer()``,
   against a numpy unsharded engine stepped the same way; ``infer1``
   demand with the four LUBM and four point queries, no fallback; each
   line with rounds, rows and bytes exchanged, the exchange's time, the
   critical path and load/infer/query seconds; the launcher at
   ``--shards 4``; ``DistributedClosure`` over ``[cuda:0] * 4`` on 64
   disjoint chains of 64 nodes against the closed form (129,024 pairs).
   Every run of this phase records its kernels' launches by size and
   its index-mirror merge shapes (``path_sizes``) for the kernel phase;
4. LM phase: ``yi-6b`` (32 layers, d=4096, GQA 32/4), ``mamba2-1.3b``
   (48 layers, d=2048, SSD), ``recurrentgemma-9b`` (38 layers: 12
   groups of two RG-LRU blocks and a local-attention block, then two
   RG-LRU blocks; d=4096, 16/1 heads at head dim 256, window 2048) and
   ``moonshot-v1-16b-a3b`` (48 MoE layers, d=2048, MHA 16/16 at head dim
   128, 64 experts of d_ff 1408 with top-6 routing, capacity factor
   1.25; 28.1 B parameters, held in the 16-bit store: the leaves the
   forward casts in bf16, 56.1 GB), ``whisper-tiny`` (4 encoder and 4
   decoder layers, d=384, 6/6 heads at head dim 64, vocab 51,865) and
   ``phi-3-vision-4.2b`` (32 layers, d=3072, 32/32 heads at head dim 96,
   576 patch embeddings in front of the text) at full width and depth
   with random weights from ``--seed`` (the SSM and RG-LRU conv taps
   drawn as upstream's; whisper's frames and phi-3-vision's patches
   drawn with numpy at the reference test's 0.02 scale), each served
   greedily: B = 2 prompts of S random tokens (2048; 4096 for
   recurrentgemma, past its window; 1472 behind phi-3-vision's 576
   patches; for whisper B = 16 clips of 1500 encoder frames and 432
   tokens, so the 16 steps end at its 448-token context) through
   ``prefill_fn`` (``max_len`` = patches + S + 16), then 16
   ``decode_fn`` steps.
   The first decode step's logits must match the sequence form over the
   prompt plus that token (``hidden()``; for whisper ``encode`` feeding
   ``_decoder_hidden``) within ``3e-2 * max(1, scale)``, as the
   reference's decode test (``1e-3 * max(1, scale)`` with the same weights in
   float32; for moonshot, where either forward of a pair dropped MoE
   pairs over capacity, both pairs again at capacity factor E / k,
   where none can drop, and those are gated), the peak device memory
   must stay under 80 GB, and the two forwards must have launched
   ``flash_attention`` (yi and moonshot at head dim 128, recurrentgemma
   at 256, whisper at 64 and phi-3-vision at 96, every launch on the
   tensor-core ``wgmma`` route) or
   ``ssd_intra`` (mamba2) once per attention or SSD layer each (for
   whisper once per encoder layer and once per decoder layer's cross-
   attention; its decoder's self-attention is short enough to
   materialize), and recurrentgemma's forwards ``linear_scan`` once per
   RG-LRU layer each (26); moonshot's line adds the pairs each forward
   dropped.  Then a profiled prefill (device busy share, attention's
   device time and share, and for recurrentgemma the scan kernel's
   device time, one layer's RG-LRU scan timed apart beside the plain
   passes, and its share of the prefill) and a profiled 4-step decode
   window;
5. training phase (``TRAIN_MODELS``), one config at a time after the LM
   phase, the card freed between them: at the configs' own widths and
   with random float32-store weights from ``--seed`` (conv taps as
   upstream's), depth cut only where the AdamW state (16 bytes a
   parameter) would not fit: ``yi-6b`` at 4 of 32 layers,
   ``mamba2-1.3b`` whole, ``moonshot-v1-16b-a3b`` at 2 of 48,
   ``recurrentgemma-9b`` at one group (RG-LRU, RG-LRU, local attention;
   4096 tokens, past its window), ``whisper-tiny`` whole (B = 4, 1500
   frames, 448 tokens padded to 512 with ignored labels) and
   ``phi-3-vision-4.2b`` at 2 of 32 (576 patches + 1472 tokens); B = 2
   sequences of 2048 tokens unless named.  Each LM kernel's wrapper,
   handed a CUDA tensor that requires grad, must raise and launch
   nothing.  Per config: the loss's central difference along a seeded
   random direction against autograd's directional derivative, in
   float32 with TF32 off (``GRAD_EPS``, relative error under
   ``GRAD_TOL``; the loss's per-token terms summed in float64 on either
   side, MoE routing pinned to the base forward's experts);
   for yi-6b one step at ``accum=2`` against ``accum=1`` in float32 (the
   loss within 1e-3, the two updates within 2e-3 of the update's norm);
   8 AdamW steps (``TRAIN_OPT``) on one fixed batch in the config's
   compute type, whose loss and gradient norm must be finite, the norm
   positive and the last loss below the first; peak device memory
   under 80 GB; no kernel launched over the config's whole run.  One
   ``{"phase": "train"}`` line each with the losses, step times (median),
   tokens per second and peak GB;
6. kernel phase: each kernel at the main path's shapes on the card (the
   index-mirror merge's ranks at the largest shape the fact path gave
   them, the LM kernels at the prefill shapes of the LM phase),
   compared with its plain PyTorch version (bit-exact for the integer
   kernels, within a stated tolerance for the float ones; attention on
   both of its routes), timed with
   CUDA events (median of ``--reps`` runs, L2 flushed before each)
   beside the plain version, one PyTorch library call as a yardstick
   where one exists, and the bound; both sorts also at 2^13, 2^16, 2^18
   and their table shapes beside ``torch.sort``, with the device kernels
   one call launches and their split into the first tile launch, the
   fused cross-tile launches and the later tile launches
   (``torch.profiler``); the probe at m = 2^10 .. 2^21 right keys (n =
   m / 2) and at the engine's shapes beside two ``torch.searchsorted``
   calls, the unique mask at 2^13 .. 2^21 keys beside ``torch.ne``, and
   the merge ranks at every merge shape the fact path gave them, each
   launch apart beside one ``torch.searchsorted`` call (``rank_size``
   rows), each checked bit for bit; the sorts, the probe and the unique
   mask bit-checked at both ends of every size bucket the fact path
   launched them at (``path_shape_checks``); ``ssd_intra``'s gram pass
   timed apart (``gram_ms``); attention also at moonshot-v1-16b-a3b's
   prefill (16/16 heads, hd 128, beside SDPA) and at recurrentgemma-9b's
   prefill (head dim 256, 16/1 heads, window 2048, bf16 and fp16 on the
   tensor-core route; the same in float32 and a ragged head-dim-192
   case on the CUDA-core one), beside SDPA with the band as an explicit
   mask (its backend named); non-causal at whisper-tiny's encoder (16 ×
   1500 frames, 6/6 heads, hd 64) and cross-attention (432 rows onto
   1500 frames), bf16 on the tensor-core route's hd-64 kernel (the
   encoder's shape also in float32 on the CUDA-core route, and on the
   hd-64 kernel causal, windowed and in fp16, with a ragged 77 -> 300
   case), and causal at phi-3-vision-4.2b's
   prefill (2 × 2048 positions, 32/32 heads, hd 96) on the tensor-core
   route's hd-96 tiles, bf16 and fp16 (and a ragged non-causal case at
   its head layout in bf16 on that route, in float32 on the CUDA-core
   one), each beside SDPA; the RG-LRU scan at recurrentgemma-9b's prefill
   shape ([2, 4096, 4096] float32, decays from U(0.9, 1)), without and
   with ``h0``, against the plain passes and against the recurrence
   stepped in float64 over 64 sampled channels, both within ``SCAN_TOL``
   of the scale;
7. trainer phase (``trainer_phase``), after the kernel phase: the fact
   engine's closure as training data, the trainer's checkpoints, crash and
   resume, and the training launcher.  ``FactCorpusSource`` with its own
   engine (``infer1`` on the ``torch`` backend) over ``synth_kg(--seed)``
   at the default size (200 entities, 600 edges), then over a
   ``corpus_engine`` at 400 entities and 1,200 edges (``CORPUS_SIZES``):
   each build's decoded ``linksTo`` pairs equal the closed-form
   transitive closure of the edge list (numpy boolean matrix products),
   and at the default size ``facts_inferred`` equals the port's numpy
   engine's, the triples equal numpy's as a multiset, and a second build
   on the card gives the same triple order and the same batches at steps
   0, 1 and 7; the builds must launch ``bitonic_sort``,
   ``bitonic_sort_kv`` and ``probe_sorted``.  Then ``Trainer`` at full
   width (``TRAINER_MODEL``: ``mamba2-1.3b``, d=2048, vocab 50,280, 8 of
   its 48 layers, 2 × 2048 tokens; 310M parameters, 3.7 GB a checkpoint)
   fed by the default-size corpus through ``ShardedLoader``, 16 steps:
   (U) uninterrupted without checkpoints; (C) with ``save_async`` every 5
   steps and a loader that raises once at step 12, which must raise with
   step 10 committed; (R) a fresh ``Trainer`` on the same directory,
   which must restore step 10 (every leaf bit-equal to the npz, on the
   card, with its dtype), run steps 10-15 and save step 16.  The losses
   of (C) and (R) must equal (U)'s at the same steps (exactly, unless a
   second (U) run shows (U) does not repeat; then within that spread),
   all finite, the last below the first; the free disk is checked before
   the first save.  Then ``python -m repro_torch.launch.train --arch
   yi-6b --smoke --data facts`` in a child (``runpy``, reporting its
   kernel launches): 20 steps, whose final loss must fall, then 30 steps
   on the same directory, which must restore step 20 and run 10.  The
   phase's lines carry build and infer seconds, closure rows, launches by
   kernel, the step time and tokens per second, ``save_async``'s blocking
   time, write and restore seconds, bytes on disk and peak GB; the
   checkpoint directories are deleted at the end.  Then the sorts, the
   probe and the unique mask are bit-checked at both ends of every size
   bucket this phase's runs launched them at (``path_shape_checks``),
   and the merge ranks at its merge shapes, if any;
8. sharding phase (``sharding_phase``), last, so the kernel phase's sort
   profiles run as before it: the LM's mesh forms on a 2x4 data x model
   mesh over ``[cuda:0] * 8`` (``launch.mesh.make_host_mesh``), float32
   with TF32 off unless named, at full width.  (1) ``yi-6b`` at 4 of 32
   layers, B 2 x 2048: 3 FSDP+TP steps (params and AdamW moments laid
   out by ``shardings_for``, the batch by ``batch_shardings``) against
   the single-device ``build_train_step`` on the same weights and batch
   (lr 1e-3): the first step's gradients within 1e-4 of each leaf's
   scale, every step's loss and the loss after the third update within
   2e-3 of the single device's, the first step's params within atol
   3e-3, the losses finite and the loss after the third update below
   the first; the layout's bytes of params and moments per mesh
   device and per card, the step times beside the single-device step's,
   peak GB; over the first sharded gradients every block's residual
   holds ``split_range(2048, 4, j)`` rows on model index ``j``
   (``seq_rows``, ``MeshSpy``: the sequence-parallel layout) and no
   whole read of a leaf split over ``model`` (``model_split_gathers``
   0: the loss is vocab-parallel).  (2) ``yi-6b`` whole in the 16-bit
   store: the sharded
   prefill (B 2 x 2048, the KV cache split over ``model``, 2053 rows
   padded to 2056) and 4 decode
   steps against the single-device run, logits within ``3e-2 * max(1,
   scale)``; ``flash_attention`` must launch once per head shard per
   layer (8 x 32) on the sharded prefill, counted from 0; its blocks'
   ``seq_rows`` as in (1).  (3)
   ``moonshot-v1-16b-a3b`` at 2 of 48 layers, 64 experts (16 a shard),
   capacity factor E/k: the expert-parallel layer against the
   single-device ``apply_moe`` on one B 2 x 2048 input (``1e-3 *
   max(1, scale)``, aux within 1e-5) and the 2-layer model's sharded
   prefill against the single-device one (the same bound), no pair
   dropped.  (4) ``pipeline_apply`` over ``yi-6b``'s ``apply_block``, 8
   layers, 4 stages and 4 microbatches on ``[cuda:0] * 4``, B 4 x 2048,
   against the sequential loop (``1e-5 * max(1, scale)``).  (5)
   ``build_dp_compressed_step`` on ``yi-6b`` at 2 of 32 layers over
   data 4, B 8 x 512, against the exact step: the loss within 1e-3, the
   params' largest relative drift under 0.35, peak under 80 GB, and
   the residuals the step kept mark each replica's own gradient as sent
   in int8 (``int8_check``: off its grid by at most 1e-2 of a step, the
   residual at most half a step, the reduced gradient within one step
   of the exact mean); the int8 bytes a replica sends beside float32's.  (6) ``python -m
   repro_torch.launch.train --arch yi-6b --smoke --mesh 2x4 --devices
   cuda:0`` in a child: 20 steps whose loss falls, then 30 on the same
   checkpoint directory, which must restore step 20 and run 10; without
   ``--devices`` it must fail naming the flag (one card).  (7) the
   mixers (``shard_mixers``): ``mamba2-1.3b`` (SSD by head shard),
   ``recurrentgemma-9b`` (RG-LRU by channel shard, local attention by
   head shard) and ``whisper-tiny`` (attention by head shard; its 6 heads
   whole on a row's first device on 2x4, 3 a device on a 4x2 mesh) at
   full width and depth in the 16-bit store, over the LM phase's prompts
   (B 2 x 2048, B 2 x 4096, 16 x 432 behind 1500 frames): the sharded
   prefill and 4 decode steps against the single device, fed its greedy
   tokens, in bf16 and in float32 on the same weights: the float32
   logits within ``3e-2 * max(1, scale)``, the bf16 ones no farther
   from the single float32 logits than ``MIXER_BF16_RATIO`` times the
   single bf16 ones; the bf16 prefill's launches equal to
   ``mixer_launches`` (384 ``ssd_intra``, 208 ``linear_scan`` and 96
   ``flash_attention``, whisper 16 and 64), counted from 0; the bf16
   prefill's ``seq_rows``: mamba2's and whisper's blocks their
   ``split_range`` shares of 2048, 1500 (the encoder) and 432 rows,
   recurrentgemma's (not sequence-parallel) the whole 4096; no whole
   read (``ShardedTensor.gather``) of a leaf split over ``model``; the
   cache's specs, the layout's bytes, the times beside the single
   device's, peak under 80 GB; each kernel timed at its shard's shape
   against its plain version (``mixer_kernel_ms``); then one FSDP+TP
   step of ``mamba2-1.3b`` at 8 of 48 layers (B 2 x 2048) and of
   ``recurrentgemma-9b`` at one group (B 2 x 2048) at the yi step's
   gates, no kernel launched;
9. dry-run phase (``dryrun_phase``), after the sharding phase: (a)
   starts in CPU children before the sharding phase, whose card work
   their tracing overlaps, and is read after (b) has run on the card.  (b) The
   dry run held against the card: ``yi-6b`` whole in the 16-bit store,
   the LM phase's B 2 x 2048 prefill (``max_len`` 2064), traced on
   ``meta:0`` (``launch.dryrun.trace_cell``: shape-only tensors, a
   ``launch.hlo_analysis.Recorder``), then run on ``cuda:0`` under the
   same recorder: the ops by aten name and the products identical, no
   op off the device, the kernel records equal to the ``kernels.LAUNCHES``
   deltas, the argument bytes equal to the bytes the card holds for the
   weights and tokens, the predicted new allocations within
   ``DRYRUN_PEAK_BAND`` of ``torch.cuda.max_memory_allocated``'s
   increment, and the measured prefill (CUDA events, median of 3 warm
   runs) at or above the roofline bound ``max(compute_s, memory_s)``
   with the ratio printed.  (a) ``python -m repro_torch.launch.dryrun``
   on the production 16x16 mesh of fake devices for ``DRYRUN_CELLS``
   (yi-6b prefill_32k and decode_32k, mamba2-1.3b long_500k and the
   closure cell), all at once in children that touch no card, one line
   each with the record's memory, roofline, bottleneck and collectives
   by kind; the yi-6b prefill must show a reduce-scatter (its
   sequence-parallel residual) and a peak no higher than
   ``DRYRUN_SP_PEAK``, and the decode and long cells their
   ``DRYRUN_UNMOVED`` figures; a timed ``dryrun_all`` line;
10. a ``{"kernels": [...]}`` line with every ported kernel's numbers
   (the fact kernels' launches counted over the engine, demand, serving,
   launcher, sharded and trainer phases; ``queued`` lists the kernels
   still to port: none); attention's row
   times the ``wgmma`` route beside the CUDA-core kernel on the same
   inputs (``simt_ms``) and counts yi's launches by route; its
   ``flash_attention@mha`` row (moonshot's shape) counts moonshot's; its
   ``flash_attention@hd256`` row (the same wrapper at head dim 256)
   counts recurrentgemma's launches by route and carries ``simt_ms``
   and ``sdpa_ms``; ``flash_attention@encdec`` counts whisper's and
   carries its cross-attention row (``cross``), ``flash_attention@hd96``
   phi-3-vision's, each with ``sdpa_ms`` and ``simt_ms``;
   the merge ranks' row times its two launches apart (``left_ms``,
   ``right_ms``); ``ssd_intra``'s row carries its gram pass
   (``gram_ms``) and the bound at the float32 rate without tensor cores
   (``bound_old_ms``) beside the TF32 one; attention's row adds the
   sharding phase's launches on yi's head shards, and the SSD, scan,
   hd-256 and enc-dec rows the mixers step's; ``linear_scan``'s row
   (not a Pallas kernel: XLA's associative scan in the reference) its
   time from ``h0`` (``h0_ms``) and the float64 check;
11. the last line: ``{"ok": true, "device": {...}}``.

Float32 products run in full float32 (``allow_tf32`` off for matmuls
and cuDNN) wherever a kernel is compared with its plain version.

Nothing of JAX and nothing of the reference ``repro`` package is
imported.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 SXM non-tensor-core float32 peak, the
#                             table's only rate for scalar (non-matrix) ops
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core peak


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after a warm-up, with the L2 cache flushed before each run.  A spin
    kernel (~0.5 ms) keeps the card busy while the host enqueues the
    events and ``fn``'s launches, so a short kernel's time is its device
    time, not the wrapper's host overhead."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int,
             ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, pairs) -> int:
    """Largest |kernel - plain| over all outputs (int64 exact)."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if not torch.equal(a, b):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, int(d), 1)
    return err


# the device kernels of csrc/bitonic_sort.cu (tile launches, then the two
# kinds of cross-tile launch), and those of the engine's other kernels
SORT_KERNELS = ("tile_network", "cross_fused", "cross_smem")
OUR_KERNELS = (*SORT_KERNELS, "probe_splitters", "probe_gather",
               "rank_splitters", "rank_gather", "unique_mask_vec")


def is_sort_kernel(name: str) -> bool:
    return any(k in name for k in SORT_KERNELS)


def sort_split(torch, fn, n: int, elem_bytes: int, expected: int) -> dict:
    """One sort call's device kernels, from ``torch.profiler`` (as
    ``lm_profile`` counts them), L2 flushed first, in three groups: the
    first tile launch, every cross-tile launch (``cross_fused`` and
    ``cross_smem``) and the later tile launches, each with its launches,
    device ms and bound (each launch reads and writes the ``n``-element
    array once); ``other`` is the wrapper's pad copy and fill.  The tracer
    can miss the first launches after it starts, even behind a spin kernel
    and a pause (seen after earlier profiles in one process), so three
    calls run and the last is counted; a profile whose counted call shows
    fewer sort kernels than the ``expected`` launches (none at all seen
    once in a whole run; 8 of 15 over all three calls seen once behind a
    million unprofiled launches; 13 of 15 in three profiles running,
    seen once) is taken again, up to six profiles (``profiles``).
    The caller gates the count of the last one taken."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for profiles in range(1, 7):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            time.sleep(0.2)
            for _ in range(3):
                flush.bitwise_not_()  # L2 flushed before each call
                fn()
            torch.cuda.synchronize()
        calls = [(e.name, e.time_range.elapsed_us() / 1e3) for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and not any(w in e.name for w in ("spin", "bitwise_not"))),
            key=lambda e: e.time_range.start)]
        last = 0
        for i in range(1, len(calls)):
            if is_sort_kernel(calls[i - 1][0]) and not is_sort_kernel(
                    calls[i][0]):
                last = i  # a wrapper's pad copy after a sort kernel: a call
        calls = calls[last:]
        sort = [(k, ms) for k, ms in calls if is_sort_kernel(k)]
        if len(sort) >= expected:
            break
    if not sort:
        fail("sort_split: the profiler saw no sort kernel in six profiles")
    other = [ms for k, ms in calls if not is_sort_kernel(k)]
    tile = SORT_KERNELS[0]
    groups = {"first_tile": sort[:1],
              "cross": [c for c in sort[1:] if tile not in c[0]],
              "later_tiles": [c for c in sort[1:] if tile in c[0]]}
    per_launch = bound_ms(2 * n * elem_bytes, 0)[0]
    out = {g: {"launches": len(c), "ms": sum(ms for _, ms in c),
               "bound_ms": len(c) * per_launch}
           for g, c in groups.items()}
    out["other"] = {"launches": len(other), "ms": sum(other)}
    out["sort_kernels"] = len(sort)
    out["device_kernels"] = len(calls)
    out["profiles"] = profiles
    out["kernel_names"] = sorted({m.group(0) for k, _ in sort for m in [
        re.search(rf"({'|'.join(SORT_KERNELS)})<[^>]*>", k)] if m})
    return out


def sort_detail(torch, rng, reps: int, sizes=(13, 16, 18)) -> list:
    """Both sort kernels at 2^s for each of ``sizes`` (by default 2^13,
    2^16 and 2^18, the engine's most frequent large sort) and at the table
    shapes: bit checks against the plain versions, kernel ms beside
    ``torch.sort`` ms, and at the table shapes the device kernels one call
    launches, their split into first tile, cross-tile and later tile
    launches, and a check that the sort kernels counted are
    ``launch_plan``'s."""
    import numpy as np

    from repro_torch.kernels.sortmerge.ops import tag_bits_for
    from repro_torch.kernels.sortmerge.sortmerge import (
        bitonic_sort, bitonic_sort_kv, bitonic_sort_kv_plain,
        bitonic_sort_plain, launch_plan, sort_tier)

    rows = []
    for name, lg_top in (("bitonic_sort", 21), ("bitonic_sort_kv", 20)):
        for lg in sorted({*sizes, lg_top}):
            n = 1 << lg
            if name == "bitonic_sort":  # tagged keys, as the index builds
                tb = tag_bits_for(n)
                raw = rng.randint(0, 1 << 30, n).astype(np.int64)
                x = torch.tensor((raw << tb) | np.arange(n, dtype=np.int64),
                                 device="cuda")
                err = max_abs_err(torch, [(bitonic_sort(x),
                                           bitonic_sort_plain(x))])
                call, lib, eb = (lambda: bitonic_sort(x),
                                 lambda: torch.sort(x), 8)
            else:  # keys with many ties, an int32 payload
                k = torch.tensor(rng.randint(0, 1 << 16, n).astype(np.int64),
                                 device="cuda")
                v = torch.arange(n, dtype=torch.int32, device="cuda")
                (gk, gv), (wk, wv) = (bitonic_sort_kv(k, v),
                                      bitonic_sort_kv_plain(k, v))
                err = max_abs_err(torch, [(gk, wk), (gv, wv)])
                call, lib, eb = (lambda: bitonic_sort_kv(k, v),
                                 lambda: torch.sort(k), 12)
            kv = name == "bitonic_sort_kv"
            row = {"sort_size": name, "n": n,
                   "tile": sort_tier(n, kv)[0], "max_abs_err": err,
                   "kernel_ms": time_ms(torch, call, reps),
                   "library_ms": time_ms(torch, lib, reps),
                   "bound_ms": bound_ms(2 * eb * n, 0)[0],
                   "plan_launches": len(launch_plan(n, kv=kv))}
            if lg == lg_top:
                row["split"] = sort_split(torch, call, n, eb,
                                          row["plan_launches"])
            print(json.dumps(row), flush=True)
            if err:
                fail(f"{name} at n={n}: kernel and plain version differ")
            if lg == lg_top and (
                    row["split"]["sort_kernels"] != row["plan_launches"]):
                fail(f"{name} at n={n}: {row['split']['sort_kernels']} "
                     f"sort kernels, launch_plan says "
                     f"{row['plan_launches']}")
            rows.append(row)
    return rows


# (log2 n, log2 m) of the probe's by-size rows: n = m / 2 from 2^10 to
# 2^21 right keys, then the engine's most frequent shape (32 left keys
# against 2^21) and its largest (engine_probe_sizes at scale 500); log2
# of the unique mask's
PROBE_SIZES = ((9, 10), (12, 13), (15, 16), (17, 18), (20, 21), (5, 21),
               (15, 21), (18, 19))
UNIQUE_SIZES = (13, 16, 18, 21)


def search_detail(torch, rng, reps: int, probe_sizes=PROBE_SIZES,
                  unique_sizes=UNIQUE_SIZES) -> list:
    """``probe_sorted`` at n = 2^a left keys against m = 2^b sorted right
    keys for each (a, b) of ``probe_sizes`` (keys drawn from [0, 2m), as
    the kernel phase's), and ``unique_mask_sorted`` at 2^s sorted keys
    with about eight rows per value for each of ``unique_sizes``: bit
    checks against the plain versions (the mask also on the view
    ``x[1:]``, 8 bytes past a 16-byte boundary), kernel ms beside the
    library call's ms, and the bound."""
    import numpy as np

    from repro_torch.kernels.mergejoin.mergejoin import (probe_plan,
                                                         probe_sorted,
                                                         probe_sorted_plain)
    from repro_torch.kernels.uniquefilter.uniquefilter import (
        unique_mask_sorted, unique_mask_sorted_plain)

    rows = []
    for lg_n, lg_m in probe_sizes:
        n, m = 1 << lg_n, 1 << lg_m
        r = torch.tensor(np.sort(rng.randint(0, 2 * m, m)).astype(np.int64),
                         device="cuda")
        lk = torch.tensor(rng.randint(0, 2 * m, n).astype(np.int64),
                          device="cuda")
        s, table = probe_plan(m)
        rows.append({
            "search_size": "probe_sorted", "n": n, "m": m, "s": s,
            "table": table,
            "max_abs_err": max_abs_err(torch, zip(probe_sorted(lk, r),
                                                  probe_sorted_plain(lk, r))),
            "kernel_ms": time_ms(torch, lambda: probe_sorted(lk, r), reps),
            "library_ms": time_ms(
                torch, lambda: (torch.searchsorted(r, lk),
                                torch.searchsorted(r, lk, right=True)), reps),
            "bound_ms": bound_ms(8 * n + 8 * m + 8 * n, 0)[0]})
        print(json.dumps(rows[-1]), flush=True)
    for lg in unique_sizes:
        n = 1 << lg
        x = torch.tensor(np.sort(rng.randint(0, n // 8, n + 1)).astype(
            np.int64), device="cuda")
        xa, xu = x[:n], x[1:]  # 16-byte aligned, and 8 bytes past it
        rows.append({
            "search_size": "unique_mask_sorted", "n": n,
            "max_abs_err": max_abs_err(torch, [
                (unique_mask_sorted(v), unique_mask_sorted_plain(v))
                for v in (xa, xu)]),
            "kernel_ms": time_ms(torch, lambda: unique_mask_sorted(xa), reps),
            "unaligned_ms": time_ms(torch, lambda: unique_mask_sorted(xu),
                                    reps),
            "library_ms": time_ms(torch, lambda: torch.ne(xa[1:], xa[:-1]),
                                  reps),
            "bound_ms": bound_ms(9 * n, n)[0]})
        print(json.dumps(rows[-1]), flush=True)
    for row in rows:
        if row["max_abs_err"]:
            fail(f"{row['search_size']} at n={row['n']}: kernel and plain "
                 "version differ")
    return rows


def rank_detail(torch, rng, reps: int, shapes) -> list:
    """``merge_ranks`` at each (run lanes, delta lanes) of ``shapes`` (the
    index-mirror merges the engine phase ran): both runs sorted, as the
    merge gives them, each launch timed apart (the run ranked into the
    delta, side left; the delta into the run, side right) beside one
    ``torch.searchsorted`` call each, with the tree the plan takes and
    the bound; at the largest shape also the run's keys in random order
    (``x_order``), which the kernel must take as well.  Bit checks against
    the plain version."""
    import numpy as np

    from repro_torch.kernels.mergejoin.mergejoin import merge_ranks_plan
    from repro_torch.kernels.sortmerge.sortmerge import (merge_ranks,
                                                         merge_ranks_plain)

    rows = []
    cases = [(cap, dcap, "sorted") for cap, dcap in shapes]
    cases.append((*max(shapes), "random"))
    for cap, dcap, order in cases:
        base, drun = (torch.tensor(np.sort(rng.randint(
            0, 1 << 52, k, dtype=np.int64)), device="cuda")
            for k in (cap, dcap))
        # random: the run's keys shuffled where they are the searched keys
        xs = (base[torch.randperm(cap, device="cuda")] if order == "random"
              else base)
        row = {"rank_size": "merge_ranks", "run": cap, "delta": dcap,
               "x_order": order}
        for side, x, other in (("left", xs, drun), ("right", drun, base)):
            right = side == "right"
            s, table = merge_ranks_plan(x.shape[0], other.shape[0])
            row[side] = {
                "n": x.shape[0], "m": other.shape[0], "s": s,
                "table": table,
                "max_abs_err": max_abs_err(torch, [(
                    merge_ranks(x, other, right),
                    merge_ranks_plain(x, other, right))]),
                "kernel_ms": time_ms(
                    torch, lambda: merge_ranks(x, other, right), reps),
                "library_ms": time_ms(
                    torch, lambda: torch.searchsorted(other, x, right=right),
                    reps),
                "bound_ms": bound_ms(12 * x.shape[0] + 8 * other.shape[0],
                                     0)[0]}
        row["kernel_ms"] = row["left"]["kernel_ms"] + row["right"]["kernel_ms"]
        row["library_ms"] = (row["left"]["library_ms"]
                             + row["right"]["library_ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    for row in rows:
        if row["left"]["max_abs_err"] or row["right"]["max_abs_err"]:
            fail(f"merge_ranks at ({row['run']}, {row['delta']}, "
                 f"{row['x_order']}): kernel and plain version differ")
    return rows


def path_shape_checks(torch, rng, sizes: dict) -> dict:
    """The sorts, the probe and the unique mask at every size the fact
    path launched them at (``sizes``: the engine, demand, serving,
    launcher and sharded phases, or the trainer phase's runs), each call
    bit for bit against its plain version.  A
    size is counted by bucket, 2^(k-1) < n <= 2^k, so both ends of each
    bucket are checked; the probe also in the padded form of a batched
    lookup (a real prefix of each side, ``INT64_MAX`` pads after it), and
    ``bitonic_sort`` in int64 and int32.  Keys carry ties.  The merge
    ranks are ``rank_detail``'s: it takes each of their exact shapes."""
    import numpy as np

    from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                         probe_sorted_plain)
    from repro_torch.kernels.sortmerge.sortmerge import (
        bitonic_sort, bitonic_sort_kv, bitonic_sort_kv_plain,
        bitonic_sort_plain)
    from repro_torch.kernels.uniquefilter.uniquefilter import (
        unique_mask_sorted, unique_mask_sorted_plain)

    big = np.iinfo(np.int64).max
    out = {}

    def ends(k: int) -> list:
        return sorted({1 << k, (1 << (k - 1)) + 1 if k else 1})

    def dev(a, dtype=torch.int64):
        return torch.tensor(a, device="cuda").to(dtype)

    def check(name, shape, pairs):
        err = max_abs_err(torch, pairs)
        row = out.setdefault(name, {"calls": 0, "max_abs_err": 0,
                                    "sizes": set(), "differ": []})
        row["calls"] += 1
        row["sizes"].add(tuple(d for d in shape if isinstance(d, int)))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if err:
            row["differ"].append(shape)

    for lg in sizes["sort_sizes"]["bitonic_sort"]:
        for n in ends(int(lg)):
            for dt in (torch.int64, torch.int32):
                x = dev(rng.randint(0, max(2, n // 4), n), dt)
                check("bitonic_sort", [n, str(dt)],
                      [(bitonic_sort(x), bitonic_sort_plain(x))])
    for lg in sizes["sort_sizes"]["bitonic_sort_kv"]:
        for n in ends(int(lg)):
            k = dev(rng.randint(0, max(2, n // 4), n))
            v = torch.arange(n, dtype=torch.int32, device="cuda")
            (gk, gv), (wk, wv) = (bitonic_sort_kv(k, v),
                                  bitonic_sort_kv_plain(k, v))
            check("bitonic_sort_kv", [n], [(gk, wk), (gv, wv)])
    runs = {}  # sorted right runs by length, from [0, 2m)
    for key in sizes["search_sizes"]["probe_sorted"]:
        a, b = map(int, key.split(","))
        for m in ends(b):
            if m not in runs:
                runs[m] = np.sort(rng.randint(0, 2 * m, m)).astype(np.int64)
            r = dev(runs[m])
            for n in ends(a):
                lk = dev(rng.randint(0, 2 * m, n))
                check("probe_sorted", [n, m],
                      zip(probe_sorted(lk, r), probe_sorted_plain(lk, r)))
        n, m = 1 << a, 1 << b  # padded as Ops.batch_probe pads
        rp, lp = np.full(m, big), np.full(n, big)
        rp[:m // 2 + 1] = runs[(1 << (b - 1)) + 1 if b else 1][:m // 2 + 1]
        lp[:n // 2 + 1] = rng.randint(0, 2 * m, n // 2 + 1)
        rp, lp = dev(rp), dev(lp)
        check("probe_sorted", [n, m, "padded"],
              zip(probe_sorted(lp, rp), probe_sorted_plain(lp, rp)))
    for key in sizes["search_sizes"]["unique_mask_sorted"]:
        for n in ends(int(key)):
            x = dev(np.sort(rng.randint(0, max(2, n // 8), n)))
            check("unique_mask_sorted", [n],
                  [(unique_mask_sorted(x), unique_mask_sorted_plain(x))])
    for row in out.values():
        row["sizes"] = sorted(row["sizes"])
    print(json.dumps({"path_shape_checks": out}), flush=True)
    for name, row in out.items():
        if row["differ"]:
            fail(f"{name}: kernel and plain version differ at the path's "
                 f"sizes {row['differ'][:4]}")
    return out


def kernel_phase(torch, seed: int, reps: int, merge_shapes,
                 sizes: dict) -> dict:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                         probe_sorted_plain)
    from repro_torch.kernels.sortmerge.ops import tag_bits_for
    from repro_torch.kernels.sortmerge.sortmerge import (
        bitonic_sort, bitonic_sort_kv, bitonic_sort_kv_plain,
        bitonic_sort_plain, merge_ranks, merge_ranks_plain)
    from repro_torch.kernels.uniquefilter.uniquefilter import (
        unique_mask_sorted, unique_mask_sorted_plain)

    rng = np.random.RandomState(seed)
    dev = "cuda"
    out = {}

    # bitonic_sort: 2^21 tagged int64 keys, the index-build form
    n = 1 << 21
    tb = tag_bits_for(n)
    raw = rng.randint(0, 1 << 30, n).astype(np.int64)
    x = torch.tensor((raw << tb) | np.arange(n, dtype=np.int64), device=dev)
    got = bitonic_sort(x)
    want = bitonic_sort_plain(x)
    torch.cuda.synchronize()
    lg = int(np.log2(n))
    out["bitonic_sort"] = {
        "shape": [n], "dtype": "int64",
        "max_abs_err": max_abs_err(torch, [(got, want)]),
        "kernel_ms": time_ms(torch, lambda: bitonic_sort(x), reps),
        "plain_ms": time_ms(torch, lambda: bitonic_sort_plain(x), reps),
        "library_ms": time_ms(torch, lambda: torch.sort(x), reps),
        "library_call": "torch.sort",
        "bound": bound_ms(2 * 8 * n, n * lg)}

    # bitonic_sort_kv: 2^20 int64 keys (many ties) carrying int32 values
    n = 1 << 20
    k = torch.tensor(rng.randint(0, 1 << 16, n).astype(np.int64), device=dev)
    v = torch.arange(n, dtype=torch.int32, device=dev)
    gk, gv = bitonic_sort_kv(k, v)
    wk, wv = bitonic_sort_kv_plain(k, v)
    torch.cuda.synchronize()
    lg = int(np.log2(n))
    out["bitonic_sort_kv"] = {
        "shape": [n], "dtype": "int64+int32",
        "max_abs_err": max_abs_err(torch, [(gk, wk), (gv, wv)]),
        "kernel_ms": time_ms(torch, lambda: bitonic_sort_kv(k, v), reps),
        "plain_ms": time_ms(torch, lambda: bitonic_sort_kv_plain(k, v),
                            reps),
        "library_ms": time_ms(torch, lambda: torch.sort(k), reps),
        "library_call": "torch.sort (keys + int64 indices)",
        "bound": bound_ms(2 * 12 * n, n * lg)}

    # probe_sorted: n = 2^20 left keys against m = 2^21 sorted right keys
    n, m = 1 << 20, 1 << 21
    r = torch.tensor(np.sort(rng.randint(0, 1 << 22, m)).astype(np.int64),
                     device=dev)
    lk = torch.tensor(rng.randint(0, 1 << 22, n).astype(np.int64),
                      device=dev)
    lo, hi = probe_sorted(lk, r)
    plo, phi = probe_sorted_plain(lk, r)
    torch.cuda.synchronize()
    out["probe_sorted"] = {
        "shape": [n, m], "dtype": "int64",
        "max_abs_err": max_abs_err(torch, [(lo, plo), (hi, phi)]),
        "kernel_ms": time_ms(torch, lambda: probe_sorted(lk, r), reps),
        "plain_ms": time_ms(torch, lambda: probe_sorted_plain(lk, r), reps),
        "library_ms": time_ms(
            torch, lambda: (torch.searchsorted(r, lk),
                            torch.searchsorted(r, lk, right=True)), reps),
        "library_call": "torch.searchsorted (left and right)",
        # bytes: both inputs read once, both int32 bounds written once;
        # operations: two binary searches per left key
        "bound": bound_ms(8 * n + 8 * m + 8 * n,
                          2 * n * int(np.ceil(np.log2(m))))}

    # merge_ranks: the two rank launches of one index-mirror merge — a
    # resident tagged run of `cap` lanes against a sorted delta run of
    # `dcap` lanes (left side), and the delta run against the resident
    # run (right side), at the largest (cap, dcap) of the engine phase
    cap, dcap = max(merge_shapes)
    base, drun = (torch.tensor(np.sort(rng.randint(0, 1 << 52, k,
                                                   dtype=np.int64)),
                               device=dev)
                  for k in (cap, dcap))

    def ranks(fn):
        return fn(base, drun, False), fn(drun, base, True)
    got = ranks(merge_ranks)
    want = ranks(merge_ranks_plain)
    torch.cuda.synchronize()
    out["merge_ranks"] = {
        "shape": [cap, dcap], "dtype": "int64",
        "max_abs_err": max_abs_err(torch, zip(got, want)),
        "kernel_ms": time_ms(torch, lambda: ranks(merge_ranks), reps),
        # the two launches apart: the run ranked into the delta (side
        # left) and the delta ranked into the run (side right)
        "left_ms": time_ms(torch, lambda: merge_ranks(base, drun, False),
                           reps),
        "right_ms": time_ms(torch, lambda: merge_ranks(drun, base, True),
                            reps),
        "plain_ms": time_ms(torch, lambda: ranks(merge_ranks_plain), reps),
        "library_ms": time_ms(
            torch, lambda: (torch.searchsorted(drun, base),
                            torch.searchsorted(base, drun, right=True)),
            reps),
        "library_call": "torch.searchsorted (both runs)",
        # bytes: both runs read once, both rank arrays written once;
        # operations: one binary search per element of each run
        "bound": bound_ms(12 * (cap + dcap),
                          cap * int(np.ceil(np.log2(dcap)))
                          + dcap * int(np.ceil(np.log2(cap))))}

    # unique_mask_sorted: 2^21 sorted int64 keys with many ties (about
    # eight rows per distinct value), the width of a resident column
    n = 1 << 21
    x = torch.tensor(np.sort(rng.randint(0, n // 8, n)).astype(np.int64),
                     device=dev)
    got = unique_mask_sorted(x)
    want = unique_mask_sorted_plain(x)
    torch.cuda.synchronize()
    out["unique_mask_sorted"] = {
        "shape": [n], "dtype": "int64",
        "distinct": int(got.sum()),
        "max_abs_err": max_abs_err(torch, [(got, want)]),
        "kernel_ms": time_ms(torch, lambda: unique_mask_sorted(x), reps),
        "plain_ms": time_ms(torch, lambda: unique_mask_sorted_plain(x),
                            reps),
        "library_ms": time_ms(torch, lambda: torch.ne(x[1:], x[:-1]), reps),
        "library_call": "torch.ne(x[1:], x[:-1])",
        # bytes: the keys read once, the bool mask written once;
        # operations: one compare per element
        "bound": bound_ms(9 * n, n)}

    sort_detail(torch, rng, reps)
    search_detail(torch, rng, reps)
    rank_detail(torch, rng, reps, merge_shapes)
    path_shape_checks(torch, rng, sizes)
    out.update(lm_kernel_rows(torch, rng, reps))

    # the launches above compare and time the kernels; they are not the
    # main path's, so they are dropped from the counts
    kernels.reset_counts()
    for name, row in out.items():
        b, by = row.pop("bound")
        row["bound_ms"], row["bound_by"] = b, by
        print(json.dumps({"kernel": name, **row}), flush=True)
        if row["max_abs_err"] > row.get("tolerance", 0):
            fail(f"{name}: kernel and plain version differ "
                 f"(max abs err {row['max_abs_err']})")
    return out


def float_err(torch, got, want, tol: float, what: str) -> float:
    """Largest |kernel - plain| of one float output; fails past ``tol``
    or on a non-finite value."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs plain "
             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if err > tol:
        fail(f"{what}: kernel and plain version differ by {err} > {tol}")
    return err


def sdpa_backend(torch, fn) -> tuple[str, str]:
    """(backend, its heaviest device kernel) of ``fn``, a
    ``scaled_dot_product_attention`` call, read from the kernel names a
    profile of it shows: PyTorch's dispatcher picks the backend and does
    not report it.  The tracer can miss a session's first launches after
    earlier profiles in one process (``sort_split``), so a spin kernel
    and a pause go first and three calls run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    per = {k: v for k, v in device_events(prof).items() if "spin" not in k}
    if not per:
        return "not measured", "not measured"
    names = " ".join(per).lower()
    top = max(per.items(), key=lambda kv: kv[1][0])[0]
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return backend, top[:80]
    return "math", top[:80]


def lm_kernel_rows(torch, rng, reps: int) -> dict:
    """The LM kernels at the LM phase's prefill shapes, against their
    plain versions; plus windowed, unaligned and wide-head attention
    cases."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain, launch_route)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.ssd import (gram_scratch, ssd_intra,
                                             ssd_intra_plain)

    dev = "cuda"
    out = {}

    def normal(*shape, dtype=torch.float32):
        return torch.tensor(rng.randn(*shape).astype(np.float32),
                            device=dev).to(dtype)

    def attention_case(b_, sq, skv, hq, hkv, d_, win, dt, tol, route,
                       causal=True):
        """One attention comparison on the route it must take."""
        qq = normal(b_, sq, hq, d_, dtype=dt)
        kk, vv = (normal(b_, skv, hkv, d_, dtype=dt) for _ in range(2))
        before = kernels.LAUNCHES["flash_attention_wgmma"]
        what = (f"flash_attention ({b_}x{sq}x{skv}, {hq}/{hkv} heads, hd "
                f"{d_}, window {win}, causal {causal}, {dt})")
        err = float_err(
            torch, flash_attention(qq, kk, vv, causal=causal, window=win),
            flash_attention_plain(qq, kk, vv, causal=causal, window=win),
            tol, what)
        took = ("wgmma" if kernels.LAUNCHES["flash_attention_wgmma"] > before
                else "simt")
        if took != route:
            fail(f"{what}: took the {took} route, expected {route}")
        return {"shape": [b_, sq, skv, hq, hkv, d_], "window": win,
                "causal": causal, "dtype": str(dt).replace("torch.", ""),
                "route": took, "max_abs_err": err, "tolerance": tol}

    def attention_row(b_, sq, skv, h, d_, causal, route, what):
        """Attention at one of the LM phase's shapes in bf16 (h query
        heads over h kv heads), against its plain version on the route it
        must take (2e-2, as the bf16 cases), timed beside its plain
        version, SDPA on the same inputs in SDPA's [B, H, S, hd] layout
        (its backend named; its distance from the kernel's output
        recorded, not gated) and, on ``wgmma``, the CUDA-core kernel.
        Bound: q, k, v read once and the output written once (bf16), and
        the two products (QK^T and PV, 2 FLOPs per multiply-add) over the
        (query, key) pairs the mask keeps, at the bf16 tensor-core peak.
        A causal row has Sq = Skv."""
        q = normal(b_, sq, h, d_, dtype=torch.bfloat16)
        k, v = (normal(b_, skv, h, d_, dtype=torch.bfloat16)
                for _ in range(2))
        before = kernels.LAUNCHES["flash_attention_wgmma"]
        got = flash_attention(q, k, v, causal=causal)
        err = float_err(torch, got,
                        flash_attention_plain(q, k, v, causal=causal), 2e-2,
                        f"flash_attention ({what})")
        took = ("wgmma" if kernels.LAUNCHES["flash_attention_wgmma"] > before
                else "simt")
        if took != route:
            fail(f"flash_attention ({what}): took the {took} route, "
                 f"expected {route}")
        qt, kt_, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt_, vt,
                                                  is_causal=causal)
        backend, backend_kernel = sdpa_backend(torch, sdpa)
        sdpa_err = float((sdpa().transpose(1, 2).float() - got.float())
                         .abs().max())
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        row = {
            "shape": [b_, sq, skv, h, h, d_], "dtype": "bfloat16",
            "causal": causal, "route": took, "max_abs_err": err,
            "tolerance": 2e-2, "pairs": pairs,
            "kernel_ms": time_ms(
                torch, lambda: flash_attention(q, k, v, causal=causal),
                reps),
            "plain_ms": time_ms(
                torch, lambda: flash_attention_plain(q, k, v, causal=causal),
                reps),
            "library_ms": time_ms(torch, sdpa, reps),
            "library_call": f"F.scaled_dot_product_attention(is_causal="
                            f"{causal})",
            "sdpa_backend": backend, "sdpa_kernel": backend_kernel,
            "sdpa_max_abs_err": sdpa_err,
            "bound": bound_ms(2 * 2 * b_ * (sq + skv) * h * d_,
                              4 * b_ * h * d_ * pairs, BF16_OPS_PER_S)}
        if took == "wgmma":
            row["simt_ms"] = time_ms(
                torch, lambda: launch_route("simt", q, k, v, causal=causal),
                reps)
        return row

    # flash_attention: yi-6b's prefill, B=2, S=2048, Hq=32, Hkv=4, hd=128,
    # bf16, causal, on the tensor-core route; 2e-2 absolute in bf16
    # (tests/test_kernels.py)
    B, S, Hq, Hkv, hd = 2, 2048, 32, 4, 128
    q = normal(B, S, Hq, hd, dtype=torch.bfloat16)
    k, v = (normal(B, S, Hkv, hd, dtype=torch.bfloat16) for _ in range(2))
    before = kernels.LAUNCHES["flash_attention_wgmma"]
    err = float_err(torch, flash_attention(q, k, v, causal=True),
                    flash_attention_plain(q, k, v, causal=True), 2e-2,
                    "flash_attention (yi prefill)")
    if kernels.LAUNCHES["flash_attention_wgmma"] != before + 1:
        fail("flash_attention (yi prefill) did not take the wgmma route")
    # a windowed case, Sq != Skv with ragged tails (no tile divides them)
    # on both routes, and fp16 at yi's shape (4e-3: an ulp of the output)
    side = [attention_case(*c) for c in (
        (1, 300, 300, 8, 2, 128, 100, torch.bfloat16, 2e-2, "wgmma"),
        (2, 77, 200, 12, 1, 64, 0, torch.float32, 1e-5, "simt"),
        (2, 77, 200, 12, 1, 64, 0, torch.bfloat16, 2e-2, "wgmma"),
        (B, S, S, Hq, Hkv, hd, 0, torch.float16, 4e-3, "wgmma"))]
    qt, kt_, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    band = S * (S + 1) // 2
    out["flash_attention"] = {
        "shape": [B, S, Hq, Hkv, hd], "dtype": "bfloat16", "causal": True,
        "route": "wgmma", "max_abs_err": err, "tolerance": 2e-2,
        "side_cases": side,
        "kernel_ms": time_ms(
            torch, lambda: flash_attention(q, k, v, causal=True), reps),
        # the CUDA-core kernel (the float32 route) on the same bf16
        # inputs: the time the tensor-core route replaces
        "simt_ms": time_ms(
            torch, lambda: launch_route("simt", q, k, v, causal=True), reps),
        "plain_ms": time_ms(
            torch, lambda: flash_attention_plain(q, k, v, causal=True), reps),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt_, vt, is_causal=True, enable_gqa=True), reps),
        "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
        # bytes: q, k, v read once, out written once (bf16); operations:
        # the causal band's two products (QK^T and PV), 2 FLOPs per
        # multiply-add, at the bf16 tensor-core peak (the inputs' type)
        "bound": bound_ms(2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd),
                          4 * B * Hq * hd * band, BF16_OPS_PER_S)}

    # flash_attention at moonshot-v1-16b-a3b's prefill: B=2, S=2048, 16
    # query heads over 16 kv heads (MHA, a group of 1), hd 128, bf16,
    # causal, on the tensor-core route
    del q, k, v, qt, kt_, vt
    out["flash_attention@mha"] = attention_row(
        2, 2048, 2048, 16, 128, True, "wgmma", "moonshot prefill")

    # flash_attention at head dim 256: recurrentgemma-9b's prefill, B=2,
    # S=4096, Hq=16 over Hkv=1, causal, window 2048, bf16, on the
    # tensor-core route (2e-2 as the bf16 cases); fp16 at that shape
    # (4e-3) on the same route; the same in float32 (1e-5) and a ragged
    # Sq != Skv case at head dim 192, both dtypes, on the CUDA-core one
    B, S, Hq, Hkv, hd, W = 2, 4096, 16, 1, 256, 2048
    q = normal(B, S, Hq, hd, dtype=torch.bfloat16)
    k, v = (normal(B, S, Hkv, hd, dtype=torch.bfloat16) for _ in range(2))
    before = dict(kernels.LAUNCHES)
    err = float_err(
        torch, flash_attention(q, k, v, causal=True, window=W),
        flash_attention_plain(q, k, v, causal=True, window=W), 2e-2,
        "flash_attention (recurrentgemma prefill, hd 256)")
    if (kernels.LAUNCHES["flash_attention"] != before["flash_attention"] + 1
            or kernels.LAUNCHES["flash_attention_wgmma"]
            != before["flash_attention_wgmma"] + 1):
        fail("flash_attention (hd 256) did not take the wgmma route")
    side = [attention_case(*c) for c in (
        (B, S, S, Hq, Hkv, hd, W, torch.float16, 4e-3, "wgmma"),
        (B, S, S, Hq, Hkv, hd, W, torch.float32, 1e-5, "simt"),
        (2, 77, 300, 16, 1, 192, 100, torch.bfloat16, 2e-2, "simt"),
        (2, 77, 300, 16, 1, 192, 100, torch.float32, 1e-5, "simt"))]
    # the yardstick: SDPA with the band as an explicit boolean mask over
    # K/V repeated to every query head (the repeat is outside the call)
    qt = q.transpose(1, 2).contiguous()
    kt_, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
               .contiguous() for x in (k, v))
    pos = torch.arange(S, device=dev)
    band_mask = ((pos[:, None] >= pos[None, :])
                 & (pos[:, None] - pos[None, :] < W))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt_, vt,
                                              attn_mask=band_mask)
    backend, backend_kernel = sdpa_backend(torch, sdpa)
    # that the yardstick computes the same function (recorded, not gated)
    sdpa_err = float((sdpa().transpose(1, 2).float()
                      - flash_attention(q, k, v, causal=True, window=W)
                      .float()).abs().max())
    # (query, key) pairs in the causal band under the window
    band = W * (W + 1) // 2 + (S - W) * W
    out["flash_attention@hd256"] = {
        "shape": [B, S, Hq, Hkv, hd], "dtype": "bfloat16", "causal": True,
        "window": W, "route": "wgmma", "max_abs_err": err, "tolerance": 2e-2,
        "side_cases": side, "band_pairs": band,
        "kernel_ms": time_ms(
            torch, lambda: flash_attention(q, k, v, causal=True, window=W),
            reps),
        # the CUDA-core kernel on the same bf16 inputs: the time the
        # tensor-core route replaces at hd 256
        "simt_ms": time_ms(
            torch, lambda: launch_route("simt", q, k, v, causal=True,
                                        window=W), reps),
        "plain_ms": time_ms(
            torch, lambda: flash_attention_plain(q, k, v, causal=True,
                                                 window=W), reps),
        "library_ms": time_ms(torch, sdpa, reps),
        "library_call": "F.scaled_dot_product_attention(attn_mask=band, "
                        "K/V repeated to 16 heads)",
        "sdpa_backend": backend, "sdpa_kernel": backend_kernel,
        "sdpa_max_abs_err": sdpa_err,
        # bytes: q, k, v read once, out written once (bf16); operations:
        # the band's two products (QK^T and PV), 2 FLOPs per multiply-add,
        # at the bf16 tensor-core peak (the inputs' type)
        "bound": bound_ms(2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd),
                          4 * B * Hq * hd * band, BF16_OPS_PER_S)}
    del q, k, v, qt, kt_, vt, band_mask

    # flash_attention at whisper-tiny's shapes: 16 clips, 6/6 heads at hd
    # 64, non-causal, on the tensor-core route (its hd-64 kernel): the
    # encoder over 1500 frames, and the decoder's cross-attention from a
    # 432-token prompt onto them (``cross``); the encoder's shape in
    # float32 on the CUDA-core route (1e-5), and on the hd-64 kernel
    # causal, windowed (100) and in fp16 (4e-3), and a ragged 77 -> 300
    # case at whisper's heads
    enc = attention_row(16, 1500, 1500, 6, 64, False, "wgmma",
                        "whisper encoder")
    cross = attention_row(16, 432, 1500, 6, 64, False, "wgmma",
                          "whisper cross-attention")
    cross["bound_ms"], cross["bound_by"] = cross.pop("bound")
    side = [attention_case(*c) for c in (
        (16, 1500, 1500, 6, 6, 64, 0, torch.float32, 1e-5, "simt", False),
        (16, 1500, 1500, 6, 6, 64, 0, torch.bfloat16, 2e-2, "wgmma", True),
        (16, 1500, 1500, 6, 6, 64, 100, torch.bfloat16, 2e-2, "wgmma"),
        (16, 1500, 1500, 6, 6, 64, 0, torch.float16, 4e-3, "wgmma", False),
        (2, 77, 300, 6, 6, 64, 0, torch.bfloat16, 2e-2, "wgmma", False))]
    out["flash_attention@encdec"] = {**enc, "cross": cross,
                                     "side_cases": side}

    # flash_attention at head dim 96: phi-3-vision-4.2b's prefill, 2 rows
    # of 576 patches and 1472 tokens, 32/32 heads, causal, on the
    # tensor-core route's hd-96 tiles (beside the CUDA-core kernel's time
    # on the same inputs); fp16 at that shape (4e-3) on the same route; a
    # ragged non-causal case at its head layout in bf16 on that route and
    # in float32 on the CUDA-core one
    out["flash_attention@hd96"] = {
        **attention_row(2, 2048, 2048, 32, 96, True, "wgmma",
                        "phi-3-vision prefill, hd 96"),
        "side_cases": [attention_case(*c) for c in (
            (2, 2048, 2048, 32, 32, 96, 0, torch.float16, 4e-3, "wgmma"),
            (2, 77, 300, 32, 32, 96, 0, torch.bfloat16, 2e-2, "wgmma",
             False),
            (2, 77, 300, 32, 32, 96, 0, torch.float32, 1e-5, "simt",
             False))]}

    # ssd_intra: mamba2-1.3b's prefill, b=2, nc=8, Q=256, nh=64, hp=64,
    # N=128, float32; 1e-4 of max|y| and of max|state| (sums over Q and N
    # reassociated)
    b, nc, Q, nh, hp, N = 2, 8, 256, 64, 64, 128
    dlog = -np.abs(rng.randn(b, nc, Q, nh)).astype(np.float32) * 0.05
    cum = torch.tensor(np.cumsum(dlog, axis=2), device=dev)
    u = normal(b, nc, Q, nh, hp)
    Bm, Cm = normal(b, nc, Q, N), normal(b, nc, Q, N)
    y, st = ssd_intra(cum, u, Bm, Cm)
    yp, sp = ssd_intra_plain(cum, u, Bm, Cm)
    tols = [1e-4 * max(1.0, float(w.abs().max())) for w in (yp, sp)]
    errs = [float_err(torch, g, w, t, f"ssd_intra ({what})")
            for g, w, t, what in ((y, yp, tols[0], "y"),
                                  (st, sp, tols[1], "state"))]
    tri = Q * (Q + 1) // 2
    gram = gram_scratch(b, nc, Q, dev)
    lib = _build.library("ssd_intra")

    def gram_pass():
        _build.check(lib.ssd_gram_f32(
            Bm.data_ptr(), Cm.data_ptr(), b, nc, Q, N, gram.data_ptr(),
            gram.shape[0], torch.cuda.current_stream().cuda_stream),
            "ssd_gram")
    # bytes: cum, u, B, C read once, y and the states written once;
    # operations the function needs (2 per multiply-add): the gram
    # C.B^T's lower triangle once per (b, c), and per head the decay (exp
    # of a difference, times the gram), M u over the triangle, the state
    # weights and the state product u^T B
    nbytes = 4 * (b * nc * Q * nh + 2 * b * nc * Q * nh * hp
                  + 2 * b * nc * Q * N + b * nc * nh * hp * N)
    ops = b * nc * (tri * N * 2 + nh * (tri * 2 + tri * hp * 2 + Q * hp
                                        + Q * hp * N * 2))
    out["ssd_intra"] = {
        "shape": [b, nc, Q, nh, hp, N], "dtype": "float32",
        "max_abs_err": max(errs), "tolerance": max(tols),
        "kernel_ms": time_ms(torch, lambda: ssd_intra(cum, u, Bm, Cm), reps),
        # the gram pass alone (the kernel's first launch)
        "gram_ms": time_ms(torch, gram_pass, reps),
        "plain_ms": time_ms(torch, lambda: ssd_intra_plain(cum, u, Bm, Cm),
                            reps),
        "library_ms": None, "library_call": None,
        # the kernel runs the work as three TF32 tensor-core products
        # (split float32), so the operations count three times at the TF32
        # peak
        "bound": bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S),
        # the old yardstick: the same work at the float32 peak without
        # tensor cores
        "bound_old_ms": bound_ms(nbytes, ops)[0]}
    out["linear_scan"] = scan_row(torch, rng, reps)
    return out


# the RG-LRU scan's kernel row: recurrentgemma-9b's prefill, B 2 prompts
# of S 4096 at d 4096; its gate (both checks), 1e-5 of max(1, max|h|):
# kernel and plain passes sum the same terms in another order in float32
# (the staged model reads ~4e-7 against float64 at S 4096,
# tests/test_torch_rglru_scan.py); channels the float64 check steps
SCAN_SHAPE = (2, 4096, 4096)
SCAN_TOL = 1e-5
SCAN_F64_CHANNELS = 64


def scan_row(torch, rng, reps: int, shape=SCAN_SHAPE) -> dict:
    """``linear_scan`` at ``shape``, float32, decays from U(0.9, 1) (the
    state carries across the prompt), without ``h0`` (the prefill's form)
    and with one: against the plain passes on the card and against the
    recurrence stepped in float64 on the host over ``SCAN_F64_CHANNELS``
    sampled channels of each batch row, each within ``SCAN_TOL`` of
    max(1, max|h|); timed beside the plain passes.  No single PyTorch call
    computes a first-order linear recurrence (``library_ms`` None)."""
    import numpy as np

    from repro_torch.kernels.rglru_scan.scan import (linear_scan,
                                                     linear_scan_plain)

    B, S, D = shape
    a = torch.tensor(rng.uniform(0.9, 1.0, shape).astype(np.float32),
                     device="cuda")
    b = torch.tensor(rng.randn(*shape).astype(np.float32), device="cuda")
    h0 = torch.tensor(rng.randn(B, D).astype(np.float32), device="cuda")
    idx = np.sort(rng.choice(D, min(D, SCAN_F64_CHANNELS), replace=False))
    a64, b64 = (x[:, :, idx].double().cpu().numpy() for x in (a, b))

    def check(init, what):
        got = linear_scan(a, b, init)
        plain = linear_scan_plain(a, b, init)
        tol = SCAN_TOL * max(1.0, float(plain.abs().max()))
        err = float_err(torch, got, plain, tol, f"linear_scan ({what})")
        h = (np.zeros((B, len(idx))) if init is None
             else init[:, idx].double().cpu().numpy())
        want = np.empty(a64.shape)
        for t in range(S):
            h = a64[:, t] * h + b64[:, t]
            want[:, t] = h
        tol64 = SCAN_TOL * max(1.0, float(np.abs(want).max()))
        err64 = float(np.abs(got[:, :, idx].double().cpu().numpy()
                             - want).max())
        if not err64 <= tol64:
            fail(f"linear_scan ({what}): {err64} from the float64 "
                 f"recurrence > {tol64}")
        return {"max_abs_err": err, "tolerance": tol, "f64_max_abs_err":
                err64, "f64_tolerance": tol64}

    # the row's own error and tolerance are the case without h0 (the
    # prefill's form); the case with one is its ``h0`` entry
    row = {"shape": [B, S, D], "dtype": "float32", **check(None, "no h0"),
           "h0": check(h0, "h0"),
           "kernel_ms": time_ms(torch, lambda: linear_scan(a, b), reps),
           "h0_kernel_ms": time_ms(torch, lambda: linear_scan(a, b, h0),
                                   reps),
           "plain_ms": time_ms(torch, lambda: linear_scan_plain(a, b), reps),
           "library_ms": None, "library_call": None,
           # bytes: a and b read once, h written once (float32);
           # operations: a multiply and an add an element, at the float32
           # rate without tensor cores
           "bound": bound_ms(4 * 3 * B * S * D, 2 * B * S * D)}
    del a, b, h0
    torch.cuda.empty_cache()
    return row


def row_sets(engine, queries):
    return [{tuple(sorted(r.items())) for r in engine.query(q)}
            for q in queries]


def merge_shapes(torch_ops):
    """Record the (run lanes, delta lanes) of every index-mirror merge the
    engine runs: ``merge_sorted_mirror_impl`` is wrapped in the
    ``torch_ops`` module's namespace, where ``TorchOps`` looks it up.
    Returns the list and an undo function."""
    seen = []
    orig = torch_ops.merge_sorted_mirror_impl

    def recording(buf, *args, dcap, **kw):
        seen.append((int(buf.shape[0]), int(dcap)))
        return orig(buf, *args, dcap=dcap, **kw)
    torch_ops.merge_sorted_mirror_impl = recording

    def undo():
        torch_ops.merge_sorted_mirror_impl = orig
    return seen, undo


# (preset, config overrides) of the engine phase's runs, in order: the two
# raw presets of the first slice, the reference's default compressed
# tier under both presets, and the device sketch planner
RUNS = [
    ("infer1", {"compress": False}),
    ("query1", {"compress": False}),
    ("infer1", {"compress": True}),
    ("query1", {"compress": True}),
    ("query1", {"compress": True, "sort_mode": "sketch"}),
]


def engine_config(preset: str, overrides: dict):
    from repro_torch.core import EngineConfig
    cfg = getattr(EngineConfig, preset)(backend="torch")
    cfg.eval_mode = "full"
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def new_sizes() -> dict:
    """Empty launches-by-size tables in the form of ``kernels.counts()``:
    the sorts' by log2 of the padded length, the probe's by "log2 n,log2
    m" and the unique mask's by "log2 n"."""
    from repro_torch import kernels
    return {"sort_sizes": {name: {} for name in kernels.SORT_SIZES},
            "search_sizes": {name: {} for name in kernels.SEARCH_SIZES}}


def engine_phase(torch, scale: int, seed: int, sizes: dict, shapes: list):
    """The five engine runs against numpy.  Adds the launches by size to
    ``sizes``; ``shapes`` is the index-mirror merge recorder's list
    (``merge_shapes``).  Returns the launches over the runs and
    ``Ops.unique_mask``, and the demand and serving phases' oracle."""
    from repro_torch import kernels
    from repro_torch.core import EngineConfig, HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import decoded_fact_checksum
    from repro_torch.datasets import LUBM_QUERIES, lubm_like

    t0 = time.perf_counter()
    facts = lubm_like(scale, seed=seed)
    print(json.dumps({"phase": "engine", "scale": scale,
                      "base_facts": len(facts),
                      "gen_s": time.perf_counter() - t0}), flush=True)

    # oracle: the port's numpy backend on the same facts.  Results do not
    # depend on the configuration (the paper's invariant, held by the CPU
    # tests over the whole grid), so one AI-indexed run serves every run
    t0 = time.perf_counter()
    cfg = EngineConfig.query1(backend="numpy")
    cfg.eval_mode = "full"
    ref = HiperfactEngine(cfg)
    ref.add_rules(rdfs_plus_rules())
    ref.insert_facts(facts)
    ref_stats = ref.infer()
    ref_rows = row_sets(ref, LUBM_QUERIES)
    ref_sum = decoded_fact_checksum(ref)
    # the demand and serving phases' queries: the four above and the
    # point queries
    oracle = {"facts": facts, "facts_inferred": ref_stats.facts_inferred,
              "rows": ref_rows + row_sets(ref, point_queries()),
              "checksum": ref_sum}
    print(json.dumps({"oracle": "numpy", "preset": "query1",
                      "facts_inferred": ref_stats.facts_inferred,
                      "rows": [len(s) for s in oracle["rows"]],
                      "checksum": ref_sum,
                      "seconds": time.perf_counter() - t0}), flush=True)
    del ref

    launches = {name: 0 for name in kernels.ENGINE_KERNELS}
    engine_sizes = new_sizes()  # this phase's runs alone
    for preset, overrides in RUNS:
        e = HiperfactEngine(engine_config(preset, overrides))
        e.add_rules(rdfs_plus_rules())
        snap = e.ops.transfers.snapshot()
        work = e.ops.sort_work.snapshot()
        codecs0 = e.ops.residency_stats()["codecs"]
        n_shapes = len(shapes)
        kernels.reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        e.insert_facts(facts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = e.infer()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows = row_sets(e, LUBM_QUERIES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = kernels.counts()  # ... and ends here
        moved = e.ops.transfers.delta(snap)
        sorted_work = e.ops.sort_work.delta(work)
        res = e.ops.residency_stats()
        res["codecs"] = {k: v - codecs0[k] for k, v in res["codecs"].items()}
        checksum = decoded_fact_checksum(e)
        rec = {"preset": preset, **overrides, "backend": "torch",
               "eval_mode": "full",
               "load_s": t1 - t0, "infer_s": t2 - t1, "query_s": t3 - t2,
               "facts_inferred": stats.facts_inferred,
               "iterations": stats.iterations,
               "sketch_misses": stats.sketch_misses,
               "rows": [len(s) for s in rows],
               "launches": counts["launches"],
               "sort_sizes": counts["sort_sizes"],
               "search_sizes": counts["search_sizes"],
               "width_fallbacks": counts["fallbacks"],
               "transfers": {"h2d_calls": moved.h2d_calls,
                             "h2d_bytes": moved.h2d_bytes,
                             "d2h_calls": moved.d2h_calls,
                             "d2h_bytes": moved.d2h_bytes},
               "residency": res,
               "sort_work": sorted_work.as_dict(),
               "merge_shapes": sorted(set(shapes[n_shapes:])),
               "cache": e.ops.cache.stats(),
               "checksum": checksum,
               "checksum_equal": checksum == ref_sum,
               "rows_equal": rows == ref_rows}
        print(json.dumps(rec), flush=True)
        for name in launches:
            launches[name] += counts["launches"][name]
        add_sizes(engine_sizes, counts)
        label = f"{preset} {overrides}"
        if stats.facts_inferred != ref_stats.facts_inferred:
            fail(f"{label}: facts_inferred {stats.facts_inferred} != "
                 f"{ref_stats.facts_inferred} (numpy)")
        if checksum != ref_sum:
            fail(f"{label}: decoded fact checksum differs from numpy")
        if rows != ref_rows:
            fail(f"{label}: query row sets differ from numpy")
        if overrides["compress"] and not (
                0 < res["resident_bytes_coded"] < res["resident_bytes_raw"]):
            fail(f"{label}: coded resident bytes {res['resident_bytes_coded']}"
                 f" not below raw {res['resident_bytes_raw']}")
        # release this engine's device cache before the next run
        e.ops.cache.clear()
    print(json.dumps({"engine_sort_sizes": {
        k: dict(sorted(v.items()))
        for k, v in engine_sizes["sort_sizes"].items()}}), flush=True)
    counts = unique_mask_entry(torch)
    launches = {k: launches[k] + counts["launches"][k] for k in launches}
    add_sizes(engine_sizes, counts)
    add_sizes(sizes, engine_sizes)
    # the probe's and the unique mask's launches over the five runs and
    # Ops.unique_mask, by size: how the kernel phase's shapes stand
    print(json.dumps({"engine_probe_sizes": {
        k: dict(sorted(v.items()))
        for k, v in engine_sizes["search_sizes"].items()}}), flush=True)
    # a run may skip a kernel for a reason of its data or its mode: an
    # index mirror whose column outgrows its power-of-two buffer is
    # re-sorted, not merged (at scale 500, infer1's only in-infer LPIM
    # compaction does), and only the sketch planner and Ops.unique_mask
    # reach unique_mask_sorted, so the check is over the whole path
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} never launched on the path")
    device_profile(torch, facts, "infer1", {"compress": False})
    device_profile(torch, facts, "infer1", {"compress": True})
    return launches, oracle


def add_sizes(sizes: dict, counts: dict) -> None:
    """Add a run's launches by size (``kernels.counts()``) to ``sizes``."""
    for group, per_kernel in sizes.items():
        for name, by_lg in counts[group].items():
            for lg, c in by_lg.items():
                # the sorts' keys are ints, but strings after JSON
                lg = int(lg) if group == "sort_sizes" else lg
                per_kernel[name][lg] = per_kernel[name].get(lg, 0) + c


def unique_mask_entry(torch) -> dict:
    """``Ops.unique_mask`` (the compressed backend's entry point of the
    unique-mask kernel) once at full width: a sorted column of 2^20 rows
    with ties, against ``NumpyOps.unique_mask``.  Returns the kernel
    counters of that call."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.backend import get_backend

    ops = get_backend("torch", compress=True)
    x = np.sort(np.random.RandomState(7).randint(0, 1 << 17, 1 << 20)
                ).astype(np.int64) + (1 << 40)
    snap = ops.transfers.snapshot()
    kernels.reset_counts()  # the entry point's run starts here
    t0 = time.perf_counter()
    got = ops.unique_mask(x)
    secs = time.perf_counter() - t0
    counts = kernels.counts()  # ... and ends here
    moved = ops.transfers.delta(snap)
    want = get_backend("numpy").unique_mask(x)
    equal = bool(np.array_equal(got, want))
    print(json.dumps({"entry": "Ops.unique_mask", "rows": len(x),
                      "distinct": int(want.sum()), "seconds": secs,
                      "launches": counts["launches"],
                      "h2d_bytes": moved.h2d_bytes,
                      "d2h_bytes": moved.d2h_bytes, "equal": equal}),
          flush=True)
    if not equal:
        fail("Ops.unique_mask differs from NumpyOps.unique_mask")
    return counts


def device_events(prof) -> dict:
    """{kernel name: (device us, calls)} of a profile's device-side events
    (kernels, memcpys): a host op's device time repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType
    return {ev.key: (ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def device_profile(torch, facts, preset: str, overrides: dict) -> None:
    """Device busy time of one more fresh run of ``preset`` (load, infer,
    queries) under ``torch.profiler``: the sum of device kernel times,
    the share spent in the port's own CUDA kernels, and the top kernels.
    The profiler's overhead lengthens ``wall_s``, so ``idle_share`` is an
    upper bound; the timed runs above are the end-to-end numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.datasets import LUBM_QUERIES

    e = HiperfactEngine(engine_config(preset, overrides))
    e.add_rules(rdfs_plus_rules())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e.insert_facts(facts)
        e.infer()
        row_sets(e, LUBM_QUERIES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    e.ops.cache.clear()
    per = device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    ours = sum(us for k, (us, _) in per.items()
               if any(n in k for n in OUR_KERNELS)) / 1e6
    sorts = sum(us for k, (us, _) in per.items() if is_sort_kernel(k)) / 1e6
    copies = sum(us for k, (us, _) in per.items()
                 if "memcpy" in k.lower()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "profile": preset, **overrides, "wall_s": wall,
        "device_busy_s": busy if busy else "not measured",
        "idle_share": 1 - busy / wall if busy else "not measured",
        "own_kernels_s": ours, "sort_kernels_s": sorts, "copies_s": copies,
        "top_device_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                               for k, (us, c) in top]}), flush=True)


def point_queries():
    """The demand and serving phases' point queries, beside
    ``LUBM_QUERIES``: one constant anchor each (batchable when served): a
    student's types, a department's members (an attribute-anchored
    probe), everything about a student, a professor's courses."""
    from repro_torch.core.conditions import cond
    return [[cond("Data", "stu0_0_0", "type", "?t")],
            [cond("Data", "?x", "memberOf", "dept0_0")],
            [cond("Data", "stu0_3_7", "?p", "?o")],
            [cond("Data", "prof0_1_2", "teacherOf", "?c")]]


# the kernels the demand and serving phases must launch between them (the
# demand rounds' joins, dedups and probes; the served probes and the AI
# mirrors' merges on every served append)
SERVING_KERNELS = ("bitonic_sort", "bitonic_sort_kv", "probe_sorted",
                   "merge_ranks")


def require_launches(phase: str, counts: dict, names) -> None:
    for name in names:
        if counts[name] <= 0:
            fail(f"{phase}: kernel {name} never launched")


def demand_phase(torch, oracle: dict, sizes: dict, shapes: list) -> dict:
    """``eval_mode="demand"`` under ``infer1`` on the card: the facts
    loaded and never inferred, then ``LUBM_QUERIES`` and four point
    queries, each materializing its own cone.  Every row set must equal
    the numpy full engine's (the engine phase's oracle) with no fallback
    to a full ``infer()``, and the rounds must launch the sort and the
    probe.  Adds the load's and the queries' launches by size to
    ``sizes`` (and the merge recorder adds to ``shapes``).  Returns the
    kernel launches of the queries."""
    from repro_torch import kernels
    from repro_torch.core import HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.datasets import LUBM_QUERIES

    e = HiperfactEngine(engine_config("infer1", {"eval_mode": "demand"}))
    e.add_rules(rdfs_plus_rules())
    n_shapes = len(shapes)
    kernels.reset_counts()
    t0 = time.perf_counter()
    e.insert_facts(oracle["facts"])
    torch.cuda.synchronize()
    load = kernels.counts()
    add_sizes(sizes, load)
    print(json.dumps({"phase": "demand", "preset": "infer1",
                      "base_facts": len(oracle["facts"]),
                      "load_s": time.perf_counter() - t0,
                      "sort_sizes": load["sort_sizes"],
                      "search_sizes": load["search_sizes"]}), flush=True)
    names = ("demand_rounds", "demand_cone_rows", "demand_fallbacks",
             "rows_considered")
    queries = LUBM_QUERIES + point_queries()
    kernels.reset_counts()  # the demand path's run starts here
    t_all = time.perf_counter()
    for i, (q, want) in enumerate(zip(queries, oracle["rows"])):
        before = {k: getattr(e.last_infer, k) for k in names}
        t0 = time.perf_counter()
        got = row_sets(e, [q])[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = {"demand_query": i,
               "conditions": [f"{c.id} {c.attr} {c.val}" for c in q],
               "seconds": secs,
               **{k: getattr(e.last_infer, k) - before[k] for k in names},
               "rows": len(got), "rows_equal": got == want,
               "facts_inferred_full": oracle["facts_inferred"]}
        print(json.dumps(rec), flush=True)
        if got != want:
            fail(f"demand query {i}: row set differs from numpy full")
    counts = kernels.counts()  # ... and ends here
    add_sizes(sizes, counts)
    st = e.last_infer
    print(json.dumps({"phase": "demand", "queries_s":
                      time.perf_counter() - t_all,
                      "demand_rounds": st.demand_rounds,
                      "demand_cone_rows": st.demand_cone_rows,
                      "demand_fallbacks": st.demand_fallbacks,
                      "facts_inferred_full": oracle["facts_inferred"],
                      "launches": counts["launches"],
                      "sort_sizes": counts["sort_sizes"],
                      "search_sizes": counts["search_sizes"],
                      "merge_shapes": sorted(set(shapes[n_shapes:])),
                      "width_fallbacks": counts["fallbacks"]}), flush=True)
    if st.demand_fallbacks:
        fail(f"demand phase: {st.demand_fallbacks} fallbacks to infer()")
    require_launches("demand phase", counts["launches"],
                     ("bitonic_sort", "probe_sorted"))
    e.ops.cache.clear()
    return counts["launches"]


# the serving phase: writers x appends each, readers x reads each, and the
# batcher's tenants
SERVE_WRITERS, SERVE_APPENDS, SERVE_READERS, SERVE_READS = 2, 8, 4, 24
SERVE_TENANTS = 3


def new_student(rng, w: int, i: int) -> list:
    """One served append: a new student with a type, a department and a
    course, shaped like ``lubm_like``'s."""
    from repro_torch.core import Fact
    d, p, c = rng.randint(8), rng.randint(6), rng.randint(2)
    stu = f"stu_w{w}_{i}"
    return [Fact("Data", stu, "type",
                 "GraduateStudent" if i % 4 == 0 else "Student"),
            Fact("Data", stu, "memberOf", f"dept0_{d}"),
            Fact("Data", stu, "takesCourse", f"course0_{d}_{p}_{c}")]


def serve_threads(srv, queries, seed: int, first: int) -> dict:
    """The serving phase's threaded workload on ``srv``: writer threads
    append new students (``first`` numbers the first append of each),
    reader threads mix ``LUBM_QUERIES`` (even reads) with the point
    queries (odd reads) across tenants.  Returns each read's (seconds,
    mode, query index, result), each append's seconds, errors and the
    wall time."""
    import threading

    import numpy as np

    n_lubm = len(queries) - len(point_queries())
    out = {"reads": [], "appends": [], "errors": []}
    lock = threading.Lock()

    def writer(w):
        rng = np.random.RandomState(seed + 100 * (first + 1) + w)
        try:
            for i in range(first, first + SERVE_APPENDS):
                t = time.perf_counter()
                srv.append(new_student(rng, w, i))
                dt = time.perf_counter() - t
                with lock:
                    out["appends"].append(dt)
        except Exception as exc:  # noqa: BLE001 - fails the phase
            out["errors"].append(repr(exc))

    def reader(r):
        try:
            for i in range(SERVE_READS):
                qi = ((i // 2 + r) % n_lubm if i % 2 == 0 else
                      n_lubm + (i // 2 + r) % (len(queries) - n_lubm))
                t = time.perf_counter()
                res = srv.serve(queries[qi],
                                tenant=f"t{(r + i) % SERVE_TENANTS}")
                dt = time.perf_counter() - t
                with lock:
                    out["reads"].append((dt, res.mode, qi, res))
        except Exception as exc:  # noqa: BLE001
            out["errors"].append(repr(exc))

    threads = ([threading.Thread(target=writer, args=(w,))
                for w in range(SERVE_WRITERS)]
               + [threading.Thread(target=reader, args=(r,))
                  for r in range(SERVE_READERS)])
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    out["wall_s"] = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail("serving phase: a thread did not finish in 600 s")
    if out["errors"]:
        fail(f"serving phase: {len(out['errors'])} reads or writes raised: "
             f"{out['errors'][:3]}")
    if len(out["reads"]) != SERVE_READERS * SERVE_READS:
        fail(f"serving phase: {len(out['reads'])} reads served")
    return out


def pct_ms(xs, q: float) -> float:
    ms = sorted(x * 1e3 for x in xs)
    return ms[min(len(ms) - 1, int(len(ms) * q))]


def burst_queries() -> list:
    """The serving phase's burst: point reads of 16 base students and of
    the first and last student each writer appended, all anchored on the
    subject (one ``(Data, ID)`` bucket, so one wave of the batcher)."""
    from repro_torch.core.conditions import cond
    stus = [f"stu0_{d}_{s}" for d in range(8) for s in (5, 17)]
    stus += [f"stu_w{w}_{i}" for w in range(SERVE_WRITERS)
             for i in (0, SERVE_APPENDS - 1)]
    return [[cond("Data", stu, "?p", "?o")] for stu in stus]


def serve_burst(srv, queries) -> list:
    """One read of each query, all released together by a barrier with
    the writers idle, so the batcher's admission window takes several
    anchors in one wave.  Returns the results in query order."""
    import threading

    barrier = threading.Barrier(len(queries))
    out, errors = [None] * len(queries), []

    def read(i):
        try:
            barrier.wait(timeout=60)
            out[i] = srv.serve(queries[i], tenant=f"t{i % SERVE_TENANTS}")
        except Exception as exc:  # noqa: BLE001 - fails the phase
            errors.append(repr(exc))

    threads = [threading.Thread(target=read, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if any(t.is_alive() for t in threads):
        fail("serving phase: a burst read did not finish in 120 s")
    if errors:
        fail(f"serving phase: {len(errors)} burst reads raised: "
             f"{errors[:3]}")
    return out


def serving_phase(torch, facts, seed: int, sizes: dict,
                  shapes: list) -> dict:
    """``FactServer`` over a ``query1`` engine (``eval_mode="delta"``,
    the default compressed tier) on the card: ``serve_threads``'s writers
    and readers, then a burst of point reads with the writers idle
    (``serve_burst``), which must coalesce.  Every batched read, and the
    first, a middle and the last result of each other query, is held
    against a numpy engine of the same preset and mode stepped through
    the server's write history to the result's token.  Then the threaded
    workload once more under ``torch.profiler`` for the card's busy
    time.  Adds every run's launches by size to ``sizes`` (the merge
    recorder adds to ``shapes``).  Returns the kernel launches of the
    threaded run and the burst."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.datasets import LUBM_QUERIES
    from repro_torch.serve import FactServer, ServedResult

    def engine(cfg):
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        e.insert_facts(facts)
        e.infer()
        return e

    n_shapes = len(shapes)
    kernels.reset_counts()  # the server's engine: load and first infer
    t0 = time.perf_counter()
    e = engine(engine_config("query1", {"eval_mode": "delta"}))
    torch.cuda.synchronize()
    setup = kernels.counts()
    add_sizes(sizes, setup)
    print(json.dumps({"phase": "serving", "preset": "query1",
                      "eval_mode": "delta", "compress": e.ops.compress,
                      "setup_s": time.perf_counter() - t0,
                      "sort_sizes": setup["sort_sizes"],
                      "search_sizes": setup["search_sizes"],
                      "merge_shapes": sorted(set(shapes[n_shapes:]))}),
          flush=True)
    queries = LUBM_QUERIES + point_queries()
    burst = burst_queries()
    srv = FactServer(e, record_history=True)
    n_shapes = len(shapes)
    kernels.reset_counts()  # the serving path's run starts here
    run = serve_threads(srv, queries, seed, 0)
    b0 = srv.stats()["batch"]
    t0 = time.perf_counter()
    burst_res = serve_burst(srv, burst)
    burst_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.counts()  # ... and ends here
    add_sizes(sizes, counts)
    st = srv.stats()
    b1 = st["batch"]
    reads, wall = run["reads"], run["wall_s"]
    by = {}
    for dt, mode, qi, _ in reads:
        by.setdefault(("mode", mode), []).append(dt)
        by.setdefault(("query", qi), []).append(dt)
    burst_rec = {k: b1[k] - b0[k] for k in ("device_calls",
                                            "batched_queries", "flushes")}
    burst_rec.update(reads=len(burst), seconds=burst_s,
                     modes=sorted({r.mode for r in burst_res}))
    rec = {"serving": "query1", "writers": SERVE_WRITERS,
           "appends": len(run["appends"]), "readers": SERVE_READERS,
           "reads": len(reads), "wall_s": wall,
           "served_qps": len(reads) / wall,
           "p50_ms": pct_ms([r[0] for r in reads], 0.5),
           "p99_ms": pct_ms([r[0] for r in reads], 0.99),
           "p50_ms_by_mode": {k[1]: pct_ms(v, 0.5) for k, v in by.items()
                              if k[0] == "mode"},
           "p50_ms_by_query": {k[1]: pct_ms(v, 0.5) for k, v in by.items()
                               if k[0] == "query"},
           "append_p50_ms": pct_ms(run["appends"], 0.5),
           "append_max_ms": pct_ms(run["appends"], 1.0),
           # summed over the writers, lock waits included
           "append_s_sum": sum(run["appends"]),
           # the threaded run's batcher numbers are b0's; the burst's
           # are the difference
           "served": st["served"], "epoch_retries": st["epoch_retries"],
           "requery": st["requery"], "batch": b0, "burst": burst_rec,
           "launches": counts["launches"],
           "sort_sizes": counts["sort_sizes"],
           "search_sizes": counts["search_sizes"],
           "merge_shapes": sorted(set(shapes[n_shapes:])),
           "width_fallbacks": counts["fallbacks"], "card": card_line()}
    print(json.dumps(rec), flush=True)
    if b0["batched_queries"] <= 0:
        fail("serving phase: no read took the batched probe")
    if burst_rec["modes"] != ["batched"]:
        fail(f"serving phase: burst reads served as {burst_rec['modes']}")
    if burst_rec["batched_queries"] <= burst_rec["device_calls"]:
        fail(f"serving phase: the burst's {burst_rec['batched_queries']} "
             f"reads took {burst_rec['device_calls']} device calls: no "
             "wave carried several anchors")
    require_launches("serving phase", counts["launches"],
                     ("probe_sorted", "merge_ranks"))

    # the oracle: every batched read, and the first, a middle and the last
    # result of each other query, each beside a numpy engine stepped
    # through the write history to the last entry bearing the result's
    # token; queries index queries + burst
    served = {}
    for _, _, qi, res in reads:
        served.setdefault(qi, []).append(res)
    served.update({len(queries) + k: [res]
                   for k, res in enumerate(burst_res)})
    picks = {}
    n_batched = 0
    for qi in range(len(queries) + len(burst)):
        results = served.get(qi)
        if not results:
            fail(f"serving phase: query {qi} was never served")
        ends = {0, len(results) // 2, len(results) - 1}
        for j, res in enumerate(results):
            if res.mode == "batched" or j in ends:
                n_batched += res.mode == "batched"
                picks.setdefault(res.token, set()).add(
                    (qi, res.checksum(), len(res.rows)))
    all_queries = queries + burst
    del served, reads, run, burst_res
    history = srv.history
    last = {tok: i for i, (_, _, tok) in enumerate(history)}
    if set(picks) - set(last):
        fail("serving phase: a served token names no write prefix")
    t0 = time.perf_counter()
    oracle = engine(engine_config("query1", {"eval_mode": "delta",
                                             "backend": "numpy"}))
    checked = 0
    for i, (kind, fs, tok) in enumerate(history):
        if kind not in ("init", "append", "delete", "materialize") or (
                fs and kind not in ("append", "delete")):
            fail(f"serving phase: history entry {i} is a {kind} the "
                 "oracle cannot replay")
        if fs:
            if kind == "append":
                oracle.insert_facts(fs)
            else:
                oracle.delete_facts(fs)
            oracle.infer()
        if last[tok] != i or tok not in picks:
            continue
        for qi, checksum, n in sorted(picks[tok]):
            want = ServedResult(oracle.query(all_queries[qi]), tok,
                                "oracle")
            if (want.checksum(), len(want.rows)) != (checksum, n):
                fail(f"serving phase: query {qi} at history entry {i} "
                     f"served {n} rows, numpy has {len(want.rows)}")
            checked += 1
    print(json.dumps({"serving_oracle": "numpy", "history": len(history),
                      "tokens_checked": len(picks),
                      "results_checked": checked,
                      "batched_reads_checked": n_batched,
                      "seconds": time.perf_counter() - t0}), flush=True)
    del oracle

    # the card's busy time over the same workload (more appends, fresh
    # student names), under the profiler: its overhead lengthens wall_s
    n_shapes = len(shapes)
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prun = serve_threads(srv, queries, seed, SERVE_APPENDS)
        torch.cuda.synchronize()
    srv.close()
    prof_counts = kernels.counts()
    add_sizes(sizes, prof_counts)
    per = device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    ours = sum(us for k, (us, _) in per.items()
               if any(n in k for n in OUR_KERNELS)) / 1e6
    copies = sum(us for k, (us, _) in per.items()
                 if "memcpy" in k.lower()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    print(json.dumps({
        "serving_profile": "query1", "reads": len(prun["reads"]),
        "appends": len(prun["appends"]), "wall_s": prun["wall_s"],
        "device_busy_s": busy if busy else "not measured",
        "idle_share": 1 - busy / prun["wall_s"] if busy else "not measured",
        "own_kernels_s": ours, "copies_s": copies,
        "sort_sizes": prof_counts["sort_sizes"],
        "search_sizes": prof_counts["search_sizes"],
        "merge_shapes": sorted(set(shapes[n_shapes:])),
        "top_device_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                               for k, (us, c) in top]}), flush=True)
    e.ops.cache.clear()
    return counts["launches"]


# runs the launcher module as ``python -m`` does (``runpy``), then prints
# the kernel launches by size and the index-mirror merge shapes of that
# process on a line of its own
# (``{module}`` is the launcher's module; ``{setup}`` runs before it and
# may add entries to ``report``)
LAUNCHER_CHILD = """\
import atexit, json, runpy, sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch import kernels
from repro_torch.backend import torch_ops
shapes, _ = chip_smoke.merge_shapes(torch_ops)
report = {{}}
{setup}
atexit.register(lambda: print("launcher_kernels " + json.dumps(
    {{**kernels.counts(), "merge_shapes": sorted(set(shapes)), **report}}),
    flush=True))
sys.argv[0] = {module!r}
runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
"""


def launcher_env() -> dict:
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def launcher_child(module: str, setup: str = "") -> str:
    return LAUNCHER_CHILD.format(root=str(ROOT), src=str(ROOT / "src"),
                                 module=module, setup=setup)


def launcher_phase(sizes: dict, shapes: list, backend: str = "torch",
                   runs=(("delta", 1), ("demand", 1))) -> None:
    """``python -m repro_torch.launch.serve`` on the card, once per
    ``(eval_mode, shards)`` of ``runs`` (by default ``delta`` and
    ``demand`` on one shard): each must exit 0 and print its ``served
    ... qps`` line.  The module runs through ``runpy`` in a child that
    reports its kernel launches by size and its merge shapes, which are
    added to ``sizes`` and ``shapes``."""
    env = launcher_env()
    child = launcher_child("repro_torch.launch.serve")
    for mode, shards in runs:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", child,
             "--backend", backend, "--eval-mode", mode, "--chains", "8",
             "--hops", "8", "--writers", "2", "--readers", "4",
             "--write-ops", "6", "--reads", "12", "--shards", str(shards)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        lines = res.stdout.strip().splitlines()
        served = [ln for ln in lines if re.match(
            r"served \d+ reads in [\d.]+s \([\d.]+ qps\)", ln)]
        counts = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                  if ln.startswith("launcher_kernels ")]
        print(json.dumps({"launcher": "repro_torch.launch.serve",
                          "eval_mode": mode, "shards": shards,
                          "rc": res.returncode,
                          "seconds": time.perf_counter() - t0,
                          "stdout": [ln for ln in lines if not
                                     ln.startswith("launcher_kernels ")],
                          "kernels": counts[0] if counts else None}),
              flush=True)
        if res.returncode != 0 or not served or not counts:
            fail(f"launcher ({mode}, {shards} shards): rc "
                 f"{res.returncode}, stderr {res.stderr[-400:]!r}")
        add_sizes(sizes, counts[0])
        shapes.extend(tuple(s) for s in counts[0]["merge_shapes"])


# the sharded phase: shard workers of each run; the closure's chains,
# nodes per chain and capacities (per shard: 129,024 pairs over 4 shards)
SHARDS = 4
CLOSURE_CHAINS, CLOSURE_NODES = 64, 64
CLOSURE_CAPS = {"edge_cap": 1 << 16, "delta_cap": 1 << 13,
                "slot_cap": 1 << 12, "join_cap": 1 << 13}
# the launches each sharded run must show (run 2 adds the merge ranks of
# its AI mirrors and the sketch planner's unique mask)
SHARDED_KERNELS = ("bitonic_sort", "bitonic_sort_kv", "probe_sorted")


def timed_exchange(e) -> dict:
    """Wrap a sharded engine's ``exchange.exchange`` to sum its wall time
    (the device path ends in copies to the host, so the time includes
    the card's work); returns the running totals."""
    acc = {"calls": 0, "seconds": 0.0}
    inner = e.exchange.exchange

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        acc["seconds"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out
    e.exchange.exchange = timed
    return acc


def exchange_totals(logs) -> dict:
    return {"flushes": len(logs),
            "rows_exchanged": sum(log["rows"] for log in logs),
            "payload_bytes": sum(log["payload_bytes"] for log in logs),
            "padded_bytes": sum(log["padded_bytes"] for log in logs),
            "payload_bytes_wire": sum(log["payload_bytes_wire"]
                                      for log in logs),
            "padded_bytes_wire": sum(log["padded_bytes_wire"]
                                     for log in logs),
            "max_slot_cap": max((log["slot_cap"] for log in logs),
                                default=0),
            "device_flushes": sum(bool(log["device"]) for log in logs)}


def release(e) -> None:
    """Free a sharded engine's device caches (parent and workers)."""
    for ops in [e.ops] + [w.ops for w in e.workers]:
        ops.cache.clear()


def sharded_run(torch, label: str, preset: str, overrides: dict, facts,
                queries, devices, sizes: dict, shapes: list,
                append=None) -> dict:
    """One ``shards=SHARDS`` run on the card: load ``facts``, ``infer()``
    (then, with ``append``, insert that batch and ``infer()`` again; no
    ``infer()`` under demand) and ask ``queries``; the kernel counts are reset just before the load
    and read just after the queries.  ``devices`` given, the exchange is
    the device transport over them; else the engine's default.  Prints
    the run's line (rounds, rows and bytes exchanged, the exchange's
    time, the critical path, load/infer/query seconds, launches, sizes)
    and adds its launches by size to ``sizes``.  Returns the engine and
    its results."""
    from repro_torch import kernels
    from repro_torch.core import HiperfactEngine
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import ShardedEngine, decoded_fact_checksum
    from repro_torch.distributed.pipeline import FrontierExchange

    cfg = engine_config(preset, {**overrides, "shards": SHARDS})
    e = HiperfactEngine(cfg)
    if not isinstance(e, ShardedEngine) or len(e.workers) != SHARDS:
        fail(f"sharded {label}: shards={SHARDS} built {type(e).__name__}")
    if devices is not None:
        e.exchange = FrontierExchange(SHARDS, compress=e.exchange.compress,
                                      devices=devices)
    acc = timed_exchange(e)
    e.add_rules(rdfs_plus_rules())
    n_shapes = len(shapes)
    kernels.reset_counts()  # this sharded run starts here
    t0 = time.perf_counter()
    e.insert_facts(facts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # demand never infers: each query materializes its own cone
    infers = [] if cfg.eval_mode == "demand" else [e.infer()]
    if append is not None:
        e.insert_facts(append)
        infers.append(e.infer())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rows = row_sets(e, queries)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = kernels.counts()  # ... and ends here
    add_sizes(sizes, counts)
    st = e.last_infer
    rounds = [r for s in infers for r in s.rounds]
    out = {"engine": e, "rows": rows, "checksum": decoded_fact_checksum(e),
           "facts_inferred": [s.facts_inferred for s in infers],
           "launches": counts["launches"]}
    rec = {"sharded": label, "shards": SHARDS, "preset": preset,
           "eval_mode": cfg.eval_mode, "sort_mode": cfg.sort_mode,
           "compress": e.workers[0].ops.compress,
           "wire_compress": e.exchange.compress,
           "transport": "device" if devices is not None else "default",
           "base_facts": len(facts),
           "appended": 0 if append is None else len(append),
           "load_s": t1 - t0, "infer_s": t2 - t1, "query_s": t3 - t2,
           "rounds": [s.iterations for s in infers],
           "critical_path_s": sum(r["critical_path_s"] for r in rounds),
           "worker_s_sum": sum(sum(r["worker_seconds"]) for r in rounds),
           "exchange_s": acc["seconds"], "exchange_calls": acc["calls"],
           **exchange_totals(e.exchange_log),
           "facts_inferred": out["facts_inferred"],
           "num_facts": e.num_facts(), "resident_facts": e.resident_facts(),
           "demand_rounds": st.demand_rounds,
           "demand_cone_rows": st.demand_cone_rows,
           "demand_fallbacks": st.demand_fallbacks,
           "rows": [len(r) for r in rows], "checksum": out["checksum"],
           "launches": counts["launches"],
           "sort_sizes": counts["sort_sizes"],
           "search_sizes": counts["search_sizes"],
           "merge_shapes": sorted(set(shapes[n_shapes:])),
           "width_fallbacks": counts["fallbacks"]}
    print(json.dumps(rec), flush=True)
    return out


def sharded_phase(torch, oracle: dict, seed: int, sizes: dict,
                  shapes: list) -> dict:
    """The sharded engine (``shards=SHARDS``) on the card, every run held
    against numpy: run 1 (``infer1``, full, ``oracle``'s facts) with the
    exchange's device transport over ``[cuda:0] * SHARDS`` — every flush
    on the device; run 2 (``query1`` compressed, sketch planner, delta)
    on the default transport — the host permute on one card, every flush
    saying so — then one appended batch of new students and a second
    ``infer()``, against a numpy unsharded engine stepped the same way;
    run 3 demand (``infer1``) with ``LUBM_QUERIES`` and the point
    queries, no fallback; all three over the engine phase's facts
    (``oracle``).  Then the serving
    launcher at ``--shards SHARDS`` and ``DistributedClosure`` over
    ``[cuda:0] * SHARDS`` against the closed form.  Every run adds its
    launches by size and merge shapes to ``sizes``/``shapes``.  Returns
    the runs' kernel launches."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import HiperfactEngine
    from repro_torch.core.distributed import ClosureConfig, DistributedClosure
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import decoded_fact_checksum
    from repro_torch.datasets import LUBM_QUERIES

    t_phase = time.perf_counter()
    launches = {name: 0 for name in kernels.ENGINE_KERNELS}

    def tally(label, counts, names):
        require_launches(f"sharded {label}", counts, names)
        for k in launches:
            launches[k] += counts[k]

    # run 1: the device transport at full scale
    n_q = len(LUBM_QUERIES)
    cuda0 = [torch.device("cuda", 0)] * SHARDS
    r1 = sharded_run(torch, "device", "infer1", {}, oracle["facts"],
                     LUBM_QUERIES, cuda0, sizes, shapes)
    e = r1["engine"]
    if r1["checksum"] != oracle["checksum"]:
        fail("sharded device: decoded fact checksum differs from numpy")
    if r1["facts_inferred"] != [oracle["facts_inferred"]]:
        fail(f"sharded device: facts_inferred {r1['facts_inferred']} != "
             f"{oracle['facts_inferred']} (numpy)")
    if r1["rows"] != oracle["rows"][:n_q]:
        fail("sharded device: query row sets differ from numpy")
    if not e.exchange_log or not all(log["device"]
                                     for log in e.exchange_log):
        fail("sharded device: a flush took the host permute")
    tally("device", r1["launches"], SHARDED_KERNELS)
    release(e)
    del e, r1

    # run 2: the default transport, an append, a second infer()
    rng = np.random.RandomState(seed + 7)
    batch = [f for i in range(64) for f in new_student(rng, 9, i)]
    r2 = sharded_run(torch, "default+append", "query1",
                     {"compress": True, "sort_mode": "sketch",
                      "eval_mode": "delta"}, oracle["facts"], LUBM_QUERIES,
                     None, sizes, shapes, append=batch)
    e = r2["engine"]
    if any(log["device"] for log in e.exchange_log):
        fail("sharded default+append: a flush took the device transport "
             "on one card")
    t0 = time.perf_counter()
    ref = HiperfactEngine(engine_config("query1", {"eval_mode": "delta",
                                                   "backend": "numpy"}))
    ref.add_rules(rdfs_plus_rules())
    ref.insert_facts(oracle["facts"])
    want_inferred = [ref.infer().facts_inferred]
    ref.insert_facts(batch)
    want_inferred.append(ref.infer().facts_inferred)
    want = {"checksum": decoded_fact_checksum(ref),
            "rows": row_sets(ref, LUBM_QUERIES)}
    print(json.dumps({"oracle": "numpy", "sharded": "default+append",
                      "eval_mode": "delta", "facts_inferred": want_inferred,
                      "seconds": time.perf_counter() - t0}), flush=True)
    del ref
    if r2["checksum"] != want["checksum"]:
        fail("sharded default+append: decoded fact checksum differs from "
             "numpy")
    if r2["facts_inferred"] != want_inferred:
        fail(f"sharded default+append: facts_inferred "
             f"{r2['facts_inferred']} != {want_inferred} (numpy)")
    if r2["rows"] != want["rows"]:
        fail("sharded default+append: query row sets differ from numpy")
    tally("default+append", r2["launches"],
          SHARDED_KERNELS + ("merge_ranks", "unique_mask_sorted"))
    release(e)
    del e, r2

    # run 3: demand, every query materializing its cone across the shards
    r3 = sharded_run(torch, "demand", "infer1", {"eval_mode": "demand"},
                     oracle["facts"], LUBM_QUERIES + point_queries(), None,
                     sizes, shapes)
    e = r3["engine"]
    if e.last_infer.demand_fallbacks:
        fail(f"sharded demand: {e.last_infer.demand_fallbacks} fallbacks "
             "to infer()")
    if r3["rows"] != oracle["rows"]:
        fail("sharded demand: query row sets differ from numpy")
    tally("demand", r3["launches"], SHARDED_KERNELS)
    release(e)
    del e, r3

    launcher_phase(sizes, shapes, runs=(("delta", SHARDS),))

    # the distributed closure: disjoint chains, against the closed form
    nodes = np.arange(CLOSURE_CHAINS * CLOSURE_NODES, dtype=np.int64)
    src = nodes[nodes % CLOSURE_NODES != CLOSURE_NODES - 1]
    a, b = np.triu_indices(CLOSURE_NODES, 1)
    base = np.arange(CLOSURE_CHAINS, dtype=np.int64)[:, None] * CLOSURE_NODES
    want = np.sort((((base + a) << 32) | (base + b)).ravel())
    t0 = time.perf_counter()
    got, iters = DistributedClosure(cuda0, ClosureConfig(**CLOSURE_CAPS)).run(
        src, src + 1, max_iters=2 * CLOSURE_NODES)
    torch.cuda.synchronize()
    print(json.dumps({"closure": "DistributedClosure", "shards": SHARDS,
                      "chains": CLOSURE_CHAINS, "nodes": CLOSURE_NODES,
                      "edges": len(src), "pairs": len(got),
                      "closed_form_pairs": len(want), "iterations": iters,
                      "seconds": time.perf_counter() - t0,
                      "equal": bool(np.array_equal(got, want))}),
          flush=True)
    if not np.array_equal(got, want):
        fail(f"closure: {len(got)} pairs, the closed form has {len(want)}")
    print(json.dumps({"phase": "sharded", "seconds":
                      time.perf_counter() - t_phase,
                      "launches": launches, "card": card_line()}),
          flush=True)
    return launches


# prompts (of most models) and greedy decode steps
LM_BATCH, LM_STEPS = 2, 16
# (config, its kernel's row in the kernels line, the launch counts its
# forwards raise, prompt tokens, whether its weights take the 16-bit
# store, prompts) of the LM phase.  Every attention (head dim 64, 96,
# 128 or 256) must take the tensor-core route.  2048 tokens put yi's and
# moonshot's attention on the kernel's branch (> 1024) and give mamba2 8
# chunks of 256; recurrentgemma's 4096 pass its 2048-key window, so the
# kernel's window mask and kv-tile skip run in prefill, the prefill cache
# takes the full-ring branch and every decode step overwrites a live
# slot.
# moonshot's 28.1 B parameters are 112.2 GB in the float32 store, past
# the card; the 16-bit store holds the leaves the forward casts (56.1
# GB) and computes the same bits.  whisper-tiny serves 16 clips of 1500
# encoder frames behind 432-token prompts, so 16 steps end at its
# 448-token text context: its encoder (1500 frames, non-causal) and its
# cross-attention (432 rows over 1500 frames) take the kernel, its
# decoder's self-attention (433 positions at most) the materialized
# branch.  phi-3-vision-4.2b puts 576 patch embeddings before 1472 text
# tokens: 2048 positions take the kernel's branch
LM_MODELS = [
    ("yi-6b", "flash_attention", ("flash_attention", "flash_attention_wgmma"),
     2048, False, LM_BATCH),
    ("mamba2-1.3b", "ssd_intra", ("ssd_intra",), 2048, False, LM_BATCH),
    ("recurrentgemma-9b", "flash_attention@hd256",
     ("flash_attention", "flash_attention_wgmma", "linear_scan"), 4096, False,
     LM_BATCH),
    ("moonshot-v1-16b-a3b", "flash_attention@mha",
     ("flash_attention", "flash_attention_wgmma"), 2048, True, LM_BATCH),
    ("whisper-tiny", "flash_attention@encdec",
     ("flash_attention", "flash_attention_wgmma"), 432, False, 16),
    ("phi-3-vision-4.2b", "flash_attention@hd96",
     ("flash_attention", "flash_attention_wgmma"), 1472, False, LM_BATCH)]
LM_COUNTS = ("flash_attention", "flash_attention_wgmma", "ssd_intra",
             "linear_scan")
# the kernel rows ``lm_kernel_rows`` builds with its ``attention_row``
ATTENTION_ROWS = ("flash_attention@mha", "flash_attention@encdec",
                  "flash_attention@hd96")
# the block kinds whose forward launches attention or the SSD kernel (a
# MoE block launches attention, and its dispatch is stock torch ops, as
# the reference's is XLA); an RG-LRU block launches the scan kernel
# (``scan_layers``), where the reference runs XLA's associative scan
KERNEL_KINDS = ("attn", "local", "ssm", "moe")


def kernel_layers(cfg) -> int:
    """Layers whose forward launches an LM kernel once at the LM phase's
    shapes, from the config alone: every attention, local-attention, MoE
    and SSD block; for the enc-dec family each encoder layer (over its
    1500 frames) and each decoder layer's cross-attention onto them (its
    decoder's self-attention, at most 433 positions, materializes)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    return sum(k.value in KERNEL_KINDS for k in cfg.block_kinds())


def scan_layers(cfg) -> int:
    """RG-LRU blocks, from the config alone: each forward's sequence form
    launches ``linear_scan`` once in each."""
    return sum(k.value == "rglru" for k in cfg.block_kinds())


def lm_inputs(torch, cfg, seed: int, batch: int) -> dict:
    """What a family's prefill takes besides its tokens, drawn from
    ``seed`` with numpy at the reference test's 0.02 scale, float32 on
    the card: the enc-dec family's encoder frames [B, enc_seq, d], the
    VLM's patch embeddings [B, n_patches, d]; nothing for the others."""
    import numpy as np

    name, n = {"encdec": ("frames", cfg.enc_seq),
               "vlm": ("patches", cfg.n_patches)}.get(cfg.family, ("", 0))
    if not name:
        return {}
    r = np.random.RandomState(seed + 2)
    return {name: torch.tensor((r.randn(batch, n, cfg.d_model) * 0.02)
                               .astype(np.float32), device="cuda")}


def prefix_len(extra: dict) -> int:
    """Positions in front of the tokens: the VLM's patches."""
    return extra["patches"].shape[1] if "patches" in extra else 0


def check_logits(torch, model, params, ext, at: int, extra: dict):
    """Logits of the sequence form of the forward over ``ext`` at token
    ``at``: ``encode`` feeding ``_decoder_hidden`` for the enc-dec family,
    else ``hidden()``, behind the VLM's patches, which shift the
    position."""
    with torch.no_grad():
        if "frames" in extra:
            h, _ = model._decoder_hidden(params, ext,
                                         model.encode(params,
                                                      extra["frames"]))
        else:
            h, _, _ = model.hidden(params, ext, **extra)
        return model._logits(params, h[:, prefix_len(extra) + at, :])


def lm_phase(torch, seed: int, steps: int, models=LM_MODELS) -> dict:
    """Greedy serving of each LM at full width; returns, for each LM
    kernel row, its launches over its model's run and their routes."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, init_params, param_bytes,
                                    param_count)
    from repro_torch.models import moe
    from repro_torch.models.params import store_spec

    launches = {}
    for arch, row, own, seq, sixteen, batch in models:
        cfg = get_config(arch)
        store = cfg.dtype if sixteen else None
        model = build_model(cfg)
        spec = model.spec()
        t0 = time.perf_counter()
        params = init_params(spec, seed, store=store)
        seed_conv_taps(torch, params, seed)
        torch.cuda.synchronize()
        print(json.dumps({"lm": arch, "layers": cfg.n_layers,
                          "d_model": cfg.d_model, "d_ff": cfg.d_ff,
                          "vocab": cfg.vocab, "heads": [cfg.n_heads,
                                                        cfg.n_kv_heads],
                          "head_dim": cfg.head_dim, "window": cfg.window,
                          "experts": [cfg.n_experts, cfg.top_k],
                          "capacity_factor": cfg.capacity_factor,
                          "enc_layers": cfg.n_enc_layers,
                          "dtype": cfg.dtype,
                          "store": store or "float32",
                          "params": param_count(spec),
                          # ArchConfig.param_count(): whisper's leaves out
                          # its biases, norm offsets and pad rows
                          "params_analytic": cfg.param_count(),
                          "param_gb": param_bytes(store_spec(spec, store))
                          / 1e9,
                          "param_gb_float32_store": param_bytes(spec) / 1e9,
                          "init_s": time.perf_counter() - t0}), flush=True)
        prompts = torch.tensor(np.random.RandomState(seed).randint(
            0, cfg.vocab, (batch, seq)).astype(np.int32), device="cuda")
        extra = lm_inputs(torch, cfg, seed, batch)
        pre = prefix_len(extra)
        torch.cuda.reset_peak_memory_stats()
        moe.reset_dropped()
        kernels.reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, prompts, pre + seq + steps,
                                         **extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dropped = {"prefill": moe.dropped_pairs()}
        moe.reset_dropped()
        tok = logits.argmax(-1)
        first = None
        step_ms = []
        for i in range(steps):
            ts = time.perf_counter()
            step, cache = model.decode_fn(params, tok, cache)
            first = step if first is None else first
            tok = step.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
        t2 = time.perf_counter()
        dropped["decode_steps"] = moe.dropped_pairs()
        moe.reset_dropped()
        # consistency: the sequence form over the prompt and the first
        # greedy token, against the first decode step's logits
        ext = torch.cat([prompts, logits.argmax(-1)[:, None].to(
            prompts.dtype)], dim=1)
        ref = check_logits(torch, model, params, ext, seq, extra)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = kernels.counts()["launches"]  # ... and ends here
        dropped["check"] = moe.dropped_pairs()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lens = cache["lens"].tolist()
        pair = {"err": float((first.float() - ref.float()).abs().max()),
                "scale": float(ref.float().abs().max()), "ref": ref.float(),
                "dropped": dropped["prefill"] + dropped["check"]}
        del cache
        gated = gated_consistency(torch, cfg, params, ext, seq, pair, extra)
        g16, g32 = gated["bfloat16"], gated["float32"]
        err, err32 = g16["err"], g32["err"]
        bound = 3e-2 * max(1.0, g16["scale"])
        bound32 = 1e-3 * max(1.0, g32["scale"])
        # the served bf16 forward against the float32 one on the same
        # weights, both routing freely at the gated capacity (the float32
        # path is the one the CPU tests hold to the reference at 1e-4): a
        # reading, with no bound at full depth
        free = gated.get("bfloat16_free", g16)
        bf16_vs_f32 = float((free["ref"] - g32["ref"]).abs().max())
        finite = bool(torch.isfinite(logits).all()
                      and torch.isfinite(first).all())
        line = {
            "lm": arch, "batch": batch, "prompt": seq, "decode_steps": steps,
            "inputs": {k: list(v.shape) for k, v in extra.items()},
            "prefill_s": t1 - t0,
            "decode_ms_per_token": (t2 - t1) / steps * 1e3,
            "decode_ms_first": step_ms[0],
            "decode_ms_median": statistics.median(step_ms),
            "decode_ms_steps": step_ms,
            "generated_tokens_per_s": batch * steps / (t2 - t1),
            "forward_s": t3 - t2,
            "peak_device_gb": peak_gb,
            "logits_shape": list(logits.shape), "finite": finite,
            "consistency_err": err, "consistency_bound": bound,
            "f32_consistency_err": err32, "f32_consistency_bound": bound32,
            "bf16_vs_f32_err": bf16_vs_f32,
            "bf16_vs_f32_rel": bf16_vs_f32 / max(1.0, g32["scale"]),
            "cache_lens": lens,
            "launches": {k: counts[k] for k in LM_COUNTS}}
        if cfg.family == "moe":
            line.update({
                "dropped_pairs": dropped,
                "consistency_gated": ("configured" if gated["capacity_factor"]
                                      == cfg.capacity_factor
                                      else "no_drop_repeat"),
                "consistency_capacity_factor": gated["capacity_factor"],
                "consistency_routing": "bf16 pinned at the compared tokens, "
                                       "float32 free",
                "bf16_free_consistency_err": free["err"],
                "routing_flips": {"bfloat16_free": free["flips"],
                                  "float32": g32["flips"]},
                "consistency_configured": gated["configured"]})
        del gated, g16, g32, free
        print(json.dumps(line), flush=True)
        if not finite or list(logits.shape) != [batch, cfg.vocab]:
            fail(f"{arch}: logits {list(logits.shape)}, finite={finite}")
        if err > bound or err32 > bound32:
            fail(f"{arch}: decode logits differ from the forward by {err} "
                 f"(bound {bound}; float32: {err32}, bound {bound32})")
        if lens != [pre + seq + steps] * batch:
            fail(f"{arch}: cache lens {lens}")
        if peak_gb >= 80:
            fail(f"{arch}: peak device memory {peak_gb} GB, past one card")
        # two forwards ran (the prefill and the check), each launching
        # the model's kernel once per kernel layer, and the scan kernel
        # once per RG-LRU layer
        per = {k: (scan_layers(cfg) if k == "linear_scan"
                   else kernel_layers(cfg)) for k in LM_COUNTS}
        want = {k: (2 * per[k] if k in own else 0) for k in LM_COUNTS}
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"{arch}: LM kernel launches {got}, expected {want}")
        tc = counts["flash_attention_wgmma"]
        launches[row] = {"launches": counts[own[0]], "routes": {
            "wgmma": tc, "simt": counts["flash_attention"] - tc}}
        if "linear_scan" in own:
            launches["linear_scan"] = {"launches": counts["linear_scan"]}
        del logits, first, step, ref
        lm_prefill_profile(torch, arch, model, params, prompts, extra)
        lm_profile(torch, arch, model, params, prompts, extra)
        del params, model, extra
        torch.cuda.empty_cache()
    return launches


def seed_conv_taps(torch, params, seed: int) -> None:
    """Draw the conv taps and bias of every SSM and RG-LRU block, in the
    stacked groups (``b0``, ``b1``, ... in order) and then the tail, from
    one generator seeded with ``seed + 1``, as upstream initializes a
    depthwise ``nn.Conv1d`` of width W: uniform in +-1/sqrt(W).  The
    reference's specs initialize them to zeros, which makes every SSM
    block of a fresh model output exactly 0 and every RG-LRU block's
    conv output its bias alone (0): the block would carry no signal and
    the consistency check would prove nothing.  A dense or MoE model has
    no such block and is left as it is, as is an enc-dec or VLM one."""
    gen = None
    groups = params.get("blocks", {})  # the enc-dec tree has none
    for blk in (*(groups[g] for g in sorted(groups)),
                *params.get("tail", [])):
        for kind in ("ssm", "rglru"):
            if kind not in blk:
                continue
            conv = blk[kind]
            if gen is None:
                gen = torch.Generator(device=conv["conv_w"].device)
                gen.manual_seed(seed + 1)
            bound = 1.0 / conv["conv_w"].shape[-2] ** 0.5  # [.., W, ch]
            for name in ("conv_w", "conv_b"):
                conv[name].uniform_(-bound, bound, generator=gen)


class RouteProbe:
    """Stands in for ``moe._route`` while a consistency pair runs.  In
    the decode step (``mode = "decode"``) it keeps each MoE layer's
    router probabilities; in the check forward (``mode = "check"``) it
    counts the (layer, row) pairs whose top-k experts at the compared
    tokens (flat ``rows``) differ from the decode step's, and with
    ``pin`` gives those tokens the decode step's probabilities, so both
    forwards route them alike."""

    def __init__(self, torch, moe, k: int, rows: list, pin: bool):
        self.torch, self.moe, self.route = torch, moe, moe._route
        self.k, self.rows, self.pin = k, rows, pin
        self.mode, self.decided, self.flips, self.layer = None, [], 0, 0

    def __enter__(self):
        self.moe._route = self
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def top(self, p):
        return self.torch.topk(p, self.k).indices.sort(-1).values

    def __call__(self, xf, w):
        p = self.route(xf, w)
        if self.mode == "decode":
            self.decided.append(p)
        elif self.mode == "check":
            want = self.decided[self.layer]
            self.layer += 1
            self.flips += int((self.top(p[self.rows]) != self.top(want))
                              .any(-1).sum())
            if self.pin:
                p = p.clone()
                p[self.rows] = want
        return p


def consistency_pair(torch, cfg, params, ext, seq: int, pin: bool = False,
                     extra: dict | None = None) -> dict:
    """Decode after a prefill of ``seq`` tokens against the sequence form
    over ``seq + 1`` (``check_logits``; both take ``extra``, the frames
    or patches), in ``cfg.dtype`` on the given weights (``cfg.dtype``
    only sets the compute type).  Returns the max abs error ``err``, the
    forward's max |logit| ``scale`` and float32 logits at position
    ``seq`` (``ref``), the MoE pairs the three forwards dropped, and the
    (layer, row) pairs whose experts differ between the step and the
    forward at the compared tokens (``flips``; with ``pin`` the forward
    takes the step's routing there)."""
    from repro_torch.models import build_model, moe

    model = build_model(cfg)
    B = ext.shape[0]
    extra = extra or {}
    pre = prefix_len(extra)
    rows = [b * (pre + seq + 1) + pre + seq for b in range(B)]
    moe.reset_dropped()
    with torch.no_grad(), RouteProbe(torch, moe, cfg.top_k, rows,
                                     pin) as probe:
        _, cache = model.prefill_fn(params, ext[:, :seq], pre + seq + 1,
                                    **extra)
        probe.mode = "decode"
        step = model.decode_fn(params, ext[:, seq], cache)[0]
        del cache
        probe.mode, probe.layer = "check", 0
        ref = check_logits(torch, model, params, ext, seq, extra).float()
    return {"err": float((step.float() - ref).abs().max()),
            "scale": float(ref.abs().max()), "ref": ref,
            "dropped": moe.dropped_pairs(), "flips": probe.flips}


def gated_consistency(torch, cfg, params, ext, seq: int, pair,
                      extra: dict) -> dict:
    """The consistency check in bf16 (``pair``: the served run's first
    decode step against its check forward) and again with the same
    weights in float32, where the two differ by reassociation only, so a
    fault that the bf16 bound could hide shows.  Returns the gated
    pairs under "bfloat16" and "float32".

    A MoE model needs two more steps.  (1) A forward drops the pairs
    past an expert's capacity, and the prefill over ``seq`` tokens and
    the forward over ``seq + 1`` may drop different ones (the extra
    token shifts the second row's places in its experts' runs), so where
    either configured pair dropped any, the pairs run again at capacity
    factor E / k, where none can drop.  (2) Top-k routing is
    discontinuous: in bf16 the step's and the forward's rounding differ
    by an ulp or so, enough to flip an expert choice where two
    probabilities nearly tie, and one flipped choice moves the logits by
    far more than the bound.  So the gated bf16 pair routes the compared
    tokens in the forward as the step routed them (``pin``), and the
    pair with free routing is a reading (``bfloat16_free``, with its
    ``flips``); float32 routes freely and is gated."""
    import dataclasses

    f32 = consistency_pair(torch, dataclasses.replace(cfg, dtype="float32"),
                           params, ext, seq, extra=extra)
    out = {"bfloat16": pair, "float32": f32}
    if cfg.family != "moe":
        return out
    out["configured"] = {
        "capacity_factor": cfg.capacity_factor,
        "err": pair["err"], "bound": 3e-2 * max(1.0, pair["scale"]),
        "dropped": pair["dropped"], "f32_err": f32["err"],
        "f32_bound": 1e-3 * max(1.0, f32["scale"]),
        "f32_dropped": f32["dropped"], "f32_flips": f32["flips"]}
    gate = cfg
    if pair["dropped"] or f32["dropped"]:
        gate = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
        out["float32"] = consistency_pair(
            torch, dataclasses.replace(gate, dtype="float32"), params, ext,
            seq, extra=extra)
    out["capacity_factor"] = gate.capacity_factor
    out["bfloat16_free"] = consistency_pair(torch, gate, params, ext, seq,
                                            extra=extra)
    out["bfloat16"] = consistency_pair(torch, gate, params, ext, seq,
                                       pin=True, extra=extra)
    for name in ("bfloat16", "bfloat16_free", "float32"):
        if out[name]["dropped"]:
            fail(f"{cfg.name}: {out[name]['dropped']} pairs dropped at "
                 f"capacity factor {gate.capacity_factor} ({name})")
    return out


def lm_profile(torch, arch: str, model, params, prompts, extra: dict,
               steps: int = 4):
    """Device time of ``steps`` decode steps under ``torch.profiler``,
    against a fresh prefill of the prompts' first 256 tokens (behind
    ``extra``'s frames or patches; outside the window): the device busy
    share of a decode step and its top kernels.  The profiler's overhead
    lengthens ``wall_s``, so ``idle_share`` is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    short = prompts[:, :256]
    logits, cache = model.prefill_fn(
        params, short, prefix_len(extra) + short.shape[1] + steps, **extra)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step, cache = model.decode_fn(params, tok, cache)
            tok = step.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "lm_profile": arch, "decode_steps": steps, "wall_s": wall,
        "device_busy_s": busy if busy else "not measured",
        "idle_share": 1 - busy / wall if busy else "not measured",
        "device_kernels": sum(c for _, c in per.values()),
        "top_device_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                               for k, (us, c) in top]}), flush=True)


def lm_prefill_profile(torch, arch: str, model, params, prompts,
                       extra: dict):
    """One more prefill of the prompts (and ``extra``) under
    ``torch.profiler``: the device busy share and top kernels, the
    attention kernels' device time (``flash_kernel``/``flash_tc``) and
    its share of the busy time, and for a model with RG-LRU blocks the
    scan kernel's device time in the profile, one layer's linear scan at
    the prefill's shape timed apart (CUDA events; the serving route, the
    kernel) beside the plain passes, and its share of the prefill over all
    such layers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rglru_scan.scan import linear_scan_plain
    from repro_torch.models import rglru

    seq = prompts.shape[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill_fn(params, prompts, prefix_len(extra) + seq + 1,
                         **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = device_events(prof)
    busy = sum(us for us, _ in per.values()) / 1e6
    attn = sum(us for k, (us, _) in per.items() if "flash" in k) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    line = {"lm_prefill_profile": arch, "wall_s": wall,
            "device_busy_s": busy if busy else "not measured",
            "idle_share": 1 - busy / wall if busy else "not measured",
            "attention_device_ms": attn if busy else "not measured",
            "attention_share_of_busy": (attn / (busy * 1e3) if busy
                                        else "not measured"),
            "top_device_kernels": [{"name": k[:80], "ms": us / 1e3,
                                    "calls": c} for k, (us, c) in top]}
    cfg = model.cfg
    n_rec = sum(k.value == "rglru" for k in cfg.block_kinds())
    if n_rec:
        shape = (prompts.shape[0], seq, cfg.d_model)
        a = torch.rand(shape, device="cuda") * 0.1 + 0.9
        b = torch.randn(shape, device="cuda")
        scan_ms = time_ms(torch, lambda: rglru._linear_scan(a, b), 5)
        scan_dev = sum(us for k, (us, _) in per.items()
                       if "linear_scan" in k) / 1e3
        line.update({
            "recurrent_layers": n_rec, "scan_ms": scan_ms,
            "scan_plain_ms": time_ms(torch, lambda: linear_scan_plain(a, b),
                                     5),
            "scan_device_ms": scan_dev if busy else "not measured",
            "scan_share_of_prefill": n_rec * scan_ms / (wall * 1e3)})
        del a, b
    print(json.dumps(line), flush=True)


# -- training phase -----------------------------------------------------------

# (config, layers kept (None: all of them), batch, text tokens) of the
# training phase.  Widths are the configs' own.  The float32 store's
# training state (weight, gradient, m and v: 16 bytes a parameter) of
# yi-6b (97.0 GB), moonshot-v1-16b-a3b (448.9 GB) and recurrentgemma-9b
# (167.1 GB) does not fit on one card: yi-6b runs 4 of 32 layers (1.22 B
# parameters), moonshot 2 of 48 (1.81 B), recurrentgemma one group of its
# pattern (RG-LRU, RG-LRU, local attention: 2.75 B with its untied
# 256k-row embedding and head).  phi-3-vision-4.2b's (61.1 GB) would,
# barely; it runs 2 of 32 to keep the phase short.  mamba2-1.3b and
# whisper-tiny run whole.  recurrentgemma's 4096 tokens pass its
# 2048-key window; whisper's 448 tokens are its text context (over 1500
# encoder frames), phi-3-vision's 1472 follow its 576 patches
TRAIN_MODELS = [("yi-6b", 4, 2, 2048), ("mamba2-1.3b", None, 2, 2048),
                ("moonshot-v1-16b-a3b", 2, 2, 2048),
                ("recurrentgemma-9b", 3, 2, 4096),
                ("whisper-tiny", None, 4, 448),
                ("phi-3-vision-4.2b", 2, 2, 1472)]
TRAIN_STEPS = 8
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 16}
# the gradient check: (L(p + eps d) - L(p - eps d)) / 2 eps against
# <g, d> in float32 with TF32 off; d is drawn leaf by leaf from a seeded
# generator as N(0, 1) times the leaf's rms (at least 0.02), so eps is a
# relative step of every weight.  The loss's third-order term along d
# grows with the parameters perturbed (at eps = 1e-2 it is 3-14 % of
# <g, d> at these widths), its float32 rounding with fewer: at 1e-3 both
# stay under 4e-3 in every config (``tools/train_probe.py`` sweeps the
# step), and ``rel_err_half_eps`` reads the same at eps / 2
GRAD_EPS = 1e-3
GRAD_TOL = 1e-2
# accum=2 against accum=1 (yi-6b, float32): the loss at the reference
# test's bound; the two steps' updates (new weights less the old) within
# ACCUM_UPDATE_TOL of the update's L2 norm.  Adam's first step moves a
# weight by lr * g / (|g| + eps), about lr in sign, so a weight whose
# gradient lies near eps = 1e-8 moves by a fraction that the float32
# noise between the two summations of its gradient can shift by much of
# lr: the largest single difference is a reading (``max_over_lr``)
ACCUM_LOSS_TOL = 1e-3
ACCUM_UPDATE_TOL = 2e-3


def train_config(arch: str, layers):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def train_batch(torch, cfg, seed: int, batch: int, seq: int,
                device="cuda") -> dict:
    """``batch`` rows of ``seq`` random text tokens and labels (numpy,
    from ``seed``) with the family's frames or patches (``lm_inputs``).
    Where the positions (patches included) are not a multiple of
    ``cfg.logit_chunk`` (whisper: 448 over chunks of 256) the rows are
    padded to one with token 0 and label -1: the decoder is causal and
    ``chunked_ce`` skips label -1, so the loss is the unpadded one."""
    import numpy as np

    r = np.random.RandomState(seed + 3)
    toks = r.randint(0, cfg.vocab, (batch, seq))
    labels = r.randint(0, cfg.vocab, (batch, seq))
    extra = lm_inputs(torch, cfg, seed, batch)
    pad = -(prefix_len(extra) + seq) % cfg.logit_chunk
    toks = np.pad(toks, ((0, 0), (0, pad)))
    labels = np.pad(labels, ((0, 0), (0, pad)), constant_values=-1)
    return {"tokens": torch.tensor(toks.astype(np.int32), device=device),
            "labels": torch.tensor(labels.astype(np.int32), device=device),
            **{k: v.to(device) for k, v in extra.items()}}


def fresh_params(torch, model, seed: int, device="cuda"):
    """The float32 store from ``seed``, conv taps drawn as upstream's."""
    from repro_torch.models import init_params
    params = init_params(model.spec(), seed, device=device)
    seed_conv_taps(torch, params, seed)
    return params


def sorted_map(fn, tree):
    """``fn`` over the leaves in ``tree_leaves``' order (dict keys
    sorted), into a tree of the same layout."""
    if isinstance(tree, dict):
        return {k: sorted_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sorted_map(fn, v) for v in tree)
    return fn(tree)


class PinnedRouting:
    """Stands in for ``moe._top_k`` while the gradient check runs: with
    ``mode = "record"`` it keeps each MoE layer's expert ids, with
    ``"replay"`` it gives the layers those ids (and the probabilities at
    them) in turn.  Top-k routing and the capacity drops are piecewise
    constant in the weights; pinned, a perturbed forward stays on the
    base forward's piece, where the loss is smooth and ``<g, d>`` is its
    derivative."""

    def __init__(self, moe):
        self.moe, self.top_k = moe, moe._top_k
        self.mode, self.ids, self.at = None, [], 0

    def __enter__(self):
        self.moe._top_k = self
        return self

    def __exit__(self, *exc):
        self.moe._top_k = self.top_k

    def __call__(self, probs, k):
        if self.mode == "replay":
            idx = self.ids[self.at]
            self.at += 1
            return probs.gather(-1, idx), idx
        w, idx = self.top_k(probs, k)
        if self.mode == "record":
            self.ids.append(idx)
        return w, idx


class Float64Sums:
    """Stands in for ``chunked_ce`` (in ``models/transformer.py`` and
    ``models/encdec.py``, whose ``loss_fn`` call it) while the gradient
    check evaluates the loss on either side: the same per-token NLL
    (``transformer.chunk_nll``), summed in float64.  The float32 sum of
    ~4096 NLLs near ln V ~ 11 rounds the loss by a few 1e-6, as much as
    the difference it must resolve; summed in float64 the loss keeps
    only the forward's own float32 rounding, which averages over the
    tokens."""

    def __init__(self, torch):
        from repro_torch.models import encdec, transformer
        self.torch, self.mods = torch, (transformer, encdec)
        self.ce, self.nll = transformer.chunked_ce, transformer.chunk_nll

    def __enter__(self):
        for m in self.mods:
            m.chunked_ce = self
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.chunked_ce = self.ce

    def __call__(self, h, head_w, labels, chunk, n_vocab=0):
        chunk = min(chunk, h.shape[1])
        w, labels = head_w.to(h.dtype), labels.long()
        tot = sum(self.nll(h[:, s:s + chunk], w, labels[:, s:s + chunk],
                           n_vocab).double().sum()
                  for s in range(0, h.shape[1], chunk))
        return tot, (labels >= 0).sum().to(self.torch.int32)


def grad_check(torch, model, params, data, seed: int,
               eps: float = GRAD_EPS, device="cuda") -> dict:
    """The central difference of ``model.loss_fn`` along a random
    direction d against ``<g, d>`` (autograd's gradient, as the train
    step takes it), at ``params``, on the model's own compute type (the
    caller passes a float32 one).  d is drawn from one seed, leaf by
    leaf, each time it is needed, so only one leaf of it is held at a
    time."""
    from repro_torch.models import moe
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import loss_and_grads

    scales = [max(float(p.float().pow(2).mean().sqrt()), 0.02)
              for p in tree_leaves(params)]

    def directions():
        gen = torch.Generator(device=device).manual_seed(seed + 4)
        for p, s in zip(tree_leaves(params), scales):
            yield torch.randn(p.shape, generator=gen, device=device).mul_(s)

    with PinnedRouting(moe) as pin:
        pin.mode = "record"
        with torch.no_grad():
            base = float(model.loss_fn(params, data)[0])
        pin.mode = None
        loss, _, grads = loss_and_grads(model, params, data)
        gd = sum(float(torch.sum(g * d, dtype=torch.float64))
                 for g, d in zip(tree_leaves(grads), directions()))
        del grads
        side = []
        for step in (eps, -eps, eps / 2, -eps / 2):
            d = directions()
            shifted = sorted_map(lambda p: p + step * next(d), params)
            pin.mode, pin.at = "replay", 0
            with torch.no_grad(), Float64Sums(torch):
                side.append(float(model.loss_fn(shifted, data)[0]))
            del shifted
        pinned = len(pin.ids)
    fd = (side[0] - side[1]) / (2 * eps)
    fd_half = (side[2] - side[3]) / eps   # a reading: the convergence

    def rel(x):
        return abs(x - gd) / max(abs(gd), 1e-30)
    return {"eps": eps, "loss": float(loss), "loss_no_grad": base,
            "loss_plus": side[0], "loss_minus": side[1],
            "central_difference": fd, "directional_derivative": gd,
            "rel_err": rel(fd), "tol": GRAD_TOL,
            "rel_err_half_eps": rel(fd_half), "pinned_moe_layers": pinned}


def accum_check(torch, model, seed: int, data, device="cuda") -> dict:
    """One train step with ``accum=2`` against one with ``accum=1`` from
    the same fresh weights, on ``model``'s compute type (float32)."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)

    out = []
    for accum in (1, 2):
        state = init_train_state(fresh_params(torch, model, seed, device))
        state, met = build_train_step(model, OptimizerConfig(**TRAIN_OPT),
                                      accum)(state, data)
        out.append((state["params"], float(met["loss"]), float(met["lr"])))
        del state
    (p1, l1, lr), (p2, l2, _) = out
    diff = norm = worst = 0.0
    for a, b, p0 in zip(tree_leaves(p1), tree_leaves(p2), tree_leaves(
            fresh_params(torch, model, seed, device))):
        diff += float(torch.sum((a - b).double() ** 2))
        norm += float(torch.sum((a - p0).double() ** 2))
        worst = max(worst, float((a - b).abs().max()))
    return {"loss_accum1": l1, "loss_accum2": l2,
            "loss_err": abs(l1 - l2), "loss_tol": ACCUM_LOSS_TOL,
            "update_rel_err": (diff / norm) ** 0.5,
            "update_tol": ACCUM_UPDATE_TOL, "max_over_lr": worst / lr,
            "lr": lr}


def refuse_gradient(torch) -> None:
    """Each LM kernel's wrapper, handed a CUDA tensor that requires grad,
    raises and launches nothing (its kernel has no backward)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.rglru_scan.scan import linear_scan
    from repro_torch.kernels.ssd.ssd import ssd_intra

    def req(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda").to(dtype).requires_grad_()
    cum = torch.cumsum(-torch.rand(1, 2, 32, 2, device="cuda"), 2)
    calls = {"flash_attention": (flash_attention, [
        req(1, 64, 2, 64, dtype=torch.bfloat16) for _ in range(3)]),
        "ssd_intra": (ssd_intra, [cum.requires_grad_(),
                                  req(1, 2, 32, 2, 16), req(1, 2, 32, 16),
                                  req(1, 2, 32, 16)]),
        "linear_scan": (linear_scan, [req(2, 64, 32), req(2, 64, 32)])}
    for name, (fn, args) in calls.items():
        before = kernels.LAUNCHES[name]
        try:
            fn(*args)
        except RuntimeError as e:
            if "training route" not in str(e):
                fail(f"{name}: a tensor that requires grad raised {e!r}")
        else:
            fail(f"{name} took a tensor that requires grad")
        if kernels.LAUNCHES[name] != before:
            fail(f"{name} launched on a tensor that requires grad")


def train_phase(torch, seed: int, models=TRAIN_MODELS,
                steps: int = TRAIN_STEPS, device="cuda") -> None:
    """Train each config in turn on the card (module docstring, phase 5):
    the gradient check, accumulation (yi-6b), ``steps`` AdamW steps on one
    fixed batch; every gate fatal."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, param_count
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)

    t_phase = time.perf_counter()
    refuse_gradient(torch)
    for arch, layers, batch, seq in models:
        cfg = train_config(arch, layers)
        model = build_model(cfg, device=device)
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                              device=device)
        n = param_count(model.spec())
        data = train_batch(torch, cfg, seed, batch, seq, device)
        torch.cuda.reset_peak_memory_stats()
        before = kernels.counts()["launches"]
        t0 = time.perf_counter()
        params = fresh_params(torch, model, seed, device)
        check = grad_check(torch, model32, params, data, seed, device=device)
        accum = (accum_check(torch, model32, seed, data, device)
                 if arch == "yi-6b" else None)
        state = init_train_state(params)
        del params
        step = build_train_step(model, OptimizerConfig(**TRAIN_OPT))
        losses, norms, lrs, step_ms = [], [], [], []
        for _ in range(steps):
            ts = time.perf_counter()
            state, met = step(state, data)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            lrs.append(float(met["lr"]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        after = kernels.counts()["launches"]
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        median_ms = statistics.median(step_ms)
        line = {"phase": "train", "arch": arch,
                "layers": [cfg.n_layers, get_config(arch).n_layers],
                "d_model": cfg.d_model, "params": n,
                "state_gb": 16 * n / 1e9, "compute": cfg.dtype,
                "store": "float32", "batch": batch, "tokens": seq,
                "positions": int(data["labels"].shape[1]) + prefix_len(data),
                "inputs": {k: list(v.shape) for k, v in data.items()},
                "losses": losses, "grad_norms": norms, "lrs": lrs,
                "step_ms": step_ms, "step_ms_median": median_ms,
                "tokens_per_s": batch * seq / (median_ms / 1e3),
                "peak_device_gb": peak_gb, "grad_check": check,
                "accum": accum, "launches": launched,
                "seconds": time.perf_counter() - t0, "card": card_line()}
        print(json.dumps(line), flush=True)
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f"train {arch}: loss or grad norm not finite")
        if min(norms) <= 0:
            fail(f"train {arch}: a zero gradient norm")
        if not losses[-1] < losses[0]:
            fail(f"train {arch}: loss {losses[0]} -> {losses[-1]} over "
                 f"{steps} steps on one batch")
        if not check["rel_err"] <= GRAD_TOL:
            fail(f"train {arch}: central difference {check} off the "
                 "gradient")
        if accum and not (accum["loss_err"] <= accum["loss_tol"]
                          and accum["update_rel_err"] <= accum["update_tol"]):
            fail(f"train {arch}: accum 2 differs from accum 1: {accum}")
        if peak_gb >= 80:
            fail(f"train {arch}: peak device memory {peak_gb} GB")
        if launched:
            fail(f"train {arch}: the training route launched {launched}")
        del state, step, data, model, model32
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "train_all", "seconds":
                      time.perf_counter() - t_phase}), flush=True)


# the trainer phase (module docstring, phase 7).  The fact corpus's KG
# sizes (entities, edges): the default, whose batches feed the trainer,
# then a larger one (the closure's work grows as n^3); the kernels its
# builds must launch
CORPUS_SIZES = ((200, 600), (400, 1200))
CORPUS_KERNELS = ("bitonic_sort", "bitonic_sort_kv", "probe_sorted")
CORPUS_STEPS = (0, 1, 7)   # batches a second build must repeat
# the trainer: (arch, layers, batch, seq), its optimizer and loop; the
# crash run's loader raises once at CRASH_AT, after the async save of
# step 10 began
TRAINER_MODEL = ("mamba2-1.3b", 8, 2, 2048)
TRAINER_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 16}
TRAINER_LOOP = {"steps": 16, "ckpt_every": 5, "log_every": 1}
CRASH_AT = 12
CKPT_DIR = ROOT / "build" / "trainer_ckpt"
# the launcher's two runs: (steps, the step it must restore, steps run)
TRAIN_LAUNCHER_RUNS = ((20, None, 20), (30, 20, 10))
# in the training launcher's child: the steps each Trainer.run ran
TRAIN_LAUNCHER_SETUP = """\
from repro_torch.train import trainer
_run = trainer.Trainer.run
def _counted(self, *a, **k):
    out = _run(self, *a, **k)
    report.setdefault("steps_run", []).append(len(out[1]))
    return out
trainer.Trainer.run = _counted
"""


def closed_form_closure(facts) -> set:
    """The transitive closure of ``synth_kg``'s ``linksTo`` edges, by
    boolean matrix products in numpy (no engine): {(subject, object)}."""
    import numpy as np
    edges = [(int(f.id[1:]), int(f.val[1:])) for f in facts
             if f.attr == "linksTo"]
    n = 1 + max(max(e) for e in edges)
    reach = np.zeros((n, n), np.float32)
    for s, o in edges:
        reach[s, o] = 1
    while True:   # each pass doubles the path lengths covered
        more = np.maximum(reach, (reach @ reach > 0).astype(np.float32))
        if np.array_equal(more, reach):
            break
        reach = more
    return {(f"e{s}", f"e{o}") for s, o in zip(*np.nonzero(reach))}


def corpus_build(torch, seed: int, kg: tuple, cfg, batch: int, seq: int,
                 engine_backend: str | None):
    """``FactCorpusSource`` over ``synth_kg(*kg, seed)``: with its own
    engine (``engine_backend`` None: ``infer1`` on the card) or with one
    built by ``corpus_engine`` on ``engine_backend``.  Returns the source,
    its build seconds and the kernel launches of the build."""
    from repro_torch import kernels
    from repro_torch.data import factsource
    kernels.reset_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    if engine_backend is None:
        src = factsource.FactCorpusSource(cfg.vocab, seq, batch, seed=seed)
    else:
        src = factsource.FactCorpusSource(
            cfg.vocab, seq, batch, seed=seed,
            engine=factsource.corpus_engine(seed, engine_backend, *kg))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return src, secs, kernels.counts()  # ... and ends here


def corpus_phase(torch, seed: int, cfg, batch: int, seq: int, sizes: dict,
                 shapes: list, kg_sizes=CORPUS_SIZES) -> tuple:
    """The fact corpus on the card (phase 7, step 1).  Returns the
    default-size source (its batches feed the trainer) and its builds'
    launches by kernel; adds their launches by size to ``sizes`` and
    their merge shapes to ``shapes``."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.backend import torch_ops
    from repro_torch.core.conditions import cond
    from repro_torch.data.factsource import synth_kg

    launches = {name: 0 for name in kernels.ENGINE_KERNELS}
    recorded, undo = merge_shapes(torch_ops)
    query = [cond("Data", "?s", "linksTo", "?o")]
    first = None
    for i, kg in enumerate(kg_sizes):
        src, secs, counts = corpus_build(torch, seed, kg, cfg, batch, seq,
                                         "torch" if i else None)
        add_sizes(sizes, counts)
        launches = {k: launches[k] + counts["launches"][k]
                    for k in launches}
        closure = closed_form_closure(synth_kg(*kg, seed))
        decoded = {(r["s"], r["o"]) for r in src.engine.query(query)}
        line = {"phase": "corpus", "entities": kg[0], "edges": kg[1],
                "own_engine": i == 0, "build_s": secs,
                "infer_s": src.engine.last_infer.seconds,
                "facts_inferred": src.engine.last_infer.facts_inferred,
                "closure_rows": len(src._triples),
                "closed_form_rows": len(closure),
                "launches": {k: v for k, v in counts["launches"].items()
                             if v},
                "card": card_line()}
        if i == 0:   # the default size: numpy's engine, a second build
            ref, ref_s, _ = corpus_build(torch, seed, kg, cfg, batch, seq,
                                         "numpy")
            again, again_s, again_counts = corpus_build(
                torch, seed, kg, cfg, batch, seq, None)
            add_sizes(sizes, again_counts)
            launches = {k: launches[k] + again_counts["launches"][k]
                        for k in launches}
            same_order = np.array_equal(again._triples, src._triples)
            same_batches = all(
                np.array_equal(again.batch(s)[k], src.batch(s)[k])
                for s in CORPUS_STEPS for k in ("tokens", "labels"))
            line.update({
                "numpy_build_s": ref_s, "second_build_s": again_s,
                "numpy_facts_inferred":
                    ref.engine.last_infer.facts_inferred,
                "multiset_equals_numpy": sorted(map(tuple,
                                                    src._triples.tolist()))
                == sorted(map(tuple, ref._triples.tolist())),
                "order_equals_numpy": np.array_equal(src._triples,
                                                     ref._triples),
                "second_build_same_order": same_order,
                "second_build_same_batches": same_batches})
        print(json.dumps(line), flush=True)
        if decoded != closure or len(src._triples) != len(closure):
            fail(f"corpus {kg}: {len(decoded)} decoded linksTo pairs, "
                 f"{len(src._triples)} rows, against {len(closure)} in the "
                 "closed-form closure")
        if i == 0:
            if line["facts_inferred"] != line["numpy_facts_inferred"]:
                fail(f"corpus {kg}: facts_inferred {line['facts_inferred']}"
                     f", numpy {line['numpy_facts_inferred']}")
            if not line["multiset_equals_numpy"]:
                fail(f"corpus {kg}: triples differ from numpy's")
            if not (same_order and same_batches):
                fail(f"corpus {kg}: a second build gave another order "
                     f"(same order {same_order}, batches {same_batches})")
            first = src
            del ref, again
        else:
            del src
    undo()
    shapes.extend(recorded)
    require_launches("corpus", launches, CORPUS_KERNELS)
    return first, launches


def timed_method(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` so each call appends its seconds to ``log``."""
    orig = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        log.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)


def checked_restore(torch, cm, log: list, device) -> None:
    """Wrap ``cm.restore``: time it, then hold every restored leaf
    against the checkpoint's npz bit for bit, on ``device``, with the
    npz's dtype (before the first step writes the tensors in place)."""
    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.params import tree_leaves
    orig = cm.restore

    def restore(step, skeleton, shardings=None):
        t0 = time.perf_counter()
        tree = orig(step, skeleton, shardings)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        host = CheckpointManager.snapshot(tree)
        path = Path(cm.dir) / f"step_{step:09d}" / "shard_00000.npz"
        bad = []
        with np.load(path) as data:
            if sorted(data.files) != sorted(host):
                fail(f"restore {step}: keys differ from the npz's")
            for (key, got), leaf in zip(host.items(), tree_leaves(tree)):
                want = data[key]
                if (leaf.device.type != torch.device(device).type
                        or got.dtype != want.dtype
                        or not np.array_equal(got, want)):
                    bad.append(key)
        log.append({"step": step, "seconds": secs, "leaves": len(host),
                    "bad": bad})
        return tree
    cm.restore = restore


def trainer_runs(torch, seed: int, loader, cfg, batch: int,
                 device="cuda") -> dict:
    """(U), (C) and (R) of phase 7, step 2, on ``loader``; every gate
    fatal.  Returns the phase line's fields."""
    import shutil

    from repro_torch.models import param_count
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    def trainer(ckpt_dir, data):
        return Trainer(cfg, data, OptimizerConfig(**TRAINER_OPT),
                       TrainerConfig(**TRAINER_LOOP, ckpt_dir=ckpt_dir,
                                     seed=seed),
                       global_batch=batch, device=device)

    def uninterrupted():
        t = trainer(None, loader)
        state, losses = t.run()
        del state
        return losses, t.timer.history

    class CrashyLoader:
        """Raises once at ``CRASH_AT``: a node failure."""

        def __init__(self):
            self.crashed = False

        def __call__(self, step):
            if step == CRASH_AT and not self.crashed:
                self.crashed = True
                raise RuntimeError("injected node failure")
            return loader(step)

    torch.cuda.reset_peak_memory_stats()
    losses_u, step_s = uninterrupted()
    torch.cuda.empty_cache()
    n = param_count(trainer(None, loader).model.spec())
    ckpt_bytes = 12 * n + 4   # params, m and v in float32, the step
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    # keep=3 committed steps and one being written
    need = 4 * ckpt_bytes
    free = shutil.disk_usage(CKPT_DIR).free
    if free < need:
        fail(f"trainer: checkpoints need {need} bytes on disk, {free} free")

    crash = trainer(str(CKPT_DIR), CrashyLoader())
    snap_s, write_s = [], []
    timed_method(crash.ckpt, "save_async", snap_s)
    timed_method(crash.ckpt, "_write", write_s)
    try:
        crash.run()
    except RuntimeError as e:
        if "injected node failure" not in str(e):
            raise
    else:
        fail("trainer: the crash run did not raise")
    losses_c, latest_c = crash.losses, crash.ckpt.latest_step()
    del crash
    torch.cuda.empty_cache()

    resume = trainer(str(CKPT_DIR), loader)
    restores = []
    checked_restore(torch, resume.ckpt, restores, device)
    timed_method(resume.ckpt, "_write", write_s)
    state, losses_r = resume.run()
    del state
    latest_r = resume.ckpt.latest_step()
    on_disk = sum(f.stat().st_size for f in
                  (CKPT_DIR / f"step_{latest_r:09d}").iterdir())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del resume
    torch.cuda.empty_cache()

    want_c, want_r = losses_u[:CRASH_AT], losses_u[10:]
    dev = max([abs(a - b) for a, b in zip(losses_c, want_c)]
              + [abs(a - b) for a, b in zip(losses_r, want_r)], default=0.0)
    spread = None
    if dev > 0:   # does (U) itself repeat?
        again, _ = uninterrupted()
        spread = max(abs(a - b) for a, b in zip(again, losses_u))
    median_s = statistics.median(step_s)
    out = {"losses_u": losses_u, "losses_c": losses_c, "losses_r": losses_r,
           "max_dev_from_u": dev, "u_run_to_run_spread": spread,
           "latest_after_crash": latest_c, "restores": restores,
           "latest_after_resume": latest_r, "params": n,
           "ckpt_bytes_on_disk": on_disk, "ckpt_state_bytes": ckpt_bytes,
           "save_async_blocking_ms": [x * 1e3 for x in snap_s],
           "write_s": write_s, "step_ms_median": median_s * 1e3,
           "tokens_per_s": batch * loader.source.seq_len / median_s,
           "peak_device_gb": peak_gb}
    print(json.dumps({"phase": "trainer_runs", **out}), flush=True)
    if latest_c != 10 or len(losses_c) != CRASH_AT:
        fail(f"trainer: the crash left step {latest_c} committed after "
             f"{len(losses_c)} steps, not step 10 after {CRASH_AT}")
    if [r["step"] for r in restores] != [10] or restores[0]["bad"]:
        fail(f"trainer: the resume restored {restores}")
    if len(losses_r) != 6 or latest_r != 16:
        fail(f"trainer: the resume ran {len(losses_r)} steps and left step "
             f"{latest_r}, not 6 and 16")
    if dev > 0 and not (spread and dev <= spread):
        fail(f"trainer: crash/resume losses off the uninterrupted run's by "
             f"{dev}, its own run-to-run spread {spread}")
    every = losses_u + losses_c + losses_r
    if not all(math.isfinite(x) for x in every):
        fail("trainer: a loss is not finite")
    if not losses_u[-1] < losses_u[0]:
        fail(f"trainer: loss {losses_u[0]} -> {losses_u[-1]}")
    if peak_gb >= 80:
        fail(f"trainer: peak device memory {peak_gb} GB")
    shutil.rmtree(CKPT_DIR)
    return out


def train_launcher_runs(sizes: dict, shapes: list, device="cuda",
                        extra=(), data="facts",
                        ckpt_name="launcher_ckpt") -> dict:
    """``python -m repro_torch.launch.train --arch yi-6b --smoke --data
    facts`` (``extra`` flags added) in a child, as
    ``TRAIN_LAUNCHER_RUNS`` says (phase 7, step 3).  Returns its launches
    by kernel; adds them by size to ``sizes`` and the merge shapes to
    ``shapes``."""
    import shutil

    from repro_torch import kernels
    ckpt = CKPT_DIR.with_name(ckpt_name)
    shutil.rmtree(ckpt, ignore_errors=True)
    env = launcher_env()
    child = launcher_child("repro_torch.launch.train", TRAIN_LAUNCHER_SETUP)
    launches = {name: 0 for name in kernels.ENGINE_KERNELS}
    for steps, restored, ran in TRAIN_LAUNCHER_RUNS:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", child, "--arch", "yi-6b", "--smoke",
             "--steps", str(steps), "--data", data, "--ckpt-dir",
             str(ckpt), "--device", device, *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        lines = res.stdout.strip().splitlines()
        final = [re.match(r"final loss: (\S+) \(start (\S+)\)", ln)
                 for ln in lines]
        final = [tuple(map(float, m.groups())) for m in final if m]
        counts = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                  if ln.startswith("launcher_kernels ")]
        said = re.findall(r"restoring checkpoint step (\d+)", res.stderr)
        line = {"launcher": "repro_torch.launch.train", "steps": steps,
                "flags": list(extra),
                "rc": res.returncode, "seconds": time.perf_counter() - t0,
                "final_loss": final[0] if final else None,
                "restored": said, "kernels": counts[0] if counts else None}
        print(json.dumps(line), flush=True)
        if res.returncode != 0 or not final or not counts:
            fail(f"train launcher ({steps} steps): rc {res.returncode}, "
                 f"stderr {res.stderr[-400:]!r}")
        last, start = final[0]
        if not (math.isfinite(last) and math.isfinite(start)):
            fail(f"train launcher ({steps} steps): loss {final[0]}")
        if restored is None and not last < start:
            fail(f"train launcher ({steps} steps): loss {start} -> {last}")
        if said != ([] if restored is None else [str(restored)]) or \
                counts[0].get("steps_run") != [ran]:
            fail(f"train launcher ({steps} steps): restored {said}, ran "
                 f"{counts[0].get('steps_run')}; want {restored}, {ran}")
        add_sizes(sizes, counts[0])
        shapes.extend(tuple(s) for s in counts[0]["merge_shapes"])
        launches = {k: launches[k] + counts[0]["launches"][k]
                    for k in launches}
    shutil.rmtree(ckpt)
    return launches


def trainer_phase(torch, seed: int, reps: int, model=TRAINER_MODEL,
                  kg_sizes=CORPUS_SIZES, device="cuda") -> dict:
    """The fact corpus on the card, the trainer's crash and resume at
    full width fed by it, and the training launcher (module docstring,
    phase 7); every gate fatal.  The fact kernels are then bit-checked at
    the sizes and merge shapes of this phase's runs, as the kernel phase
    checks the earlier phases'.  Returns the fact kernels' launches over
    the corpus builds and the launcher's children."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader

    t0 = time.perf_counter()
    sizes, shapes = new_sizes(), []
    arch, layers, batch, seq = model
    cfg = train_config(arch, layers)
    src, launches = corpus_phase(torch, seed, cfg, batch, seq, sizes,
                                 shapes, kg_sizes)
    runs = trainer_runs(torch, seed, ShardedLoader(src), cfg, batch, device)
    del src
    child = train_launcher_runs(sizes, shapes, device)
    launches = {k: launches[k] + child[k] for k in launches}
    print(json.dumps({"trainer_path_sizes": sizes,
                      "trainer_merge_shapes": sorted(set(shapes))}),
          flush=True)
    rng = np.random.RandomState(seed + 11)
    path_shape_checks(torch, rng, sizes)
    if shapes:
        rank_detail(torch, rng, reps, sorted(set(shapes)))
    print(json.dumps({"phase": "trainer", "arch": arch,
                      "layers": [cfg.n_layers, get_config(arch).n_layers],
                      "d_model": cfg.d_model, "vocab": cfg.vocab,
                      "batch": batch, "seq": seq,
                      "step_ms_median": runs["step_ms_median"],
                      "tokens_per_s": runs["tokens_per_s"],
                      "launches": launches,
                      "seconds": time.perf_counter() - t0,
                      "card": card_line()}), flush=True)
    return launches


# the sharding phase (module docstring, phase 8): the LM's mesh forms on a
# 2x4 data x model mesh over one card's device list.  (arch, layers,
# batch, seq) per sub-phase; float32 with TF32 off unless named
SHARD_MESH = (2, 4)
SHARD_TRAIN = ("yi-6b", 4, 2, 2048)
SHARD_TRAIN_STEPS = 3
SHARD_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10}
SHARD_GRAD_TOL = 1e-4     # of each leaf's scale, float32 with TF32 off
SHARD_SERVE = ("yi-6b", None, 2, 2048)     # whole, the 16-bit store
SHARD_DECODE_STEPS = 4
SHARD_MOE = ("moonshot-v1-16b-a3b", 2, 2, 2048)
SHARD_PIPE = ("yi-6b", 8, 4, 2048)         # 4 stages, 4 microbatches
SHARD_DP = ("yi-6b", 2, 8, 512)            # data 4
SHARD_DP_N = 4
# the mixers step: (arch, mesh, batch, prompt) at full width and depth in
# the 16-bit store, the LM phase's prompts; whisper's 6 heads split over a
# model axis of 2, not of 4
SHARD_MIXERS = (("mamba2-1.3b", (2, 4), 2, 2048),
                ("recurrentgemma-9b", (2, 4), 2, 4096),
                ("whisper-tiny", (2, 4), 16, 432),
                ("whisper-tiny", (4, 2), 16, 432))
# and one FSDP+TP step each (arch, layers, batch, seq), float32;
# recurrentgemma at 2048 positions (its window), not the training
# phase's 4096: with both sides' weights, moments and gradients on the
# card it peaked at 77.5 GB at 4096 before the 16.1 GB the earlier
# phases leave
SHARD_MIXER_TRAIN = (("mamba2-1.3b", 8, 2, 2048),
                     ("recurrentgemma-9b", 3, 2, 2048))
# the sharded bf16 forward's distance from the single device's float32
# logits, at most this times the single bf16 forward's: both round every
# op to bf16, in another order (the partial products of the row-parallel
# GEMMs among them), and at full depth that rounding alone moves the
# logits past 3e-2 * max(1, scale) (mamba2-1.3b 0.141 against a bound of
# 0.121, recurrentgemma-9b 0.187 against 0.139, NVIDIA H100 80GB HBM3)
MIXER_BF16_RATIO = 1.5


def layout_bytes(tree) -> dict:
    """What the layout puts on each mesh device (each leaf's block) and
    on each physical device (each block it holds once), summed over a
    tree of ``ShardedTensor``s."""
    from repro_torch.distributed.sharding import is_sharded
    from repro_torch.models.params import tree_leaves
    per_mesh, per_card = 0, {}
    for x in tree_leaves(tree, is_sharded):
        item = x.dtype.itemsize
        per_mesh += x.sharding.block_bytes(x.shape, item)
        for d, b in x.sharding.device_bytes(x.shape, item).items():
            per_card[str(d)] = per_card.get(str(d), 0) + b
    return {"per_mesh_device": per_mesh, "per_physical_device": per_card}


def placed(tree, spec, mesh):
    from repro_torch.distributed.sharding import shardings_for
    from repro_torch.models.params import tree_map
    return tree_map(lambda x, sh: sh.place(x), tree,
                    shardings_for(spec, mesh))


def timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def grad_gap(torch, got, want, device) -> float:
    """The worst leaf's max |got - want| over max(its max |want|, 1e-3 of
    the largest over all leaves): ``got`` a tree of ``ShardedTensor``s,
    ``want`` the single device's gradients (on ``device`` or the host:
    compared a leaf at a time on ``device``)."""
    from repro_torch.distributed.sharding import is_sharded
    from repro_torch.models.params import tree_leaves
    want = tree_leaves(want)
    top = max(float(w.to(device).abs().max()) for w in want)
    gap = 0.0
    for a, b in zip(tree_leaves(got, is_sharded), want):
        b = b.to(device)
        scale = max(float(b.abs().max()), 1e-3 * top)
        gap = max(gap, float((a.gather(device) - b).abs().max()) / scale)
    return gap


class MeshSpy:
    """Within ``with``: each sequence form block's residual rows on the
    model indices of the first batch block (``rows``: how often each
    tuple came; a decoder LM's blocks, an enc-dec's after each MLP), and
    each whole read of a leaf split over ``model`` (``gathers``, by its
    spec)."""

    def __init__(self):
        self.rows: dict = {}
        self.gathers: list = []

    def __enter__(self):
        from repro_torch.distributed.sharding import ShardedTensor
        from repro_torch.models import encdec, transformer
        block, mlp = transformer._block_sharded, encdec._mlp_rows
        gather = ShardedTensor.gather

        def add(H):
            key = tuple(h.shape[1] for h in H[0])
            self.rows[key] = self.rows.get(key, 0) + 1

        def block_spy(*a, **k):
            out = block(*a, **k)
            add(out[0])
            return out

        def mlp_spy(*a, **k):
            out = mlp(*a, **k)
            add(out)
            return out

        def gather_spy(st, dev):
            if any("model" in str(e) for e in st.sharding.spec):
                self.gathers.append(list(map(str, st.sharding.spec)))
            return gather(st, dev)
        self._saved = [(transformer, "_block_sharded", block),
                       (encdec, "_mlp_rows", mlp),
                       (ShardedTensor, "gather", gather)]
        transformer._block_sharded = block_spy
        encdec._mlp_rows = mlp_spy
        ShardedTensor.gather = gather_spy
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def seq_rows(self) -> list:
        return [[list(k), n] for k, n in sorted(self.rows.items())]

    def check(self, where: str, lengths, M: int, sp: bool) -> None:
        """Every block held ``split_range(S, M, j)`` rows on model index
        ``j`` (``sp``) or the whole ``S`` on each, for an ``S`` of
        ``lengths``, and each of ``lengths`` was seen."""
        want = {tuple(S * (j + 1) // M - S * j // M if sp else S
                      for j in range(M)) for S in lengths}
        if set(self.rows) != want:
            fail(f"{where}: residual rows by model index "
                 f"{self.seq_rows()}, expected {sorted(want)}")


def shard_train(torch, seed: int, mesh, device) -> None:
    """FSDP+TP steps of yi-6b at 4 of 32 layers against the single-device
    step on the same weights and batch: the first step's gradients leaf
    by leaf, then every step's loss (each step reports the loss before
    its update, so the second and third hold the updates)."""
    import dataclasses

    from repro_torch.distributed.sharding import (activation_hints,
                                                  batch_shardings,
                                                  is_sharded)
    from repro_torch.models import build_model, param_count
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state, loss_and_grads)
    arch, layers, batch, seq = SHARD_TRAIN
    cfg = dataclasses.replace(train_config(arch, layers), dtype="float32")
    single = build_model(cfg, device=device)
    model = build_model(cfg, activation_hints(cfg, mesh, batch, "train"))
    params = fresh_params(torch, single, seed, device)
    data = train_batch(torch, cfg, seed, batch, seq, device)
    sdata = tree_map(lambda x, sh: sh.place(x), data,
                     batch_shardings(data, mesh, batch))
    sparams = placed(params, single.spec(), mesh)
    torch.cuda.reset_peak_memory_stats()
    g0 = loss_and_grads(single, params, data)[2]
    with MeshSpy() as spy:
        g1 = loss_and_grads(model, sparams, sdata)[2]
    grad_err = grad_gap(torch, g1, g0, device)
    del g0, g1
    sstate = init_train_state(sparams)
    state = init_train_state(params)
    del params, sparams
    opt = OptimizerConfig(**SHARD_OPT)
    step, sstep = build_train_step(single, opt), build_train_step(model, opt)
    single_losses, losses, single_ms, mesh_ms = [], [], [], []
    for i in range(SHARD_TRAIN_STEPS):
        (state, met), ms0 = timed(torch, lambda: step(state, data))
        (sstate, smet), ms1 = timed(torch, lambda: sstep(sstate, sdata))
        single_losses.append(float(met["loss"]))
        losses.append(float(smet["loss"]))
        single_ms.append(ms0)
        mesh_ms.append(ms1)
        if i == 0:
            param_err = max(float((a.gather(device) - b).abs().max())
                            for a, b in zip(
                                tree_leaves(sstate["params"], is_sharded),
                                tree_leaves(state["params"])))
    loss_errs = [abs(a - b) for a, b in zip(losses, single_losses)]
    # the last update's effect: the loss after it
    with torch.no_grad():
        after = float(model.loss_fn(sstate["params"], sdata)[0])
        single_after = float(single.loss_fn(state["params"], data)[0])
    loss_errs.append(abs(after - single_after))
    peak = torch.cuda.max_memory_allocated() / 1e9
    line = {"phase": "sharding", "part": "fsdp_tp_train", "arch": arch,
            "layers": [cfg.n_layers, train_config(arch, None).n_layers],
            "mesh": dict(mesh.shape), "params": param_count(single.spec()),
            "batch": batch, "seq": seq, "lr": SHARD_OPT["lr"],
            "losses": losses, "single_losses": single_losses,
            "loss_after": after, "single_loss_after": single_after,
            "loss_errs": loss_errs, "first_grad_rel_err": grad_err,
            "first_step_param_err": param_err,
            "params_bytes": layout_bytes(sstate["params"]),
            "opt_state_bytes": layout_bytes({"m": sstate["opt"]["m"],
                                             "v": sstate["opt"]["v"]}),
            "step_ms": mesh_ms, "single_step_ms": single_ms,
            "seq_rows": spy.seq_rows(),
            "model_split_gathers": len(spy.gathers),
            "peak_device_gb": peak, "card": card_line()}
    print(json.dumps(line), flush=True)
    spy.check("sharding train", [seq], mesh.shape["model"],
              model.hints.seq_parallel())
    if spy.gathers:
        fail(f"sharding train: {len(spy.gathers)} whole reads of leaves "
             f"split over model: {spy.gathers[:4]}")
    if not grad_err <= SHARD_GRAD_TOL:
        fail(f"sharding train: gradients off the single device by "
             f"{grad_err} of their scale")
    if not all(e <= 2e-3 for e in loss_errs):
        fail(f"sharding train: losses off the single step by {loss_errs}")
    if not param_err <= 3e-3:
        fail(f"sharding train: params off the single step by {param_err}")
    # at lr 1e-3 the single device's own curve rises on the third step
    # (the line's single_losses): the end is gated, below the start
    if not (all(math.isfinite(x) for x in losses + [after])
            and after < losses[0]):
        fail(f"sharding train: losses {losses}, then {after}")
    if peak >= 80:
        fail(f"sharding train: peak device memory {peak} GB")


def shard_serve(torch, seed: int, mesh, device) -> int:
    """yi-6b whole in the 16-bit store: the sharded prefill (the KV cache
    split over ``model``) and decode steps against the single-device run;
    returns the kernel's launches over the sharded prefill by route."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.distributed.sharding import activation_hints
    from repro_torch.models import build_model, init_params
    arch, layers, batch, seq = SHARD_SERVE
    cfg = train_config(arch, layers)
    single = build_model(cfg, device=device)
    pre = build_model(cfg, activation_hints(cfg, mesh, batch, "prefill"))
    dec = build_model(cfg, activation_hints(cfg, mesh, batch, "decode"))
    params = init_params(single.spec(), seed, device=device,
                         store=cfg.dtype)
    sparams = placed(params, single.spec(), mesh)
    r = np.random.RandomState(seed + 21)
    toks = torch.tensor(r.randint(0, cfg.vocab, (
        batch, seq + SHARD_DECODE_STEPS)).astype(np.int32), device=device)
    # 2053 rows do not split over the 4 model devices: the cache is split
    # all the same, padded to 2056
    max_len = seq + SHARD_DECODE_STEPS + 1
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (want, cache), single_ms = timed(torch, lambda: single.prefill_fn(
            params, toks[:, :seq], max_len))
        wants = [want.float()]
        for i in range(SHARD_DECODE_STEPS):
            want, cache = single.decode_fn(params, toks[:, seq + i], cache)
            wants.append(want.float())
        del cache
        kernels.reset_counts()
        with MeshSpy() as spy:
            (got, scache), mesh_ms = timed(torch, lambda: pre.prefill_fn(
                sparams, toks[:, :seq], max_len))
        torch.cuda.synchronize()
        launched = dict(kernels.LAUNCHES)
        gots = [got.float()]
        dec_ms = []
        for i in range(SHARD_DECODE_STEPS):
            (got, scache), ms = timed(torch, lambda: dec.decode_fn(
                sparams, toks[:, seq + i], scache))
            gots.append(got.float())
            dec_ms.append(ms)
    errs, bounds = [], []
    for g, w in zip(gots, wants):
        errs.append(float((g - w).abs().max()))
        bounds.append(3e-2 * max(1.0, float(w.abs().max())))
    grid = pre.grid
    expect = grid.size * cfg.n_layers     # every head shard of every layer
    k = scache["layers"]["b0"]["k"]
    line = {"phase": "sharding", "part": "prefill_decode", "arch": arch,
            "layers": cfg.n_layers, "store": cfg.dtype, "batch": batch,
            "seq": seq, "max_len": max_len, "mesh": dict(mesh.shape),
            "cache_spec": list(map(str, k.sharding.spec)),
            "cache_block": list(k[0].shape),
            "logits_err": errs, "logits_bound": bounds,
            "flash_launches": launched["flash_attention"],
            "flash_wgmma_launches": launched["flash_attention_wgmma"],
            "expected_launches": expect, "seq_rows": spy.seq_rows(),
            "prefill_ms": mesh_ms, "single_prefill_ms": single_ms,
            "decode_ms": dec_ms,
            "params_bytes": layout_bytes(sparams),
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card_line()}
    print(json.dumps(line), flush=True)
    spy.check("sharding serve", [seq], mesh.shape["model"],
              pre.hints.seq_parallel())
    if not all(e <= b for e, b in zip(errs, bounds)):
        fail(f"sharding serve: logits off the single device: {errs}")
    if launched["flash_attention"] != expect:
        fail(f"sharding serve: flash_attention launched "
             f"{launched['flash_attention']} times on the head shards, "
             f"not {expect}")
    return {"wgmma": launched["flash_attention_wgmma"], "simt":
            launched["flash_attention"] - launched["flash_attention_wgmma"]}


def shard_moe(torch, seed: int, mesh, device) -> None:
    """moonshot's expert-parallel dispatch (64 experts, 16 a shard) at
    capacity factor E/k, where nothing drops, against the single-device
    ``apply_moe``: the layer alone and a 2-layer model's prefill."""
    import dataclasses

    import numpy as np

    from repro_torch.distributed.sharding import activation_hints
    from repro_torch.models import build_model, init_params, moe
    arch, layers, batch, seq = SHARD_MOE
    base = train_config(arch, layers)
    cfg = dataclasses.replace(base, dtype="float32", capacity_factor=(
        base.n_experts / base.top_k))
    hints = activation_hints(cfg, mesh, batch, "prefill")
    if not moe.uses_ep(cfg, hints):
        fail("sharding moe: the expert-parallel form was not taken")
    p = init_params(moe.moe_spec(cfg), seed, device=device)
    sp = placed(p, moe.moe_spec(cfg), mesh)
    r = np.random.RandomState(seed + 31)
    x = torch.tensor((r.randn(batch, seq, cfg.d_model) * 0.5).astype(
        np.float32), device=device)
    with torch.no_grad():
        moe.reset_dropped()
        (y0, a0), ms0 = timed(torch, lambda: moe.apply_moe(p, x, cfg))
        (y1, a1), ms1 = timed(torch, lambda: moe.apply_moe(sp, x, cfg,
                                                           hints))
        dropped = moe.dropped_pairs()
    err = float((y1 - y0).abs().max())
    bound = 1e-3 * max(1.0, float(y0.abs().max()))
    aux_err = abs(float(a1) - float(a0))
    del p, sp, x, y0, y1
    single = build_model(cfg, device=device)
    model = build_model(cfg, hints)
    params = fresh_params(torch, single, seed, device)
    sparams = placed(params, single.spec(), mesh)
    toks = torch.tensor(r.randint(0, cfg.vocab, (batch, seq)).astype(
        np.int32), device=device)
    with torch.no_grad():
        moe.reset_dropped()
        want, _ = single.prefill_fn(params, toks, seq)
        got, _ = model.prefill_fn(sparams, toks, seq)
        dropped += moe.dropped_pairs()
    lerr = float((got - want).abs().max())
    lbound = 1e-3 * max(1.0, float(want.abs().max()))
    line = {"phase": "sharding", "part": "expert_parallel", "arch": arch,
            "layers": [cfg.n_layers, base.n_layers], "experts": cfg.n_experts,
            "experts_per_shard": cfg.n_experts // mesh.shape["model"],
            "capacity_factor": cfg.capacity_factor, "batch": batch,
            "seq": seq, "y_err": err, "y_bound": bound, "aux_err": aux_err,
            "prefill_logits_err": lerr, "prefill_bound": lbound,
            "dropped_pairs": dropped, "ep_ms": ms1, "single_ms": ms0,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card_line()}
    print(json.dumps(line), flush=True)
    if not (err <= bound and aux_err <= 1e-5 and lerr <= lbound):
        fail(f"sharding moe: EP off the single device: {line}")
    if dropped:
        fail(f"sharding moe: {dropped} pairs dropped at capacity factor E/k")


def shard_pipeline(torch, seed: int, device) -> None:
    """``pipeline_apply`` over yi-6b's ``apply_block`` (8 layers, 4
    stages, 4 microbatches on ``[device] * 4``) against the sequential
    loop."""
    import dataclasses

    import numpy as np

    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import BlockKind
    from repro_torch.models.transformer import apply_block
    arch, layers, batch, seq = SHARD_PIPE
    cfg = dataclasses.replace(train_config(arch, layers), dtype="float32")
    model = build_model(cfg, device=device)
    blocks = fresh_params(torch, model, seed, device)["blocks"]["b0"]
    r = np.random.RandomState(seed + 41)
    h = torch.tensor((r.randn(batch, seq, cfg.d_model) * 0.5).astype(
        np.float32), device=device)
    pos = torch.arange(seq, device=device)[None]

    def block(lp, x):
        return apply_block(lp, x, BlockKind.ATTN, cfg,
                           pos.expand(x.shape[0], seq))[0]
    mesh = make_host_mesh((4,), ("pod",), devices=[device] * 4)
    with torch.no_grad():
        want, seq_ms = timed(torch, lambda: _sequential(blocks, h, block,
                                                        layers))
        got, pipe_ms = timed(torch, lambda: pipeline_apply(
            block, blocks, h, mesh=mesh, n_stages=4, n_micro=4,
            axis="pod"))
    err = float((got - want).abs().max())
    bound = 1e-5 * max(1.0, float(want.abs().max()))
    print(json.dumps({"phase": "sharding", "part": "pipeline", "arch": arch,
                      "layers": layers, "stages": 4, "microbatches": 4,
                      "batch": batch, "seq": seq, "err": err,
                      "bound": bound, "pipeline_ms": pipe_ms,
                      "sequential_ms": seq_ms, "card": card_line()}),
          flush=True)
    if not err <= bound:
        fail(f"sharding pipeline: {err} off the sequential loop")


def _sequential(blocks, h, block, layers):
    from repro_torch.models.params import tree_map
    for i in range(layers):
        h = block(tree_map(lambda w: w[i], blocks), h)
    return h


def shard_dp_compressed(torch, seed: int, device) -> None:
    """``build_dp_compressed_step`` on yi-6b at 2 of 32 layers over data
    4 against the exact step.  Reckoned before the run: 4 residuals and 4
    local gradients of 3.5 GB each, the params and AdamW's moments (3.5
    and 7 GB) and the exact step's params kept for the drift: ~42 GB,
    before the reduction's and AdamW's per-leaf temporaries.  The step
    holds one replica's gradients at a time (``compress_grads`` right
    after each backward), so ~31 GB.

    AdamW's first update moves a weight by about ``lr * sign(g)``
    whatever ``g``'s size, and the loss it reports is the one before the
    update, so neither the params nor the loss hold the reduced gradient:
    ``int8_check`` holds the residuals the step kept against each
    replica's exact gradient."""
    import dataclasses

    from repro_torch.distributed.compression import reduced_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, param_count
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (OptimizerConfig,
                                   build_dp_compressed_step,
                                   build_train_step, init_compressed_state,
                                   init_train_state)
    arch, layers, batch, seq = SHARD_DP
    cfg = dataclasses.replace(train_config(arch, layers), dtype="float32")
    model = build_model(cfg, device=device)
    opt = OptimizerConfig(**SHARD_OPT)
    data = train_batch(torch, cfg, seed, batch, seq, device)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(fresh_params(torch, model, seed, device))
    (state, m1), exact_ms = timed(torch, lambda: build_train_step(
        model, opt)(state, data))
    exact = state["params"]
    del state
    torch.cuda.empty_cache()
    mesh = make_host_mesh((SHARD_DP_N,), ("data",),
                          devices=[device] * SHARD_DP_N)
    cstate = init_compressed_state(fresh_params(torch, model, seed, device),
                                   SHARD_DP_N, mesh)
    (cstate, m2), comp_ms = timed(torch, lambda: build_dp_compressed_step(
        model, opt, mesh)(cstate, data))
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss_err = abs(float(m2["loss"]) - float(m1["loss"]))
    drift = max(float((a - b).abs().max()) / (float(a.abs().max()) + 1e-9)
                for a, b in zip(tree_leaves(exact),
                                tree_leaves(cstate["params"])))
    sizes = reduced_bytes(exact)
    del exact, cstate["params"], cstate["opt"]
    torch.cuda.empty_cache()
    check = int8_check(torch, model, fresh_params(torch, model, seed, device),
                       data, cstate["grad_residual"], SHARD_DP_N, device)
    line = {"phase": "sharding", "part": "dp_int8", "arch": arch,
            "layers": [layers, train_config(arch, None).n_layers],
            "params": param_count(model.spec()), "data": SHARD_DP_N,
            "batch": batch, "seq": seq, "loss": float(m2["loss"]),
            "exact_loss": float(m1["loss"]), "loss_err": loss_err,
            "max_rel_drift": drift, **check,
            "reduced_bytes_per_replica": sizes,
            "step_ms": comp_ms, "exact_step_ms": exact_ms,
            "peak_device_gb": peak,
            "peak_with_check_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card_line()}
    print(json.dumps(line), flush=True)
    if not (loss_err <= 1e-3 and drift < 0.35 and peak < 80):
        fail(f"sharding dp_int8: {line}")
    if not (check["off_grid"] <= 1e-2 and check["residual"] <= 0.5 + 1e-3
            and check["reduced_err"] <= 1.0):
        fail(f"sharding dp_int8: the step did not send its replicas' "
             f"int8 gradients: {check}")


def int8_check(torch, model, params, data, residuals, n: int,
               device) -> dict:
    """The first compressed step, from zero residuals, must have sent
    replica ``r``'s gradient ``g_r`` as its int8 codes: with ``g_r`` from
    a backward of its own on the replica's rows and ``res_r`` the
    residual the step kept, ``g_r - res_r`` lies on the int8 grid of step
    ``s_r = amax(g_r) / 127`` and ``|res_r| <= s_r / 2``.  The reduced
    gradient, the mean of ``g_r - res_r``, is then off the exact mean
    gradient by the mean residual.  Returns, over the leaves, the worst
    off-grid distance and residual in units of ``s_r``, and the worst
    ``|reduced - exact mean|`` in units of the leaf's largest ``s_r``."""
    from repro_torch.distributed.sharding import is_sharded
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import loss_and_grads
    res = tree_leaves(residuals, is_sharded)
    mean_res = [torch.zeros(r.shape[1:], device=device) for r in res]
    steps = [0.0] * len(res)
    off = worst = 0.0
    for i in range(n):
        rows = tree_map(lambda x: x[i * x.shape[0] // n:
                                    (i + 1) * x.shape[0] // n], data)
        grads = tree_leaves(loss_and_grads(model, params, rows)[2])
        for k, (g, r) in enumerate(zip(grads, res)):
            ri = r.piece(device, [(i, i + 1)])[0]
            step = max(float(g.abs().max()), 1e-30) / 127.0
            sent = (g.float() - ri) / step
            off = max(off, float((sent - torch.round(sent)).abs().max()))
            worst = max(worst, float(ri.abs().max()) / step)
            mean_res[k] += ri / n
            steps[k] = max(steps[k], step)
        del grads
    return {"off_grid": off, "residual": worst, "reduced_err": max(
        float(m.abs().max()) / st for m, st in zip(mean_res, steps))}


def shard_launcher(torch, device) -> None:
    """``python -m repro_torch.launch.train --mesh 2x4 --devices
    cuda:0`` (yi-6b smoke): 20 steps whose loss falls, then 30 on the same
    directory, which must restore step 20 and run 10; without
    ``--devices`` on a card with fewer than 8 devices it must fail naming
    the flag."""
    mesh = ("--mesh", "x".join(map(str, SHARD_MESH)))
    devices = "cuda:0" if device == "cuda" else str(device)
    train_launcher_runs(new_sizes(), [], "cuda", (*mesh, "--devices",
                                                  devices),
                        data="synthetic", ckpt_name="mesh_ckpt")
    if torch.cuda.device_count() < math.prod(SHARD_MESH):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "yi-6b", "--smoke", "--steps", "1", *mesh], cwd=ROOT,
            env=launcher_env(), capture_output=True, text=True, timeout=300)
        said = res.stderr.strip().splitlines()[-1:] or [""]
        print(json.dumps({"launcher": "repro_torch.launch.train",
                          "flags": list(mesh), "rc": res.returncode,
                          "error": said[0]}), flush=True)
        if res.returncode == 0 or "--devices" not in said[0]:
            fail(f"--mesh without --devices on one card: rc "
                 f"{res.returncode}, {said[0]!r}")


def mixer_launches(cfg, mesh_shape) -> dict:
    """The LM kernels one sharded prefill launches, from the config and
    the mesh alone: each SSD, RG-LRU and (local) attention layer once on
    every device of the ``R x M`` grid (whisper: the encoder's and the
    cross-attention's layers, ``kernel_layers``), except attention whose
    query heads ``M`` does not split, once a row."""
    R, M = mesh_shape
    per = R * M if cfg.n_heads % M == 0 else R
    want = {"ssd_intra": 0, "linear_scan": R * M * scan_layers(cfg),
            "flash_attention": 0}
    if cfg.family == "ssm":
        want["ssd_intra"] = R * M * kernel_layers(cfg)
    else:
        want["flash_attention"] = per * kernel_layers(cfg)
    return want


def mixer_kernel_ms(torch, seed: int, reps: int) -> dict:
    """Each kernel of the mixers step at its shard's shape on the 2x4 mesh
    (whisper's also on 4x2), against its plain version at the kernel
    phase's gates (``ssd_intra`` 1e-4 and ``linear_scan`` 1e-5 of the
    scale, attention 2e-2 in bf16), timed (CUDA events); ``bound_ms``
    as the kernel rows count it."""
    import numpy as np

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.ssd.ssd import ssd_intra, ssd_intra_plain
    rng = np.random.RandomState(seed + 31)
    dev = "cuda"

    def normal(*shape, dtype=torch.float32):
        return torch.tensor(rng.randn(*shape).astype(np.float32),
                            device=dev).to(dtype)
    out = {}
    # mamba2-1.3b: b 1 a row, 16 of 64 heads a device
    b, nc, Q, nh, hp, N = 1, 8, 256, 16, 64, 128
    cum = torch.tensor(np.cumsum(-np.abs(rng.randn(b, nc, Q, nh)).astype(
        np.float32) * 0.05, axis=2), device=dev)
    u, Bm, Cm = normal(b, nc, Q, nh, hp), normal(b, nc, Q, N), \
        normal(b, nc, Q, N)
    errs = [float_err(torch, g, w, 1e-4 * max(1.0, float(w.abs().max())),
                      f"ssd_intra (shard {what})")
            for g, w, what in zip(ssd_intra(cum, u, Bm, Cm),
                                  ssd_intra_plain(cum, u, Bm, Cm),
                                  ("y", "state"))]
    tri = Q * (Q + 1) // 2
    nbytes = 4 * (b * nc * Q * nh + 2 * b * nc * Q * nh * hp
                  + 2 * b * nc * Q * N + b * nc * nh * hp * N)
    ops = b * nc * (tri * N * 2 + nh * (tri * 2 + tri * hp * 2 + Q * hp
                                        + Q * hp * N * 2))
    out["ssd_intra"] = {
        "shape": [b, nc, Q, nh, hp, N], "max_abs_err": max(errs),
        "ms": time_ms(torch, lambda: ssd_intra(cum, u, Bm, Cm), reps),
        "plain_ms": time_ms(torch, lambda: ssd_intra_plain(cum, u, Bm, Cm),
                            reps),
        "bound_ms": bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)[0]}
    del cum, u, Bm, Cm
    # recurrentgemma-9b: B 1 a row, 1024 of 4096 channels a device
    scan = scan_row(torch, rng, reps, (1, 4096, 1024))
    out["linear_scan"] = {"shape": scan["shape"],
                          "max_abs_err": scan["max_abs_err"],
                          "f64_max_abs_err": scan["f64_max_abs_err"],
                          "ms": scan["kernel_ms"],
                          "plain_ms": scan["plain_ms"],
                          "bound_ms": scan["bound"][0]}

    def attention(name, b_, sq, skv, hq, hkv, d_, window, causal):
        q = normal(b_, sq, hq, d_, dtype=torch.bfloat16)
        k, v = (normal(b_, skv, hkv, d_, dtype=torch.bfloat16)
                for _ in range(2))
        err = float_err(torch, flash_attention(q, k, v, causal=causal,
                                               window=window),
                        flash_attention_plain(q, k, v, causal=causal,
                                              window=window), 2e-2,
                        f"flash_attention ({name})")
        # the (query, key) pairs the mask keeps, two products of 2 FLOPs
        # a multiply-add, at the bf16 peak; q, k, v, out once in bf16
        qi = np.arange(sq)[:, None] + (skv - sq)
        ki = np.arange(skv)[None, :]
        keep = np.ones((sq, skv), bool)
        if causal:
            keep &= qi >= ki
        if window:
            keep &= qi - ki < window
        pairs = int(keep.sum()) * b_ * hq
        out[name] = {
            "shape": [b_, sq, skv, hq, hkv, d_], "window": window,
            "causal": causal, "max_abs_err": err,
            "ms": time_ms(torch, lambda: flash_attention(
                q, k, v, causal=causal, window=window), reps),
            "bound_ms": bound_ms(2 * (2 * b_ * sq * hq * d_
                                      + 2 * b_ * skv * hkv * d_),
                                 4 * pairs * d_, BF16_OPS_PER_S)[0]}
    attention("flash_attention@hd256", 1, 4096, 4096, 4, 1, 256, 2048, True)
    # whisper on 2x4: its 6 heads whole on a row's first device, B 8; on
    # 4x2: 3 a device, B 4; the encoder, then the cross-attention
    for tag, b_, h in (("2x4", 8, 6), ("4x2", 4, 3)):
        attention(f"flash_attention@encdec {tag}", b_, 1500, 1500, h, h, 64,
                  0, False)
        attention(f"flash_attention@encdec {tag} cross", b_, 432, 1500, h,
                  h, 64, 0, False)
    torch.cuda.empty_cache()
    return out


def serve_steps(torch, model, params, prompts, max_len: int, extra: dict,
                toks: list | None = None):
    """A prefill and ``SHARD_DECODE_STEPS`` decode steps, fed ``toks`` or
    (``None``) greedy -> (their logits, float32; the prefill's ms and
    each step's; the cache; the tokens fed)."""
    fed = []
    with torch.no_grad():
        (got, cache), pre_ms = timed(torch, lambda: model.prefill_fn(
            params, prompts, max_len, **extra))
        out, steps = [got.float()], []
        for i in range(SHARD_DECODE_STEPS):
            fed.append(got.argmax(-1) if toks is None else toks[i])
            (got, cache), ms = timed(torch, lambda: model.decode_fn(
                params, fed[-1], cache))
            out.append(got.float())
            steps.append(ms)
    return out, pre_ms, steps, cache, fed


def shard_mixer(torch, seed: int, arch: str, mesh_shape, batch: int,
                seq: int, device) -> dict:
    """One model of the mixers step: the sharded prefill over the LM
    phase's prompts and 4 decode steps (fed the single device's greedy
    tokens) against the single-device run on the same weights, in the
    configured bf16 and in float32 (the same 16-bit-stored weights read
    in float32).  Gates: the float32 pair within ``3e-2 * max(1,
    scale)``; the sharded bf16 logits no farther from the single float32
    ones than ``MIXER_BF16_RATIO`` times the single bf16 logits are (the
    bf16 rounding alone takes both past ``3e-2 * scale`` at full depth);
    the launches of the bf16 prefill (the main path's run) equal
    ``mixer_launches``; no whole read of a leaf split over ``model``.
    Returns those launches by kernel row."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (activation_hints,
                                                  is_sharded)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_leaves
    cfg = get_config(arch)
    f32 = dataclasses.replace(cfg, dtype="float32")
    mesh = make_host_mesh(mesh_shape, devices=[device] * math.prod(
        mesh_shape))

    def models(c):
        return (build_model(c, device=device), Served(
            build_model(c, activation_hints(c, mesh, batch, "prefill")),
            build_model(c, activation_hints(c, mesh, batch, "decode"))))
    single, sharded = models(cfg)
    single32, sharded32 = models(f32)
    sp = activation_hints(cfg, mesh, batch, "prefill").seq_parallel()
    held = torch.cuda.memory_allocated() / 1e9
    params = init_params(single.spec(), seed, device=device,
                         store=cfg.dtype)
    seed_conv_taps(torch, params, seed)
    prompts = torch.tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab, (batch, seq)).astype(np.int32), device=device)
    extra = lm_inputs(torch, cfg, seed, batch)
    max_len = seq + SHARD_DECODE_STEPS
    torch.cuda.reset_peak_memory_stats()
    # the single device's greedy tokens feed every other run's steps
    wants, single_ms, single_dec, _, toks = serve_steps(
        torch, single, params, prompts, max_len, extra)
    wants32 = serve_steps(torch, single32, params, prompts, max_len, extra,
                          toks)[0]
    sparams = placed(params, single.spec(), mesh)
    del params
    torch.cuda.empty_cache()
    with MeshSpy() as every:   # whole reads over every sharded run
        kernels.reset_counts()   # the main path's run starts here
        with torch.no_grad(), MeshSpy() as spy:
            (got, scache), mesh_ms = timed(torch, lambda: sharded.prefill_fn(
                sparams, prompts, max_len, **extra))
        launched = dict(kernels.LAUNCHES)   # ... and ends here
        gots, _, dec_ms, scache, _ = serve_steps(
            torch, sharded, sparams, prompts, max_len, extra, toks)
        gots32 = serve_steps(torch, sharded32, sparams, prompts, max_len,
                             extra, toks)[0]
    gathered = every.gathers
    del got

    def errs(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]
    err32 = errs(gots32, wants32)
    bounds = [3e-2 * max(1.0, float(w.abs().max())) for w in wants32]
    mesh16, single16 = errs(gots, wants32), errs(wants, wants32)
    want_launches = mixer_launches(cfg, mesh_shape)
    got_launches = {k: launched[k] for k in want_launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    line = {"phase": "sharding", "part": "mixers", "arch": arch,
            "layers": cfg.n_layers, "store": cfg.dtype, "batch": batch,
            "seq": seq, "max_len": max_len, "mesh": dict(mesh.shape),
            "inputs": {k: list(v.shape) for k, v in extra.items()},
            "f32_logits_err": err32, "f32_logits_bound": bounds,
            "bf16_vs_single_bf16": errs(gots, wants),
            "bf16_vs_single_f32": mesh16,
            "single_bf16_vs_single_f32": single16,
            "launches": got_launches, "expected_launches": want_launches,
            "wgmma_launches": launched["flash_attention_wgmma"],
            "model_split_gathers": len(gathered),
            "seq_rows": spy.seq_rows(),
            "cache_specs": sorted({str(tuple(x.sharding.spec)) for x in
                                   tree_leaves(scache, is_sharded)}),
            "prefill_ms": mesh_ms, "single_prefill_ms": single_ms,
            "decode_ms": dec_ms, "single_decode_ms": single_dec,
            "params_bytes": layout_bytes(sparams),
            "cache_bytes": layout_bytes(scache),
            "allocated_before_gb": held, "peak_device_gb": peak,
            "card": card_line()}
    print(json.dumps(line), flush=True)
    del sparams, scache
    torch.cuda.empty_cache()
    where = f"sharding mixers {arch} {tuple(mesh_shape)}"
    if not all(math.isfinite(e) and e <= b for e, b in zip(err32, bounds)):
        fail(f"{where}: float32 logits off the single device: {err32} "
             f"(bounds {bounds})")
    if not max(mesh16) <= MIXER_BF16_RATIO * max(single16):
        fail(f"{where}: bf16 logits {max(mesh16)} from the float32 ones, "
             f"the single device's {max(single16)}")
    if got_launches != want_launches:
        fail(f"{where}: launches {got_launches}, expected {want_launches}")
    if gathered:
        fail(f"{where}: {len(gathered)} whole reads of leaves split over "
             f"model: {gathered[:4]}")
    # the prompt's rows and whisper's encoder frames
    spy.check(where, [seq] + [v.shape[1] for v in extra.values()
                              if cfg.family == "encdec"],
              mesh.shape["model"], sp)
    if peak >= 80:
        fail(f"{where}: peak device memory {peak} GB")
    rows = {k: {"launches": launched[k]} for k in ("ssd_intra",
                                                   "linear_scan")}
    if want_launches["flash_attention"]:   # the LM phase's row of its model
        tc = launched["flash_attention_wgmma"]
        rows[{m[0]: m[1] for m in LM_MODELS}[arch]] = {
            "launches": launched["flash_attention"],
            "routes": {"wgmma": tc, "simt": launched["flash_attention"] - tc}}
    return rows


class Served:
    """Prefill with one model, decode with the other (a mesh model is
    built per step kind, as the reference builds one)."""

    def __init__(self, pre, dec):
        self.prefill_fn, self.decode_fn = pre.prefill_fn, dec.decode_fn


def shard_mixer_train(torch, seed: int, arch: str, layers: int, batch: int,
                      seq: int, mesh, device) -> None:
    """One FSDP+TP step of ``arch`` at ``layers`` (the SSM and RG-LRU
    mixers on their shards) against the single-device step on the same
    weights and batch, at the yi step's gates: the gradients within
    ``SHARD_GRAD_TOL`` of each leaf's scale, the loss within 2e-3, the
    params after the step within atol 3e-3; no kernel launched.  Each
    side runs ``build_train_step``'s two halves at accum 1,
    ``loss_and_grads`` then ``adamw_update``, so its gradients serve both
    gates; one side's weights and moments are on the card at a time (the
    single device's gradients and updated weights wait on the host)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.distributed.sharding import (activation_hints,
                                                  batch_shardings,
                                                  is_sharded)
    from repro_torch.models import build_model, param_count
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import OptimizerConfig, loss_and_grads
    from repro_torch.train.optimizer import adamw_update, init_opt_state
    cfg = dataclasses.replace(train_config(arch, layers), dtype="float32")
    single = build_model(cfg, device=device)
    model = build_model(cfg, activation_hints(cfg, mesh, batch, "train"))
    opt = OptimizerConfig(**SHARD_OPT)
    data = train_batch(torch, cfg, seed, batch, seq, device)
    sdata = tree_map(lambda x, sh: sh.place(x), data,
                     batch_shardings(data, mesh, batch))
    params = fresh_params(torch, single, seed, device)

    def on_host(tree):   # a copy: AdamW writes the weights in place
        return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)
    start = on_host(params)    # the sharded side starts from these
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()

    def step(m, p, d):
        (loss, _, grads), ms = timed(torch, lambda: loss_and_grads(m, p,
                                                                   d))
        p, _, _ = adamw_update(p, grads, init_opt_state(p), opt)
        return loss, grads, p, ms
    l0, g0, stepped, single_ms = step(single, params, data)
    g0, stepped = on_host(g0), on_host(stepped)
    del params
    torch.cuda.empty_cache()
    sparams = placed(start, single.spec(), mesh)
    del start
    l1, g1, sparams, mesh_ms = step(model, sparams, sdata)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    grad_err = grad_gap(torch, g1, g0, device)
    del g0, g1
    param_err = max(float((a.gather(device) - b.to(device)).abs().max())
                    for a, b in zip(tree_leaves(sparams, is_sharded),
                                    tree_leaves(stepped)))
    loss_err = abs(float(l1) - float(l0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    line = {"phase": "sharding", "part": "mixers_train", "arch": arch,
            "layers": [cfg.n_layers, train_config(arch, None).n_layers],
            "mesh": dict(mesh.shape), "params": param_count(single.spec()),
            "batch": batch, "seq": seq, "loss": float(l1),
            "single_loss": float(l0), "loss_err": loss_err,
            "grad_rel_err": grad_err, "step_param_err": param_err,
            "grads_ms": mesh_ms, "single_grads_ms": single_ms,
            "params_bytes": layout_bytes(sparams),
            "launches": launched, "peak_device_gb": peak,
            "card": card_line()}
    print(json.dumps(line), flush=True)
    del sparams, stepped
    torch.cuda.empty_cache()
    if not grad_err <= SHARD_GRAD_TOL:
        fail(f"sharding mixers train {arch}: gradients off the single "
             f"device by {grad_err} of their scale")
    if not loss_err <= 2e-3:
        fail(f"sharding mixers train {arch}: loss off by {loss_err}")
    if not param_err <= 3e-3:
        fail(f"sharding mixers train {arch}: params off by {param_err}")
    if launched:
        fail(f"sharding mixers train {arch}: launched {launched}")
    if peak >= 80:
        fail(f"sharding mixers train {arch}: peak device memory {peak} GB")


def shard_mixers(torch, seed: int, reps: int, device) -> dict:
    """The mixers step (module docstring, phase 8 (7)) -> the kernels'
    launches on the sharded prefills by kernel row."""
    from repro_torch.launch.mesh import make_host_mesh
    import gc
    rows: dict = {}
    for arch, shape, batch, seq in SHARD_MIXERS:
        gc.collect()
        torch.cuda.empty_cache()
        for row, v in shard_mixer(torch, seed, arch, shape, batch, seq,
                                  device).items():
            got = rows.setdefault(row, {"launches": 0})
            got["launches"] += v["launches"]
            for route, n in v.get("routes", {}).items():
                got.setdefault("routes", {"wgmma": 0, "simt": 0})
                got["routes"][route] += n
    print(json.dumps({"phase": "sharding", "part": "mixer_kernels",
                      "rows": mixer_kernel_ms(torch, seed, reps),
                      "card": card_line()}), flush=True)
    mesh = make_host_mesh(SHARD_MESH, devices=[device] * math.prod(
        SHARD_MESH))
    for arch, layers, batch, seq in SHARD_MIXER_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        shard_mixer_train(torch, seed, arch, layers, batch, seq, mesh,
                          device)
    return rows


def sharding_phase(torch, seed: int, reps: int, device="cuda") -> dict:
    """The LM's mesh forms on a 2x4 data x model mesh over ``[device] *
    8`` (module docstring, phase 8); every gate fatal.  Returns the LM
    kernels' launches on the sharded prefills by kernel row (with the
    attention rows' routes): yi's head shards and the mixers step's."""
    import gc

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    # what earlier phases left allocated: each part's peak counts it
    held = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 1e9
    mesh = make_host_mesh(SHARD_MESH, devices=[device] * math.prod(
        SHARD_MESH))
    parts = {}
    for name, fn in (("train", lambda: shard_train(torch, seed, mesh,
                                                   device)),
                     ("serve", lambda: shard_serve(torch, seed, mesh,
                                                   device)),
                     ("moe", lambda: shard_moe(torch, seed, mesh, device)),
                     ("pipeline", lambda: shard_pipeline(torch, seed,
                                                         device)),
                     ("dp_int8", lambda: shard_dp_compressed(torch, seed,
                                                             device)),
                     ("launcher", lambda: shard_launcher(torch, device)),
                     ("mixers", lambda: shard_mixers(torch, seed, reps,
                                                     device))):
        ts = time.perf_counter()
        parts[name] = fn()
        gc.collect()   # a part's cycles hold card memory until collected
        torch.cuda.empty_cache()
        parts[name + "_s"] = time.perf_counter() - ts
    print(json.dumps({"phase": "sharding_all", "seconds":
                      time.perf_counter() - t0,
                      "allocated_at_start_gb": held,
                      "allocated_after_gc_gb": base,
                      "part_seconds": {k: v for k, v in parts.items()
                                       if k.endswith("_s")}}), flush=True)
    rows = parts["mixers"]
    rows.setdefault("flash_attention", {"launches": 0, "routes": {
        "wgmma": 0, "simt": 0}})
    for route, n in parts["serve"].items():
        rows["flash_attention"]["launches"] += n
        rows["flash_attention"]["routes"][route] += n
    return rows


# the dry run's production cells on the 16x16 mesh of fake devices, each
# in a child process, all at once; the others take from minutes to hours
# of CPU (PERF.md, the dry-run table) and are left out of the smoke
DRYRUN_CELLS = (("yi-6b", "prefill_32k"), ("yi-6b", "decode_32k"),
                ("mamba2-1.3b", "long_500k"), ("hiperfact", ""))
DRYRUN_TIMEOUT = 400
# the dry run's prediction of the yi-6b prefill's new allocations against
# the card's max_memory_allocated increment: the caching allocator rounds
# each block up to 512 bytes and kernels' internal temporaries come on top
DRYRUN_PEAK_BAND = (0.98, 1.10)
# yi-6b prefill_32k with its residual sequence-parallel: at most the peak
# bytes a device the whole residual took (6.90 GiB by ``python -m
# repro_torch.launch.dryrun`` before the sequence split; 7.90 before a
# block's attention half moved into ``_attn_rows``, whose return frees the
# last row's normed input and output, 512 MiB each) ...
DRYRUN_SP_PEAK = 7410712576
# ... and the cells the sequence split does not reach, as they were
# before it: peak bytes a device, each collective kind's bytes
DRYRUN_UNMOVED = {
    "yi-6b__decode_32k": {
        "peak_bytes_per_device": 1193494792,
        "collective_bytes": {"all-gather": 714424320.0,
                             "all-reduce": 12713984.0, "copy": 15360000.0}},
    "mamba2-1.3b__long_500k": {
        "peak_bytes_per_device": 61065736,
        "collective_bytes": {"all-gather": 223243600.0,
                             "all-reduce": 397504.0, "copy": 4100.0}},
}


def dryrun_start(cells=DRYRUN_CELLS) -> list:
    """``python -m repro_torch.launch.dryrun`` on each cell, all at once
    in children that touch no card -> [(arch, shape, child)]."""
    out = ROOT / "build" / "dryrun"
    procs = []
    for arch, shape in cells:
        args = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--mesh", "single", "--out", str(out)]
        if shape:
            args += ["--shape", shape]
        procs.append((arch, shape, subprocess.Popen(
            args, cwd=ROOT, env=launcher_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def dryrun_cells(procs, t0: float) -> list:
    """Wait for ``dryrun_start``'s children (started at ``t0``); one line
    per cell with its record's memory, roofline and bottleneck.  A child
    that fails or runs past ``DRYRUN_TIMEOUT`` fails the phase; every
    child is stopped before this returns."""
    out = ROOT / "build" / "dryrun"
    try:
        for arch, shape, p in procs:
            left = max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0))
            try:
                so, se = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                fail(f"dry run {arch} {shape}: past {DRYRUN_TIMEOUT} s")
            if p.returncode != 0:
                fail(f"dry run {arch} {shape}: rc {p.returncode}: "
                     f"{(se or so).strip().splitlines()[-1:]}")
    finally:
        stop_children(procs)
    rows = []
    for arch, shape, _ in procs:
        tag = f"{arch}__{shape}" if shape else "hiperfact-closure"
        rec = json.loads((out / "single" / f"{tag}.json").read_text())
        det = json.loads((out / "single" / "detail" / f"{tag}.json")
                         .read_text())
        keys = {"arch", "shape", "kind", "params", "active_params", "mesh",
                "lower_s", "compile_s", "memory", "cost_analysis",
                "hlo_bytes", "hlo", "roofline", "bottleneck"}
        if set(rec) != keys or rec["mesh"]["devices"] != 256:
            fail(f"dry run {tag}: record keys {sorted(rec)}, mesh "
                 f"{rec['mesh']}")
        row = {"phase": "dryrun", "cell": tag, "mesh": rec["mesh"]["shape"],
               "trace_s": rec["lower_s"], "build_s": rec["compile_s"],
               "ops": rec["hlo_bytes"], "memory": rec["memory"],
               "peak_gib": rec["memory"]["peak_bytes_per_device"] / 2**30,
               "roofline": rec["roofline"], "bottleneck": rec["bottleneck"],
               "collectives": rec["hlo"]["collectives"],
               "outside": det["outside"],
               **({"cache_len": det["cache_len"]} if "cache_len" in det
                  else {})}
        print(json.dumps(row), flush=True)
        rows.append(row)
    by_cell = {r["cell"]: r for r in rows}
    pre = by_cell.get("yi-6b__prefill_32k")
    if pre is not None and not (
            "reduce-scatter" in pre["collectives"]
            and pre["memory"]["peak_bytes_per_device"] <= DRYRUN_SP_PEAK):
        fail(f"dry run yi-6b prefill_32k: collectives "
             f"{sorted(pre['collectives'])}, peak "
             f"{pre['memory']['peak_bytes_per_device']} (at most "
             f"{DRYRUN_SP_PEAK})")
    for tag, want in DRYRUN_UNMOVED.items():
        row = by_cell.get(tag)
        if row is None:
            continue
        got = {"peak_bytes_per_device":
               row["memory"]["peak_bytes_per_device"],
               "collective_bytes": {k: c["bytes"] for k, c in
                                    row["collectives"].items()}}
        if got != want:
            fail(f"dry run {tag}: {got}, before the sequence split {want}")
    return rows


def dryrun_card_check(torch, seed: int) -> dict:
    """The dry run held against the card: yi-6b whole in the 16-bit
    store, the LM phase's B 2 x 2048 prefill, traced on ``meta:0`` and
    run on ``cuda:0`` under the same recorder.  Gates: the ops by aten
    name and the products identical, the kernel records equal to
    ``kernels.LAUNCHES``' deltas, the argument bytes equal to the bytes
    the card holds for weights and tokens, the predicted new allocations
    within ``DRYRUN_PEAK_BAND`` of ``max_memory_allocated``'s increment,
    and the measured prefill at or above the roofline bound."""
    import gc

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.fake import ShapeMode
    from repro_torch.launch.hlo_analysis import Recorder, analyze_trace
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import (abstract_params, store_spec,
                                           tree_leaves, tree_map)

    cfg = get_config("yi-6b")
    B, S = LM_BATCH, 2048
    max_len = S + LM_STEPS
    meta0, cuda0 = torch.device("meta", 0), torch.device("cuda", 0)
    # the trace on meta:0
    fake_model = build_model(cfg, device=meta0)
    spec = store_spec(fake_model.spec(), cfg.dtype)
    with ShapeMode():
        fake_params = tree_map(lambda x: x.to(meta0), abstract_params(spec))
        fake_toks = torch.empty((B, S), dtype=torch.int32, device=meta0)
        fake, mem, trace_s = D.trace_cell(
            lambda p, t: fake_model.prefill_fn(p, t, max_len),
            (fake_params, fake_toks), [meta0])
    del fake_params, fake_toks
    pred = analyze_trace(fake, D.LINK_BW)
    mem = mem[meta0]
    # the run on cuda:0, under the same recorder
    model = build_model(cfg)
    params = init_params(model.spec(), seed, store=cfg.dtype)
    toks = torch.tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab, (B, S)).astype(np.int32), device="cuda")
    held = sum(x.nbytes for x in tree_leaves(params)) + toks.nbytes
    times = []
    for _ in range(4):   # a warm-up, then three timed runs
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = model.prefill_fn(params, toks, max_len)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
        del out
    prefill_s = statistics.median(times[1:])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_counts()
    real = Recorder(devices=[cuda0], span=D.link_spans([cuda0]))
    t0 = time.perf_counter()
    with real:
        out = model.prefill_fn(params, toks, max_len)
    torch.cuda.synchronize()
    recorded_s = time.perf_counter() - t0
    increment = torch.cuda.max_memory_allocated() - before
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    del out
    st_f, st_r = fake.stats[meta0], real.stats[cuda0]
    ops_f = {k: v for k, v in st_f.ops.items() if v}
    ops_r = {k: v for k, v in st_r.ops.items() if v}
    predicted = mem["peak_bytes_per_device"] - mem["argument_bytes"]
    compute_s = pred["flops_per_device"] / D.PEAK_FLOPS
    memory_s = pred["mem_bytes_per_device"] / D.HBM_BW
    bound_s = max(compute_s, memory_s)
    row = {"phase": "dryrun_card", "arch": "yi-6b", "store": cfg.dtype,
           "batch": B, "prompt": S, "max_len": max_len,
           "trace_s": trace_s, "ops": sum(ops_f.values()),
           "ops_equal": ops_f == ops_r,
           "ops_only_traced": {k: v - ops_r.get(k, 0) for k, v in
                               ops_f.items() if v != ops_r.get(k, 0)},
           "ops_only_card": {k: v - ops_f.get(k, 0) for k, v in
                             ops_r.items() if v != ops_f.get(k, 0)},
           "outside": [dict(fake.outside), {str(k): v for k, v in
                                            real.outside.items()}],
           "product_flops": [st_f.product_flops, st_r.product_flops],
           "kernel_records": [dict(st_f.kernels), dict(st_r.kernels)],
           "launches": launches,
           "argument_bytes": mem["argument_bytes"], "card_bytes": held,
           "predicted_new_bytes": predicted, "measured_increment": increment,
           "peak_ratio": increment / predicted if predicted else None,
           "peak_band": list(DRYRUN_PEAK_BAND),
           "flops": pred["flops_per_device"],
           "mem_bytes": pred["mem_bytes_per_device"],
           "compute_s": compute_s, "memory_s": memory_s, "bound_s": bound_s,
           "prefill_s": prefill_s, "prefill_s_runs": times[1:],
           "prefill_over_bound": prefill_s / bound_s,
           "recorded_prefill_s": recorded_s}
    print(json.dumps(row), flush=True)
    if not row["ops_equal"]:
        fail(f"dry run vs card: ops differ {row['ops_only_traced']} / "
             f"{row['ops_only_card']}")
    if fake.outside or real.outside:
        fail(f"dry run vs card: ops off the device {row['outside']}")
    if st_f.product_flops != st_r.product_flops or \
            st_f.products != st_r.products:
        fail(f"dry run vs card: product FLOPs {row['product_flops']}")
    if dict(st_r.kernels) != launches or dict(st_f.kernels) != launches \
            or not launches:
        fail(f"dry run vs card: kernel records {row['kernel_records']}, "
             f"launches {launches}")
    if mem["argument_bytes"] != held:
        fail(f"dry run vs card: argument bytes {mem['argument_bytes']} vs "
             f"{held} on the card")
    lo, hi = DRYRUN_PEAK_BAND
    if not lo * predicted <= increment <= hi * predicted:
        fail(f"dry run vs card: predicted {predicted} new bytes, the card "
             f"allocated {increment} more")
    if prefill_s < bound_s:
        fail(f"dry run vs card: prefill {prefill_s} s below the roofline "
             f"bound {bound_s} s")
    del params, model
    torch.cuda.empty_cache()
    return row


def stop_children(procs) -> None:
    for _, _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def dryrun_phase(torch, seed: int, procs, t0: float) -> None:
    """Phase 9 (module docstring): the production cells' CPU children
    (``dryrun_start``, started at ``t0``, before the sharding phase, whose
    card work their tracing overlaps), the card check, then the cells are
    read."""
    t1 = time.perf_counter()
    try:
        card = dryrun_card_check(torch, seed)
    except BaseException:
        stop_children(procs)
        raise
    t2 = time.perf_counter()
    cells = dryrun_cells(procs, t0)
    print(json.dumps({"phase": "dryrun_all",
                      "seconds": time.perf_counter() - t1,
                      "since_children_start_s": time.perf_counter() - t0,
                      "card_check_s": t2 - t1,
                      "cells": [c["cell"] for c in cells],
                      "prefill_over_bound": card["prefill_over_bound"]}),
          flush=True)


KERNELS = [
    {"name": "bitonic_sort", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/bitonic_sort.cu",
     "replaces": "src/repro/kernels/sortmerge/sortmerge.py:218"},
    {"name": "bitonic_sort_kv", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/bitonic_sort.cu",
     "replaces": "src/repro/kernels/sortmerge/sortmerge.py:252"},
    {"name": "probe_sorted", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/probe_sorted.cu",
     "replaces": "src/repro/kernels/mergejoin/mergejoin.py:46"},
    {"name": "merge_ranks", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/merge_ranks.cu",
     "replaces": "src/repro/kernels/sortmerge/sortmerge.py:172"},
    {"name": "unique_mask_sorted", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/unique_mask.cu",
     "replaces": "src/repro/kernels/uniquefilter/uniquefilter.py:32"},
    {"name": "flash_attention", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
     "sources": {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    # the same wrapper at moonshot-v1-16b-a3b's MHA shape (16/16 heads,
    # hd 128): its launches are moonshot's
    {"name": "flash_attention@mha", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
     "sources": {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    # the same wrapper at head dim 256 (recurrentgemma-9b), where it takes
    # the tensor-core kernel's hd-256 tiles (and times the CUDA-core
    # kernel's second instantiation on the same inputs)
    {"name": "flash_attention@hd256", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
     "sources": {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    # the same wrapper at whisper-tiny's non-causal attention (6/6 heads,
    # hd 64): the encoder over 1500 frames, and the decoder's cross-
    # attention onto them (``cross``); its launches are whisper's
    {"name": "flash_attention@encdec", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
     "sources": {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    # the same wrapper at head dim 96 (phi-3-vision-4.2b), where it takes
    # the tensor-core kernel's hd-96 tiles; its launches are phi-3-vision's
    {"name": "flash_attention@hd96", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
     "sources": {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                 "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
     "replaces": "src/repro/kernels/flash_attention/flash_attention.py:92"},
    {"name": "ssd_intra", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/ssd_intra.cu",
     "replaces": "src/repro/kernels/ssd/ssd.py:53"},
    # not a Pallas kernel: the reference's RG-LRU scan runs in XLA
    {"name": "linear_scan", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
     "replaces": "src/repro/models/rglru.py:67 (jax.lax.associative_scan, "
                 "XLA)"},
]
QUEUED: list = []  # every Pallas kernel of the reference has a port


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=500,
                    help="lubm_like scale (~2136 base facts per unit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=7,
                    help="timed runs per kernel (median reported)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1

    t_smoke = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    # float32 products in full float32 wherever kernels meet plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_library_s": secs}), flush=True)

    # every run of the fact path adds its kernels' launches by size and
    # its index-mirror merge shapes here; the kernel phase checks each
    from repro_torch.backend import torch_ops
    sizes = new_sizes()
    shapes, undo = merge_shapes(torch_ops)
    launches, oracle = engine_phase(torch, args.scale, args.seed, sizes,
                                    shapes)
    seen = {k: 0 for k in launches}
    for counts in (demand_phase(torch, oracle, sizes, shapes),
                   serving_phase(torch, oracle["facts"], args.seed, sizes,
                                 shapes)):
        seen = {k: seen[k] + counts[k] for k in seen}
    for name in SERVING_KERNELS:
        if seen[name] <= 0:
            fail(f"kernel {name} never launched in the demand and serving "
                 "phases")
    launches = {k: launches[k] + seen[k] for k in launches}
    launcher_phase(sizes, shapes)
    sharded = sharded_phase(torch, oracle, args.seed, sizes, shapes)
    launches = {k: launches[k] + sharded[k] for k in launches}
    del oracle
    undo()
    print(json.dumps({"path_sizes": {
        group: {k: dict(sorted(v.items())) for k, v in per.items()}
        for group, per in sizes.items()},
        "path_merge_shapes": sorted(set(shapes))}), flush=True)
    lm = lm_phase(torch, args.seed, LM_STEPS)
    for row, v in lm.items():
        if v["launches"] <= 0:
            fail(f"kernel row {row} never launched in the LM phase")
    launches.update({row: v["launches"] for row, v in lm.items()})
    train_phase(torch, args.seed)
    rows = kernel_phase(torch, args.seed, args.reps, sorted(set(shapes)),
                        sizes)
    corpus = trainer_phase(torch, args.seed, args.reps)
    launches = {k: launches[k] + corpus.get(k, 0) for k in launches}
    # the dry run's CPU children trace while the sharding phase runs
    t_dry = time.perf_counter()
    procs = dryrun_start()
    try:
        # last, so the kernel phase's sort profiles run as in earlier
        # slices
        sharded_lm = sharding_phase(torch, args.seed, args.reps)
    except BaseException:
        stop_children(procs)
        raise
    for row, v in sharded_lm.items():
        launches[row] += v["launches"]
        for route, n in v.get("routes", {}).items():
            lm[row]["routes"][route] += n
    dryrun_phase(torch, args.seed, procs, t_dry)

    line = []
    for k in KERNELS:
        r = rows[k["name"]]
        extra = {}
        if k["name"] == "flash_attention":  # launches by route, and the
            extra = {"routes": lm[k["name"]]["routes"],  # CUDA-core time
                     "simt_ms": r["simt_ms"]}
        elif k["name"] == "flash_attention@hd256":  # launches by route,
            extra = {"routes": lm[k["name"]]["routes"],  # CUDA-core, SDPA
                     "simt_ms": r["simt_ms"],
                     "sdpa_ms": r["library_ms"],
                     "sdpa_backend": r["sdpa_backend"],
                     "sdpa_max_abs_err": r["sdpa_max_abs_err"],
                     "window": r["window"]}
        elif k["name"] in ATTENTION_ROWS:  # launches by route, SDPA, the
            extra = {"routes": lm[k["name"]]["routes"],  # CUDA-core time
                     "sdpa_ms": r["library_ms"],  # on wgmma, whisper's
                     "sdpa_backend": r["sdpa_backend"],  # cross-attention
                     "sdpa_max_abs_err": r["sdpa_max_abs_err"],
                     **{key: r[key] for key in ("simt_ms", "cross")
                        if key in r}}
        elif k["name"] == "merge_ranks":  # the two launches apart
            extra = {"left_ms": r["left_ms"], "right_ms": r["right_ms"]}
        elif k["name"] == "ssd_intra":  # the gram pass, the old yardstick
            extra = {"gram_ms": r["gram_ms"],
                     "bound_old_ms": r["bound_old_ms"]}
        elif k["name"] == "linear_scan":  # from h0, the float64 check
            extra = {"h0_ms": r["h0_kernel_ms"], "h0": r["h0"],
                     "f64_max_abs_err": r["f64_max_abs_err"]}
        line.append({**k, "status": "ported and checked",
                     "launches": launches[k["name"]],
                     "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], **extra})
    print(json.dumps({"phase": "all", "seconds":
                      time.perf_counter() - t_smoke}), flush=True)
    print(json.dumps({"kernels": line, "queued": QUEUED, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
