#!/usr/bin/env python3
"""Drive the PyTorch port's main, serving, streaming, sharded, collective,
first-generation, retrieval, competitor-loader and LM serving paths (every
family of the repo's model configs) on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases (any failure exits non-zero; nothing is caught):

1. The card: its name, the device count and ``nvidia-smi``'s name and
   power limit.
2. Build: the CUDA sources under ``src/repro_torch/kernels/csrc/`` compile
   with ``nvcc`` (one process per source, all at once); the ``-Xptxas -v``
   register and spill lines are printed.
3. Main path at d = 2: ``osm_like(10_000_000, seed=7)`` is bulk loaded by
   FMBI on the host, exported to the card plain and compressed, and a
   1024-window batch and a 1024-query k = 16 k-NN batch run on each export.
   The launch counts are zeroed just before and read just after; each of
   the path's four kernels must have launched.  The first 32 windows and the first 16 k-NN
   queries are held against a NumPy brute force over all points (equal id
   sets; equal f32 distance sequences), and two queries whose every squared
   distance overflows f32 (a coordinate of 2e19, one of +inf) must answer
   k distinct dataset rows at +inf on both exports and both engines.
4. The same at d = 5 over ``nycyt_like(2_000_000)``, with the windows
   (half-width 0.05) centred at dataset rows so that they hold points.
   Phases 3a, 3s, 3h, 3c, 3u, 3w, 5 and 3b at d = 2 run right after
   phase 3, and 4u, 4w, the d = 5 retrieval phase right after phase 4, on
   their exports, points and batches.
3a. Serving (``DeviceQueryServer``, microbatches of 64).  Static: the
   server over phase 3's index answers its 1024 windows and 1024 k-NN
   queries; every window equals the fused batch's id set and every k-NN
   distance sequence the fused batch's.  Adaptive: an ``AMBI`` over phase
   3's points rounded to f32 (buffer 5 % of the pages) boots the server
   from its single unrefined root (no leaf on the card, one cold row);
   16 window batches (half-width 0.01) and 16 k-NN batches (k = 16) of 64
   queries, each a centre plus a jitter in [0, 0.08), alternate between
   two dataset rows (both drawn with ``default_rng(13)``), the launch
   counts zeroed before and read after (the four main-path kernels must
   have launched); the first four batches of each kind are replayed (no
   cold query, no page I/O).  Windows of batches 0, 4, 8, 12, 15 and of
   the replay, and the first 16 k-NN queries of each, equal a brute force
   over all points; the AMBI stays partial; one full export, every leaf
   on the card uploaded once, one delta refresh per swap; no retry, host
   fallback or degraded answer (without a fault plan, each would hide a
   device fault).  Then ``window_hot``/``knn_hot`` over phase 3's first 64
   windows and queries: a certificate is incomplete exactly where the
   query reaches cold space, and complete answers equal the brute force.
3s. Streaming, right after 3a on the same points rounded to f32:
   ``StreamingIndex(points, buffer_pages=1466)`` bulk loads the base tier
   and ``DeviceQueryServer.from_streaming`` (microbatches of 64, a journal
   and a snapshot in a temporary directory) exports its mirror.  The
   reference's streaming traffic (``bench_hotpaths``): 32 inserts of 1024
   uniform points (``default_rng(5)``, rounded to f32); after every fourth,
   32 base and 16 inserted rows deleted (``default_rng(17)``); after every
   eighth, phase 3's first 64 windows and 64 k-NN queries (k = 16, rounded
   to f32).  The counts are zeroed before the first insert and read after
   the last round; the four main-path kernels must have launched.  The
   base tier never merges, so its 256 tombstones make the last round's
   k-NN over-fetch ``k_eff`` = 512 rows, more than a leaf's 341 slots.
   The run must flush, fuse and rebuild-merge; one full export (the boot)
   and one delta per sync; the export never stale; no retry, host
   fallback or degraded answer; no deleted id in any answer, and the first
   16 windows and k-NN queries of each round equal a brute force over the
   live rows.  Then a ``Frontend`` over the server (a virtual-clock burst
   of 256 mixed requests at ``queue_bound`` 64, and 64 in real time):
   admitted answers equal the server's, rejected ones carry certificates.
   The server is dropped without a barrier (what a kill leaves) and
   ``recover`` must replay the 40 journaled ops and answer the last
   round's queries as the live server did.  Phase 3a's adaptive server
   then takes 1024 inserts and 16 deletes into a streaming overlay and
   answers a window and a k-NN batch against the brute force.  Last, an
   adaptive server over ``osm_like(1_000_000)`` (rounded to f32) with a
   journal, ``compact_slack=0`` (compaction barriers) and a hotspot
   stream of 4 + 4 batches is killed and recovered: equal tables in every
   column and equal answers.  Its timings: bulk load, points per second,
   every ``apply_delta``, warm batches, checkpoints and recovery.
3h. Sharded serving, right after 3s, on phase 3's index and batches.
   Static: ``ShardedDeviceTable.from_index`` at m = 4 and m = 8 (timed
   to ``torch.cuda.synchronize()``), the 1024 windows and 1024 k-NN
   queries through ``window_query_batch_sharded`` /
   ``knn_query_batch_sharded`` in one batch (three runs), then a
   ``shards=4`` server in microbatches of 64: every window equals the
   fused single-table batch's id set, every k-NN distance sequence the
   fused batch's; shards probed per window, round-1 home shards and
   round-2 (query, shard) pairs are logged.  Outage: a ``FaultPlan``
   kills shard 1's ``shard_dispatch`` (two attempts, breaker threshold
   1): a window's certificate is incomplete exactly where it reaches
   shard 1's router box, naming shard 1 alone, with the other shards'
   share of the fused answer; a k-NN answer holds no id of shard 1, is
   ``certified_exact`` exactly where shard 1's router mindist exceeds
   its k-th distance (then equal to the fused answer), and the first 16
   equal a brute force over the other shards' points; ``repair([1])``
   re-exports one shard and every answer equals the fused batch's again.
   Adaptive: an ``AMBI`` over the points rounded to f32 (phase 3a's
   buffer) behind ``from_ambi(..., shards=4)``, phase 3a's 16 + 16
   hotspot batches: the boot plans one shard, the server re-plans to
   four, and ``full_exports`` = 1 + 4 + the later per-changed-shard
   refreshes (each timed); windows of batches 0, 4, 8, 12, 15 and 16 k-NN
   queries of each equal the brute force.  Streaming: a
   ``StreamingIndex`` of the same points behind ``from_streaming(...,
   shards=4)`` (no journal) fed phase 3s's traffic: no full re-shard,
   per-shard refreshes (each timed) fewer than 4 per sync, the export
   never stale, no deleted id, the first 16 windows and k-NN queries of
   each round equal a brute force over the live rows.  Each part zeroes
   the counts before and reads them after (the four main-path kernels
   must have launched) and asserts no retry, host fallback or degraded
   answer where no fault plan is armed.
3c. The collective build and rounds over a ``torch.distributed`` process
   group, right after 3h, on phase 3's points as f32.  Four gloo ranks
   (``mesh.run_ranks``) share ``cuda:0``: NCCL puts no two ranks on one
   card, so each collective is staged through host tensors while the
   compute stays on the card.  The points reach the ranks through an
   ``.npy`` each memory-maps.  ``shard_build`` at ``levels_local`` = 14
   (about 305 slots per leaf): kept plus dropped rows make n, no row id
   twice, all in range; ``shard_knn`` over phase 3's 1024 queries: every
   rank the same answer, every certified one equal to a brute force over
   the kept rows (plain PyTorch on the card); ``knn_batch_shard_map`` over
   the first 64 queries on ``ShardedDeviceTable.from_index(index,
   4).stacked()``: distances equal to phase 3's fused batch and the brute
   force, ids equal except among ties; ``window_count_batch_shard_map``
   over the 1024 windows: equal to phase 3's counts.  The built shards go
   through ``shard_build_tables`` and ``from_tables`` behind the sharded
   protocols: every window equals the kept rows of the fused answer (the
   first 32 a brute force over the kept rows) and every k-NN answer the
   brute force; ``box_hits`` and ``pair_window_ids`` must have launched
   for the windows, ``leaf_mindist`` and ``pair_dist2`` for the k-NN, and
   the router's pruning is counted as in 3h.  Then an NCCL world of one
   over the first 1M points (the m = 1 branch; a transport check, not the
   full-width path).  Each rank
   logs its build spans (sample gather, route, ``all_to_all`` with the
   bytes staged through the host, local build), its round times and its
   launch counts; ``partition_assign``, ``leaf_mindist``,
   ``gathered_dist2`` and ``window_count_tiles`` must have launched on
   every rank of the four.  A rank's failure fails the run, naming it.
3u. First-generation engine (``fused=False``) on phase 3's two exports,
   the same windows and k-NN queries, three runs each, counts zeroed
   before and read after: ``box_hits``, ``window_mask_gathered``,
   ``leaf_mindist`` and ``gathered_dist2`` must have launched and
   ``pair_window_ids`` and ``pair_dist2`` must not.  Every window must
   equal the fused batch's id set and every k-NN distance sequence the
   fused batch's, on each export.
3w. ``ops.window_count`` over all of phase 3's points for its 1024
   windows (counts zeroed before, read after; ``window_count_tiles`` must
   have launched): every count must equal the fused window batch's size.
5. Retrieval at d = 2 (run right after phase 3w, while its points and
   index are in memory): ``RetrievalServer(points, levels=15)`` builds the
   balanced grid index on the card over phase 3's points (f32), then runs,
   each cold and warm: ``knn`` over phase 3's 1024 queries (k = 16, 16
   candidate leaves), ``window_count`` over phase 3's 1024 windows,
   ``knn_kernel`` (brute force) over the first 64 queries, an adaptive
   ``knn`` stream (``route`` each batch), ``route`` of every point (FMBI's
   Step-2 shape) and a snapshot boot (phase 3's FMBI index saved, served
   by ``RetrievalServer.from_snapshot``, ``knn`` through
   ``nearest_leaf``).  The counts are zeroed before and read after; each
   of the phase's four kernels must have launched.  Every window count
   must equal phase 3's fused window batch (f32 export), and the first 16
   certified ``knn`` answers and 16 ``knn_kernel`` answers the NumPy brute
   force.  Then the NaN-row case (ROADMAP C.7): 10 evenly spread rows get
   a NaN y and a second server is built over them; no NaN row may be
   answered by ``knn`` or ``knn_kernel``, and the first 16 answers of each
   equal the brute force.  The selection's total-order key pass, its
   stable sort and the whole ``top_k`` are timed on grid ``knn``'s two
   selection planes.
3b. Competitor loaders, right after phase 5: each of the six
   ``ALL_LOADERS`` trees (FMBI, Hilbert packing, STR, OMT, KDB, Waffle)
   over ``osm_like(3_000_000, seed=7)`` (phase 3's generator cut from 10M
   points for the host builds' time; buffer 5 % of the pages), built on
   the host (seconds, IOStats, ``leaf_stats``, ``overlap_area_2d``),
   exported to the card (f32) and queried with phase 3's generators (1024
   windows of half-width 0.01, 1024 k-NN queries with k = 16, three runs
   each), the counts zeroed before and read after each tree (the four
   main-path kernels must launch for every tree).  Every window's id set
   and every k-NN distance sequence must be equal across the six trees,
   and the first 32 windows and 16 queries equal the brute force.
6. The same at d = 5 over phase 4's points and queries, ``levels=13``.
7. Kernels: each kernel is called on the inputs its path gave it (the
   largest call per kernel and bound type for ``box_hits``,
   ``window_mask_gathered`` and the retrieval kernels, the first for the
   others, recorded during phases 3, 3u, 3w and 5; ``window_count_tiles``
   at all 1024 windows over all points; ``partition_assign`` also at its
   smallest call, one adaptive batch of 64 queries, which takes the
   small-n kernel where all points take the shared-table one; the other
   kernels of ``SMALLEST`` also at their smallest call) and held bit for
   bit against its plain PyTorch version on the card; both are timed with
   CUDA events, ``pairwise_dist2`` beside ``torch.cdist``, and every timed
   kernel call also by its device time under ``torch.profiler``, with
   the L2 flushed before each call for the kernels of ``COLD_L2``.  Phase
   3a's calls are held bit for bit too, untimed: the static server's first
   (largest) and smallest call of each main-path kernel, and the adaptive
   stream's first (largest), smallest and last (the one-row root level at
   boot, cold slots, the leaf blocks that ``apply_delta`` appended).  The
   same comparison runs at d = 5, where the six redesigned kernels
   (``TIMED_D5``) are timed too.  Phase 3s's calls (``<dtype>:stream``,
   its last k-NN round at ``k_eff`` = 512 among them) are held the same
   way, untimed, and so are phase 3h's (``<dtype>:sharded``: the
   shards' ragged query counts, the one-row root level of a partial
   shard, the refreshed shards), rank 0's calls of phase 3c
   (``<dtype>:collective``, saved by the rank with ``torch.save``) and
   its protocols' calls on the built shards
   (``<dtype>:collective_tables``: first, smallest and last), and phase
   3b's per tree (``<dtype>:competitors:<loader>``: first, smallest and
   largest; Hilbert's overlapping boxes and KDB's unpacked leaves).  Each
   phase also counts its launches by shape (``launch_shapes``).
   ``gathered_dist2`` and ``pair_dist2`` are timed beside one batched
   ``torch.cdist`` (direct sums, squared) as ``pairwise_dist2`` is beside
   ``torch.cdist``.
8. LM serving, after phase 7: the dense LM at qwen3-0.6b's full width
   (28 layers, d 1024, 16/8 heads of 128, d_ff 3072, vocab 151,936, tied
   embeddings), its weights drawn from a seeded ``torch.Generator`` on
   the card.  In float32, the prefill of a 2 x 120 prompt and 8 decode
   steps must be within ``LM_TOL`` of one full forward over the 128
   tokens, and ``LMServer.generate`` of 2 x 128 -> 16 new tokens must
   equal the argmax of one full forward over the prompt and the generated
   tokens.  Then ``generate`` in bfloat16 (batch 4, prompt 512, 64 new
   tokens) is timed: prefill, decode per step, tokens per second, peak
   allocation.  The float32 checks are repeated on a gemma3-style config
   at d_model 1024 (five local layers of window 1024 and a global one,
   then two remainder local layers) with a 512-token prompt.
9. The LM's other families, after phase 8, at their published widths
   (``FAMILIES``): rwkv6-3b (32 layers), jamba-v0.1-52b cut to one
   superblock (8 layers: 1 attention, 7 Mamba, 4 MoE FFNs of 16
   experts), qwen3-moe-235b-a22b cut to 2 layers (128 experts, top 8),
   arctic-480b cut to 1 layer (128 experts, dense residual),
   seamless-m4t-medium (12 + 12 layers, frames) and internvl2-2b (24
   layers, 256 patches), each drawn from a seeded ``torch.Generator`` on
   the card and freed before the next.  In float32 (capacity factor
   E / top_k, at least 8: no dropped assignment, asserted; arctic's 56
   GB of float32 weights have no check) the prefill of a 2 x 120 prompt (seamless: 56 tokens
   beside 2 x 256 frames; internvl2: after 2 x 256 patches) and 8 decode
   steps must be within ``LM_TOL`` of one full forward, and greedy
   generation of 16 tokens must equal teacher forcing.  A random
   32-layer RWKV6 amplifies float32 rounding past ``LM_TOL``, so its
   checks run on the same weights in float64, with a 2 x 500 prompt
   too, no multiple of its chunk (ROADMAP C.9); its float32 model must
   be within ``WITNESS_TOL`` of the float64 forward at both lengths, and
   its bfloat16 model beyond it.  Each MoE config's float32 router picks the
   same experts as a float64 recomputation on the card wherever the k-th
   and next gate are 1e-6 apart.  Then the shipped config in bfloat16:
   ``generate`` (``prefill``/``decode_step`` for seamless and internvl2)
   of 4 x 512 -> 32 tokens (seamless: frames 4 x 512, prompt 64;
   internvl2: 256 patches and 256 tokens), timed twice: prefill ms,
   decode ms per step, tokens per second, peak allocation and the
   dropped assignments per MoE layer.

``--profile`` adds a ``torch.profiler`` trace of one batch of each kind
per export, fused and first-generation, of one hot adaptive window and
k-NN batch (phase 3a's first batch, replayed), of phase 3s's window and
k-NN batch on the multi-tier state, of one warm 64-query window and k-NN
microbatch of phase 3h's ``shards=4`` server and one insert of 2048
points with its sharded sync, of the fused window batch's
frontier alone (``box_hits`` and the mask operations around it), of
phase 3b's window and k-NN batch per tree, of phase 8's bfloat16 prefill
and one decode step, of one bfloat16 decode step per phase-9 config, and
of the retrieval ``knn``,
``window_count`` and ``knn_kernel`` batches (device busy time, idle
share, time by kernel name).  The line before the last is one JSON
object listing the kernels; the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the ``src/`` tree beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
REPO = pathlib.Path(__file__).resolve().parent

REPLACES = {
    "box_hits": ("src/repro_torch/kernels/csrc/window_filter.cu",
                 "src/repro/kernels/window_filter.py:229"),
    "pair_window_ids": ("src/repro_torch/kernels/csrc/window_filter.cu",
                        "src/repro/kernels/window_filter.py:299"),
    "leaf_mindist": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                     "src/repro/kernels/knn_topk.py:142"),
    "pair_dist2": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                   "src/repro/kernels/knn_topk.py:192"),
    "partition_assign": ("src/repro_torch/kernels/csrc/partition_assign.cu",
                         "src/repro/kernels/partition_assign.py:48"),
    "window_count_gathered": ("src/repro_torch/kernels/csrc/window_filter.cu",
                              "src/repro/kernels/window_filter.py:183"),
    "pairwise_dist2": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                       "src/repro/kernels/knn_topk.py:96"),
    "gathered_dist2": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                       "src/repro/kernels/knn_topk.py:59"),
    "window_mask_gathered": ("src/repro_torch/kernels/csrc/window_filter.cu",
                             "src/repro/kernels/window_filter.py:128"),
    "window_count_tiles": ("src/repro_torch/kernels/csrc/window_filter.cu",
                           "src/repro/kernels/window_filter.py:85"),
}
MAIN_PATH = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2")
RETRIEVAL = ("partition_assign", "window_count_gathered", "pairwise_dist2",
             "gathered_dist2")
UNFUSED = ("box_hits", "window_mask_gathered", "leaf_mindist", "gathered_dist2")
FUSED_ONLY = ("pair_window_ids", "pair_dist2")   # must not launch unfused
# the phase whose launch counts the kernels line reports
PHASE = {**dict.fromkeys(MAIN_PATH, "d2"), **dict.fromkeys(RETRIEVAL, "retrieval_d2"),
         "window_mask_gathered": "unfused_d2", "window_count_tiles": "window_count_d2"}
OPS_NAME = {
    "box_hits": "box_hits_tiled",
    "pair_window_ids": "pair_window_ids",
    "leaf_mindist": "leaf_mindist_tiled",
    "pair_dist2": "pair_dist2",
    "partition_assign": "partition_assign",
    "window_count_gathered": "window_count_gathered",
    "pairwise_dist2": "pairwise_dist2",
    "gathered_dist2": "gathered_dist2",
    "window_mask_gathered": "window_mask_gathered",
    "window_count_tiles": "window_count",
}
# the argument whose dtype keys a recorded call (the bounds or the points)
BOUND_ARG = {"box_hits": 0, "pair_window_ids": 2, "leaf_mindist": 1,
             "pair_dist2": 1, "partition_assign": 0, "window_count_gathered": 2,
             "pairwise_dist2": 1, "gathered_dist2": 1, "window_mask_gathered": 2,
             "window_count_tiles": 2}
LARGEST = ("box_hits", "window_mask_gathered") + RETRIEVAL
# also kept: the smallest call (``route`` of one adaptive batch of 64
# queries; the root level of the frontier; the last rounds' pair chunks),
# timed by its device time: the launches a per-launch table leaves out
SMALLEST = ("partition_assign", "box_hits", "pair_window_ids", "leaf_mindist",
            "pair_dist2")
# timed at d = 5 as well (the kernels with a redesign to compare)
TIMED_D5 = ("window_count_tiles", "partition_assign", "box_hits", "pair_window_ids",
            "pair_dist2", "window_count_gathered")
# timed with a cold L2: the main path reaches these after traffic larger
# than the 50 MB L2 (pair_dist2 after the mindist plane and its top-k,
# window_count_gathered after the 320 MB gather of its candidates' points)
COLD_L2 = ("pair_dist2", "window_count_gathered")
L2_FLUSH_BYTES = 128 << 20
# traces that device_ms and device_trace take before they give up on a
# whole one
TRACE_TRIES = 4
# torch.profiler drops the first device events of every trace once the
# process has done enough CUDA work outside traces (on the H100: none in a
# fresh process, 2-3 per trace after the main path, once more than 64;
# waiting at the trace's ends does not help).  Each trace therefore opens
# with LEAD_MARKS fills of a one-byte tensor (kernels named MARK_NAME, which
# the port never launches) and closes with one; a trace whose first or last
# device event is not a mark may have lost events of its own, and is taken
# again with twice the lead.
LEAD_MARKS = 64
MARK_NAME = "FillFunctor<unsigned char>"


def log(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------------------
# recording the main path's kernel inputs
# --------------------------------------------------------------------------
class Recorder:
    """Wraps the public wrappers of ``names`` while a path runs and keeps,
    per kernel and bound dtype, the arguments of one call: the largest for
    ``box_hits``, ``window_mask_gathered`` and the retrieval kernels, the
    first call (the whole batch's first round or first pair chunk) for the
    others, and for the kernels of ``SMALLEST`` also the smallest (key
    dtype ``<dtype>:smallest``); with ``last``, also every kernel's last
    call (``<dtype>:last``); with ``largest``, also every kernel's largest
    call (``<dtype>:largest``).  ``suffix`` follows the dtype in every key.
    ``shapes`` counts the calls of every kernel, not only those of
    ``names``, by ``"<bound argument shape> -> <output shape>"``."""

    def __init__(self, ops, names, suffix="", last=False, largest=False):
        self.ops = ops
        self.names = names
        self.suffix = suffix
        self.last = last
        self.largest = largest
        self.calls: dict = {}
        self.shapes: dict = {}
        self._orig = {}

    def __enter__(self):
        for name in OPS_NAME:
            fn_name = OPS_NAME[name]
            orig = getattr(self.ops, fn_name)
            self._orig[fn_name] = orig
            setattr(self.ops, fn_name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for fn_name, orig in self._orig.items():
            setattr(self.ops, fn_name, orig)

    def _wrap(self, name, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            bound = args[BOUND_ARG[name]]
            dtype = str(bound.dtype).replace("torch.", "")
            label = dtype + self.suffix
            key = (name, label)
            if name in self.names and (key not in self.calls or (
                    name in LARGEST and first.numel() > self.calls[key][2])):
                self.calls[key] = (args, kw, first.numel())
            small = (name, f"{label}:smallest")
            if name in self.names and name in SMALLEST and (
                    small not in self.calls or first.numel() < self.calls[small][2]):
                self.calls[small] = (args, kw, first.numel())
            if name in self.names and self.last:
                self.calls[(name, f"{label}:last")] = (args, kw, first.numel())
            big = (name, f"{label}:largest")
            if name in self.names and self.largest and (
                    big not in self.calls or first.numel() > self.calls[big][2]):
                self.calls[big] = (args, kw, first.numel())
            shape = (f"{dtype} {'x'.join(map(str, bound.shape))} -> "
                     f"{'x'.join(map(str, first.shape))}")
            by_shape = self.shapes.setdefault(name, {})
            by_shape[shape] = by_shape.get(shape, 0) + 1
            return out
        return call


# --------------------------------------------------------------------------
# numpy brute force (the reference the sampled results are held against)
# --------------------------------------------------------------------------
def brute_window(pts32, lo, hi) -> np.ndarray:
    inside = np.ones(len(pts32), dtype=bool)
    for k in range(pts32.shape[1]):
        inside &= (pts32[:, k] >= lo[k]) & (pts32[:, k] <= hi[k])
    return np.flatnonzero(inside)


def brute_d2(pts32, q) -> np.ndarray:
    """f32 squared distances summed per dimension in the kernel's order."""
    acc = np.zeros(len(pts32), dtype=np.float32)
    for k in range(pts32.shape[1]):
        diff = pts32[:, k] - q[k]
        acc = acc + diff * diff
    return acc


def check_knn(full, ids, d2, k) -> None:
    """Hold one k-NN answer against the brute-force distances ``full``."""
    n = len(full)
    m = min(k, n)
    if len(ids) != m or len(d2) != m or not np.all(np.isfinite(d2)):
        raise AssertionError(f"k-NN answer of {len(ids)} ids, expected {m} finite")
    part = np.argpartition(full, min(m, n - 1))[: m + 1]
    part = part[np.argsort(full[part], kind="stable")]
    want = full[part]
    if not np.array_equal(d2, want[:m]):
        raise AssertionError(f"k-NN distances differ from brute force: {d2} vs {want[:m]}")
    if not np.array_equal(full[ids], d2):
        raise AssertionError("returned distances are not those of the returned ids")
    if m < n and want[m - 1] < want[m]:  # no tie at the k-th boundary
        if set(ids.tolist()) != set(part[:m].tolist()):
            raise AssertionError("k-NN ids differ from brute force")


def check_overflow_knn(tag, pts32, devs, k, rt) -> None:
    """Two queries whose every squared distance overflows f32 (a coordinate
    of 2e19, and one of +inf), on both exports and both engines: each
    answer must be k distinct dataset rows at +inf, never padding."""
    far = np.full((2, pts32.shape[1]), 0.5, dtype=np.float32)
    far[0, 0], far[1, 0] = 2e19, np.inf
    with np.errstate(over="ignore"):
        full = [brute_d2(pts32, q) for q in far]
    for name, dv in (("f32", devs[False]), ("bf16", devs[True])):
        for fused in (True, False):
            ids, d2 = rt.knn_query_batch_torch(dv, far, k, fused=fused, return_dists=True)
            for i in range(len(far)):
                if (len(ids[i]) != k or (ids[i] < 0).any() or len(set(ids[i].tolist())) != k
                        or not np.isinf(d2[i]).all() or not np.isinf(full[i][ids[i]]).all()):
                    raise AssertionError(f"[{tag}] overflowing k-NN query {far[i]} ({name}, "
                                         f"fused={fused}): ids {ids[i]}, d2 {d2[i]}")
    log(f"[{tag}] overflowing k-NN queries answer {k} live rows at +inf on both exports "
        f"and engines")


# --------------------------------------------------------------------------
# timing one batch
# --------------------------------------------------------------------------
def timed_runs(fn, torch, launches, runs=2):
    """Run ``fn`` ``runs`` times (the first includes one-time set-up);
    returns its last result and ``{"wall_s": [...], "launches": the
    launches of the last run, by kernel}``."""
    times = []
    for _ in range(runs):
        before = launches.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = launches.counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return res, {"wall_s": times, "launches": delta}


# --------------------------------------------------------------------------
# one main-path run
# --------------------------------------------------------------------------
def buffer_pages_for(n, d):
    """benchmarks/common.py:buffer_pages, recomputed: 5 % of the data pages."""
    from repro_torch.core.pagestore import branch_capacity, leaf_capacity

    return max(int(-(-n // leaf_capacity(d)) * 0.05), branch_capacity(d) + 1)


def main_path(tag, pts, seed_q, n_windows, n_knn, k, torch, rt, launches,
              device="cuda", half_width=0.01, at_points=False, profile=False):
    """Bulk load ``pts``, export it plain and compressed, run the window and
    k-NN batches on both with the launch counts zeroed before and read
    after, and check them against the brute force.  Windows of
    ``half_width`` are centred uniformly in [0, 0.9)^d, or at dataset rows
    when ``at_points``; k-NN queries are uniform in [0, 1)^d.  Returns the
    measurements and the recorded kernel calls."""
    from repro_torch.core.queries_torch import _frontier_count
    from repro_torch.kernels import ops

    n, d = pts.shape
    buffer_pages = buffer_pages_for(n, d)
    out = {"n": n, "d": d, "buffer_pages": buffer_pages}
    t0 = time.perf_counter()
    idx = rt.bulk_load(pts, buffer_pages, rt.PageStore(buffer_pages))
    out["bulk_load_s"] = time.perf_counter() - t0
    out["io"] = {"reads": idx.store.stats.reads, "writes": idx.store.stats.writes}
    torch.cuda.reset_peak_memory_stats()
    devs = {}
    for comp in (False, True):
        t0 = time.perf_counter()
        devs[comp] = rt.DeviceTable.from_index(idx, compressed=comp, device=device)
        torch.cuda.synchronize()
        out[f"export_{'bf16' if comp else 'f32'}_s"] = time.perf_counter() - t0
    dev = devs[False]
    out.update(leaves=dev.n_leaves, leaf_size=dev.leaf_size,
               levels=len(dev.levels), live_points=dev.live_points())
    qrng = np.random.default_rng(seed_q)
    if at_points:
        centres = pts[qrng.integers(0, n, n_windows)]
    else:
        centres = qrng.random((n_windows, d)) * 0.9
    los, his = centres - half_width, centres + half_width
    qs = qrng.random((n_knn, d))
    log(f"[{tag}] n={n} d={d} bulk_load {out['bulk_load_s']:.3f} s, "
        f"{dev.n_leaves} leaves of <= {dev.leaf_size} slots, {len(dev.levels)} levels")

    recorder = Recorder(ops, MAIN_PATH)
    launches.reset()
    batches = {}
    with recorder:
        for comp, dv in devs.items():
            name = "bf16" if comp else "f32"
            runs = {"window": lambda: rt.window_query_batch_torch(dv, los, his, fused=True),
                    "knn": lambda: rt.knn_query_batch_torch(dv, qs, k, fused=True,
                                                            return_dists=True)}
            for kind, run in runs.items():
                res, rec = timed_runs(run, torch, launches, runs=3)
                batches[(kind, name)] = res
                if kind == "window":
                    rec["chunks"] = rec["launches"].get("pair_window_ids", 0)
                    rec["ids"] = int(sum(len(r) for r in res))
                else:
                    rec["rounds"] = rec["launches"].get("leaf_mindist", 0)
                out[f"{kind}_{name}"] = rec
                log(f"[{tag}] {kind} batch ({name} bounds): {rec}")
    counts = launches.counts()
    out["launches"] = counts
    out["launch_shapes"] = recorder.shapes
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    missing = [kk for kk in MAIN_PATH if counts[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels not launched on the main path: {missing}")
    log(f"[{tag}] main-path launches {counts}; by shape {recorder.shapes}; "
        f"max_memory_allocated {out['max_memory_allocated']} B")

    qlo = torch.from_numpy(los.astype(np.float32)).to(device)
    qhi = torch.from_numpy(his.astype(np.float32)).to(device)
    for comp, dv in devs.items():
        out[f"pairs_{'bf16' if comp else 'f32'}"] = int(_frontier_count(dv, qlo, qhi)[1])

    pts32 = pts.astype(np.float32)
    lo32, hi32, qs32 = los.astype(np.float32), his.astype(np.float32), qs.astype(np.float32)
    for i in range(32):
        want = brute_window(pts32, lo32[i], hi32[i])
        for name in ("f32", "bf16"):
            if not np.array_equal(np.sort(batches[("window", name)][i]), want):
                raise AssertionError(f"[{tag}] window {i} ({name}) differs from brute force")
    for i in range(16):
        full = brute_d2(pts32, qs32[i])
        for name in ("f32", "bf16"):
            ids, d2 = batches[("knn", name)]
            check_knn(full, ids[i], d2[i], k)
    check_overflow_knn(tag, pts32, devs, k, rt)
    for name in ("f32", "bf16"):
        if (len(batches[("window", name)]), len(batches[("knn", name)][0])) != (
                n_windows, n_knn):
            raise AssertionError(f"[{tag}] a batch lost queries ({name})")
    # every window and k-NN answer: the compressed export equals the plain
    for a, b in zip(batches[("window", "f32")], batches[("window", "bf16")]):
        if not np.array_equal(np.sort(a), np.sort(b)):
            raise AssertionError(f"[{tag}] compressed and plain windows differ")
    for a, b in zip(batches[("knn", "f32")][1], batches[("knn", "bf16")][1]):
        if not np.array_equal(a, b):
            raise AssertionError(f"[{tag}] compressed and plain k-NN distances differ")
    if profile:
        out["profile"] = {
            name: profile_batches({
                "window": lambda: rt.window_query_batch_torch(dv, los, his, fused=True),
                "frontier": lambda: _frontier_count(dv, qlo, qhi),
                "knn": lambda: rt.knn_query_batch_torch(dv, qs, k, fused=True)}, torch)
            for name, dv in (("f32", devs[False]), ("bf16", devs[True]))
        }
        log(f"[{tag}] profile: {out['profile']}")
    log(f"[{tag}] 32 windows and 16 k-NN queries per export equal the brute force")
    inputs = {"index": idx, "los": los, "his": his, "qs": qs, "devs": devs,
              "batches": batches,
              "window_counts": np.array([len(r) for r in batches[("window", "f32")]])}
    return out, recorder.calls, inputs


# --------------------------------------------------------------------------
# the first-generation engine and ops.window_count
# --------------------------------------------------------------------------
def unfused_path(tag, inputs, k, torch, rt, launches, profile=False):
    """Run phase 3's (or 4's) window and k-NN batches with ``fused=False``
    on both exports, with the launch counts zeroed before and read after,
    and hold every answer against the fused batches.  Returns the
    measurements and the recorded ``window_mask_gathered`` calls."""
    from repro_torch.kernels import ops

    los, his, qs = inputs["los"], inputs["his"], inputs["qs"]
    fused = inputs["batches"]
    out = {}
    recorder = Recorder(ops, ("window_mask_gathered",))
    launches.reset()
    batches = {}
    with recorder:
        for comp, dv in inputs["devs"].items():
            name = "bf16" if comp else "f32"
            runs = {"window": lambda: rt.window_query_batch_torch(dv, los, his, fused=False),
                    "knn": lambda: rt.knn_query_batch_torch(dv, qs, k, fused=False,
                                                            return_dists=True)}
            for kind, run in runs.items():
                res, rec = timed_runs(run, torch, launches, runs=3)
                batches[(kind, name)] = res
                if kind == "window":
                    rec["chunks"] = rec["launches"].get("window_mask_gathered", 0)
                    rec["ids"] = int(sum(len(r) for r in res))
                else:
                    rec["rounds"] = rec["launches"].get("leaf_mindist", 0)
                out[f"{kind}_{name}"] = rec
                log(f"[{tag}] unfused {kind} batch ({name} export): {rec}")
    counts = launches.counts()
    out["launches"] = counts
    out["launch_shapes"] = recorder.shapes
    missing = [kk for kk in UNFUSED if counts[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels not launched on the unfused path: {missing}")
    fused_launched = [kk for kk in FUSED_ONLY if counts[kk]]
    if fused_launched:
        raise AssertionError(f"[{tag}] fused kernels launched with fused=False: "
                             f"{fused_launched}")
    for name in ("f32", "bf16"):
        got_w, want_w = batches[("window", name)], fused[("window", name)]
        if len(got_w) != len(want_w):
            raise AssertionError(f"[{tag}] unfused window batch lost windows ({name})")
        for i, (a, b) in enumerate(zip(got_w, want_w)):
            if not np.array_equal(np.sort(a), np.sort(b)):
                raise AssertionError(f"[{tag}] unfused window {i} ({name}) differs "
                                     f"from the fused batch")
        got_k, want_k = batches[("knn", name)][1], fused[("knn", name)][1]
        if len(got_k) != len(want_k):
            raise AssertionError(f"[{tag}] unfused k-NN batch lost queries ({name})")
        for i, (a, b) in enumerate(zip(got_k, want_k)):
            if not np.array_equal(a, b):
                raise AssertionError(f"[{tag}] unfused k-NN query {i} ({name}) differs "
                                     f"from the fused batch: {a} vs {b}")
    log(f"[{tag}] unfused launches {counts}; by shape {recorder.shapes}; every window "
        f"and k-NN distance sequence of both exports equals the fused batch's")
    if profile:
        out["profile"] = {
            name: profile_batches({
                "window": lambda: rt.window_query_batch_torch(dv, los, his, fused=False),
                "knn": lambda: rt.knn_query_batch_torch(dv, qs, k, fused=False)}, torch)
            for name, dv in (("f32", inputs["devs"][False]), ("bf16", inputs["devs"][True]))
        }
        log(f"[{tag}] unfused profile: {out['profile']}")
    return out, recorder.calls


def window_count_path(tag, pts, inputs, torch, launches, device="cuda"):
    """``ops.window_count`` of phase 3's (or 4's) windows over all points,
    with the launch counts zeroed before and read after; every count must
    equal the fused window batch's size.  Returns the measurements and
    the recorded ``window_count_tiles`` call."""
    from repro_torch.kernels import ops

    pts_dev = torch.from_numpy(pts.astype(np.float32)).to(device)
    lo = torch.from_numpy(inputs["los"].astype(np.float32)).to(device)
    hi = torch.from_numpy(inputs["his"].astype(np.float32)).to(device)
    recorder = Recorder(ops, ("window_count_tiles",))
    launches.reset()
    with recorder:
        counts, out = timed_runs(lambda: ops.window_count(lo, hi, pts_dev).cpu().numpy(),
                                 torch, launches)
    out["launches"] = launched = launches.counts()
    out["launch_shapes"] = recorder.shapes
    out.update(windows=len(lo), points=len(pts_dev))
    if launched["window_count_tiles"] == 0:
        raise AssertionError(f"[{tag}] window_count_tiles not launched")
    want = inputs["window_counts"]
    if counts.shape != want.shape or not np.array_equal(counts, want):
        bad = np.flatnonzero(counts != want)
        raise AssertionError(f"[{tag}] ops.window_count differs from the fused window "
                             f"batch at {len(bad)} windows, first {bad[:5]}")
    log(f"[{tag}] ops.window_count: {out}; all {len(counts)} counts over "
        f"{len(pts_dev)} points equal the fused window batch's sizes")
    return out, recorder.calls


# --------------------------------------------------------------------------
# serving: DeviceQueryServer, static and adaptive over AMBI
# --------------------------------------------------------------------------
class SortedWindows:
    """Brute-force windows over every point, through one sort by the first
    coordinate: each window scans only the points of its x-range, with the
    same f32 comparisons as :func:`brute_window`."""

    def __init__(self, pts32):
        self.pts32 = pts32
        self.order = np.argsort(pts32[:, 0], kind="stable")
        self.xs = pts32[self.order, 0]

    def __call__(self, lo, hi) -> np.ndarray:
        a = np.searchsorted(self.xs, lo[0], side="left")
        b = np.searchsorted(self.xs, hi[0], side="right")
        cand = self.order[a:b]
        p = self.pts32[cand]
        inside = np.ones(len(cand), dtype=bool)
        for k in range(p.shape[1]):
            inside &= (p[:, k] >= lo[k]) & (p[:, k] <= hi[k])
        return np.sort(cand[inside])


def serving_zero_faults(tag, stats) -> None:
    """No fault plan is armed, so a retry, a host fallback or a degraded
    answer can only hide a device fault (a kernel that failed to build or
    launch, retried and then answered by the host): raise on any."""
    bad = {k: getattr(stats, k) for k in ("retries", "host_fallbacks", "degraded_queries")
           if getattr(stats, k)}
    if bad:
        raise AssertionError(f"[{tag}] the resilience plane absorbed device faults: {bad}")


def serving_path(tag, pts, inputs, buffer_pages, full_leaves, k, torch, rt, launches,
                 device="cuda", n_batches=16, per_batch=64, n_replay=4, n_check=16,
                 profile=False):
    """Phase 3a: ``DeviceQueryServer`` over phase 3's index (static), then
    adaptive over an ``AMBI`` of phase 3's points rounded to f32 (the
    device's values, so host and device answers agree exactly), booted
    from the single unrefined root and fed a two-centre hotspot stream,
    with the launch counts zeroed before the stream and read after.
    Returns the measurements and the kernel calls of both runs, recorded
    under ``<dtype>:static`` and ``<dtype>:serving`` (the adaptive
    stream's first, smallest and last call of each kernel: the one-row
    root level at boot, cold slots, the leaf blocks that apply_delta appended)."""
    from repro_torch.kernels import ops

    out = {"k": k, "buffer_pages": buffer_pages}
    los, his, qs = inputs["los"], inputs["his"], inputs["qs"]
    pts32 = pts.astype(np.float32)

    # static serving: every answer equals phase 3's fused batch (f32 export)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static = rt.DeviceQueryServer.from_index(inputs["index"], device=device)
    torch.cuda.synchronize()
    out["static_boot_s"] = time.perf_counter() - t0
    walls = {}
    static_rec = Recorder(ops, MAIN_PATH, suffix=":static")
    for kind, run in (("window", lambda: static.window(los, his)),
                      ("knn", lambda: static.knn(qs, k))):
        t0 = time.perf_counter()
        with static_rec:
            res = run()
        walls[kind] = time.perf_counter() - t0
        if kind == "window":
            want = inputs["batches"][("window", "f32")]
            bad = [i for i, (a, b) in enumerate(zip(res, want))
                   if not np.array_equal(np.sort(a), np.sort(b))]
        else:
            want = inputs["batches"][("knn", "f32")][1]
            bad = [i for i, (ids, w) in enumerate(zip(res, want))
                   if not np.array_equal(brute_d2(pts32[ids], qs[i].astype(np.float32)), w)]
        if len(res) != len(want) or bad:
            raise AssertionError(f"[{tag}] static {kind} answers differ from phase 3's at "
                                 f"{bad[:5]} ({len(res)} of {len(want)})")
    serving_zero_faults(tag, static.stats)
    out["static"] = {"wall_s": walls, "microbatches": static.stats.microbatches}
    log(f"[{tag}] static DeviceQueryServer: boot {out['static_boot_s']:.3f} s, "
        f"{walls} over {static.stats.microbatches} microbatches of 64; every window and "
        f"k-NN distance sequence equals phase 3's")
    del static

    # adaptive serving from the single unrefined root
    p = pts32.astype(np.float64)
    t0 = time.perf_counter()
    ambi = rt.AMBI(p, buffer_pages)
    out["ambi_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = rt.DeviceQueryServer.from_ambi(ambi, device=device)
    torch.cuda.synchronize()
    out["boot_s"] = time.perf_counter() - t0
    if (srv.dev.n_leaves, srv.dev.n_cold) != (0, 1):
        raise AssertionError(f"[{tag}] boot export holds {srv.dev.n_leaves} leaves and "
                             f"{srv.dev.n_cold} cold rows, expected 0 and 1")
    rng = np.random.default_rng(13)
    centres = p[rng.integers(0, len(p), 2)]
    stream = [(centres[s % 2] + rng.random((per_batch, 2)) * 0.08)
              .astype(np.float32).astype(np.float64) for s in range(n_batches)]
    hw = 0.01
    delta_s = []
    orig_delta = rt.DeviceTable.apply_delta

    def timed_delta(dev, table, points):
        t = time.perf_counter()
        new = orig_delta(dev, table, points)
        torch.cuda.synchronize()
        delta_s.append(time.perf_counter() - t)
        return new

    def serve(kind, batch):
        st = srv.stats
        before = (st.cold_queries, st.hot_queries, st.grafts, len(delta_s))
        t = time.perf_counter()
        res = srv.window(batch - hw, batch + hw) if kind == "window" else srv.knn(batch, k)
        wall = time.perf_counter() - t
        rec = {"kind": kind, "wall_s": wall, "cold": st.cold_queries - before[0],
               "hot": st.hot_queries - before[1], "grafts": st.grafts - before[2],
               "apply_delta_s": sum(delta_s[before[3]:])}
        return res, rec

    rt.DeviceTable.apply_delta = timed_delta
    recorder = Recorder(ops, MAIN_PATH, suffix=":serving", last=True)
    launches.reset()
    try:
        with recorder:
            answers, batches = [], []
            for batch in stream:
                for kind in ("window", "knn"):
                    res, rec = serve(kind, batch)
                    answers.append((kind, batch, res))
                    batches.append(rec)
                    log(f"[{tag}] adaptive {rec}")
            counts = launches.counts()
            cold, io = srv.stats.cold_queries, ambi.store.stats.total
            replay = []
            for batch in stream[:n_replay]:
                for kind in ("window", "knn"):
                    res, rec = serve(kind, batch)
                    answers.append((kind, batch, res))
                    replay.append(rec)
    finally:
        rt.DeviceTable.apply_delta = orig_delta
    st, up = srv.stats, srv.upload_stats
    out.update(batches=batches, replay=replay, launches=counts,
               stats=dict(vars(st)), upload_stats=up.as_dict(),
               apply_delta_s=sum(delta_s), leaves=srv.dev.n_leaves,
               cold_rows=srv.dev.n_cold, refined_share=srv.dev.n_leaves / full_leaves,
               replay_cold=st.cold_queries - cold,
               replay_io=ambi.store.stats.total - io)
    log(f"[{tag}] ambi {out['ambi_s']:.3f} s, boot {out['boot_s']:.3f} s; {st}; uploads "
        f"{up.as_dict()}; apply_delta {out['apply_delta_s']:.3f} s in {len(delta_s)} "
        f"calls; {srv.dev.n_leaves} leaves on the card of {full_leaves} "
        f"({out['refined_share']:.4f}), {srv.dev.n_cold} cold rows; replay walls "
        f"{[r['wall_s'] for r in replay]}")
    missing = [kk for kk in MAIN_PATH if counts[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels not launched by the adaptive stream: {missing}")
    if out["replay_cold"] or out["replay_io"]:
        raise AssertionError(f"[{tag}] the replay was not all hot: {out['replay_cold']} "
                             f"cold queries, {out['replay_io']} page I/Os")
    if ambi.is_fully_refined():
        raise AssertionError(f"[{tag}] the hotspot stream refined the whole index")
    if not (up.full_exports == 1 and up.uploaded_leaf_blocks == srv.dev.n_leaves
            and up.delta_refreshes == st.delta_refreshes > 0):
        raise AssertionError(f"[{tag}] uploads {up.as_dict()} against {st} and "
                             f"{srv.dev.n_leaves} leaves on the card")
    serving_zero_faults(tag, st)

    # answers against the brute force over all points
    windows = SortedWindows(pts32)
    checked = [i for i in (0, 4, 8, 12, 15) if i < n_batches]
    checked += list(range(n_batches, n_batches + n_replay))
    for b in checked:
        for kind, batch, res in answers[2 * b: 2 * b + 2]:
            b32 = batch.astype(np.float32)
            if kind == "window":
                for i in range(len(batch)):
                    if not np.array_equal(np.sort(res[i]), windows(b32[i] - np.float32(hw),
                                                                   b32[i] + np.float32(hw))):
                        raise AssertionError(f"[{tag}] adaptive window {b}/{i} differs from "
                                             f"brute force")
            else:
                for i in range(n_check):
                    full = brute_d2(pts32, b32[i])
                    check_knn(full, res[i], full[res[i]], k)
    log(f"[{tag}] windows of batches {checked} and the first {n_check} k-NN queries of "
        f"each equal the brute force over all points")

    # brownout tier over phase 3's first 64 windows and queries, rounded
    # to f32 as the device sees them (the host cold test then agrees)
    from repro_torch.core.geometry import boxes_mindist_sq

    w_lo, w_hi, q64 = (x[:per_batch].astype(np.float32).astype(np.float64)
                       for x in (los, his, qs))
    t = ambi.table
    unref = np.flatnonzero(t.unrefined)
    (w_res, w_certs), (k_res, k_certs) = srv.window_hot(w_lo, w_hi), srv.knn_hot(q64, k)
    lo32, hi32 = w_lo.astype(np.float32), w_hi.astype(np.float32)
    reach = ((t.mbb_lo[unref][None] <= w_hi[:, None])
             & (t.mbb_hi[unref][None] >= w_lo[:, None])).all(axis=2).any(axis=1)
    w_complete = np.array([c.complete for c in w_certs])
    if not np.array_equal(w_complete, ~reach):
        raise AssertionError(f"[{tag}] window_hot certificates: incomplete at "
                             f"{np.flatnonzero(~w_complete)}, cold space reached at "
                             f"{np.flatnonzero(reach)}")
    q32 = q64.astype(np.float32)
    minds = boxes_mindist_sq(t.mbb_lo[unref], t.mbb_hi[unref], q64)
    k_cold = np.array([
        len(r) < k or minds[i].min() <= float(np.max(np.sum(
            (p[r] - q64[i]) ** 2, axis=1)))
        for i, r in enumerate(k_res)])
    k_complete = np.array([c.complete for c in k_certs])
    if not np.array_equal(k_complete, ~k_cold):
        raise AssertionError(f"[{tag}] knn_hot certificates: incomplete at "
                             f"{np.flatnonzero(~k_complete)}, cold space reachable at "
                             f"{np.flatnonzero(k_cold)}")
    for i in np.flatnonzero(w_complete):
        if not np.array_equal(np.sort(w_res[i]), windows(lo32[i], hi32[i])):
            raise AssertionError(f"[{tag}] complete window_hot answer {i} differs from "
                                 f"brute force")
    for i in np.flatnonzero(k_complete)[:n_check]:
        full = brute_d2(pts32, q32[i])
        check_knn(full, k_res[i], full[k_res[i]], k)
    if srv.stats.retries or srv.stats.host_fallbacks:
        raise AssertionError(f"[{tag}] the brownout tier retried or fell back: {srv.stats}")
    out["brownout"] = {"window_complete": int(w_complete.sum()),
                       "knn_complete": int(k_complete.sum()), "queries": per_batch}
    log(f"[{tag}] brownout tier: {out['brownout']}; certificates incomplete exactly where "
        f"the query reaches cold space; complete answers equal the brute force")
    if profile:
        b = stream[0]
        out["profile"] = profile_batches({
            "window": lambda: srv.window(b - hw, b + hw),
            "knn": lambda: srv.knn(b, k)}, torch)
        log(f"[{tag}] profile (hot replay batches): {out['profile']}")
    out["launch_shapes"] = recorder.shapes
    # phase 3s grows a streaming overlay on this server
    inputs["adaptive"] = {"srv": srv, "windows": windows, "batch": stream[0], "hw": hw}
    del ambi
    return out, {**static_rec.calls, **recorder.calls}


# --------------------------------------------------------------------------
# phase 3s: streaming ingest, recovery, the adaptive overlay, the frontend
# --------------------------------------------------------------------------
def live_knn(pts32, p64, live, q, k, pre=64):
    """The ``k`` nearest live rows of ``q`` by f64 distance, ties by id (the
    streaming contract): an f32 brute force over every point picks ``pre``
    candidates among the live rows, f64 ranks them."""
    d32 = brute_d2(pts32, q.astype(np.float32))
    d32[~live] = np.inf
    cand = np.argpartition(d32, pre)[:pre]
    d64 = np.sum((p64[cand] - q) ** 2, axis=1)
    return cand[np.lexsort((cand, d64))[:k]]


def check_live_answers(tag, points, live, los, his, qs, wres, kres, k, n_check):
    """No tombstoned id in any answer; the first ``n_check`` windows and
    k-NN queries equal a brute force over the live rows."""
    dead = ~live
    for kind, res in (("window", wres), ("knn", kres)):
        bad = [i for i, ids in enumerate(res) if dead[np.asarray(ids, dtype=np.int64)].any()]
        if bad:
            raise AssertionError(f"[{tag}] deleted ids in {kind} answers {bad[:5]}")
    pts32 = points.astype(np.float32)
    lo32, hi32 = los.astype(np.float32), his.astype(np.float32)
    for i in range(n_check):
        want = brute_window(pts32, lo32[i], hi32[i])
        if not np.array_equal(np.sort(wres[i]), want[live[want]]):
            raise AssertionError(f"[{tag}] window {i} differs from the brute force")
        if not np.array_equal(kres[i], live_knn(pts32, points, live, qs[i], k)):
            raise AssertionError(f"[{tag}] k-NN query {i} differs from the brute force")


# the reference's streaming traffic (bench_hotpaths): 32 inserts of 1024
# points, 64-query batches; the first 16 answers of a batch are brute-forced
STREAM_INSERTS, STREAM_PER_INSERT, STREAM_BATCH, STREAM_CHECK = 32, 1024, 64, 16


def streaming_path(tag, pts, inputs, buffer_pages, k, torch, rt, launches,
                   device="cuda", durable_n=1_000_000, smi="", profile=False):
    """Phase 3s: ``DeviceQueryServer.from_streaming`` over a
    ``StreamingIndex`` of phase 3's points rounded to f32, journaled, fed
    the reference's streaming traffic (``bench_hotpaths``: 32 inserts of
    1024 uniform points from ``default_rng(5)``), with 32 base and 16
    inserted rows deleted (``default_rng(17)``) after every fourth insert
    and phase 3's first 64 windows and k-NN queries (rounded to f32)
    after every eighth, the launch counts zeroed before and read after;
    then a ``Frontend`` over it, a kill and ``recover``; a streaming
    overlay on phase 3a's adaptive server; and an adaptive server's
    journal, compaction barrier and recovery over ``durable_n`` points.
    Returns the measurements and the kernel calls of the ingest and its
    queries, recorded under ``<dtype>:stream`` (first, smallest and last
    call: the last k-NN batch runs at ``k_eff`` = 512)."""
    import shutil

    from repro_torch.core.datasets import osm_like
    from repro_torch.kernels import ops
    from repro_torch.serve import Frontend, VirtualClock

    out = {"k": k, "buffer_pages": buffer_pages, "nvidia_smi": smi}
    w_lo, w_hi, q64 = (x[:STREAM_BATCH].astype(np.float32).astype(np.float64)
                       for x in (inputs["los"], inputs["his"], inputs["qs"]))
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_stream_"))
    Server = rt.DeviceQueryServer
    delta_s, ckpt_s = [], []
    orig_delta, orig_ckpt = rt.DeviceTable.apply_delta, Server._checkpoint_locked

    def timed_delta(dev, table, points):
        t = time.perf_counter()
        new = orig_delta(dev, table, points)
        torch.cuda.synchronize()
        delta_s.append(time.perf_counter() - t)
        return new

    def timed_ckpt(srv):
        t = time.perf_counter()
        orig_ckpt(srv)
        ckpt_s.append(time.perf_counter() - t)

    try:
        rt.DeviceTable.apply_delta, Server._checkpoint_locked = timed_delta, timed_ckpt
        # -- boot: the base tier's bulk load, the export, the boot barrier
        p = pts.astype(np.float32).astype(np.float64)
        t0 = time.perf_counter()
        stream = rt.StreamingIndex(p, buffer_pages=buffer_pages)
        out["base_load_s"] = time.perf_counter() - t0
        del p
        t0 = time.perf_counter()
        srv = Server.from_streaming(stream, microbatch=STREAM_BATCH,
                                    journal_path=tmp / "ops.journal",
                                    snapshot_path=tmp / "snap.npz", device=device)
        torch.cuda.synchronize()
        out["boot_s"] = time.perf_counter() - t0
        out["boot_checkpoint_s"] = ckpt_s[0]
        n0, s_leaf = stream.n_ids, srv.dev.leaf_size
        log(f"[{tag}] base tier of {n0} points: bulk load {out['base_load_s']:.3f} s; boot "
            f"{out['boot_s']:.3f} s (boot barrier {out['boot_checkpoint_s']:.3f} s); "
            f"{srv.dev.n_leaves} leaves of <= {s_leaf} slots; {smi}")

        # -- ingest with deletes and query rounds, counts zeroed around it
        feed = (np.random.default_rng(5).random((STREAM_INSERTS * STREAM_PER_INSERT, 2))
                .astype(np.float32).astype(np.float64))
        drng = np.random.default_rng(17)
        base_dels = drng.choice(n0, 32 * (STREAM_INSERTS // 4), replace=False)
        new_dels: list = []
        insert_s, rounds, answers = [], [], []

        def fresh():
            if srv._stream_is_stale():
                raise AssertionError(f"[{tag}] the device export went stale")

        recorder = Recorder(ops, MAIN_PATH, suffix=":stream", last=True)
        launches.reset()
        with recorder:
            for i in range(STREAM_INSERTS):
                t = time.perf_counter()
                srv.insert(feed[i * STREAM_PER_INSERT:(i + 1) * STREAM_PER_INSERT])
                torch.cuda.synchronize()
                insert_s.append(time.perf_counter() - t)
                fresh()
                if (i + 1) % 4 == 0:
                    j = (i + 1) // 4 - 1
                    ins = np.setdiff1d(np.arange(n0, stream.n_ids), new_dels)
                    new = drng.choice(ins, 16, replace=False)
                    new_dels.extend(new.tolist())
                    srv.delete(np.concatenate([base_dels[32 * j:32 * (j + 1)], new]))
                    fresh()
                if (i + 1) % 8 == 0:
                    k_eff = srv._k_eff(k)
                    t = time.perf_counter()
                    wres = srv.window(w_lo, w_hi)
                    w_s = time.perf_counter() - t
                    t = time.perf_counter()
                    kres = srv.knn(q64, k)
                    k_s = time.perf_counter() - t
                    fresh()
                    rounds.append({"after_insert": i + 1, "k_eff": k_eff, "window_s": w_s,
                                   "knn_s": k_s, "shadow": stream.shadow,
                                   "tiers": len(stream.tiers), "leaves": srv.dev.n_leaves})
                    answers.append((wres, kres, stream.live_mask().copy()))
                    log(f"[{tag}] round {rounds[-1]}")
        counts = launches.counts()
        st, up = srv.stats, srv.upload_stats
        n_fed = STREAM_INSERTS * STREAM_PER_INSERT
        out.update(insert_s=insert_s, points_per_s=n_fed / sum(insert_s),
                   rounds=rounds, launches=counts, launch_shapes=recorder.shapes,
                   apply_delta_s=list(delta_s), stats=dict(vars(st)),
                   upload_stats=up.as_dict(),
                   stream={c: getattr(stream, c) for c in
                           ("flushes", "fusions", "merges", "point_reallocs", "shadow")})
        log(f"[{tag}] {STREAM_INSERTS} inserts of {STREAM_PER_INSERT}: "
            f"{out['points_per_s']:.1f} points/s "
            f"(insert walls {[round(x, 4) for x in insert_s]}); {len(delta_s)} apply_delta "
            f"swaps {[round(x, 4) for x in delta_s]}; stream {out['stream']}; {st}; uploads "
            f"{up.as_dict()}; launches {counts}; {smi}")
        missing = [kk for kk in MAIN_PATH if counts[kk] == 0]
        if missing:
            raise AssertionError(f"[{tag}] kernels not launched by the streaming run: {missing}")
        if not (stream.flushes >= 1 and stream.fusions >= 1 and stream.merges >= 1):
            raise AssertionError(f"[{tag}] the run did not flush, fuse and rebuild-merge: "
                                 f"{out['stream']}")
        if rounds[-1]["k_eff"] != 512 or not 512 > s_leaf:
            raise AssertionError(f"[{tag}] the last round ran at k_eff {rounds[-1]['k_eff']}, "
                                 f"leaves of {s_leaf} slots; expected 512 > S")
        if not (up.full_exports == 1 and up.delta_refreshes == st.delta_refreshes
                == st.stream_syncs > 0):
            raise AssertionError(f"[{tag}] uploads {up.as_dict()} against {st}")
        serving_zero_faults(tag, st)
        for wres, kres, live in answers:   # the rows live at that round
            check_live_answers(tag, stream.points[:len(live)], live, w_lo, w_hi, q64,
                               wres, kres, k, STREAM_CHECK)
        log(f"[{tag}] every round: no deleted id; the first {STREAM_CHECK} windows and k-NN "
            f"queries equal a brute force over the live rows")

        # -- warm batches on the multi-tier state (bench_hotpaths'
        # ingest_query_batch_64_s, on the port)
        warm = {"window_s": [], "knn_s": []}
        for _ in range(3):
            for kind, run in (("window_s", lambda: srv.window(w_lo, w_hi)),
                              ("knn_s", lambda: srv.knn(q64, k))):
                t = time.perf_counter()
                run()
                warm[kind].append(time.perf_counter() - t)
        out["warm"] = warm
        log(f"[{tag}] warm 64-query batches on {len(stream.tiers)} tiers: {warm}; {smi}")
        if profile:
            out["profile"] = profile_batches({
                "window": lambda: srv.window(w_lo, w_hi),
                "knn": lambda: srv.knn(q64, k)}, torch)
            log(f"[{tag}] profile: {out['profile']}")

        # -- the frontend over the streaming server
        fl, fh, fq = (x[:128].astype(np.float32).astype(np.float64)
                      for x in (inputs["los"], inputs["his"], inputs["qs"]))
        fe = Frontend(srv, clock=VirtualClock(), queue_bound=64, batch_max=STREAM_BATCH,
                      batch_window_s=0.001)
        reqs = []
        for i in range(128):
            reqs.append(fe.submit_window(fl[i], fh[i]))
            reqs.append(fe.submit_knn(fq[i], k))
        t = time.perf_counter()
        fe.drain()
        out["frontend_drain_s"] = time.perf_counter() - t
        ok = [r for r in reqs if r.status == "ok"]
        if len(ok) != 64 or any(r.status != "rejected" or r.cert.complete
                                for r in reqs if r.status != "ok"):
            raise AssertionError(f"[{tag}] frontend burst: {fe.stats}")
        rt_reqs = []
        fe_rt = Frontend(srv, queue_bound=256, batch_max=STREAM_BATCH,
                         batch_window_s=0.002).start()
        for i in range(32):
            rt_reqs.append(fe_rt.submit_window(fl[i], fh[i]))
            rt_reqs.append(fe_rt.submit_knn(fq[i], k))
        for r in rt_reqs:
            r.wait(120.0)
        fe_rt.stop()
        if any(r.status != "ok" for r in rt_reqs):
            raise AssertionError(f"[{tag}] real-time frontend: {fe_rt.stats}")
        for r in ok + rt_reqs:
            if r.kind == "window":
                want = srv.window(r.payload[0][None], r.payload[1][None])[0]
            else:
                want = srv.knn(r.payload[0][None], k)[0]
            if not np.array_equal(np.sort(r.ids) if r.kind == "window" else r.ids, want):
                raise AssertionError(f"[{tag}] a frontend answer differs from the server's")
        out["frontend"] = {"burst": dict(vars(fe.stats)), "realtime": dict(vars(fe_rt.stats))}
        log(f"[{tag}] frontend: burst of 256 at queue_bound 64 {out['frontend']['burst']}, "
            f"drained in {out['frontend_drain_s']:.4f} s; real time "
            f"{out['frontend']['realtime']}; admitted answers equal the server's")
        serving_zero_faults(tag, srv.stats)

        # -- kill (no barrier after boot) and recover
        journaled = srv.journal.seq
        last_w, last_k, _ = answers[-1]
        calls = recorder.calls
        del srv, stream, fe, fe_rt, reqs, rt_reqs, ok, answers, recorder
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = Server.recover(tmp / "snap.npz", tmp / "ops.journal", microbatch=STREAM_BATCH,
                             device=device)
        torch.cuda.synchronize()
        out["recover_s"] = time.perf_counter() - t0
        out["replayed"] = rec.stats.replayed_records
        n_ops = STREAM_INSERTS + STREAM_INSERTS // 4
        if not rec.stats.replayed_records == journaled == n_ops:
            raise AssertionError(f"[{tag}] recovery replayed {rec.stats.replayed_records} of "
                                 f"{journaled} journaled ops, expected {n_ops}")
        rw, rk = rec.window(w_lo, w_hi), rec.knn(q64, k)
        if not (all(np.array_equal(a, b) for a, b in zip(rw, last_w))
                and all(np.array_equal(a, b) for a, b in zip(rk, last_k))):
            raise AssertionError(f"[{tag}] the recovered server answers differently")
        serving_zero_faults(tag, rec.stats)
        log(f"[{tag}] kill and recover: {out['recover_s']:.3f} s, {out['replayed']} records "
            f"replayed; 64 + 64 answers equal the live server's; {smi}")
        del rec, last_w, last_k
        torch.cuda.empty_cache()

        # -- a streaming overlay on phase 3a's adaptive server
        a = inputs.pop("adaptive")
        asrv, hw = a["srv"], a["hw"]
        b = a["batch"]
        # phase 3a's brownout tier left degraded answers in the counters
        faults0 = {f: getattr(asrv.stats, f)
                   for f in ("retries", "host_fallbacks", "degraded_queries")}
        orng = np.random.default_rng(23)
        new_pts = (b[orng.integers(0, len(b), 1024)] + (orng.random((1024, 2)) - 0.5) * 0.02
                   ).astype(np.float32).astype(np.float64)
        t = time.perf_counter()
        new_ids = asrv.insert(new_pts)
        out["overlay_insert_s"] = time.perf_counter() - t
        before = np.unique(np.concatenate(asrv.window(b - hw, b + hw)))
        before = before[before < new_ids[0]]
        dels = np.concatenate([orng.choice(before, 8, replace=False),
                               orng.choice(new_ids, 8, replace=False)])
        asrv.delete(dels)
        t = time.perf_counter()
        ow = asrv.window(b - hw, b + hw)
        ok_s = time.perf_counter() - t
        t = time.perf_counter()
        okn = asrv.knn(b, k)
        out["overlay"] = {"window_s": ok_s, "knn_s": time.perf_counter() - t,
                          "k_eff": asrv._k_eff(k), "stats": dict(vars(asrv.stats))}
        ostream = asrv.stream
        check_live_answers(tag + " overlay", ostream.points, ostream.live_mask(), b - hw,
                           b + hw, b, ow, okn, k, STREAM_CHECK)
        grew = {f: getattr(asrv.stats, f) - v for f, v in faults0.items()
                if getattr(asrv.stats, f) != v}
        if grew:
            raise AssertionError(f"[{tag} overlay] the resilience plane absorbed device "
                                 f"faults: {grew}")
        log(f"[{tag}] overlay on phase 3a's adaptive server: 1024 inserted, 16 deleted; "
            f"{out['overlay']}; no deleted id, the first {STREAM_CHECK} windows and k-NN "
            f"queries equal a brute force")
        del asrv, a, ostream

        # -- adaptive durability at a smaller depth
        dp = osm_like(durable_n, seed=7).astype(np.float32).astype(np.float64)
        dbuf = buffer_pages_for(durable_n, 2)
        ddir, kdir = tmp / "adaptive", tmp / "killed"
        ddir.mkdir()
        dsrv = Server.from_ambi(rt.AMBI(dp, dbuf), microbatch=STREAM_BATCH, compact_slack=0.0,
                                journal_path=ddir / "ops.journal",
                                snapshot_path=ddir / "snap.npz", device=device)
        rng = np.random.default_rng(13)
        centres = dp[rng.integers(0, len(dp), 4)]
        batches = [(centres[s % 2] + rng.random((STREAM_BATCH, 2)) * 0.08)
                   .astype(np.float32).astype(np.float64) for s in range(4)]
        t0 = time.perf_counter()
        for batch in batches:
            dsrv.window(batch - 0.01, batch + 0.01)
            dsrv.knn(batch, k)
        out_d = {"n": durable_n, "buffer_pages": dbuf, "stream_s": time.perf_counter() - t0,
                 "compactions": dsrv.stats.compactions, "checkpoints": dsrv.stats.checkpoints}
        if dsrv.stats.compactions < 1:
            raise AssertionError(f"[{tag}] no compaction at compact_slack=0: {dsrv.stats}")
        dsrv.compact_slack = 1e9   # no barrier after the last one: replay has work
        tail = [(c + rng.random((STREAM_BATCH, 2)) * 0.08).astype(np.float32).astype(np.float64)
                for c in centres[2:]]
        for batch in tail:
            dsrv.window(batch - 0.01, batch + 0.01)
        shutil.copytree(ddir, kdir)   # what a kill leaves
        t0 = time.perf_counter()
        drec = Server.recover(kdir / "snap.npz", kdir / "ops.journal", microbatch=STREAM_BATCH,
                              compact_slack=1e9, device=device)
        torch.cuda.synchronize()
        out_d.update(recover_s=time.perf_counter() - t0,
                     replayed=drec.stats.replayed_records,
                     checkpoint_s=list(ckpt_s[1:]))
        if drec.stats.replayed_records < 1:
            raise AssertionError(f"[{tag}] the adaptive recovery replayed nothing")
        for srv_ in (dsrv, drec):
            serving_zero_faults(tag + " adaptive durability", srv_.stats)
        probe = [(c + rng.random((STREAM_BATCH, 2)) * 0.08).astype(np.float32).astype(np.float64)
                 for c in (centres[0], centres[3])]
        for c in rt.NodeTable.COLUMNS:
            if not np.array_equal(getattr(dsrv.ambi.table, c), getattr(drec.ambi.table, c)):
                raise AssertionError(f"[{tag}] recovered AMBI column {c} differs")
        for batch in probe:
            for run in (lambda s: s.window(batch - 0.01, batch + 0.01),
                        lambda s: s.knn(batch, k)):
                if not all(np.array_equal(np.sort(x), np.sort(y))
                           for x, y in zip(run(dsrv), run(drec))):
                    raise AssertionError(f"[{tag}] the recovered adaptive server answers "
                                         f"differently")
        if not dsrv.ambi.table.equals(drec.ambi.table):
            raise AssertionError(f"[{tag}] the tables diverged after the same traffic")
        out["adaptive_durability"] = out_d
        log(f"[{tag}] adaptive durability over {durable_n} points: {out_d}; the recovered "
            f"table equals the live one in every column and answers the same; {smi}")
        out["total_apply_delta_s"] = sum(delta_s)
        del dsrv, drec, dp
    finally:
        rt.DeviceTable.apply_delta, Server._checkpoint_locked = orig_delta, orig_ckpt
        shutil.rmtree(tmp, ignore_errors=True)
    return out, calls


# --------------------------------------------------------------------------
# phase 3h: sharded serving (router, two-round k-NN, static/adaptive/streaming)
# --------------------------------------------------------------------------
class ShardProbes:
    """Counts the per-shard dispatches of the sharded protocols while it
    is entered: ``(shard, queries)`` of each window and k-NN call."""

    def __init__(self, dt, sdev_of):
        self.dt = dt
        self.sdev_of = sdev_of   # () -> the ShardedDeviceTable being served
        self.calls = {"window": [], "knn": []}

    def __enter__(self):
        self._orig = (self.dt.window_query_batch_torch, self.dt.knn_query_batch_torch)
        for kind, orig in zip(("window", "knn"), self._orig):
            setattr(self.dt, f"{kind}_query_batch_torch", self._wrap(kind, orig))
        return self

    def __exit__(self, *exc):
        self.dt.window_query_batch_torch, self.dt.knn_query_batch_torch = self._orig

    def _wrap(self, kind, orig):
        def call(dev, qs, *a, **kw):
            s = next(i for i, x in enumerate(self.sdev_of().shards) if x is dev)
            self.calls[kind].append((s, len(np.atleast_2d(qs))))
            return orig(dev, qs, *a, **kw)
        return call


def probe_stats(probes, sdev, los, his, qs, runs) -> dict:
    """The router's pruning over the last of ``runs`` equal window and
    k-NN batches that ``probes`` counted on ``sdev``: window dispatches
    per batch, shards per window, windows per shard, round-1 home shards,
    and the round-2 (query, shard) pairs in all and per shard."""
    from repro_torch.core.geometry import boxes_intersect_windows, boxes_mindist_sq

    hit = boxes_intersect_windows(sdev.shard_lo, sdev.shard_hi, los.astype(np.float32),
                                  his.astype(np.float32))
    minds = boxes_mindist_sq(sdev.shard_lo, sdev.shard_hi, qs.astype(np.float32))
    calls = probes.calls["knn"]
    kcalls = calls[len(calls) // runs * (runs - 1):]
    homes = len(np.unique(np.argmin(minds, axis=1)))
    return dict(
        window_dispatches=len(probes.calls["window"]) // runs,
        shards_per_window=float(hit.sum(axis=1).mean()),
        windows_per_shard=hit.sum(axis=0).tolist(),
        round1_home_shards=homes,
        knn_dispatches=len(kcalls),
        round2_pairs=int(sum(c for _, c in kcalls[homes:])),
        round2_queries_per_shard=[int(sum(c for s, c in kcalls[homes:] if s == j))
                                  for j in range(sdev.m)])


def timed_method(cls, name, torch, sink):
    """Wrap the method (or classmethod) ``cls.name`` so that each call's
    wall time, ending in ``torch.cuda.synchronize()``, is appended to
    ``sink`` as ``(name, seconds)``; returns the original attribute, to
    be set back."""
    raw = cls.__dict__[name]
    fn = raw.__func__ if isinstance(raw, classmethod) else raw

    def call(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((name, time.perf_counter() - t))
        return out

    setattr(cls, name, classmethod(call) if isinstance(raw, classmethod) else call)
    return raw


def main_path_launched(tag, counts) -> None:
    missing = [kk for kk in MAIN_PATH if counts[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels not launched: {missing}")


def same_as_fused(tag, pts32, qs, inputs, wres, kres, what) -> None:
    """Every window equals the fused single-table batch's id set and every
    k-NN answer's f32 distance sequence the fused batch's."""
    want_w = inputs["batches"][("window", "f32")]
    want_k = inputs["batches"][("knn", "f32")][1]
    bad_w = [i for i, (a, b) in enumerate(zip(wres, want_w))
             if not np.array_equal(np.sort(a), np.sort(b))]
    bad_k = [i for i, (ids, w) in enumerate(zip(kres, want_k))
             if not np.array_equal(brute_d2(pts32[ids], qs[i].astype(np.float32)), w)]
    if len(wres) != len(want_w) or len(kres) != len(want_k) or bad_w or bad_k:
        raise AssertionError(f"[{tag}] {what}: windows {bad_w[:5]} and k-NN {bad_k[:5]} "
                             f"differ from the fused batch ({len(wres)}, {len(kres)})")


SHARDS_STATIC = (4, 8)
SHARDS_SERVED = 4


def sharded_path(tag, pts, inputs, buffer_pages, k, torch, rt, launches, device="cuda",
                 smi="", profile=False, small_n=None):
    """Phase 3h: the sharded engine on phase 3's index and batches.

    Static: ``ShardedDeviceTable.from_index`` at m = 4 and 8, the 1024
    windows and k-NN queries through the protocols in one batch (three
    runs), and a ``shards=4`` server in microbatches of 64, every answer
    equal to the fused single-table batch's.  Outage: shard 1 dead, its
    certificates and ``repair([1])``.  Adaptive: AMBI over the points
    rounded to f32 behind ``from_ambi(..., shards=4)``, phase 3a's hotspot
    stream (the re-plan from one shard to four).  Streaming: a
    ``StreamingIndex`` behind ``from_streaming(..., shards=4)`` fed phase
    3s's traffic.  ``small_n`` cuts the adaptive and streaming parts to
    ``osm_like(small_n)``.  Returns the measurements and the kernel calls,
    recorded under ``<dtype>:sharded`` (first, smallest and last)."""
    from repro_torch.core import distributed_torch as DT
    from repro_torch.core.datasets import osm_like
    from repro_torch.core.geometry import boxes_intersect_windows, boxes_mindist_sq
    from repro_torch.kernels import ops
    from repro_torch.serve import FaultPlan, FaultRule, RetryPolicy

    out = {"k": k, "nvidia_smi": smi}
    index, los, his, qs = inputs["index"], inputs["los"], inputs["his"], inputs["qs"]
    pts32 = pts.astype(np.float32)
    n = len(pts)
    Sharded = rt.ShardedDeviceTable
    recorder = Recorder(ops, MAIN_PATH, suffix=":sharded", last=True)
    refresh_s: list = []
    restore = [(Sharded, "refresh", timed_method(Sharded, "refresh", torch, refresh_s)),
               (Sharded, "from_table", timed_method(Sharded, "from_table", torch,
                                                    refresh_s))]
    current = {}
    probes = ShardProbes(DT, lambda: current["sdev"])
    try:
        with recorder:
            # -- static: the protocols in one batch, m = 4 and 8
            for m in SHARDS_STATIC:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sdev = Sharded.from_index(index, m, device=device)
                torch.cuda.synchronize()
                rec = {"export_s": time.perf_counter() - t0, "m": sdev.m,
                       "points_per_shard": [s.n_points for s in sdev.shards],
                       "leaves_per_shard": [s.n_leaves for s in sdev.shards]}
                current["sdev"] = sdev
                launches.reset()
                for kind in probes.calls:
                    probes.calls[kind].clear()
                with probes:
                    wres, rec["window"] = timed_runs(
                        lambda: rt.window_query_batch_sharded(sdev, los, his, fused=True),
                        torch, launches, runs=3)
                    kres, rec["knn"] = timed_runs(
                        lambda: rt.knn_query_batch_sharded(sdev, qs, k, fused=True),
                        torch, launches, runs=3)
                counts = launches.counts()
                main_path_launched(f"{tag} m={m}", counts)
                same_as_fused(f"{tag} m={m}", pts32, qs, inputs, wres, kres,
                              f"protocols at m={m}")
                rec.update(launches=counts,
                           **probe_stats(probes, sdev, los, his, qs, runs=3))
                out[f"static_m{m}"] = rec
                log(f"[{tag}] m={m}: export {rec['export_s']:.3f} s "
                    f"({rec['points_per_shard']} points); windows {rec['window']}; k-NN "
                    f"{rec['knn']}; {rec['shards_per_window']:.3f} shards per window, "
                    f"{rec['round1_home_shards']} round-1 home shards, "
                    f"{rec['round2_pairs']} round-2 (query, shard) pairs "
                    f"{rec['round2_queries_per_shard']}; every answer equals the fused "
                    f"batch's; {smi}")
                del sdev, wres, kres
            torch.cuda.empty_cache()

            # -- static server, microbatches of 64
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv = rt.DeviceQueryServer.from_index(index, shards=SHARDS_SERVED, device=device)
            torch.cuda.synchronize()
            boot = time.perf_counter() - t0
            current["sdev"] = srv.sdev
            launches.reset()
            walls = {}
            t0 = time.perf_counter()
            wres = srv.window(los, his)
            walls["window"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            kres = srv.knn(qs, k)
            walls["knn"] = time.perf_counter() - t0
            main_path_launched(f"{tag} server", launches.counts())
            same_as_fused(f"{tag} server", pts32, qs, inputs, wres, kres,
                          f"the shards={SHARDS_SERVED} server")
            serving_zero_faults(f"{tag} server", srv.stats)
            out["server"] = {"boot_s": boot, "wall_s": walls, "stats": dict(vars(srv.stats)),
                             "upload_stats": srv.upload_stats.as_dict(),
                             "launches": launches.counts()}
            log(f"[{tag}] shards={SHARDS_SERVED} server: boot {boot:.3f} s; {walls} over "
                f"{srv.stats.microbatches} microbatches of 64; every answer equals the fused "
                f"batch's; {smi}")
            if profile:
                w_lo, w_hi, q64 = los[:64], his[:64], qs[:64]
                out["server"]["profile"] = profile_batches({
                    "window": lambda: srv.window(w_lo, w_hi),
                    "knn": lambda: srv.knn(q64, k)}, torch)
                log(f"[{tag}] profile (warm sharded microbatches): "
                    f"{out['server']['profile']}")
            del srv, wres, kres
            torch.cuda.empty_cache()

            # -- outage: shard 1 dead, then repair([1])
            plan = FaultPlan([FaultRule("shard_dispatch", rate=1.0, match={"shard": 1})],
                             seed=0)
            srv = rt.DeviceQueryServer.from_index(
                index, shards=SHARDS_SERVED, fault_plan=plan, breaker_threshold=1,
                breaker_cooldown_s=1e9, retry=RetryPolicy(max_attempts=2, sleep=lambda s: 0),
                device=device)
            current["sdev"] = srv.sdev
            owned = np.zeros(n, dtype=bool)
            ids1 = srv.sdev.shards[1].host_ids
            owned[ids1[ids1 >= 0]] = True
            wres, wcerts = srv.window(los, his, return_certs=True)
            kres, kcerts = srv.knn(qs, k, return_certs=True)
            sdev = srv.sdev
            hit1 = boxes_intersect_windows(sdev.shard_lo[1:2], sdev.shard_hi[1:2],
                                           los.astype(np.float32), his.astype(np.float32))[:, 0]
            want_w = inputs["batches"][("window", "f32")]
            bad = []
            for i, (got, cert, want) in enumerate(zip(wres, wcerts, want_w)):
                alive = want[~owned[want]]
                dropped = pts32[want[owned[want]]]
                ok = (cert.complete == (not hit1[i]) and np.array_equal(np.sort(got),
                                                                        np.sort(alive)))
                if not cert.complete:
                    ok &= (cert.missing_shards == (1,) and not cert.certified_exact and
                           bool(((cert.missing_lo[0] <= dropped)
                                 & (dropped <= cert.missing_hi[0])).all()))
                if not ok:
                    bad.append(i)
            minds1 = boxes_mindist_sq(sdev.shard_lo[1:2], sdev.shard_hi[1:2],
                                      qs.astype(np.float32))[:, 0]
            want_k = inputs["batches"][("knn", "f32")][1]
            n_exact = 0
            for i, (ids, cert) in enumerate(zip(kres, kcerts)):
                d2 = brute_d2(pts32[ids], qs[i].astype(np.float32))
                if cert.missing_shards not in ((), (1,)) or cert.certified_exact != bool(
                        minds1[i] > d2[-1]):
                    bad.append(("knn", i))
                if owned[ids].any() or not np.all(np.diff(d2) >= 0):
                    bad.append(("knn alive", i))
                if cert.certified_exact:
                    n_exact += 1
                    if not np.array_equal(d2, want_k[i]):
                        bad.append(("knn exact", i))
            alive_pts = np.flatnonzero(~owned)
            for i in range(16):   # exact over the alive shards (brute force)
                full = brute_d2(pts32[alive_pts], qs[i].astype(np.float32))
                check_knn(full, np.searchsorted(alive_pts, kres[i]),
                          brute_d2(pts32[kres[i]], qs[i].astype(np.float32)), k)
            if bad:
                raise AssertionError(f"[{tag}] outage answers or certificates wrong at "
                                     f"{bad[:8]}")
            n_deg = int(sum(not c.complete for c in wcerts))
            if not (0 < n_deg < len(los)) or srv.breakers[1].state != "open":
                raise AssertionError(f"[{tag}] outage: {n_deg} degraded windows, breaker "
                                     f"{srv.breakers[1].state}")
            exports = srv.upload_stats["full_exports"]
            plan.disarm()
            t0 = time.perf_counter()
            repaired = srv.repair()
            torch.cuda.synchronize()
            repair_s = time.perf_counter() - t0
            launches.reset()
            wres2, wc2 = srv.window(los, his, return_certs=True)
            kres2, kc2 = srv.knn(qs, k, return_certs=True)
            main_path_launched(f"{tag} repaired", launches.counts())
            if (repaired != [1] or srv.upload_stats["full_exports"] != exports + 1
                    or not all(c.complete and c.certified_exact for c in wc2 + kc2)):
                raise AssertionError(f"[{tag}] repair {repaired}: {srv.upload_stats}")
            same_as_fused(f"{tag} repaired", pts32, qs, inputs, wres2, kres2, "after repair")
            out["outage"] = {"degraded_windows": n_deg,
                             "knn_certified_exact": n_exact,
                             "knn_missing_shard_1": int(sum(not c.certified_exact
                                                            for c in kcerts)),
                             "retries": srv.stats.retries, "repair_s": repair_s,
                             "stats": dict(vars(srv.stats))}
            log(f"[{tag}] outage of shard 1: {out['outage']}; certificates name exactly "
                f"shard 1, answers are the alive shards' share of the brute force; "
                f"repair([1]) re-exported one shard and every answer equals the fused "
                f"batch's again; {smi}")
            del srv, wres, kres, wres2, kres2, owned, alive_pts, plan
            torch.cuda.empty_cache()

            # -- adaptive: AMBI behind from_ambi(..., shards=4), phase 3a's stream
            if small_n:
                pts = osm_like(small_n, seed=7)
                pts32 = pts.astype(np.float32)
                buffer_pages = buffer_pages_for(small_n, 2)
            p = pts32.astype(np.float64)
            t0 = time.perf_counter()
            ambi = rt.AMBI(p, buffer_pages)
            srv = rt.DeviceQueryServer.from_ambi(ambi, shards=SHARDS_SERVED, device=device)
            torch.cuda.synchronize()
            boot = time.perf_counter() - t0
            current["sdev"] = srv.sdev
            if srv.sdev.m != 1:
                raise AssertionError(f"[{tag}] adaptive boot planned {srv.sdev.m} shards")
            rng = np.random.default_rng(13)
            centres = p[rng.integers(0, len(p), 2)]
            stream = [(centres[s % 2] + rng.random((64, 2)) * 0.08)
                      .astype(np.float32).astype(np.float64) for s in range(16)]
            hw = 0.01
            refresh_s.clear()
            launches.reset()
            batches, answers, replan = [], [], None
            for b, batch in enumerate(stream):
                for kind in ("window", "knn"):
                    st = srv.stats
                    before = (st.cold_queries, st.shard_refreshes, len(refresh_s))
                    t = time.perf_counter()
                    res = (srv.window(batch - hw, batch + hw) if kind == "window"
                           else srv.knn(batch, k))
                    wall = time.perf_counter() - t
                    current["sdev"] = srv.sdev
                    if replan is None and srv.sdev.m == SHARDS_SERVED:
                        replan = {"batch": b, "kind": kind,
                                  "full_exports": srv.upload_stats["full_exports"],
                                  "shard_refreshes": st.shard_refreshes}
                    batches.append({"kind": kind, "wall_s": wall,
                                    "cold": st.cold_queries - before[0],
                                    "shard_refreshes": st.shard_refreshes - before[1],
                                    "refresh_s": [s for _, s in refresh_s[before[2]:]]})
                    answers.append((kind, batch, res))
            counts = launches.counts()
            main_path_launched(f"{tag} adaptive", counts)
            st, up = srv.stats, srv.upload_stats
            out["adaptive"] = {"n": len(p), "buffer_pages": buffer_pages, "boot_s": boot,
                               "batches": batches, "replan": replan, "launches": counts,
                               "stats": dict(vars(st)), "upload_stats": up.as_dict(),
                               "refresh_s": [s for _, s in refresh_s],
                               "leaves_per_shard": [s.n_leaves for s in srv.sdev.shards]}
            log(f"[{tag}] adaptive over {len(p)} points: boot {boot:.3f} s; re-plan {replan}; "
                f"{st}; uploads {up.as_dict()}; refreshes "
                f"{[round(s, 4) for _, s in refresh_s]}; batch walls "
                f"{[round(b_['wall_s'], 4) for b_ in batches]}; {smi}")
            if replan is None or srv.sdev.m != SHARDS_SERVED or st.shards != SHARDS_SERVED:
                raise AssertionError(f"[{tag}] the adaptive server never re-planned to "
                                     f"{SHARDS_SERVED} shards: {st}")
            if up.full_exports != 1 + SHARDS_SERVED + (st.shard_refreshes - SHARDS_SERVED):
                raise AssertionError(f"[{tag}] adaptive exports {up.as_dict()} against {st}")
            serving_zero_faults(f"{tag} adaptive", st)
            windows = SortedWindows(pts32)
            for b in (0, 4, 8, 12, 15):
                for kind, batch, res in answers[2 * b: 2 * b + 2]:
                    b32 = batch.astype(np.float32)
                    for i in range(len(batch) if kind == "window" else 16):
                        if kind == "window":
                            if not np.array_equal(np.sort(res[i]), windows(
                                    b32[i] - np.float32(hw), b32[i] + np.float32(hw))):
                                raise AssertionError(f"[{tag}] adaptive window {b}/{i}")
                        else:
                            full = brute_d2(pts32, b32[i])
                            check_knn(full, res[i], full[res[i]], k)
            log(f"[{tag}] adaptive: windows of batches 0, 4, 8, 12, 15 and 16 k-NN queries "
                f"of each equal the brute force")
            del srv, ambi, answers, windows
            torch.cuda.empty_cache()

            # -- streaming: from_streaming(..., shards=4), phase 3s's traffic
            t0 = time.perf_counter()
            sstream = rt.StreamingIndex(p, buffer_pages=buffer_pages)
            base_s = time.perf_counter() - t0
            del p
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv = rt.DeviceQueryServer.from_streaming(sstream, microbatch=STREAM_BATCH,
                                                      shards=SHARDS_SERVED, device=device)
            torch.cuda.synchronize()
            boot = time.perf_counter() - t0
            current["sdev"] = srv.sdev
            n0 = sstream.n_ids
            feed = (np.random.default_rng(5).random((STREAM_INSERTS * STREAM_PER_INSERT, 2))
                    .astype(np.float32).astype(np.float64))
            drng = np.random.default_rng(17)
            base_dels = drng.choice(n0, 32 * (STREAM_INSERTS // 4), replace=False)
            new_dels: list = []
            w_lo, w_hi, q64 = (x[:STREAM_BATCH].astype(np.float32).astype(np.float64)
                               for x in (los, his, qs))
            insert_s, rounds, sanswers = [], [], []
            refresh_s.clear()
            launches.reset()
            for i in range(STREAM_INSERTS):
                t = time.perf_counter()
                srv.insert(feed[i * STREAM_PER_INSERT:(i + 1) * STREAM_PER_INSERT])
                torch.cuda.synchronize()
                insert_s.append(time.perf_counter() - t)
                current["sdev"] = srv.sdev
                if (i + 1) % 4 == 0:
                    j = (i + 1) // 4 - 1
                    ins = np.setdiff1d(np.arange(n0, sstream.n_ids), new_dels)
                    new = drng.choice(ins, 16, replace=False)
                    new_dels.extend(new.tolist())
                    srv.delete(np.concatenate([base_dels[32 * j:32 * (j + 1)], new]))
                if srv._stream_is_stale():
                    raise AssertionError(f"[{tag}] the sharded export went stale")
                if (i + 1) % 8 == 0:
                    t = time.perf_counter()
                    wres = srv.window(w_lo, w_hi)
                    w_s = time.perf_counter() - t
                    t = time.perf_counter()
                    kres = srv.knn(q64, k)
                    rounds.append({"after_insert": i + 1, "k_eff": srv._k_eff(k),
                                   "window_s": w_s, "knn_s": time.perf_counter() - t,
                                   "shard_refreshes": srv.stats.shard_refreshes})
                    sanswers.append((wres, kres, sstream.live_mask().copy()))
                    log(f"[{tag}] streaming round {rounds[-1]}")
            counts = launches.counts()
            main_path_launched(f"{tag} streaming", counts)
            st, up = srv.stats, srv.upload_stats
            n_fed = STREAM_INSERTS * STREAM_PER_INSERT
            out["streaming"] = {
                "n": n0, "base_load_s": base_s, "boot_s": boot, "insert_s": insert_s,
                "points_per_s": n_fed / sum(insert_s), "rounds": rounds, "launches": counts,
                "refresh_s": [s for _, s in refresh_s], "stats": dict(vars(st)),
                "upload_stats": up.as_dict(),
                "stream": {c: getattr(sstream, c) for c in
                           ("flushes", "fusions", "merges", "shadow")}}
            log(f"[{tag}] sharded streaming over {n0} points: base {base_s:.3f} s, boot "
                f"{boot:.3f} s; {out['streaming']['points_per_s']:.1f} points/s; refreshes "
                f"{[round(s, 4) for _, s in refresh_s]}; {st}; uploads {up.as_dict()}; "
                f"launches {counts}; {smi}")
            if not (st.stream_reshards == 0
                    and 0 < st.shard_refreshes < SHARDS_SERVED * st.stream_syncs):
                raise AssertionError(f"[{tag}] sharded streaming: {st}")
            serving_zero_faults(f"{tag} streaming", st)
            for wres, kres, live in sanswers:
                check_live_answers(tag, sstream.points[:len(live)], live, w_lo, w_hi, q64,
                                   wres, kres, k, STREAM_CHECK)
            log(f"[{tag}] every streaming round: no deleted id; the first {STREAM_CHECK} "
                f"windows and k-NN queries equal a brute force over the live rows")
            if profile:
                extra = (np.random.default_rng(29).random((2048, 2))
                         .astype(np.float32).astype(np.float64))
                out["streaming"]["profile_sync"] = profile_batches(
                    {"insert_2048": lambda: srv.insert(extra)}, torch)
                log(f"[{tag}] profile (an insert of 2048 with its sync): "
                    f"{out['streaming']['profile_sync']}")
            del srv, sstream, sanswers
    finally:
        for cls, name, orig in restore:
            setattr(cls, name, orig)
    out["launch_shapes"] = recorder.shapes
    return out, recorder.calls


# --------------------------------------------------------------------------
# phase 3c: the collective build and rounds over a process group
# --------------------------------------------------------------------------
# the kernels the ranks launch (partition_assign only where m > 1: it
# routes points to their owner shards)
COLLECTIVE = ("partition_assign", "leaf_mindist", "gathered_dist2", "window_count_tiles")
COLLECTIVE_RANKS = 4
COLLECTIVE_LEVELS = 14        # 10M points over 4 ranks: about 305 slots per leaf
COLLECTIVE_BATCH = 64         # knn_batch_shard_map scans every leaf: a small batch
ONE_RANK_N = 1_000_000        # the NCCL world of one: a transport check
ONE_RANK_LEVELS = 12
STACKED = ("leaf_pts", "leaf_ids", "leaf_counts", "leaf_lo", "leaf_hi")
RANK_TIMEOUT = 600


def collective_rank(group, tmp, levels, k, record):
    """One rank of phase 3c: ``shard_build`` over its row slice of
    ``points.npy`` (memory-mapped), ``shard_knn`` over ``qs.npy``, and
    both collective rounds over the stacked layout saved beside it.  Rank
    0 records one call per kernel (``torch.save`` into ``tmp``) when
    ``record``.  Returns host data only."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core import distributed_torch as DT
    from repro_torch.kernels import launches, ops

    m, r = group.size, group.rank
    pts = np.load(f"{tmp}/points.npy", mmap_mode="r")
    per = len(pts) // m
    stacked = {key: np.load(f"{tmp}/stacked_{key}.npy", mmap_mode="r") for key in STACKED}
    qs, los, his = (np.load(f"{tmp}/{name}.npy") for name in ("qs", "los", "his"))
    recorder = (Recorder(ops, COLLECTIVE, suffix=":collective") if record and r == 0
                else contextlib.nullcontext())
    launches.reset()
    with recorder:
        local = D.shard_build(np.array(pts[r * per:(r + 1) * per]), levels, group)
        staged_build = group.staged_bytes
        with group.timed("shard_knn"):
            knn = D.shard_knn(local.index, qs, k, group)
        with group.timed("knn_batch"):
            batch = DT.knn_batch_shard_map(stacked, qs[:COLLECTIVE_BATCH], k, group)
        with group.timed("window_count"):
            counts = DT.window_count_batch_shard_map(stacked, los, his, group)
    if record and r == 0:
        torch.save(recorder.calls, f"{tmp}/calls.pt")
    return {"arrays": local.arrays(), "n_mine": local.n_mine, "n_dropped": local.n_dropped,
            "seconds": dict(group.seconds), "staged_build": staged_build,
            "staged_bytes": group.staged_bytes, "launches": launches.counts(),
            "knn": tuple(t.cpu().numpy() for t in knn), "knn_batch": batch,
            "window_count": counts}


def brute_knn_top(pts_dev, keep, qs32, k, torch, chunk=8):
    """The ``k + 1`` smallest f32 squared distances per query over the
    rows where ``keep`` holds, and their rows: plain PyTorch on the card,
    summed per dimension in the kernels' order, ``chunk`` queries at a
    time."""
    q = torch.from_numpy(qs32).to(pts_dev.device)
    drop = ~torch.from_numpy(keep).to(pts_dev.device)
    dist, rows = [], []
    for a in range(0, len(q), chunk):
        acc = torch.zeros((len(q[a:a + chunk]), len(pts_dev)), device=pts_dev.device)
        for j in range(pts_dev.shape[1]):
            diff = pts_dev[None, :, j] - q[a:a + chunk, j, None]
            acc = acc + diff * diff
        acc.masked_fill_(drop[None], float("inf"))
        v, i = torch.topk(acc, k + 1, dim=1, largest=False)
        dist.append(v.cpu().numpy())
        rows.append(i.cpu().numpy())
    return np.concatenate(dist), np.concatenate(rows)


def check_top(tag, what, pts32, q, d2, ids, want_d, want_i, k) -> None:
    """One k-NN answer against the brute force's ``k + 1`` best: equal
    distance sequence, distances those of the ids, equal ids where the
    k-th distance is not tied."""
    if (not np.array_equal(d2, want_d[:k])
            or not np.array_equal(brute_d2(pts32[ids], q), d2)
            or (want_d[k - 1] < want_d[k] and set(ids.tolist()) != set(want_i[:k].tolist()))):
        raise AssertionError(f"[{tag}] {what}: {ids} at {d2}, brute force {want_i[:k]} at "
                             f"{want_d[:k]}")


def run_collective(tag, pts32, stacked, qs32, los32, his32, m, levels, k, backend, device,
                   record, torch):
    """Save the inputs into a temporary directory, run ``collective_rank``
    on ``m`` ranks of ``backend`` (every rank on ``device``), check that
    every rank holds the same answers and log each rank's spans, staged
    bytes and launches.  Returns the rank results, the recorded calls and
    the run's wall seconds."""
    from repro_torch.core import mesh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_collective_") as tmp:
        np.save(f"{tmp}/points.npy", pts32)
        for key in STACKED:
            np.save(f"{tmp}/stacked_{key}.npy", stacked[key])
        for name, a in (("qs", qs32), ("los", los32), ("his", his32)):
            np.save(f"{tmp}/{name}.npy", a)
        t0 = time.perf_counter()
        ranks = mesh.run_ranks(collective_rank, m, backend=backend, devices=[device] * m,
                               args=(tmp, levels, k, record), timeout=RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        calls = (torch.load(f"{tmp}/calls.pt", map_location=device, weights_only=False)
                 if record else {})
    for r, res in enumerate(ranks[1:], 1):
        for key in ("knn", "knn_batch", "window_count"):
            a, b = res[key], ranks[0][key]
            if isinstance(a, np.ndarray):
                a, b = (a,), (b,)
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"[{tag}] rank {r}'s {key} differs from rank 0's")
    for r, res in enumerate(ranks):
        s = res["seconds"]
        log(f"[{tag}] {backend} rank {r}/{m}: sample gather {s['sample_gather']:.4f} s, "
            f"route {s['route']:.4f} s, all_to_all {s['all_to_all']:.4f} s "
            f"({res['staged_build']} B staged through the host), local build "
            f"{s['build']:.4f} s; rounds: shard_knn {s['shard_knn'] * 1e3:.2f} ms, "
            f"knn_batch_shard_map {s['knn_batch'] * 1e3:.2f} ms, "
            f"window_count_batch_shard_map {s['window_count'] * 1e3:.2f} ms; "
            f"{res['staged_bytes']} B staged in all; n_mine {res['n_mine']}, dropped "
            f"{res['n_dropped']}; launches {res['launches']}")
    return ranks, calls, wall


def check_collective(tag, pts32, ranks, qs32, k, want_counts, torch, device, launched):
    """The checks both worlds share: every row kept once or dropped, the
    kernels of ``launched`` launched on every rank, certified
    ``shard_knn`` answers and every ``knn_batch_shard_map`` answer equal
    to a brute force over the kept rows, and the window counts equal
    ``want_counts``.  Returns the stacked build, the kept-row mask and the
    brute force's top distances and rows."""
    from repro_torch.core import distributed as D

    n = len(pts32)
    shard_out = D.stack_shards([r["arrays"] for r in ranks])
    rows = shard_out[1].ravel()
    rows = rows[rows >= 0]
    n_mine = sum(r["n_mine"] for r in ranks)
    dropped = sum(r["n_dropped"] for r in ranks)
    if (n_mine + dropped != n or len(rows) != n_mine or len(np.unique(rows)) != len(rows)
            or rows.min() < 0 or rows.max() >= n):
        raise AssertionError(f"[{tag}] rows lost or duplicated: n_mine {n_mine} + dropped "
                             f"{dropped} of {n}, {len(rows)} row ids")
    for r, res in enumerate(ranks):
        missing = [kk for kk in launched if res["launches"][kk] == 0]
        if missing:
            raise AssertionError(f"[{tag}] rank {r} did not launch {missing}")
    keep = np.zeros(n, dtype=bool)
    keep[rows] = True
    pts_dev = torch.from_numpy(pts32).to(device)
    want_d, want_i = brute_knn_top(pts_dev, keep, qs32, k, torch)
    d2, sel, _, exact = ranks[0]["knn"]
    for i in np.flatnonzero(exact):
        check_top(tag, f"shard_knn query {i}", pts32, qs32[i], d2[i], sel[i], want_d[i],
                  want_i[i], k)
    if keep.all():
        all_d, all_i = want_d, want_i
    else:
        all_d, all_i = brute_knn_top(pts_dev, np.ones(n, dtype=bool), qs32[:COLLECTIVE_BATCH],
                                     k, torch)
    b_d2, b_ids = ranks[0]["knn_batch"]
    for i in range(COLLECTIVE_BATCH):
        check_top(tag, f"knn_batch_shard_map query {i}", pts32, qs32[i], b_d2[i], b_ids[i],
                  all_d[i], all_i[i], k)
    counts = ranks[0]["window_count"]
    if counts.dtype != np.int32 or not np.array_equal(counts, want_counts):
        raise AssertionError(f"[{tag}] window_count_batch_shard_map differs at "
                             f"{np.flatnonzero(counts != want_counts)[:5]}")
    log(f"[{tag}] {n_mine} rows kept once, {dropped} dropped at the capacity; "
        f"{int(exact.sum())} of {len(exact)} shard_knn answers certified, each equal to the "
        f"brute force over the kept rows; {COLLECTIVE_BATCH} knn_batch_shard_map answers "
        f"equal the brute force; {len(counts)} window counts equal")
    del pts_dev
    return shard_out, keep, want_d, want_i


def collective_path(tag, pts, inputs, k, torch, rt, launches, device="cuda:0",
                    levels=COLLECTIVE_LEVELS,
                    one_n=ONE_RANK_N, one_levels=ONE_RANK_LEVELS, one_backend="nccl"):
    """Phase 3c: the collective build and rounds on phase 3's points (f32).

    Four gloo ranks on ``device`` (the card: NCCL puts no two ranks on
    one GPU, so gloo runs the collectives through host tensors and the
    compute stays on the card): ``shard_build`` at ``levels``,
    ``shard_knn`` over phase 3's 1024 queries, ``knn_batch_shard_map``
    over its first ``COLLECTIVE_BATCH`` on ``ShardedDeviceTable.from_index(index,
    4).stacked()`` and ``window_count_batch_shard_map`` over its 1024
    windows; then the built shards through ``shard_build_tables`` and
    ``from_tables`` behind the sharded protocols.  Then a world of one on
    ``one_backend`` (NCCL on the card) over the first ``one_n`` points:
    the transport check of the m = 1 branch, not the full-width path.
    The protocols' calls are recorded under ``<dtype>:collective_tables``
    (first, smallest and last), the router's pruning counted as in 3h.
    Returns the measurements, rank 0's recorded kernel calls and the
    protocols'."""
    from repro_torch.core import distributed as D
    from repro_torch.core import distributed_torch as DT
    from repro_torch.kernels import ops

    pts32 = np.ascontiguousarray(pts, dtype=np.float32)
    qs32 = inputs["qs"].astype(np.float32)
    los32, his32 = inputs["los"].astype(np.float32), inputs["his"].astype(np.float32)
    t_start = time.perf_counter()
    m = COLLECTIVE_RANKS
    out = {"ranks": m, "levels": levels}
    # on the CPU (a rehearsal) every kernel runs as its plain version
    on_card = torch.device(device).type == "cuda"
    launched = COLLECTIVE if on_card else ()
    t0 = time.perf_counter()
    stacked = rt.ShardedDeviceTable.from_index(inputs["index"], m, device=device).stacked()
    out["stacked_s"] = time.perf_counter() - t0
    ranks, calls, out["run_s"] = run_collective(
        tag, pts32, stacked, qs32, los32, his32, m, levels, k, "gloo", device, True,
        torch)
    del stacked
    out["per_rank"] = [{kk: res[kk] for kk in ("seconds", "staged_build", "staged_bytes",
                                                "launches", "n_mine", "n_dropped")}
                       for res in ranks]
    if on_card and not all(res["staged_bytes"] > 0 for res in ranks):
        raise AssertionError(f"[{tag}] a gloo rank on {device} staged nothing")
    shard_out, keep, want_d, want_i = check_collective(
        tag, pts32, ranks, qs32, k, inputs["window_counts"], torch, device, launched)
    b_d2, b_ids = ranks[0]["knn_batch"]
    fused_ids, fused_d2 = inputs["batches"][("knn", "f32")]
    for i in range(COLLECTIVE_BATCH):
        below = b_d2[i] < b_d2[i][-1]
        if (not np.array_equal(b_d2[i], fused_d2[i])
                or set(b_ids[i][below].tolist()) != set(fused_ids[i][below].tolist())):
            raise AssertionError(f"[{tag}] knn_batch_shard_map query {i} differs from "
                                 f"phase 3's fused batch")
    del ranks
    # the built shards behind the sharded protocols
    t0 = time.perf_counter()
    tables = D.shard_build_tables(shard_out, levels)
    out["tables_s"] = time.perf_counter() - t0
    live = 0
    for t in tables:
        t.check_invariants()
        live += int(t.leaf_count[t.leaf_rows()].sum())
    if live != int(keep.sum()):
        raise AssertionError(f"[{tag}] tables hold {live} rows, the build kept {keep.sum()}")
    t0 = time.perf_counter()
    sdev = rt.ShardedDeviceTable.from_tables(tables, pts32, device=device)
    torch.cuda.synchronize()
    out["from_tables_s"] = time.perf_counter() - t0
    recorder = Recorder(ops, MAIN_PATH, suffix=":collective_tables", last=True)
    probes = ShardProbes(DT, lambda: sdev)
    with recorder, probes:
        wins, out["windows"] = timed_runs(
            lambda: rt.window_query_batch_sharded(sdev, los32, his32), torch, launches)
        knns, out["knn"] = timed_runs(lambda: rt.knn_query_batch_sharded(sdev, qs32, k),
                                      torch, launches)
    for kind, names in (("windows", ("box_hits", "pair_window_ids")),
                        ("knn", ("leaf_mindist", "pair_dist2"))):
        missing = [kk for kk in names if not out[kind]["launches"].get(kk)]
        if missing:
            raise AssertionError(f"[{tag}] from_tables {kind}: kernels not launched: "
                                 f"{missing}")
    calls.update(recorder.calls)
    out.update(leaves_per_shard=[s.n_leaves for s in sdev.shards],
               leaf_size=[s.leaf_size for s in sdev.shards],
               **probe_stats(probes, sdev, los32, his32, qs32, runs=2))
    kept_rows = np.flatnonzero(keep)
    fused_w = inputs["batches"][("window", "f32")]
    for i, (got, want) in enumerate(zip(wins, fused_w)):
        if not np.array_equal(np.sort(got), np.sort(want[keep[want]])):
            raise AssertionError(f"[{tag}] from_tables window {i} differs from the kept rows "
                                 f"of the fused answer")
    sorted_kept = SortedWindows(pts32[kept_rows])
    for i in range(32):
        if not np.array_equal(np.sort(wins[i]), kept_rows[sorted_kept(los32[i], his32[i])]):
            raise AssertionError(f"[{tag}] from_tables window {i} differs from brute force")
    for i, ids in enumerate(knns):
        check_top(tag, f"from_tables k-NN query {i}", pts32, qs32[i],
                  brute_d2(pts32[ids], qs32[i]), ids, want_d[i], want_i[i], k)
    log(f"[{tag}] shard_build_tables {out['tables_s']:.3f} s, from_tables "
        f"{out['from_tables_s']:.3f} s ({out['leaves_per_shard']} leaves of "
        f"{out['leaf_size']} slots); windows {out['windows']}; k-NN {out['knn']}; "
        f"{out['shards_per_window']:.3f} shards per window, {out['round1_home_shards']} "
        f"round-1 home shards, {out['round2_pairs']} round-2 (query, shard) pairs "
        f"{out['round2_queries_per_shard']}; {len(wins)} windows and {len(knns)} k-NN "
        f"queries through the protocols equal the brute force over the {live} kept rows")
    del sdev, tables, shard_out
    # the world of one: the m = 1 branch and the transport of one_backend
    sub = pts32[:one_n]
    idx1 = rt.bulk_load(sub.astype(np.float64), 250, rt.PageStore(250))
    stacked1 = rt.ShardedDeviceTable.from_index(idx1, 1, device=device).stacked()
    sorted_sub = SortedWindows(sub)
    counts1 = np.array([len(sorted_sub(lo, hi)) for lo, hi in zip(los32, his32)],
                       dtype=np.int32)
    ranks1, _, out["one_run_s"] = run_collective(
        f"{tag} {one_backend} world of 1 (transport check)", sub, stacked1, qs32, los32,
        his32, 1, one_levels, k, one_backend, device, False, torch)
    if one_backend == "nccl" and ranks1[0]["staged_bytes"]:
        raise AssertionError(f"[{tag}] the NCCL rank staged through the host")
    check_collective(f"{tag} {one_backend} world of 1", sub, ranks1, qs32, k, counts1,
                     torch, device,
                     tuple(kk for kk in launched if kk != "partition_assign"))
    out["one_rank"] = {"backend": one_backend, "n": one_n, "levels": one_levels,
                       **{kk: ranks1[0][kk] for kk in ("seconds", "staged_bytes",
                                                       "launches")}}
    out["total_s"] = time.perf_counter() - t_start
    log(f"[{tag}] {one_backend} world of 1 over {one_n} points: a transport check of the "
        f"m = 1 branch, not the full-width path; {out['one_rank']}; phase 3c "
        f"{out['total_s']:.1f} s")
    return out, calls


# --------------------------------------------------------------------------
# the retrieval path (balanced grid index + RetrievalServer)
# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# phase 3b: the paper's competitor loaders behind the device engine
# --------------------------------------------------------------------------
COMPETITOR_N = 3_000_000   # phase 3's 10M points cut for the host builds' time


def competitors_path(tag, n, k, torch, rt, launches, device="cuda", profile=False):
    """Phase 3b: each of the six ``ALL_LOADERS`` trees over
    ``osm_like(n, seed=7)`` (buffer 5 % of the pages) built on the host
    (seconds, IOStats, ``leaf_stats``, ``overlap_area_2d``), exported to
    the card (f32) and queried with phase 3's generators: one 1024-window
    batch (half-width 0.01) and one 1024-query k-NN batch, three runs each,
    the counts zeroed before and read after (the four main-path kernels
    must launch for every tree).  Every window's id set and every k-NN
    distance sequence must be equal across the six trees, and the first
    windows and queries equal to the brute force.  Returns the
    measurements and each tree's first, smallest and largest kernel calls
    (``<dtype>:competitors:<loader>``).  ``profile`` adds a trace of one
    warm batch of each kind per tree."""
    from repro_torch.core.datasets import osm_like
    from repro_torch.core.metrics import overlap_area_2d
    from repro_torch.kernels import ops

    pts = osm_like(n, seed=7)
    d = pts.shape[1]
    buffer_pages = buffer_pages_for(n, d)
    qrng = np.random.default_rng(11)           # phase 3's generators
    centres = qrng.random((1024, d)) * 0.9
    los, his = centres - 0.01, centres + 0.01
    qs = qrng.random((1024, d))
    out = {"n": n, "d": d, "buffer_pages": buffer_pages, "trees": {}}
    calls, answers = {}, {}
    for name in sorted(rt.ALL_LOADERS):
        rec = {}
        store = rt.PageStore(buffer_pages)
        t0 = time.perf_counter()
        idx = rt.ALL_LOADERS[name](pts, buffer_pages, store)
        rec["build_s"] = time.perf_counter() - t0
        rec["io"] = {"reads": store.stats.reads, "writes": store.stats.writes,
                     "total": store.stats.total}
        rec["leaf_stats"] = rt.leaf_stats(idx).as_row()
        rec["overlap_area_2d"] = overlap_area_2d(idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = rt.DeviceTable.from_index(idx, device=device)
        torch.cuda.synchronize()
        rec["export_s"] = time.perf_counter() - t0
        rec.update(leaves=dev.n_leaves, leaf_size=dev.leaf_size, levels=len(dev.levels))
        recorder = Recorder(ops, MAIN_PATH, suffix=f":competitors:{name}", largest=True)
        launches.reset()
        with recorder:
            wres, rec["window"] = timed_runs(
                lambda: rt.window_query_batch_torch(dev, los, his, fused=True), torch,
                launches, runs=3)
            kres, rec["knn"] = timed_runs(
                lambda: rt.knn_query_batch_torch(dev, qs, k, fused=True, return_dists=True),
                torch, launches, runs=3)
        rec["window"]["chunks"] = rec["window"]["launches"].get("pair_window_ids", 0)
        rec["knn"]["rounds"] = rec["knn"]["launches"].get("leaf_mindist", 0)
        rec["launches"] = launches.counts()
        rec["launch_shapes"] = recorder.shapes
        missing = [kk for kk in MAIN_PATH if rec["launches"][kk] == 0]
        if missing:
            raise AssertionError(f"[{tag}] {name}: main-path kernels not launched: {missing}")
        calls.update(recorder.calls)
        if profile:
            rec["profile"] = profile_batches({
                "window": lambda: rt.window_query_batch_torch(dev, los, his, fused=True),
                "knn": lambda: rt.knn_query_batch_torch(dev, qs, k, fused=True)}, torch)
        answers[name] = ([np.sort(w) for w in wres], kres)
        out["trees"][name] = rec
        log(f"[{tag}] {name}: build {rec['build_s']:.3f} s, io {rec['io']}, "
            f"{rec['leaves']} leaves of <= {rec['leaf_size']} slots, {rec['levels']} levels, "
            f"leaf_stats {rec['leaf_stats']}, overlap {rec['overlap_area_2d']}; export "
            f"{rec['export_s']:.3f} s; window {rec['window']}; knn {rec['knn']}")
        del dev, idx, recorder

    first = "fmbi"
    wins, (_, dists) = answers[first]
    for name, (w, (_, kd)) in answers.items():
        if len(w) != len(wins) or any(not np.array_equal(a, b) for a, b in zip(w, wins)):
            raise AssertionError(f"[{tag}] {name}'s windows differ from {first}'s")
        if len(kd) != len(dists) or any(not np.array_equal(a, b) for a, b in zip(kd, dists)):
            raise AssertionError(f"[{tag}] {name}'s k-NN distances differ from {first}'s")
    pts32 = pts.astype(np.float32)
    lo32, hi32, qs32 = los.astype(np.float32), his.astype(np.float32), qs.astype(np.float32)
    for i in range(32):
        if not np.array_equal(wins[i], brute_window(pts32, lo32[i], hi32[i])):
            raise AssertionError(f"[{tag}] window {i} differs from brute force")
    for i in range(16):
        full = brute_d2(pts32, qs32[i])
        for name, (_, (ids, kd)) in answers.items():
            check_knn(full, ids[i], kd[i], k)
    out["ids_per_batch"] = int(sum(len(w) for w in wins))
    log(f"[{tag}] all six trees: 1024 windows ({out['ids_per_batch']} ids) and 1024 "
        f"k-NN distance sequences equal; the first 32 windows and 16 queries equal "
        f"the brute force")
    return out, calls


def retrieval_path(tag, pts, inputs, levels, k, torch, rt, launches,
                   n_kernel=64, n_check=16, device="cuda", profile=False, nan_rows=0):
    """Build ``RetrievalServer(pts, levels)`` on the card, run its batches
    cold and warm with the launch counts zeroed before and read after, and
    check them against phase 3's (or 4's) fused window counts and the
    NumPy brute force.  With ``nan_rows``, also the NaN-row case
    (:func:`nan_row_case`) and the cost of the selection's total-order key
    (:func:`selection_cost`).  Returns the measurements and the recorded
    kernel calls."""
    from repro_torch.core import grid_index as GI
    from repro_torch.kernels import ops

    n, d = pts.shape
    pts32 = pts.astype(np.float32)
    lo32 = inputs["los"].astype(np.float32)
    hi32 = inputs["his"].astype(np.float32)
    qs32 = inputs["qs"].astype(np.float32)
    out = {"n": n, "d": d, "levels": levels, "k": k}
    recorder = Recorder(ops, RETRIEVAL)
    launches.reset()
    with recorder:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = rt.RetrievalServer(pts32, levels=levels, device=device)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        index = srv.index
        out.update(leaves=index.n_leaves, leaf_size=index.leaf_size)
        inter, contained = GI._leaf_window_masks(
            index, torch.from_numpy(lo32).to(device), torch.from_numpy(hi32).to(device))
        straddle = (inter & ~contained).sum(dim=1)
        c = GI._pow2(max(int(straddle.max()), 1))
        out["window_budget_c"] = c
        out["straddle_mean"] = float(straddle.float().mean())
        out["gathered_bytes"] = len(lo32) * c * index.leaf_size * (4 * d + 4)
        del inter, contained
        log(f"[{tag}] build {out['build_s']:.3f} s: {index.n_leaves} leaves of "
            f"{index.leaf_size} slots; window budget c = {c} (mean straddle "
            f"{out['straddle_mean']:.1f}), gathered {out['gathered_bytes']} B")

        knn_res, out["knn"] = timed_runs(
            lambda: srv.knn(qs32, k, n_candidate_leaves=16), torch, launches)
        counts, out["window_count"] = timed_runs(
            lambda: GI.window_count(index, lo32, hi32).cpu().numpy(), torch, launches)
        kk_res, out["knn_kernel"] = timed_runs(
            lambda: srv.knn_kernel(qs32[:n_kernel], k), torch, launches)
        srv.adaptive = True
        srng = np.random.default_rng(13)
        stream = [(srng.random((64, d)) * 0.05 + 0.6) for _ in range(16)]
        _, out["adaptive_stream"] = timed_runs(
            lambda: [srv.knn(b, k) for b in stream], torch, launches)
        out["adaptive_stream"].update(hit_rate=srv.stats.hit_rate,
                                      queries=srv.stats.queries)
        pts_dev = torch.from_numpy(pts32).to(device)
        leaf_of, out["route_all"] = timed_runs(lambda: GI.route(index, pts_dev),
                                               torch, launches)
        in_box = ((index.leaf_lo[leaf_of.long()] <= pts_dev)
                  & (pts_dev <= index.leaf_hi[leaf_of.long()])).all(dim=1)
        out["route_all"]["share_in_own_box"] = float(in_box.float().mean())
        del pts_dev, leaf_of, in_box

        snap_dir = REPO / "build" / "chip_smoke"
        snap_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=snap_dir) as tmp:
            path = pathlib.Path(tmp) / "index.npz"
            t0 = time.perf_counter()
            inputs["index"].save(path)
            out["snapshot_save_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            boot = rt.RetrievalServer.from_snapshot(path, adaptive=True, device=device)
            torch.cuda.synchronize()
            out["snapshot_boot_s"] = time.perf_counter() - t0
        snap_res, out["snapshot_knn"] = timed_runs(
            lambda: boot.knn(qs32, k, n_candidate_leaves=16), torch, launches)
        out["snapshot_grid"] = {"leaves": boot.index.n_leaves,
                                "leaf_size": boot.index.leaf_size}
    launched = launches.counts()
    out["launches"] = launched
    out["launch_shapes"] = recorder.shapes
    missing = [kk for kk in RETRIEVAL if launched[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] retrieval kernels not launched: {missing}")
    for name in ("knn", "window_count", "knn_kernel", "adaptive_stream", "route_all",
                 "snapshot_knn"):
        log(f"[{tag}] {name}: {out[name]}")
    log(f"[{tag}] snapshot save {out['snapshot_save_s']:.3f} s, boot "
        f"{out['snapshot_boot_s']:.3f} s ({out['snapshot_grid']}); retrieval "
        f"launches {launched}; by shape {recorder.shapes}")

    if counts.shape != (len(lo32),) or not np.array_equal(counts, inputs["window_counts"]):
        bad = np.flatnonzero(counts != inputs["window_counts"])
        raise AssertionError(f"[{tag}] window_count differs from the fused window "
                             f"batch at {len(bad)} windows, first {bad[:5]}")
    rows, d2, exact = knn_res
    out["knn_exact_flags"] = int(exact.sum())
    checked = 0
    for i in np.flatnonzero(exact)[:n_check]:
        check_knn(brute_d2(pts32, qs32[i]), rows[i], d2[i], k)
        checked += 1
    srows, sd2, sexact = snap_res
    out["snapshot_exact_flags"] = int(sexact.sum())
    for i in np.flatnonzero(sexact)[:4]:
        check_knn(brute_d2(pts32, qs32[i]), srows[i], sd2[i], k)
    kidx, kd2 = kk_res
    krows = index.row_ids.cpu().numpy()[kidx]
    for i in range(min(n_check, n_kernel)):
        check_knn(brute_d2(pts32, qs32[i]), krows[i], kd2[i], k)
    if checked < n_check:
        raise AssertionError(f"[{tag}] only {checked} certified k-NN answers")
    log(f"[{tag}] all {len(counts)} window counts equal the fused batch; "
        f"{out['knn_exact_flags']} of {len(qs32)} knn answers certified, the first "
        f"{checked} and {n_check} knn_kernel answers equal the brute force; "
        f"{out['route_all']['share_in_own_box']:.6f} of the points lie in their "
        f"routed leaf's box")
    if nan_rows:
        out["nan_rows"] = nan_row_case(tag, pts32, qs32, nan_rows, levels, k, n_check,
                                       n_kernel, rt, device)
        out["selection"] = selection_cost(index, qs32, torch, device)
        log(f"[{tag}] selection cost (ms): {out['selection']}")
    if profile:
        srv.adaptive = False
        out["profile"] = profile_batches({
            "knn": lambda: srv.knn(qs32, k, n_candidate_leaves=16),
            "window_count": lambda: GI.window_count(index, lo32, hi32).cpu(),
            "knn_kernel": lambda: srv.knn_kernel(qs32[:n_kernel], k)}, torch)
        log(f"[{tag}] profile: {out['profile']}")
    del srv, boot
    return out, recorder.calls


def nan_row_case(tag, pts32, qs32, n_nan, levels, k, n_check, n_kernel, rt, device):
    """ROADMAP C.7 on the card: ``n_nan`` rows of the points, evenly spread,
    get a NaN y and a ``RetrievalServer`` is built over them.  A NaN
    distance ranks last (``lax.top_k``'s total order), so no NaN row may be
    answered; the first ``n_check`` certified ``knn`` answers and
    ``knn_kernel`` answers must equal the brute force (NaN rows last)."""
    bad = np.linspace(0, len(pts32) - 1, n_nan).astype(np.int64)
    pts_nan = pts32.copy()
    pts_nan[bad, 1] = np.nan
    srv = rt.RetrievalServer(pts_nan, levels=levels, device=device)
    rows, d2, exact = srv.knn(qs32, k, n_candidate_leaves=16)
    kidx, kd2 = srv.knn_kernel(qs32[:n_kernel], k)
    krows = srv.index.row_ids.cpu().numpy()[kidx]
    if np.isin(rows, bad).any() or np.isin(krows, bad).any():
        raise AssertionError(f"[{tag}] a NaN row was answered as a nearest neighbour")
    certified = np.flatnonzero(exact)[:n_check]
    if len(certified) < n_check:
        raise AssertionError(f"[{tag}] only {len(certified)} certified answers over NaN rows")
    for i in certified:
        check_knn(brute_d2(pts_nan, qs32[i]), rows[i], d2[i], k)
    for i in range(min(n_check, n_kernel)):
        check_knn(brute_d2(pts_nan, qs32[i]), krows[i], kd2[i], k)
    log(f"[{tag}] {n_nan} NaN rows: no NaN row answered by knn ({int(exact.sum())} of "
        f"{len(qs32)} certified) or knn_kernel; the first {n_check} of each equal the "
        f"brute force")
    return {"rows": n_nan, "certified": int(exact.sum())}


def selection_cost(index, qs32, torch, device, n_c=16, reps=10):
    """Event times (ms) of the selection's total-order key pass, of the
    stable sort it feeds and of the whole ``ref.top_k``, on the two
    selections of grid ``knn``: candidate leaves by mindist ``(Q, L)`` and
    the candidates' slots by distance ``(Q, n_c * S)``."""
    from repro_torch.kernels import ops, ref

    q = torch.from_numpy(qs32).to(device)
    n_l, s = index.n_leaves, index.leaf_size
    mind = ops.leaf_mindist_tiled(q, index.leaf_lo, index.leaf_hi)
    cand = ref.top_k(-mind, n_c)[1]
    valid = (index.row_ids >= 0).view(n_l, s)[cand].reshape(len(q), n_c * s)
    d2 = ops.gathered_dist2(q, index.points_sorted.view(n_l, s, -1)[cand].reshape(
        len(q), n_c * s, -1), valid.to(torch.int32))
    out = {}
    for name, x, k in (("leaves", -mind, n_c + 1), ("slots", -d2, 16)):
        key = ref.total_order_key(x)
        out[name] = {
            "shape": list(x.shape),
            "key_ms": time_ms(lambda: ref.total_order_key(x), reps, torch),
            "sort_ms": time_ms(lambda: torch.sort(key, dim=-1, descending=True, stable=True),
                               reps, torch),
            "top_k_ms": time_ms(lambda: ref.top_k(x, k), reps, torch),
        }
    return out


# --------------------------------------------------------------------------
# device busy and idle share of one batch (torch.profiler)
# --------------------------------------------------------------------------
def profile_batches(runs: dict, torch) -> dict:
    """Trace one run of each batch in ``runs`` (name -> callable, after a
    warm-up run) and report, per batch, the host wall time, the device busy
    time (the union of the CUDA kernel and copy intervals in the trace),
    the idle share and the device time by kernel name."""
    out = {}
    for kind, run in runs.items():
        run()
        torch.cuda.synchronize()
        wall = []

        def timed(run=run):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e6)
        events = device_trace(timed, torch)
        wall_us = wall[-1]
        spans, by_name = [], {}
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        busy, end = 0.0, -1.0
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[kind] = {
            "wall_us": wall_us, "device_busy_us": busy,
            "idle_share": 1.0 - busy / wall_us if wall_us else None,
            "device_events": len(spans),
            "top_us": [[name[:80], us] for name, us in top],
        }
    return out


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------
def byte_and_op_counts(name, args, kw, out, torch):
    """Bytes the function must move (each input read once, each output
    written once, counting what these inputs need) and its operations."""
    if name == "box_hits":
        lo, hi, qlo, qhi = args
        n, d = lo.shape
        nq = qlo.shape[0]
        b = 2 * n * d * lo.element_size() + 2 * nq * d * 4 + n * nq * 4
        return b, 2 * n * nq * d
    if name == "leaf_mindist":
        q, lo, hi = args
        nq, d = q.shape
        n_l = lo.shape[0]
        b = 2 * n_l * d * lo.element_size() + nq * d * 4 + nq * n_l * 4
        return b, 6 * nq * n_l * d
    if name == "pair_window_ids":
        qlo, qhi, llo, lhi, pts, lids, cnt, qi, li, pv = args
        p, (n_l, s, d) = qi.shape[0], pts.shape
        qi64, li64 = qi.long(), li.long()
        box_ok = ((llo[li64] <= qhi[qi64]) & (lhi[li64] >= qlo[qi64])).all(1) & (pv > 0)
        live = torch.where(box_ok, cnt[li64].clamp(max=s), 0)
        leaves = torch.unique(li64[box_ok])
        pts_b = int(cnt[leaves].clamp(max=s).sum()) * d * 4
        ids_b = int(torch.unique(out[0][out[0] >= 0]).numel()) * 4
        boxes = int(torch.unique(li64[pv > 0]).numel()) * (8 * d + 4)
        qb = int(torch.unique(qi64).numel()) * 8 * d
        b = 12 * p + qb + boxes + pts_b + ids_b + p * s * 4 + p * 4
        return b, int(live.sum()) * 2 * d
    if name == "pair_dist2":
        q, pts, cnt, qi, li = args
        p, (n_l, s, d) = qi.shape[0], pts.shape
        li64 = li.long()
        leaves = torch.unique(li64)
        pts_b = int(cnt[leaves].clamp(max=s).sum()) * d * 4
        qb = int(torch.unique(qi.long()).numel()) * 4 * d
        b = 8 * p + qb + leaves.numel() * 4 + pts_b + p * s * 4
        return b, int(cnt[li64].clamp(max=s).sum()) * 3 * d
    if name == "partition_assign":
        pts, sdim, sval = args
        n, d = pts.shape
        levels = kw["levels"]
        # points and leaf ids once, and the table entries a descent can reach
        return n * d * 4 + n * 4 + ((1 << levels) - 1) * 8, n * levels
    if name == "window_count_gathered":
        lo, hi, pts, valid = args
        nq, npp, d = pts.shape
        nv = int((valid > 0).sum())
        return 2 * nq * d * 4 + nq * npp * 4 + nv * d * 4 + nq * 4, nv * 2 * d
    if name == "window_mask_gathered":
        lo, hi, pts, valid = args
        nq, npp, d = pts.shape
        nv = int((valid > 0).sum())
        return 2 * nq * d * 4 + nq * npp * 4 + nv * d * 4 + nq * npp * 4, nv * 2 * d
    if name == "window_count_tiles":
        lo, hi, pts, *rest = args
        valid = rest[0] if rest else None
        nq, d = lo.shape
        n_p = pts.shape[0]
        nv = n_p if valid is None else int((valid > 0).sum())
        vb = 0 if valid is None else n_p * 4
        return 2 * nq * d * 4 + nv * d * 4 + vb + nq * 4, nq * nv * 2 * d
    if name == "gathered_dist2":
        q, pts, valid = args
        nq, npp, d = pts.shape
        nv = int((valid > 0).sum())
        return nq * d * 4 + nq * npp * 4 + nv * d * 4 + nq * npp * 4, nv * 3 * d
    if name == "pairwise_dist2":
        q, pts, valid = args
        nq, d = q.shape
        n_p = pts.shape[0]
        nv = int((valid > 0).sum())
        return nq * d * 4 + n_p * 4 + nv * d * 4 + nq * n_p * 4, nq * nv * 3 * d
    raise KeyError(name)


def bitwise_equal(a, b, torch) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """Largest |a - b|; equal entries (equal infinities, NaN against NaN)
    count 0."""
    if not a.numel():
        return 0.0
    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())
    return float((a - b).abs().masked_fill(same, 0.0).max())


def time_ms(fn, reps, torch) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_trace(body, torch):
    """The device events (kernels, copies, memsets) of one run of ``body``
    under ``torch.profiler``, the marks left out (see ``LEAD_MARKS``); it
    raises after ``TRACE_TRIES`` traces that lost a mark at either end."""
    from torch.profiler import ProfilerActivity, profile

    mark = torch.empty(1, dtype=torch.uint8, device="cuda")
    for t in range(TRACE_TRIES):
        lead = LEAD_MARKS << t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                mark.fill_(1)
            body()
            mark.fill_(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events and MARK_NAME in events[0].name and MARK_NAME in events[-1].name:
            return [e for e in events if MARK_NAME not in e.name]
        log(f"device_trace: a trace lost its first {lead} marks or its last one")
    raise RuntimeError(f"device_trace: {TRACE_TRIES} traces lost a mark at one end")


def device_ms(fn, reps, torch, flush=None):
    """Device time of one call: the summed durations of the device events
    (kernels, memsets) of ``reps`` calls under ``torch.profiler``, over
    ``reps``.  Unlike :func:`time_ms` it leaves out the host's launch gaps,
    which are most of a back-to-back loop of small launches.  ``flush``,
    where given, runs before every call; the sum then takes only the
    events named as in a trace of the calls alone.  A trace (see
    :func:`device_trace`) whose events do not come ``reps`` times each is
    taken again, up to ``TRACE_TRIES`` times, and then it raises, naming
    the odd events."""
    from collections import Counter

    def trace(cold):
        def body():
            for _ in range(reps):
                if cold:
                    flush()
                fn()
        return device_trace(body, torch)

    def odd(events):
        """The event names that do not come ``reps`` times, with counts."""
        n = Counter(e.name for e in events)
        return {name[:60]: c for name, c in n.items() if c != reps} if n else {"none": 0}

    fn()
    torch.cuda.synchronize()
    bad = None
    for _ in range(TRACE_TRIES):
        own = trace(False)
        bad = odd(own)
        if bad:
            continue
        if flush is not None:
            names = {e.name for e in own}
            own = [e for e in trace(True) if e.name in names]
            bad = odd(own) or {n[:60]: 0 for n in names - {e.name for e in own}}
            if bad:
                continue
        return sum(e.time_range.end - e.time_range.start for e in own) / reps / 1e3
    raise RuntimeError(f"device_ms: no whole trace of {reps} calls in {TRACE_TRIES} "
                       f"tries; the last one's odd events: {bad}")


def l2_flush(torch):
    """A callable that overwrites a buffer larger than the card's L2."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def kernel_phase(calls, torch, timed, reps: int = 20) -> dict:
    """Hold each recorded call's kernel bit for bit against its plain
    version; ``timed`` (True, or the names to time) adds CUDA-event times
    of kernel and plain version, the bound, the library call and the
    kernel's device time under the profiler (with a cold L2 for the
    kernels of ``COLD_L2``)."""
    from repro_torch.kernels import knn_topk, partition_assign, ref, window_filter

    kernel = {"box_hits": window_filter.box_hits,
              "pair_window_ids": window_filter.pair_window_ids,
              "leaf_mindist": knn_topk.leaf_mindist,
              "pair_dist2": knn_topk.pair_dist2,
              "partition_assign": partition_assign.partition_assign,
              "window_count_gathered": window_filter.window_count_gathered,
              "pairwise_dist2": knn_topk.pairwise_dist2,
              "gathered_dist2": knn_topk.gathered_dist2,
              "window_mask_gathered": window_filter.window_mask_gathered,
              "window_count_tiles": window_filter.window_count_tiles}
    plain = {"box_hits": ref.box_hits_tiled_ref,
             "pair_window_ids": ref.pair_window_ids_ref,
             "leaf_mindist": ref.leaf_mindist_ref,
             "pair_dist2": ref.pair_dist2_ref,
             "partition_assign": ref.partition_assign_ref,
             "window_count_gathered": ref.window_count_gathered_ref,
             "pairwise_dist2": ref.pairwise_dist2_ref,
             "gathered_dist2": ref.gathered_dist2_ref,
             "window_mask_gathered": ref.window_mask_gathered_ref,
             "window_count_tiles": ref.window_count_ref}
    # the nearest single PyTorch call, timed beside the kernel and used
    # nowhere in the port: given a call's arguments, the call to time.
    # pairwise_dist2's is unsquared and unmasked; the per-query distances
    # of gathered_dist2 and pair_dist2 are one batched cdist (direct sums,
    # squared, unmasked), pair_dist2's on its pairs' gathered queries and
    # leaf blocks (the gather not timed)
    def cdist2(q, pts):
        return lambda: torch.cdist(
            q[:, None], pts, compute_mode="donot_use_mm_for_euclid_dist").square_()

    library = {
        "pairwise_dist2": lambda q, p, valid: lambda: torch.cdist(q, p),
        "gathered_dist2": lambda q, pts, valid: cdist2(q, pts),
        "pair_dist2": lambda q, pts, cnt, qi, li: cdist2(q[qi.long()], pts[li.long()]),
    }
    flush = l2_flush(torch) if timed else None
    res = {}
    for (name, bdtype), (args, kw, _) in sorted(calls.items()):
        got = kernel[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got_t, want_t))
        if not all(bitwise_equal(g, w, torch) for g, w in zip(got_t, want_t)):
            raise AssertionError(f"{name} ({bdtype}) differs from its plain version: "
                                 f"max abs err {err}")
        rec = {"shapes": [None if a is None else list(a.shape) for a in args],
               "max_abs_err": err, **kw}
        if timed is True or (timed and name in timed):
            b, ops = byte_and_op_counts(name, args, kw, got_t, torch)
            bytes_ms = b / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            rec.update(
                ms=time_ms(lambda: kernel[name](*args, **kw), reps, torch),
                plain_ms=time_ms(lambda: plain[name](*args, **kw), max(reps // 4, 3),
                                 torch),
                bytes=b, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=(time_ms(library[name](*args), reps, torch)
                            if name in library else None),
            )
            rec["device_ms"] = device_ms(lambda: kernel[name](*args, **kw), reps, torch,
                                         flush=flush if name in COLD_L2 else None)
            rec["cold_l2"] = name in COLD_L2
        res[(name, bdtype)] = rec
        log(f"kernel {name} ({bdtype}): bitwise equal to plain; {rec}")
    return res


# --------------------------------------------------------------------------
# phase 8: the dense LM served on the card
# --------------------------------------------------------------------------
LM_ARCH = "qwen3-0.6b"
LM_LOCAL_ARCH = "gemma3-27b"    # cut to one superblock and two remainder layers
# float32 logits are of unit scale; prefill + decode against one full
# forward differ by the order of float32 sums (tests/test_decode.py's
# decode tolerance)
LM_TOL = 2e-3
SERVING_RUNS = 2   # timed generations of each model; the last is the one reported


def lm_inputs(cfg, batch, torch, rng, device, n_extra=256):
    """The stub inputs a config needs beside its tokens: ``frames`` of
    ``n_extra`` positions for an encoder-decoder, ``patch_embeds`` of
    ``n_extra`` patches for the VLM (normal draws, on the card, in the
    config's dtype), and the number of patch positions."""
    extra = {}
    if cfg.encoder_layers:
        extra["frames"] = rng.normal(0, 1, (batch, n_extra, cfg.d_model))
    if cfg.frontend == "patch_stub":
        extra["patch_embeds"] = rng.normal(0, 1, (batch, n_extra, cfg.d_model))
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float64": torch.float64}[cfg.dtype]
    extra = {k: torch.from_numpy(v).to(device=device, dtype=dtype) for k, v in extra.items()}
    return extra, (n_extra if cfg.frontend == "patch_stub" else 0)


def greedy(lm, prompt, n_new, extra, n_patch, torch):
    """Greedy decoding of ``n_new`` tokens: ``LMServer.generate`` for the
    token-only families, and for those that take frames or patches
    (``extra``) the same loop through ``LM.prefill``/``decode_step``.
    Returns ``(B, n_new)`` token ids."""
    from repro_torch.serve import LMServer

    if not extra:
        return LMServer(lm).generate(prompt, n_new)
    b, s = prompt.shape
    lg, cache = lm.prefill(prompt, n_patch + s + n_new, **extra)
    out = [lg[:, -1].argmax(dim=-1)]
    for t in range(n_new - 1):
        pos = torch.full((b,), n_patch + s + t, dtype=torch.int64, device=lm.device)
        lg, cache = lm.decode_step(out[-1][:, None], cache, pos)
        out.append(lg[:, 0].argmax(dim=-1))
    return torch.stack(out, dim=1).cpu().numpy()


def prefill_decode(lm, toks, prompt_len, extra, n_patch, torch):
    """The logits of a prefill over ``toks[:, :prompt_len]`` (after
    ``n_patch`` patches, or beside an encoder's frames: ``extra``) and of
    one decode step for each later token: ``(B, S - prompt_len + 1, V)``,
    the positions ``prompt_len - 1`` onwards."""
    b, s = toks.shape
    last, cache = lm.prefill(toks[:, :prompt_len], cache_len=n_patch + s, **extra)
    out = [last[:, -1]]
    for t in range(prompt_len, s):
        lg, cache = lm.decode_step(toks[:, t:t + 1], cache,
                                   torch.full((b,), n_patch + t, device=toks.device))
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def lm_checks(tag, lm, prompt_len, n_decode, n_new, torch, rng, extra=None, n_patch=0):
    """Checks of one model in its dtype: prefill of a 2 x ``prompt_len``
    prompt (after ``n_patch`` patches, or beside an encoder's frames:
    ``extra``) and ``n_decode`` decode steps against one full forward
    over the ``prompt_len + n_decode`` tokens, within ``LM_TOL``, and
    greedy generation of ``n_new`` tokens (:func:`greedy`; none if 0)
    against the argmax of one full forward over the prompt and the
    generated tokens (teacher forcing; a position may differ only where
    that forward's top two logits are within ``LM_TOL``)."""
    cfg = lm.cfg
    extra = extra or {}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt_len + n_decode))).to(
        lm.device)
    full = lm(toks, **extra)[:, n_patch + prompt_len - 1:]
    got = prefill_decode(lm, toks, prompt_len, extra, n_patch, torch)
    errs = (got - full).abs().amax(dim=(0, 2)).tolist()
    del full, got
    out = {"tol": LM_TOL, "prefill_decode_max_abs_err": max(errs), "errs": errs}
    if not max(errs) <= LM_TOL:
        raise AssertionError(f"[{tag}] prefill + decode differ from the full forward by "
                             f"{max(errs)} > {LM_TOL} ({out})")
    if not n_new:
        log(f"[{tag}] {cfg.dtype}: prefill {prompt_len} + {n_decode} decode steps against "
            f"one full forward: max abs err {max(errs):.3e}")
        return out
    prompt = toks[:, :prompt_len].cpu().numpy()
    gen = greedy(lm, prompt, n_new, extra, n_patch, torch)
    seq = torch.from_numpy(np.concatenate([prompt, gen], axis=1)).to(lm.device)
    forced = lm(seq[:, :-1], **extra)[:, n_patch + prompt_len - 1:]
    want = forced.argmax(dim=-1).cpu().numpy()
    near = 0
    for b, i in zip(*np.nonzero(gen != want)):
        gap = float(forced[b, i, want[b, i]] - forced[b, i, gen[b, i]])
        if gap > LM_TOL:
            raise AssertionError(f"[{tag}] generate's token {i} of row {b} is {gen[b, i]}, "
                                 f"the full forward's argmax {want[b, i]} ({gap} higher)")
        near += 1
    out.update(generated=gen.tolist(), near_ties=near)
    log(f"[{tag}] {cfg.dtype}: prefill {prompt_len} + {n_decode} decode steps against one "
        f"full forward: max abs err {max(errs):.3e}; generate of {n_new} tokens equals "
        f"teacher forcing ({near} near ties)")
    return out


def lm_path(tag, torch, smi, device="cuda", profile=False):
    """Phase 8: the dense LM at qwen3-0.6b's full width (28 layers, d 1024,
    16/8 heads of 128, d_ff 3072, vocab 151,936, tied), initialised from a
    seeded ``torch.Generator`` on the card.  Float32 checks
    (:func:`lm_checks`: a 2 x 120 prompt with 8 decode steps, 2 x 128 ->
    16 new tokens), then a timed ``generate`` in bfloat16 (batch 4, prompt
    512, 64 new tokens; the second of two runs): prefill ms, median decode
    ms per step, tokens per second and the peak allocation.  Then the f32
    checks on a gemma3-style config at d_model 1024 (local_per_global 5,
    window 1024, 8 layers: one superblock and two remainder local layers)
    with a 512-token prompt, shorter than the window (ROADMAP C.8).
    ``profile`` adds a trace of one bf16 prefill and one decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    rng = np.random.default_rng(21)
    cfg = get_config(LM_ARCH)
    out = {"arch": LM_ARCH, "nvidia_smi": smi}
    f32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    lm = LM(f32, device=device, generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in lm.parameters())
    out["f32"] = lm_checks(tag, lm, 120, 8, 16, torch, rng)
    del lm
    torch.cuda.empty_cache()

    lm = LM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    batch, prompt_len, n_new = 4, 512, 64
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len))
    gen, runs = timed_serving(lm, prompt, n_new, {}, 0, torch)
    if gen.shape != (batch, n_new) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"[{tag}] bf16 generate gave {gen.shape} tokens out of range")
    out["bf16_generate"] = {"batch": batch, "prompt": prompt_len, "new": n_new,
                            "runs": runs}
    if profile:
        _, cache = lm.prefill(prompt, prompt_len + 1)
        last = torch.from_numpy(gen[:, :1]).to(lm.device)
        pos = torch.full((batch,), prompt_len, device=lm.device)
        out["profile"] = profile_batches({
            "prefill": lambda: lm.prefill(prompt, prompt_len + 1),
            "decode_step": lambda: lm.decode_step(last, cache, pos)}, torch)
        log(f"[{tag}] profile: {out['profile']}")
    log(f"[{tag}] {LM_ARCH} bf16 generate {batch} x {prompt_len} -> {n_new}: {runs}")
    del lm
    torch.cuda.empty_cache()

    local = dataclasses.replace(
        get_config(LM_LOCAL_ARCH), name="gemma3-style-1024", n_layers=8, d_model=1024,
        n_heads=8, n_kv_heads=4, d_ff=4096, dtype="float32")
    lm = LM(local, device=device, generator=torch.Generator(device=device).manual_seed(1))
    kinds = [layer.kind for layer in lm.layers]
    if kinds != ["local"] * 5 + ["global"] + ["local"] * 2:
        raise AssertionError(f"[{tag}] local config's layers are {kinds}")
    out["local"] = {"config": {"n_layers": local.n_layers, "d_model": local.d_model,
                               "local_window": local.local_window, "kinds": kinds,
                               "vocab": local.vocab},
                    **lm_checks(f"{tag} local", lm, 512, 8, 16, torch, rng)}
    del lm
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 9: the LM's other families served on the card
# --------------------------------------------------------------------------
# (config, layers on the card (None: all), float32 checks: prompt, decode
# steps, new tokens, frames or patches; bfloat16 run: batch, prompt, new
# tokens, frames or patches).  Widths are the published ones; depth is cut
# where the weights do not fit one card: jamba to one superblock (8 layers:
# 1 attention, 7 Mamba, 4 MoE FFNs of 16 experts), qwen3-moe to 2 layers
# of 128 experts, arctic to 1 layer (128 experts, dense residual; its
# float32 weights would be 56 GB, so it has no float32 check).
FAMILIES = (
    ("rwkv6-3b", None, (120, 8, 16, 0), (4, 512, 32, 0)),
    ("jamba-v0.1-52b", 8, (120, 8, 16, 0), (4, 512, 32, 0)),
    ("qwen3-moe-235b-a22b", 2, (120, 8, 16, 0), (4, 512, 32, 0)),
    ("arctic-480b", 1, None, (4, 512, 32, 0)),
    ("seamless-m4t-medium", None, (56, 8, 16, 256), (4, 64, 32, 512)),
    ("internvl2-2b", None, (120, 8, 16, 256), (4, 256, 32, 256)),
)
RWKV_LONG_PROMPT = 500       # no multiple of la_chunk = 64 (ROADMAP C.9)
# A random 32-layer RWKV6 amplifies rounding: its float32 prefill + decode
# and its float32 full forward differ by more than LM_TOL, and no float32
# order of sums holds LM_TOL there.  So its checks run on the same weights
# in float64 (the same path; every float32 internal widens), at LM_TOL, and
# the float32 model is held to that float64 witness at WITNESS_TOL, which
# a bfloat16 run of the same weights must exceed.  On an H100 the float32
# model came within 6.7e-2 and the bfloat16 one 5.3 away (PERF.md, PR 22).
F64_CHECKS = ("rwkv6-3b",)
WITNESS_TOL = 0.15
GATE_GAP = 1e-6              # experts compared where the k-th and next gate differ more


def check_capacity(cfg):
    """The capacity factor of the checks: ``E / top_k``, at least
    test_decode.py's 8, gives every expert a slot for every token of a
    chunk, so no assignment can drop (a drop makes a prefill differ from a
    full forward by design).  At 8, qwen3-moe's 128 experts of top 8 give
    an expert slots for half the tokens, and its random router sent more
    than half of a 256-token forward to one expert (34 assignments of
    layer 1 dropped on an H100)."""
    return max(8.0, cfg.n_experts / cfg.moe_top_k) if cfg.n_experts else cfg.capacity_factor


def moe_layers(lm):
    return [(li, layer.ffn) for li, layer in enumerate(lm.layers) if layer.ffn_kind == "moe"]


def routing_check(tag, moe, xf, torch):
    """The float32 router's top-k on the card against a float64
    recomputation of the same gates on the card: the chosen experts (as
    sets) must be equal wherever the k-th and (k+1)-th float64 gates
    differ by more than ``GATE_GAP``."""
    from repro_torch.kernels.ref import top_k

    k = moe.cfg.moe_top_k
    _, e32 = moe.route(xf)
    g64 = torch.softmax(xf.double() @ moe.router.double(), dim=-1)
    v64, e64 = top_k(g64, min(k + 1, g64.shape[1]))
    clear = ((v64[:, k - 1] - v64[:, k]) > GATE_GAP if k < g64.shape[1]
             else torch.ones_like(v64[:, 0], dtype=torch.bool))
    same = (e32.sort(dim=-1).values == e64[:, :k].sort(dim=-1).values).all(dim=-1)
    bad = int((clear & ~same).sum())
    out = {"tokens": xf.shape[0], "clear": int(clear.sum()), "differ_where_clear": bad,
           "differ_anywhere": int((~same).sum()),
           "order_equal": int((e32 == e64[:, :k]).all(dim=-1).sum())}
    if bad:
        raise AssertionError(f"[{tag}] {bad} tokens route to other experts than float64's "
                             f"where the gates are {GATE_GAP} apart: {out}")
    log(f"[{tag}] routing on the card against float64: {out}")
    return out


def capture_moe_input(moe):
    """Keep the first input a MoE layer sees, as ``(T, D)`` rows."""
    seen = []

    def hook(_mod, args):
        if not seen:
            seen.append(args[0].reshape(-1, args[0].shape[-1]).clone())
    return seen, moe.register_forward_pre_hook(hook)


def timed_serving(lm, prompt, n_new, extra, n_patch, torch):
    """:func:`greedy` run ``SERVING_RUNS`` times, prefill and each decode
    step timed with CUDA events: per run,
    the prefill ms, the median and largest decode ms per step, tokens per
    second over the host wall and the peak allocation."""
    import statistics

    events = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*a, **kw)
            end.record()
            events[name].append((start, end))
            return res
        return call

    lm.prefill, lm.decode_step = timed("prefill", lm.prefill), timed("decode", lm.decode_step)
    out = []
    try:
        for _ in range(SERVING_RUNS):
            for v in events.values():
                v.clear()
            for _, moe in moe_layers(lm):
                moe.dropped.zero_()
            torch.cuda.reset_peak_memory_stats()
            start_bytes = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = greedy(lm, prompt, n_new, extra, n_patch, torch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            decode_ms = [a.elapsed_time(b) for a, b in events["decode"]]
            out.append({
                "wall_s": wall,
                "prefill_ms": events["prefill"][0][0].elapsed_time(events["prefill"][0][1]),
                "decode_ms_median": statistics.median(decode_ms),
                "decode_ms_max": max(decode_ms), "decode_steps": len(decode_ms),
                "tokens_per_s": prompt.shape[0] * n_new / wall,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "allocated_at_start": start_bytes,
                "dropped_per_moe_layer": {li: int(moe.dropped) for li, moe in moe_layers(lm)}})
    finally:
        del lm.prefill, lm.decode_step    # the methods again (no cycle through lm)
    return gen, out


def families_path(tag, torch, smi, device="cuda", profile=False):
    """Phase 9: the LM's other families (RWKV6, the Mamba hybrid, the two
    MoE configs, the encoder-decoder and the VLM) at their published
    widths, depths as ``FAMILIES`` cuts them, weights drawn from a seeded
    ``torch.Generator`` on the card, one config after another
    (:func:`family_run`; every tensor of one is freed before the next)."""
    import gc

    rng = np.random.default_rng(22)
    out = {"nvidia_smi": smi}
    gc.collect()               # earlier phases' models, held by reference cycles
    torch.cuda.empty_cache()
    for seed, (arch, layers, checks, run) in enumerate(FAMILIES):
        out[arch] = family_run(f"{tag} {arch}", arch, layers, checks, run, seed, rng, torch,
                               device, profile)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def witness_check(tag, lm, toks, want, prompt_len, torch, control=False):
    """Prefill + decode of ``lm`` over ``toks`` (:func:`prefill_decode`)
    against ``want``, a float64 full forward's logits at the same
    positions: within ``WITNESS_TOL``, or for a ``control`` (bfloat16)
    beyond it."""
    got = prefill_decode(lm, toks, prompt_len, {}, 0, torch)
    err = float((got.double() - want).abs().max())
    out = {"prompt": prompt_len, "decode_steps": toks.shape[1] - prompt_len,
           "max_abs_err": err, "tol": WITNESS_TOL}
    if control != (not err <= WITNESS_TOL):
        raise AssertionError(f"[{tag}] {lm.cfg.dtype} prefill + decode against the float64 "
                             f"forward: {out} ({'control ' if control else ''}limit "
                             f"{WITNESS_TOL})")
    log(f"[{tag}] {lm.cfg.dtype} prefill {prompt_len} + {out['decode_steps']} decode steps "
        f"against the float64 forward: max abs err {err:.3e} "
        f"({'above' if control else 'within'} {WITNESS_TOL})")
    return out


def family_run(name, arch, layers, checks, run, seed, rng, torch, device, profile):
    """One config of phase 9: checks in float32 (:func:`lm_checks`;
    :func:`check_capacity`, so that no assignment drops, which is asserted),
    in float64 for ``F64_CHECKS`` (also a 2 x 500 prompt, no multiple of
    the chunk) with the float32 and bfloat16 models held to that witness
    (:func:`witness_check`), the float32 router against float64 for the
    MoE configs (:func:`routing_check`; arctic's on its bf16 model), then
    the shipped config in bfloat16, timed (:func:`timed_serving`), with
    the dropped assignments per MoE layer.  ``profile`` adds a trace of
    one bf16 decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rec = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "kinds": [f"{k}/{f}" for k, f in
                     ((cfg.layer_kinds()[i % cfg.superblock], cfg.ffn_kinds()[i % cfg.superblock])
                      for i in range(cfg.n_layers))]}
    witness = []
    if checks is not None:
        dtype = "float64" if arch in F64_CHECKS else "float32"
        chk = dataclasses.replace(cfg, dtype=dtype, capacity_factor=check_capacity(cfg))
        torch.cuda.reset_peak_memory_stats()
        lm = LM(chk, device=device, generator=torch.Generator(device=device).manual_seed(seed))
        rec["params"] = sum(p.numel() for p in lm.parameters())
        prompt_len, n_decode, n_new, n_extra = checks
        extra, n_patch = lm_inputs(chk, 2, torch, rng, device, n_extra)
        moes = moe_layers(lm)
        if moes:
            seen, hook = capture_moe_input(moes[0][1])
        rec["checks"] = {"dtype": dtype, **lm_checks(f"{name} {dtype}", lm, prompt_len,
                                                      n_decode, n_new, torch, rng, extra=extra,
                                                      n_patch=n_patch)}
        if moes:
            hook.remove()
            rec["checks"]["dropped"] = {li: int(m.dropped) for li, m in moes}
            if any(rec["checks"]["dropped"].values()):
                raise AssertionError(f"[{name}] the f32 checks dropped assignments: "
                                     f"{rec['checks']['dropped']}")
            rec["routing"] = routing_check(name, moes[0][1], seen[0], torch)
        if dtype == "float64":
            rec["checks_long"] = lm_checks(f"{name} {dtype} long", lm, RWKV_LONG_PROMPT, 8, 0,
                                           torch, rng)
            for plen in (prompt_len, RWKV_LONG_PROMPT):
                toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, plen + n_decode))).to(
                    lm.device)
                witness.append((toks, lm(toks)[:, plen - 1:].clone(), plen))
        rec["checks_peak_bytes"] = torch.cuda.max_memory_allocated()
        del lm, extra, moes
        torch.cuda.empty_cache()
        if witness:
            lm = LM(dataclasses.replace(cfg, dtype="float32"), device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
            rec["f32_witness"] = [witness_check(name, lm, toks, want, plen, torch)
                                  for toks, want, plen in witness]
            del lm
            torch.cuda.empty_cache()
    batch, prompt_len, n_new, n_extra = run
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    rec["bf16_init_s"] = time.perf_counter() - t0
    rec["bf16_init_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["bf16_params"] = sum(p.numel() for p in lm.parameters())
    rec["bf16_weight_bytes"] = sum(p.numel() * p.element_size() for p in lm.parameters())
    if witness:
        rec["bf16_control"] = [witness_check(name, lm, toks, want, plen, torch, control=True)
                               for toks, want, plen in witness]
        del witness
    extra, n_patch = lm_inputs(cfg, batch, torch, rng, device, n_extra)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len))
    moes = moe_layers(lm)
    if moes and checks is None:
        seen, hook = capture_moe_input(moes[0][1])
    gen, runs = timed_serving(lm, prompt, n_new, extra, n_patch, torch)
    if moes and checks is None:
        hook.remove()
        rec["routing"] = routing_check(name, moes[0][1], seen[0], torch)
    if gen.shape != (batch, n_new) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"[{name}] bf16 generation gave {gen.shape} tokens out of range")
    rec["bf16"] = {"batch": batch, "prompt": prompt_len, "new": n_new,
                   "frames_or_patches": n_extra, "runs": runs}
    if profile:
        _, cache = lm.prefill(prompt, n_patch + prompt_len + 1, **extra)
        last = torch.from_numpy(gen[:, :1]).to(lm.device)
        pos = torch.full((batch,), n_patch + prompt_len, device=lm.device)
        rec["profile"] = profile_batches(
            {"decode_step": lambda: lm.decode_step(last, cache, pos)}, torch)
    log(f"[{name}] {rec['bf16_params']:,} bf16 parameters "
        f"({rec['bf16_weight_bytes'] / 1e9:.2f} GB; init peak "
        f"{rec['bf16_init_peak_bytes'] / 1e9:.2f} GB); {batch} x {prompt_len} -> {n_new}: "
        f"{runs[-1]}" + (f"; decode step profile {rec['profile']}" if profile else ""))
    return rec


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every measurement here as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one batch of each kind with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch as rt
    from repro_torch.core.datasets import nycyt_like, osm_like
    from repro_torch.kernels import build, launches

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    built = build.build_all()
    build_s = next(iter(built.values()))["seconds"]
    log(f"build: {build_s:.2f} s for {len(built)} sources in parallel")
    for name, rec in built.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    results = {"device": kind, "count": count, "nvidia_smi": smi, "build_s": build_s}
    pts = osm_like(10_000_000, seed=7)
    results["d2"], calls2, inputs = main_path("d=2", pts, 11, 1024, 1024, 16, torch,
                                              rt, launches, profile=args.profile)
    results["serving_d2"], scalls2 = serving_path("serving d=2", pts, inputs,
                                         results["d2"]["buffer_pages"],
                                         results["d2"]["leaves"], 16, torch, rt, launches,
                                         profile=args.profile)
    results["stream_d2"], stcalls2 = streaming_path("stream d=2", pts, inputs,
                                                    results["d2"]["buffer_pages"], 16, torch,
                                                    rt, launches, smi=smi,
                                                    profile=args.profile)
    results["sharded_d2"], shcalls2 = sharded_path("sharded d=2", pts, inputs,
                                                   results["d2"]["buffer_pages"], 16, torch,
                                                   rt, launches, smi=smi,
                                                   profile=args.profile)
    log(f"insert rate: {results['sharded_d2']['streaming']['points_per_s']:.1f} points/s "
        f"sharded (phase 3h), {results['stream_d2']['points_per_s']:.1f} on one device "
        f"(phase 3s)")
    results["collective_d2"], ccalls2 = collective_path("collective d=2", pts, inputs, 16,
                                                        torch, rt, launches)
    results["unfused_d2"], ucalls2 = unfused_path("d=2", inputs, 16, torch, rt, launches,
                                                  profile=args.profile)
    results["window_count_d2"], wcalls2 = window_count_path("d=2", pts, inputs, torch,
                                                            launches)
    results["retrieval_d2"], rcalls2 = retrieval_path("retrieval d=2", pts, inputs, 15,
                                                      16, torch, rt, launches,
                                                      profile=args.profile, nan_rows=10)
    del pts, inputs
    results["competitors_d2"], cmcalls2 = competitors_path("competitors d=2", COMPETITOR_N,
                                                          16, torch, rt, launches,
                                                          profile=args.profile)
    pts5 = nycyt_like(2_000_000)
    results["d5"], calls5, inputs = main_path("d=5", pts5, 11, 1024, 1024, 16, torch,
                                              rt, launches, half_width=0.05,
                                              at_points=True, profile=args.profile)
    results["unfused_d5"], ucalls5 = unfused_path("d=5", inputs, 16, torch, rt, launches,
                                                  profile=args.profile)
    results["window_count_d5"], wcalls5 = window_count_path("d=5", pts5, inputs, torch,
                                                            launches)
    results["retrieval_d5"], rcalls5 = retrieval_path("retrieval d=5", pts5, inputs, 13,
                                                      16, torch, rt, launches,
                                                      profile=args.profile)
    del pts5, inputs

    k2 = kernel_phase({**calls2, **ucalls2, **wcalls2, **rcalls2}, torch, timed=True)
    k5 = kernel_phase({**calls5, **ucalls5, **wcalls5, **rcalls5}, torch, timed=TIMED_D5)
    # phase 3a's, 3s's, 3h's, 3c's and 3b's calls (64-query microbatches,
    # the partial export, the streaming mirror's export, the shards' ragged
    # batches, rank 0's calls in phase 3c, the competitor trees' overlapping
    # and unpacked leaves), held bit for bit but not timed
    ks = kernel_phase({**scalls2, **stcalls2, **shcalls2, **ccalls2, **cmcalls2}, torch,
                      timed=False)
    # the recorded calls hold the earlier phases' tensors on the card
    del calls2, scalls2, stcalls2, shcalls2, ccalls2, ucalls2, wcalls2, rcalls2, cmcalls2
    del calls5, ucalls5, wcalls5, rcalls5
    results["lm"] = lm_path("lm", torch, smi, profile=args.profile)
    results["lm_families"] = families_path("families", torch, smi, profile=args.profile)

    line = []
    for name, (source, replaces) in REPLACES.items():
        f32 = k2[(name, "float32")]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results[PHASE[name]]["launches"][name],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "device_ms": f32["device_ms"],
        }
        timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        for label, rec in (("bf16", k2.get((name, "bfloat16"))),
                           ("smallest", k2.get((name, "float32:smallest"))),
                           ("d5", k5.get((name, "float32")) if name in TIMED_D5 else None)):
            if rec is not None:
                entry[label] = {key: rec[key] for key in
                                ("shapes", *timing, "device_ms") if key in rec}
        line.append(entry)
    results["kernels"] = line
    results["kernel_detail"] = {f"{n}[{b}]": v for (n, b), v in {**k2, **ks}.items()}
    results["kernel_detail_d5"] = {f"{n}[{b}]": v for (n, b), v in k5.items()}
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(results, indent=1, default=str))
    log(f"total {results['total_s']:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
