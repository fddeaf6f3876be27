#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mtscomp_tpu_torch``) on one GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU,
``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

a. print the card's name and power limit (``nvidia-smi``);
b. build the port's CUDA kernels from ``mtscomp_tpu_torch/csrc`` (ptxas
   registers and spills of every entry, and each kernel's dynamic shared
   memory a block) and its C++ host runtime from
   ``mtscomp_tpu_torch/native``;
d. make seeded Neuropixels-like recordings (30 kHz, 1-s chunks; the
   sources side by side on threads) and compress them with the port's
   own host codec (``device='none'``, ans v2):
   - the fuse8 path: random walks with diff std 6, 32 s x 385 int16
     channels, 8 s x 384 channels and 8 s x 385 uint16 channels;
   - the generic path: 32 s x 385 int16 channels of the same walk with
     spikes (a -60, -90, +150 step over 3 samples, 5 per channel per
     second), which code both byte planes;
   - the branches, 2 s each at 385 channels: second-order time diff on
     the fuse8 route (an LFP-like band) and the generic route, C order
     (plane tables), spatial diff, flags bit6 without the tail packing,
     uint8, int8, int32, bitcast float32 under a second-order diff, a
     RAW low plane, tables from another writer needing one and two
     fixups, and C order under segment tables; and 8 s each, a file
     whose plane modes change after 4 s (walk, then spikes), one whose
     last second is spiky (a mode sub-batch of one chunk), and drifting
     files compressed with adaptive windows of 4 and of 3 chunks (walk,
     then a slow oscillation);
   - the layouts the port fuses and the JAX package does not
     (``FUSE8_GEOMETRIES``), 2 s each: chunks of 16,769 samples (a step
     count with no divisor in 8..128, tp = T - 1), another writer's
     segments of 5 channels, and 1025 channels (a bit6 tail behind 8
     full groups);
   - the 8-byte items the JAX package leaves to its host codec
     (``WIDE``), 2 s each at 385 channels, values past 2**32: int64 (the
     spiky walk x 1001 around 3 * 2**40), float64 under a second-order
     diff (the walk x 1.5, bitcast), C-order uint64 around 2**63, and an
     int64 file one sample longer than its chunk (a last chunk of one
     sample, stored without a head);
c. hold every kernel form against its plain PyTorch twin on the card,
   at the shapes the decode of those files gives it (byte equality;
   ``FUSE8_GEOMETRIES`` included), K1's tables built on the card
   (``decode_tables``) also against the host packer's rows,
   K6 on the encode's B=8 batches of both 32-s files; hold K4's plane
   form against its twin and against the plane combine + element form
   (or the finalize) on batches with two coded planes, a CONST and a RAW
   plane; run every form of K4 and K5 (int64 included) on the scan edge
   shapes
   (``SCAN_EDGE_CASES``: lengths around the time segments, channel
   counts around the tiles, strided and misaligned inputs, short and
   head-extended outputs) and the finalize, K2 and K3, on its own
   (``FINALIZE_EDGE_CASES``: tails of 1, 7 and 33 channels behind bulk
   blocks that end off the warps and tiles, padded and unpadded rows,
   either block off the 16-byte grid, extra rows, short and
   head-extended outputs) against their twins; run K1's three
   forms and K6 on the edge cases (``EDGE_CASES`` x ``REGION_ENDS``:
   1 step and K6's window counts around 16, steps reading close to 4096
   words, rows of count 0 and ragged counts, a word region ending at the
   stream's last word or off the 8-word grid) against their twins and
   the normative coder; stage the first and the last chunk of every
   file the window paths read alone (B=1, what a window stages) and
   decode it with every kernel call held against its twin at that shape
   (K1 octet, K2, K3, K4's plane and element forms, K5, int16 and
   int32); and decode the CPU tests' small geometries on the card;
e-g. decode path by path, with every launch count set to 0 just before
   and read just after: decode each file through
   ``mtscomp_tpu_torch.decompress(..., device='cuda')`` with
   ``.to_array()`` and ``.tofile()`` (and ``.to_tensor()`` for the two
   32-s files), check each byte for byte against its source, check
   that every kernel form of the path was launched (the path
   ``fuse8_geometries``: K1 octet, K2 and K3 and no generic form; the
   path ``wide``: K1, K4's int64 forms and K5's, and no scan narrower
   than 64 bits) and that no chunk went to the host codec;
h. drop one word, then half the words, of one group's stream and
   expect the word audit's IOError, on both routes;
w. random-access windows on the card, path by path (``WINDOW_PATHS``:
   the 385- and 384-channel walks, the spiky walk, and the C-order,
   spatial-diff, uint8, int32, float32, order-2 and adaptive-window
   branch files), counts set to 0 just before and read just after: open
   with ``device='cuda'`` and a cache of 4 chunks, read ``r[a:b]`` inside
   one chunk, across two and three, the first and last samples, a step
   of 3, one row ``r[i]`` and ``r[:]``, each byte for byte against the
   source; K1 launches once per chunk the cache did not hold (a model
   LRU runs beside the reader's), a second read of a window launches
   nothing, the cache evicts at its size, no chunk goes to the host
   codec; a group that lost a word, read through a window, raises the
   word audit's IOError;
m. ``decompress_multi`` of four probes (the four 8-s stretches of the
   32-s walk) as one merged batch, byte-exact; with a uint16 probe among
   them the per-reader fallback, byte-exact;
F3. ``to_array()`` of the 32-s walk as one batch and with
   ``batch_chunks=8`` (four batches, four K1 launches): the same bytes,
   the peak device memory of both;
s. sharded, on ``chunk_mesh()`` over every visible card (the width goes
   in the phase's line; a width-1 time is not a multi-GPU number),
   counts set to 0 just before each call and read just after:
   ``decompress_multi(mesh=)`` of phase m's four probes,
   ``DeviceBatchDecoder.decode_batch(mesh=)`` of a walk, a spiky and a
   384-channel batch, ``DeviceBatchEncoder.encode_batch(mesh=)`` of a
   spiky batch: byte-exact against the sources and the host codec, K1
   (K6) once a shard, each timed against its unsharded call;
k. encode path by path (the two 32-s files, then the branch files),
   counts set to 0 just before and read just after: compress each
   through ``mtscomp_tpu_torch.compress(..., device='cuda')``, check the
   ``.cbin`` and ``.ch`` are byte-identical to the host route's, that K6
   launched and that no chunk went to the host codec (the path
   ``encode_opened``: int32, bitcast float32, C order under segment
   tables, a mode sub-batch of one chunk, window runs of 2; the path
   ``encode_wide``: the 8-byte files, 8 byte planes, a chunk of one
   sample), and decode each device-encoded file through the port to its
   source;
p. the measured ``'auto'`` route: ``link_profile()`` and
   ``host_profile()`` measured afresh, the CPU count, and the first-call
   cost (a fresh child process's first device decode, kernels built);
   then ``'auto'``'s decision for ``compress()`` of the 32-s walk,
   ``to_array()`` of both 32-s files and their three ``WINDOWS``
   uncached, with the port's constants and again with the size gate
   open: every read and write byte-exact, K1 (K6) launched if and only
   if the decision said card; after phase i, each decision beside both
   routes' times of this run (a log line, not a check);
t. the tools on the card, each command through ``python -m
   mtscomp_tpu_torch.cli`` with ``--device cuda``, one after the other in
   one process of their own that reports after each what it has loaded
   (neither JAX nor the JAX package) and what the command launched, on
   the 8-s 384-channel file: ``mtscomp`` (K6, no chunk on the host
   codec) = the host route's bytes; ``mtsdecomp`` = the source,
   ``--samples`` through the chunk cache (three chunks, three K1
   launches); ``mtsverify`` decodes on the card (one batch: K1 and K2
   once) and passes, and reports a flipped byte with exit code 1;
   ``mtschop`` launches nothing; ``mtsrecompress`` ans -> zlib decodes on
   the card (K1, K2), zlib -> ans encodes there (K6) = the bytes of
   ``transcode(device='none')``, and verifies on the card; ``mtscomp
   --parts 2 --workers 2`` (``compress_multihost``, each worker on the
   card) and ``mtsmerge`` of its parts = the whole-file bytes, and
   ``compress_multihost(device='cuda')`` with its ranges in this process
   (K6 once a range); a
   ``StreamWriter`` stream that dies, is resumed and finished = the
   batch compress's bytes, tailed by a ``StreamReader`` on the card (K1
   once a chunk read);
u. the hardware storm (``mtscomp_tpu_torch.storm.main`` in this
   process, counts set to 0 just before and read just after): the JAX
   storm's full grid at its geometry (385 channels, chunks of 4,000
   samples, 2.5 chunks: every dtype with bitcast floats, the 8-byte ones
   through the int64 scans, plane and segment tables, aligned and
   non-aligned
   layouts, foreign two-fixup tables, C order, spatial diff, no time
   diff, order 2, the joint probe, the ragged-tail split, adaptive
   windows, K6's word region, a corrupted file) and 16 random cells of
   seed 0, each byte-exact against the source and the host codec with
   its seconds and launches by kernel form logged; every cell must
   pass (so the wide-dtype cells leave no chunk to the host codec and
   launch no scan narrower than 64 bits, and the corruption surfaces as
   IOError) and every form of ``STORM_FORMS`` launch;
v. the entry points of ``entry.py`` (counts set to 0 just before and read
   just after):
   ``entry()``'s decode step (K1, K5) on the card equal to the same step
   on the CPU twins, and ``dryrun_multichip(device_count())`` (K1, K6
   and K5 on every card, its self-checks) passing;
r. the BASELINE.json report (``mtscomp_tpu_torch.benchmarks.baseline_report``
   in this process, ``--seconds 8 --reps 3`` on the card: the six
   configs, staged decodes over bounded batches, windows on the host
   codec, the card and ``'auto'``, ``decompress_multi`` merged and with
   ``mesh=chunk_mesh()``) and the harness's device row
   (``mtscomp_perf(..., device=True)`` of 10 s of ``ap_385``, both
   algorithms), counts set to 0 just before each and read just after:
   every byte-exact cell of the report must hold, configs 2 and 4 give a
   staged rate, K1 launches in configs 2-4 and K6 in the device
   compress and in config 6's (float32) with no chunk on the host
   codec, and the phase takes under 120 s;
j. the headline bench (``python -m mtscomp_tpu_torch.bench`` in a child
   process, as a user runs it, with ``BENCH_ENV``: 8 s of the 385-channel
   walk and a global budget of ``BENCH_ENV['BENCH_BUDGET']`` seconds;
   each of its phases in a child of its own): it must exit 0 with every
   byte check held, a staged decode rate, the card's name and power
   limit, K1 octet and K3 (and nothing else) in its staged decode, K6 in
   its device encode and in its compress on the card with no chunk left
   to the host codec, and both ``tofile()`` routes timed; its launches
   by phase count as the path ``bench``;
i. time the staged decodes (the batch staged on the card once, CUDA
   events, median of repeats) and K1 alone on the whole-file batch
   (B=32, 128 groups), K6 and the device encode staged at B=8
   (checked against the host codec first), ``compress()`` of the 32-s
   files on both routes and by layer, each kernel form against its
   twin, its bound and, where one PyTorch call computes the same
   function, that call; the staged decode of each of
   ``FUSE8_GEOMETRIES`` on the fused route and on the generic route
   with the JAX package's routing forced back; the scans alone at B=2
   and B=32
   (``SCAN_SHAPES``), with K3 at B=32, and K2 over channel counts on
   and off the 32-byte sector grid (``FINALIZE_CHANNELS``); the staged
   decode of ONE chunk (B=1, what a window stages) with K1 and K3 or
   K4's plane form alone; windows of 1 s, 0.1 s and 30 samples, uncached
   and cached, on the device route and on the host codec
   (``device='none'``), host clock with a synchronize, median of 8;
   ``to_array()`` of the 32-s files on both routes in turns; and each of
   ``WIDE`` staged on the card and on the host codec, and its
   ``to_array()`` on both routes in turns.

The order of the run: a, b, d, c, e-h, w, m, F3, s, k, p, t, u, v, r, j, i.
Then come the host-clock seconds of each phase. The last five lines are
the bench's JSON line (``{"bench": ...}``), a JSON summary of the end-to-end and staged timings (with the
kernel forms no path launches, which are held
against their twins only), a JSON object with one entry per kernel
form that the paths launch (its launches in total and by path, its
time, its twin's, its bound and the library call's), the card's name
and power limit, and ``{"ok": true, "device": {"platform": "gpu",
...}}``. Without a CUDA GPU it exits with code 2 and prints no result.
"""

import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import mtscomp_tpu_torch as mt
import mtscomp_tpu_torch.codec.ans as ans_codec
from mtscomp_tpu_torch import bench, entry, native, storm
from mtscomp_tpu_torch.benchmarks import baseline_report, harness
from mtscomp_tpu_torch.models import rans
from mtscomp_tpu_torch.models.rans import GROUP_ROWS, LANES
from mtscomp_tpu_torch.ops import _build
from mtscomp_tpu_torch.ops import device_delta as dd
from mtscomp_tpu_torch.ops import rans_decode as rd
from mtscomp_tpu_torch.ops import rans_encode as renc
from mtscomp_tpu_torch.ops.tables import pack_device_tables
from mtscomp_tpu_torch.parallel import pipeline
from mtscomp_tpu_torch.parallel.distributed import compress_multihost
from mtscomp_tpu_torch.parallel.mesh import chunk_mesh
from mtscomp_tpu_torch.parallel.pipeline import (
    DeviceBatchDecoder, DeviceBatchEncoder, _decode_fuse8, _rans_planes,
    _read_payload, check_words_used, fuse8_planes, generic_elems,
    generic_planes)
from mtscomp_tpu_torch.utils import trace

SR = 30000                    # samples per second = samples per chunk
BATCH = 8                     # chunks per staged batch (the bench's)
SECONDS = 32                  # length of the two 385-channel main files
SHORT_SECONDS = 8             # length of the 384-ch and uint16 recordings
BRANCH_SECONDS = 2            # length of each branch file
REPS = 8                      # timed repeats per measurement
TWIN_REPS = 2                 # timed repeats of a twin (slow, launch bound)
DEVICE = 'cuda'
#: The H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bandwidth,
#: and the float32 rate outside the tensor cores, taken as the scalar
#: integer ALU's ceiling too (the card's int32 rate is at most that, so
#: the time bound stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

#: Kernel forms: name -> (launch counter of that form, source, TPU
#: kernel).
KERNELS = {
    'rans_decode_groups, octet (K1)': (
        'rans_decode_octet', 'mtscomp_tpu_torch/csrc/rans_decode.cu',
        'mtscomp_tpu/ops/pallas_rans.py:68'),
    'rans_decode_groups, coarse, one fixup (K1)': (
        'rans_decode_coarse_1fixup', 'mtscomp_tpu_torch/csrc/rans_decode.cu',
        'mtscomp_tpu/ops/pallas_rans.py:155'),
    'rans_decode_groups, coarse, two fixups (K1)': (
        'rans_decode_coarse_2fixups',
        'mtscomp_tpu_torch/csrc/rans_decode.cu',
        'mtscomp_tpu/ops/pallas_rans.py:163'),
    'finalize_u8, tail form (K3)': (
        'finalize_u8_tail', 'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:310'),
    'finalize_u8 (K2)': (
        'finalize_u8', 'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:238'),
    'scan_transposed int16, head-seeded (K4)': (
        'scan_transposed_i16_seeded',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed int16, inclusive (K4)': (
        'scan_transposed_i16_inclusive',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed int32, head-seeded (K4)': (
        'scan_transposed_i32_seeded',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed int32, inclusive (K4)': (
        'scan_transposed_i32_inclusive',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed int64, head-seeded (K4)': (
        'scan_transposed_i64_seeded',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed int64, inclusive (K4)': (
        'scan_transposed_i64_inclusive',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed planes int16, head-seeded (K4)': (
        'scan_planes_i16_seeded',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'scan_transposed planes int16, inclusive (K4)': (
        'scan_planes_i16_inclusive',
        'mtscomp_tpu_torch/csrc/scan_transposed.cu',
        'mtscomp_tpu/ops/device_delta.py:140'),
    'cumsum_time int16 (K5)': (
        'cumsum_time_i16', 'mtscomp_tpu_torch/csrc/cumsum_time.cu',
        'mtscomp_tpu/ops/device_delta.py:89'),
    'cumsum_time int32 (K5)': (
        'cumsum_time_i32', 'mtscomp_tpu_torch/csrc/cumsum_time.cu',
        'mtscomp_tpu/ops/device_delta.py:89'),
    'cumsum_time int64 (K5)': (
        'cumsum_time_i64', 'mtscomp_tpu_torch/csrc/cumsum_time.cu',
        'mtscomp_tpu/ops/device_delta.py:89'),
    'rans_encode_groups (K6)': (
        'rans_encode', 'mtscomp_tpu_torch/csrc/rans_encode.cu',
        'mtscomp_tpu/ops/pallas_rans_enc.py:86'),
    'decode_tables (K1\'s tables)': (
        'decode_tables', 'mtscomp_tpu_torch/csrc/decode_tables.cu',
        'none: the JAX package packs them on the host '
        '(mtscomp_tpu/ops/pallas_rans.py pack_device_tables)'),
}

#: ptxas entry-name fragments (all of them in the mangled name) -> the
#: kernel it compiles. K4 and K5 are three passes: segment totals, their
#: prefixes (one kernel an accumulator width, compiled into both sources),
#: the seeded scan. int64 mangles as ``l``, the 64-bit accumulator as
#: ``y``.
#: The finalize is K4's kernels behind their finalize load stage: K2 with
#: one channel block, K3 with a tail block.
PTXAS_NAMES = (
    (('rans_decode_groups_kernelILi0E',), 'K1 octet'),
    (('rans_decode_groups_kernelILi1E',), 'K1 coarse 1'),
    (('rans_decode_groups_kernelILi2E',), 'K1 coarse 2'),
    (('scan_transposed_totals_kernel', 'ElemLoadIsE'), 'K4 i16 totals'),
    (('scan_transposed_totals_kernel', 'ElemLoadIiE'), 'K4 i32 totals'),
    (('scan_transposed_totals_kernel', 'ElemLoadIlE'), 'K4 i64 totals'),
    (('scan_transposed_totals_kernel', 'PlaneLoad'), 'K4 planes totals'),
    (('scan_transposed_totals_kernel', 'FinalizeLoadILb0E'), 'K2 totals'),
    (('scan_transposed_totals_kernel', 'FinalizeLoadILb1E'), 'K3 totals'),
    (('scan_transposed_kernel', 'ElemLoadIsE'), 'K4 i16 scan'),
    (('scan_transposed_kernel', 'ElemLoadIiE'), 'K4 i32 scan'),
    (('scan_transposed_kernel', 'ElemLoadIlE'), 'K4 i64 scan'),
    (('scan_transposed_kernel', 'PlaneLoad'), 'K4 planes scan'),
    (('scan_transposed_kernel', 'FinalizeLoadILb0E'), 'K2 scan'),
    (('scan_transposed_kernel', 'FinalizeLoadILb1E'), 'K3 scan'),
    (('cumsum_time_totals_kernelIsE',), 'K5 i16 totals'),
    (('cumsum_time_totals_kernelIiE',), 'K5 i32 totals'),
    (('cumsum_time_totals_kernelIlE',), 'K5 i64 totals'),
    (('cumsum_time_scan_kernelIsE',), 'K5 i16 scan'),
    (('cumsum_time_scan_kernelIiE',), 'K5 i32 scan'),
    (('cumsum_time_scan_kernelIlE',), 'K5 i64 scan'),
    (('seg_prefix_kernelIjE',), 'K4/K5 prefix'),
    (('seg_prefix_kernelIyE',), 'K4/K5 i64 prefix'),
    (('rans_encode_groups_kernel',), 'K6'),
    (('decode_tables_kernel',), 'K1 tables'))

ORDER1 = {'time_diff_order': 1, 'do_spatial_diff': False}
MODE_NAMES = {ans_codec.MODE_RAW: 'RAW', ans_codec.MODE_RANS: 'RANS',
              ans_codec.MODE_CONST: 'CONST'}

#: K6's steps a window (``kWindow`` in csrc/rans_encode.cu).
ENC_WINDOW = 16
#: Edge cases of K1 and K6 (phase c on the card, the port's CPU tests on
#: the twins): name -> (steps, tables). 'skewed' rows draw from their own
#: random tables, with rows of count 0 and ragged counts; 'uniform' rows
#: from flat 256-symbol tables (8 bits a symbol: in step, the lanes read
#: close to 4096 words every other step, across K1's ring slots), one
#: skewed row shifting the step totals off the slot grid and one ragged
#: row.
EDGE_CASES = {
    'one_step': (1, 'skewed'),
    'window_less_one': (ENC_WINDOW - 1, 'skewed'),
    'one_window': (ENC_WINDOW, 'skewed'),
    'window_and_one': (ENC_WINDOW + 1, 'skewed'),
    'two_windows_and_three': (2 * ENC_WINDOW + 3, 'skewed'),
    'eight_bit_symbols': (2 * ENC_WINDOW + 3, 'uniform'),
}
#: Where a group's word region ends (K1's W, K6's cap): at the largest
#: stream's last word, or one past it off the 8-word grid.
REGION_ENDS = ('exact', 'off_grid')

#: Edge shapes of the time scans K4 and K5 (phase c on the card, the
#: port's CPU tests on the twins): name -> (B, C, T', variant), T' the
#: steps per channel. Time lengths sit around K4's and K5's segments (64
#: steps; 32 for K4's int32), channel counts around a warp, a 16-byte
#: vector and K4's 256-channel tile; 40,000 channels exceed K5's tile.
#: Variants: 'channel_slice' feeds a channel slice of a wider tensor,
#: 'off_grid' a tensor whose base is off the 16-byte grid, 'short_out'
#: asks K4 for fewer steps than it is given, 'plus_one' its head-seeded
#: form for one more.
SCAN_EDGE_CASES = {
    '%dx%dx%d' % (1 + 2 * ((i + j) % 2), C, T): (
        1 + 2 * ((i + j) % 2), C, T, 'plain')
    for i, T in enumerate((1, 2, 31, 32, 33, 63, 64, 65, 67, 131))
    for j, C in enumerate((1, 7, 8, 33, 385, 1025))}
SCAN_EDGE_CASES.update({
    '%dx%dx%d_%s' % (B, C, T, variant): (B, C, T, variant)
    for B, C, T in ((3, 33, 131), (1, 385, 65), (3, 7, 64))
    for variant in ('channel_slice', 'off_grid', 'short_out', 'plus_one')})
SCAN_EDGE_CASES['1x40000x3'] = (1, 40000, 3, 'plain')
SCAN_EDGE_CASES['1x40000x3_off_grid'] = (1, 40000, 3, 'off_grid')

#: Edge shapes of the finalize, K2 and K3 (phase c on the card, the port's
#: CPU tests on the twins): name -> (B, CA, CB, T', variant): CA bulk and
#: CB tail channels (0: K2, no tail block), T' coded steps a channel. The
#: tails of 1, 7 and 33 channels sit behind bulk blocks that end on and
#: off a warp (32) and the channel tile; T' around the 64-step segments.
#: Variants: 'plain' feeds contiguous rows of T' bytes (off the 16-byte
#: grid unless T' is on it), 'padded' rows padded to 128 as K1 leaves
#: them with ``n_samples`` = T' + 1 (the path's form: 16-byte loads),
#: 'bulk_off_grid' and 'tail_off_grid' padded rows with that block's base
#: off the grid, 'short_out' fewer samples than steps, 'plus_one'
#: unpadded rows and T' + 1 samples, 'extra_rows' blocks with more rows
#: than heads (the bulk a channel slice of a wider tensor).
FINALIZE_EDGE_CASES = {
    '%dx%d+%dx%d_%s' % (1 + 2 * ((i + j) % 2), CA, CB, T, variant): (
        1 + 2 * ((i + j) % 2), CA, CB, T, variant)
    for i, T in enumerate((1, 63, 64, 65, 131))
    for j, (CA, CB) in enumerate(((32, 1), (37, 7), (250, 33), (384, 1),
                                  (33, 0), (385, 0)))
    for variant in ('plain', 'padded')}
FINALIZE_EDGE_CASES.update({
    '%dx%d+%dx%d_%s' % (B, CA, CB, T, variant): (B, CA, CB, T, variant)
    for B, CA, CB, T in ((3, 37, 7, 131), (1, 384, 1, 65), (2, 250, 33, 64),
                         (3, 33, 0, 131))
    for variant in ('bulk_off_grid', 'tail_off_grid', 'short_out',
                    'plus_one', 'extra_rows')
    if CB or variant != 'tail_off_grid'})

#: Recordings: name -> (signal, seconds, channels, dtype, seed, compress
#: options, another writer's choice or None (``('min_freq', n)``: its
#: tables, :func:`foreign_quantizer`; ``('k', n)``: its segments of n
#: channels, :func:`foreign_geometry`), expected (route, rANS planes,
#: bit6, K1 fixups) of its first batch, or None where the modes or the
#: transform change between chunks). Route 'fuse8' or 'generic'. Chunks
#: are 1 s (``SR`` samples) unless the options name a ``chunk_duration``.
RECORDINGS = {
    'int16_385ch': ('walk', SECONDS, 385, 'int16', 0, ORDER1, None,
                    ('fuse8', 1, True, 0)),
    'int16_384ch': ('walk', SHORT_SECONDS, 384, 'int16', 1, ORDER1, None,
                    ('fuse8', 1, False, 0)),
    'uint16_385ch': ('walk', SHORT_SECONDS, 385, 'uint16', 2, ORDER1, None,
                     ('fuse8', 1, True, 0)),
    'spiky_int16_385ch': ('spiky', SECONDS, 385, 'int16', 3, ORDER1, None,
                          ('generic', 2, False, 0)),
    'order2_fuse8': ('lfp', BRANCH_SECONDS, 385, 'int16', 4,
                     {'time_diff_order': 2, 'do_spatial_diff': False}, None,
                     ('fuse8', 1, True, 0)),
    'order2_generic': ('spiky', BRANCH_SECONDS, 385, 'int16', 5,
                       {'time_diff_order': 2, 'do_spatial_diff': False},
                       None, ('generic', 2, False, 0)),
    'c_order': ('spiky', BRANCH_SECONDS, 385, 'int16', 6,
                dict(ORDER1, chunk_order='C', ans_table_mode='plane'), None,
                ('generic', 2, False, 0)),
    'spatial': ('spiky', BRANCH_SECONDS, 385, 'int16', 7,
                {'time_diff_order': 1, 'do_spatial_diff': True}, None,
                ('generic', 2, False, 0)),
    'bit6_spatial': ('walk', BRANCH_SECONDS, 385, 'int16', 8,
                     {'time_diff_order': 1, 'do_spatial_diff': True}, None,
                     ('generic', 1, True, 0)),
    'uint8': ('walk', BRANCH_SECONDS, 385, 'uint8', 9, ORDER1, None,
              ('generic', 1, True, 0)),
    'int8': ('spiky', BRANCH_SECONDS, 385, 'int8', 10, ORDER1, None,
             ('generic', 1, True, 0)),
    'int32': ('spiky', BRANCH_SECONDS, 385, 'int32', 11, ORDER1, None,
              ('generic', None, False, 0)),
    'float32_order2': ('walk', BRANCH_SECONDS, 385, 'float32', 12,
                       {'time_diff_order': 2, 'do_spatial_diff': False},
                       None, ('generic', None, False, 0)),
    'raw_low_plane': ('wide', BRANCH_SECONDS, 385, 'int16', 13, ORDER1, None,
                      ('generic', 1, True, 0)),
    'foreign_1fixup': ('walk', BRANCH_SECONDS, 385, 'int16', 14,
                       dict(ORDER1, ans_table_mode='plane'),
                       ('min_freq', 16), ('fuse8', 1, True, 1)),
    'foreign_2fixups': ('heavy', BRANCH_SECONDS, 385, 'int16', 15,
                        dict(ORDER1, ans_table_mode='plane'),
                        ('min_freq', 9), ('generic', 2, False, 2)),
    # One batch of 8 chunks: 4 with a constant high byte, then 4 with
    # both planes coded (two mode-uniform device sub-batches).
    'mixed_modes': ('walk_then_spiky', SHORT_SECONDS, 385, 'int16', 16,
                    dict(ORDER1, n_threads=BATCH), None, None),
    # Windows of 4 chunks re-probe the transform (bit5 stamps).
    'adaptive': ('walk_then_slow', SHORT_SECONDS, 385, 'int16', 17,
                 {'transform_adapt': 4, 'n_threads': BATCH}, None, None),
    # Fused on the card, generic in the JAX package (its Pallas step
    # blocks, 128-lane channel tiles, tp >= T and tail block): chunks of
    # 16,769 samples (4 channels a segment, S = 4 x 131 steps with no
    # divisor in 8..128, tp = T - 1; a shorter last chunk), another
    # writer's segments of 5 channels (32 x 5 rows, K2), and 1025
    # channels (a bit6 tail behind 8 full groups of 4-channel segments,
    # 1,152 rows).
    'fuse8_odd_steps': ('walk', BRANCH_SECONDS, 385, 'int16', 18,
                        dict(ORDER1, chunk_duration=16769 / SR), None,
                        ('fuse8', 1, True, 0)),
    'fuse8_k5': ('walk', BRANCH_SECONDS, 385, 'int16', 19, ORDER1, ('k', 5),
                 ('fuse8', 1, False, 0)),
    'fuse8_1025ch': ('walk', BRANCH_SECONDS, 1025, 'int16', 20, ORDER1, None,
                     ('fuse8', 1, True, 0)),
    # Encode routes the JAX package leaves to its host codec: C order
    # under segment tables; one Writer batch of 7 walk chunks and 1
    # spiky one (mode sub-batches of 7 and 1); windows of 3 chunks
    # re-probing the transform (window runs of 6 and 2 chunks).
    'c_order_segment': ('spiky', BRANCH_SECONDS, 385, 'int16', 21,
                        dict(ORDER1, chunk_order='C'), None,
                        ('generic', 2, False, 0)),
    'mixed_runt': ('walk_then_one_spiky', SHORT_SECONDS, 385, 'int16', 22,
                   dict(ORDER1, n_threads=BATCH), None, None),
    'adaptive_runts': ('walk_then_slow', SHORT_SECONDS, 385, 'int16', 23,
                       {'transform_adapt': 3, 'n_threads': BATCH}, None,
                       None),
    # 8-byte items, which the JAX package decodes and encodes on its host
    # codec (JAX without x64 has no int64 tensor): values past 2**32, K1
    # then K4's int64 form (the spiky int64 walk), K4 i64 and K5 i64
    # (order 2 of the walk x 1.5 as float64, bitcast), the torch layout
    # and K5 i64 (C-order uint64 around 2**63); all three encode on the
    # card (8 byte planes, K6).
    'int64': ('spiky', BRANCH_SECONDS, 385, 'int64', 24, ORDER1, None,
              ('generic', None, False, 0)),
    'float64_order2': ('walk', BRANCH_SECONDS, 385, 'float64', 25,
                       {'time_diff_order': 2, 'do_spatial_diff': False},
                       None, ('generic', None, False, 0)),
    'uint64_c_order': ('walk', BRANCH_SECONDS, 385, 'uint64', 26,
                       dict(ORDER1, chunk_order='C'), None,
                       ('generic', None, False, 0)),
    # A recording one sample longer than its chunk: the last chunk, of
    # one sample, is stored without a head, so its decode runs K4's
    # inclusive int64 form (and its device encode a batch of one row).
    'int64_last_sample': ('spiky', BRANCH_SECONDS, 385, 'int64', 27,
                          dict(ORDER1, chunk_duration=(BRANCH_SECONDS * SR
                                                       - 1) / SR),
                          None, ('generic', None, False, 0)),
}
#: The recordings of 8-byte items (decoded, encoded and timed as paths of
#: their own).
WIDE = ('int64', 'float64_order2', 'uint64_c_order', 'int64_last_sample')
#: Every scan form narrower than 64 bits: a wide path must launch none.
NARROW_SCANS = ('finalize_u8', 'finalize_u8_tail', 'scan_planes_i16_seeded',
                'scan_transposed_i16_seeded', 'scan_transposed_i32_seeded',
                'cumsum_time_i16', 'cumsum_time_i32')
#: The layouts only the port fuses (``RECORDINGS``' note), decoded and
#: timed on both routes as a path of their own.
FUSE8_GEOMETRIES = ('fuse8_odd_steps', 'fuse8_k5', 'fuse8_1025ch')

#: Paths, each driven with the counts set to 0 just before it: name ->
#: (recordings, kernel forms that must have launched, forms that must
#: not). The generic decode of 2-byte data goes from K1 into K4's plane
#: form; K4's int16 element form stays on the branches through the
#: bit6 layouts (uint8, int8, a RAW low plane), its int32 form through
#: the 4-byte files, K5 through C order, the spatial diffs and order 2.
PATHS = {
    'fuse8': (('int16_385ch', 'int16_384ch', 'uint16_385ch'),
              ('decode_tables', 'rans_decode_octet', 'finalize_u8',
               'finalize_u8_tail'), ()),
    'generic': (('spiky_int16_385ch',),
                ('decode_tables', 'rans_decode_octet',
                 'scan_planes_i16_seeded'),
                ('scan_transposed_i16_seeded',)),
    'branches': (tuple(name for name, r in RECORDINGS.items()
                       if r[1] == BRANCH_SECONDS
                       and name not in FUSE8_GEOMETRIES + WIDE)
                 + ('mixed_modes', 'adaptive'),
                 ('decode_tables', 'rans_decode_octet',
                  'rans_decode_coarse_1fixup',
                  'rans_decode_coarse_2fixups', 'finalize_u8_tail',
                  'scan_planes_i16_seeded', 'scan_transposed_i16_seeded',
                  'scan_transposed_i32_seeded', 'cumsum_time_i16',
                  'cumsum_time_i32'), ()),
    'fuse8_geometries': (FUSE8_GEOMETRIES,
                         ('decode_tables', 'rans_decode_octet',
                          'finalize_u8', 'finalize_u8_tail'),
                         ('scan_planes_i16_seeded',
                          'scan_transposed_i16_seeded',
                          'scan_transposed_i32_seeded', 'cumsum_time_i16')),
    'wide': (WIDE, ('decode_tables', 'rans_decode_octet',
                    'scan_transposed_i64_seeded',
                    'scan_transposed_i64_inclusive', 'cumsum_time_i64'),
             NARROW_SCANS),
}

#: Encode paths, each driven with the counts set to 0 just before it:
#: name -> (recordings, kernel forms that must have launched). Files from
#: another writer are not this writer's bytes. Every chunk of every path
#: encodes on the card: ``encode_opened`` holds what the JAX package
#: leaves to its host codec (4-byte elements, bitcast float32 included;
#: C order under segment tables; mode sub-batches and window runs under
#: 4 chunks).
ENCODE_PATHS = {
    'encode_main': (('int16_385ch', 'spiky_int16_385ch'), ('rans_encode',)),
    'encode_branches': (('int16_384ch', 'uint16_385ch', 'order2_fuse8',
                         'order2_generic', 'c_order', 'spatial',
                         'bit6_spatial', 'uint8', 'int8', 'raw_low_plane',
                         'mixed_modes', 'adaptive', 'fuse8_odd_steps',
                         'fuse8_1025ch'),
                        ('rans_encode',)),
    'encode_opened': (('int32', 'float32_order2', 'c_order_segment',
                       'mixed_runt', 'adaptive_runts'), ('rans_encode',)),
    'encode_wide': (WIDE, ('rans_encode',)),
}
ENCODED = {name for names, _forms in ENCODE_PATHS.values() for name in names}

#: The forms some path launches. The others, K4's inclusive scans of 2-
#: and 4-byte elements, run only for chunks without a stored head, which
#: this codec's writer makes only for a chunk of one sample (the path
#: ``wide`` has one, of int64): they are held against their twins and
#: timed, and reported apart from the path kernels.
ON_PATH = {form for paths in (PATHS, ENCODE_PATHS)
           for _names, forms, *_not in paths.values() for form in forms}

#: Window paths (phase w), each driven with the counts set to 0 just
#: before it: name -> (recordings read through ``Reader[...]`` on the card,
#: kernel forms that must have launched). A window decodes one chunk a
#: call (B=1) through the forms of its file's decode path.
WINDOW_PATHS = {
    'windows_fuse8': (('int16_385ch', 'int16_384ch'),
                      ('decode_tables', 'rans_decode_octet', 'finalize_u8',
                       'finalize_u8_tail')),
    'windows_generic': (('spiky_int16_385ch',),
                        ('decode_tables', 'rans_decode_octet',
                         'scan_planes_i16_seeded')),
    'windows_branches': (('c_order', 'spatial', 'uint8', 'int32',
                          'float32_order2', 'order2_fuse8', 'adaptive'),
                         ('decode_tables', 'rans_decode_octet',
                          'finalize_u8_tail',
                          'scan_transposed_i16_seeded',
                          'scan_transposed_i32_seeded', 'cumsum_time_i16',
                          'cumsum_time_i32')),
    'windows_wide': (WIDE[:3], ('decode_tables', 'rans_decode_octet',
                                'scan_transposed_i64_seeded',
                                'cumsum_time_i64')),
}
#: Decoded chunks a window reader keeps on the card (phase w).
WINDOW_CACHE = 4


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_resources(ptxas):
    """``{kernel form: 'Used N registers, ...'}`` from ``-Xptxas -v``
    output (a spill line and a resource line follow each entry)."""
    out, name = {}, None
    for line in ptxas.splitlines():
        if 'Compiling entry function' in line:
            name = next((v for k, v in PTXAS_NAMES
                         if all(part in line for part in k)), None)
        elif name and ('spill stores' in line or 'registers' in line):
            text = line.split(':', 1)[-1].strip()
            if 'spill stores' in text:
                text = text.split(', ')[1]
            parts = out.setdefault(name, [])
            if text not in parts:         # one kernel in two sources: once
                parts.append(text)
    missing = [v for _k, v in PTXAS_NAMES if v not in out]
    require(not missing, 'ptxas reported no resources for %s' % missing)
    spills = {name: parts for name, parts in out.items()
              if not any(p.startswith('0 bytes spill stores') for p in parts)}
    require(not spills, 'ptxas reports register spills: %s' % spills)
    return {name: '; '.join(parts) for name, parts in out.items()}


def rounded(x):
    """Floats of nested dicts and lists to 6 decimals (keeps the summary
    short)."""
    if isinstance(x, dict):
        return {k: rounded(v) for k, v in x.items()}
    if isinstance(x, list):
        return [rounded(v) for v in x]
    return round(x, 6) if isinstance(x, float) else x


def signal_second(rng, kind, n_channels):
    """One second of diffs: a random walk's (std 6), with spikes, with
    wide steps (std 3000: the low byte plane turns RAW) or with heavy
    tails (2 % of the steps x30)."""
    if kind == 'wide':
        return rng.normal(0.0, 3000.0, size=(SR, n_channels))
    if kind == 'heavy':
        return heavy_tailed_steps(rng, (SR, n_channels))
    d = rng.normal(0.0, 6.0, size=(SR, n_channels))
    if kind == 'spiky':
        t, c = np.nonzero(rng.random((SR - 3, n_channels)) < 5.0 / SR)
        for k, v in enumerate((-60.0, -90.0, 150.0)):
            np.add.at(d, (t + k, c), v)
    return d


def heavy_tailed_steps(rng, shape):
    """Random-walk steps with heavy tails: normal (std 6), 2 % of them
    multiplied by 30 (rare and common symbols in the tables)."""
    steps = rng.normal(0.0, 6.0, size=shape)
    steps[rng.random(shape) < 0.02] *= 30.0
    return steps


def foreign_quantizer(min_freq):
    """A stand-in for another writer of the ans format: a drop-in for
    ``mtscomp_tpu_torch.codec.ans._quantize_rows`` that quantizes at unit
    granularity (this codec's writer uses an 8-slot grid, which K1 reads
    through octet tables), as the JAX package's
    ``test_foreign_min8_tables_container_roundtrip`` does, with every
    present frequency at least ``min_freq``: 16 keeps each 16-slot
    bucket to two symbols (one fixup); 9 or less lets a bucket hold three
    (two fixups). The port's CPU tests import it from here."""
    def quantize(counts):
        counts = np.asarray(counts, dtype=np.int64)
        present = counts > 0
        ideal = counts * 4096 / counts.sum()
        freqs = np.floor(ideal).astype(np.int64)
        freqs[present] = np.maximum(freqs[present], min_freq)
        rem = int(4096 - freqs.sum())
        if rem > 0:
            frac = np.where(present, ideal - np.floor(ideal), -1.0)
            freqs[np.argsort(-frac, kind='stable')[:rem]] += 1
        while freqs.sum() > 4096:
            freqs[int(np.argmax(freqs))] -= 1
        return freqs

    return lambda sums: np.stack([quantize(r) for r in np.asarray(sums)]
                                 ).astype(np.uint16)


def foreign_geometry(k):
    """Another writer's channel-aligned segments: a drop-in for
    ``mtscomp_tpu_torch.codec.ans.aligned_geometry`` that puts ``k``
    channels in every segment (this codec's writer takes multiples of 4;
    the format stores k in the header and every reader takes any). The
    port's CPU tests import it from here."""
    def geometry(n_coded, n_head, _seg0):
        tcs = n_coded // n_head
        tp = -(-tcs // LANES) * LANES
        return k, k * tp, tp, tcs, n_head * tp

    return geometry


def edge_groups(name, n_groups=2):
    """The seeded symbol rows of one of ``EDGE_CASES``: ``(rows, freqs,
    counts, steps)``, ``rows[n][r]`` row r of group n (uint8), ``freqs``
    (N, 32, 256) this writer's 8-aligned tables, ``counts`` (N, 32)
    int32. The port's CPU tests import it from here."""
    steps, kind = EDGE_CASES[name]
    rng = np.random.default_rng(100 + list(EDGE_CASES).index(name))
    full = steps * LANES
    freqs = np.zeros((n_groups, GROUP_ROWS, 256), np.int64)
    counts = np.zeros((n_groups, GROUP_ROWS), np.int32)
    rows = []
    for n in range(n_groups):
        if kind == 'uniform':
            c = np.full(GROUP_ROWS, full)
            c[12] = full - 77
        else:
            c = rng.integers(0, full + 1, size=GROUP_ROWS)
            c[rng.choice(np.arange(1, GROUP_ROWS), 4, replace=False)] = 0
            c[0] = full
        group = []
        for r in range(GROUP_ROWS):
            if kind == 'uniform' and r != 7:
                f = np.full(256, 16)
            else:
                hist = np.zeros(256, np.int64)
                k = int(rng.integers(2, 40))
                hist[rng.choice(256, k, replace=False)] = rng.geometric(
                    0.05, size=k)
                f = rans.quantize_freqs(hist)
            freqs[n, r] = f
            group.append(rng.choice(256, size=int(c[r]),
                                    p=f / f.sum()).astype(np.uint8))
        counts[n] = c
        rows.append(group)
    return rows, freqs, counts, steps


def region_width(n_words, region_end):
    """K1's W or K6's cap for streams of ``n_words`` words: the largest
    one's length ('exact') or one past it, off the 8-word grid."""
    w = max(max(n_words), 1)
    if region_end == 'off_grid':
        w += 2 if (w + 1) % 8 == 0 else 1
    return w


def edge_k1_inputs(rows, freqs, counts, streams, region_end):
    """K1's inputs for encoded edge groups (``streams`` (states, words)
    of each group from a normative ``rans_encode_group``), as CPU
    tensors: (states, words, octet_pk, coarse_pk, dense_pk, counts)."""
    N = len(rows)
    W = region_width([w.size for _s, w in streams], region_end)
    states = np.full((N, GROUP_ROWS, LANES), rans.RANS_L, np.uint32)
    words = np.zeros((N, W), np.uint16)
    octet = np.zeros((N, GROUP_ROWS, LANES), np.int32)
    coarse = np.zeros((N, GROUP_ROWS, 256), np.int32)
    dense = np.zeros((N, GROUP_ROWS, 256), np.int32)
    for n, (st, w) in enumerate(streams):
        states[n] = st
        words[n, :w.size] = w
        for r in range(GROUP_ROWS):
            c, d, _two, o = pack_device_tables(freqs[n, r])
            coarse[n, r], dense[n, r], octet[n, r] = (c.reshape(-1),
                                                      d.reshape(-1), o)
    return tuple(torch.from_numpy(a) for a in (
        states.view(np.int32), words.view(np.int16), octet, coarse, dense,
        counts))


def edge_k6_inputs(rows, freqs, counts, steps, n_words, region_end):
    """K6's inputs for edge groups whose streams have ``n_words`` words,
    as CPU tensors: (symbols, pk, rcp, counts) and the region ``cap``."""
    symbols = np.zeros((len(rows), GROUP_ROWS, steps * LANES), np.uint8)
    for n, group in enumerate(rows):
        for r, row in enumerate(group):
            symbols[n, r, :row.size] = row
    pk, rcp = renc.pack_encoder_tables(freqs)
    return (tuple(torch.from_numpy(a) for a in (symbols, pk, rcp, counts)),
            region_width(n_words, region_end))


def scan_edge_arrays(name):
    """The seeded inputs of one of ``SCAN_EDGE_CASES``, as numpy arrays
    over the whole integer range: ``elems`` and ``head`` by width (16,
    32, 64), the (B, C, T') byte planes ``lo`` and ``hi`` and the
    per-chunk constants ``lo_const`` and ``hi_const``. The port's CPU
    tests import it from here."""
    B, C, T, _variant = SCAN_EDGE_CASES[name]
    rng = np.random.default_rng(200 + list(SCAN_EDGE_CASES).index(name))
    out = {}
    for bits, dtype in ((16, np.int16), (32, np.int32)):
        info = np.iinfo(dtype)
        out['elems%d' % bits] = rng.integers(
            info.min, info.max, size=(B, C, T), endpoint=True,
            dtype=np.int64).astype(dtype)
        out['head%d' % bits] = rng.integers(
            info.min, info.max, size=(B, C), endpoint=True,
            dtype=np.int64).astype(dtype)
    for key, shape in (('lo', (B, C, T)), ('hi', (B, C, T)),
                       ('lo_const', (B,)), ('hi_const', (B,))):
        out[key] = rng.integers(0, 255, size=shape, endpoint=True,
                                dtype=np.int64).astype(np.uint8)
    # Drawn last, so that the 16- and 32-bit inputs stay what they were.
    for key, shape in (('elems64', (B, C, T)), ('head64', (B, C))):
        out[key] = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64
                                ).view(np.int64)
    return out


def edge_tensor(a, variant, device):
    """A (B, C, T') array as the tensor a scan edge case feeds: a channel
    slice of a wider tensor, a view whose base is one element off the
    16-byte grid, or the plain contiguous tensor."""
    t = torch.from_numpy(a).to(device)
    B, C, T = t.shape
    if variant == 'channel_slice':
        wide = torch.zeros((B, C + 5, T), dtype=t.dtype, device=device)
        wide[:, 2:2 + C] = t
        return wide[:, 2:2 + C]
    if variant == 'off_grid':
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(B, C, T)
    return t


def edge_n_samples(T, variant, seeded):
    """The output steps a scan edge case asks K4 for."""
    if variant == 'short_out':
        return max(T - 3, 0)
    return T + 1 if variant == 'plus_one' and seeded else T


def scan_edge_calls(name, device):
    """Every form of K4 and K5 on one of ``SCAN_EDGE_CASES``: a list of
    ``(label, kernel, twin, args, kwargs)`` with the tensors on
    ``device``. K5 takes the elements time-major, (B, T', C); the plane
    form runs with two coded planes and with either plane constant,
    zigzag on and off."""
    _B, _C, T, variant = SCAN_EDGE_CASES[name]
    a = scan_edge_arrays(name)
    calls = []
    for bits in (16, 32, 64):
        elems = edge_tensor(a['elems%d' % bits], variant, device)
        head = torch.from_numpy(a['head%d' % bits]).to(device)
        time_major = edge_tensor(np.ascontiguousarray(
            a['elems%d' % bits].transpose(0, 2, 1)), variant, device)
        calls.append(('K5 i%d' % bits, dd.cumsum_time, dd.cumsum_time_ref,
                      (time_major,), {}))
        for h in (head, None):
            calls.append((
                'K4 i%d %s' % (bits, 'inclusive' if h is None else 'seeded'),
                dd.cumsum_time_transposed, dd.cumsum_time_transposed_ref,
                (elems, h),
                {'n_samples': edge_n_samples(T, variant, h is not None)}))
    lo = edge_tensor(a['lo'], variant, device)
    hi = edge_tensor(a['hi'], variant, device)
    lo_c = torch.from_numpy(a['lo_const']).to(device)
    hi_c = torch.from_numpy(a['hi_const']).to(device)
    head = torch.from_numpy(a['head16']).to(device)
    for kind, planes in (('two coded', (lo, hi)), ('const hi', (lo, hi_c)),
                         ('const lo', (lo_c, hi))):
        for h in (head, None):
            for zigzag in (True, False):
                calls.append((
                    'K4 planes, %s, %s, zigzag %s' % (
                        kind, 'inclusive' if h is None else 'seeded', zigzag),
                    dd.cumsum_time_transposed_planes,
                    dd.cumsum_time_transposed_planes_ref, planes + (h,),
                    {'n_samples': edge_n_samples(T, variant, h is not None),
                     'zigzag': zigzag}))
    return calls


def finalize_edge_call(name, device):
    """One of ``FINALIZE_EDGE_CASES`` as a call of the finalize:
    ``(kernel, twin, args, kwargs)`` with seeded tensors on ``device``
    (bytes and heads over their whole range; ``hi`` uint8 or int32 by
    turns). K2 for a case without tail channels, else K3. The port's CPU
    tests import it from here."""
    B, CA, CB, T, variant = FINALIZE_EDGE_CASES[name]
    index = list(FINALIZE_EDGE_CASES).index(name)
    rng = np.random.default_rng(300 + index)
    width = T if variant in ('plain', 'plus_one') else -(-T // LANES) * LANES
    extra = 3 if variant == 'extra_rows' else 0

    def block(n_rows, how):
        return edge_tensor(rng.integers(
            0, 255, size=(B, n_rows, width), endpoint=True,
            dtype=np.int64).astype(np.uint8), how, device)

    head = torch.from_numpy(rng.integers(
        -32768, 32767, size=(B, CA + CB), endpoint=True,
        dtype=np.int64).astype(np.int16)).to(device)
    hi = torch.from_numpy(rng.integers(0, 255, size=B, endpoint=True)).to(
        device, torch.int32 if index % 2 else torch.uint8)
    kwargs = {'n_samples': {'plain': None,
                            'short_out': max(T - 3, 0)}.get(variant, T + 1)}
    how = 'off_grid' if variant == 'bulk_off_grid' else 'plain'
    if not CB:
        return (dd.cumsum_time_transposed_u8,
                dd.cumsum_time_transposed_u8_ref,
                (block(CA + extra, how), head, hi), kwargs)
    bulk = block(CA, 'channel_slice' if extra else how)
    tail = block(CB + extra,
                 'off_grid' if variant == 'tail_off_grid' else 'plain')
    return (dd.cumsum_time_transposed_u8_tail,
            dd.cumsum_time_transposed_u8_tail_ref,
            (bulk, tail, head[:, :CA], head[:, CA:], hi), kwargs)


def to_dtype(walk, dtype):
    """Integer samples in ``dtype``, wrapping like the codec's modular
    arithmetic; int32 is scaled x1001 (wide values, all four planes in
    play), float32 by 0.25 (bitcast to int32 by the writer); int64 is
    scaled x1001 around 3 * 2**40, uint64 lies around 2**63 and float64
    is scaled by 1.5 (bitcast to int64): values past 2**32."""
    w = walk.astype(np.int64)
    if dtype == 'float32':
        return (walk * 0.25).astype(np.float32)
    if dtype == 'int32':
        return (w * 1001).astype(np.int32)
    if dtype == 'int64':
        return w * 1001 + (np.int64(3) << 40)
    if dtype == 'uint64':
        return w.astype(np.uint64) + (np.uint64(1) << np.uint64(63))
    if dtype == 'float64':
        return walk * 1.5
    bits = np.dtype(dtype).itemsize * 8
    u = (w % (1 << bits)).astype('uint%d' % bits)
    return u.view(dtype)


def lfp_second(rng, s, n_channels, freq, phase):
    """One second of an LFP-like band: a 5-20 Hz oscillation of
    amplitude 30 per channel plus white noise (std 1). Its level stays
    small, so a second-order time diff, whose first coded row is
    ``x1 - 2*x0``, keeps every chunk's high byte constant (fuse8)."""
    t = (s * SR + np.arange(SR))[:, None] / SR
    return (30.0 * np.sin(2 * np.pi * freq * t + phase)
            + rng.normal(0.0, 1.0, size=(SR, n_channels)))


def slow_second(s, n_channels, freq, phase):
    """One second of a slow oscillation without noise: amplitude 2000 at
    5-20 Hz, whose second time diff is far smaller than its first (the
    transform probe picks order 2 for it, order 1 for a walk)."""
    t = (s * SR + np.arange(SR))[:, None] / SR
    return 2000.0 * np.sin(2 * np.pi * freq * t + phase)


def make_recording(path, kind, seconds, n_channels, dtype, seed):
    """Seeded signal, written one second at a time. The kinds
    ``walk_then_spiky`` and ``walk_then_slow`` switch from the walk to
    the spiky walk or the slow oscillation halfway through,
    ``walk_then_one_spiky`` for its last second."""
    rng = np.random.default_rng(seed)
    arr = np.empty((seconds * SR, n_channels), dtype=dtype)
    level = np.zeros(n_channels)
    freq = rng.uniform(5.0, 20.0, size=n_channels)
    phase = rng.uniform(0.0, 2 * np.pi, size=n_channels)
    with open(path, 'wb') as f:
        for s in range(seconds):
            late = s >= seconds // 2
            if kind == 'lfp':
                walk = lfp_second(rng, s, n_channels, freq, phase)
            elif kind == 'walk_then_slow' and late:
                walk = level + slow_second(s, n_channels, freq, phase)
            else:
                sub = {'walk_then_spiky': 'spiky' if late else 'walk',
                       'walk_then_one_spiky': ('spiky' if s == seconds - 1
                                               else 'walk'),
                       'walk_then_slow': 'walk'}.get(kind, kind)
                walk = level + np.cumsum(
                    signal_second(rng, sub, n_channels), axis=0)
            level = walk[-1]
            block = to_dtype(walk, dtype)
            arr[s * SR:(s + 1) * SR] = block
            f.write(block.tobytes())
    return arr


def make_recordings(workdir):
    """Phase d: every one of ``RECORDINGS``, the sources made side by side
    on threads (each from its own seed, the longest first), then
    compressed one after the other, so that the host compress times
    stand alone."""
    def make(name):
        kind, seconds, n_channels, dtype, seed = RECORDINGS[name][:5]
        t0 = time.perf_counter()
        arr = make_recording(workdir / (name + '.bin'), kind, seconds,
                             n_channels, dtype, seed)
        return arr, time.perf_counter() - t0

    names = sorted(RECORDINGS, key=lambda n: -RECORDINGS[n][1])
    with concurrent.futures.ThreadPoolExecutor(
            max(1, min(6, os.cpu_count() or 1))) as pool:
        made = dict(zip(names, pool.map(make, names)))
    return {name: Recording(workdir, name, *made[name])
            for name in RECORDINGS}


class Recording:
    """A compressed test recording and its source samples."""

    def __init__(self, workdir, name, arr, made_s):
        (kind, seconds, n_channels, dtype, _seed, opts, foreign,
         self.expect) = RECORDINGS[name]
        self.name = name
        self.raw = workdir / (name + '.bin')
        self.cbin = workdir / (name + '.cbin')
        self.ch = workdir / (name + '.ch')
        self.workdir = workdir
        self.kwargs = dict(sample_rate=float(SR), n_channels=n_channels,
                           dtype=dtype, algorithm='ans', quiet=True,
                           check_after_compress=False, **opts)
        self.arr = arr
        #: Samples a chunk (the last one may be shorter).
        self.chunk = int(round(opts.get('chunk_duration', 1.0) * SR))
        t1 = time.perf_counter()
        seams = (('_quantize_rows', foreign_quantizer),
                 ('aligned_geometry', foreign_geometry))
        saved = {attr: getattr(ans_codec, attr) for attr, _ in seams}
        if foreign is not None:
            attr, make = seams[('min_freq', 'k').index(foreign[0])]
            setattr(ans_codec, attr, make(foreign[1]))
        try:
            mt.compress(self.raw, self.cbin, self.ch, device='none',
                        **self.kwargs)
        finally:
            for attr, fn in saved.items():
                setattr(ans_codec, attr, fn)
        t2 = time.perf_counter()
        #: compress() on the host route, host clock (s).
        self.host_compress_s = t2 - t1
        if name not in ENCODED:
            self.raw.unlink()
        log('d. %s: %d s x %d ch %s (%s), %.1f MB raw -> %.1f MB (x%.3f); '
            'made in %.1f s (beside the others), host compress %.1f s'
            % (name, seconds, n_channels, dtype, kind, self.arr.nbytes / 1e6,
               self.cbin.stat().st_size / 1e6,
               self.arr.nbytes / self.cbin.stat().st_size, made_s, t2 - t1))

    def device_compress(self):
        """compress() on the device route: the same .cbin and .ch bytes
        as the host route's, decoding through the port to the source.
        Returns the compress() host-clock seconds and the chunks the
        route left to the host codec."""
        cbin = self.workdir / (self.name + '.dev.cbin')
        ch = self.workdir / (self.name + '.dev.ch')
        before = mt.launch_counts()['host_encoded_chunks']
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mt.compress(self.raw, cbin, ch, device=DEVICE, **self.kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_host = mt.launch_counts()['host_encoded_chunks'] - before
        require(cbin.read_bytes() == self.cbin.read_bytes(),
                '%s: the device-encoded .cbin differs from the host '
                'route\'s' % self.name)
        require(ch.read_bytes() == self.ch.read_bytes(),
                '%s: the device-encoded .ch differs from the host route\'s'
                % self.name)
        r = mt.decompress(cbin, ch, device=DEVICE, quiet=True,
                          check_after_decompress=False)
        try:
            require(np.array_equal(r.to_array(), self.arr),
                    '%s: the device-encoded file does not decode to its '
                    'source' % self.name)
            n_chunks = r.n_chunks
        finally:
            r.close()
        cbin.unlink()
        log('k. %s: compress(device=%r) %.3f s (host route %.3f s), '
            'byte-identical, %d of %d chunks on the host codec, decodes '
            'to the source' % (self.name, DEVICE, dt, self.host_compress_s,
                               n_host, n_chunks))
        return dt, n_host, n_chunks

    def reader(self, device=None, **kwargs):
        # The smoke test compares every byte itself: no host re-decode.
        return mt.decompress(self.cbin, self.ch, device=device or DEVICE,
                             quiet=True, check_after_decompress=False,
                             **kwargs)

    def writer_batch(self, n_chunks=BATCH):
        """An open port Writer (device route) over the recording and its
        first ``n_chunks`` chunks as one (B, T, C) array."""
        w = mt.Writer(device=DEVICE, **{
            k: v for k, v in self.kwargs.items()
            if k not in ('sample_rate', 'n_channels', 'dtype')})
        w.open(self.raw, sample_rate=float(SR),
               n_channels=self.kwargs['n_channels'],
               dtype=self.kwargs['dtype'])
        return w, np.stack([np.asarray(w.get_chunk(i))
                            for i in range(min(n_chunks, w.n_chunks))])

    def staged(self, n_chunks=BATCH):
        """(reader, parsed chunks, fn, staged tensors) for the first
        ``n_chunks`` chunks of ``self.chunk`` samples, staged on the card;
        checks the file has the layout its name promises."""
        r = self.reader()
        bounds = r.chunk_bounds
        parsed = [r.codec.parse(_read_payload(r, i))
                  for i in range(min(n_chunks, r.n_chunks))
                  if bounds[i + 1] - bounds[i] == self.chunk]
        dec = DeviceBatchDecoder(r, DEVICE)
        require(dec.supported(parsed, self.chunk), '%s: batch not supported'
                % self.name)
        fn, args = dec.pack(parsed, self.chunk)
        route, n_rans, bit6, fixups = self.expect
        got_route = 'fuse8' if fn.func is _decode_fuse8 else 'generic'
        got_fixups = (fn.keywords['fixups'] if got_route == 'fuse8'
                      else fn.keywords['lay'].fixups)
        modes = [tuple(p['modes']) for p in parsed]
        got_rans = modes[0].count(ans_codec.MODE_RANS)
        require(got_route == route and got_fixups == fixups
                and (n_rans is None or got_rans == n_rans)
                and (parsed[0]['tail_split'] > 1) == bit6
                and len(set(modes)) == 1,
                '%s: layout %s (modes %s, tail_split %d, fixups %d), '
                'expected %s' % (self.name, got_route, modes,
                                 parsed[0]['tail_split'], got_fixups,
                                 self.expect))
        return r, parsed, fn, args


#: The benchmark harness's timer: the median over ``reps`` of the
#: CUDA-event time of ``inner`` calls, per call, after one warm-up call.
cuda_ms = harness.cuda_ms


def max_abs_err(a, b, mask=None):
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    if mask is not None:
        d = d[mask]
    return int(d.max()) if d.numel() else 0


def compare(kernel, twin, args, kwargs, live=None):
    """A kernel and its twin on the same card tensors: (max_abs_err,
    kernel output), over every tensor of a tuple output. With ``live``,
    the outputs are K1's (symbols, words used) and only the live symbol
    columns count."""
    got = kernel(*args, **kwargs)
    ref = twin(*args, **kwargs)
    torch.cuda.synchronize()
    if live is None:
        pairs = (zip(got, ref) if isinstance(got, tuple)
                 else ((got, ref),))
        err = 0
        for g, r in pairs:
            require(g.shape == r.shape and g.dtype == r.dtype,
                    'kernel %s %s, twin %s %s' % (tuple(g.shape), g.dtype,
                                                  tuple(r.shape), r.dtype))
            err = max(err, max_abs_err(g, r))
    else:
        err = max(max_abs_err(got[0], ref[0], live),
                  max_abs_err(got[1], ref[1]))
    require(err == 0, '%s disagrees with its twin (max abs err %d)'
            % (kernel.__name__, err))
    return err, got


def k1_calls(fn, args):
    """K1 as the staged batch runs it: (name, kernel, twin, args, kwargs)."""
    kw = fn.keywords
    S = kw['S'] if 'S' in kw else kw['lay'].S
    fixups = kw['fixups'] if 'fixups' in kw else kw['lay'].fixups
    k1_args = tuple(args[:5]) + (S,)
    if fixups == 0:
        return ('rans_decode_groups, octet (K1)', rd.decode_groups,
                rd.decode_groups_ref, k1_args, {})
    return ('rans_decode_groups, coarse, %s (K1)'
            % ('one fixup' if fixups == 1 else 'two fixups'),
            rd.decode_groups_coarse, rd.decode_groups_coarse_ref, k1_args,
            {'one_fixup': fixups == 1})


def k1_tables_call(parsed, fn, args):
    """The table builder as the staged batch ran it: (name, kernel, twin,
    args, kwargs), its inputs rebuilt from the parsed chunks by the
    pipeline's own helpers, after checking that the K1 tables the batch
    staged (built on the card) equal the host packer's rows bit for bit.
    None for a batch whose tables the host packed (a foreign table)."""
    kw = fn.keywords
    fixups = kw['fixups'] if 'fixups' in kw else kw['lay'].fixups
    if fixups:
        return None
    planes = [p for p, m in enumerate(parsed[0]['modes'])
              if m == ans_codec.MODE_RANS]
    B, G = len(parsed), len(parsed[0]['groups'])
    NG = max(B * G, 1)
    slots = pipeline.group_slots(B, G, B, kw.get('tail'))
    freqs, tbase = pipeline.freq_stack(parsed, planes)
    rows = pipeline.segment_tables(parsed, planes, slots, tbase, NG)
    lookup, dense, host_fixups = pipeline.host_tables(parsed, slots, NG)
    require(host_fixups == 0
            and np.array_equal(args[2].cpu().numpy(), lookup)
            and np.array_equal(args[3].cpu().numpy(), dense),
            'the K1 tables built on the card differ from the host packer\'s')
    t_args = (torch.from_numpy(freqs.view(np.int16)).to(DEVICE),
              torch.from_numpy(rows).to(DEVICE))
    return ('decode_tables (K1\'s tables)', rd.decode_tables,
            rd.decode_tables_ref, t_args, {})


def finalize_call(bulk, tail_block, heads, hi):
    """The finalize a fuse8 batch runs: (name, kernel, twin, args) of K2,
    or of K3 where the batch has a ragged-tail block."""
    if tail_block is None:
        return ('finalize_u8 (K2)', dd.cumsum_time_transposed_u8,
                dd.cumsum_time_transposed_u8_ref, (bulk, heads, hi))
    cA = bulk.shape[1]
    return ('finalize_u8, tail form (K3)', dd.cumsum_time_transposed_u8_tail,
            dd.cumsum_time_transposed_u8_tail_ref,
            (bulk, tail_block, heads[:, :cA], heads[:, cA:], hi))


def check_kernels(recs):
    """Phase c: every kernel form against its twin at the path's shapes,
    the layouts only the port fuses (``FUSE8_GEOMETRIES``) included.
    Returns ``{name: (kernel, twin, args, kwargs, err)}``, at the first
    batch that ran each form, and the staged batches kept for phases h
    and i."""
    calls, staged = {}, {}

    def record(name, kernel, twin, args, kwargs, live=None):
        err, out = compare(kernel, twin, args, kwargs, live)
        calls.setdefault(name, (kernel, twin, args, kwargs, err))
        return out

    def held(_name, kernel, twin, args, kwargs):
        # Compared, but not kept as the form's timed call.
        return compare(kernel, twin, args, kwargs)[1]

    for name in ('int16_385ch', 'int16_384ch', 'spiky_int16_385ch', 'int32',
                 'int64', 'float64_order2', 'foreign_1fixup',
                 'foreign_2fixups', 'order2_generic',
                 'raw_low_plane') + FUSE8_GEOMETRIES:
        T = recs[name].chunk
        r, parsed, fn, args = recs[name].staged()
        k1_name, kernel, twin, k1_args, k1_kw = k1_calls(fn, args)
        live = (torch.arange(k1_args[-1] * LANES, device=args[4].device)
                < args[4][:, :, None].long())
        syms, _used = record(k1_name, kernel, twin, k1_args, k1_kw, live)
        const_vals, raw_vals, heads = args[5], args[6], args[7]
        kw = fn.keywords
        done = [k1_name]
        tables = k1_tables_call(parsed, fn, args)
        if tables is not None:
            record(*tables)
            done.append('%s (= the host packer\'s rows)' % tables[0])
        if fn.func is _decode_fuse8:
            bulk, tail_block = fuse8_planes(syms, B=kw['B'], G=kw['G'],
                                            k=kw['k'], tp=kw['tp'],
                                            tail=kw['tail'])
            hi = const_vals[:, 0]
            key, kernel, twin, f_args = finalize_call(bulk, tail_block,
                                                      heads, hi)
            out = record(key, kernel, twin, f_args, {'n_samples': T})
            done.append(key)
            # The finalize is the plane form with a CONST high plane (its
            # two channel blocks joined here): two load stages, one result.
            C = heads.shape[1]
            lo = bulk[:, :C] if tail_block is None else torch.cat(
                [bulk, tail_block[:, :C - bulk.shape[1]]], dim=1)
            check_plane_form(held, (lo[:, :, :T - 1], hi), heads, True, out)
            done.append('K4 plane form (CONST high plane) = %s'
                        % key.split('(')[1][:2])
        else:
            lay = kw['lay']
            elems = generic_elems(syms, const_vals, raw_vals, lay)
            width = {4: 'int32', 8: 'int64'}.get(lay.itemsize, 'int16')
            ct = elems.view(lay.B, lay.C, lay.Tc)
            out = record('scan_transposed %s, head-seeded (K4)' % width,
                         dd.cumsum_time_transposed,
                         dd.cumsum_time_transposed_ref, (ct, heads),
                         {'n_samples': T})
            record('scan_transposed %s, inclusive (K4)' % width,
                   dd.cumsum_time_transposed, dd.cumsum_time_transposed_ref,
                   (ct,), {})
            # K5 at the shape of its order-2 pass: the K4 output.
            record('cumsum_time %s (K5)' % width, dd.cumsum_time,
                   dd.cumsum_time_ref, (out,), {})
            done.append('K4 both modes, K5 (%s)' % width)
            if lay.itemsize == 2:
                check_plane_form(record, staged_planes(
                    syms, const_vals, raw_vals, lay), heads, lay.zigzag, out)
                done.append('K4 plane form (%s%s) = combine + element form'
                            % ('+'.join(MODE_NAMES[m] for m in lay.modes),
                               ', K1\'s rows in place' if lay.plane_form
                               else ''))
        log('c. %s: B=%d S=%d route %s; %s equal their twins byte for '
            'byte' % (name, len(parsed), k1_args[-1], fn.func.__name__,
                      ', '.join(done)))
        staged[name] = (r, parsed, fn, args)
    decode_forms = {n for n, (key, _s, _r) in KERNELS.items()
                    if key != 'rans_encode'}
    require(set(calls) == decode_forms, 'the staged batches ran kernels %s, '
            'expected %s' % (sorted(calls), sorted(decode_forms)))
    return calls, staged


def staged_planes(syms, const_vals, raw_vals, lay):
    """The two byte planes of a staged 2-byte F-order batch as K4's plane
    form takes them: the route's own views where it takes the plane
    form, else the reassembled rANS planes (copies), the RAW plane's
    view and the CONST plane's values."""
    if lay.plane_form:
        return tuple(generic_planes(syms, const_vals, raw_vals, lay))
    coded = _rans_planes(syms, lay) if lay.planes(ans_codec.MODE_RANS) \
        else None
    planes = []
    for p, mode in enumerate(lay.modes):
        j = lay.planes(mode).index(p)
        if mode == ans_codec.MODE_RANS:
            planes.append(coded[:, j].view(lay.B, lay.C, lay.Tc))
        elif mode == ans_codec.MODE_RAW:
            planes.append(raw_vals[:, j].view(lay.B, lay.C, lay.Tc))
        else:
            planes.append(const_vals[:, j])
    return tuple(planes)


def check_plane_form(record, planes, heads, zigzag, want):
    """K4's plane form on a staged batch's planes: both modes against the
    twin, and the head-seeded one against ``want``, what the route's other
    kernels made of the same batch (the head and the coded samples)."""
    n_samples = next(p.shape[2] for p in planes if p.dim() == 3) + 1
    out = record('scan_transposed planes int16, head-seeded (K4)',
                 dd.cumsum_time_transposed_planes,
                 dd.cumsum_time_transposed_planes_ref, planes + (heads,),
                 {'n_samples': n_samples, 'zigzag': zigzag})
    require(torch.equal(out, want), 'K4\'s plane form differs from the '
            'route\'s other kernels on the same batch')
    record('scan_transposed planes int16, inclusive (K4)',
           dd.cumsum_time_transposed_planes,
           dd.cumsum_time_transposed_planes_ref, planes + (None,),
           {'zigzag': zigzag})


#: The kernel wrappers the decode pipeline calls, by the name it calls
#: them under, and each one's plain twin.
PIPELINE_TWINS = {
    'decode_tables': rd.decode_tables_ref,
    'decode_groups': rd.decode_groups_ref,
    'decode_groups_coarse': rd.decode_groups_coarse_ref,
    'cumsum_time': dd.cumsum_time_ref,
    'cumsum_time_transposed': dd.cumsum_time_transposed_ref,
    'cumsum_time_transposed_planes': dd.cumsum_time_transposed_planes_ref,
    'cumsum_time_transposed_u8': dd.cumsum_time_transposed_u8_ref,
    'cumsum_time_transposed_u8_tail': dd.cumsum_time_transposed_u8_tail_ref,
}


@contextlib.contextmanager
def held_against_twins(seen):
    """While open, every kernel call of the decode pipeline also runs the
    kernel's twin on the same card tensors and fails unless the two give
    the same bytes (K1: in the live symbol columns). The launch counters
    that moved are added to ``seen``."""
    def checked(name, kernel, twin):
        def call(*args, **kwargs):
            live = None
            if name.startswith('decode_groups'):
                counts, S = args[4], args[5]
                live = (torch.arange(S * LANES, device=counts.device)
                        < counts[:, :, None].long())
            before = mt.launch_counts()
            _err, got = compare(kernel, twin, args, kwargs, live)
            after = mt.launch_counts()
            seen.update(k for k in after if after[k] > before[k])
            return got
        call.__name__ = name
        return call

    kernels = {name: getattr(pipeline, name) for name in PIPELINE_TWINS}
    for name, twin in PIPELINE_TWINS.items():
        setattr(pipeline, name, checked(name, kernels[name], twin))
    try:
        yield
    finally:
        for name, kernel in kernels.items():
            setattr(pipeline, name, kernel)


def check_single_chunk_forms(recs):
    """Phase c, B=1: the first and the last chunk of every file the
    window paths read, each staged alone as a window stages it, decoded
    with every kernel call held against its twin at that shape, and
    compared with the source; every form of the window path was among
    them."""
    for path, (names, kernels) in WINDOW_PATHS.items():
        seen, n_chunks = set(), 0
        for name in names:
            rec, r = recs[name], recs[name].reader()
            try:
                for idx in sorted({0, r.n_chunks - 1}):
                    parsed = [r.codec.parse(_read_payload(r, idx))]
                    dec = DeviceBatchDecoder(r, DEVICE)
                    require(dec.supported(parsed, SR),
                            '%s: chunk %d not supported' % (name, idx))
                    with held_against_twins(seen):
                        out = dec.decode_tensor(parsed, SR)
                    require(out.cpu().numpy().tobytes()
                            == rec.arr[idx * SR:(idx + 1) * SR].tobytes(),
                            '%s: chunk %d staged alone differs from the '
                            'source' % (name, idx))
                    n_chunks += 1
            finally:
                r.close()
        require(set(kernels) <= seen, 'the %s files launched %s at B=1, '
                'expected %s among them' % (path, sorted(seen), kernels))
        log('c. B=1, %s: %d chunks of %s staged alone, byte-exact; %s equal '
            'their twins byte for byte at every call'
            % (path, n_chunks, ', '.join(names), ', '.join(sorted(seen))))


def check_scan_edge_cases():
    """Phase c, edge shapes: every form of K4 and K5 on every one of
    ``SCAN_EDGE_CASES``, against its twin (byte equality)."""
    n = 0
    for case in SCAN_EDGE_CASES:
        for label, kernel, twin, args, kwargs in scan_edge_calls(case,
                                                                 DEVICE):
            try:
                compare(kernel, twin, args, kwargs)
            except RuntimeError as e:
                raise RuntimeError('scan edge case %s, %s: %s'
                                   % (case, label, e)) from e
            n += 1
    log('c. %d scan edge shapes (T\' 1 to 131 and C 1 to 1025 around the '
        'segments and tiles, 40000 channels, channel slices, bases off the '
        '16-byte grid, short and head-extended outputs): %d calls of K4 '
        '(element form at int16, int32 and int64, plane form) and K5 '
        '(int16, int32, int64) equal their twins' % (len(SCAN_EDGE_CASES), n))


def check_finalize_edge_cases():
    """Phase c, edge shapes of the finalize: K2 or K3 on every one of
    ``FINALIZE_EDGE_CASES``, against its twin (byte equality)."""
    for case in FINALIZE_EDGE_CASES:
        kernel, twin, args, kwargs = finalize_edge_call(case, DEVICE)
        try:
            compare(kernel, twin, args, kwargs)
        except RuntimeError as e:
            raise RuntimeError('finalize edge case %s: %s' % (case, e)) from e
    n_tail = sum(1 for c in FINALIZE_EDGE_CASES.values() if c[2])
    log('c. %d finalize edge shapes (T\' 1 to 131; tails of 1, 7 and 33 '
        'channels behind 32, 37, 250 and 384 bulk channels; padded and '
        'unpadded rows, either block off the 16-byte grid, extra rows, '
        'short and head-extended outputs): %d calls of K3 and %d of K2 '
        'equal their twins' % (len(FINALIZE_EDGE_CASES), n_tail,
                               len(FINALIZE_EDGE_CASES) - n_tail))


def check_edge_cases():
    """Phase c, edge cases: every one of ``EDGE_CASES`` x ``REGION_ENDS``
    through K1 (all three forms) and K6 on the card, each held against
    its twin (byte equality) and against the normative coder (K1 decodes
    the normative encoder's streams to the source rows and reads every
    word; K6 gives its states, counts and streams)."""
    forms = (('octet', rd.decode_groups, rd.decode_groups_ref, 2, {}),
             ('coarse, one fixup', rd.decode_groups_coarse,
              rd.decode_groups_coarse_ref, 3, {'one_fixup': True}),
             ('coarse, two fixups', rd.decode_groups_coarse,
              rd.decode_groups_coarse_ref, 3, {'one_fixup': False}))
    for case in EDGE_CASES:
        rows, freqs, counts, steps = edge_groups(case)
        streams = [rans.rans_encode_group(g, freqs[n])
                   for n, g in enumerate(rows)]
        n_words = [w.size for _st, w in streams]
        for end in REGION_ENDS:
            k1_in = [t.to(DEVICE) for t in
                     edge_k1_inputs(rows, freqs, counts, streams, end)]
            live = (torch.arange(steps * LANES, device=k1_in[0].device)
                    < k1_in[5][:, :, None].long())
            for form, kernel, twin, table, kw in forms:
                args = (k1_in[0], k1_in[1], k1_in[table], k1_in[4],
                        k1_in[5], steps)
                _err, (syms, used) = compare(kernel, twin, args, kw, live)
                syms = syms.cpu().numpy()
                require(used.tolist() == n_words and all(
                    np.array_equal(syms[n, r, :row.size], row)
                    for n, group in enumerate(rows)
                    for r, row in enumerate(group)),
                    'edge case %s (%s): K1 %s differs from the normative '
                    'coder' % (case, end, form))
            k6_in, cap = edge_k6_inputs(rows, freqs, counts, steps, n_words,
                                        end)
            _err, (states, words, nw) = k6_compare(
                tuple(t.to(DEVICE) for t in k6_in) + (cap,))
            states, words = states.cpu().numpy(), words.cpu().numpy()
            require(nw.tolist() == n_words and all(
                np.array_equal(states[n].view(np.uint32), st)
                and np.array_equal(words[n, cap - w.size:].view(np.uint16), w)
                for n, (st, w) in enumerate(streams)),
                'edge case %s (%s): K6 differs from the normative coder'
                % (case, end))
        log('c. edge case %s: %d steps, %s words, regions %s: K1 (octet, '
            'one and two fixups) and K6 equal their twins and the normative '
            'coder' % (case, steps, n_words, REGION_ENDS))


def k6_compare(args):
    """K6 and its twin on the same staged inputs: (max_abs_err over the
    states, the word counts and each group's stream, kernel outputs)."""
    got = renc.encode_groups(*args)
    ref = renc.encode_groups_ref(*args)
    torch.cuda.synchronize()
    cap = args[4]
    live = (torch.arange(cap, device=args[0].device)[None, :]
            >= cap - ref[2][:, None].long())
    err = max(max_abs_err(got[0], ref[0]), max_abs_err(got[2], ref[2]),
              max_abs_err(got[1], ref[1], live))
    require(err == 0, 'rans_encode_groups disagrees with its twin (max abs '
            'err %d)' % err)
    return err, got


def check_encode_kernel(recs):
    """Phase c for K6: each 32-s file's first B=8 chunks through the
    device encode (payload 0 checked against the host codec), then K6
    held against its twin on the staged inputs. Returns ``{name:
    (encoder, staged chunks, K6 args, err)}``."""
    out = {}
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        w, chunks = recs[name].writer_batch()
        try:
            enc = DeviceBatchEncoder(w, device=DEVICE)
            x = torch.from_numpy(chunks).to(DEVICE)
            payloads = enc.encode_batch(x)
            host = w.codec.encode(w._transform_chunk(chunks[0]),
                                  order=w.chunk_order)
            require(payloads[0] == host, '%s: the device encode of chunk 0 '
                    'differs from the host codec\'s' % name)
            args = enc.last_kernel_args
            err, (_st, _w, nw) = k6_compare(args)
            log('c. %s: K6 on %d groups x %d steps, %d words, equals its '
                'twin (states, counts, streams); payload 0 equals the host '
                'codec\'s' % (name, args[0].shape[0], args[0].shape[2] //
                                LANES, int(nw.sum())))
            out[name] = (enc, x, args, err)
        finally:
            w.close()
    return out


def drive_encode_paths(recs):
    """Phase k, path by path: counts set to 0 just before each path and
    read just after. Returns (compress() seconds by file, counts by
    path)."""
    times, counts_by_path = {}, {}
    for path, (names, kernels) in ENCODE_PATHS.items():
        mt.reset_launch_counts()
        for name in names:
            dt, n_host, _n_chunks = recs[name].device_compress()
            require(n_host == 0, '%s: %d chunks went to the host codec'
                    % (name, n_host))
            times[name] = {'device_s': dt,
                           'host_s': recs[name].host_compress_s}
        torch.cuda.synchronize()
        counts = mt.launch_counts()
        counts_by_path[path] = counts
        log('k. launch counts over the %s path: %s'
            % (path, json.dumps(counts)))
        for key in kernels:
            require(counts[key] > 0, 'kernel %s never launched on the %s '
                    'path' % (key, path))
        require(counts['host_encoded_chunks'] == 0,
                '%d chunks went to the host codec on the %s path'
                % (counts['host_encoded_chunks'], path))
    return times, counts_by_path


def encode_layers(rec):
    """compress() of a whole 32-s file by layer, host clock, one Writer
    batch (8 chunks) at a time as its device route runs them: seconds of
    the program's spans (``utils/trace.py``, on for this pass alone),
    ``write.read`` (the memmapped chunks, read here) and the encoder's
    (``write.upload``, ``encode.*``, ``write.decide``, ``write.assemble``),
    with one synchronize after each batch. Write-back, hashing and the
    sidecar are not in it."""
    w, _ = rec.writer_batch(1)
    trace.enable_tracing()
    trace.reset_stats()
    try:
        enc = DeviceBatchEncoder(w, device=DEVICE)
        t_all = time.perf_counter()
        for b0 in range(0, w.n_chunks, BATCH):
            with trace.phase('write.read'):
                chunks = np.stack([np.asarray(w.get_chunk(i)) for i in
                                   range(b0, min(b0 + BATCH, w.n_chunks))])
            enc.encode_batch(chunks)
            torch.cuda.synchronize()
        total = time.perf_counter() - t_all
        spans = {k: v[1] for k, v in trace.phase_stats().items()}
    finally:
        trace.enable_tracing(False)
        trace.reset_stats()
        w.close()
    return dict(spans, total_s=total, raw_mb=rec.arr.nbytes / 1e6)


def time_encode(encoded):
    """Phase i, encode: K6 on the staged B=8 inputs and the staged
    device encode (the batch on the card), CUDA events, median of
    REPS; GB/s of raw input."""
    out = {}
    for name, (enc, x, args, _err) in encoded.items():
        raw = x.numel() * x.element_size()
        k6 = cuda_ms(lambda: renc.encode_groups(*args), REPS)
        full = cuda_ms(lambda: enc.encode_batch(x), REPS)
        out[name] = {'batch_chunks': x.shape[0], 'k6_ms': k6,
                     'k6_gbps': raw / 1e6 / k6, 'encode_ms': full,
                     'encode_gbps': raw / 1e6 / full}
        log('i. staged encode %s, B=%d: K6 %.4f ms (%.3f GB/s of raw '
            'input), device encode %.3f ms (%.3f GB/s)'
            % (name, x.shape[0], k6, raw / 1e6 / k6, full, raw / 1e6 / full))
    return out


def decode_through_reader(rec, with_tensor=False):
    """Main path: decompress(...).to_array() and .tofile(), byte-exact."""
    r = rec.reader()
    try:
        t0 = time.perf_counter()
        got = r.to_array()
        t1 = time.perf_counter()
        require(np.array_equal(got, rec.arr), '%s: to_array() differs '
                'from the source' % rec.name)
        del got
        out = rec.workdir / (rec.name + '.decoded.bin')
        t2 = time.perf_counter()
        r.tofile(out)
        t3 = time.perf_counter()
        back = np.fromfile(out, dtype=rec.arr.dtype).reshape(rec.arr.shape)
        require(np.array_equal(back, rec.arr), '%s: tofile() differs '
                'from the source' % rec.name)
        del back
        out.unlink()
        if with_tensor:
            t = r.to_tensor()
            require(t.device.type == DEVICE, 'to_tensor left the card')
            # A uint64 file gives a torch.uint64 view: compared as bits.
            require(t.dtype == pipeline._torch_dtype(rec.arr.dtype)
                    and t.cpu().view(pipeline._BITS[t.element_size()][0])
                    .numpy().tobytes() == rec.arr.tobytes(),
                    '%s: to_tensor() differs from the source' % rec.name)
            del t
        log('e. %s: to_array %.3f s, tofile %.3f s (host clock, %d chunks)'
            ', byte-exact' % (rec.name, t1 - t0, t3 - t2, r.n_chunks))
        return {'to_array_s': t1 - t0, 'tofile_s': t3 - t2}
    finally:
        r.close()


def drive_paths(recs):
    """Phases e-g, path by path: counts set to 0 just before each path
    and read just after. Returns (end-to-end times, counts by path)."""
    end_to_end, counts_by_path = {}, {}
    for path, (names, kernels, never) in PATHS.items():
        mt.reset_launch_counts()
        for name in names:
            end_to_end[name] = decode_through_reader(
                recs[name],
                with_tensor=RECORDINGS[name][1] == SECONDS or name in WIDE)
        torch.cuda.synchronize()
        counts = mt.launch_counts()
        counts_by_path[path] = counts
        log('f. launch counts over the %s path: %s'
            % (path, json.dumps(counts)))
        for key in kernels:
            require(counts[key] > 0, 'kernel %s never launched on the %s '
                    'path' % (key, path))
        for key in never:
            require(counts[key] == 0, 'kernel %s launched on the %s path'
                    % (key, path))
        require(counts['host_fallback_chunks'] == 0,
                '%d chunks fell back to the host codec on the %s path'
                % (counts['host_fallback_chunks'], path))
    return end_to_end, counts_by_path


def check_small_geometries(workdir):
    """The CPU tests' geometries (a 129-channel ragged tail at 4-channel
    segments, 128 uniform channels, 40 uint16 channels in one row),
    decoded on the card and through the twins: both byte-exact."""
    for C, T, n, dtype, opts in [(129, 1000, 4, 'int16', {'ans_seg_log2': 12}),
                                 (128, 1000, 2, 'int16', {'ans_seg_log2': 12}),
                                 (40, 300, 4, 'uint16', {})]:
        rng = np.random.default_rng(C)
        arr = np.cumsum(rng.normal(0.0, 5.0, size=(n * T, C)),
                        axis=0).astype(np.int16).astype(dtype)
        raw, cbin, ch = (workdir / ('small' + ext)
                         for ext in ('.bin', '.cbin', '.ch'))
        arr.tofile(raw)
        mt.compress(raw, cbin, ch, sample_rate=float(T), n_channels=C,
                    dtype=dtype, algorithm='ans', quiet=True,
                    check_after_compress=False, device='none', **opts)
        for device in (DEVICE, 'cpu'):
            r = mt.decompress(cbin, ch, device=device, quiet=True,
                              check_after_decompress=False)
            try:
                require(np.array_equal(r.to_array(), arr), '%d ch x %d %s: '
                        'decode on %s differs from the source'
                        % (C, T, dtype, device))
            finally:
                r.close()
        log('c. %d ch x %d samples x %d chunks %s: byte-exact on the card '
            'and through the twins' % (C, T, n, dtype))


def check_audit(staged):
    """Phase h: reads past a group's stream return zeros, the count goes
    on, and the audit raises -- on the fuse8 and the generic route."""
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        r, parsed, _fn, _args = staged[name]
        for what, cut in (('one dropped word', lambda w: w[:-1]),
                          ('half the words dropped',
                           lambda w: w[:w.size // 2])):
            bad = [dict(p) for p in parsed]
            j = min(3, len(bad) - 1)
            groups = [dict(g) for g in bad[j]['groups']]
            groups[0]['words'] = cut(groups[0]['words'])
            bad[j]['groups'] = groups
            try:
                DeviceBatchDecoder(r, DEVICE).decode_batch(bad, SR)
            except IOError as e:
                log('h. %s, %s -> IOError: %s' % (name, what, e))
            else:
                raise RuntimeError('%s: %s passed the word audit'
                                   % (name, what))


# --- random-access windows, multi-probe, bounded batches, tools -----------

def kernel_launches():
    """(launches of every kernel form so far, K1's alone)."""
    counts = {k: v for k, v in mt.launch_counts().items()
              if not k.startswith('host_')}
    return (sum(counts.values()),
            sum(v for k, v in counts.items() if k.startswith('rans_decode')))


def lru_after(order, capacity, ids):
    """An LRU of ``capacity`` entries, oldest first in ``order``, after it
    served ``ids`` in turn: (misses, new order)."""
    order, misses = list(order), 0
    for i in ids:
        if i in order:
            order.remove(i)
        else:
            misses += 1
        order.append(i)
        del order[:-capacity]
    return misses, order


def window_exprs(ns, n_chunks):
    """Index expressions of phase w: inside one chunk, across two (and
    three where the file has four), the first and last samples, a step
    of 3, one row, everything."""
    exprs = [slice(SR // 3, SR // 3 + 5000), slice(SR - 50, SR + 50),
             slice(0, 1), slice(ns - 1, ns), slice(100, SR + 100, 3),
             ns // 2 + 7, slice(None)]
    if n_chunks >= 4:
        exprs.insert(2, slice(2 * SR - 10, 3 * SR + 10))
    return exprs


def read_windows(rec):
    """Phase w on one recording: every window byte for byte against the
    source, one K1 launch per chunk the cache did not hold (a model LRU
    run beside the reader's), no launch at all on a second read."""
    r = rec.reader(cache_size=WINDOW_CACHE)
    try:
        ns, n_reads = r.n_samples, 0
        for expr in window_exprs(ns, r.n_chunks):
            if isinstance(expr, slice):
                i0, i1, _step = expr.indices(ns)
            else:
                i0, i1 = expr, expr + 1
            first, last = r._chunks_for_interval(i0, i1 - 1)
            ids = list(range(first, last + 1))
            cache = r._dev_cache
            misses, order = lru_after(list(cache._cache) if cache else [],
                                      WINDOW_CACHE, ids)
            total0, k1_0 = kernel_launches()
            got = r[expr]
            total1, k1_1 = kernel_launches()
            require(got.dtype == rec.arr.dtype
                    and np.array_equal(got, rec.arr[expr]),
                    '%s: window %s differs from the source'
                    % (rec.name, expr))
            require(k1_1 - k1_0 == misses, '%s: window %s launched K1 %d '
                    'times for %d uncached chunks'
                    % (rec.name, expr, k1_1 - k1_0, misses))
            require(list(r._dev_cache._cache) == order
                    and len(order) <= WINDOW_CACHE,
                    '%s: the cache holds chunks %s after window %s, its '
                    'model %s' % (rec.name, list(r._dev_cache._cache), expr,
                                  order))
            if len(ids) <= WINDOW_CACHE:
                again = r[expr]
                require(np.array_equal(again, got) and again is not got,
                        '%s: the second read of window %s differs'
                        % (rec.name, expr))
                require(kernel_launches()[0] == total1, '%s: the second '
                        'read of window %s launched a kernel'
                        % (rec.name, expr))
            n_reads += 1
        if r.n_chunks > WINDOW_CACHE:
            require(len(r._dev_cache._cache) == WINDOW_CACHE, '%s: the cache '
                    'holds %d chunks, its size is %d'
                    % (rec.name, len(r._dev_cache._cache), WINDOW_CACHE))
        on_card = {t.device.type for t, _ in r._dev_cache._cache.values()}
        require(on_card == {torch.device(DEVICE).type},
                '%s: cached chunks on %s' % (rec.name, on_card))
    finally:
        r.close()
    require(r._dev_cache is None, 'close() kept the window cache')
    return n_reads


def drive_window_paths(recs):
    """Phase w, path by path: counts set to 0 just before each path and
    read just after. Returns the counts by path."""
    counts_by_path = {}
    for path, (names, kernels) in WINDOW_PATHS.items():
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        n_reads = sum(read_windows(recs[name]) for name in names)
        torch.cuda.synchronize()
        counts = mt.launch_counts()
        counts_by_path[path] = counts
        log('w. %s: %d windows of %s byte-exact in %.1f s; launch counts: %s'
            % (path, n_reads, ', '.join(names), time.perf_counter() - t0,
               json.dumps(counts)))
        for key in kernels:
            require(counts[key] > 0, 'kernel %s never launched on the %s '
                    'path' % (key, path))
        require(counts['host_fallback_chunks'] == 0,
                '%d chunks fell back to the host codec on the %s path'
                % (counts['host_fallback_chunks'], path))
    return counts_by_path


def check_window_audit(recs):
    """Phase w, audit: a group that lost a word, read through a window,
    raises the word audit's IOError and leaves nothing in the cache."""
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        r = recs[name].reader()
        parse = r.codec.parse

        def dropping_a_word(payload):
            parsed = dict(parse(payload))
            groups = [dict(g) for g in parsed['groups']]
            groups[0]['words'] = groups[0]['words'][:-1]
            parsed['groups'] = groups
            return parsed

        r.codec.parse = dropping_a_word
        try:
            r[SR + 10:SR + 20]
        except IOError as e:
            require(not r._dev_cache._cache, 'a corrupt chunk was cached')
            log('w. %s, one dropped word read through a window -> IOError: '
                '%s' % (name, e))
        else:
            raise RuntimeError('%s: a dropped word passed the window\'s '
                               'word audit' % name)
        finally:
            r.close()


def check_multi(workdir, recs):
    """Phase m: four probes (the four 8-s stretches of the 32-s walk, 385
    ch) through ``decompress_multi``: one merged batch (one K1 launch),
    every probe byte-exact; with a probe of another dtype among them, the
    per-reader fallback, byte-exact too."""
    kwargs = dict(sample_rate=float(SR), n_channels=385, dtype='int16',
                  algorithm='ans', quiet=True, check_after_compress=False,
                  **ORDER1)
    walk = recs['int16_385ch'].arr
    arrs, readers = [], []
    try:
        for i in range(4):
            raw, cbin, ch = (workdir / ('probe%d%s' % (i, ext))
                             for ext in ('.bin', '.cbin', '.ch'))
            arrs.append(walk[i * SHORT_SECONDS * SR:
                             (i + 1) * SHORT_SECONDS * SR])
            arrs[i].tofile(raw)
            mt.compress(raw, cbin, ch, device='none', **kwargs)
            raw.unlink()
            readers.append(mt.decompress(cbin, ch, device=DEVICE, quiet=True,
                                         check_after_decompress=False))
        mt.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mt.decompress_multi(readers)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = mt.launch_counts()
        require(all(np.array_equal(o, a) for o, a in zip(outs, arrs)),
                'decompress_multi differs from the sources')
        require(kernel_launches()[1] == 1 and counts['finalize_u8_tail'] == 1,
                'decompress_multi launched %s, expected one merged batch'
                % json.dumps(counts))
        require(counts['host_fallback_chunks'] == 0,
                'decompress_multi sent chunks to the host codec')
        del outs
        # A probe of another dtype: no shared decode identity.
        other = recs['uint16_385ch']
        readers.append(other.reader())
        mt.reset_launch_counts()
        outs = mt.decompress_multi(readers[1:])
        require(all(np.array_equal(o, a) for o, a in
                    zip(outs, arrs[1:] + [other.arr])),
                'decompress_multi\'s fallback differs from the sources')
        require(kernel_launches()[1] == 4, 'the fallback launched K1 %d '
                'times for 4 readers' % kernel_launches()[1])
        log('m. decompress_multi: 4 probes x %d chunks in one batch, %.3f s '
            '(host clock), byte-exact; with a uint16 probe among them the '
            'per-reader fallback, byte-exact' % (SHORT_SECONDS, dt))
        return {'probes': 4, 'chunks_each': SHORT_SECONDS, 'merged_s': dt}
    finally:
        for r in readers:
            r.close()


def multi_probes(workdir, recs):
    """Phase m's four probes, opened again on the card, and their
    sources."""
    readers = [mt.decompress(workdir / ('probe%d.cbin' % i),
                             workdir / ('probe%d.ch' % i), device=DEVICE,
                             quiet=True, check_after_decompress=False)
               for i in range(4)]
    walk = recs['int16_385ch'].arr
    n = SHORT_SECONDS * SR
    return readers, [walk[i * n:(i + 1) * n] for i in range(4)]


def check_sharded(workdir, recs):
    """Phase s: ``chunk_mesh()`` over the visible cards; ``decompress_multi
    (mesh=)`` on phase m's four probes, ``decode_batch(mesh=)`` on a walk,
    a spiky and a 384-channel batch and ``encode_batch(mesh=)`` on a spiky
    batch, counts set to 0 just before each and read just after: byte-
    exact against the sources and the host codec, K1 (K6) once a shard,
    each timed against its unsharded call (host clock with a synchronize,
    in turns). Returns (timings, counts of the sharded calls)."""
    mesh = chunk_mesh()
    width = len(mesh)
    out = {'width': width, 'devices': [str(d) for d in mesh]}
    counts_all = dict.fromkeys(mt.launch_counts(), 0)

    def sharded_call(label, fn, k_key, want):
        """Run ``fn`` (the sharded call) with the counts set to 0, hold
        its launches of ``k_key`` to one a shard; returns its result."""
        mt.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        counts = mt.launch_counts()
        require(counts[k_key] == want, '%s launched %s %d times on a mesh '
                'of %d, expected %d' % (label, k_key, counts[k_key], width,
                                        want))
        require(counts['host_fallback_chunks'] == 0
                and counts['host_encoded_chunks'] == 0,
                '%s sent chunks to the host codec' % label)
        for k, v in counts.items():
            counts_all[k] += v
        return got

    def turns(sharded, plain, reps=4):
        """Host-clock ms of the sharded and the unsharded call, median of
        ``reps``, in turns (plain, sharded, sharded, plain, ...)."""
        times = {'sharded_ms': [], 'plain_ms': []}
        for i in range(2 * reps):
            key = 'plain_ms' if i % 4 in (0, 3) else 'sharded_ms'
            fn = plain if key == 'plain_ms' else sharded
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0))
        return {k: float(np.median(v)) for k, v in times.items()}

    readers, arrs = multi_probes(workdir, recs)
    try:
        outs = sharded_call(
            'decompress_multi', lambda: mt.decompress_multi(readers,
                                                            mesh=mesh),
            'rans_decode_octet', width)
        require(all(np.array_equal(o, a) for o, a in zip(outs, arrs)),
                'decompress_multi(mesh=) differs from the sources')
        del outs
        out['decompress_multi'] = dict(turns(
            lambda: mt.decompress_multi(readers, mesh=mesh),
            lambda: mt.decompress_multi(readers), reps=2),
            chunks=4 * SHORT_SECONDS)
    finally:
        for r in readers:
            r.close()
    B = width * max(1, BATCH // width)
    for name in ('int16_385ch', 'spiky_int16_385ch', 'int16_384ch'):
        rec = recs[name]
        r = rec.reader()
        try:
            parsed = [r.codec.parse(_read_payload(r, i)) for i in range(B)]
            dec = DeviceBatchDecoder(r, DEVICE)
            got = sharded_call('decode_batch(mesh=) of %s' % name,
                               lambda: dec.decode_batch(parsed, SR,
                                                        mesh=mesh),
                               'rans_decode_octet', width)
            require(np.array_equal(got.reshape(-1, rec.arr.shape[1]),
                                   rec.arr[:B * SR]),
                    '%s: decode_batch(mesh=) differs from the source' % name)
            del got
            out['decode_batch ' + name] = dict(turns(
                lambda: dec.decode_batch(parsed, SR, mesh=mesh),
                lambda: dec.decode_batch(parsed, SR)), chunks=B)
        finally:
            r.close()
    rec = recs['spiky_int16_385ch']
    w, x = rec.writer_batch(B)
    try:
        enc = DeviceBatchEncoder(w, device=DEVICE)
        got = sharded_call('encode_batch(mesh=)',
                           lambda: enc.encode_batch(x, mesh=mesh),
                           'rans_encode', width)
        host = [w.codec.encode(w._transform_chunk(c), order=w.chunk_order)
                for c in x]
        require(got == host, 'encode_batch(mesh=) differs from the host '
                'codec')
        out['encode_batch spiky_int16_385ch'] = dict(turns(
            lambda: enc.encode_batch(x, mesh=mesh),
            lambda: enc.encode_batch(x)), chunks=B)
    finally:
        w.close()
    log('s. mesh of %d card(s) %s: decompress_multi (4 probes x %d chunks), '
        'decode_batch of the walk, the spiky walk and the 384-ch walk and '
        'encode_batch of the spiky walk (B=%d) byte-exact, K1 / K6 once a '
        'shard; host clock, sharded against unsharded: %s%s'
        % (width, out['devices'], SHORT_SECONDS, B, json.dumps(rounded(
            {k: v for k, v in out.items() if isinstance(v, dict)})),
           ' (width 1: not a multi-GPU number)' if width == 1 else ''))
    return out, counts_all


#: A fresh process's first device decode (phase p): the port imported,
#: a reader opened on the card, then one uncached window timed (CUDA
#: context, the kernel library's load, the first allocations and the
#: decode), then the same window uncached again.
FIRST_CALL_CHILD = """
import hashlib, json, sys, time
import torch
import mtscomp_tpu_torch as mt
cbin, ch, a, n = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
r = mt.decompress(cbin, ch, device='cuda', quiet=True,
                  check_after_decompress=False)
t0 = time.perf_counter()
win = r[a:a + n]
torch.cuda.synchronize()
t1 = time.perf_counter()
r._dev_cache.clear()
t2 = time.perf_counter()
again = r[a:a + n]
torch.cuda.synchronize()
t3 = time.perf_counter()
print('FIRST ' + json.dumps({
    'first_s': t1 - t0, 'again_s': t3 - t2,
    'sha1': hashlib.sha1(win.tobytes()).hexdigest(),
    'same': bool((win == again).all()), 'k1': mt.launch_counts()[
        'rans_decode_octet']}), flush=True)
"""


def first_call(workdir, rec):
    """Phase p: the first-call cost in a fresh child process, kernels
    already built (its HOME the work directory)."""
    a, n = WINDOWS['1s']
    env = dict(os.environ, HOME=str(workdir),
               PYTHONPATH=str(Path(__file__).resolve().parent))
    proc = subprocess.run(
        [sys.executable, '-c', FIRST_CALL_CHILD, str(rec.cbin), str(rec.ch),
         str(a), str(n)], cwd=str(workdir), env=env, capture_output=True,
        text=True, timeout=300)
    require(proc.returncode == 0 and 'FIRST ' in proc.stdout,
            'the first-call child failed (%d): %s'
            % (proc.returncode, proc.stderr[-2000:]))
    got = json.loads(proc.stdout.split('FIRST ', 1)[1])
    require(got['sha1'] == hashlib.sha1(rec.arr[a:a + n].tobytes())
            .hexdigest() and got['same'] and got['k1'] == 2,
            'the first-call child read a wrong window: %s' % got)
    return got


def auto_reads(recs, label):
    """'auto' on the card's machine: compress() of the 32-s walk,
    to_array() of both 32-s files and the three ``WINDOWS`` of each,
    uncached. Each decision is read first, then the call runs with the
    counts set to 0: K6 (K1) launched if and only if the decision said
    card, every byte the source's or the host route's."""
    out, total = {}, dict.fromkeys(mt.launch_counts(), 0)

    def tally():
        for k, v in mt.launch_counts().items():
            total[k] += v

    rec = recs['int16_385ch']
    w = mt.Writer(device='auto', **{k: v for k, v in rec.kwargs.items()
                                    if k not in ('sample_rate', 'n_channels',
                                                 'dtype')})
    w.open(rec.raw, sample_rate=float(SR), n_channels=385, dtype='int16')
    card = w._use_device()
    w.close()
    cbin = rec.workdir / 'auto.cbin'
    ch = rec.workdir / 'auto.ch'
    mt.reset_launch_counts()
    mt.compress(rec.raw, cbin, ch, device='auto', **rec.kwargs)
    torch.cuda.synchronize()
    k6 = mt.launch_counts()['rans_encode']
    tally()
    require(cbin.read_bytes() == rec.cbin.read_bytes()
            and ch.read_bytes() == rec.ch.read_bytes(),
            '%s: compress(device=auto) differs from the host route' % label)
    require((k6 > 0) == card, '%s: compress said %s and launched K6 %d '
            'times' % (label, 'card' if card else 'host', k6))
    cbin.unlink()
    out['compress int16_385ch'] = card
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        rec = recs[name]
        r = rec.reader(device='auto', cache_size=WINDOW_CACHE)
        try:
            card = r._use_device()
            mt.reset_launch_counts()
            require(np.array_equal(r.to_array(), rec.arr),
                    '%s: to_array() of %s differs' % (label, name))
            k1 = kernel_launches()[1]
            tally()
            require((k1 > 0) == card, '%s: to_array() of %s said %s and '
                    'launched K1 %d times' % (label, name,
                                              'card' if card else 'host', k1))
            out['to_array ' + name] = card
            for wlabel, (a, n) in WINDOWS.items():
                card = r._use_device(window=(a, a + n))
                if r._dev_cache is not None:
                    r._dev_cache.clear()
                r.read_chunk.cache_clear()
                mt.reset_launch_counts()
                require(np.array_equal(r[a:a + n], rec.arr[a:a + n]),
                        '%s: the %s window of %s differs'
                        % (label, wlabel, name))
                k1 = kernel_launches()[1]
                tally()
                require(k1 == (1 if card else 0), '%s: the %s window of %s '
                        'said %s and launched K1 %d times'
                        % (label, wlabel, name, 'card' if card else 'host',
                           k1))
                out['window %s %s' % (wlabel, name)] = card
        finally:
            r.close()
    log('p. %s: %s' % (label, json.dumps({k: 'card' if v else 'host'
                                          for k, v in out.items()})))
    return out, total


def auto_against_routes(auto, compress_s, routes_s, windows_ms):
    """Phase p's decisions beside the route times phases k and i measured
    in this run (a log line, not a check: timing agreement would be
    flaky). Returns {call: {'auto': ..., 'gate_open': ..., 'card': time,
    'host': time}}."""
    out = {}
    for call, card in auto['decisions'].items():
        kind, _sep, rest = call.partition(' ')
        if kind == 'compress':
            times = (compress_s[rest]['device_s'], compress_s[rest]['host_s'])
        elif kind == 'to_array':
            times = tuple(float(np.median(routes_s[rest][k]))
                          for k in ('device_s', 'host_s'))
        else:
            label, name = rest.split(' ')
            times = tuple(windows_ms[name]['%s_%s' % (label, route)]
                          ['uncached_ms'] / 1e3 for route in ('device',
                                                              'host'))
        out[call] = {'auto': 'card' if card else 'host',
                     'gate_open': 'card' if auto['decisions_gate_open'][call]
                     else 'host', 'card_s': times[0], 'host_s': times[1]}
    log('p. auto decisions beside the routes measured in this run (s; '
        'to_array a median of 2, windows uncached): %s'
        % json.dumps(rounded(out)))
    return out


def check_auto(workdir, recs):
    """Phase p: the link and host profiles measured afresh, the first-call
    cost, and the 'auto' decisions with the port's constants and with the
    size gate open (the profiles alone deciding), each read and write
    byte-exact with K1/K6 launched where the decision said card."""
    t0 = time.perf_counter()
    link = pipeline.link_profile(refresh=True, device=DEVICE)
    t1 = time.perf_counter()
    host = pipeline.host_profile(refresh=True)
    t2 = time.perf_counter()
    cores = os.cpu_count()
    first = first_call(workdir, recs['int16_385ch'])
    pool_rate = host[1] * min(cores, mt.api.HOST_POOL_SCALING_CORES)
    out = {'link_profile': {'latency_s': link[0], 'bytes_per_s': link[1],
                            'probe_s': t1 - t0},
           'host_profile': {'encode_bytes_per_s': host[0],
                            'decode_bytes_per_s': host[1],
                            'probe_s': t2 - t1},
           'cpu_count': cores, 'first_call': first,
           'host_pool_bytes_in_first_call': pool_rate * first['first_s'],
           'AUTO_DEVICE_MIN_BYTES': mt.api.AUTO_DEVICE_MIN_BYTES}
    log('p. link_profile: sync %.4f ms, fetch %.1f MB/s (probe %.3f s); '
        'host_profile: encode %.1f MB/s, decode %.1f MB/s a core (probe '
        '%.3f s); %d CPUs; a fresh process\'s first device decode (a 1-s '
        'window, kernels built) %.3f s, again %.4f s: the host pool decodes '
        '%.1f MB in that time (AUTO_DEVICE_MIN_BYTES %d)'
        % (link[0] * 1e3, link[1] / 1e6, t1 - t0, host[0] / 1e6,
           host[1] / 1e6, t2 - t1, cores, first['first_s'], first['again_s'],
           out['host_pool_bytes_in_first_call'] / 1e6,
           mt.api.AUTO_DEVICE_MIN_BYTES))
    counts = {}
    out['decisions'], counts['auto'] = auto_reads(recs, 'auto')
    gate = mt.api.AUTO_DEVICE_MIN_BYTES
    mt.api.AUTO_DEVICE_MIN_BYTES = 0
    try:
        out['decisions_gate_open'], counts['auto_gate_open'] = auto_reads(
            recs, 'auto, size gate open')
    finally:
        mt.api.AUTO_DEVICE_MIN_BYTES = gate
    return out, counts


def check_bounded_batches(rec):
    """F3: ``to_array()`` of a 32-s file as one batch (the default bound
    keeps it whole) and with ``batch_chunks=8`` (four batches): the same
    bytes, K1 launched once a batch; peak device memory of both."""
    out = {}
    for label, kwargs, batches in (
            ('one_batch', {}, 1),
            ('batch_chunks_%d' % BATCH, {'batch_chunks': BATCH},
             SECONDS // BATCH)):
        r = rec.reader(**kwargs)
        try:
            mt.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = r.to_array()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            k1 = kernel_launches()[1]
            require(np.array_equal(got, rec.arr), '%s: to_array() in %d '
                    'batches differs from the source' % (rec.name, batches))
            require(k1 == batches, '%s: to_array() launched K1 %d times, '
                    'expected %d batches' % (rec.name, k1, batches))
            del got
        finally:
            r.close()
        out[label] = {'batches': batches, 'to_array_s': dt,
                      'peak_device_bytes': peak}
        log('F3. %s to_array(), %s: %d K1 launches, %.3f s (host clock), '
            'peak device memory %.1f MB above the %.1f MB held before'
            % (rec.name, label, k1, dt, peak / 1e6, base / 1e6))
    return out


#: What the child of phase t runs: each command line it is given through
#: ``python -m mtscomp_tpu_torch.cli`` as ``runpy`` runs it, one after the
#: other in one process (a process takes longer to reach the card than a
#: command takes), reporting after each its exit code, which modules the
#: process has loaded and what the command launched.
CLI_CHILD = """
import json, runpy, sys, time
import mtscomp_tpu_torch as mt
for argv in json.loads(sys.argv[1]):
    mt.reset_launch_counts()
    sys.argv = ['mtscomp_tpu_torch.cli'] + argv
    t0, rc = time.perf_counter(), 0
    try:
        runpy.run_module('mtscomp_tpu_torch.cli', run_name='__main__',
                         alter_sys=True)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    print('\\nCHILD ' + json.dumps({
        'rc': rc, 'seconds': time.perf_counter() - t0,
        'loaded': sorted(m for m in sys.modules if m.split('.')[0]
                         in ('jax', 'jaxlib', 'mtscomp_tpu')),
        'counts': mt.launch_counts()}), flush=True)
"""


def run_cli(workdir, commands):
    """The port's CLI in one fresh process (its HOME the work directory:
    no user configuration): ``commands`` is a list of ``(argv, exit code
    wanted)``. Returns ``[(stdout, launch counts)]``, one for each
    command; fails on another exit code or if the process loaded JAX or
    the JAX package."""
    env = dict(os.environ, HOME=str(workdir),
               PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-c', CLI_CHILD,
         json.dumps([argv for argv, _rc in commands])],
        cwd=str(workdir), env=env, capture_output=True, text=True,
        timeout=600)
    pieces = proc.stdout.split('\nCHILD ')
    require(proc.returncode == 0 and len(pieces) == len(commands) + 1,
            'the CLI process ended with code %d after %d of %d commands: %s'
            % (proc.returncode, len(pieces) - 1, len(commands),
               proc.stderr[-2000:]))
    # A piece after the first is a command's report line, then the next
    # command's output.
    tails = [piece.partition('\n') for piece in pieces[1:]]
    stdouts = [pieces[0]] + [tail for _report, _nl, tail in tails]
    out = []
    for (argv, want_rc), stdout, (report, _nl, _tail) in zip(
            commands, stdouts, tails):
        child = json.loads(report)
        name = ' '.join(a if len(a) < 24 else Path(a).name for a in argv)
        require(child['rc'] == want_rc, '%s exited with code %d, expected '
                '%d: %s' % (name, child['rc'], want_rc, proc.stderr[-2000:]))
        require(not child['loaded'], '%s loaded %s' % (name, child['loaded']))
        log('t. %s: exit code %d in %.1f s, no JAX module loaded; launched '
            '%s' % (name, child['rc'], child['seconds'], json.dumps(
                {k: v for k, v in child['counts'].items() if v})))
        out.append((stdout, child['counts']))
    log('t. %d commands in one process, %.1f s with its start'
        % (len(commands), time.perf_counter() - t0))
    return out


def check_tools(workdir, recs):
    """Phase t: the tool layer on the card, each command through
    ``python -m mtscomp_tpu_torch.cli`` with ``--device cuda`` on an 8-s
    file; then a live stream written, resumed and tailed."""
    rec = recs['int16_384ch']
    src = rec.arr
    meta = ['-d', 'int16', '-s', str(SR), '-n', '384', '-a', 'ans',
            '--diff-order', '1', '--spatial-diff', '0', '-nc']
    on_card = ['--device', DEVICE]
    t = {ext: str(workdir / ('tool' + ext)) for ext in
         ('.cbin', '.ch', '.bin', '.win.bin', '.chop.cbin', '.z.cbin',
          '.a.cbin', '.host.cbin', '.parts.cbin', '.parts.ch',
          '.merged.cbin', '.flip.cbin', '.flip.ch')}
    blob = bytearray(rec.cbin.read_bytes())
    blob[len(blob) // 2] ^= 0x20
    Path(t['.flip.cbin']).write_bytes(bytes(blob))
    shutil.copy(rec.ch, t['.flip.ch'])
    a, b = SR - 1000, 2 * SR + 1000
    half = src.shape[0] // SR // 2
    parts = [str(workdir / ('part_%06d_%06d.cbin' % (i * half,
                                                      (i + 1) * half)))
             for i in range(2)]
    (comp, decomp, window, verify, flipped, chop, to_zlib, to_ans, multihost,
     _merge) = run_cli(workdir, [
        (['mtscomp', str(rec.raw), t['.cbin'], t['.ch']] + on_card + meta, 0),
        (['mtsdecomp', t['.cbin'], '-o', t['.bin'], '-nc'] + on_card, 0),
        (['mtsdecomp', t['.cbin'], '-o', t['.win.bin'], '--samples',
          '%d:%d' % (a, b)] + on_card, 0),
        (['mtsverify', t['.cbin']] + on_card, 0),
        (['mtsverify', t['.flip.cbin']] + on_card, 1),
        (['mtschop', t['.cbin'], '-n', '2', '-o', t['.chop.cbin']], 0),
        (['mtsrecompress', t['.chop.cbin'], '-o', t['.z.cbin'], '-a', 'zlib']
         + on_card, 0),
        (['mtsrecompress', t['.z.cbin'], '-o', t['.a.cbin'], '-a', 'ans',
          '--ans-tables', 'segment'] + on_card, 0),
        (['mtscomp', str(rec.raw), t['.parts.cbin'], t['.parts.ch'],
          '--parts', '2', '--workers', '2'] + on_card + meta, 0),
        (['mtsmerge'] + parts + ['-o', t['.merged.cbin']], 0)])

    def launched(counts):
        return {k: v for k, v in counts.items() if v}

    # mtscomp on the card (K6) = the host route's bytes.
    counts = comp[1]
    require(counts['rans_encode'] > 0 and counts['host_encoded_chunks'] == 0,
            'mtscomp --device %s: %s' % (DEVICE, launched(counts)))
    require(Path(t['.cbin']).read_bytes() == rec.cbin.read_bytes()
            and Path(t['.ch']).read_bytes() == rec.ch.read_bytes(),
            'mtscomp --device %s wrote other bytes than the host route'
            % DEVICE)
    # mtsdecomp on the card = the source; a sample window through the
    # chunk cache.
    counts = decomp[1]
    require(counts['rans_decode_octet'] > 0 and counts['finalize_u8'] > 0
            and counts['host_fallback_chunks'] == 0,
            'mtsdecomp --device %s: %s' % (DEVICE, launched(counts)))
    require(np.array_equal(np.fromfile(t['.bin'], src.dtype).reshape(
        src.shape), src), 'mtsdecomp differs from the source')
    counts = window[1]
    require(counts['rans_decode_octet'] == 3 and counts['finalize_u8'] == 3,
            'mtsdecomp --samples: %s, expected three chunks'
            % launched(counts))
    require(np.array_equal(np.fromfile(t['.win.bin'], src.dtype).reshape(
        -1, src.shape[1]), src[a:b]), 'mtsdecomp --samples differs')
    # mtsverify decodes on the card (the 8 chunks are one batch), passes,
    # and reports a flipped byte from there.
    out, counts = verify
    require(counts['rans_decode_octet'] == 1 and counts['finalize_u8'] == 1
            and counts['host_fallback_chunks'] == 0,
            'mtsverify --device %s: %s' % (DEVICE, launched(counts)))
    require('verdict' in out and 'OK' in out and 'FAILED' not in out,
            'mtsverify: %s' % out)
    out, counts = flipped
    decode = [line for line in out.splitlines()
              if line.startswith('chunks_decode')]
    require('FAILED' in out and 'MISMATCH' in out and len(decode) == 1
            and not decode[0].endswith(' ok')
            and counts['host_fallback_chunks'] == 0,
            'mtsverify passed a flipped byte: %s' % out)
    # mtschop copies bytes; mtsrecompress ans -> zlib decodes on the card,
    # zlib -> ans encodes there: the host route's bytes.
    require(not launched(chop[1]), 'mtschop launched %s' % launched(chop[1]))
    counts = to_zlib[1]
    require(counts['rans_decode_octet'] > 0 and counts['finalize_u8'] > 0
            and counts['host_fallback_chunks'] == 0,
            'mtsrecompress -a zlib --device %s: %s'
            % (DEVICE, launched(counts)))
    counts = to_ans[1]
    require(counts['rans_encode'] > 0 and counts['host_encoded_chunks'] == 0
            and counts['rans_decode_octet'] == 0,
            'mtsrecompress -a ans --device %s: %s'
            % (DEVICE, launched(counts)))
    mt.transcode(t['.z.cbin'], out=t['.host.cbin'], algorithm='ans',
                 ans_table_mode='segment', device='none', quiet=True)
    for ext in ('.cbin', '.ch'):
        require(Path(t['.a.cbin']).with_suffix(ext).read_bytes()
                == Path(t['.host.cbin']).with_suffix(ext).read_bytes(),
                'mtsrecompress --device %s wrote another %s than the host '
                'route' % (DEVICE, ext))
    before = kernel_launches()[1]
    require(mt.verify_file(t['.a.cbin'], quiet=True, device=DEVICE)['ok']
            and kernel_launches()[1] == before + 1,
            'the recompressed file does not verify on the card')
    r = mt.decompress(t['.a.cbin'], device=DEVICE, quiet=True,
                      check_after_decompress=False)
    try:
        require(np.array_equal(r.to_array(), src[:2 * SR])
                and np.array_equal(r[SR - 7:SR + 7], src[SR - 7:SR + 7]),
                'zlib -> ans: the recompressed file differs from the source')
    finally:
        r.close()
    # compress_multihost: two worker processes, each on the card because
    # the device is named (their launches are their own processes'), then
    # mtsmerge of the parts: both the whole-file bytes.
    require(multihost[1]['host_encoded_chunks'] == 0,
            'mtscomp --parts: %s' % launched(multihost[1]))
    for name in ('.parts.cbin', '.merged.cbin'):
        require(Path(t[name]).read_bytes() == rec.cbin.read_bytes(),
                'tool%s differs from the whole-file compress' % name)
    # What a worker runs with the device named, here in this process
    # where its launches can be read: each range through K6.
    mt.reset_launch_counts()
    compress_multihost(
        rec.raw, workdir / 'ranges.cbin', workdir / 'ranges.ch', 2,
        part_dir=workdir / 'ranges', n_workers=1, device=DEVICE,
        **rec.kwargs)
    counts = mt.launch_counts()
    require(counts['rans_encode'] >= 2 and counts['host_encoded_chunks'] == 0,
            'compress_multihost(device=%r): %s' % (DEVICE, launched(counts)))
    require((workdir / 'ranges.cbin').read_bytes() == rec.cbin.read_bytes(),
            'compress_multihost(device=%r) differs from the whole-file '
            'compress' % DEVICE)
    # A live stream that dies after three chunks, resumed, finished and
    # tailed on the card.
    live, live_ch = workdir / 'live.cbin', workdir / 'live.ch'
    kwargs = dict(sample_rate=float(SR), n_channels=384, dtype='int16',
                  algorithm='ans', ans_table_mode='segment', **ORDER1)
    w = mt.StreamWriter(live, live_ch, live_sidecar=True, **kwargs)
    w.append(src[:3 * SR + 777])
    w._fb.close()                       # the crash: 777 samples are lost
    before = kernel_launches()[1]
    tail = mt.StreamReader(live, live_ch, device=DEVICE)
    try:
        require(tail.n_samples == 3 * SR and not tail.finalized
                and np.array_equal(tail[-SR // 2:], src[3 * SR - SR // 2:3 * SR]),
                'the tail of the live stream differs')
        w = mt.StreamWriter.resume(live, live_ch)
        require(w.n_samples == 3 * SR, 'resumed at sample %d' % w.n_samples)
        w.append(src[w.n_samples:])
        w.close()
        require(tail.refresh() and tail.finalized
                and np.array_equal(tail[5 * SR - 9:5 * SR + 9],
                                   src[5 * SR - 9:5 * SR + 9]),
                'the tail of the finished stream differs')
    finally:
        tail.close()
    k1 = kernel_launches()[1] - before
    require(k1 == 3, 'the StreamReader on the card launched K1 %d times for '
            'three chunks' % k1)
    require(live.read_bytes() == rec.cbin.read_bytes()
            and json.loads(live_ch.read_text())
            == json.loads(rec.ch.read_text()),
            'the resumed stream differs from the batch compress')
    log('t. StreamWriter: 3 chunks, a crash, resume, %d chunks: the batch '
        'compress\'s bytes; StreamReader tailed it on the card (K1 once a '
        'chunk read)' % (src.shape[0] // SR))


#: Phase u: the storm's random cells after its full grid (the JAX
#: storm's 27 cells at its full geometry: 385 channels, chunks of 4,000
#: samples, 2.5 chunks), and the kernel forms the storm must launch.
STORM_RANDOM = 16
STORM_GRID = 27
STORM_FORMS = ('rans_decode_octet', 'rans_decode_coarse_2fixups',
               'finalize_u8', 'finalize_u8_tail', 'scan_planes_i16_seeded',
               'scan_transposed_i16_seeded', 'scan_transposed_i32_seeded',
               'scan_transposed_i64_seeded', 'cumsum_time_i16',
               'cumsum_time_i32', 'rans_encode')


def run_storm(workdir):
    """Phase u: ``mtscomp_tpu_torch.storm.main`` in this process on the
    card, the full grid and ``STORM_RANDOM`` random cells of seed 0, the
    report in the work directory; every cell must pass (the storm itself
    fails a decode batch without its K1 launch, a device encode of a
    rANS plane without K6, a wide-dtype cell with a chunk on the host
    codec, a scan narrower than 64 bits or none of 64, and a corrupted
    file read without an IOError).
    Returns the storm's summary with each cell's seconds and launches."""
    base = workdir / 'storm' / 'GPU_STORM'
    rc = storm.main(['--random', str(STORM_RANDOM), '--seed', '0',
                     '--device', DEVICE, '--out', str(base)])
    report = json.loads(base.with_name(base.name + '.json').read_text())
    summary, cells = report['summary'], report['cells']
    for c in cells:
        log('u. %-26s %s %7.2f s, launches %s%s'
            % (c['cell'], 'pass' if c['ok'] else 'FAIL', c['secs'],
               json.dumps(c['launches']),
               ', host %s' % json.dumps(c['host']) if c['host'] else ''))
    log('u. storm: %d/%d cells passed in %.1f s; launches over the storm %s; '
        'chunks on the host codec %s'
        % (summary['passed'], summary['cells'], summary['seconds'],
           json.dumps(summary['launches']), json.dumps(summary['host'])))
    failed = [c['cell'] for c in cells if not c['ok']]
    require(rc == 0 and not failed, 'storm cells failed: %s' % failed)
    require(summary['cells'] == STORM_GRID + STORM_RANDOM,
            'the storm ran %d cells, expected %d'
            % (summary['cells'], STORM_GRID + STORM_RANDOM))
    summary['by_cell'] = {c['cell']: {'secs': c['secs'],
                                      'launches': c['launches']}
                          for c in cells}
    return summary


def check_entry():
    """Phase v: ``entry()``'s decode step on the card (K1, K5) equals the
    same step on the CPU twins byte for byte, and
    ``dryrun_multichip(device_count())`` (K1, K6, K5 on every card)
    passes its self-checks."""
    fn, args = entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    want = fn(*(a.cpu() for a in args))
    require(got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.cpu(), want),
            'entry() on the card differs from its twins')
    n = torch.cuda.device_count()
    total = entry.dryrun_multichip(n)
    log('v. entry(): %s %s on the card = the twins; dryrun_multichip(%d) '
        'passed, checksum %d' % (tuple(got.shape), got.dtype, n, total))
    return {'shape': list(got.shape), 'dryrun_devices': n,
            'checksum': total}


#: Phase r: the BASELINE.json report's arguments, and the most host-clock
#: seconds the phase may take with the harness's device rows.
BASELINE_ARGS = ['--device', DEVICE, '--seconds', '8', '--reps', '3']
BASELINE_LIMIT_S = 120.0
#: Every byte-exact cell of the report (:func:`exact_cells`), by path.
BASELINE_EXACT_CELLS = frozenset((
    'config1.zlib', 'config1.ans', 'config2.staged',
    'config2.to_array.' + DEVICE, 'config2.to_array.host', 'config3',
    'config4.decompress_multi', 'config4.staged', 'config4.mesh', 'config5',
    'config6.ans'))


def exact_cells(result, path=()):
    """``(path, value)`` of every ``exact`` key of the report's nested
    result (config 6's zlib row is ``bit_exact``: the reference's
    float-domain codec is not lossless, and is not one of them)."""
    for key, value in result.items():
        if isinstance(value, dict):
            yield from exact_cells(value, path + (key,))
        elif key == 'exact':
            yield '.'.join(path), value


def run_baseline_report():
    """Phase r: ``baseline_report.main(BASELINE_ARGS)`` in this process
    on the card, then the harness's device row
    (``mtscomp_perf(..., device=True)``: compress and decode on the card)
    of 10 s of the ``ap_385`` dataset for both algorithms. Every
    byte-exact cell must hold, the staged rates of configs 2 and 4 be
    measured, K1 launch in configs 2-4 and K6 in the device compress,
    all within ``BASELINE_LIMIT_S``. Returns the report's numbers, the
    rows, and the launches summed over the phase."""
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = baseline_report.main(BASELINE_ARGS)
    require(rc == 0, 'baseline_report.main returned %d' % rc)
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith(('#', '|', '(')):
            log('r. ' + line)
    res = json.loads(next(line for line in lines
                          if line.startswith('{"baseline_report"'))
                     )['baseline_report']
    cells = dict(exact_cells(res))
    require(set(cells) == BASELINE_EXACT_CELLS,
            'the report gave the byte-exact cells %s, not %s'
            % (sorted(cells), sorted(BASELINE_EXACT_CELLS)))
    require(all(cells.values()),
            'byte-exact cells of the report failed: %s'
            % sorted(k for k, v in cells.items() if not v))
    for name in ('config2', 'config4'):
        require(res[name]['staged']['gbps'] is not None,
                '%s: no staged rate' % name)
    # Config 6's float32 file encodes on the card (K6, bitcast int32).
    require(res['config6']['launches'].get('rans_encode', 0) > 0
            and not res['config6']['launches'].get('host_encoded_chunks'),
            'config6 launches %s' % json.dumps(res['config6']['launches']))
    counts = dict.fromkeys(mt.launch_counts(), 0)
    for name in ('config%d' % i for i in range(1, 7)):
        for key, n in res[name]['launches'].items():
            counts[key] += n
        if name in ('config2', 'config3', 'config4'):
            k1 = sum(n for key, n in res[name]['launches'].items()
                     if key.startswith('rans_decode'))
            require(k1 > 0, '%s never launched K1' % name)
    arr, sr = harness.make_dataset('ap_385', 10)
    rows = {}
    for algorithm in ('zlib', 'ans'):
        mt.reset_launch_counts()
        rows[algorithm] = harness.mtscomp_perf(arr, sr, algorithm=algorithm,
                                               device=True)
        launched = mt.launch_counts()
        for key, n in launched.items():
            counts[key] += n
        rows[algorithm]['launches'] = {k: v for k, v in launched.items()
                                       if v}
        log('r. mtscomp_perf(ap_385 10 s, %s, device=True): %s'
            % (algorithm, json.dumps(rows[algorithm])))
    require(rows['ans']['launches'].get('rans_encode', 0) > 0
            and rows['ans']['launches'].get('host_encoded_chunks', 0) == 0,
            'the device compress of mtscomp_perf: %s'
            % json.dumps(rows['ans']['launches']))
    seconds = time.perf_counter() - t0
    log('r. BASELINE.json report and mtscomp_perf on the card: %d byte-exact '
        'cells, staged %.2f / %.2f GB/s (configs 2 / 4), %.1f s'
        % (len(cells), res['config2']['staged']['gbps'],
           res['config4']['staged']['gbps'], seconds))
    require(seconds < BASELINE_LIMIT_S,
            'phase r took %.1f s, more than %.0f' % (seconds,
                                                    BASELINE_LIMIT_S))
    return {'report': res, 'mtscomp_perf': rows, 'seconds': seconds}, counts


#: Phase j: the bench's environment (seconds of data, global budget in
#: seconds), and the most seconds its process may take, its own start
#: and the kill of a phase at the budget's end included.
BENCH_ENV = {'BENCH_SECONDS': '8', 'BENCH_BUDGET': '400'}
BENCH_LIMIT_S = 460.0


def run_bench(kind):
    """Phase j: ``python -m mtscomp_tpu_torch.bench`` in a child process
    (its process group killed at ``BENCH_LIMIT_S``), its log lines
    logged. Returns its JSON line and its launches summed over its
    phases."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, out = bench.run_module([], BENCH_LIMIT_S, env=BENCH_ENV)
    seconds = time.perf_counter() - t0
    for text in out.splitlines():
        if text.startswith('[bench]'):
            log('j. ' + text[:400])
    lines = [text for text in out.splitlines()
             if text.startswith('{') and '"metric"' in text]
    require(rc == 0 and lines, 'the bench exited %s after %.1f s:\n%s'
            % (rc, seconds, out[-3000:]))
    line = json.loads(lines[-1])
    launches = line['launches']
    require(line['byte_exact'] and line['value'] is not None
            and not line['phase_errors'], 'the bench: %s' % lines[-1])
    require(line['device']['platform'] == 'gpu'
            and line['device']['name'] == kind
            and line['device']['power_limit'] is not None,
            'the bench named the card %s' % json.dumps(line['device']))
    require(set(launches['dev_decode']) == set(bench.DECODE_FORMS),
            'the bench\'s staged decode launched %s'
            % json.dumps(launches['dev_decode']))
    for phase in ('encode', 'dev_encode'):
        require(launches[phase].get('rans_encode', 0) > 0
                and not launches[phase].get('host_encoded_chunks'),
                'the bench\'s %s launched %s'
                % (phase, json.dumps(launches[phase])))
    require(line['e2e_decomp_mbps'] is not None
            and line['e2e_host_mbps'] is not None,
            'the bench timed tofile() on one route only')
    counts = dict.fromkeys(mt.launch_counts(), 0)
    for by_form in launches.values():
        for key, n in by_form.items():
            counts[key] += n
    log('j. the bench: %.3f GB/s staged (K1 + K3), e2e %.1f MB/s on the '
        'card, %.1f on the host; encode %.1f MB/s on the host, %.1f on the '
        'card; K6 %.3f GB/s; %.1f s'
        % (line['value'], line['e2e_decomp_mbps'], line['e2e_host_mbps'],
           line['encode_mbps'], line['device_compress_mbps'],
           line['device_encode_gbps'], seconds))
    return line, counts


def host_ms(fn, reps=REPS):
    """Median over ``reps`` of the host-clock time of ``fn()`` followed by
    a synchronize, in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


#: Timed windows (phase i): name -> (first sample, samples), inside one
#: chunk of the 32-s files.
WINDOWS = {'1s': (5 * SR, SR), '0.1s': (5 * SR + 1000, SR // 10),
           '30_samples': (5 * SR + 1000, 30)}


def time_windows(recs):
    """Phase i, windows: ``r[a:b]`` inside one chunk, uncached (both
    caches emptied before each read) and cached, on the device route and
    on the host codec (``device='none'``), same file, same run."""
    out = {}
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        rec, out[name] = recs[name], {}
        for route, device in (('device', DEVICE), ('host', 'none')):
            r = rec.reader(device=device, cache_size=WINDOW_CACHE)
            try:
                for label, (a, n) in WINDOWS.items():
                    def uncached():
                        if r._dev_cache is not None:
                            r._dev_cache.clear()
                        r.read_chunk.cache_clear()
                        return r[a:a + n]

                    require(np.array_equal(uncached(), rec.arr[a:a + n]),
                            '%s: timed window differs' % name)
                    out[name]['%s_%s' % (label, route)] = {
                        'uncached_ms': host_ms(uncached),
                        'cached_ms': host_ms(lambda: r[a:a + n])}
            finally:
                r.close()
        for label in WINDOWS:
            dev, host = (out[name]['%s_%s' % (label, route)]
                         for route in ('device', 'host'))
            log('i. %s window of %s: uncached %.3f ms on the card, %.3f on '
                'the host codec; cached %.3f, %.3f (host clock, median of %d)'
                % (label, name, dev['uncached_ms'], host['uncached_ms'],
                   dev['cached_ms'], host['cached_ms'], REPS))
    return out


def time_routes(recs, names=('int16_385ch', 'spiky_int16_385ch')):
    """Phase i: ``to_array()`` of the 32-s files (or ``names``) on the
    device route and on the host codec in turns (device, host, host,
    device), host clock."""
    out = {}
    for name in names:
        rec, times = recs[name], {'device_s': [], 'host_s': []}
        for route in ('device', 'host', 'host', 'device'):
            r = rec.reader(device=DEVICE if route == 'device' else 'none')
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = r.to_array()
                torch.cuda.synchronize()
                times[route + '_s'].append(time.perf_counter() - t0)
                require(np.array_equal(got, rec.arr), '%s: to_array() on '
                        'the %s route differs' % (name, route))
                del got
            finally:
                r.close()
        out[name] = times
        log('i. %s to_array(): device route %s s, host codec %s s (host '
            'clock, in turns)' % (name, times['device_s'], times['host_s']))
    return out


def time_wide(recs):
    """Phase i, the 8-byte recordings (``WIDE``): the staged decode of
    each one's batch on the card (K1 and the int64 scans; CUDA events,
    median of ``REPS`` x 8) and of the same chunks on the host codec, the
    route they took before the card had int64 scans and the JAX package's
    (its C++ worker pool; host clock, median of ``REPS``), both
    byte-exact; then ``to_array()`` on both routes in turns."""
    out = {}
    for name in WIDE:
        rec = recs[name]
        r, parsed, fn, args = rec.staged()
        try:
            ids = list(range(len(parsed)))
            want = rec.arr[:len(parsed) * rec.chunk].tobytes()
            got, used = fn(*args)
            check_words_used(parsed, used)
            require(got.cpu().numpy().tobytes() == want,
                    '%s: the staged decode differs from the source' % name)
            host = r._decompress_chunks_batch(ids)
            require(b''.join(host[i].tobytes() for i in ids) == want,
                    '%s: the host codec\'s decode differs from the source'
                    % name)
            del got, host
            card = cuda_ms(lambda: fn(*args), REPS, inner=8)
            on_host = host_ms(lambda: r._decompress_chunks_batch(ids))
        finally:
            r.close()
        out[name] = {'batch_chunks': len(parsed), 'chunk_samples': rec.chunk,
                     'staged_card_ms': card, 'staged_host_ms': on_host,
                     'card_gbps': len(want) / 1e6 / card,
                     'host_gbps': len(want) / 1e6 / on_host}
        log('i. staged decode %s, B=%d: %.4f ms on the card (%.3f GB/s), '
            '%.3f ms on the host codec (%.3f GB/s)'
            % (name, len(parsed), card, len(want) / 1e6 / card, on_host,
               len(want) / 1e6 / on_host))
    for name, times in time_routes(recs, WIDE).items():
        out[name]['to_array_s'] = times
    return out


def time_single_chunk(recs):
    """Phase i, B=1 (what a window stages): the staged decode of one
    chunk of each 32-s file, and its kernels alone (K1 on 4 or 7 groups,
    K3 or K4's plane form), each held against its twin, CUDA events."""
    out = {}
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        r, parsed, fn, args = recs[name].staged(1)
        try:
            res, used = fn(*args)
            check_words_used(parsed, used)
            arr = recs[name].arr[:SR]
            require(np.array_equal(res.cpu().numpy().reshape(arr.shape), arr),
                    '%s: the B=1 staged decode differs' % name)
            staged_ms = cuda_ms(lambda: fn(*args), REPS, inner=8)
            k1_name, kernel, twin, k1_args, kw = k1_calls(fn, args)
            live = (torch.arange(k1_args[-1] * LANES, device=args[4].device)
                    < args[4][:, :, None].long())
            _err, (syms, _used) = compare(kernel, twin, k1_args, kw, live)
            forms = [(k1_name, kernel, k1_args, kw)]
            const_vals, raw_vals, heads = args[5], args[6], args[7]
            fkw = fn.keywords
            if fn.func is _decode_fuse8:
                bulk, tail_block = fuse8_planes(
                    syms, B=1, G=fkw['G'], k=fkw['k'], tp=fkw['tp'],
                    tail=fkw['tail'])
                form, kernel, twin, f_args = finalize_call(
                    bulk, tail_block, heads, const_vals[:, 0])
                f_kw = {'n_samples': SR}
                compare(kernel, twin, f_args, f_kw)
                forms.append((form, kernel, f_args, f_kw))
            else:
                lay = fkw['lay']
                p_args = tuple(generic_planes(syms, const_vals, raw_vals,
                                              lay)) + (heads,)
                p_kw = {'n_samples': SR, 'zigzag': lay.zigzag}
                compare(dd.cumsum_time_transposed_planes,
                        dd.cumsum_time_transposed_planes_ref, p_args, p_kw)
                forms.append(('scan_transposed planes int16, head-seeded '
                              '(K4)', dd.cumsum_time_transposed_planes,
                              p_args, p_kw))
            kernels = []
            for form, kernel, k_args, k_kw in forms:
                got = kernel(*k_args, **k_kw)
                nbytes, ops = work(KERNELS[form][0], k_args, got)
                del got
                kernels.append({
                    'name': form, 'groups': args[0].shape[0],
                    'ms': cuda_ms(lambda: kernel(*k_args, **k_kw), REPS,
                                  inner=8),
                    'bound_ms': 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                          ops / ALU_OPS_PER_S),
                    'max_abs_err': 0})
            out[name] = {'batch_chunks': 1, 'staged_ms': staged_ms,
                         'gbps': arr.nbytes / 1e6 / staged_ms,
                         'kernels': kernels}
            log('i. staged decode %s at B=1 (%d groups): %.4f ms, %.3f GB/s '
                'of decoded output; %s' % (
                    name, args[0].shape[0], staged_ms,
                    arr.nbytes / 1e6 / staged_ms, '; '.join(
                        '%s %.4f ms (bound %.4f), equal to its twin'
                        % (k['name'], k['ms'], k['bound_ms'])
                        for k in kernels)))
        finally:
            r.close()
    return out


def stage_breakdown(rec):
    """Host clock of the decode's layers over the whole file, one batch:
    parse, pack + upload, kernels, audit + fetch."""
    r = rec.reader()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parsed = [r.codec.parse(_read_payload(r, i))
                  for i in range(r.n_chunks)]
        t1 = time.perf_counter()
        fn, args = DeviceBatchDecoder(r, DEVICE).pack(parsed, SR)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out, used = fn(*args)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        check_words_used(parsed, used)
        host = out.cpu().numpy()
        t4 = time.perf_counter()
        require(np.array_equal(host.reshape(rec.arr.shape),
                               rec.arr.view(host.dtype)),
                'stage breakdown decode differs from the source')
        return {'chunks': len(parsed), 'parse_s': t1 - t0,
                'pack_upload_s': t2 - t1, 'device_s': t3 - t2,
                'audit_fetch_s': t4 - t3, 'total_s': t4 - t0,
                'raw_mb': rec.arr.nbytes / 1e6}
    finally:
        r.close()


def time_staged(recs, staged):
    """Phase i, staged decodes: the B=8 batches kept from phase c, and
    each 32-s file's 32 chunks in one batch."""
    stagings = {}
    for name, (r, parsed, fn, args) in staged.items():
        out, used = fn(*args)
        check_words_used(parsed, used)
        arr = recs[name].arr[:len(parsed) * recs[name].chunk]
        require(np.array_equal(out.cpu().numpy().reshape(arr.shape),
                               arr.view(out.cpu().numpy().dtype)),
                '%s: staged decode differs from the source' % name)
        if name in ('int16_385ch', 'int16_384ch', 'spiky_int16_385ch'):
            ms = cuda_ms(lambda: fn(*args), REPS, inner=8)
            stagings[name] = {'batch_chunks': len(parsed), 'ms': ms,
                              'gbps': arr.nbytes / 1e6 / ms}
        r.close()
    for name in ('int16_385ch', 'spiky_int16_385ch'):
        r, parsed, fn, args = recs[name].staged(SECONDS)
        try:
            ms = cuda_ms(lambda: fn(*args), REPS, inner=2)
            stagings[name + '_all'] = {
                'batch_chunks': len(parsed), 'ms': ms,
                'gbps': len(parsed) * SR * 385 * 2 / 1e6 / ms}
            if name == 'int16_385ch':
                # K1 alone on the whole-file batch to_array() runs.
                k1_name, kernel, twin, k1_args, kw = k1_calls(fn, args)
                live = (torch.arange(k1_args[-1] * LANES,
                                     device=args[4].device)
                        < args[4][:, :, None].long())
                compare(kernel, twin, k1_args, kw, live)
                stagings[name + '_all']['k1_groups'] = args[0].shape[0]
                stagings[name + '_all']['k1_ms'] = cuda_ms(
                    lambda: kernel(*k1_args, **kw), REPS)
                log('i. %s on the whole-file batch (%d groups): %.4f ms, '
                    'equal to its twin' % (k1_name, args[0].shape[0],
                                           stagings[name + '_all']['k1_ms']))
        finally:
            r.close()
    for name, st in stagings.items():
        log('i. staged decode %s: %.4f ms per %d-chunk batch, %.3f GB/s'
            ' of decoded output' % (name, st['ms'], st['batch_chunks'],
                                    st['gbps']))
    return stagings


def time_fuse8_geometries(recs):
    """Phase i: the staged decode of each layout only the port fuses
    (``FUSE8_GEOMETRIES``: a batch of up to ``BATCH`` chunks of the
    recording's first run), on the fused route and on the generic route
    with the JAX package's routing forced back (``_fuse8_geom`` saying
    no): both byte-exact, CUDA events, median of ``REPS``."""
    out = {}
    for name in FUSE8_GEOMETRIES:
        rec = recs[name]
        r, parsed, fn, args = rec.staged()
        try:
            geom = pipeline._fuse8_geom
            pipeline._fuse8_geom = lambda *a: (False, geom(*a)[1])
            try:
                gfn, gargs = DeviceBatchDecoder(r, DEVICE).pack(parsed,
                                                                rec.chunk)
            finally:
                pipeline._fuse8_geom = geom
            require(gfn.func is not _decode_fuse8,
                    '%s: the generic route was not forced' % name)
            arr = rec.arr[:len(parsed) * rec.chunk]
            res = {'batch_chunks': len(parsed), 'chunk_samples': rec.chunk,
                   'generic_plane_form': gfn.keywords['lay'].plane_form}
            for route, f, a in (('fuse8', fn, args),
                                ('generic', gfn, gargs)):
                got, used = f(*a)
                check_words_used(parsed, used)
                require(np.array_equal(got.cpu().numpy().reshape(arr.shape),
                                       arr),
                        '%s: the %s route differs from the source'
                        % (name, route))
                ms = cuda_ms(lambda f=f, a=a: f(*a), REPS, inner=8)
                res[route + '_ms'] = ms
                res[route + '_gbps'] = arr.nbytes / 1e6 / ms
            out[name] = res
            log('i. staged decode %s, B=%d of %d samples: fused %.4f ms '
                '(%.3f GB/s), generic %.4f ms (%.3f GB/s)%s'
                % (name, len(parsed), rec.chunk, res['fuse8_ms'],
                   res['fuse8_gbps'], res['generic_ms'], res['generic_gbps'],
                   ', K4 plane form' if res['generic_plane_form'] else ''))
        finally:
            r.close()
    return out


def _nbytes(t):
    return t.numel() * t.element_size()


def work(key, args, out):
    """``(bytes, operations)`` a kernel form's call must move and do on
    this run's inputs: each input read once and each output written
    once, where the data decide it (live symbols, words used or
    emitted) as this run's data need it. Operations are integer ALU
    operations per element: 12 a decoded symbol (slot lookup, table
    reads, multiply-add, renorm test and shift), 15 an encoded symbol
    (renorm test and shift, multiply-high, shifts, multiply-add), 6 a
    finalized sample (combine, unzigzag, add), 1 a scanned element."""
    if key.startswith('rans_decode'):
        states, words, lookup, dense, counts = args[:5]
        syms, used = out
        live = int(counts.sum())
        return (_nbytes(states) + 2 * int(used.sum()) + _nbytes(lookup)
                + _nbytes(dense) + _nbytes(counts) + live + _nbytes(used),
                12 * live)
    if key.startswith('finalize'):
        B, T, C = out.shape
        small = sum(_nbytes(a) for a in args if a.dim() < 3)  # heads, hi
        return B * C * (T - 1) + small + _nbytes(out), 6 * out.numel()
    if key.startswith('scan_transposed'):
        return (sum(_nbytes(a) for a in args if a is not None)
                + _nbytes(out), out.numel())
    if key.startswith('scan_planes'):
        # A coded plane's live bytes (the steps the output needs), a
        # constant plane's value per chunk, the heads; the finalize's 6
        # operations a sample.
        B, T, C = out.shape
        lo, hi, head = args
        live = B * C * (T - 1 if head is not None else T)
        return (sum(live if p.dim() == 3 else _nbytes(p) for p in (lo, hi))
                + (0 if head is None else _nbytes(head)) + _nbytes(out),
                6 * out.numel())
    if key.startswith('cumsum_time'):
        return _nbytes(args[0]) + _nbytes(out), out.numel()
    if key == 'decode_tables':
        # Each row a table built: two scans of 256 symbols and the entry
        # (16 operations a symbol), nine compares a searched octet.
        freqs, rows = args
        return (sum(_nbytes(t) for t in (*args, *out)),
                (16 * 256 + 9 * 512) * int((rows >= 0).sum()))
    if key == 'rans_encode':
        _symbols, pk, rcp, counts, _cap = args
        states, _words, n_words = out
        live = int(counts.sum())
        return (live + _nbytes(pk) + _nbytes(rcp) + _nbytes(counts)
                + _nbytes(states) + 2 * int(n_words.sum())
                + _nbytes(n_words), 15 * live)
    raise KeyError(key)


def library_call(key, args):
    """One PyTorch call computing the same function, or None: the time
    cumsum for K5, and for K4 the cumsum over time of the transposed
    view (the inclusive scan; the head-seeded form adds the head)."""
    d = args[0]
    if key.startswith('cumsum_time'):
        return lambda: torch.cumsum(d, dim=1, dtype=d.dtype)
    if key.startswith('scan_transposed'):
        return lambda: torch.cumsum(d.transpose(1, 2), dim=1, dtype=d.dtype)
    return None


def time_kernels(calls, counts_by_path):
    """Phase i, kernel forms against their twins, their bounds and the
    library calls. Returns the entries of the forms the paths launch
    and, apart, of those no path launches; ``launches`` is the form's
    counter summed over the paths' runs, ``launches_by_path`` the counter
    of each path's run."""
    on_path, off_path = [], []
    for name, (key, source, replaces) in KERNELS.items():
        kernel, twin, args, kwargs, err = calls[name]
        out = kernel(*args, **kwargs)
        nbytes, ops = work(key, args, out)
        del out
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
        ms = cuda_ms(lambda: kernel(*args, **kwargs), REPS)
        plain_ms = cuda_ms(lambda: twin(*args, **kwargs), TWIN_REPS)
        lib = library_call(key, args)
        library_ms = cuda_ms(lib, REPS) if lib is not None else None
        by_path = {path: c[key] for path, c in counts_by_path.items()}
        entry = {'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': sum(by_path.values()),
                 'launches_by_path': by_path, 'max_abs_err': err, 'ms': ms,
                 'plain_ms': plain_ms, 'bound_ms': 1e3 * max(t_bytes, t_ops),
                 'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
                 'library_ms': library_ms, 'bytes': nbytes,
                 'operations': ops}
        if key in ON_PATH:
            require(entry['launches'] > 0, '%s never launched' % name)
            on_path.append(entry)
        else:
            off_path.append(entry)
        log('i. %s: kernel %.4f ms, twin %.4f ms, bound %.4f ms (%s), '
            'library %s ms (on the card); launches by path %s'
            % (name, ms, plain_ms, entry['bound_ms'], entry['bound_by'],
               'n/a' if library_ms is None else '%.4f' % library_ms,
               json.dumps(by_path)))
    return on_path, off_path


#: Phase i, the scans alone beside their staged B=8 calls: K5 at B=2, the
#: batch its paths launch, K4's int64 form at B=2 (the wide files' batch),
#: and every int16 form and the finalize at B=32 (a whole 32-s file in one
#: batch); (kernel form, chunks).
SCAN_SHAPES = (('cumsum_time int16 (K5)', 2), ('cumsum_time int32 (K5)', 2),
               ('cumsum_time int64 (K5)', 2),
               ('scan_transposed int64, head-seeded (K4)', 2),
               ('cumsum_time int16 (K5)', 32),
               ('scan_transposed int16, head-seeded (K4)', 32),
               ('scan_transposed planes int16, head-seeded (K4)', 32),
               ('finalize_u8, tail form (K3)', 32))


#: Phase i, the finalize against the output row's length: channel counts
#: whose (B, T, C) int16 rows are on (384, 400: 768 and 800 bytes) and off
#: (385, 386) the 32-byte sector grid of device memory.
FINALIZE_CHANNELS = (384, 385, 386, 400)


def time_finalize_channels():
    """Phase i: K2 at B=8 on seeded random bytes, 30,000 steps, over
    ``FINALIZE_CHANNELS``: each held against its twin, then timed against
    its bound (what the store runs of rows off the sector grid cost)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    out = []
    for C in FINALIZE_CHANNELS:
        args = (torch.randint(0, 256, (BATCH, C, SR + 80), dtype=torch.uint8,
                              device=DEVICE, generator=gen),
                torch.randint(-32768, 32768, (BATCH, C), dtype=torch.int16,
                              device=DEVICE, generator=gen),
                torch.randint(0, 256, (BATCH,), dtype=torch.uint8,
                              device=DEVICE, generator=gen))
        kwargs = {'n_samples': SR}
        _err, got = compare(dd.cumsum_time_transposed_u8,
                            dd.cumsum_time_transposed_u8_ref, args, kwargs)
        nbytes, ops = work('finalize_u8', args, got)
        del got
        ms = cuda_ms(lambda: dd.cumsum_time_transposed_u8(*args, **kwargs),
                     REPS)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
        out.append({'channels': C, 'row_bytes': 2 * C, 'batch_chunks': BATCH,
                    'ms': ms, 'bound_ms': bound, 'max_abs_err': 0})
        log('i. finalize_u8 (K2) at %d channels (rows of %d bytes), B=%d, '
            'random bytes: %.4f ms, bound %.4f ms, equal to its twin'
            % (C, 2 * C, BATCH, ms, bound))
    return out


def time_scan_shapes():
    """Phase i: K3, K4 and K5 on seeded random elements of ``SCAN_SHAPES``
    at 385 channels x 30,000 steps: each held against its twin, then timed
    against its bound."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)

    def rand(shape, dtype):
        n = int(np.prod(shape)) * dtype.itemsize
        return torch.randint(0, 256, (n,), dtype=torch.uint8, device=DEVICE,
                             generator=gen).view(dtype).view(shape)

    out = []
    for name, B in SCAN_SHAPES:
        key = KERNELS[name][0]
        dtype = (torch.int64 if 'i64' in key else
                 torch.int32 if 'i32' in key else torch.int16)
        if key.startswith('cumsum_time'):
            kernel, twin = dd.cumsum_time, dd.cumsum_time_ref
            args, kwargs = (rand((B, SR, 385), dtype),), {}
        elif key.startswith('finalize'):
            kernel = dd.cumsum_time_transposed_u8_tail
            twin = dd.cumsum_time_transposed_u8_tail_ref
            # 384 bulk channels and the one tail channel, rows 128-padded.
            args = (rand((B, 384, SR + 80), torch.uint8),
                    rand((B, 1, SR + 80), torch.uint8),
                    rand((B, 384), dtype), rand((B, 1), dtype),
                    rand((B,), torch.uint8))
            kwargs = {'n_samples': SR}
        elif key.startswith('scan_planes'):
            kernel = dd.cumsum_time_transposed_planes
            twin = dd.cumsum_time_transposed_planes_ref
            # Rows 128-padded as K1 leaves them: the pads are never read.
            args = tuple(rand((B, 385, SR + 80), torch.uint8)[:, :, :SR - 1]
                         for _ in range(2)) + (rand((B, 385), dtype),)
            kwargs = {'n_samples': SR, 'zigzag': True}
        else:
            kernel = dd.cumsum_time_transposed
            twin = dd.cumsum_time_transposed_ref
            args = (rand((B, 385, SR - 1), dtype), rand((B, 385), dtype))
            kwargs = {'n_samples': SR}
        _err, got = compare(kernel, twin, args, kwargs)
        nbytes, ops = work(key, args, got)
        del got
        ms = cuda_ms(lambda: kernel(*args, **kwargs), REPS)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
        out.append({'name': name, 'batch_chunks': B, 'ms': ms,
                    'bound_ms': bound, 'max_abs_err': 0})
        log('i. %s at B=%d (385 ch x %d steps, random elements): %.4f ms, '
            'bound %.4f ms, equal to its twin' % (name, B, SR, ms, bound))
    return out


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA GPU is visible; nothing was run.',
              file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    log('a. card: %s | torch %s, CUDA %s, %s'
        % (card, torch.__version__, torch.version.cuda, kind))

    t0 = time.perf_counter()
    path, ptxas = _build.build()
    build_s = time.perf_counter() - t0
    resources = ptxas_resources(ptxas)
    log('b. built (or reused) %s in %.1f s; ptxas: %s'
        % (path.name, build_s, json.dumps(resources)))
    lib = _build.library()
    smem = {form: lib.mts_rans_decode_smem_bytes(fixups) for fixups, form in
            enumerate(('K1 octet', 'K1 coarse 1', 'K1 coarse 2'))}
    smem['K6'] = lib.mts_rans_encode_smem_bytes()
    for width, size in (('i16', 2), ('i32', 4), ('i64', 8)):   # 385 ch
        smem['K4 %s scan' % width] = lib.mts_scan_transposed_smem_bytes(
            385, dd.scan_transposed_geometry(385, size)[1], size)
        smem['K5 ' + width] = lib.mts_cumsum_time_smem_bytes(
            385, *dd.cumsum_time_geometry(385, size), size)
    # The finalize runs K4's int16 scan: K2 at 384 channels, K3 at 385.
    smem['K2 scan, 384 ch'] = lib.mts_scan_transposed_smem_bytes(
        384, dd.scan_transposed_geometry(384, 2)[1], 2)
    smem['K3 scan, 385 ch'] = smem['K4 i16 scan']
    log('b. dynamic shared memory a block (bytes): %s' % json.dumps(smem))
    # The host codec's C++ runtime builds at first use: before any timing.
    t0 = time.perf_counter()
    require(native.available(), 'the native host library did not build')
    native_s = time.perf_counter() - t0
    log('b. built (or reused) %s in %.1f s'
        % (native.library_path().name, native_s))

    workdir = Path(tempfile.mkdtemp(prefix='mtscomp_smoke_'))
    # The measured profiles are cached in the work directory, never in
    # the user's ~/.cache.
    pipeline._profile_cache_path = lambda name: str(workdir / 'cache' / name)
    phase_s, clock = {'a-b build': time.perf_counter() - t_start}, [
        time.perf_counter()]

    def done(label):
        """Close the phase ``label``: its host-clock seconds."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        phase_s[label] = now - clock[0]
        clock[0] = now

    try:
        recs = make_recordings(workdir)
        done('d recordings')
        calls, staged = check_kernels(recs)
        check_single_chunk_forms(recs)
        check_edge_cases()
        check_scan_edge_cases()
        check_finalize_edge_cases()
        encoded = check_encode_kernel(recs)
        enc, x, args, err = encoded['spiky_int16_385ch']
        calls['rans_encode_groups (K6)'] = (
            renc.encode_groups, renc.encode_groups_ref, args, {}, err)
        for name in set(RECORDINGS) - set(staged):
            if recs[name].expect is not None:
                recs[name].staged()[0].close()    # checks its layout
        check_small_geometries(workdir)
        done('c kernels against twins')
        end_to_end, counts_by_path = drive_paths(recs)
        check_audit(staged)
        done('e-h decode paths')
        counts_by_path.update(drive_window_paths(recs))
        check_window_audit(recs)
        done('w windows')
        multi = check_multi(workdir, recs)
        bounded = check_bounded_batches(recs['int16_385ch'])
        done('m, F3')
        sharded, counts_by_path['sharded'] = check_sharded(workdir, recs)
        done('s sharded')
        compress_s, encode_counts = drive_encode_paths(recs)
        counts_by_path.update(encode_counts)
        done('k encode paths')
        auto, auto_counts = check_auto(workdir, recs)
        counts_by_path.update(auto_counts)
        done('p profiles and auto')
        check_tools(workdir, recs)
        done('t tools')
        mt.reset_launch_counts()
        storm_summary = run_storm(workdir)
        counts_by_path['storm'] = mt.launch_counts()
        for key in STORM_FORMS:
            require(counts_by_path['storm'][key] > 0,
                    'kernel %s never launched in the storm' % key)
        done('u storm')
        mt.reset_launch_counts()
        entry_run = check_entry()
        counts_by_path['entry'] = mt.launch_counts()
        for key in ('rans_decode_octet', 'cumsum_time_i16', 'rans_encode'):
            require(counts_by_path['entry'][key] > 0,
                    'kernel %s never launched by the entry phase' % key)
        log('v. launch counts over the entry phase: %s'
            % json.dumps(counts_by_path['entry']))
        done('v entry')
        baseline, counts_by_path['baseline_report'] = run_baseline_report()
        done('r baseline report')
        bench_line, counts_by_path['bench'] = run_bench(kind)
        done('j bench')
        stagings = time_staged(recs, staged)
        del staged
        fuse8_geometries = time_fuse8_geometries(recs)
        staged_encode = time_encode(encoded)
        del encoded, enc, x
        layers = {name: stage_breakdown(recs[name])
                  for name in ('int16_385ch', 'spiky_int16_385ch')}
        enc_layers = {name: encode_layers(recs[name])
                      for name in ('int16_385ch', 'spiky_int16_385ch')}
        kernels, off_path = time_kernels(calls, counts_by_path)
        del calls
        scan_shapes = time_scan_shapes()
        finalize_channels = time_finalize_channels()
        done('i timings, bulk paths and kernels')
        single_chunk = time_single_chunk(recs)
        windows_ms = time_windows(recs)
        routes_s = time_routes(recs)
        wide = time_wide(recs)
        auto['against_routes'] = auto_against_routes(
            auto, compress_s, routes_s, windows_ms)
        done('i timings, windows and routes')
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log('seconds by phase (host clock): %s' % json.dumps(rounded(phase_s)))

    require('jax' not in sys.modules, 'the port loaded JAX')
    require(not any(m.split('.')[0] == 'mtscomp_tpu' for m in sys.modules),
            'the port loaded the JAX package')
    # The summary sits next to the last line, so that a log that keeps
    # only the end of the output still holds every number.
    log(json.dumps({'bench': bench_line}))
    log(json.dumps(rounded({'build_s': build_s, 'native_build_s': native_s,
                            'phase_s': phase_s,
                            'ptxas': resources, 'dynamic_smem': smem,
                            'end_to_end': end_to_end,
                            'to_array_routes_s': routes_s,
                            'windows_ms': windows_ms,
                            'single_chunk': single_chunk,
                            'decompress_multi': multi,
                            'auto': auto, 'sharded': sharded,
                            'storm': storm_summary, 'entry': entry_run,
                            'baseline_report': baseline,
                            'bounded_batches': bounded, 'staged': stagings,
                            'fuse8_geometries': fuse8_geometries,
                            'wide': wide,
                            'layers_s': layers, 'compress_s': compress_s,
                            'staged_encode': staged_encode,
                            'encode_layers_s': enc_layers,
                            'scan_shapes': scan_shapes,
                            'finalize_channels': finalize_channels,
                            'held_against_twin_only': off_path})))
    log(json.dumps({'kernels': kernels}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
