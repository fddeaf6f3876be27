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
d. make seeded Neuropixels-like recordings (30 kHz, 1-s chunks) and
   compress them with the port's own host codec (``device='none'``,
   ans v2):
   - the fuse8 path: random walks with diff std 6, 32 s x 385 int16
     channels, 8 s x 384 channels and 8 s x 385 uint16 channels;
   - the generic path: 32 s x 385 int16 channels of the same walk with
     spikes (a -60, -90, +150 step over 3 samples, 5 per channel per
     second), which code both byte planes;
   - the branches, 2 s each at 385 channels: second-order time diff on
     the fuse8 route (an LFP-like band) and the generic route, C order
     (plane tables), spatial diff, flags bit6 without the tail packing,
     uint8, int8, int32, bitcast float32 under a second-order diff, a
     RAW low plane, and tables from another writer needing one and two
     fixups; and 8 s each, a file whose plane modes change after 4 s
     (walk, then spikes) and a drifting file compressed with adaptive
     windows of 4 chunks (walk, then a slow oscillation);
c. hold every kernel form against its plain PyTorch twin on the card,
   at the shapes the decode of those files gives it (byte equality),
   K6 on the encode's B=8 batches of both 32-s files; hold K4's plane
   form against its twin and against the plane combine + element form
   (or the finalize) on batches with two coded planes, a CONST and a RAW
   plane; run every form of K4 and K5 on the scan edge shapes
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
   the normative coder; and decode the CPU tests' small geometries on
   the card;
e-g. decode path by path, with every launch count set to 0 just before
   and read just after: decode each file through
   ``mtscomp_tpu_torch.decompress(..., device='cuda')`` with
   ``.to_array()`` and ``.tofile()`` (and ``.to_tensor()`` for the two
   32-s files), check each byte for byte against its source, check
   that every kernel form of the path was launched and that no chunk
   went to the host codec;
h. drop one word, then half the words, of one group's stream and
   expect the word audit's IOError, on both routes;
k. encode path by path (the two 32-s files, then the branch files),
   counts set to 0 just before and read just after: compress each
   through ``mtscomp_tpu_torch.compress(..., device='cuda')``, check the
   ``.cbin`` and ``.ch`` are byte-identical to the host route's, that K6
   launched and that no chunk went to the host codec (int32 excepted:
   ``supported()`` declines it, and all its chunks must go there), and
   decode each device-encoded file through the port to its source;
i. time the staged decodes (the batch staged on the card once, CUDA
   events, median of repeats) and K1 alone on the whole-file batch
   (B=32, 128 groups), K6 and the device encode staged at B=8
   (checked against the host codec first), ``compress()`` of the 32-s
   files on both routes and by layer, each kernel form against its
   twin, its bound and, where one PyTorch call computes the same
   function, that call, and the scans alone at B=2 and B=32
   (``SCAN_SHAPES``), with K3 at B=32, and K2 over channel counts on
   and off the 32-byte sector grid (``FINALIZE_CHANNELS``).

The last four lines are a JSON summary of the end-to-end and staged
timings (with the kernel forms no path launches, which are held
against their twins only), a JSON object with one entry per kernel
form that the paths launch (its launches in total and by path, its
time, its twin's, its bound and the library call's), the card's name
and power limit, and ``{"ok": true, "device": {"platform": "gpu",
...}}``. Without a CUDA GPU it exits with code 2 and prints no result.
"""

import json
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
from mtscomp_tpu_torch import native
from mtscomp_tpu_torch.models import rans
from mtscomp_tpu_torch.models.rans import GROUP_ROWS, LANES
from mtscomp_tpu_torch.ops import _build
from mtscomp_tpu_torch.ops import device_delta as dd
from mtscomp_tpu_torch.ops import rans_decode as rd
from mtscomp_tpu_torch.ops import rans_encode as renc
from mtscomp_tpu_torch.ops.tables import pack_device_tables
from mtscomp_tpu_torch.parallel.pipeline import (
    DeviceBatchDecoder, DeviceBatchEncoder, _decode_fuse8, _rans_planes,
    _read_payload, check_words_used, fuse8_planes, generic_elems,
    generic_planes)

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
    'rans_encode_groups (K6)': (
        'rans_encode', 'mtscomp_tpu_torch/csrc/rans_encode.cu',
        'mtscomp_tpu/ops/pallas_rans_enc.py:86'),
}

#: ptxas entry-name fragments (all of them in the mangled name) -> the
#: kernel it compiles. K4 and K5 are three passes: segment totals, their
#: prefixes (one kernel, compiled into both sources), the seeded scan.
#: The finalize is K4's kernels behind their finalize load stage: K2 with
#: one channel block, K3 with a tail block.
PTXAS_NAMES = (
    (('rans_decode_groups_kernelILi0E',), 'K1 octet'),
    (('rans_decode_groups_kernelILi1E',), 'K1 coarse 1'),
    (('rans_decode_groups_kernelILi2E',), 'K1 coarse 2'),
    (('scan_transposed_totals_kernel', 'ElemLoadIsE'), 'K4 i16 totals'),
    (('scan_transposed_totals_kernel', 'ElemLoadIiE'), 'K4 i32 totals'),
    (('scan_transposed_totals_kernel', 'PlaneLoad'), 'K4 planes totals'),
    (('scan_transposed_totals_kernel', 'FinalizeLoadILb0E'), 'K2 totals'),
    (('scan_transposed_totals_kernel', 'FinalizeLoadILb1E'), 'K3 totals'),
    (('scan_transposed_kernel', 'ElemLoadIsE'), 'K4 i16 scan'),
    (('scan_transposed_kernel', 'ElemLoadIiE'), 'K4 i32 scan'),
    (('scan_transposed_kernel', 'PlaneLoad'), 'K4 planes scan'),
    (('scan_transposed_kernel', 'FinalizeLoadILb0E'), 'K2 scan'),
    (('scan_transposed_kernel', 'FinalizeLoadILb1E'), 'K3 scan'),
    (('cumsum_time_totals_kernelIsE',), 'K5 i16 totals'),
    (('cumsum_time_totals_kernelIiE',), 'K5 i32 totals'),
    (('cumsum_time_scan_kernelIsE',), 'K5 i16 scan'),
    (('cumsum_time_scan_kernelIiE',), 'K5 i32 scan'),
    (('seg_prefix_kernel',), 'K4/K5 prefix'),
    (('rans_encode_groups_kernel',), 'K6'))

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
#: options, foreign writer's minimum frequency or None, expected
#: (route, rANS planes, bit6, K1 fixups) of its first batch, or None where
#: the modes or the transform change between chunks). Route 'fuse8' or
#: 'generic'.
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
                       dict(ORDER1, ans_table_mode='plane'), 16,
                       ('fuse8', 1, True, 1)),
    'foreign_2fixups': ('heavy', BRANCH_SECONDS, 385, 'int16', 15,
                        dict(ORDER1, ans_table_mode='plane'), 9,
                        ('generic', 2, False, 2)),
    # One batch of 8 chunks: 4 with a constant high byte, then 4 with
    # both planes coded (two mode-uniform device sub-batches).
    'mixed_modes': ('walk_then_spiky', SHORT_SECONDS, 385, 'int16', 16,
                    dict(ORDER1, n_threads=BATCH), None, None),
    # Windows of 4 chunks re-probe the transform (bit5 stamps).
    'adaptive': ('walk_then_slow', SHORT_SECONDS, 385, 'int16', 17,
                 {'transform_adapt': 4, 'n_threads': BATCH}, None, None),
}

#: Paths, each driven with the counts set to 0 just before it: name ->
#: (recordings, kernel forms that must have launched, forms that must
#: not). The generic decode of 2-byte data goes from K1 into K4's plane
#: form; K4's int16 element form stays on the branches through the
#: bit6 layouts (uint8, int8, a RAW low plane), its int32 form through
#: the 4-byte files, K5 through C order, the spatial diffs and order 2.
PATHS = {
    'fuse8': (('int16_385ch', 'int16_384ch', 'uint16_385ch'),
              ('rans_decode_octet', 'finalize_u8', 'finalize_u8_tail'), ()),
    'generic': (('spiky_int16_385ch',),
                ('rans_decode_octet', 'scan_planes_i16_seeded'),
                ('scan_transposed_i16_seeded',)),
    'branches': (tuple(name for name, r in RECORDINGS.items()
                       if r[1] == BRANCH_SECONDS)
                 + ('mixed_modes', 'adaptive'),
                 ('rans_decode_octet', 'rans_decode_coarse_1fixup',
                  'rans_decode_coarse_2fixups', 'finalize_u8_tail',
                  'scan_planes_i16_seeded', 'scan_transposed_i16_seeded',
                  'scan_transposed_i32_seeded', 'cumsum_time_i16',
                  'cumsum_time_i32'), ()),
}

#: Encode paths, each driven with the counts set to 0 just before it:
#: name -> (recordings, kernel forms that must have launched). Files from
#: another writer's tables are not this writer's bytes, and bitcast
#: float32 codes 4-byte integers, which the device encode declines.
ENCODE_PATHS = {
    'encode_main': (('int16_385ch', 'spiky_int16_385ch'), ('rans_encode',)),
    'encode_branches': (('int16_384ch', 'uint16_385ch', 'order2_fuse8',
                         'order2_generic', 'c_order', 'spatial',
                         'bit6_spatial', 'uint8', 'int8', 'int32',
                         'raw_low_plane', 'mixed_modes', 'adaptive'),
                        ('rans_encode',)),
}
#: Recordings whose every chunk the device route must leave to the host
#: codec (``supported()`` declines 4-byte integers).
HOST_ENCODED = {'int32'}
ENCODED = {name for names, _forms in ENCODE_PATHS.values() for name in names}

#: The forms some path launches. The others, K4's inclusive scans, run
#: only for chunks without a stored head, which this codec's writer
#: never makes (it stores one for every 2-D chunk): they are held against
#: their twins and timed, and reported apart from the path kernels.
ON_PATH = {form for paths in (PATHS, ENCODE_PATHS)
           for _names, forms, *_not in paths.values() for form in forms}


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
    32), the (B, C, T') byte planes ``lo`` and ``hi`` and the per-chunk
    constants ``lo_const`` and ``hi_const``. The port's CPU tests import
    it from here."""
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
    for bits in (16, 32):
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
    play), float32 by 0.25 (bitcast to int32 by the writer)."""
    w = walk.astype(np.int64)
    if dtype == 'float32':
        return (walk * 0.25).astype(np.float32)
    if dtype == 'int32':
        return (w * 1001).astype(np.int32)
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
    """Seeded signal, written one 1-s chunk at a time. The kinds
    ``walk_then_spiky`` and ``walk_then_slow`` switch from the walk to
    the spiky walk or the slow oscillation halfway through."""
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
                       'walk_then_slow': 'walk'}.get(kind, kind)
                walk = level + np.cumsum(
                    signal_second(rng, sub, n_channels), axis=0)
            level = walk[-1]
            block = to_dtype(walk, dtype)
            arr[s * SR:(s + 1) * SR] = block
            f.write(block.tobytes())
    return arr


class Recording:
    """A compressed test recording and its source samples."""

    def __init__(self, workdir, name):
        (kind, seconds, n_channels, dtype, seed, opts, min_freq,
         self.expect) = RECORDINGS[name]
        self.name = name
        self.raw = workdir / (name + '.bin')
        self.cbin = workdir / (name + '.cbin')
        self.ch = workdir / (name + '.ch')
        self.workdir = workdir
        self.kwargs = dict(sample_rate=float(SR), n_channels=n_channels,
                           dtype=dtype, algorithm='ans', quiet=True,
                           check_after_compress=False, **opts)
        t0 = time.perf_counter()
        self.arr = make_recording(self.raw, kind, seconds, n_channels, dtype,
                                  seed)
        t1 = time.perf_counter()
        quantize_rows = ans_codec._quantize_rows
        if min_freq is not None:
            ans_codec._quantize_rows = foreign_quantizer(min_freq)
        try:
            mt.compress(self.raw, self.cbin, self.ch, device='none',
                        **self.kwargs)
        finally:
            ans_codec._quantize_rows = quantize_rows
        t2 = time.perf_counter()
        #: compress() on the host route, host clock (s).
        self.host_compress_s = t2 - t1
        if name not in ENCODED:
            self.raw.unlink()
        log('d. %s: %d s x %d ch %s (%s), %.1f MB raw -> %.1f MB (x%.3f); '
            'made in %.1f s, host compress %.1f s'
            % (name, seconds, n_channels, dtype, kind, self.arr.nbytes / 1e6,
               self.cbin.stat().st_size / 1e6,
               self.arr.nbytes / self.cbin.stat().st_size, t1 - t0, t2 - t1))

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

    def reader(self):
        # The smoke test compares every byte itself: no host re-decode.
        return mt.decompress(self.cbin, self.ch, device=DEVICE, quiet=True,
                             check_after_decompress=False)

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
        ``n_chunks`` chunks, staged on the card; checks the file has the
        layout its name promises."""
        r = self.reader()
        parsed = [r.codec.parse(_read_payload(r, i))
                  for i in range(min(n_chunks, r.n_chunks))]
        dec = DeviceBatchDecoder(r, DEVICE)
        require(dec.supported(parsed, SR), '%s: batch not supported'
                % self.name)
        fn, args = dec.pack(parsed, SR)
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


def cuda_ms(fn, reps, inner=1):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls,
    per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def max_abs_err(a, b, mask=None):
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    if mask is not None:
        d = d[mask]
    return int(d.max()) if d.numel() else 0


def compare(kernel, twin, args, kwargs, live=None):
    """A kernel and its twin on the same card tensors: (max_abs_err,
    kernel output). With ``live``, the outputs are K1's (symbols, words
    used) and only the live symbol columns count."""
    got = kernel(*args, **kwargs)
    ref = twin(*args, **kwargs)
    torch.cuda.synchronize()
    if live is None:
        require(got.shape == ref.shape and got.dtype == ref.dtype,
                'kernel %s %s, twin %s %s' % (tuple(got.shape), got.dtype,
                                              tuple(ref.shape), ref.dtype))
        err = max_abs_err(got, ref)
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


def check_kernels(recs):
    """Phase c: every kernel form against its twin at the path's shapes.
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
                 'foreign_1fixup', 'foreign_2fixups', 'order2_generic',
                 'raw_low_plane'):
        r, parsed, fn, args = recs[name].staged()
        k1_name, kernel, twin, k1_args, k1_kw = k1_calls(fn, args)
        live = (torch.arange(k1_args[-1] * LANES, device=args[4].device)
                < args[4][:, :, None].long())
        syms, _used = record(k1_name, kernel, twin, k1_args, k1_kw, live)
        const_vals, raw_vals, heads = args[5], args[6], args[7]
        kw = fn.keywords
        done = [k1_name]
        if fn.func is _decode_fuse8:
            bulk, tail_block = fuse8_planes(syms, B=kw['B'], G=kw['G'],
                                            k=kw['k'], tp=kw['tp'],
                                            tail=kw['tail'])
            hi = const_vals[:, 0]
            if tail_block is None:
                key, kernel, twin = ('finalize_u8 (K2)',
                                     dd.cumsum_time_transposed_u8,
                                     dd.cumsum_time_transposed_u8_ref)
                f_args = (bulk, heads, hi)
            else:
                key, kernel, twin = ('finalize_u8, tail form (K3)',
                                     dd.cumsum_time_transposed_u8_tail,
                                     dd.cumsum_time_transposed_u8_tail_ref)
                cA = bulk.shape[1]
                f_args = (bulk, tail_block, heads[:, :cA], heads[:, cA:], hi)
            out = record(key, kernel, twin, f_args, {'n_samples': SR})
            done.append(key)
            # The finalize is the plane form with a CONST high plane (its
            # two channel blocks joined here): two load stages, one result.
            C = heads.shape[1]
            lo = bulk[:, :C] if tail_block is None else torch.cat(
                [bulk, tail_block[:, :C - bulk.shape[1]]], dim=1)
            check_plane_form(held, (lo[:, :, :SR - 1], hi), heads, True, out)
            done.append('K4 plane form (CONST high plane) = %s'
                        % key.split('(')[1][:2])
        else:
            lay = kw['lay']
            elems = generic_elems(syms, const_vals, raw_vals, lay)
            width = 'int32' if lay.itemsize == 4 else 'int16'
            ct = elems.view(lay.B, lay.C, lay.Tc)
            out = record('scan_transposed %s, head-seeded (K4)' % width,
                         dd.cumsum_time_transposed,
                         dd.cumsum_time_transposed_ref, (ct, heads),
                         {'n_samples': SR})
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
    kernels made of the same batch."""
    out = record('scan_transposed planes int16, head-seeded (K4)',
                 dd.cumsum_time_transposed_planes,
                 dd.cumsum_time_transposed_planes_ref, planes + (heads,),
                 {'n_samples': SR, 'zigzag': zigzag})
    require(torch.equal(out, want), 'K4\'s plane form differs from the '
            'route\'s other kernels on the same batch')
    record('scan_transposed planes int16, inclusive (K4)',
           dd.cumsum_time_transposed_planes,
           dd.cumsum_time_transposed_planes_ref, planes + (None,),
           {'zigzag': zigzag})


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
        '(element and plane forms) and K5 equal their twins'
        % (len(SCAN_EDGE_CASES), n))


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
            dt, n_host, n_chunks = recs[name].device_compress()
            want = n_chunks if name in HOST_ENCODED else 0
            require(n_host == want, '%s: %d chunks went to the host codec, '
                    'expected %d' % (name, n_host, want))
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
        want = sum(recs[n].arr.shape[0] // SR for n in names
                   if n in HOST_ENCODED)
        require(counts['host_encoded_chunks'] == want,
                '%d chunks went to the host codec on the %s path, expected '
                '%d' % (counts['host_encoded_chunks'], path, want))
    return times, counts_by_path


def encode_layers(rec):
    """compress() of a whole 32-s file by layer, host clock, one Writer
    batch (8 chunks) at a time as its device route runs them: read (the
    memmapped chunks), then the encoder's layers (each ends in a
    synchronize). Write-back, hashing and the sidecar are not in it."""
    w, _ = rec.writer_batch(1)
    try:
        enc = DeviceBatchEncoder(w, device=DEVICE)
        enc.profile = {'read': 0.0}
        t_all = time.perf_counter()
        for b0 in range(0, w.n_chunks, BATCH):
            t0 = time.perf_counter()
            chunks = np.stack([np.asarray(w.get_chunk(i)) for i in
                               range(b0, min(b0 + BATCH, w.n_chunks))])
            enc.profile['read'] += time.perf_counter() - t0
            enc.encode_batch(chunks)
        total = time.perf_counter() - t_all
    finally:
        w.close()
    return dict(enc.profile, total_s=total, raw_mb=rec.arr.nbytes / 1e6)


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
            require(np.array_equal(t.cpu().numpy(), rec.arr),
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
                recs[name], with_tensor=RECORDINGS[name][1] == SECONDS)
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
        arr = recs[name].arr[:len(parsed) * SR]
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
#: batch its paths launch, and every int16 form and the finalize at B=32
#: (a whole 32-s file in one batch); (kernel form, chunks).
SCAN_SHAPES = (('cumsum_time int16 (K5)', 2), ('cumsum_time int32 (K5)', 2),
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
        dtype = torch.int32 if 'i32' in key else torch.int16
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
    for width, size in (('i16', 2), ('i32', 4)):       # at 385 channels
        smem['K4 %s scan' % width] = lib.mts_scan_transposed_smem_bytes(
            385, dd.scan_transposed_geometry(385, size)[1])
        smem['K5 ' + width] = lib.mts_cumsum_time_smem_bytes(
            385, *dd.cumsum_time_geometry(385, size), size)
    # The finalize runs K4's int16 scan: K2 at 384 channels, K3 at 385.
    smem['K2 scan, 384 ch'] = lib.mts_scan_transposed_smem_bytes(
        384, dd.scan_transposed_geometry(384, 2)[1])
    smem['K3 scan, 385 ch'] = smem['K4 i16 scan']
    log('b. dynamic shared memory a block (bytes): %s' % json.dumps(smem))
    # The host codec's C++ runtime builds at first use: before any timing.
    t0 = time.perf_counter()
    require(native.available(), 'the native host library did not build')
    native_s = time.perf_counter() - t0
    log('b. built (or reused) %s in %.1f s'
        % (native.library_path().name, native_s))

    workdir = Path(tempfile.mkdtemp(prefix='mtscomp_smoke_'))
    try:
        recs = {name: Recording(workdir, name) for name in RECORDINGS}
        calls, staged = check_kernels(recs)
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
        end_to_end, counts_by_path = drive_paths(recs)
        check_audit(staged)
        compress_s, encode_counts = drive_encode_paths(recs)
        counts_by_path.update(encode_counts)
        stagings = time_staged(recs, staged)
        del staged
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
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    require('jax' not in sys.modules, 'the port loaded JAX')
    require(not any(m.split('.')[0] == 'mtscomp_tpu' for m in sys.modules),
            'the port loaded the JAX package')
    # The summary sits next to the last line, so that a log that keeps
    # only the end of the output still holds every number.
    log(json.dumps(rounded({'build_s': build_s, 'native_build_s': native_s,
                            'ptxas': resources, 'dynamic_smem': smem,
                            'end_to_end': end_to_end, 'staged': stagings,
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
