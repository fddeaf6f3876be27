"""Entry points on the GPU: a one-card decode step and a multi-card
dry run, the port's counterpart of ``__graft_entry__.py``.

``entry()`` returns the flagship decode step, grouped rANS decode (K1)
-> byte-plane combine -> inverse zigzag -> time integration (K5), with
small example tensors staged as the pipeline stages a group.

``dryrun_multichip(n)`` runs one full codec step over a mesh of n
devices (:func:`~.parallel.mesh.chunk_mesh`): the groups sharded over a
chunk axis, each shard decoded (K1), re-encoded (K6) and left-aligned;
a (B, T, C) int16 batch sharded over chunks and channels through the
delta transform and back (K5); the partial checksums summed onto the
first device. It checks every stage and raises on a failure.

Run both over the visible cards with ``python -m
mtscomp_tpu_torch.entry``.
"""

import sys

import numpy as np
import torch

from .device import resolve_device
from .models import rans
from .ops.device_delta import (cumsum_time, diff_time, zigzag_decode,
                               zigzag_encode)
from .ops.rans_decode import decode_groups
from .ops.rans_encode import (encode_groups, left_align, pack_encoder_tables,
                              symbol_capacity)
from .ops.tables import pack_device_tables
from .parallel.mesh import chunk_mesh, on_device


def _example_groups(n_groups=2, seg=1024, seed=0):
    """Encode a small batch of segment groups for the example args:
    ``(states (n, 32, 128) uint32, words (n, W) uint16, freq_rows (n, 32,
    256) int32, counts (n, 32) int32, n_steps, data, n_words)``, ``data``
    the int16 samples whose zigzag low bytes the groups code."""
    R = rans.GROUP_ROWS
    rng = np.random.default_rng(seed)
    data = np.round(rng.normal(0, 6, size=n_groups * R * seg)).astype(np.int16)
    z = rans.zigzag_encode(data)
    lo = (z & 255).astype(np.uint8)
    counts256 = np.bincount(lo, minlength=256)
    freqs = rans.quantize_freqs(counts256)
    states = np.zeros((n_groups, R, 128), np.uint32)
    words_l, S = [], seg // 128
    for g in range(n_groups):
        rows = [lo[(g * R + r) * seg:(g * R + r + 1) * seg]
                for r in range(R)]
        st, wd = rans.rans_encode_group(rows, np.tile(freqs, (R, 1)))
        states[g] = st
        words_l.append(wd)
    W = 1 << int(np.ceil(np.log2(max(w.size for w in words_l) + 1)))
    words = np.zeros((n_groups, W), np.uint16)
    for g, wd in enumerate(words_l):
        words[g, :wd.size] = wd
    freq_rows = np.tile(freqs.astype(np.int32), (n_groups, R, 1))
    counts = np.full((n_groups, R), seg, np.int32)
    n_words = np.array([w.size for w in words_l], np.int32)
    return states, words, freq_rows, counts, S, data, n_words


def _stage(states, words, freq_rows, counts, device):
    """K1's input tensors on ``device``, staged as
    :meth:`~.parallel.pipeline.DeviceBatchDecoder.pack` stages a group:
    the word stream in rows of 128 lanes, no more rows than the longest
    stream fills, octet and dense tables of
    :func:`~.ops.tables.pack_device_tables` per row. uint32 and uint16
    travel as int32 and int16 bits."""
    N, R = counts.shape
    staged = np.zeros((N, -(-words.shape[1] // rans.LANES) * rans.LANES),
                      np.uint16)
    staged[:, :words.shape[1]] = words
    octet = np.zeros((N, R, rans.LANES), np.int32)
    dense = np.zeros((N, R, 256), np.int32)
    tables = {}
    for n in range(N):
        for r in range(R):
            key = freq_rows[n, r].tobytes()
            if key not in tables:
                _coarse, dpk, _two, opk = pack_device_tables(freq_rows[n, r])
                if opk is None:
                    raise ValueError("a table off the 8-slot grid has no "
                                     "octet form")
                tables[key] = (opk, dpk.reshape(256))
            octet[n, r], dense[n, r] = tables[key]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (put(states.view(np.int32)), put(staged.view(np.int16)),
            put(octet), put(dense), put(counts))


def _decode_step(n_steps):
    """The decode step: K1, the byte-plane combine (each group row's
    symbols in the JAX scan decoder's (step, row, lane) order, pairs of
    bytes little-endian), the inverse zigzag, then K5 over (N, T, 128)."""
    def forward(states, words, octet_pk, dense_pk, counts):
        syms, _used = decode_groups(states, words, octet_pk, dense_pk,
                                    counts, n_steps)
        N, R, _ = syms.shape
        flat = syms.view(N, R, n_steps, rans.LANES).transpose(1, 2) \
            .reshape(N, -1)
        d = zigzag_decode(flat.view(torch.int16))
        return cumsum_time(d.view(N, -1, rans.LANES))
    return forward


def entry(device=None):
    """``(fn, example_args)`` for the flagship decode step on ``device``
    (``'cuda'`` by default, where ``fn`` launches K1 and K5; ``'cpu'``
    runs their plain twins). ``fn(*example_args)`` is a (2, 128, 128)
    int16 tensor equal to the JAX ``entry()``'s output on the same seed.
    """
    device = resolve_device('cuda' if device is None else device)
    states, words, freqs, counts, S, _, _ = _example_groups()
    return _decode_step(S), _stage(states, words, freqs, counts, device)


def _mesh_grid(n_devices, devices):
    """The mesh and its ``(dp, mp)`` factorisation: chunk shard i and
    channel shard j on ``mesh[i * mp + j]``."""
    mesh = chunk_mesh(devices) if devices is not None \
        else chunk_mesh(n_devices=n_devices)
    if len(mesh) != n_devices:
        raise ValueError("a dry run over %d devices was given %d"
                         % (n_devices, len(mesh)))
    dp = n_devices // 2 if n_devices % 2 == 0 else n_devices
    return mesh, dp, n_devices // dp


def dryrun_multichip(n_devices, devices=None):
    """Shard the full codec step over an ``n_devices`` mesh and run it once.

    ``devices`` lists the mesh's devices (the default: the first
    ``n_devices`` CUDA devices; ``['cpu'] * n`` runs the twins, each CPU
    entry standing for a card). The mesh is ``dp`` chunk shards by ``mp``
    channel shards, ``dp = n // 2`` for even n, else n: the JAX dry run's
    factorisation. Each device decodes its chunk shard's groups (K1),
    re-encodes the symbols (K6) and left-aligns the streams; its
    (chunks, channels) block of a raw int16 batch goes through diff,
    zigzag, inverse zigzag and K5; its partial checksum is copied onto
    the first device and summed there (plain tensor copies: no
    collective library).

    Self-checking at every stage, as the JAX dry run: each device's
    symbols equal the plaintext the groups were encoded from and each
    group consumed its stream; the re-encode gives back the states, the
    word counts and the merged streams bit for bit; the transform round
    trip is exact; the total is not 0. Raises RuntimeError on any
    failure; returns the total.
    """
    mesh, dp, mp = _mesh_grid(n_devices, devices)
    n_groups = dp * 2
    seg = 1024
    (states, words, freqs, counts, S, data,
     n_words) = _example_groups(n_groups=n_groups, seg=seg)
    pk, rcp = pack_encoder_tables(freqs)
    R = rans.GROUP_ROWS
    expected_rows = (rans.zigzag_encode(data) & 255).astype(
        np.uint8).reshape(n_groups, R, seg)
    W = words.shape[1]
    # Raw chunk batch for the transform side: (B, T, C) sharded over
    # chunks (batch) and channels.
    B, T, C = dp * 2, 64, 128 * mp
    chunks = np.random.default_rng(1).integers(-1000, 1000, size=(B, T, C),
                                               dtype=np.int16)
    gs, bs, cs = n_groups // dp, B // dp, C // mp

    launched = []
    for i in range(dp):
        g = slice(i * gs, (i + 1) * gs)
        for j in range(mp):
            dev = mesh[i * mp + j]
            with on_device(dev):
                k1_args = _stage(states[g], words[g], freqs[g], counts[g],
                                 dev)
                syms, used = decode_groups(*k1_args, S)
                enc_args = (syms, torch.from_numpy(pk[g]).to(dev),
                            torch.from_numpy(rcp[g]).to(dev), k1_args[4],
                            symbol_capacity(counts[g]))
                st2, words2, nw2 = encode_groups(*enc_args)
                x = torch.from_numpy(np.ascontiguousarray(
                    chunks[i * bs:(i + 1) * bs, :, j * cs:(j + 1) * cs])
                ).to(dev)
                back = cumsum_time(zigzag_decode(zigzag_encode(
                    diff_time(x))))
                local = (syms.to(torch.int64).sum()
                         + (st2 & 0xFF).to(torch.int64).sum()
                         + nw2.to(torch.int64).sum()
                         + back.to(torch.int64).sum())
            launched.append((i, j, syms, used, st2, words2, nw2, back, local))

    # Every launch is queued before the first fetch, so cards overlap.
    total = sum(local.to(mesh[0]) for *_, local in launched)
    for i, j, syms, used, st2, words2, nw2, back, _local in launched:
        g = slice(i * gs, (i + 1) * gs)
        where = 'device %d (chunk shard %d, channel shard %d)' % (
            i * mp + j, i, j)
        # 1. Entropy stage: the decode equals the known plaintext.
        if not (np.array_equal(syms.cpu().numpy(), expected_rows[g])
                and np.array_equal(used.cpu().numpy(), n_words[g])):
            raise RuntimeError("sharded entropy decode wrong on %s" % where)
        # 2. The re-encode gives back the states and the merged streams.
        flat, nw = left_align(words2, nw2)
        stream2 = np.zeros((gs, W), np.uint16)
        offs = np.concatenate([[0], np.cumsum(nw)])
        for k in range(gs):
            stream2[k, :nw[k]] = flat[offs[k]:offs[k + 1]]
        if not np.array_equal(st2.cpu().numpy().view(np.uint32), states[g]):
            raise RuntimeError("re-encode states differ on %s" % where)
        if not np.array_equal(nw, n_words[g]):
            raise RuntimeError("re-encode stream lengths differ on %s"
                               % where)
        if not np.array_equal(stream2, words[g]):
            raise RuntimeError("re-encode merged streams differ on %s"
                               % where)
        # 3. The transform round trip is exact.
        if not np.array_equal(back.cpu().numpy(), chunks[
                i * bs:(i + 1) * bs, :, j * cs:(j + 1) * cs]):
            raise RuntimeError("transform round trip differs on %s" % where)
    total = int(total)
    if total == 0:
        raise RuntimeError("the checksum is 0")
    return total


def main():
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print('entry ok:', tuple(out.shape), out.dtype)
    n = torch.cuda.device_count()
    total = dryrun_multichip(n)
    print('dryrun ok: %d devices, checksum %d' % (n, total))
    return 0


if __name__ == '__main__':
    sys.exit(main())
