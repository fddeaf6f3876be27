"""Format transcoding: re-encode a compressed file without the raw data.

The reference can only convert formats by decompressing to a raw file
and recompressing it. Chunks are
independent and chunk bounds are format-invariant, so transcoding can
stream chunk-by-chunk instead: decode one chunk, re-diff with the
target transform flags, entropy-code with the target codec, append —
bounded memory, no intermediate raw file, and the source's
``sha1_uncompressed`` is re-derived along the way and cross-checked
(a transcode doubles as a full integrity audit of the source). An ans
source decodes, and an ans target encodes, on the configured device as
``Reader`` and ``Writer`` do (the GPU kernels by default), a bounded
batch of chunks at a time; every device writes the same bytes.

Use cases:

- ``zlib -> ans``: upgrade legacy reference-written files to the
  lane-parallel v2 format (better ratio, device decode);
- ``ans -> zlib``: export v2 files for consumers running the reference
  implementation — with identical chunk bounds the output is exactly
  what the reference would have written for the same raw data;
- ``ans -> ans``: re-encode with different parameters (e.g.
  ``ans_table_mode='segment'`` for channel-heterogeneous bands).

CLI: ``mtsrecompress in.cbin [in.ch] -o out.cbin [-a zlib|ans]
[--device DEVICE]``.
"""

import hashlib
from pathlib import Path

import numpy as np

from .codec import get_codec
from .config import read_config
from .device import configured_device
from .format import write_cmeta
from .ops.delta import diff_along_axis
from .parallel import pipeline
from .utils.misc import logger, progress


class _Target:
    """The target's coding parameters, under the names
    :class:`~.parallel.pipeline.DeviceBatchEncoder` reads off a
    ``Writer``, and the encode of a batch of decoded chunks on either
    route."""

    def __init__(self, codec, device, dtype, n_channels, chunk_order,
                 do_time_diff, time_diff_order, do_spatial_diff):
        self.codec = codec
        self.device = device
        self.dtype = self.code_dtype = np.dtype(dtype)
        self.n_channels = n_channels
        self.chunk_order = chunk_order
        self.do_time_diff = do_time_diff
        self.time_diff_order = time_diff_order
        self.do_spatial_diff = do_spatial_diff

    def _transform_chunk(self, chunk, order=None, spatial=None):
        """Delta stage: time diff (order 1 or 2), then spatial diff."""
        order = self.time_diff_order if order is None else order
        spatial = self.do_spatial_diff if spatial is None else spatial
        chunkd = diff_along_axis(chunk, axis=0 if self.do_time_diff else None)
        if self.do_time_diff and order == 2:
            chunkd = diff_along_axis(chunkd, axis=0)
        return diff_along_axis(chunkd, axis=1 if spatial else None)

    def _host_payloads(self, chunks):
        # Parts form when available: the caller streams each container
        # to the file without the multi-MB join.
        enc = getattr(self.codec, 'encode_parts', self.codec.encode)
        return [enc(self._transform_chunk(c), order=self.chunk_order)
                for c in chunks]

    def encode(self, chunks):
        """Payloads of ``chunks`` (arrays in the coding dtype), in order:
        on the device, each run of equal-shape chunks as one batch,
        where the target is ans and has one; the host codec otherwise,
        and for dtypes the device route declines (the same bytes)."""
        if self.device is None:
            return self._host_payloads(chunks)
        payloads, first = [], 0
        while first < len(chunks):
            last = first + 1
            while last < len(chunks) \
                    and chunks[last].shape == chunks[first].shape:
                last += 1
            run, first = chunks[first:last], last
            enc = pipeline.DeviceBatchEncoder(self, device=self.device)
            if enc.supported(run[0].shape[0]):
                payloads += enc.encode_batch(np.stack(run))
            else:
                pipeline.host_encoded_chunks += len(run)
                payloads += self._host_payloads(run)
        return payloads


def transcode(cdata, cmeta=None, out=None, outmeta=None, algorithm='ans',
              do_time_diff=None, do_spatial_diff=None, overwrite=False,
              quiet=False, device=None, **kwargs):
    """Re-encode a compressed file with another codec, chunk by chunk.

    Parameters mirror :func:`~.api.decompress` for the source and
    :func:`~.api.compress` for the target. ``device`` is where an ans
    source decodes and an ans target encodes (``'cuda'``, ``'cuda:N'``,
    ``'cpu'``, ``'none'`` for the host codec, ``'auto'``: by cost, as
    ``Reader`` and ``Writer`` decide); None takes the
    configuration's, as ``Reader`` and ``Writer`` do. ``do_time_diff`` /
    ``do_spatial_diff`` default to the source file's flags. Extra
    kwargs reach the target codec via the config merge
    (``ans_seg_log2``, ``ans_table_mode``, ...).

    Returns the new compression ratio (compressed bytes / raw bytes).
    Raises ``IOError`` if the source fails its stored
    ``sha1_uncompressed`` during the re-derivation.
    """
    from .api import _encodes_on_device, decompress
    if out is None:
        raise ValueError("transcode requires an explicit output path "
                         "(the default would shadow the input).")
    out = Path(out)
    outmeta = Path(outmeta) if outmeta is not None \
        else out.with_suffix('.ch')
    if out.resolve() == Path(cdata).resolve():
        raise ValueError("transcode output must not overwrite its input.")
    if not overwrite and (out.exists() or outmeta.exists()):
        raise ValueError("Output %s already exists (use overwrite=True)."
                         % (out if out.exists() else outmeta))

    cfg = read_config(**dict(kwargs, algorithm=algorithm, device=device))
    r = decompress(cdata, cmeta, quiet=True, device=cfg.device,
                   check_after_decompress=False)
    try:
        src = dict(r.cmeta)
        time_diff = bool(src.get('do_time_diff', True)
                         if do_time_diff is None else do_time_diff)
        if isinstance(do_spatial_diff, str):
            # 'auto' is a Writer-side probe of the raw file; a transcode
            # inherits the source's recorded flag (None) or an explicit
            # boolean — bool('auto') silently meaning True would be a trap.
            raise ValueError("transcode takes do_spatial_diff=None "
                             "(inherit) or a boolean, not %r."
                             % (do_spatial_diff,))
        spatial_diff = bool(src.get('do_spatial_diff', False)
                            if do_spatial_diff is None else do_spatial_diff)
        # Prediction order of the TARGET: inherit the source's recorded
        # order for ans targets (absent key = 1); zlib targets always
        # order 1 (reference byte-identity). Explicit override via
        # kwargs['time_diff_order'] (1 or 2).
        if kwargs.get('transform_adapt'):
            # Adaptive windows are a Writer-side probe schedule over the
            # raw recording; a transcode re-encodes chunk-by-chunk with
            # ONE target transform (adaptive SOURCES are fine — the
            # Reader already honors their per-chunk descriptors).
            raise ValueError("transcode does not take transform_adapt; "
                             "recompress from the raw file to adapt.")
        tdo = kwargs.get('time_diff_order')
        if isinstance(tdo, str):
            # 'auto' is a Writer-side probe of the raw file; a transcode
            # inherits the source's recorded order (None) or an explicit
            # 1/2 — same contract as the do_spatial_diff guard above.
            raise ValueError("transcode takes time_diff_order=None "
                             "(inherit) or 1 or 2, not %r." % (tdo,))
        diff_order = int(src.get('time_diff_order', 1)
                         if tdo is None else tdo)
        if algorithm != 'ans' or not time_diff:
            diff_order = 1
        if diff_order not in (1, 2):
            # diff_order (not tdo) so a bad SOURCE sidecar value is
            # named too — tdo is None on that path.
            raise ValueError("time_diff_order must be 1 or 2 for "
                             "transcode (got %r)." % (diff_order,))
        order = src.get('chunk_order', 'F')
        codec = get_codec(
            algorithm, seg_log2=cfg.get('ans_seg_log2', 16),
            channel_aligned=cfg.get('ans_channel_segments', True),
            table_mode=cfg.get('ans_table_mode', 'plane'))

        # Float sources re-encode with the target's float transform:
        # ans targets code the IEEE bit pattern as a same-width integer
        # (byte-exact round trips, see Writer.open); zlib targets keep
        # the reference's float-domain diff. The source's own domain is
        # already undone by the Reader (decoded chunks are raw floats).
        bitcast = (codec.name == 'ans' and r.dtype.kind == 'f'
                   and r.dtype.itemsize in (2, 4, 8))
        code_dtype = (np.dtype('int%d' % (r.dtype.itemsize * 8))
                      if bitcast else r.dtype)
        device = configured_device(cfg.device) if codec.name == 'ans' \
            else None
        if device is not None and cfg.device == 'auto' \
                and not _encodes_on_device(
                    r.n_samples * r.n_channels * r.dtype.itemsize, device):
            device = None              # 'auto' chose the host codec
        target = _Target(codec, device, code_dtype, r.n_channels, order,
                         time_diff, diff_order, spatial_diff)

        sha_u, sha_c = hashlib.sha1(), hashlib.sha1()
        offsets = [0]
        tmp = out.with_name(out.name + '.transcoding')
        try:
            with open(tmp, 'wb') as fb:
                for decoded in progress(r.decoded_batches(),
                                        desc='Transcoding', disable=quiet):
                    chunks = []
                    for _idx, chunk in decoded:
                        # C-order chunk bytes == the raw file's byte order
                        # (hashing the buffer directly avoids a tobytes
                        # copy).
                        chunk = np.ascontiguousarray(chunk)
                        sha_u.update(chunk)
                        chunks.append(chunk.view(code_dtype))
                    for payload in target.encode(chunks):
                        parts = (payload if isinstance(payload, list)
                                 else (payload,))
                        size = 0
                        for part in parts:
                            fb.write(part)
                            sha_c.update(part)
                            size += len(part)
                        offsets.append(offsets[-1] + size)
            want = src.get('sha1_uncompressed')
            # The audit only holds when the source decodes byte-exactly
            # (integers, or bitcast float files); legacy float files
            # decode within CHECK_ATOL, not bit-for-bit, so their
            # re-derived hash legitimately differs from the raw file's.
            exact_src = (r.dtype.kind in 'iu'
                         or getattr(r, 'float_bitcast', False))
            if want and exact_src and sha_u.hexdigest() != want:
                raise IOError(
                    "Source %s decodes to data that does not match its "
                    "sha1_uncompressed — refusing to transcode a corrupt "
                    "file." % cdata)
            tmp.replace(out)
        finally:
            tmp.unlink(missing_ok=True)

        cm = dict(src)
        # A live snapshot sidecar is a valid source, but the output is
        # a complete file — never inherit the in-progress marker.
        cm.pop('streaming', None)
        cm['algorithm'] = codec.name
        cm['version'] = codec.format_version
        cm['do_time_diff'] = time_diff
        cm['do_spatial_diff'] = spatial_diff
        cm['chunk_offsets'] = offsets
        cm['sha1_compressed'] = sha_c.hexdigest()
        cm['sha1_uncompressed'] = sha_u.hexdigest()
        cm.pop('ans_seg_log2', None)
        cm.pop('ans_table_mode', None)
        cm.pop('float_bitcast', None)
        cm.pop('time_diff_order', None)
        if time_diff and diff_order == 2:
            cm['time_diff_order'] = 2
        if codec.name == 'ans':
            cm['ans_seg_log2'] = codec.seg_log2
            if codec.table_mode != 'plane':
                cm['ans_table_mode'] = codec.table_mode
            if bitcast:
                cm['float_bitcast'] = True
        write_cmeta(outmeta, cm)
        n_bytes = r.shape[0] * r.shape[1] * r.dtype.itemsize
        ratio = offsets[-1] / n_bytes if n_bytes else 0.0
        logger.info("Transcoded %s (%s) -> %s (%s), -%.3f%%.",
                    cdata, src.get('algorithm'), out, codec.name,
                    100 - 100 * ratio)
        return ratio
    finally:
        r.close()
