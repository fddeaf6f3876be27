"""Standalone integrity audit of a compressed pair — no raw file needed.

The reference can only verify a compressed file against the original
raw data (``check()``, mtscomp.py:866-888); once the raw file is
deleted — the whole point of compressing — nothing can audit the
archive. ``verify_file`` audits the pair in place:

1. **Structure**: sidecar schema, monotone chunk bounds/offset tables,
   payload size == offset-table end, parseable dtype.
2. **Payload hash**: SHA1 of the ``.cbin`` vs ``sha1_compressed``.
3. **Deep decode** (default): every chunk is decoded with the format's
   own corruption machinery live (per-chunk CRC32, frequency-table
   validation, stream-word consumption audit), and the decoded bytes
   re-derive ``sha1_uncompressed`` — for byte-exact formats (integers,
   bitcast floats) this proves the archive reproduces the original
   recording bit for bit, without the original. An ans file decodes on
   the configured device as every ``Reader`` does (the GPU kernels by
   default, their word audit live), a bounded batch at a time.

CLI: ``mtsverify data.cbin [data.ch] [--fast] [--device DEVICE]``.
"""

import hashlib
from pathlib import Path

import numpy as np

from .format import cmeta_sidecar_path, read_cmeta
from .utils.misc import logger, progress

#: Checks that :func:`verify_file` can report (in report order).
CHECKS = ('sidecar', 'structure', 'payload_size', 'sha1_compressed',
          'chunks_decode', 'sha1_uncompressed')


def _structure_issues(cm, payload_size):
    """Structural sidecar problems as a list of strings."""
    issues = []
    bounds = cm.get('chunk_bounds')
    offsets = cm.get('chunk_offsets')
    if not bounds or not offsets:
        return ["sidecar lacks chunk_bounds/chunk_offsets"]
    if len(bounds) != len(offsets):
        issues.append("chunk_bounds (%d) and chunk_offsets (%d) lengths "
                      "differ" % (len(bounds), len(offsets)))
    if bounds[0] != 0:
        issues.append("chunk_bounds must start at 0 (got %s)" % bounds[0])
    if offsets[0] != 0:
        issues.append("chunk_offsets must start at 0 (got %s)" % offsets[0])
    if any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
        issues.append("chunk_bounds are not strictly increasing")
    if any(o1 <= o0 for o0, o1 in zip(offsets, offsets[1:])):
        issues.append("chunk_offsets are not strictly increasing "
                      "(zero-byte chunk payloads are invalid)")
    try:
        dt = np.dtype(cm.get('dtype'))
    except TypeError:
        issues.append("dtype %r is not a valid numpy dtype"
                      % (cm.get('dtype'),))
        dt = None
    nc = cm.get('n_channels')
    if not isinstance(nc, int) or nc <= 0:
        issues.append("n_channels %r is not a positive int" % (nc,))
    if dt is not None and isinstance(nc, int) and nc > 0 \
            and not cm.get('chopped'):
        # Chopped sidecars keep the pre-chop shape (reference parity:
        # mtscomp.py:787-793 copies cmeta and truncates only the
        # bounds/offsets), so the shape check only applies otherwise.
        shape = cm.get('shape')
        if shape and int(np.prod(shape)) != bounds[-1] * nc:
            issues.append("shape %s does not cover n_samples x n_channels "
                          "(%d x %d)" % (shape, bounds[-1], nc))
    if payload_size != offsets[-1]:
        issues.append("payload is %d bytes but the offset table ends at %d"
                      % (payload_size, offsets[-1]))
    return issues


def verify_file(cdata, cmeta=None, deep=True, quiet=False, n_threads=None,
                device=None):
    """Audit a compressed pair; returns a report dict.

    Report keys: ``ok`` (bool), ``issues`` (list of strings, empty when
    ok) and ``checks`` (check name -> 'ok' / 'skipped (...)' / the
    failure message). Raises ``OSError`` only when the files themselves
    cannot be read; verification *failures* are reported, not raised.

    ``deep=False`` skips the chunk decode (hash + structure only).
    ``device`` is where the deep pass decodes an ans file (``'cuda'``,
    ``'cuda:N'``, ``'cpu'``, ``'none'`` for the host codec, ``'auto'``);
    None takes the configuration's, as ``Reader`` does. The report is the
    same on every device.
    """
    cdata = Path(cdata)
    cmeta_path = Path(cmeta) if cmeta is not None \
        else cmeta_sidecar_path(cdata)
    issues = []
    checks = {}

    try:
        cm = read_cmeta(cmeta_path)
        checks['sidecar'] = 'ok'
    except (ValueError, AssertionError) as e:
        # Unparseable JSON / non-dict: nothing else can run.
        msg = "sidecar %s is not a valid .ch file (%s)" % (cmeta_path, e)
        return dict(ok=False, issues=[msg], checks={'sidecar': msg})

    payload_size = cdata.stat().st_size
    struct_issues = _structure_issues(cm, payload_size)
    issues += struct_issues
    checks['structure'] = struct_issues[0] if struct_issues else 'ok'
    checks['payload_size'] = (
        'ok' if not any('payload is' in s for s in struct_issues)
        else 'MISMATCH')

    # -- payload hash -------------------------------------------------------
    want_c = cm.get('sha1_compressed')
    sha_c = hashlib.sha1()
    with open(cdata, 'rb') as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            sha_c.update(block)
    if not want_c:
        # chop() nulls the hashes (reference semantics, mtscomp.py:791-793).
        checks['sha1_compressed'] = 'skipped (sidecar has no hash)'
    elif sha_c.hexdigest() == want_c:
        checks['sha1_compressed'] = 'ok'
    else:
        msg = ("payload SHA1 %s does not match the sidecar's %s"
               % (sha_c.hexdigest(), want_c))
        issues.append(msg)
        checks['sha1_compressed'] = 'MISMATCH'

    if not deep:
        checks['chunks_decode'] = 'skipped (--fast)'
        checks['sha1_uncompressed'] = 'skipped (--fast)'
        return dict(ok=not issues, issues=issues, checks=checks)

    # -- deep decode: CRC + table validation + word audits run inline -------
    if any('chunk_offsets' in s or 'chunk_bounds' in s or 'dtype' in s
           for s in struct_issues):
        checks['chunks_decode'] = 'skipped (structure invalid)'
        checks['sha1_uncompressed'] = 'skipped (structure invalid)'
        return dict(ok=False, issues=issues, checks=checks)

    from .api import Reader
    kwargs = dict(quiet=True, check_after_decompress=False)
    if device is not None:
        kwargs['device'] = device
    if n_threads:
        kwargs['n_threads'] = n_threads
    r = Reader(**kwargs)
    r.open(cdata, cmeta_path)
    sha_u = hashlib.sha1()
    bad_decode = None
    try:
        batches = progress(r.decoded_batches(), desc='Verifying',
                           disable=quiet)
        try:
            for decoded in batches:
                for _i, chunk in decoded:
                    sha_u.update(np.ascontiguousarray(chunk))
        except IOError as e:
            bad_decode = str(e)
    finally:
        exact = r.dtype.kind in 'iu' or getattr(r, 'float_bitcast', False)
        r.close()
    if bad_decode:
        issues.append(bad_decode)
        checks['chunks_decode'] = bad_decode
        checks['sha1_uncompressed'] = 'skipped (decode failed)'
        return dict(ok=False, issues=issues, checks=checks)
    checks['chunks_decode'] = 'ok'

    want_u = cm.get('sha1_uncompressed')
    if not want_u:
        checks['sha1_uncompressed'] = 'skipped (sidecar has no hash)'
    elif not exact:
        # Legacy float files decode within CHECK_ATOL, not bit-for-bit:
        # their re-derived hash legitimately differs from the raw file's.
        checks['sha1_uncompressed'] = \
            'skipped (float-domain decode is not byte-exact)'
    elif sha_u.hexdigest() == want_u:
        checks['sha1_uncompressed'] = 'ok'
    else:
        msg = ("decoded data SHA1 %s does not match the sidecar's %s"
               % (sha_u.hexdigest(), want_u))
        issues.append(msg)
        checks['sha1_uncompressed'] = 'MISMATCH'

    ok = not issues
    if not quiet:
        logger.info("Verified %s: %s.", cdata, 'OK' if ok else 'FAILED')
    return dict(ok=ok, issues=issues, checks=checks)
