"""Exact per-row byte histograms for the device encode, the port's
counterpart of ``mtscomp_tpu/ops/device_hist.py`` (``histogram256``).

The JAX package counts with nibble one-hot matmuls on the TPU's matrix
unit, because scatter-adds serialize there; on the H100 a plain torch
``bincount`` over row-offset bins is exact and needs no kernel of its
own. Rows are counted in blocks of about 2^25 values, which bounds the
int32 bin-index tensor at 128 MB.
"""

import torch

BLOCK = 1 << 25          # values per bincount call


def histogram256(v):
    """(N, n) uint8 -> (N, 256) int64: the count of each byte value in
    each row."""
    if v.dtype != torch.uint8 or v.dim() != 2:
        raise ValueError("histogram256 takes (N, n) uint8, got %s %s"
                         % (v.dtype, tuple(v.shape)))
    N, n = v.shape
    out = torch.zeros((N, 256), dtype=torch.int64, device=v.device)
    rows = max(1, BLOCK // max(n, 1))
    for r0 in range(0, N if n else 0, rows):
        blk = v[r0:r0 + rows]
        k = blk.shape[0]
        idx = blk.to(torch.int32) + 256 * torch.arange(
            k, dtype=torch.int32, device=v.device)[:, None]
        out[r0:r0 + k] = torch.bincount(idx.reshape(-1),
                                        minlength=256 * k).view(k, 256)
    return out
