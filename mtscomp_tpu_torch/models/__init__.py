"""Entropy models: symbol statistics and coding tables for the rANS codec."""

from .rans import (  # noqa: F401
    SCALE_BITS, SCALE, RANS_L, MIN_FREQ, LANES, GROUP_ROWS,
    quantize_freqs, quantize_freqs_batch, cumulative_freqs, encoder_tables,
    zigzag_encode, zigzag_decode,
    rans_encode_group, rans_decode_group, group_steps,
)
