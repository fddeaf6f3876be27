"""The recordings the benchmark compresses and reads, drawn from the seed.

One generator serves every configuration: a random walk over time per
channel, the walk of the repository's earlier benchmarks (the port's
``benchmarks/harness.py`` ``synth_walk`` and ``baseline_report``'s AP
and LFP signals), made on the card in a few large calls. Each step is
``round(N(0, 1) * std_c)``, summed over time in int32 (exact, so the
result does not depend on the order of the sum), clipped to ``+-clip``
and stored as int16. ``std_c`` sweeps log-uniformly over the channels
from ``step_std[0]`` to ``step_std[1]``: equal ends give the AP band's
flat walk, ``(3, 40)`` the LFP band's gradient along the shank.

``clip=None`` stores the sum modulo 2**16 instead. The codec codes the
time diffs in int16's modular arithmetic, so it then sees the steps
themselves, and the ratio does not depend on how long a channel spends
at a rail, which the seed would decide: a walk of steps up to 40 leaves
+-30000 on most channels within a few minutes.

A rig of several probes (a configuration's ``probes``) draws each probe
with :func:`walk` from its own seed, :func:`probe_seed`: probe 0 takes
the run's seed, so a one-probe configuration draws what it always drew,
and probe ``p >= 1`` the first 63 bits of NumPy's ``SeedSequence`` of
``(seed mod 2**63, p)``.
"""

import numpy as np

#: Elements drawn per call (512 MB of float32 at once on the card).
BLOCK_ELEMENTS = 1 << 27


def channel_stds(n_channels, step_std):
    lo, hi = step_std
    return np.logspace(np.log10(lo), np.log10(hi), n_channels)


def probe_seed(seed, probe):
    """The seed :func:`walk` draws probe ``probe`` of a rig with."""
    seed = int(seed) % (1 << 63)
    if probe == 0:
        return seed
    state = np.random.SeedSequence([seed, probe]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def walk(n_samples, n_channels, step_std, clip, seed, device):
    """An ``(n_samples, n_channels)`` int16 ndarray, the same for the same
    arguments on the same kind of device."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    std = torch.tensor(channel_stds(n_channels, step_std),
                       dtype=torch.float32, device=device)
    out = torch.empty((n_samples, n_channels), dtype=torch.int16)
    rows = max(1, BLOCK_ELEMENTS // n_channels)
    carry = torch.zeros(n_channels, dtype=torch.int32, device=device)
    for i0 in range(0, n_samples, rows):
        n = min(rows, n_samples - i0)
        steps = torch.randn((n, n_channels), generator=gen, device=device)
        steps = steps.mul_(std).round_().to(torch.int32)
        steps[0] += carry
        steps = torch.cumsum(steps, dim=0, dtype=torch.int32)
        carry = steps[-1].clone()
        if clip is not None:
            steps.clamp_(-clip, clip)
        out[i0:i0 + n].copy_(steps.to(torch.int16))
    return out.numpy()
