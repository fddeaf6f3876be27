"""Benchmark figures: faceted grouped-bar charts over harness results.

Parity with the reference's plot generator (benchmark.py:100-204,
``PlotParams``/``benchmark_plots``: grouped bars of each timing target
over the parameter grid), redesigned around this framework's harness:
the input is the plain list-of-dicts that :func:`..benchmarks.run_grid`
returns, and the figure layout is derived from column names instead of
a plot-dimension spec object.

Requires matplotlib (optional dependency — everything else in the
package runs without it).

Usage::

    from mtscomp_tpu_torch.benchmarks import run_grid
    from mtscomp_tpu_torch.benchmarks.plots import bar_chart, benchmark_plots

    rows = run_grid(duration=10.0)
    fig = bar_chart(rows, metric='read_mbps', group_by='algorithm',
                    bar_by='n_threads')
    fig.savefig('read_throughput.png')

    benchmark_plots('bench_plots/')      # the standard panel
"""

from collections import OrderedDict


def _unique(rows, key):
    """Distinct values of ``key`` across rows, in first-seen order."""
    seen = OrderedDict()
    for r in rows:
        if key in r:
            seen.setdefault(r[key], None)
    return list(seen)


def bar_chart(rows, metric, group_by, bar_by=None, facet_by=None, ax=None):
    """Grouped-bar chart of ``metric`` from harness result rows.

    rows     : list of dicts (``run_grid`` output)
    metric   : numeric column to plot (bar height)
    group_by : column forming the x-axis groups
    bar_by   : column forming the bars within each group (optional)
    facet_by : column splitting the figure into subplot columns (optional)

    Returns the matplotlib figure (or ``ax.figure`` when ``ax`` given,
    in which case ``facet_by`` must be None).
    """
    import matplotlib.pyplot as plt
    import numpy as np

    facets = _unique(rows, facet_by) if facet_by else [None]
    if ax is not None:
        assert facet_by is None, "pass either ax or facet_by"
        fig, axes = ax.figure, [ax]
    else:
        fig, axes = plt.subplots(1, len(facets), squeeze=False,
                                 figsize=(5 * len(facets), 3.5))
        axes = list(axes[0])

    for facet, a in zip(facets, axes):
        sub = [r for r in rows if facet_by is None or r.get(facet_by) == facet]
        groups = _unique(sub, group_by)
        bars = _unique(sub, bar_by) if bar_by else [None]
        index = np.arange(len(groups), dtype=float)
        width = 0.75 / max(len(bars), 1)

        def value(g, b):
            for r in sub:
                if r.get(group_by) == g and (b is None
                                             or r.get(bar_by) == b):
                    return r.get(metric, 0)
            return 0

        for bi, b in enumerate(bars):
            heights = [value(g, b) for g in groups]
            label = None if b is None else '%s=%s' % (bar_by, b)
            a.bar(index + bi * width, heights, width, label=label)
        a.set_xticks(index + width * (len(bars) - 1) / 2)
        a.set_xticklabels([str(g) for g in groups])
        a.set_xlabel(group_by)
        a.set_ylabel(metric)
        if facet is not None:
            a.set_title('%s=%s' % (facet_by, facet))
        if bar_by:
            a.legend(fontsize='small')
    fig.tight_layout()
    return fig


def benchmark_plots(output_dir=None, rows=None, duration=5.0):
    """Render the standard benchmark panel (one figure per metric).

    Runs the default harness grid when ``rows`` is not supplied; writes
    ``<metric>.png`` files into ``output_dir`` when given. Returns the
    dict ``{metric: figure}``.
    """
    from .harness import run_grid
    if rows is None:
        rows = run_grid(duration=duration)
    figs = {}
    for metric in ('ratio', 'write_mbps', 'read_mbps', 'window_ms'):
        figs[metric] = bar_chart(rows, metric=metric, group_by='algorithm',
                                 bar_by='n_threads', facet_by='dataset')
    if output_dir is not None:
        from pathlib import Path
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for metric, fig in figs.items():
            fig.savefig(out / ('%s.png' % metric), dpi=120)
    return figs


if __name__ == '__main__':  # pragma: no cover
    import sys
    benchmark_plots(sys.argv[1] if len(sys.argv) > 1 else 'bench_plots')
    print('wrote benchmark figures')
