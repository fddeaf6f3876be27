from .harness import mtscomp_perf, run_grid, format_report  # noqa: F401

__all__ = ['mtscomp_perf', 'run_grid', 'format_report']
# Plot helpers (matplotlib-gated) live in .plots: bar_chart, benchmark_plots.
