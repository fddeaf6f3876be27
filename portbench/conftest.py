"""pytest settings of the benchmark's own tests (``portbench/tests``).

Tests that need a CUDA card carry the ``chip`` marker and skip inside
the test where none is visible."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers',
        'chip: needs a CUDA card; skips inside the test without one')
