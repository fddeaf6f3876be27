"""PyTorch port: the port imports neither JAX nor the JAX package.

A static check over every Python file of ``mtscomp_tpu_torch/`` and
``chip_smoke.py``: no ``import`` or ``from ... import`` names ``jax``
or ``mtscomp_tpu`` (or a module under either), at any depth of the
file. ``test_torch_pipeline.py::test_port_never_imports_jax`` holds the
same at run time.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(REPO))
               for p in (REPO / 'mtscomp_tpu_torch').rglob('*.py')
               if '_build' not in p.parts) + ['chip_smoke.py']
BANNED = ('jax', 'mtscomp_tpu')


def imported_modules(tree):
    """Absolute module names the file's import statements name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def banned(name):
    return name is not None and name.split('.')[0] in BANNED


def test_the_walk_sees_the_port():
    assert 'mtscomp_tpu_torch/parallel/pipeline.py' in FILES
    assert 'mtscomp_tpu_torch/codec/ans.py' in FILES
    for name in ('verify.py', 'transcode.py', 'stream.py', 'cli.py',
                 'parallel/distributed.py', 'utils/trace.py',
                 'benchmarks/__init__.py', 'benchmarks/harness.py',
                 'benchmarks/baseline_report.py', 'benchmarks/plots.py',
                 'bench.py'):
        assert 'mtscomp_tpu_torch/' + name in FILES
    assert len(FILES) >= 26


@pytest.mark.parametrize('name', FILES)
def test_no_jax_or_reference_import(name):
    tree = ast.parse((REPO / name).read_text(), filename=name)
    found = sorted({m for m in imported_modules(tree) if banned(m)})
    assert not found, '%s imports %s' % (name, found)


def test_the_check_catches_a_reference_import():
    """The walk finds imports nested in functions and both forms."""
    src = ("def f():\n    import jax.numpy as jnp\n"
           "from mtscomp_tpu.codec import ans\nimport numpy\n")
    assert sorted(m for m in imported_modules(ast.parse(src))
                  if banned(m)) == ['jax.numpy', 'mtscomp_tpu.codec']
    assert not banned('mtscomp_tpu_torch.codec')
