"""BENCHMARK.json against the benchmark's contract, and every file it
names present."""

import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}')
TEXT = re.compile(r'[^\t\n]{1,200}')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert isinstance(BENCH['run_seconds'], int)
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 << 10


def test_command_and_paths():
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', p)
        assert not p.startswith('/') and '..' not in p.split('/')
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH['command']) <= 32
    for word in BENCH['command']:
        assert TEXT.fullmatch(word) and not word.startswith('/')
        assert '..' not in word


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_are_unique_and_plain(section):
    names = [e['name'] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.fullmatch(n), n


def test_configs():
    used = {w['config'] for w in BENCH['workloads']}
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['name'] in used
        assert TEXT.fullmatch(c['source']) and TEXT.fullmatch(c['why'])
        assert c['file'].startswith(tuple(p + '/' for p in BENCH['paths']))
        config = json.loads((ROOT / c['file']).read_text())
        assert len(c['reduced']) <= 16
        for key in c['reduced']:
            assert NAME.fullmatch(key) and key in config['reduced']
        assert 'assumed' in config and 'guarantees' in config
        for w in BENCH['workloads']:
            if w['config'] == c['name']:
                traffic = json.loads((ROOT / 'portbench' / 'traffic' / (
                    w['traffic'] + '.json')).read_text())
                run.check_config(c['name'], config, traffic['call'])


def test_workloads():
    configs = {c['name'] for c in BENCH['configs']}
    pairs = set()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in configs and w['chips'] in (1, 4)
        assert NAME.fullmatch(w['traffic']) and TEXT.fullmatch(w['why'])
        assert (ROOT / 'portbench' / 'traffic'
                / (w['traffic'] + '.json')).is_file()
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)


def _cells(metric):
    return metric.get('workloads',
                      [w['name'] for w in BENCH['workloads']])


@pytest.mark.parametrize('section', ['end_to_end', 'per_layer'])
def test_metrics(section):
    cells = {w['name'] for w in BENCH['workloads']}
    keys = {'name', 'unit', 'better', 'source'} | (
        {'bound'} if section == 'end_to_end' else {'layer', 'moves'})
    for m in BENCH[section]:
        assert set(m) - {'workloads'} == keys, m['name']
        assert UNIT.fullmatch(m['unit']) and m['better'] in ('lower',
                                                            'higher')
        assert m['source'] in SOURCES
        assert set(_cells(m)) <= cells
        assert (ROOT / 'portbench' / 'metrics'
                / (m['name'] + '.py')).is_file()
        if section == 'end_to_end':
            assert m['source'] in ('host_clock', 'device_trace')
            assert 0.01 <= m['bound'] <= 0.25
    assert 1 <= len(BENCH['end_to_end']) <= 16
    assert 1 <= len(BENCH['per_layer']) <= 128


def test_every_per_layer_metric_lists_its_cells_and_moves_one_metric():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    layers = {}
    for m in BENCH['per_layer']:
        assert isinstance(m['workloads'], list) and m['workloads']
        assert m['moves'] in e2e
        assert TEXT.fullmatch(m['layer'])
        # Each listed cell reports the metric it moves.
        assert set(m['workloads']) <= set(_cells(e2e[m['moves']]))
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH['workloads']:
        e2e = [m['name'] for m in BENCH['end_to_end']
               if w['name'] in _cells(m)]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert any(w['name'] in m['workloads'] for m in BENCH['per_layer'])
    setup = next(m for m in BENCH['end_to_end'] if m['name'] == 'setup_s')
    assert setup['bound'] <= 0.25


def test_run_seconds_fit_a_check_of_24_cells():
    runs = 2 + 14 * 24
    assert (runs * (BENCH['run_seconds'] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
