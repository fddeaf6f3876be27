"""Run one cell of the benchmark of mtscomp_tpu_torch once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control]

From the root of a checkout that holds ``BENCHMARK.json``, on a machine
with the cards the cell asks for: without them the run prints no result
and exits with code 2. It makes the recording from ``--seed`` on the
card, writes it and encodes it through the program (set-up), warms up
one call, then makes the cell's calls one after another for
``--seconds`` (the window), and judges a sample of their answers against
the source with the plain reference once the window has closed.

Earlier lines give the card's name and power limit, the program's
kernel launches by form and the chunks it left to its host codec, and
the bytes written; the last lines of standard error give each number
the check compared beside its limit; the last line of standard output
is the result, one JSON object. ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` profiles the window, turns on the
program's phase spans, and reports its per-layer metrics. Each metric is
read by ``portbench/metrics/<name>.py``. ``--control`` puts a lossy
codec in the program's place (every sample loses its lowest bit), which
must come out not correct; the benchmark's own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mtscomp_tpu')


def load_cell(name, bench=None):
    """Everything one cell needs, from ``BENCHMARK.json`` (or ``bench``,
    a dict of the same form) and the files it names: the cell, its
    configuration and traffic, and the end-to-end and per-layer metrics it
    reports."""
    if bench is None:
        bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit('portbench: no workload %r in BENCHMARK.json' % name)
    cell = cells[name]
    config = next(c for c in bench['configs'] if c['name'] == cell['config'])

    def applies(metric):
        return name in metric.get('workloads', [name])

    return {
        'cell': cell,
        'config': json.loads((ROOT / config['file']).read_text()),
        'traffic': json.loads(
            (HERE / 'traffic' / (cell['traffic'] + '.json')).read_text()),
        'end_to_end': [m for m in bench['end_to_end'] if applies(m)],
        'per_layer': [m for m in bench['per_layer'] if applies(m)],
    }


def metric_reader(name):
    """``read(run)`` of ``portbench/metrics/<name>.py``."""
    path = HERE / 'metrics' / (name + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench.metrics.' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What the metric readers read: the window's calls, the set-up, and
    in a traced run the program's phase spans and the device trace."""

    def __init__(self, calls, t0, setup_s, ratio, spans, trace):
        self.calls, self.t0 = calls, t0
        self.setup_s, self.ratio = setup_s, ratio
        self.spans, self.trace = spans, trace

    @property
    def span_s(self):
        """From the window's start to the last call's completion."""
        return self.calls[-1][1] - self.t0

    @property
    def bytes(self):
        """Decoded (or, for ``compress``, raw) bytes of every call."""
        return sum(c[2] for c in self.calls)

    @property
    def coded_bytes(self):
        return sum(c[3] for c in self.calls)

    @property
    def latencies_ms(self):
        return [1e3 * (e - s) for s, e, _, _ in self.calls]


def card_line(device):
    """The card's name and power limit, from ``nvidia-smi``."""
    import torch
    index = device.index or 0
    try:
        limit = subprocess.run(
            ['nvidia-smi', '-i', str(index), '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip() or 'unknown'
    except (OSError, subprocess.SubprocessError):
        limit = 'unknown'
    return '%s, power limit %s' % (torch.cuda.get_device_name(index), limit)


def run_cell(spec, seed, seconds, trace, device, control=False, log=print):
    """Run the cell of ``spec`` (:func:`load_cell`) once on ``device`` (a
    ``torch.device``); returns the result's dict."""
    import torch
    import mtscomp_tpu_torch as mt
    from mtscomp_tpu_torch.utils import trace as mt_trace

    from . import calls as calls_mod
    from . import devtrace, signals

    config, traffic = spec['config'], spec['traffic']
    sig = config['signal']
    n_samples = int(round(traffic['recording_s'] * config['sample_rate']))
    cuda = device.type == 'cuda'
    steps = _Steps(log, T_START)
    if cuda:
        torch.cuda.init()
    steps('start, imports and the card')
    src = signals.walk(n_samples, config['n_channels'], sig['step_std'],
                       sig['clip'], seed, device)
    steps('the recording drawn')
    files = tempfile.mkdtemp(prefix='portbench-')
    kind = calls_mod.KINDS[traffic['call']](
        mt, config, traffic, src, files, device.type, seed % (1 << 63),
        control)
    try:
        kind.setup()
        steps('written and encoded')
        kind.warm()
        steps('one call to warm up')
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        mt.reset_launch_counts()
        mt_trace.enable_tracing(bool(trace))
        mt_trace.reset_stats()
        profile = (devtrace.profiled(os.path.join(files, 'trace.json'),
                                     device)
                   if trace else contextlib.nullcontext())
        name = 'portbench.' + traffic['call']
        record = []
        with profile:
            setup_s = time.perf_counter() - T_START
            t0 = time.perf_counter()
            failed = 0
            while time.perf_counter() - t0 < seconds:
                s = time.perf_counter()
                try:
                    with _span(name, trace):
                        done, coded = kind.call()
                except Exception as e:  # a failed call is counted
                    failed += 1
                    log('portbench: a call failed: %r' % (e,))
                    continue
                record.append((s, time.perf_counter(), done, coded))
        lat = sorted(e - s for s, e, _, _ in record)
        log('portbench: %d calls, seconds: min %s, median %s, max %s'
            % (len(lat), lat and lat[0], lat and lat[len(lat) // 2],
               lat and lat[-1]))
        spans = mt_trace.phase_stats() if trace else None
        mt_trace.enable_tracing(False)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        launches = mt.launch_counts()
        log('portbench: launches %s' % json.dumps(
            {k: v for k, v in launches.items() if v}))
        log('portbench: chunks left to the host codec: decode %d, encode %d'
            % (launches['host_fallback_chunks'],
               launches['host_encoded_chunks']))
        log('portbench: bytes written %d' % kind.written)
        kind.close()
        if cuda:
            torch.cuda.empty_cache()
        checks = kind.check()
        ratio = kind.ratio()
        tr = (devtrace.Trace.load(os.path.join(files, 'trace.json'))
              if trace else None)
    finally:
        shutil.rmtree(files, ignore_errors=True)

    run = Run(record, t0, setup_s, ratio, spans, tr)
    correct = failed == 0 and all(
        c['value'] <= c['at_most'] if 'at_most' in c
        else c['value'] >= c['at_least'] for c in checks.values())
    metrics = {}
    for m in spec['per_layer' if trace else 'end_to_end']:
        value = metric_reader(m['name'])(run) if record else None
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if cuda else device.type,
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': spec['cell']['chips'], 'memory_peak_bytes': peak}
    result = {'correct': correct, 'attempted': len(record) + failed,
              'failed': failed, 'metrics': metrics, 'device': dev}
    if trace:
        dev['busy_s'], dev['window_s'] = tr.busy_s, tr.window_s
        result['breakdown'] = {'device_ops': tr.device_ops(),
                               'idle_gaps': tr.idle_gaps()}
    result['checks'] = checks
    return result


class _Steps:
    """Logs the seconds each step of the set-up took."""

    def __init__(self, log, t):
        self.log, self.t = log, t

    def __call__(self, what):
        t = time.perf_counter()
        self.log('portbench: set-up %.3f s: %s' % (t - self.t, what))
        self.t = t


def _span(name, on):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def main(argv=None):
    p = argparse.ArgumentParser(prog='python3 -m portbench.run')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--control', action='store_true')
    args = p.parse_args(argv)
    spec = load_cell(args.workload)

    # Every build and kernel cache of the program stays in the checkout.
    for key, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ.setdefault(key, str(ROOT / '.portbench_cache' / sub))
    try:
        import mtscomp_tpu_torch  # noqa: F401
    except ImportError as e:
        print('portbench: the program cannot be imported: %s' % e,
              file=sys.stderr)
        return 2
    import torch
    chips = spec['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('portbench: this cell needs %d CUDA card(s); %d visible'
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    print('portbench: card %s' % card_line(device), flush=True)
    result = run_cell(spec, args.seed, args.seconds, args.trace, device,
                      control=args.control,
                      log=lambda s: print(s, flush=True))
    loaded = sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print('portbench: the run loaded %s' % ', '.join(loaded),
              file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        bound = ('<= %s' % c['at_most']) if 'at_most' in c \
            else ('>= %s' % c['at_least'])
        print('check %s %s %s' % (name, c['value'], bound), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
