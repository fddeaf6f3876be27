"""Run cells of the benchmark several times and report each metric's
spread, as the bounds in ``BENCHMARK.json`` are set from.

    python3 -m portbench.sets --workload <cell>[,<cell>...] --seeds 11,12,13
        --out DIR [--seconds S] [--trace 0|1] [--control]

Each run is a process of its own (``python3 -m portbench.run``), one
after another. Its output goes to ``DIR/<cell>.<run>.<seed>.<trace>.out`` and
``.err``; one JSON line a run, then one a cell, with each metric's
values, median and spread (the distance between the quartiles as a share
of the median), are printed.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from .stats import spread


def main(argv=None):
    p = argparse.ArgumentParser(prog='python3 -m portbench.sets')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--control', action='store_true')
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    with open('BENCHMARK.json') as f:
        seconds = args.seconds or json.load(f)['run_seconds']
    os.makedirs(args.out, exist_ok=True)
    for cell in args.workload.split(','):
        values = {}
        for k, seed in enumerate(args.seeds.split(',')):
            cmd = [sys.executable, '-m', 'portbench.run', '--workload', cell,
                   '--seed', seed, '--seconds', str(seconds),
                   '--trace', str(args.trace)] + (
                       ['--control'] if args.control else [])
            stem = os.path.join(args.out, '%s.%d.%s.%d' % (cell, k, seed,
                                                           args.trace))
            t0 = time.time()
            with open(stem + '.out', 'w') as out, \
                    open(stem + '.err', 'w') as err:
                rc = subprocess.run(cmd, stdout=out, stderr=err).returncode
            with open(stem + '.out') as f:
                lines = f.read().splitlines()
            try:
                result = json.loads(lines[-1])
            except (IndexError, ValueError):
                result = None
            print(json.dumps({'cell': cell, 'seed': seed, 'rc': rc,
                              'wall_s': time.time() - t0,
                              'result': result}), flush=True)
            for name, m in ((result or {}).get('metrics') or {}).items():
                values.setdefault(name, []).append(m['value'])
        summary = {name: {'values': v, 'median': statistics.median(v),
                          'spread': spread(v) if len(v) >= 2 else None}
                   for name, v in values.items()}
        print(json.dumps({'cell': cell, 'summary': summary}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
