"""The six-probe rig's cell, ``ap6_multi_to_array``, run whole on the CPU
at a tiny size (the kernels' plain twins standing in for the card): its
check separates sound runs from the control and from a merged decode
broken underneath, and its traced run reads ``decompress_multi``'s
counters. The faults are planted in the samples that
``DeviceBatchDecoder._decode_shards`` returns, which every decode onto a
device reaches (``decode_batch``, so ``decompress_multi``, and
``decode_tensor``, so ``Reader.to_array`` and ``.to_tensor``)."""

import json

import pytest
import torch

from mtscomp_tpu_torch.parallel import pipeline
from portbench import run

CELL = 'ap6_multi_to_array'
SEED = 2**31 + 29


def _tiny(cell, batch_chunks=0):
    """The cell at 1 kHz, 40 channels and 6 s a probe (6 chunks)."""
    spec = run.load_cell(cell)
    spec['config']['sample_rate'] = 1000.0
    spec['config']['n_channels'] = 40
    spec['config']['reader'] = dict(spec['config']['reader'],
                                    batch_chunks=batch_chunks)
    spec['traffic']['recording_s'] = 6
    return spec


def _run(cell=CELL, trace=0, control=False, batch_chunks=0):
    return run.run_cell(_tiny(cell, batch_chunks), SEED, 0.5, trace,
                        torch.device('cpu'), control=control,
                        log=lambda s: None)


def test_the_cell_is_a_rig_of_six_384_channel_probes():
    spec = run.load_cell(CELL)
    assert spec['config']['probes'] == 6
    assert spec['config']['n_channels'] == 384
    assert spec['traffic'] == {'call': 'multi_to_array', 'recording_s': 16}
    assert spec['cell']['chips'] == 1
    names = {m['name'] for m in spec['per_layer']}
    assert {'multi.merged_share', 'multi.recopied_bytes_per_byte'} <= names


def test_a_sound_run_is_correct_and_the_control_is_not():
    res = _run()
    assert res['correct'] and res['failed'] == 0 and res['attempted'] >= 1
    names = {m['name'] for m in run.load_cell(CELL)['end_to_end']}
    assert set(res['metrics']) == names
    json.dumps(res)
    control = _run(control=True)
    assert not control['correct']
    assert control['checks']['samples_wrong']['value'] > 0


@pytest.mark.parametrize('batch_chunks, recopied', [(0, 0.0), (12, 1.0)])
def test_a_traced_run_reads_the_merge_counters(batch_chunks, recopied):
    """One batch a call (the arrays are views of it) copies nothing
    more; batches of 12 chunks (2 a probe, 3 a call) copy every decoded
    byte once more."""
    res = _run(trace=1, batch_chunks=batch_chunks)
    assert res['correct']
    # On the CPU no device operation is traced and nothing is copied to
    # or from a card, and a call of one batch assembles nothing: every
    # other metric has something to read.
    absent = {'multi.transfer_bytes_per_byte'} | (
        set() if batch_chunks else {'multi.assemble_s_per_gb'})
    listed = {m['name'] for m in run.load_cell(CELL)['per_layer']
              if m['source'] != 'device_trace'} - absent
    assert listed <= set(res['metrics'])
    assert res['metrics']['multi.merged_share']['value'] == 100.0
    assert res['metrics']['multi.recopied_bytes_per_byte']['value'] == \
        recopied


def test_a_program_without_the_counters_leaves_the_metrics_out(
        monkeypatch):
    real = pipeline.count

    def count(name, n=1):
        if not name.startswith('decode.multi_'):
            real(name, n)
    monkeypatch.setattr(pipeline, 'count', count)
    res = _run(trace=1)
    assert res['correct']
    assert 'multi.merged_share' not in res['metrics']
    assert 'multi.recopied_bytes_per_byte' not in res['metrics']


def _fault(fault, probes):
    """``_decode_shards`` with ``fault`` planted in the samples it
    returns: the decode left undone (zeros), the later half of the batch
    zeroed, the first two probes' chunks swapped (a batch holds its
    chunks probe by probe), or one sample altered."""
    real = pipeline.DeviceBatchDecoder._decode_shards

    def decode_shards(self, parsed_list, n_samples, mesh=None):
        out = []
        for s in real(self, parsed_list, n_samples, mesh):
            if fault == 'unchanged':
                out.append(torch.zeros_like(s))
                continue
            s = s.clone()
            per = len(s) // probes
            if fault == 'half':
                s[(len(s) + 1) // 2:] = 0
            elif fault == 'swapped':
                s[:2 * per] = torch.cat([s[per:2 * per], s[:per]])
            else:
                s.view(-1)[s.numel() // 3] += 1
            out.append(s)
        return out
    return decode_shards


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'swapped',
                                   'altered'])
def test_a_broken_merged_decode_is_not_correct(monkeypatch, fault):
    probes = run.load_cell(CELL)['config']['probes']
    monkeypatch.setattr(pipeline.DeviceBatchDecoder, '_decode_shards',
                        _fault(fault, probes))
    res = _run()
    assert not res['correct'], res['checks']
    assert res['checks']['samples_wrong']['value'] > 0


@pytest.mark.parametrize('cell, batch_chunks', [
    (CELL, 0), (CELL, 12), ('ap_to_array', 0), ('ap_to_tensor', 0)])
def test_every_timed_decode_reaches_the_fault_seam(monkeypatch, cell,
                                                   batch_chunks):
    """Every chunk of every call, the warm-up's too, passes through
    ``_decode_shards``: the merged decode's batches and, on
    ``Reader.to_array``'s and ``.to_tensor``'s route, ``decode_tensor``'s."""
    real, chunks = pipeline.DeviceBatchDecoder._decode_shards, []

    def spy(self, parsed_list, n_samples, mesh=None):
        chunks.append(len(parsed_list))
        return real(self, parsed_list, n_samples, mesh)
    monkeypatch.setattr(pipeline.DeviceBatchDecoder, '_decode_shards', spy)
    res = _run(cell, batch_chunks=batch_chunks)
    assert res['correct'] and res['failed'] == 0
    probes = run.load_cell(cell)['config'].get('probes', 1)
    assert sum(chunks) == 6 * probes * (res['attempted'] + 1)
    if batch_chunks:
        assert max(chunks) == batch_chunks
