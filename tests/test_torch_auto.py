"""PyTorch port: the measured ``'auto'`` route (``parallel/pipeline.py``
``link_profile`` / ``host_profile``, ``api.py`` ``Writer._use_device`` /
``Reader._use_device(window=)``).

Twins of the JAX package's auto-routing tests (``tests/test_device.py``:
relay against PCIe links, the measured host rate, ``host_profile``
measuring and caching, the CPU link's (0, inf), small files and 8-byte
dtypes deciding before any probe), and a cross-test: given the same
profiles, constants and CPU count, the port decides as the JAX package
does over a grid of links, host rates, file sizes and windows. No test
probes a link or writes ``~/.cache``: the autouse fixture pins the
port's host profile, empties its link profiles and points its disk cache
at ``tmp_path``. A GPU is simulated by patching
``torch.cuda.is_available`` (and the JAX package's backend to ``'tpu'``,
as its own tests do); nothing is launched.
"""

import multiprocessing

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu.api as jax_api  # noqa: E402
from mtscomp_tpu.parallel import pipeline as jpl  # noqa: E402

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.api as api  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as pl  # noqa: E402

from conftest import make_signal, to_int16, write_arr  # noqa: E402

#: The port's disk-cache location, before the fixture redirects it.
CACHE_PATH = pl._profile_cache_path
CONSTANTS = ('AUTO_DEVICE_MIN_BYTES', 'DEV_DECODE_KERNEL_RATE',
             'DEV_ENCODE_RATE_CAP', 'HOST_POOL_SCALING_CORES')
RELAY, PCIE = (0.030, 10e6), (0.0002, 10e9)
#: host_profile() of the card's machine (chip_smoke.py phase p, PERF.md).
HOST_OF_THE_CARD = (343e6, 553e6)


@pytest.fixture(autouse=True)
def _pin_profiles(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setattr(pl, '_HOST_PROFILE', (300e6, 250e6))
    monkeypatch.setattr(pl, '_LINK_PROFILE', {})
    monkeypatch.setattr(pl, '_profile_cache_path',
                        lambda name: str(tmp_path / 'cache' / name))


@pytest.fixture
def gpu(monkeypatch):
    """A visible GPU as far as the decisions can tell ('auto' resolves to
    'cuda'); CUDA itself is never initialized."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')


def _link(monkeypatch, link):
    monkeypatch.setattr(pl, '_LINK_PROFILE', {0: link})


def _file(tmp_path, name, arr, sr, **opts):
    path = write_arr(tmp_path / (name + '.bin'), arr)
    cbin, ch = tmp_path / (name + '.cbin'), tmp_path / (name + '.ch')
    mt.compress(path, cbin, ch, sample_rate=float(sr),
                n_channels=arr.shape[1], dtype=str(arr.dtype),
                algorithm='ans', quiet=True, device='none',
                check_after_compress=False, **opts)
    return path, cbin, ch


def _writer(path, arr, sr, **kw):
    w = mt.Writer(algorithm='ans', quiet=True, device='auto', **kw)
    w.open(path, sample_rate=float(sr), n_channels=arr.shape[1],
           dtype=str(arr.dtype))
    return w


def test_link_profile_of_the_cpu_is_zero_and_inf(monkeypatch):
    """CPU tensors are host memory: (0, inf), before any cache is read
    (a card's profile on disk must not shadow it) and with nothing
    stored."""
    pl._store_profile_cache('link_profile_cuda0.json', pl._LINK_KEYS,
                            (0.03, 10e6))
    monkeypatch.setattr(pl, '_load_profile_cache', lambda *a: (
        _ for _ in ()).throw(AssertionError('cache read for the CPU')))
    for device in ('cpu', torch.device('cpu')):
        assert pl.link_profile(device=device) == (0.0, float('inf'))
    assert pl._LINK_PROFILE == {}


def test_link_profile_is_cached_per_card_under_the_ports_cache(tmp_path):
    """A card's profile is served from this process's cache, else from
    the disk cache of its index, which lives under the port's own
    directory, never the JAX package's."""
    assert CACHE_PATH('link_profile_cuda0.json').endswith(
        '.cache/mtscomp_tpu_torch/link_profile_cuda0.json')
    assert 'mtscomp_tpu/' not in CACHE_PATH('host_profile.json')
    pl._store_profile_cache('link_profile_cuda1.json', pl._LINK_KEYS,
                            (0.002, 3e9))
    assert (tmp_path / 'cache' / 'link_profile_cuda1.json').exists()
    assert pl.link_profile(device='cuda:1') == (0.002, 3e9)
    assert pl._LINK_PROFILE == {1: (0.002, 3e9)}
    pl._LINK_PROFILE[0] = (0.001, 1e9)
    # 'cuda' is the current card: 0 while CUDA is not initialized.
    assert pl.link_profile(device='cuda') == (0.001, 1e9)


def test_host_profile_measures_and_caches(tmp_path, monkeypatch):
    """host_profile() measures real single-core codec rates (finite,
    positive) and stores them; a fresh process state reads the cache
    back instead of measuring again."""
    monkeypatch.setattr(pl, '_HOST_PROFILE', None)
    enc, dec = pl.host_profile()
    assert 0 < enc < float('inf')
    assert 0 < dec < float('inf')
    assert (tmp_path / 'cache' / 'host_profile.json').exists()
    monkeypatch.setattr(pl, '_HOST_PROFILE', None)
    monkeypatch.setattr(pl, '_measure_host_rates', lambda: (
        _ for _ in ()).throw(AssertionError('measured again')))
    assert pl.host_profile() == (enc, dec)


def test_auto_routing_follows_the_link_profile(tmp_path, monkeypatch, gpu):
    """Relay-grade links (30 ms sync, 10 MB/s) keep bulk decodes and
    windows on the host, PCIe-grade ones (0.2 ms, 10 GB/s) take the card;
    the Writer's choice follows the same profile against a slow host
    encoder; windows on the host route read the right samples."""
    monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', 0)
    sr, nc = 16000, 120
    arr = to_int16(make_signal('colored', ns=4 * sr, nc=nc))
    path, cbin, ch = _file(tmp_path, 'l', arr, sr)
    r = mt.decompress(cbin, ch, quiet=True, device='auto')
    try:
        assert r.device == torch.device('cuda')
        _link(monkeypatch, RELAY)
        assert r._use_device() is False
        assert r._use_device(window=(0, sr)) is False
        assert r._use_device(window=(0, 4 * sr)) is False
        assert np.array_equal(r[700:2300], arr[700:2300])
        _link(monkeypatch, PCIE)
        assert r._use_device() is True
        assert r._use_device(window=(0, sr)) is True
    finally:
        r.close()
    monkeypatch.setattr(pl, '_HOST_PROFILE', (20e6, 250e6))
    w = _writer(path, arr, sr)
    try:
        _link(monkeypatch, RELAY)
        assert w._use_device() is False
        _link(monkeypatch, PCIE)
        assert w._use_device() is True
    finally:
        w.close()


def test_auto_routing_uses_the_measured_host_rate(tmp_path, monkeypatch,
                                                  gpu):
    """With the link held fixed, a fast-measured host keeps the work on
    the host and a slow-measured one sends it to the card."""
    monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', 0)
    _link(monkeypatch, (0.001, 1e9))
    sr, nc = 4000, 32
    arr = to_int16(make_signal('colored', ns=4 * sr, nc=nc))
    path, cbin, ch = _file(tmp_path, 'm', arr, sr)
    cores = min(multiprocessing.cpu_count(), api.HOST_POOL_SCALING_CORES)
    r = mt.decompress(cbin, ch, quiet=True, device='auto')
    try:
        monkeypatch.setattr(pl, '_HOST_PROFILE', (300e6, 2e9 / cores))
        assert r._use_device() is False
        monkeypatch.setattr(pl, '_HOST_PROFILE', (300e6, 20e6))
        assert r._use_device() is True
    finally:
        r.close()
    w = _writer(path, arr, sr)
    try:
        monkeypatch.setattr(pl, '_HOST_PROFILE', (2e9 / cores, 250e6))
        assert w._use_device() is False
        monkeypatch.setattr(pl, '_HOST_PROFILE', (20e6, 250e6))
        assert w._use_device() is True
    finally:
        w.close()


@pytest.fixture
def no_probe(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('probed before the size and dtype gates')
    monkeypatch.setattr(pl, 'link_profile', boom)
    monkeypatch.setattr(pl, 'host_profile', boom)


def test_small_files_decide_before_any_probe(tmp_path, gpu, no_probe):
    """Below AUTO_DEVICE_MIN_BYTES 'auto' answers 'host' before any
    probe or CUDA call; the reads are the source's."""
    arr = to_int16(make_signal('colored', ns=2000, nc=8))
    path, cbin, ch = _file(tmp_path, 's', arr, 1000)
    r = mt.decompress(cbin, ch, quiet=True, device='auto')
    try:
        assert r._use_device() is False
        assert r._use_device(window=(0, 100)) is False
        assert np.array_equal(r[100:300], arr[100:300])
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()
    w = _writer(path, arr, 1000)
    try:
        assert w._use_device() is False
    finally:
        w.close()


def test_wide_dtypes_decide_before_any_probe(tmp_path, monkeypatch, gpu,
                                             no_probe):
    """8-byte dtypes take the rule of every other dtype, since the card
    decodes and encodes them (the JAX package sends them to its host
    codec before any probe): under AUTO_DEVICE_MIN_BYTES they go to the
    host before any probe, and past it the cost model decides, from the
    file's bytes at its item size."""
    rng = np.random.default_rng(12)
    walk = (rng.integers(-1000, 1000, size=(2000, 8), dtype=np.int64)
            + (np.int64(5) << 40))
    sources = {'int64': walk,
               'uint64': walk.astype(np.uint64) + (np.uint64(1)
                                                   << np.uint64(63)),
               'float64': walk * 1.5}
    for name, arr in sources.items():
        path, cbin, ch = _file(tmp_path, name, arr, 1000)
        r = mt.decompress(cbin, ch, quiet=True, device='auto')
        w = _writer(path, arr, 1000)
        try:
            monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', arr.nbytes + 1)
            assert not r._use_device()
            assert not r._use_device(window=(0, 100))
            assert not w._use_device()
            assert np.array_equal(r.to_array(), arr)
            monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', arr.nbytes)
            monkeypatch.setattr(pl, 'link_profile', lambda **k: PCIE)
            monkeypatch.setattr(pl, 'host_profile', lambda: (20e6, 20e6))
            assert r._use_device() and r._use_device(window=(0, 2000))
            assert w._use_device()
            monkeypatch.setattr(pl, 'link_profile', lambda **k: RELAY)
            assert not r._use_device() and not w._use_device()
        finally:
            r.close()
            w.close()


@pytest.mark.parametrize('device', ['cpu', 'none'])
def test_named_devices_skip_the_model(tmp_path, monkeypatch, no_probe,
                                      device):
    """'cpu' (and 'cuda', 'cuda:N') always take the device route and
    'none' never does; neither consults a profile."""
    monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', 0)
    arr = to_int16(make_signal('colored', ns=2000, nc=8))
    path, cbin, ch = _file(tmp_path, 'n', arr, 1000)
    r = mt.decompress(cbin, ch, quiet=True, device=device)
    w = mt.Writer(algorithm='ans', quiet=True, device=device)
    w.open(path, sample_rate=1000.0, n_channels=8, dtype='int16')
    try:
        want = device == 'cpu'
        assert r._use_device() is want
        assert r._use_device(window=(0, 100)) is want
        assert w._use_device() is want
        assert np.array_equal(r[10:1500], arr[10:1500])
    finally:
        r.close()
        w.close()


def test_auto_without_a_gpu_is_the_host_codec(tmp_path, monkeypatch,
                                              no_probe):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', 0)
    arr = to_int16(make_signal('colored', ns=2000, nc=8))
    path, cbin, ch = _file(tmp_path, 'g', arr, 1000)
    r = mt.decompress(cbin, ch, quiet=True, device='auto')
    try:
        assert r.device is None
        assert not r._use_device() and not r._use_device(window=(0, 10))
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()


def test_a_card_chosen_by_auto_propagates_its_errors(tmp_path, monkeypatch,
                                                     gpu):
    """No fallback hides the card: once 'auto' chose it, an error of the
    device decode or encode reaches the caller."""
    monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', 0)
    monkeypatch.setattr(pl, '_HOST_PROFILE', (1e6, 1e6))
    _link(monkeypatch, PCIE)
    arr = to_int16(make_signal('colored', ns=4000, nc=8))
    path, cbin, ch = _file(tmp_path, 'e', arr, 1000)

    def fail(*a, **k):
        raise RuntimeError('device route failed')

    monkeypatch.setattr(api, 'decompress_to_array', fail)
    monkeypatch.setattr(pl.DeviceChunkCache, 'read_window', fail)
    monkeypatch.setattr(pl.DeviceBatchEncoder, 'encode_batch', fail)
    r = mt.decompress(cbin, ch, quiet=True, device='auto')
    try:
        with pytest.raises(RuntimeError, match='device route failed'):
            r.to_array()
        with pytest.raises(RuntimeError, match='device route failed'):
            r[10:20]
    finally:
        r.close()
    with pytest.raises(RuntimeError, match='device route failed'):
        mt.compress(path, tmp_path / 'o.cbin', tmp_path / 'o.ch',
                    sample_rate=1000.0, n_channels=8, dtype='int16',
                    algorithm='ans', quiet=True, device='auto')


def test_auto_sends_a_739_mb_compress_to_the_host(tmp_path, monkeypatch,
                                                  gpu):
    """With the port's constants, compress() of a 32-s 385-channel int16
    recording (739.2 MB, the smoke's walk) goes to the host, and with the
    size gate open too, even on an unbounded link: the card's route
    encodes at most DEV_ENCODE_RATE_CAP, and the 8-core host pool of the
    card's machine encodes faster."""
    path = tmp_path / 'big.bin'
    with open(path, 'wb') as f:
        f.truncate(32 * 30000 * 385 * 2)        # sparse: nothing written
    monkeypatch.setattr(pl, 'link_profile',
                        lambda **k: (1e-5, float('inf')))
    monkeypatch.setattr(pl, 'host_profile', lambda: HOST_OF_THE_CARD)
    monkeypatch.setattr(multiprocessing, 'cpu_count', lambda: 8)
    w = mt.Writer(algorithm='ans', quiet=True, device='auto',
                  time_diff_order=1, do_spatial_diff=False)
    w.open(path, sample_rate=30000.0, n_channels=385, dtype='int16')
    try:
        assert w.n_samples * w.n_channels * 2 == 739_200_000
        assert w._use_device() is False
        monkeypatch.setattr(api, 'AUTO_DEVICE_MIN_BYTES', 0)
        assert w._use_device() is False
    finally:
        w.close()


#: The cross-test's grid: links (sync s, fetch B/s) from relay to NVLink
#: class, host profiles (encode, decode B/s a core), CPU counts, and
#: windows of the 4-chunk file (None: a bulk decode).
LINKS = ((0.030, 10e6), (0.005, 200e6), (0.001, 1e9), (0.0002, 10e9),
         (20e-6, 3e9), (1e-5, 25e9))
HOSTS = ((300e6, 250e6), (20e6, 20e6), (2e9, 2e9), (150e6, 600e6))
WINDOWS = (None, (0, 1), (100, 130), (0, 4000), (3990, 4010), (0, 16000),
           (5000, 13000))


@pytest.mark.parametrize('cores', [1, 4, 16])
@pytest.mark.parametrize('constants', ['port', 'jax'])
def test_cross_package_decisions_agree(tmp_path, monkeypatch, gpu,
                                       constants, cores):
    """Set the same profiles, constants and CPU count in both packages:
    the port's ``Writer``/``Reader._use_device(window=)`` return the JAX
    package's answer on every point of the grid, with the size gate below,
    at and above the file's size."""
    src = api if constants == 'port' else jax_api
    values = {name: getattr(src, name) for name in CONSTANTS}
    for module in (api, jax_api):
        for name, value in values.items():
            monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(multiprocessing, 'cpu_count', lambda: cores)
    arr = to_int16(make_signal('colored', ns=16000, nc=24))
    path, cbin, ch = _file(tmp_path, 'x', arr, 4000)
    n_bytes = arr.nbytes
    r = mt.decompress(cbin, ch, quiet=True, device='auto')
    jr = ref.decompress(cbin, ch, quiet=True, device='auto')
    w = _writer(path, arr, 4000)
    jw = ref.Writer(algorithm='ans', quiet=True, device='auto')
    jw.open(path, sample_rate=4000.0, n_channels=24, dtype='int16')
    seen = set()
    try:
        for gate in (0, n_bytes, n_bytes + 1):
            for module in (api, jax_api):
                monkeypatch.setattr(module, 'AUTO_DEVICE_MIN_BYTES', gate)
            for link in LINKS:
                _link(monkeypatch, link)
                monkeypatch.setattr(jpl, '_LINK_PROFILE', link)
                for host in HOSTS:
                    monkeypatch.setattr(pl, '_HOST_PROFILE', host)
                    monkeypatch.setattr(jpl, '_HOST_PROFILE', host)
                    got = w._use_device()
                    assert got == jw._use_device(), (gate, link, host)
                    seen.add(('write', got))
                    for win in WINDOWS:
                        got = r._use_device(window=win)
                        want = jr._use_device(window=win)
                        assert got == want, (gate, link, host, win)
                        seen.add((win is None, got))
    finally:
        for x in (r, jr, w, jw):
            x.close()
    # The grid reaches both answers for writes, bulk reads and windows.
    assert seen == {(kind, answer) for kind in ('write', True, False)
                    for answer in (True, False)}
