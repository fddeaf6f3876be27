"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.
The build happens at the first CUDA call, never at import: the CPU test
suite imports every module on machines without ``nvcc``. The library
file is keyed on a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses the last build. A missing ``nvcc`` or a
failed build raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_lib = None


def _nvcc():
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of mtscomp_tpu_torch cannot be built.")


def _sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def library_path():
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ('libmtstorch_%s.so' % h.hexdigest()[:16])


def build():
    """Compile the kernels unless a library for the current sources
    exists; returns ``(path, compiler output)``. One ``nvcc -c`` per
    source runs in parallel, then one link. The output (ptxas register,
    spill and shared-memory counts) is kept beside the library as
    ``.log``, so a cached build returns it too.
    """
    path = library_path()
    log = path.with_suffix('.log')
    if path.exists() and log.exists():
        return path, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = '%s.%d' % (path.stem, os.getpid())
    srcs = sorted(CSRC.glob('*.cu'))
    objs = [BUILD_DIR / ('%s.%s.o' % (tag, s.stem)) for s in srcs]
    tmp = BUILD_DIR / ('%s.tmp.so' % tag)
    procs = []
    try:
        for s, o in zip(srcs, objs):
            cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(o), str(s)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs = []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            outputs.append(out)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                                   % (proc.returncode, ' '.join(cmd),
                                      out[-8000:]))
        cmd = [nvcc, '-shared', '-o', str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s\n%s"
                               % (proc.returncode, ' '.join(cmd),
                                  proc.stderr[-8000:]))
        # Atomic publish, log first: concurrent first builds race benignly.
        tmp_log = BUILD_DIR / ('%s.tmp.log' % tag)
        tmp_log.write_text(''.join(outputs))
        os.replace(tmp_log, log)
        os.replace(tmp, path)
    finally:
        for _cmd, proc in procs:          # after a failure, stop the rest
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return path, log.read_text()


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mts_rans_decode_groups.argtypes = [
        i, p, p, p, p, p, p, p, p, i, i, i, i]
    lib.mts_scan_transposed.argtypes = [
        i, p, ll, ll, p, p, p, i, i, i, i, i, i, i, p]
    lib.mts_scan_transposed_planes.argtypes = [
        i, p, ll, ll, p, p, ll, ll, p, i, p, p, p, i, i, i, i, i, i, p]
    lib.mts_finalize_u8.argtypes = [
        i, p, ll, ll, i, p, ll, ll, p, p, p, p, i, i, i, i, i, i, p]
    lib.mts_cumsum_time.argtypes = [i, p, p, p, i, i, i, i, i, i, p]
    lib.mts_rans_encode_groups.argtypes = [i, p, p, p, p, p, p, p, p, i, i,
                                           ll]
    for fn in (lib.mts_rans_decode_groups, lib.mts_scan_transposed,
               lib.mts_scan_transposed_planes, lib.mts_finalize_u8,
               lib.mts_cumsum_time,
               lib.mts_rans_encode_groups):
        fn.restype = i
    lib.mts_rans_decode_smem_bytes.argtypes = [i]
    lib.mts_rans_decode_smem_bytes.restype = i
    lib.mts_rans_encode_smem_bytes.argtypes = []
    lib.mts_rans_encode_smem_bytes.restype = i
    lib.mts_scan_transposed_smem_bytes.argtypes = [i, i]
    lib.mts_scan_transposed_smem_bytes.restype = i
    lib.mts_cumsum_time_smem_bytes.argtypes = [i, i, i, i]
    lib.mts_cumsum_time_smem_bytes.restype = i
    lib.mts_cuda_error_string.argtypes = [i]
    lib.mts_cuda_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            _declare(lib)
            _lib = lib
        return _lib


def check(lib, rc, what):
    """Raise if a C entry reported a CUDA error (launch refused or
    earlier asynchronous fault)."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, rc, lib.mts_cuda_error_string(rc).decode()))


def stream_handle(tensor):
    """Raw ``cudaStream_t`` of PyTorch's current stream on the tensor's
    device, as an int for ctypes."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
