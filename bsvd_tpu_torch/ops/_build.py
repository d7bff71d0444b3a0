"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at
the first CUDA use (never at import: machines without ``nvcc`` import every
module), is keyed on a hash of the sources and the flags, and lands in
``bsvd_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``); later
processes reuse it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0. Pointers and the stream travel as
``c_void_p`` so 64-bit addresses are never cut.
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
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-lineinfo']

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'bsvd_conv3x3': [_I] + [_P] * 5 + [_I] * 12 + [_P],
    'bsvd_conv_ps': [_I] + [_P] * 4 + [_I] * 8 + [_P],
    'bsvd_conv_s2': [_I] + [_P] * 4 + [_I] * 9 + [_P],
    'bsvd_conv_chain': [_I] + [_P] * 8 + [_I] * 14 + [_P],
    'bsvd_bibuffer': [_I] + [_P] * 6 + [_I] * 12 + [_P],
    'bsvd_bibuffer_chain': [_I] + [_P] * 10 + [_I] * 15 + [_P],
    'bsvd_conv3x3_dw': [_I] + [_P] * 5 + [_I] * 13 + [_P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def _nvcc():
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built '
                       '(set NVCC or CUDA_HOME)')


def _digest():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if this source hash has no library yet; returns
    the library path."""
    out = _PKG / '_build' / _digest() / 'libbsvd_kernels.so'
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}.tmp'
    nvcc = _nvcc()
    objs, procs = [], []
    for cu in sorted(CSRC.glob('*.cu')):
        obj = out.parent / f'{cu.stem}.{tag}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(cu)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(str(obj))
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f'{" ".join(cmd)}\n{log}')
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    tmp = out.with_suffix(f'.{tag}')
    cmd = [nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp), *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{" ".join(cmd)}'
                           f'\n{res.stdout}\n{res.stderr}')
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            handle.bsvd_error_string.argtypes = [_I]
            handle.bsvd_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().bsvd_error_string(err).decode()
        raise RuntimeError(f'{name}: CUDA error {err}: {msg}')


def stream_ptr(t):
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
