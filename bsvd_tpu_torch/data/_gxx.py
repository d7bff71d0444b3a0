"""Building the data path's C++ helpers with g++ at first use, never at
import, into ``bsvd_tpu_torch/_build/<name>-<hash>/`` (listed in
``.gitignore``), keyed on the source and the flags."""

import hashlib
import os
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent


def build(source, name, flags, libs, pkg=PKG):
    """Compile ``source`` into ``lib<name>.so`` if this source and these
    flags have no library yet; returns its path. Raises RuntimeError with
    g++'s output on failure."""
    source = Path(source)
    h = hashlib.sha256(' '.join(list(flags) + list(libs)).encode())
    h.update(source.read_bytes())
    out = Path(pkg) / '_build' / f'{name}-{h.hexdigest()[:16]}' / \
        f'lib{name}.so'
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = ['g++', *flags, str(source), '-o', str(tmp), *libs]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'{source.name}: g++ not found ({e})') from e
    if res.returncode != 0:
        raise RuntimeError(f'{source.name}: build failed ({" ".join(cmd)}):'
                           f'\n{res.stdout}{res.stderr}')
    os.replace(tmp, out)           # atomic: concurrent processes agree
    return out
