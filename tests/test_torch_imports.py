"""Import hygiene of the port: every bsvd_tpu_torch module imports in a
fresh interpreter without a GPU or nvcc, and pulls in neither jax, the JAX
package, yaml nor cv2 (the machine with the card has none of them)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import bsvd_tpu_torch
names = ['bsvd_tpu_torch'] + [m.name for m in pkgutil.walk_packages(
    bsvd_tpu_torch.__path__, 'bsvd_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'bsvd_tpu', 'yaml',
                                    'cv2'))
print(len(names), bad)
assert len(names) >= 28, names
assert {'bsvd_tpu_torch.archs.streaming',
        'bsvd_tpu_torch.ops.bibuffer_conv',
        'bsvd_tpu_torch.train', 'bsvd_tpu_torch.models.denoising_model',
        'bsvd_tpu_torch.models.base_model', 'bsvd_tpu_torch.models.optim',
        'bsvd_tpu_torch.models.lr_scheduler',
        'bsvd_tpu_torch.models.checkpoint',
        'bsvd_tpu_torch.data.video_train_loader',
        'bsvd_tpu_torch.losses.losses'} <= set(names), names
assert not bad, bad
from bsvd_tpu_torch.ops import _build
assert _build._lib is None       # nothing built or loaded at import
"""


def test_port_imports_without_jax_yaml_or_nvcc():
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_VISIBLE_DEVICES='')
    env.pop('NVCC', None)
    res = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py outside the repo (or without a card) exits non-zero and
    prints no result."""
    src = os.path.join(ROOT, 'chip_smoke.py')
    dst = tmp_path / 'chip_smoke.py'
    dst.write_text(open(src).read())
    res = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_without_a_card_fails():
    res = subprocess.run([sys.executable, os.path.join(ROOT, 'chip_smoke.py')],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and 'no CUDA device' in res.stderr
