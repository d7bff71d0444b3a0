"""Import hygiene of the port: every bsvd_tpu_torch module imports in a
fresh interpreter without a GPU or nvcc, and pulls in neither jax, the JAX
package, yaml, cv2, pandas, tensorflow nor tensorboard (the machine with
the card has none of them), nor torchvision (the zoo's VGG is the port's
own)."""

import os
import subprocess
import sys

import pytest

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
                                    'cv2', 'pandas', 'tensorflow',
                                    'tensorboard', 'torchvision'))
print(len(names), bad)
assert len(names) >= 40, names
assert {'bsvd_tpu_torch.archs.streaming',
        'bsvd_tpu_torch.ops.bibuffer_conv',
        'bsvd_tpu_torch.train', 'bsvd_tpu_torch.models.denoising_model',
        'bsvd_tpu_torch.models.base_model', 'bsvd_tpu_torch.models.optim',
        'bsvd_tpu_torch.models.lr_scheduler',
        'bsvd_tpu_torch.models.checkpoint',
        'bsvd_tpu_torch.data.video_train_loader',
        'bsvd_tpu_torch.losses.losses',
        'bsvd_tpu_torch.models.seq_inference', 'bsvd_tpu_torch.test',
        'bsvd_tpu_torch.metrics', 'bsvd_tpu_torch.metrics.psnr_ssim',
        'bsvd_tpu_torch.utils.img_util', 'bsvd_tpu_torch.utils.logger',
        'bsvd_tpu_torch.utils.misc', 'bsvd_tpu_torch.data.utils_common',
        'bsvd_tpu_torch.data.jpeg_decode', 'bsvd_tpu_torch.data.bmp_decode',
        'bsvd_tpu_torch.utils.jpeg_encode',
        'bsvd_tpu_torch.data.val_folder_dataset',
        'bsvd_tpu_torch.data.png_decode', 'bsvd_tpu_torch.data._gxx',
        'bsvd_tpu_torch.utils.options', 'bsvd_tpu_torch.utils.yaml_lite',
        'bsvd_tpu_torch.parallel', 'bsvd_tpu_torch.parallel.mesh',
        'bsvd_tpu_torch.parallel.spatial',
        'bsvd_tpu_torch.parallel.dryrun', 'bsvd_tpu_torch.profiler',
        'bsvd_tpu_torch.profile_net', 'bsvd_tpu_torch.tools.parse_trace',
        'bsvd_tpu_torch.utils.tb_events', 'bsvd_tpu_torch.ops._flops',
        'bsvd_tpu_torch.convert.torch_generic',
        'bsvd_tpu_torch.archs.sr_archs', 'bsvd_tpu_torch.archs.vgg_arch',
        'bsvd_tpu_torch.archs.discriminator_arch',
        'bsvd_tpu_torch.losses.gan_loss', 'bsvd_tpu_torch.utils.file_client',
        'bsvd_tpu_torch.data.data_util', 'bsvd_tpu_torch.data.transforms',
        'bsvd_tpu_torch.data.paired_image_dataset',
        'bsvd_tpu_torch.data.sampler', 'bsvd_tpu_torch.models.sr_model',
        'bsvd_tpu_torch.models.srgan_model', 'bsvd_tpu_torch.data.mp4_demux',
        'bsvd_tpu_torch.data.h264_headers', 'bsvd_tpu_torch.data.nvdec',
        'bsvd_tpu_torch.data.yuv', 'bsvd_tpu_torch.data.orientation',
        'bsvd_tpu_torch.nn.warp', 'bsvd_tpu_torch.utils.flow_util',
        'bsvd_tpu_torch.archs.spynet_arch',
        'bsvd_tpu_torch.archs.basicvsr_arch',
        'bsvd_tpu_torch.data.video_test_dataset',
        'bsvd_tpu_torch.data.reds_dataset',
        'bsvd_tpu_torch.models.video_recurrent_model'} \
    <= set(names), names
assert not bad, bad
from bsvd_tpu_torch.ops import _build
from bsvd_tpu_torch.data import jpeg_decode, png_decode
from bsvd_tpu_torch.utils import jpeg_encode
from bsvd_tpu_torch.data import nvdec
assert _build._lib is None       # nothing built or loaded at import
assert jpeg_decode._lib is None and png_decode._lib is None
assert jpeg_encode._lib is None and nvdec._lib is None
"""


def test_port_imports_without_jax_yaml_or_nvcc():
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_VISIBLE_DEVICES='')
    env.pop('NVCC', None)
    res = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize('module', ['bsvd_tpu_torch.utils.jpeg_encode',
                                    'bsvd_tpu_torch.utils.flow_util'])
def test_module_imports_first(module):
    """A module imported first in a fresh interpreter (no circular import
    through the data package's datasets)."""
    res = subprocess.run([sys.executable, '-c', f'import {module}'],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


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
