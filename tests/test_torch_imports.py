"""Import hygiene of the port: every bsvd_tpu_torch module imports in a
fresh interpreter without a GPU or nvcc, and pulls in neither jax, the JAX
package, yaml, cv2, pandas, tensorflow nor tensorboard (the machine with
the card has none of them), nor torchvision (the zoo's VGG is the port's
own), nor requests (the downloads are on urllib)."""

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
                                    'tensorboard', 'torchvision',
                                    'requests'))
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
        'bsvd_tpu_torch.data.h264_decode',
        'bsvd_tpu_torch.data.yuv', 'bsvd_tpu_torch.data.orientation',
        'bsvd_tpu_torch.nn.warp', 'bsvd_tpu_torch.utils.flow_util',
        'bsvd_tpu_torch.archs.spynet_arch',
        'bsvd_tpu_torch.archs.basicvsr_arch',
        'bsvd_tpu_torch.data.video_test_dataset',
        'bsvd_tpu_torch.data.reds_dataset',
        'bsvd_tpu_torch.models.video_recurrent_model',
        'bsvd_tpu_torch.data.tiff_decode',
        'bsvd_tpu_torch.archs.hifacegan_arch',
        'bsvd_tpu_torch.models.hifacegan_model',
        'bsvd_tpu_torch.ops.stylegan_ops',
        'bsvd_tpu_torch.archs.stylegan2_arch',
        'bsvd_tpu_torch.models.stylegan2_model',
        'bsvd_tpu_torch.data.single_image_dataset',
        'bsvd_tpu_torch.inference._common',
        'bsvd_tpu_torch.inference.inference_stylegan2',
        'bsvd_tpu_torch.inference.inference_esrgan',
        'bsvd_tpu_torch.inference.inference_ridnet',
        'bsvd_tpu_torch.ops.deform_conv', 'bsvd_tpu_torch.archs.edvr_arch',
        'bsvd_tpu_torch.archs.tof_arch', 'bsvd_tpu_torch.archs.duf_arch',
        'bsvd_tpu_torch.models.video_base_model',
        'bsvd_tpu_torch.models.video_gan_model',
        'bsvd_tpu_torch.data.vimeo90k_dataset',
        'bsvd_tpu_torch.inference.inference_basicvsr',
        'bsvd_tpu_torch.utils.cv2_ops', 'bsvd_tpu_torch.utils.face_util',
        'bsvd_tpu_torch.archs.dfdnet_arch',
        'bsvd_tpu_torch.inference.inference_dfdnet',
        'bsvd_tpu_torch.scripts.data_preparation.prepare_hifacegan_dataset',
        'bsvd_tpu_torch.utils.img_process_util',
        'bsvd_tpu_torch.utils.matlab_functions',
        'bsvd_tpu_torch.data.degradations', 'bsvd_tpu_torch.metrics.niqe',
        'bsvd_tpu_torch.scripts.metrics.calculate_niqe',
        'bsvd_tpu_torch.scripts.metrics.calculate_psnr_ssim',
        'bsvd_tpu_torch.archs.swinir_arch',
        'bsvd_tpu_torch.inference.inference_swinir',
        'bsvd_tpu_torch.archs.inception_arch', 'bsvd_tpu_torch.metrics.fid',
        'bsvd_tpu_torch.metrics.lpips', 'bsvd_tpu_torch.utils.diffjpeg',
        'bsvd_tpu_torch.scripts.metrics.calculate_fid_folder',
        'bsvd_tpu_torch.scripts.metrics.calculate_fid_stats_from_datasets',
        'bsvd_tpu_torch.scripts.metrics.calculate_lpips',
        'bsvd_tpu_torch.scripts.metrics.calculate_stylegan2_fid',
        'bsvd_tpu_torch.utils._lmdb_compat', 'bsvd_tpu_torch.utils.lmdb_util',
        'bsvd_tpu_torch.utils.download_util',
        'bsvd_tpu_torch.scripts.download_gdrive',
        'bsvd_tpu_torch.scripts.download_pretrained_models',
        'bsvd_tpu_torch.scripts.publish_models',
        'bsvd_tpu_torch.scripts.model_conversion.convert_to_npz',
        'bsvd_tpu_torch.scripts.matlab_scripts.generate_bicubic_img',
        'bsvd_tpu_torch.scripts.matlab_scripts.generate_LR_Vimeo90K'} | {
        f'bsvd_tpu_torch.scripts.data_preparation.{s}' for s in (
            'create_lmdb', 'extract_subimages', 'generate_meta_info',
            'regroup_reds_dataset', 'extract_images_from_tfrecords',
            'download_datasets')} | {
        f'bsvd_tpu_torch.tools.{t}' for t in (
            '_common', '_stream_bench', 'make_synth_dataset',
            'profile_blocks', 'profile_stream', 'bench_train',
            'bench_push_block', 'bench_stream_block_step',
            'bench_block_stream', 'run_eval_burnin', 'probe_mem',
            'probe_streams')} \
    <= set(names), names
assert not bad, bad
from bsvd_tpu_torch.ops import _build
from bsvd_tpu_torch.data import jpeg_decode, png_decode, tiff_decode
from bsvd_tpu_torch.utils import jpeg_encode
from bsvd_tpu_torch.data import h264_decode, nvdec
assert _build._lib is None       # nothing built or loaded at import
assert jpeg_decode._lib is None and png_decode._lib is None
assert tiff_decode._lib is None and h264_decode._lib is None
assert jpeg_encode._lib is None and nvdec._lib is None
"""


def test_port_imports_without_jax_yaml_or_nvcc():
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_VISIBLE_DEVICES='')
    env.pop('NVCC', None)
    res = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize('module', [
    'bsvd_tpu_torch.utils.jpeg_encode', 'bsvd_tpu_torch.utils.flow_util',
    'bsvd_tpu_torch.archs.stylegan2_arch',
    'bsvd_tpu_torch.inference.inference_stylegan2',
    'bsvd_tpu_torch.data.single_image_dataset',
    'bsvd_tpu_torch.utils.face_util', 'bsvd_tpu_torch.metrics.niqe',
    'bsvd_tpu_torch.scripts.data_preparation.prepare_hifacegan_dataset',
    'bsvd_tpu_torch.archs.swinir_arch', 'bsvd_tpu_torch.archs.inception_arch',
    'bsvd_tpu_torch.metrics.fid', 'bsvd_tpu_torch.metrics.lpips',
    'bsvd_tpu_torch.utils.diffjpeg',
    'bsvd_tpu_torch.scripts.metrics.calculate_stylegan2_fid',
    'bsvd_tpu_torch.utils.lmdb_util', 'bsvd_tpu_torch.utils.file_client',
    'bsvd_tpu_torch.scripts.data_preparation.create_lmdb',
    'bsvd_tpu_torch.scripts.data_preparation.extract_images_from_tfrecords',
    'bsvd_tpu_torch.scripts.matlab_scripts.generate_LR_Vimeo90K',
    'bsvd_tpu_torch.scripts.model_conversion.convert_to_npz'])
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
