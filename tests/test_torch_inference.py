"""The port's inference scripts (``python -m bsvd_tpu_torch.inference.
<name>``) against the JAX repo's own scripts (``inference/inference_
<name>.py``), both run in-process on the CPU through their ``main``, the
port's with ``--device cpu`` and the JAX scripts' with ``sys.argv``
patched, on the same weights and inputs; the images they write are
compared bit for bit.

- ESRGAN (RRDBNet 64 x 23) and RIDNet (with its ``default_rng(0)``
  noise) on a folder of a PNG and a JPEG.
- StyleGAN2 sampling (size 16, 5 samples a picture, 2 pictures), with and
  without truncation: the JAX script draws its codes, its noise and the
  truncation mean with ``jax.random.normal`` inside ``main``; for this
  test only, ``jax.random.normal`` is replaced (monkeypatch) by draws of
  the shapes asked for from a ``torch.Generator`` seeded as the port's
  script seeds its own, in the order the port draws them, so that both
  scripts sample the same images.
"""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import to_jax_tree
from bsvd_tpu_torch.models.checkpoint import save_npz_params
from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite
from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')
jax = pytest.importorskip('jax')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp('inputs')
    rng = np.random.default_rng(21)
    imwrite(rng.integers(0, 256, (10, 12, 3)).astype(np.uint8),
            str(root / 'a.png'))
    cv2.imwrite(str(root / 'b.jpg'),
                rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))
    return root


def _ckpt(net, path, key='params'):
    save_npz_params(str(path), {key: to_jax_tree(net)})
    return str(path)


def _read(path):
    with open(path, 'rb') as f:
        return imfrombytes(f.read(), 'unchanged')


def _run_jax_script(monkeypatch, name, argv):
    """``main()`` of the JAX repo's inference/inference_<name>.py with
    ``sys.argv`` set to ``argv`` (``sys.path``, which the script extends,
    restored after the test)."""
    monkeypatch.setattr(sys, 'path', list(sys.path))
    monkeypatch.setattr(sys, 'argv', [f'inference_{name}.py', *argv])
    spec = importlib.util.spec_from_file_location(
        f'_jax_inference_{name}',
        os.path.join(ROOT, 'inference', f'inference_{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def _same_files(ours, theirs):
    names = sorted(os.listdir(theirs))
    assert names and names == sorted(os.listdir(ours))
    for f in names:
        np.testing.assert_array_equal(_read(os.path.join(ours, f)),
                                      _read(os.path.join(theirs, f)),
                                      err_msg=f)


@pytest.mark.parametrize('name', ['esrgan', 'ridnet'])
def test_sr_and_denoise_scripts_match_the_jax_pipeline(images, tmp_path,
                                                       monkeypatch, name):
    mod = importlib.import_module(f'bsvd_tpu_torch.inference.'
                                  f'inference_{name}')
    if name == 'esrgan':
        opt = {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3,
               'num_feat': 64, 'num_block': 23, 'scale': 4, 'seed': 3}
        argv = ['--input', str(images)]
    else:
        opt = {'type': 'RIDNet', 'in_channels': 3, 'mid_channels': 64,
               'out_channels': 3, 'seed': 3}
        argv = ['--test_path', str(images), '--noise_g', '15']
    ckpt = _ckpt(build_network(opt, 'cpu'), tmp_path / 'w.npz')
    mod.main(['--model_path', ckpt, '--output', str(tmp_path / 'port'),
              '--device', 'cpu', *argv])
    _run_jax_script(monkeypatch, name, ['--model_path', ckpt, '--output',
                                        str(tmp_path / 'jax'), *argv])
    _same_files(tmp_path / 'port', tmp_path / 'jax')


@pytest.mark.parametrize('trunc', [1.0, 0.7], ids=['plain', 'truncation'])
def test_stylegan2_sampling_tiles_and_rounds_as_jax(tmp_path, monkeypatch,
                                                    trunc):
    import jax.numpy as jnp
    from bsvd_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
    from bsvd_tpu_torch.inference import inference_stylegan2 as mod
    g = StyleGAN2Generator(16, num_style_feat=512, num_mlp=8, seed=4)
    ckpt = _ckpt(g, tmp_path / 'g.npz', 'params_ema')
    argv = ['--ckpt', ckpt, '--size', '16', '--sample', '5', '--pics', '2',
            '--truncation', str(trunc), '--truncation_mean', '64',
            '--seed', '9']
    mod.main([*argv, '--output', str(tmp_path / 'port'), '--device', 'cpu'])
    gen = torch.Generator().manual_seed(9)

    def normal(key, shape, dtype=jnp.float32):
        del key
        if len(shape) == 4:               # noise, drawn NCHW by the port
            b, h, w, c = shape
            draw = torch.randn((b, c, h, w), generator=gen).permute(
                0, 2, 3, 1)
        else:
            draw = torch.randn(tuple(shape), generator=gen)
        return jnp.asarray(draw.numpy(), dtype)
    monkeypatch.setattr(jax.random, 'normal', normal)
    _run_jax_script(monkeypatch, 'stylegan2',
                    [*argv, '--output', str(tmp_path / 'jax')])
    _same_files(tmp_path / 'port', tmp_path / 'jax')
    assert not np.array_equal(_read(str(tmp_path / 'port' / '000000.png'))
                              [32:], np.zeros((16, 32, 3), np.uint8))
