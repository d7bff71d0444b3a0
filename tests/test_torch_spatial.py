"""The port's spatially sharded paths (bsvd_tpu_torch/parallel/spatial.py and
its callers) on 4 gloo CPU ranks against the JAX package (JAX on conftest's
8-device virtual CPU mesh) and against the port unsharded.

The ranks are spawned once for the file by ``python -m
bsvd_tpu_torch.parallel.dryrun --target
tests/_torch_parallel_worker.py:spatial_cases``; inputs (numpy seeds, the
JAX package's parameters through ``from_jax_params``) and outputs go
through files. Small widths, two stages, fp32; 1e-4 (summation order)
for the forwards and the stream, JAX's rtol 2e-4 / atol 2e-5
(tests/test_spatial.py) for the parameters after 3 Adam steps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs.wnet_arch import WNetConfig
from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params, to_jax_params
from bsvd_tpu_torch.parallel import spatial as port_spatial

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(chns=(8, 16, 32), mid_ch=8, in_ch=4, out_ch=3, interm_ch=8,
          norm='none', act='relu6', shift_mode='TSM')
TOL = dict(rtol=1e-4, atol=1e-4)
N_PUSH = 18


def _rng(seed):
    return np.random.default_rng(seed)


def _batches():
    rng = _rng(6)
    return [{'lq': rng.uniform(0, 1, (8, 3, 16, 8, 4)).astype(np.float32),
             'gt': rng.uniform(0, 1, (8, 3, 16, 8, 3)).astype(np.float32)}
            for _ in range(3)]


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The JAX parameters and inputs, and the 4 ranks' outputs."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    work = tmp_path_factory.mktemp('spatial')
    jcfg, pcfg = JaxConfig(**KW), WNetConfig(**KW)
    jparams = wnet_init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    x = {'halo_wider': _rng(0).uniform(0, 1, (1, 3, 32, 16, 4)),
         'halo_narrower': _rng(1).uniform(0, 1, (1, 2, 96, 8, 4)),
         'data_and_spatial': _rng(2).uniform(0, 1, (4, 2, 16, 8, 4)),
         'seq': _rng(4).uniform(0, 1, (5, 3, 32, 16)),
         'stream': _rng(5).uniform(0, 1, (N_PUSH + 2, 2, 32, 16, 4))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    inputs = {k: torch.from_numpy(v) for k, v in x.items()}
    inputs.update(cfg=KW, params=params, n_push=N_PUSH, batches=[
        {k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()])
    torch.save(inputs, work / 'inputs.pt')
    res = subprocess.run(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', '--nproc',
         '4', '--data', '2', '--spatial', '2', '--backend', 'gloo',
         '--device', 'cpu', '--checks', 'none', '--timeout', '240',
         '--target', os.path.join(ROOT, 'tests',
                                  '_torch_parallel_worker.py:spatial_cases'),
         '--workdir', str(work)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = torch.load(work / 'outputs.pt', weights_only=False)
    return {'jcfg': jcfg, 'jparams': jparams, 'pcfg': pcfg, 'x': x,
            'out': {k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()}}


def _jax_mesh(spatial):
    from bsvd_tpu.parallel.mesh import make_mesh
    return make_mesh(8, spatial=spatial)


class _Shape:
    """A stand-in mesh with a shape (the gates read nothing else)."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize('chns,mid,interm', [((64, 128, 256), 64, 64),
                                             ((32, 64, 128), 32, 32)])
def test_stage_halo_and_gates_equal_jax(chns, mid, interm):
    """c64 and c32: the halo (40 rows) and both gates as JAX's."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.parallel import spatial as jax_spatial
    for norm in ('none', 'bn'):
        kw = dict(chns=chns, mid_ch=mid, interm_ch=interm, norm=norm,
                  act='relu6')
        jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
        assert port_spatial.stage_halo(pcfg) == jax_spatial.stage_halo(
            jcfg) == 40
        for n_sp in (1, 2, 4):
            jmesh = _jax_mesh(n_sp)
            for h in (16, 32, 36, 540, 544, 96):
                want = jax_spatial.spatial_ok(jcfg, h, jmesh)
                m = _Shape(data=8 // n_sp, spatial=n_sp)
                assert port_spatial.spatial_ok(pcfg, h, m) == want
                assert port_spatial.stream_spatial_ok(pcfg, h, m) == \
                    jax_spatial.stream_spatial_ok(jcfg, h, jmesh)
        assert not port_spatial.spatial_ok(pcfg, 32, None)


@pytest.mark.parametrize('case,spatial', [('halo_wider', 4),
                                          ('halo_narrower', 2),
                                          ('data_and_spatial', 2)])
def test_spatial_forward_matches_jax(run, case, spatial):
    """Halo (40) wider than a shard (32 rows over 4: 8), narrower (96 over
    2: 48), and N=4 over data 2 x spatial 2: against JAX's
    wnet_apply_spatial and its unsharded wnet_apply."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply
    from bsvd_tpu.parallel.spatial import wnet_apply_spatial
    x = jnp.asarray(run['x'][case])
    cfg, p = run['jcfg'], run['jparams']
    ref = np.asarray(wnet_apply(p, x, cfg))
    jsp = np.asarray(jax.jit(lambda a, b: wnet_apply_spatial(
        a, b, cfg, _jax_mesh(spatial)))(p, x))
    got = run['out'][case]
    np.testing.assert_allclose(got, jsp, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize('case,psz,future', [('denoise_seq', -1, 0),
                                             ('denoise_seq_chunked', 2, 1)])
def test_denoise_seq_on_a_mesh_matches_jax(run, case, psz, future):
    """The whole clip runs the halo-exchange forward, the chunked protocol
    the unsharded one on every rank: both equal JAX's denoise_seq without
    a mesh."""
    from bsvd_tpu.models.seq_inference import denoise_seq
    ref = denoise_seq(run['jparams'], run['jcfg'], run['x']['seq'],
                      noise_sigma=0.1, temp_psz=psz,
                      future_buffer_len=future)
    np.testing.assert_allclose(run['out'][case], ref, **TOL)


@pytest.mark.parametrize('case', ['stream_spatial4', 'stream_2x2'])
def test_spatial_stream_matches_jax_and_unsharded(run, case):
    """Fill, steady pushes, a steady push_block and the drain, with the rows
    over 4 ranks (a halo wider than the shard) and over 2 with the 2
    streams over data: against the unsharded port and JAX's client."""
    from bsvd_tpu.archs.streaming import StreamDenoiser
    frames = run['x']['stream']
    sd = StreamDenoiser(run['jparams'], run['jcfg'], batch=frames.shape[1],
                        height=frames.shape[2], width=frames.shape[3])
    outs = [sd.push(jnp.asarray(f)) for f in frames[:N_PUSH]]
    outs += sd.push_block(jnp.asarray(frames[N_PUSH:]))
    outs += sd.flush()
    ref = np.stack([np.asarray(o) for o in outs if o is not None])
    assert run['out'][case + '_sharded']
    got = run['out'][case]
    assert got.shape == ref.shape == (N_PUSH + 2,) + frames.shape[1:4] + (
        3,)
    np.testing.assert_allclose(got, run['out']['stream_unsharded'], **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_block_stream_on_a_data_mesh_equals_unsharded(run):
    """BlockStreamDenoiser's 2 streams over data 2: the same frames as the
    unsharded client, exactly."""
    got, ref = run['out']['block_stream'], run['out']['block_stream_unsharded']
    assert got.shape == ref.shape == (N_PUSH + 2, 2, 32, 16, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('case,spatial', [('train_data', 1),
                                          ('train_data_spatial', 2)])
def test_train_steps_match_jax(run, case, spatial):
    """3 steps data 4 x spatial 1 and data 2 x spatial 2 (global batch 8 x
    3 x 16 x 8, Adam 1e-3) against JAX's make_train_step(mesh=...) fed the
    same batches: the losses, and the parameters to JAX's rtol 2e-4 /
    atol 2e-5."""
    import optax
    from bsvd_tpu.losses import build_loss
    from bsvd_tpu.models.denoising_model import make_train_step
    cfg = run['jcfg']
    tx = optax.adam(1e-3)
    step = jax.jit(make_train_step(cfg, tx, build_loss(
        dict(type='MSELoss', loss_weight=1.0)), mesh=_jax_mesh(spatial)))
    p = jax.tree.map(jnp.array, run['jparams'])
    s = tx.init(p)
    losses = []
    for it, b in enumerate(_batches()):
        p, s, _, ld = step(p, s, None, {k: jnp.asarray(v)
                                        for k, v in b.items()}, it, 0.0)
        losses.append(float(ld['l_pix']))
    params, got_losses, _ = run['out'][case]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-4, atol=1e-5)
    want = jax.tree.map(np.asarray, p)
    got = to_jax_params(params, run['pcfg'])
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=2e-4, atol=2e-5)


def test_amp_train_step_with_split_rows(run):
    """bf16 AMP with the rows over 4 ranks (the casts, bf16 through the
    gather and its backward) against the unsharded AMP step: the loss to
    bf16's rounding (2^-8 relative), and the first step's gradients after
    the all_reduce, per tensor, within 2^-6 of the tensor's max |ref|: the
    two orders of summation put them a bf16 rounding (~2^-8 of the max)
    apart, while the bf16 gradients lie up to ~8% of it from the fp32 ones,
    and a gather whose backward lost the other ranks' rows would miss
    stages 1 and 2 by their whole size."""
    (got, (loss,), grads), (ref, (ref_loss,), ref_grads) = (
        run['out']['train_amp_spatial'], run['out']['train_amp_unsharded'])
    assert abs(loss - ref_loss) <= 2 ** -8 * abs(ref_loss)
    assert sorted(grads) == sorted(ref_grads)
    for k in sorted(grads):
        a, b = grads[k].float(), ref_grads[k].float()
        assert torch.isfinite(a).all(), k
        assert float((a - b).abs().max()) <= 2 ** -6 * float(
            b.abs().max()), k
    for a in jax.tree.leaves(to_jax_params(got, run['pcfg'])):
        assert np.isfinite(np.asarray(a)).all()
