"""The video GAN engines of the port against the JAX package's on the
CPU, from the same weights (the JAX inits replaced by the port's seeded
trees, ``port_inits`` of tests/test_torch_video_family_models.py):

- ``VideoGANModel``: EDVR (num_feat 8, deformable groups 2, 3 frames,
  random DCN offsets) as G on a 3-frame 32 x 32 window, the VGG-style
  discriminator (128) on the restored centre frame;
- ``VideoRecurrentGANModel``: BasicVSR (num_feat 8, 1 block) as G on a
  2-frame clip, its frames folded into D's batch.

Two steps of each (L1 + vanilla GAN, G then D), both engines in float64
(the JAX model under ``jax.enable_x64`` with float64 trees and Adam
states; the port's nets, Adam moments and batch cast to float64), each
step from the JAX model's weights: the logged losses; G's and D's
gradients against the JAX step's (read off its Adam moments) and their
updates against the JAX model's ``tx_g`` / ``tx_d`` on the port's
recorded inputs (tests/torch_optax.py). In fp32 the two packages' G
gradients part by ~1e-3 of a tensor (L1 takes the sign of an output
within rounding of its GT).

Tolerances: EDVR as G losses 1e-12 x |ref|, gradients 1e-9 x each
tensor's max|ref| + 1e-12 x the net's; BasicVSR as G 1e-5 and 1e-4 (see
GAN_CASES); updates 1e-6 x max|ref| (the port's Adam takes its bias
corrections in fp32).
"""

import numpy as np
import pytest
import torch

from test_torch_video_family_models import (EDVR_NET, GRAD_REL, LOSS_REL,
                                            LR, VSR_NET, D_NET, _f64,
                                            _paths, _port, _state,
                                            _state64, _x,
                                            port_inits)  # noqa: F401
from torch_optax import (grads_close, jax_grads, recording,
                         step_matches_optax)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')


def _gan_opt(tmp_path, model_type, net_g):
    return {'name': 'vgan', 'model_type': model_type, 'is_train': True,
            'num_gpu': 1, 'manual_seed': 0, 'scale': 4,
            'network_g': dict(net_g), 'network_d': dict(D_NET),
            'path': _paths(tmp_path),
            'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3,
                                  'betas': [0.9, 0.99]},
                      'optim_d': {'type': 'Adam', 'lr': LR,
                                  'betas': [0.9, 0.99]},
                      'total_iter': 2,
                      'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
                      'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                                  'real_label_val': 1.0,
                                  'fake_label_val': 0.0,
                                  'loss_weight': 0.1}},
            'logger': {}}


# model: (G, batch, loss tolerance, gradient tolerance); BasicVSR's
# SpyNet resizes through the JAX package's interpolate_bilinear, whose
# sample coordinates are fp32 even under x64 (bsvd_tpu/nn/warp.py:89-93):
# its float64 flows sit 3e-6 x max|flow| from the port's (out_d_fake
# 1.4e-6 x itself)
GAN_CASES = {
    'VideoGANModel': (EDVR_NET, {'lq': _x((1, 3, 3, 32, 32), 6),
                                 'gt': _x((1, 3, 128, 128), 7)},
                      LOSS_REL, GRAD_REL),
    'VideoRecurrentGANModel': (VSR_NET, {'lq': _x((1, 2, 3, 32, 32), 8),
                                         'gt': _x((1, 2, 3, 128, 128), 9)},
                               1e-5, 1e-4),
}


@pytest.mark.parametrize('model_type', sorted(GAN_CASES))
def test_video_gan_models_two_steps_match_jax(tmp_path, port_inits,
                                              model_type):
    from bsvd_tpu.models import build_model as jbuild_model
    from bsvd_tpu.parallel.mesh import replicated_sharding
    net_g, batch, loss_rel, grad_rel = GAN_CASES[model_type]
    opt = _gan_opt(tmp_path, model_type, net_g)
    with jax.enable_x64(True):
        jm = jbuild_model(opt)
        pm = _port(opt)
        for net, tree in ((pm.net, jm.params), (pm.net_d, jm.d_params)):
            got = net.state_dict()
            for k, v in _state(tree).items():
                assert torch.equal(got[k], v), k
            net.double()
        for optim in (pm.optimizer, pm.optimizer_d):
            optim.mu = [m.double() for m in optim.mu]
            optim.nu = [v.double() for v in optim.nu]
        jm.params = jm.net.params = _f64(jm.params)
        jm.d_params = jm.net_d.params = _f64(jm.d_params)
        jm.opt_state = jm.tx_g.init(jm.params)
        jm.opt_state_d = jm.tx_d.init(jm.d_params)
        for name in ('params', 'opt_state', 'd_params', 'opt_state_d'):
            setattr(jm, name, jax.device_put(getattr(jm, name),
                                             replicated_sharding(jm.mesh)))
        steps = {'g': (pm.optimizer, recording(pm.optimizer), 'tx_g',
                       'opt_state'),
                 'd': (pm.optimizer_d, recording(pm.optimizer_d), 'tx_d',
                       'opt_state_d')}
        for it in (1, 2):
            # both steps from the JAX model's weights
            for net, tree in ((pm.net, jm.params), (pm.net_d, jm.d_params)):
                net.load_state_dict({k: torch.from_numpy(v) for k, v in
                                     _state64(tree).items()}, strict=False)
            before = {k: jax.tree.map(np.array, getattr(jm, v[3]))
                      for k, v in steps.items()}
            jm.feed_data({k: v.astype(np.float64) for k, v in batch.items()})
            jm.optimize_parameters(it)
            pm.feed_data(batch)
            pm.lq, pm.gt = pm.lq.double(), pm.gt.double()
            pm.optimize_parameters(it)
            jl, pl = dict(jm.log_dict), dict(pm.get_current_log())
            assert sorted(jl) == sorted(pl), (sorted(jl), sorted(pl))
            for k in jl:
                ref = float(jl[k])
                assert abs(pl[k] - ref) <= loss_rel * abs(ref), (k, pl[k],
                                                                 ref)
            for key, (optim, records, tx, state) in steps.items():
                want = _state64(jax_grads(before[key], getattr(jm, state),
                                          0.9))
                grads_close(records[-1]['grads'], want, grad_rel, 1e-12)
                step_matches_optax(getattr(jm, tx), records[-1], optim)
    assert pm.optimizer.count == pm.optimizer_d.count == 2
