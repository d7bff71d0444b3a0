"""IconVSR of the port against the JAX package's on the CPU (num_feat 8,
num_block 2, every EDVR DCN pack's ``conv_offset`` random), on 14 x 18
frames (reflect-padded to 16 x 20 inside, the output cropped back):

- temporal padding 2 on 6 frames at key-frame stride 3 (key frames 0, 3
  and the last, 5, which the stride does not reach);
- temporal padding 3 on 7 frames at stride 6 (key frames 0 and 6), the
  mirrored frames 6, 5, 4 before the clip and -5, -6, -7 after it;
- the weight carry both ways (tree shapes against ``jax.eval_shape`` of
  the JAX init), ``spynet_path`` / ``edvr_path`` loads of the submodules'
  own files, and temporal padding other than 2 or 3 refused.

Tolerance 1e-4 x max|ref| (fp32 summation order through SpyNet, the
deformable convolutions and the two branches), as
tests/test_torch_video_family.py's nets.
"""

import functools

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from test_torch_video_family import (NET_REL, _carried, _close,
                                     _random_offsets, _x)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

# temporal padding: (frames, key-frame stride)
CASES = {2: (6, 3), 3: (7, 6)}


@pytest.mark.parametrize('tp', [2, 3])
def test_iconvsr_matches_jax(tp, tmp_path):
    from bsvd_tpu.archs import basicvsr_arch as jb
    t, stride = CASES[tp]
    opt = {'type': 'IconVSR', 'num_feat': 8, 'num_block': 2,
           'keyframe_stride': stride, 'temporal_padding': tp}
    init = functools.partial(jb.iconvsr_init, num_feat=8, num_block=2,
                             keyframe_stride=stride, temporal_padding=tp)
    net, tree = _carried(opt, init, functools.partial(_random_offsets,
                                                      seed=6))
    x = _x((1, t, 3, 14, 18), 41)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    fn = jax.jit(functools.partial(jb.iconvsr_apply, num_feat=8,
                                   keyframe_stride=stride,
                                   temporal_padding=tp))
    ref = fn(tree, jnp.asarray(np.moveaxis(x, 2, -1)))
    assert got.shape == (1, t, 3, 56, 72)
    _close(got, np.moveaxis(np.asarray(ref), -1, 2), NET_REL)
    if tp == 2:
        # spynet_path / edvr_path: files of the submodules' own weights
        torch.save({'params': net.spynet.state_dict()},
                   str(tmp_path / 'spynet.pth'))
        torch.save({'params': net.edvr.state_dict()},
                   str(tmp_path / 'edvr.pth'))
        loaded = build_network(dict(opt, seed=50, spynet_path=str(
            tmp_path / 'spynet.pth'), edvr_path=str(tmp_path / 'edvr.pth')),
            'cpu')
        for sub in ('spynet', 'edvr'):
            want = getattr(net, sub).state_dict()
            for k, v in getattr(loaded, sub).state_dict().items():
                assert torch.equal(v, want[k]), (sub, k)
    with pytest.raises(ValueError, match='2 or 3'):
        build_network(dict(opt, temporal_padding=4), 'cpu')
