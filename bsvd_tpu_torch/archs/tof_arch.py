"""TOFlow, task-oriented flow video enhancement, as an ``nn.Module``
(counterpart of bsvd_tpu/archs/tof_arch.py, BasicSR's tof_arch): a
four-level SpyNet variant whose basic modules carry BatchNorm, each
neighbour of a 7-frame window warped onto the reference frame, then a
four-conv reconstruction of the reference frame.

BasicSR's names (``spynet.basic_module.<level>.basic_module.<0, 1, 3,
...>``, ``conv_1`` .. ``conv_4``, the ImageNet ``mean`` / ``std``
buffers), so a BasicSR ``.pth`` loads with ``load_state_dict``. The JAX
package's tree keeps BasicSR's BatchNorm leaf names (``w``, ``b``,
``running_mean``, ``running_var``), not the generic ``scale`` / ``mean``
ones: ``tree_from_state`` / ``state_from_tree`` carry that layout (shared
with DUF, ``duf_arch``), which ``convert.torch_generic`` uses.

BatchNorm always normalises by its running statistics, in training too,
as the JAX package's does (it has no batch-statistics path).
"""

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.duf_arch import EvalBN, state_from_tree, \
    tree_from_state
from bsvd_tpu_torch.archs.sr_archs import _Init
from bsvd_tpu_torch.nn.warp import flow_warp, interpolate_bilinear
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_CHANS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


class BasicModule(nn.Module):
    """7x7 conv (no bias), BN, ReLU four times, then a 7x7 conv with a
    bias: (ref, warped supp, flow), 8 channels -> the flow's residual."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (cin, cout) in enumerate(_CHANS):
            last = i == len(_CHANS) - 1
            layers.append(nn.Conv2d(cin, cout, 7, 1, 3, bias=last))
            if not last:
                layers += [EvalBN(cout), nn.ReLU()]
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


class SpyNetTOF(nn.Module):
    """Four levels; ref / supp (N, 3, H, W), H and W multiples of 16 ->
    the flow (N, 2, H, W) that warps supp onto ref."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(BasicModule() for _ in range(4))

    def forward(self, ref, supp):
        n, _, h, w = ref.shape
        refs, supps = [ref], [supp]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
        flow = ref.new_zeros(n, 2, h // 16, w // 16)
        for i in range(4):
            fh, fw = refs[i].shape[-2:]
            up = interpolate_bilinear(flow, fh, fw, align_corners=True) * 2.0
            warped = flow_warp(supps[i], up.permute(0, 2, 3, 1))
            flow = up + self.basic_module[i](torch.cat([refs[i], warped, up],
                                                       1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(nn.Module):
    """(N, 7, 3, H, W) frames in [0, 1], H and W multiples of 16 ->
    (N, 3, H, W), the reference frame (index 3; index 0 with
    ``adapt_official_weights``, whose frame order puts it first)."""

    CONSTANT_BUFFERS = ('mean', 'std')

    def __init__(self, adapt_official_weights=False, seed=0):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        self.register_buffer('mean', torch.tensor(MEAN).view(1, 3, 1, 1))
        self.register_buffer('std', torch.tensor(STD).view(1, 3, 1, 1))
        self.spynet = SpyNetTOF()
        self.conv_1 = nn.Conv2d(3 * 7, 64, 9, 1, 4)
        self.conv_2 = nn.Conv2d(64, 64, 9, 1, 4)
        self.conv_3 = nn.Conv2d(64, 64, 1)
        self.conv_4 = nn.Conv2d(64, 3, 1)
        _Init(seed).all_kaiming(self)

    tree_from_state = staticmethod(tree_from_state)
    state_from_tree = staticmethod(state_from_tree)

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
        return load_torch_generic(path, self, param_key)

    def forward(self, lrs):
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        n, t, c, h, w = lrs.shape
        lrs = (lrs - self.mean[:, None]) / self.std[:, None]
        lr_ref = lrs[:, self.ref_idx]
        aligned = []
        for i in range(t):
            if i == self.ref_idx:
                aligned.append(lr_ref)
            else:
                flow = self.spynet(lr_ref, lrs[:, i])
                aligned.append(flow_warp(lrs[:, i], flow.permute(0, 2, 3, 1)))
        hr = torch.cat(aligned, 1)              # frame-major channels
        hr = F.relu(self.conv_1(hr))
        hr = F.relu(self.conv_2(hr))
        hr = F.relu(self.conv_3(hr))
        hr = self.conv_4(hr) + lr_ref
        return hr * self.std + self.mean
