"""The VGG feature extractor of the perceptual and style losses
(counterpart of bsvd_tpu/archs/vgg_arch.py): the layer-name tables,
``insert_bn``, ``convert_torchvision_vgg`` and ``VGGFeatureExtractor``.

The module keeps BasicSR's names: ``vgg_net.<layer name>`` (``conv1_1``,
``bn1_1``, ``relu1_1``, ``pool1``, ...) for the layers up to the deepest
requested one, and ``mean`` / ``std`` buffers for the input norm. Its
convs are ``F.conv2d`` (XLA in the JAX package, no Pallas kernel).

Weights: torchvision's ``features.<idx>`` state dict (``vgg19-dcbb9e9d.pth``
or an ``.npz`` of the same keys), read from ``pretrain_path``, else from
``BSVD_VGG_PRETRAIN_PATH``, else from
``experiments/pretrained_models/vgg19-dcbb9e9d.pth``; none of them is in
the repository. Without a file the net is initialised at random from
``seed`` and ``pretrained`` is False (the loss logs the JAX package's
warning). The parameters never train: ``requires_grad`` is off and the
module stays in eval mode (its BN uses the running statistics).
"""

import os
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

DEFAULT_PRETRAIN_PATH = 'experiments/pretrained_models/vgg19-dcbb9e9d.pth'

NAMES = {
    'vgg11': [
        'conv1_1', 'relu1_1', 'pool1', 'conv2_1', 'relu2_1', 'pool2',
        'conv3_1', 'relu3_1', 'conv3_2', 'relu3_2', 'pool3', 'conv4_1',
        'relu4_1', 'conv4_2', 'relu4_2', 'pool4', 'conv5_1', 'relu5_1',
        'conv5_2', 'relu5_2', 'pool5'
    ],
    'vgg13': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'pool3', 'conv4_1', 'relu4_1', 'conv4_2',
        'relu4_2', 'pool4', 'conv5_1', 'relu5_1', 'conv5_2', 'relu5_2',
        'pool5'
    ],
    'vgg16': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'pool3', 'conv4_1',
        'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3', 'relu4_3', 'pool4',
        'conv5_1', 'relu5_1', 'conv5_2', 'relu5_2', 'conv5_3', 'relu5_3',
        'pool5'
    ],
    'vgg19': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'conv3_4', 'relu3_4',
        'pool3', 'conv4_1', 'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3',
        'relu4_3', 'conv4_4', 'relu4_4', 'pool4', 'conv5_1', 'relu5_1',
        'conv5_2', 'relu5_2', 'conv5_3', 'relu5_3', 'conv5_4', 'relu5_4',
        'pool5'
    ]
}

# ImageNet normalisation of [0, 1] inputs
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def insert_bn(names):
    """A bn layer after each conv (``conv1_1`` -> ``bn1_1``)."""
    out = []
    for name in names:
        out.append(name)
        if 'conv' in name:
            out.append('bn' + name.replace('conv', ''))
    return out


def vgg_names(vgg_type='vgg19'):
    """The layer names of ``vgg_type`` (``_bn`` types with their BNs), in
    torchvision's ``features`` order."""
    names = NAMES[vgg_type.replace('_bn', '')]
    return insert_bn(names) if 'bn' in vgg_type else list(names)


def _conv_channels(name):
    return min(64 * 2 ** (int(name[4]) - 1), 512)


def convert_torchvision_vgg(state_dict, vgg_type='vgg19'):
    """torchvision's ``features.<idx>.*`` (tensors or arrays) -> this
    module's ``vgg_net.<name>.*`` state dict of fp32 tensors; layers the
    file lacks (a truncated checkpoint) are left out."""
    out = {}
    for idx, name in enumerate(vgg_names(vgg_type)):
        keys = (('weight', 'bias', 'running_mean', 'running_var')
                if name.startswith('bn') else ('weight', 'bias'))
        if f'features.{idx}.weight' not in state_dict or not \
                name.startswith(('conv', 'bn')):
            continue
        for k in keys:
            out[f'vgg_net.{name}.{k}'] = torch.as_tensor(
                np.asarray(state_dict[f'features.{idx}.{k}']),
                dtype=torch.float32)
    return out


def read_torchvision_vgg(path):
    """A torchvision VGG state dict from a ``.pth`` (``torch.load`` with
    ``weights_only``) or an ``.npz``."""
    if str(path).endswith('.npz'):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return torch.load(path, map_location='cpu', weights_only=True)


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """Features of ``layer_name_list`` of a VGG on NCHW input in [0, 1]
    (or [-1, 1] with ``range_norm``): a dict name -> NCHW tensor."""

    def __init__(self, layer_name_list, vgg_type='vgg19', use_input_norm=True,
                 range_norm=False, requires_grad=False, remove_pooling=False,
                 pooling_stride=2, seed=0, pretrain_path=None):
        super().__init__()
        del requires_grad       # the extractor never trains (JAX: deleted)
        self.layer_name_list = list(layer_name_list)
        self.vgg_type = vgg_type
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = vgg_names(vgg_type)
        max_idx = max(names.index(v) for v in self.layer_name_list)
        layers, cin = OrderedDict(), 3
        for name in names[:max_idx + 1]:
            if name.startswith('conv'):
                cout = _conv_channels(name)
                layers[name] = nn.Conv2d(cin, cout, 3, 1, 1)
                cin = cout
            elif name.startswith('bn'):
                layers[name] = nn.BatchNorm2d(cin)
            elif name.startswith('relu'):
                layers[name] = nn.ReLU()
            elif not remove_pooling:
                layers[name] = nn.MaxPool2d(2, stride=pooling_stride)
        self.vgg_net = nn.Sequential(layers)
        self.register_buffer('mean', torch.tensor(_MEAN).view(1, 3, 1, 1))
        self.register_buffer('std', torch.tensor(_STD).view(1, 3, 1, 1))
        # pretrain_path False: random weights, no file looked for
        path = None if pretrain_path is False else (
            pretrain_path or os.environ.get('BSVD_VGG_PRETRAIN_PATH',
                                            DEFAULT_PRETRAIN_PATH))
        self.pretrained = path is not None and os.path.exists(path)
        if self.pretrained:
            self.load_state_dict(convert_torchvision_vgg(
                read_torchvision_vgg(path), vgg_type), strict=False)
        else:
            gen = torch.Generator().manual_seed(int(seed))
            with torch.no_grad():
                for m in self.vgg_net:
                    if isinstance(m, nn.Conv2d):
                        fan_in = m.weight[0].numel()
                        m.weight.copy_(torch.randn(m.weight.shape,
                                                   generator=gen)
                                       * np.sqrt(2.0 / fan_in))
                        m.bias.copy_((torch.rand(m.bias.shape, generator=gen)
                                      * 2 - 1) / np.sqrt(fan_in))
        for p in self.parameters():
            p.requires_grad_(False)
        self.eval()

    def train(self, mode=True):
        """Stays in eval mode (BN on its running statistics)."""
        return super().train(False)

    def forward(self, x):
        if self.range_norm:
            x = (x + 1) / 2
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        out = {}
        for name, layer in self.vgg_net.named_children():
            if isinstance(layer, nn.BatchNorm2d):
                x = F.batch_norm(x, layer.running_mean, layer.running_var,
                                 layer.weight, layer.bias, False, 0.0,
                                 layer.eps)
            else:
                x = layer(x)
            if name in self.layer_name_list:
                out[name] = x
        return out
