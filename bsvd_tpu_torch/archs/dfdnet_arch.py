"""DFDNet, the deep face dictionary network (counterpart of
bsvd_tpu/archs/dfdnet_arch.py; eval only, batch 1, 512 x 512 faces, as the
reference supports).

The module keeps BasicSR's names with every spectral-normed conv a plain
conv: sigma is folded into the weight when a checkpoint is converted
(``convert_torch_dfdnet``; BasicSR runs the net in eval mode only, where
spectral norm is exactly W / sigma(u, v) with u and v frozen). Its convs
are ``F.conv2d`` (XLA convs in the JAX package, no Pallas kernel), its
features the port's ``VGGFeatureExtractor`` (vgg19 relu2_2, relu3_4,
relu4_4, conv5_4 on [-1, 1] input).

The dictionary swap crops each facial part by its landmark box (host
integers), matches the crop against the dictionary's atoms by
correlation after AdaIN, and pastes the best atom back through an
attention block. ``forward`` records the chosen atoms in
``last_atoms`` ({(feature size, part): index}): on a card and on the CPU
two atoms whose scores lie within rounding of each other may swap.

External files (none in the repository): the network
``DFDNet_official-d1fa5650.pth`` and the component dictionary
``DFDNet_dict_512-f79685f0.pth`` (``pretrain_path`` / ``dict_path``; a
dictionary may also be an ``.npz`` of ``'<size>/<part>'`` keys, (K, C, h,
w) arrays). Without a network file the weights are drawn from ``seed``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.inception_arch import resize_bilinear
from bsvd_tpu_torch.archs.vgg_arch import VGGFeatureExtractor, vgg_names
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

PARTS = ('left_eye', 'right_eye', 'nose', 'mouth')
VGG_LAYERS = ('relu2_2', 'relu3_4', 'relu4_4', 'conv5_4')
FEATURE_SIZES = (256, 128, 64, 32)
CHANNEL_SIZES = (128, 256, 512, 512)

# the normalised 3 x 3 binomial kernel of BasicSR's Blur
_BLUR_K = np.array([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]],
                   np.float32) / 16.0


def resize_nearest(x, out_h, out_w):
    """NCHW nearest resize with F.interpolate(mode='nearest') indexing:
    src = floor(dst * in / out)."""
    ih, iw = x.shape[2], x.shape[3]
    ri = torch.as_tensor(np.arange(out_h) * ih // out_h, device=x.device)
    ci = torch.as_tensor(np.arange(out_w) * iw // out_w, device=x.device)
    return x[:, :, ri][:, :, :, ci]


def calc_mean_std(feat, eps=1e-5):
    """Per sample and channel mean and std over H, W; unbiased variance
    (BasicSR's dfdnet_util). feat: NCHW."""
    n, c, h, w = feat.shape
    flat = feat.reshape(n, c, h * w)
    mean = flat.mean(dim=2, keepdim=True)
    var = ((flat - mean) ** 2).sum(dim=2, keepdim=True) / (h * w - 1)
    return mean.reshape(n, c, 1, 1), torch.sqrt(var + eps).reshape(n, c, 1, 1)


def adaptive_instance_normalization(content_feat, style_feat):
    """Renormalise content to the style's per-channel statistics."""
    s_mean, s_std = calc_mean_std(style_feat)
    c_mean, c_std = calc_mean_std(content_feat)
    return (content_feat - c_mean) / c_std * s_std + s_mean


def _conv(cin, cout, dilation=1):
    return nn.Conv2d(cin, cout, 3, 1, dilation, dilation=dilation)


def _seq2(cin, cout, dilation=1):
    """conv -> lrelu(0.2) -> conv (BasicSR's indices 0 and 2)."""
    return nn.Sequential(_conv(cin, cout, dilation), nn.LeakyReLU(0.2),
                         _conv(cout, cout, dilation))


class _Blur(nn.Module):
    """Depthwise 3 x 3 binomial blur, pad 1 (BasicSR's Blur)."""

    def __init__(self, channels):
        super().__init__()
        self.register_buffer('kernel', torch.from_numpy(_BLUR_K)[None, None]
                             .repeat(channels, 1, 1, 1), persistent=False)

    def forward(self, x):
        return F.conv2d(x, self.kernel, padding=1, groups=x.shape[1])


class _SFTUp(nn.Module):
    """Blur -> conv -> lrelu(0.04); SFT (out * scale + sigmoid(shift)); 2x
    bilinear up -> conv -> lrelu(0.2) (BasicSR's SFTUpBlock)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Sequential(_Blur(cin), _conv(cin, cout))
        self.convup = nn.Sequential(nn.Identity(), _conv(cout, cout))
        self.scale_block = _seq2(cin, cout)
        self.shift_block = _seq2(cin, cout)

    def forward(self, x, updated_feat):
        out = F.leaky_relu(self.conv1(x), 0.04)
        scale = self.scale_block(updated_feat)
        shift = torch.sigmoid(self.shift_block(updated_feat))
        out = out * scale + shift
        out = resize_bilinear(out, out.shape[2] * 2, out.shape[3] * 2)
        return F.leaky_relu(self.convup[1](out), 0.2)


class _Res(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.body = _seq2(c, c)

    def forward(self, x):
        return x + self.body(x)


def load_face_dict(dict_path):
    """The component dictionary: a torch ``.pth`` ({size: {part: (K, C,
    h, w)}}) or an ``.npz`` ('<size>/<part>' keys) -> {str(size): {part:
    fp32 NCHW tensor}} on the CPU."""
    out = {}
    if str(dict_path).endswith('.npz'):
        with np.load(dict_path) as z:
            for k in z.files:
                size, part = k.split('/')
                out.setdefault(size, {})[part] = torch.from_numpy(
                    np.ascontiguousarray(z[k], np.float32))
        return out
    d = torch.load(dict_path, map_location='cpu', weights_only=True)
    for size, parts in d.items():
        out[str(size)] = {part: torch.as_tensor(np.asarray(feat),
                                                dtype=torch.float32)
                          for part, feat in parts.items()}
    return out


def _fold_sn(state, prefix):
    """Spectral norm folded: W / sigma, sigma = u . (W_mat @ v) (torch's
    eval-mode spectral norm, power-iteration vectors frozen)."""
    w = np.asarray(state[f'{prefix}.weight_orig'])
    u = np.asarray(state[f'{prefix}.weight_u'])
    v = np.asarray(state[f'{prefix}.weight_v'])
    sigma = float(u @ (w.reshape(w.shape[0], -1) @ v))
    return w / sigma


def convert_torch_dfdnet(state, num_feat=64):
    """A BasicSR DFDNet state dict (its 'params'; tensors or arrays) ->
    the port's state dict: spectral norms folded, the VGG's input-norm
    buffers and anything else not a conv left out."""
    out = {}
    del num_feat
    for prefix, _ in _jax_paths():
        if f'{prefix}.weight_orig' in state:
            w = _fold_sn(state, prefix)
        elif f'{prefix}.weight' in state:
            w = np.asarray(state[f'{prefix}.weight'])
        else:
            continue
        out[f'{prefix}.weight'] = torch.from_numpy(
            np.ascontiguousarray(w, np.float32))
        if f'{prefix}.bias' in state:
            out[f'{prefix}.bias'] = torch.as_tensor(
                np.asarray(state[f'{prefix}.bias']), dtype=torch.float32)
    return out


def _jax_paths():
    """(port conv prefix, path in the JAX package's dfdnet tree)."""
    pairs = [(f'vgg_extractor.vgg_net.{n}', ('vgg', n)) for n in
             vgg_names('vgg19')[:vgg_names('vgg19').index('conv5_4') + 1]
             if n.startswith('conv')]
    for fs in FEATURE_SIZES:
        for p in PARTS:
            pairs += [(f'attn_blocks.{p}_{fs}.{i}', ('attn', f'{p}_{fs}', k))
                      for k, i in enumerate((0, 2))]
    for i in range(4):
        pairs += [(f'multi_scale_dilation.conv_blocks.{i}.{j}',
                   ('ms_dilation', 'blocks', i, k))
                  for k, j in enumerate((0, 2))]
    pairs.append(('multi_scale_dilation.conv_fusion',
                  ('ms_dilation', 'fusion')))
    for i in range(4):
        pairs += [(f'upsample{i}.conv1.1', (f'upsample{i}', 'conv1')),
                  (f'upsample{i}.convup.1', (f'upsample{i}', 'convup'))]
        for blk, name in (('scale_block', 'scale'), ('shift_block', 'shift')):
            pairs += [(f'upsample{i}.{blk}.{j}', (f'upsample{i}', name, k))
                      for k, j in enumerate((0, 2))]
    pairs += [('upsample4.0', ('upsample4', 'conv0')),
              ('upsample4.4', ('upsample4', 'out'))]
    for r, idx in (('res1', 2), ('res2', 3)):
        pairs += [(f'upsample4.{idx}.body.{j}', ('upsample4', r, k))
                  for k, j in enumerate((0, 2))]
    return pairs


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_from_jax_tree(tree):
    """The JAX package's DFDNet tree (``dfdnet_init`` /
    ``convert_torch_dfdnet``: HWIO ``w``, ``b``) -> the port's state dict
    (OIHW fp32 CPU tensors)."""
    out = {}
    for prefix, path in _jax_paths():
        p = _get(tree, path)
        out[f'{prefix}.weight'] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(p['w'], np.float32), (3, 2, 0, 1))))
        if 'b' in p:
            out[f'{prefix}.bias'] = torch.as_tensor(np.array(p['b']),
                                                    dtype=torch.float32)
    return out


def jax_tree_from_state(state):
    """The port's state dict -> the JAX package's DFDNet tree (numpy)."""
    tree = {}
    for prefix, path in _jax_paths():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        leaf = {'w': np.transpose(
            state[f'{prefix}.weight'].detach().cpu().numpy(), (2, 3, 1, 0))}
        if f'{prefix}.bias' in state:
            leaf['b'] = state[f'{prefix}.bias'].detach().cpu().numpy()
        node[path[-1]] = leaf
    def listify(node):      # JAX keeps the conv pairs and blocks as lists
        if isinstance(node, dict) and node and all(
                isinstance(k, int) for k in node):
            return [listify(node[k]) for k in sorted(node)]
        if isinstance(node, dict) and 'w' not in node:
            return {k: listify(v) for k, v in node.items()}
        return node
    return listify(tree)


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):
    """NCHW DFDNet: ``forward(x, part_locations)``, x (1, 3, H, W) in
    [-1, 1] (512 x 512 in use; a smaller face keeps its part boxes in
    512-scale coordinates), part_locations four (1, 4) boxes [x0, y0, x1,
    y1] (left eye, right eye, nose, mouth)."""

    def __init__(self, num_feat, dict_path=None, face_dict=None, seed=0,
                 pretrain_path=None):
        super().__init__()
        self.num_feat = num_feat
        if face_dict is not None:
            self.face_dict = {str(k): {p: torch.as_tensor(
                np.asarray(v) if not torch.is_tensor(v) else v,
                dtype=torch.float32) for p, v in d.items()}
                for k, d in face_dict.items()}
        elif dict_path is not None:
            self.face_dict = load_face_dict(dict_path)
        else:
            raise ValueError('DFDNet needs dict_path or face_dict')
        # the VGG's weights come from the DFDNet file or the seed, never
        # from torchvision's file: point the extractor at no file
        self.vgg_extractor = VGGFeatureExtractor(
            list(VGG_LAYERS), 'vgg19', use_input_norm=True, range_norm=True,
            seed=seed, pretrain_path='/nonexistent')
        self.attn_blocks = nn.ModuleDict({
            f'{part}_{fs}': _seq2(c, c)
            for fs, c in zip(FEATURE_SIZES, CHANNEL_SIZES) for part in PARTS})
        cf = num_feat * 8
        self.multi_scale_dilation = nn.Module()
        self.multi_scale_dilation.conv_blocks = nn.ModuleList(
            [_seq2(cf, cf, d) for d in (4, 3, 2, 1)])
        self.multi_scale_dilation.conv_fusion = _conv(cf * 4, cf)
        up = [(cf, cf), (cf, num_feat * 4), (num_feat * 4, num_feat * 2),
              (num_feat * 2, num_feat)]
        for i, (ci, co) in enumerate(up):
            setattr(self, f'upsample{i}', _SFTUp(ci, co))
        self.upsample4 = nn.Sequential(
            _conv(num_feat, num_feat), nn.LeakyReLU(0.2), _Res(num_feat),
            _Res(num_feat), _conv(num_feat, 3), nn.Tanh())
        self._init_weights(seed)
        if pretrain_path:
            self.load(pretrain_path)
        self.last_atoms = {}
        for p in self.parameters():
            p.requires_grad_(False)
        self.eval()

    def _init_weights(self, seed):
        """Kaiming-normal weights and torch's default biases from
        ``seed`` (the JAX package's ``conv_init`` distributions)."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   * np.sqrt(2.0 / fan_in))
                    m.bias.copy_((torch.rand(m.bias.shape, generator=gen)
                                  * 2 - 1) / np.sqrt(fan_in))

    def load(self, path, param_key='params'):
        """A BasicSR DFDNet checkpoint (spectral norms folded)."""
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        state = ckpt.get(param_key, ckpt)
        self.load_state_dict(convert_torch_dfdnet(state, self.num_feat),
                             strict=False)
        return self

    def _swap_feat(self, vgg_feat, updated_feat, dict_feat, location,
                   part_name, f_size):
        """Dictionary swap of one facial part: crop -> AdaIN-matched atoms
        -> correlation argmax -> nearest resize back -> attention-gated
        residual. Returns the updated features and the chosen atom."""
        x0, y0, x1, y1 = [int(v) for v in location]
        part_feat = vgg_feat[:, :, y0:y1, x0:x1]
        dh, dw = dict_feat.shape[2], dict_feat.shape[3]
        part_resize = resize_bilinear(part_feat, dh, dw)
        dict_feat = adaptive_instance_normalization(dict_feat, part_resize)
        # correlation of the query with each atom; softmax keeps the argmax
        scores = torch.einsum('chw,kchw->k', part_resize[0], dict_feat)
        idx = int(torch.argmax(scores))
        swap = resize_nearest(dict_feat[idx:idx + 1], part_feat.shape[2],
                              part_feat.shape[3])
        attn = self.attn_blocks[f'{part_name}_{f_size}'](swap - part_feat)
        out = updated_feat.clone()
        out[:, :, y0:y1, x0:x1] = attn * swap + part_feat
        return out, idx

    def forward(self, x, part_locations):
        feats = self.vgg_extractor(x)
        updated = []
        self.last_atoms = {}
        for vgg_layer, f_size in zip(VGG_LAYERS, FEATURE_SIZES):
            feat = feats[vgg_layer]
            upd = feat
            for part_idx, part in enumerate(PARTS):
                loc = part_locations[part_idx]
                loc = loc.cpu().numpy() if torch.is_tensor(loc) else loc
                # 512 is BasicSR's face size: location // (512 / f_size)
                loc = (np.asarray(loc)[0] // (512 / f_size)).astype(np.int64)
                atoms = self.face_dict[str(f_size)][part]
                if atoms.device != x.device:
                    atoms = self.face_dict[str(f_size)][part] = \
                        atoms.to(x.device)
                upd, idx = self._swap_feat(feat, upd, atoms, loc, part,
                                           f_size)
                self.last_atoms[(f_size, part)] = idx
            updated.append(upd)
        ms = self.multi_scale_dilation
        y = feats['conv5_4']
        y = ms.conv_fusion(torch.cat([blk(y) for blk in ms.conv_blocks],
                                     1)) + y
        y = self.upsample0(y, updated[3])
        y = self.upsample1(y, updated[2])
        y = self.upsample2(y, updated[1])
        y = self.upsample3(y, updated[0])
        return self.upsample4(y)
