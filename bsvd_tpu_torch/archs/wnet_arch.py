"""WNet, the W-shaped multi-stage temporal-shift U-Net denoiser, in
PyTorch (counterpart of bsvd_tpu/archs/wnet_arch.py: WNetConfig, wnet_init,
the natural-layout _stage_apply, wnet_apply and the BSVD / TSN wrappers).

Layout is ``(N, T, H, W, C)`` channels-last, as in the JAX package; the T
axis merges into the batch of every conv. Each stage runs on four kernel
entry points (``ops``): K2 ``conv_chain`` for inc and for outc (with the
skip-add and the residual), K3 ``conv_s2`` for the two down convs, K1
``conv3x3`` with a temporal shift for the 8 CvBlock convs, and K4
``conv_ps`` for the two up convs. On CPU tensors each op runs its plain
PyTorch version; on CUDA tensors its hand-written kernel.

Parameters are a nested dict mirroring the JAX tree, with torch OIHW conv
weights: ``{'stage0': {'inc': {'c1': {'w', 'b'}, ...}, ...}}``. Only
``norm='none'`` and ``shift_input=False`` are ported so far.

``wnet_apply`` is differentiable: with grad mode on and parameters (or an
input) that require grad, every op runs as its autograd Function (the JAX
custom_vjps' direct backwards, K7 for the weight gradients), which is the
training forward of ``TSN.train_forward``.
"""

import dataclasses
import logging
from typing import Tuple

import torch
from torch import nn

from bsvd_tpu_torch.nn.layers import ACTS, conv_init
from bsvd_tpu_torch.ops._pack import ConvWeights
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv_ps
from bsvd_tpu_torch.ops.conv_chain import conv_chain, conv_chain_add2_res
from bsvd_tpu_torch.ops.conv_s2 import conv_s2
from bsvd_tpu_torch.ops.shift_conv import shift_conv, shift_conv_add2
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

_log = logging.getLogger('bsvd_tpu_torch')


@dataclasses.dataclass(frozen=True)
class WNetConfig:
    """Static architecture configuration (fields as bsvd_tpu's)."""
    chns: Tuple[int, ...] = (32, 64, 128)
    mid_ch: int = 3
    in_ch: int = 4
    out_ch: int = 3
    stage_num: int = 2
    interm_ch: int = 30
    norm: str = 'bn'
    act: str = 'relu'
    bias: bool = True
    blind: bool = False
    shift_input: bool = False
    shift_mode: str = 'TSM'    # 'none' | 'TSM' | 'TSM_toFutureOnly'
    fold_div: int = 8
    residual_ch: int = 3

    def __post_init__(self):
        if self.norm not in ('none', 'in', 'bn'):
            raise ValueError(f'unknown norm {self.norm!r}')
        if self.act not in ACTS:
            raise ValueError(f'unknown act {self.act!r}')
        if self.shift_mode not in ('none', 'TSM', 'TSM_toFutureOnly'):
            raise ValueError(f'unknown shift_mode {self.shift_mode!r}')

    def check_supported(self):
        """Raise for the options the port does not run yet (ROADMAP.md)."""
        if self.norm != 'none':
            raise NotImplementedError(
                f"norm {self.norm!r}: the port runs norm='none' only so far")
        if self.shift_input:
            raise NotImplementedError('shift_input: not ported yet')

    def stage_io(self, i):
        """(in_ch, out_ch) of stage i; blind drops stage 0's noise map."""
        s_in = self.in_ch if i == 0 else self.mid_ch
        if self.blind and i == 0:
            s_in = 3
        s_out = self.out_ch if i == self.stage_num - 1 else self.mid_ch
        return s_in, s_out

    @property
    def effective_in_ch(self):
        """Channels of a frame fed to the net (blind nets take no noise
        map)."""
        return 3 if self.blind else self.in_ch

    @property
    def shift_num(self):
        return 8 * self.stage_num


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stage_init(cfg, i, g):
    s_in, s_out = cfg.stage_io(i)
    c0, c1, c2 = cfg.chns

    def conv(cin, cout):
        return conv_init(cin, cout, 3, cfg.bias, generator=g)

    def cv(ch):
        return {'c1': conv(ch, ch), 'c2': conv(ch, ch)}

    return {
        'inc': {'c1': conv(s_in, cfg.interm_ch), 'c2': conv(cfg.interm_ch, c0)},
        'down0': {'conv': conv(c0, c1), 'cv': cv(c1)},
        'down1': {'conv': conv(c1, c2), 'cv': cv(c2)},
        'up2': {'cv': cv(c2), 'conv': conv(c2, 4 * c1)},
        'up1': {'cv': cv(c1), 'conv': conv(c1, 4 * c0)},
        'outc': {'c1': conv(c0, c0), 'c2': conv(c0, s_out)},
    }


def wnet_init(cfg, seed=0, generator=None):
    """Random parameters (kaiming-normal weights, torch default bias) from a
    torch.Generator seeded with ``seed``; fp32 on the CPU."""
    cfg.check_supported()
    g = generator if generator is not None else torch.Generator().manual_seed(
        seed)
    return {f'stage{i}': _stage_init(cfg, i, g) for i in range(cfg.stage_num)}


def _is_conv_leaf(node):
    return isinstance(node, dict) and 'w' in node


def prepare_params(params, device, dtype):
    """The tree with every conv as a ConvWeights cast to ``dtype`` on
    ``device`` (what the kernels pack once and reuse). ConvWeights leaves
    already there are kept, with their packed weights."""
    if isinstance(params, ConvWeights):
        if params.w.device == torch.device(device) and params.w.dtype == dtype:
            return params
        params = {'w': params.w, 'b': params.b}
    if _is_conv_leaf(params):
        b = params.get('b')
        return ConvWeights(params['w'].detach().to(device, dtype),
                           None if b is None else b.detach().to(device, dtype))
    return {k: prepare_params(v, device, dtype) for k, v in params.items()}


# ---------------------------------------------------------------------------
# apply (MIMO over (N, T, H, W, C))
# ---------------------------------------------------------------------------

def _cw(leaf):
    return leaf if isinstance(leaf, ConvWeights) else ConvWeights(
        leaf['w'], leaf.get('b'))


def _cvblock(p, x, cfg, t_len, x_add=None):
    """Two temporal-shift convs + act (reference CvBlock); ``x_add`` is
    summed into the first conv's input (up1's x1 + x2)."""
    c1, c2 = _cw(p['c1']), _cw(p['c2'])
    if cfg.shift_mode == 'none':
        x = conv3x3(x, c1, x2=x_add, act=cfg.act)
        return conv3x3(x, c2, act=cfg.act)
    causal = 'toFutureOnly' in cfg.shift_mode
    if x_add is None:
        x = shift_conv(x, c1, None, t_len, cfg.fold_div, cfg.act, causal)
    else:
        x = shift_conv_add2(x, x_add, c1, None, t_len, cfg.fold_div, cfg.act,
                            causal)
    return shift_conv(x, c2, None, t_len, cfg.fold_div, cfg.act, causal)


def _stage_apply(p, x, cfg, t_len):
    """One DenBlock stage on (N*T, H, W, C) frames, the natural-layout
    stage of bsvd_tpu (wnet_arch.py _stage_apply)."""
    x0 = conv_chain(x, _cw(p['inc']['c1']), None, _cw(p['inc']['c2']), None,
                    cfg.act, cfg.act)
    x1 = conv_s2(x0, _cw(p['down0']['conv']), act=cfg.act)
    x1 = _cvblock(p['down0']['cv'], x1, cfg, t_len)
    x2 = conv_s2(x1, _cw(p['down1']['conv']), act=cfg.act)
    x2 = _cvblock(p['down1']['cv'], x2, cfg, t_len)
    x2 = _cvblock(p['up2']['cv'], x2, cfg, t_len)
    x2 = conv_ps(x2, _cw(p['up2']['conv']))
    x1 = _cvblock(p['up1']['cv'], x1, cfg, t_len, x_add=x2)
    x1 = conv_ps(x1, _cw(p['up1']['conv']))
    # outc: act(conv(x0 + x1)) -> conv, then the residual on the first
    # residual_ch channels (wnet_models.py:181): x[..., :rc] - y[..., :rc]
    return conv_chain_add2_res(x0, x1, x, _cw(p['outc']['c1']), None,
                               _cw(p['outc']['c2']), None, cfg.act, 'none',
                               cfg.residual_ch)


def wnet_apply(params, x, cfg):
    """MIMO forward: x (N, T, H, W, C_in) -> (N, T, H, W, out_ch).

    With shift_mode='TSM' this is whole-clip BSVD inference when T is the
    clip length (and the TSN training forward when T == num_segments)."""
    cfg.check_supported()
    n, t, h, w, c = x.shape
    y = x.reshape(n * t, h, w, c)
    for i in range(cfg.stage_num):
        y = _stage_apply(params[f'stage{i}'], y, cfg, t)
    return y.reshape(n, t, h, w, y.shape[-1])


# ---------------------------------------------------------------------------
# nn.Module wrappers with reference-compatible construction / IO
# ---------------------------------------------------------------------------

def _to_module(tree):
    if _is_conv_leaf(tree):
        return nn.ParameterDict({k: nn.Parameter(v)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_tree(mod):
    if isinstance(mod, nn.ParameterDict):
        return {k: v for k, v in mod.items()}
    return {k: _to_tree(v) for k, v in mod.items()}


def _warn_unknown_opts(where, extra):
    if extra:
        _log.warning(f'{where}: ignoring unknown network option(s) '
                     f'{sorted(extra)}')


class _WNetBase(nn.Module):
    """Holds (cfg, params); called with reference layout (N, F, C, H, W)."""

    def __init__(self, cfg, params=None, seed=0):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        self.params = _to_module(params if params is not None
                                 else wnet_init(cfg, seed))
        self._prepared = {}

    @property
    def shift_num(self):
        return self.cfg.shift_num

    def param_tree(self):
        """The parameters as the nested dict ``wnet_apply`` takes, detached
        (they share storage with the module's; ``train_forward`` uses the
        parameters themselves)."""
        return _map_tree(_to_tree(self.params), torch.Tensor.detach)

    def prepared(self, device, dtype):
        """Parameters cast to ``dtype`` on ``device`` as ConvWeights, cached
        until any parameter changes (kernels pack them once)."""
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        key = (torch.device(device), dtype)
        hit = self._prepared.get(key)
        if hit is None or hit[0] != stamp:
            hit = (stamp, prepare_params(self.param_tree(), key[0], dtype))
            self._prepared[key] = hit
        return hit[1]

    def load_params(self, params):
        """Replace the parameters with a port tree (e.g. from
        convert.from_jax_params / load_tsn_state_dict)."""
        dev = next(self.parameters()).device
        with torch.no_grad():
            for name, p in self.named_parameters():
                node = params
                for part in name.split('.')[1:]:
                    node = node[part]
                p.copy_(torch.as_tensor(node).to(dev, p.dtype))
        return self

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_ckpt import load_tsn_state_dict
        return self.load_params(load_tsn_state_dict(path, self.cfg,
                                                    param_key=param_key))

    def forward(self, input, noise_map=None):
        """input (N, F, C, H, W) [+ noise_map (N, F, 1, H, W)] ->
        (N, F, out_ch, H, W), computed in input's dtype. Inference: no
        autograd graph is recorded."""
        if noise_map is not None:
            input = torch.cat([input, noise_map.to(input.dtype)], dim=2)
        x = input.permute(0, 1, 3, 4, 2)
        with torch.no_grad():
            y = wnet_apply(self.prepared(x.device, x.dtype), x, self.cfg)
        return y.permute(0, 1, 4, 2, 3)

    def train_forward(self, x, amp=False):
        """The training forward with autograd on: x (N, T, H, W, C_in) ->
        fp32 (N, T, H, W, out_ch). With ``amp`` the parameters are cast to
        bf16 differentiably (their gradients come back to the fp32 masters
        through the cast, each rounded to bf16 first) and x is cast too
        (bsvd_tpu/models/denoising_model.py make_train_step, amp=True)."""
        params = _to_tree(self.params)
        if amp:
            params = _map_tree(params, lambda t: t.to(torch.bfloat16))
            x = x.to(torch.bfloat16)
        with torch.enable_grad():
            return wnet_apply(params, x, self.cfg).float()


@ARCH_REGISTRY.register()
class TSN(_WNetBase):
    """Temporal-shift network with the reference's TSN options
    (options/train/bsvd_c64_unblind.yml network_g)."""

    def __init__(self, num_segments=11, base_model='WNet_multistage',
                 shift_type='TSM', shift_div=8, inplace=False, net2d_opt=None,
                 enable_past_buffer=True, seed=0, **kwargs):
        del inplace
        _warn_unknown_opts('TSN', kwargs)
        if base_model != 'WNet_multistage':
            raise NotImplementedError(f'base_model {base_model!r}')
        opt = dict(net2d_opt or {})
        cfg = WNetConfig(
            chns=tuple(opt.pop('chns', (32, 64, 128))),
            mid_ch=opt.pop('mid_ch', 3), in_ch=opt.pop('in_ch', 4),
            out_ch=opt.pop('out_ch', 3), stage_num=opt.pop('stage_num', 2),
            interm_ch=opt.pop('interm_ch', 30), norm=opt.pop('norm', 'bn'),
            act=opt.pop('act', 'relu'), bias=opt.pop('bias', True),
            blind=opt.pop('blind', False),
            shift_input=opt.pop('shift_input', False),
            shift_mode='none' if shift_type == 'no_temporal_shift'
            else shift_type,
            fold_div=shift_div, residual_ch=opt.pop('residual_ch', 3))
        _warn_unknown_opts('TSN net2d_opt', opt)
        self.num_segments = num_segments
        self.enable_past_buffer = enable_past_buffer
        super().__init__(cfg, seed=seed)


@ARCH_REGISTRY.register()
class BSVD(_WNetBase):
    """Inference network with the reference BSVD options (options/test/
    bsvd_c64.yml network_g). Whole-clip MIMO with zero temporal boundaries
    equals the reference's bidirectional-buffer pipeline."""

    def __init__(self, chns=(32, 64, 128), mid_ch=3, shift_input=False,
                 in_ch=4, out_ch=3, norm='bn', act='relu', interm_ch=30,
                 blind=False, pretrain_ckpt=None, shift_mode='TSM',
                 residual_ch=3, bias=True, seed=0, **kwargs):
        _warn_unknown_opts('BSVD', kwargs)
        cfg = WNetConfig(
            chns=tuple(chns), mid_ch=mid_ch, in_ch=in_ch, out_ch=out_ch,
            interm_ch=interm_ch, norm=norm, act=act, bias=bias, blind=blind,
            shift_input=shift_input, shift_mode=shift_mode,
            residual_ch=residual_ch)
        super().__init__(cfg, seed=seed)
        if pretrain_ckpt is not None:
            self.load(pretrain_ckpt)


# Stale alias used by options/test/0706_*.yml (maps to today's BSVD class).
BufferConv = BSVD
ARCH_REGISTRY._do_register('BufferConv', BSVD)
