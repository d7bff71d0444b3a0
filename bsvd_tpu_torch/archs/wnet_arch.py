"""WNet, the W-shaped multi-stage temporal-shift U-Net denoiser, in
PyTorch (counterpart of bsvd_tpu/archs/wnet_arch.py: WNetConfig, wnet_init,
the natural-layout _stage_apply, wnet_apply, the chunked wnet_apply_chunk
and the BSVD / TSN wrappers), with every option a WNetConfig holds.

Layout is ``(N, T, H, W, C)`` channels-last, as in the JAX package; the T
axis merges into the batch of every conv. Each stage runs on four kernel
entry points (``ops``): K2 ``conv_chain`` for inc and for outc (with the
skip-add and the residual), K3 ``conv_s2`` for the two down convs, K1
``conv3x3`` with a temporal shift for the 8 CvBlock convs (10 with
``shift_input``, whose inc is a CvBlock too), and K4 ``conv_ps`` for the
two up convs. On CPU tensors each op runs its plain PyTorch version; on
CUDA tensors its hand-written kernel.

Norms. The kernels apply bias and act, never a norm. BN at inference is
folded into its conv's weights and bias (``fold_bn``: ``prepare_params``
folds, and the whole-clip and chunked forwards fold a raw tree once a
call), so it runs the kernels of norm 'none'. Where a
norm must run between a conv and its act (norm 'in'; BN on the batch's
statistics while training) the route splits (``_Norms``): each conv runs
with act 'none', then the norm and the act as plain torch ops, and the
two-conv K2 sites become K1 launches (outc's residual then a torch op).
A K2 site whose intermediate is too wide for K2's shared memory
(``ops.conv_chain.fits``: bf16 past 256 channels, 192 with x2; fp32 past
192) takes the same two K1 launches.

Parameters are a nested dict mirroring the JAX tree, with torch OIHW conv
weights: ``{'stage0': {'inc': {'c1': {'w', 'b'}, 'n1': {...}, ...}, ...}}``.
Norm slots hold BN leaves (``scale``, ``bias``, running ``mean`` and
``var``) and are absent for norms 'none' and 'in', which have no
parameters (the JAX tree's empty dicts; ``convert.torch_ckpt`` maps both).

``wnet_apply`` is differentiable: with grad mode on and parameters (or an
input) that require grad, every op runs as its autograd Function (the JAX
custom_vjps' direct backwards, K7 for the weight gradients), which is the
training forward of ``TSN.train_forward``; ``remat`` recomputes each stage
in the backward (``_RematStage``).
"""

import copy
import dataclasses
import logging
from typing import Tuple

import torch
from torch import nn

from bsvd_tpu_torch.nn.layers import (ACTS, NORMS, conv_init, fold_bn_conv,
                                      get_act, is_bn_leaf, norm_apply,
                                      norm_init)
from bsvd_tpu_torch.nn.shift import chunk_carry, chunk_frame0
from bsvd_tpu_torch.ops._pack import ConvWeights
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv_ps
from bsvd_tpu_torch.ops.conv_chain import (conv_chain, conv_chain_add2_res,
                                           fits)
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
    # recompute each stage in the backward (training memory for FLOPs);
    # inference is unaffected
    remat: bool = False

    def __post_init__(self):
        if self.norm not in NORMS:
            raise ValueError(f'unknown norm {self.norm!r}')
        if self.act not in ACTS:
            raise ValueError(f'unknown act {self.act!r}')
        if self.shift_mode not in ('none', 'TSM', 'TSM_toFutureOnly'):
            raise ValueError(f'unknown shift_mode {self.shift_mode!r}')

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
        """Temporal (shift) convs of the net: 8 a stage, 10 with
        shift_input; the bidirectional pipeline's delay in frames."""
        return (8 + 2 * self.shift_input) * self.stage_num


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _drop_empty(tree):
    """The tree without its parameter-less norm slots (None)."""
    return {k: _drop_empty(v) if isinstance(v, dict) else v
            for k, v in tree.items() if v is not None}


def _stage_init(cfg, i, g):
    s_in, s_out = cfg.stage_io(i)
    c0, c1, c2 = cfg.chns

    def conv(cin, cout):
        return conv_init(cin, cout, 3, cfg.bias, generator=g)

    def norm(ch):
        return norm_init(cfg.norm, ch)

    def cv(cin, ch):
        return {'c1': conv(cin, ch), 'n1': norm(ch), 'c2': conv(ch, ch),
                'n2': norm(ch)}

    # shift_input: inc is a CvBlock s_in -> c0 -> c0 (no interm_ch)
    inc = cv(s_in, c0) if cfg.shift_input else {
        'c1': conv(s_in, cfg.interm_ch), 'n1': norm(cfg.interm_ch),
        'c2': conv(cfg.interm_ch, c0), 'n2': norm(c0)}
    return _drop_empty({
        'inc': inc,
        'down0': {'conv': conv(c0, c1), 'n': norm(c1), 'cv': cv(c1, c1)},
        'down1': {'conv': conv(c1, c2), 'n': norm(c2), 'cv': cv(c2, c2)},
        'up2': {'cv': cv(c2, c2), 'conv': conv(c2, 4 * c1)},
        'up1': {'cv': cv(c1, c1), 'conv': conv(c1, 4 * c0)},
        'outc': {'c1': conv(c0, c0), 'n1': norm(c0), 'c2': conv(c0, s_out)},
    })


def wnet_init(cfg, seed=0, generator=None):
    """Random parameters (kaiming-normal weights, torch default bias; BN
    scale 1, bias 0, running mean 0, var 1) from a torch.Generator seeded
    with ``seed``; fp32 on the CPU."""
    g = generator if generator is not None else torch.Generator().manual_seed(
        seed)
    return {f'stage{i}': _stage_init(cfg, i, g) for i in range(cfg.stage_num)}


def _is_conv_leaf(node):
    return isinstance(node, dict) and 'w' in node


# each conv key and the norm slot that follows it
_CONV_NORM = (('c1', 'n1'), ('c2', 'n2'), ('conv', 'n'))


def fold_bn(tree):
    """The tree with each conv that a BN leaf follows replaced by the one
    conv computing both (eval-mode BN on the running statistics,
    ``nn.layers.fold_bn_conv``, in fp32) and the BN leaves dropped; a tree
    without BN leaves comes back as it was."""
    if not isinstance(tree, dict) or _is_conv_leaf(tree):
        return tree
    out = {k: fold_bn(v) for k, v in tree.items() if not is_bn_leaf(v)}
    for c, n in _CONV_NORM:
        if is_bn_leaf(tree.get(n)):
            cw = _cw(tree[c])
            out[c] = fold_bn_conv(cw.w, cw.b, tree[n])
    return out


def _has_bn(params):
    """Whether the tree still holds its BN leaves (every BN net has one
    after its first conv); O(1), so a prepared tree is not walked."""
    return is_bn_leaf(params['stage0']['inc'].get('n1'))


def _folded(params):
    """A raw BN tree with BN folded (``fold_bn``); any other tree as it
    is."""
    return fold_bn(params) if _has_bn(params) else params


def prepare_params(params, device, dtype):
    """The tree with every conv as a ConvWeights cast to ``dtype`` on
    ``device`` (what the kernels pack once and reuse), BN folded into its
    conv first (``fold_bn``, in fp32, then cast). ConvWeights leaves already
    there are kept, with their packed weights."""
    return _prepare(fold_bn(params), device, dtype)


def _prepare(params, device, dtype):
    if isinstance(params, ConvWeights):
        if params.w.device == torch.device(device) and params.w.dtype == dtype:
            return params
        params = {'w': params.w, 'b': params.b}
    if _is_conv_leaf(params):
        b = params.get('b')
        return ConvWeights(params['w'].detach().to(device, dtype),
                           None if b is None else b.detach().to(device, dtype))
    return {k: _prepare(v, device, dtype) for k, v in params.items()}


# ---------------------------------------------------------------------------
# apply (MIMO over (N, T, H, W, C))
# ---------------------------------------------------------------------------

def _cw(leaf):
    return leaf if isinstance(leaf, ConvWeights) else ConvWeights(
        leaf['w'], leaf.get('b'))


class _Norms:
    """How a forward's conv sites end. ``normed``: a norm runs between the
    conv and its act (norm 'in', or BN on the batch's statistics, which
    the BN sites append to ``stats``), so the kernels take act 'none' and
    ``__call__`` applies norm and act; otherwise (norm 'none', BN folded)
    the kernels apply the act. ``mask``: the row-validity hook ``mask(v,
    level)`` of the spatially sharded forward (parallel/spatial.py), which
    ``__call__`` applies after every conv site, after the act (relu /
    relu6 of 0 is 0, so this is JAX's order). ``split``: the two-conv K2
    sites run as two K1 launches, for a norm or for a mask (a chain cannot
    mask its intermediate). On an interior shard the mask is the identity
    and the sites still split: the port keeps one route per forward."""

    def __init__(self, cfg, stats=None, mask=None):
        self.norm, self.act, self.stats = cfg.norm, cfg.act, stats
        self.mask = mask
        self.normed = cfg.norm == 'in' or (cfg.norm == 'bn'
                                           and stats is not None)
        self.split = self.normed or mask is not None
        self.kernel_act = 'none' if self.normed else cfg.act

    def __call__(self, y, leaf, level=1):
        """The site's norm (``leaf`` its parameters, or None) and act on a
        conv output computed with ``kernel_act``, then the mask at
        resolution ``level``."""
        if self.normed:
            y = get_act(self.act)(norm_apply(self.norm, leaf, y, self.stats))
        return self.rows(y, level)

    def rows(self, y, level):
        """The mask alone (a conv site with no norm and no act: the up
        convs); the identity without one."""
        return y if self.mask is None else self.mask(y, level)

    def replay(self):
        """The same route with statistics recorded nowhere: the recompute
        of a rematerialised stage normalises as its forward did, and its
        BN sites must not be folded a second time."""
        other = copy.copy(self)
        if self.stats is not None:
            other.stats = []
        return other


def _shift_conv_site(cw, leaf, x, cfg, t_len, nrm, site=None, x_add=None,
                     level=1):
    """One temporal-shift conv (+ norm) + act of a CvBlock: K1 with the
    shift, or, with ``site`` (a ``_ChunkShiftSite``), the chunk's; with
    shift_mode 'none' K1 without a shift. ``x_add`` is summed into the
    conv's input (up1's x1 + x2)."""
    act = nrm.kernel_act
    if cfg.shift_mode == 'none':
        y = conv3x3(x, cw, x2=x_add, act=act)
    elif site is not None:
        y = _chunk_shift_conv(cw, x, cfg, t_len, site, act, x_add)
    else:
        causal = 'toFutureOnly' in cfg.shift_mode
        if x_add is None:
            y = shift_conv(x, cw, None, t_len, cfg.fold_div, act, causal)
        else:
            y = shift_conv_add2(x, x_add, cw, None, t_len, cfg.fold_div, act,
                                causal)
    return nrm(y, leaf, level)


def _cvblock(p, x, cfg, t_len, nrm, x_add=None, sites=None, level=1):
    """Two temporal-shift convs (+ norm) + act (reference CvBlock) at
    resolution ``level``. ``sites``: the two convs' ``_ChunkShiftSite``s
    on the chunked path, else None."""
    s1, s2 = (None, None) if sites is None else sites
    x = _shift_conv_site(_cw(p['c1']), p.get('n1'), x, cfg, t_len, nrm, s1,
                         x_add, level)
    return _shift_conv_site(_cw(p['c2']), p.get('n2'), x, cfg, t_len, nrm,
                            s2, level=level)


def _residual(x, y, rc):
    """The per-stage residual on the first ``rc`` channels
    (wnet_models.py:181): ``x[..., :rc] - y[..., :rc]``, the rest of y."""
    return torch.cat([x[..., :rc] - y[..., :rc], y[..., rc:]], dim=-1)


def _stem(inc, x, cfg, nrm):
    """inc without shift_input (conv, act, conv, act): one K2, or two K1
    (+ norm) + act where the route splits or the intermediate is too wide
    for K2 (``conv_chain.fits``)."""
    if nrm.split or not fits(_cw(inc['c1']).cout, x.dtype, False):
        act = nrm.kernel_act
        x = nrm(conv3x3(x, _cw(inc['c1']), act=act), inc.get('n1'))
        return nrm(conv3x3(x, _cw(inc['c2']), act=act), inc.get('n2'))
    return conv_chain(x, _cw(inc['c1']), None, _cw(inc['c2']), None,
                      cfg.act, cfg.act)


def _down(d, x, nrm, level):
    """A stride-2 down conv (+ norm) + act to resolution ``level``: K3."""
    return nrm(conv_s2(x, _cw(d['conv']), act=nrm.kernel_act), d.get('n'),
               level)


def _outc(o, x, x2, res, cfg, nrm):
    """outc on (x + x2) (act(conv), then conv), then the residual from
    ``res`` (the stage input): one K2, or two K1 and a torch op where the
    route splits or the intermediate is too wide for K2."""
    if nrm.split or not fits(_cw(o['c1']).cout, x.dtype, True):
        y = nrm(conv3x3(x, _cw(o['c1']), x2=x2, act=nrm.kernel_act),
                o.get('n1'))
        return _residual(res, conv3x3(y, _cw(o['c2']), act='none'),
                        cfg.residual_ch)
    return conv_chain_add2_res(x, x2, res, _cw(o['c1']), None, _cw(o['c2']),
                               None, cfg.act, 'none', cfg.residual_ch)


def _stage_apply(p, x, cfg, t_len, nrm, sites=None):
    """One DenBlock stage on (N*T, H, W, C) frames, the natural-layout
    stage of bsvd_tpu (wnet_arch.py _stage_apply). ``sites``: the stage's
    ``_ChunkShiftSite``s on the chunked path, keyed by position as in JAX:
    inc c1 / c2 (with shift_input), then down0.cv c1 / c2, down1.cv,
    up2.cv, up1.cv."""
    off = 2 if cfg.shift_input else 0

    def pair(k):
        return None if sites is None else sites[k:k + 2]

    if cfg.shift_input:
        x0 = _cvblock(p['inc'], x, cfg, t_len, nrm, sites=pair(0))
    else:
        x0 = _stem(p['inc'], x, cfg, nrm)
    d = p['down0']
    x1 = _cvblock(d['cv'], _down(d, x0, nrm, 2), cfg, t_len, nrm,
                  sites=pair(off), level=2)
    d = p['down1']
    x2 = _cvblock(d['cv'], _down(d, x1, nrm, 4), cfg, t_len, nrm,
                  sites=pair(off + 2), level=4)
    x2 = _cvblock(p['up2']['cv'], x2, cfg, t_len, nrm, sites=pair(off + 4),
                  level=4)
    x2 = nrm.rows(conv_ps(x2, _cw(p['up2']['conv'])), 2)
    x1 = _cvblock(p['up1']['cv'], x1, cfg, t_len, nrm, x_add=x2,
                  sites=pair(off + 6), level=2)
    x1 = nrm.rows(conv_ps(x1, _cw(p['up1']['conv'])), 1)
    return _outc(p['outc'], x0, x1, x, cfg, nrm)


def _flatten(tree, prefix=()):
    """[(path, tensor)] of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(paths, leaves):
    tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


class _RematStage(torch.autograd.Function):
    """A stage whose activations are dropped after the forward and
    recomputed in the backward (the JAX package's jax.checkpoint of a
    stage): only the stage input is kept. The stage's parameters are inputs
    of the Function, so their gradients come back here even where the
    stage input needs none (stage 0). The recompute normalises as the
    forward did and records no BN statistics (``_Norms.replay``). Written
    out rather than taken from torch.utils.checkpoint, which imports
    torch._dynamo at its first call."""

    @staticmethod
    def forward(ctx, stage, y, *leaves):
        ctx.stage = stage
        ctx.save_for_backward(y, *leaves)
        with torch.no_grad():
            return stage(y, leaves, False)

    @staticmethod
    def backward(ctx, g):
        y, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        ins = [t.detach().requires_grad_(n) for t, n in zip([y] + leaves,
                                                           need)]
        with torch.enable_grad():
            out = ctx.stage(ins[0], ins[1:], True)
        wrt = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in ins)


def _remat_stage(p, y, cfg, t_len, nrm):
    """A stage under ``_RematStage``."""
    paths, leaves = zip(*_flatten(p))

    def stage(v, ts, replay):
        return _stage_apply(_unflatten(paths, ts), v, cfg, t_len,
                            nrm.replay() if replay else nrm)
    return _RematStage.apply(stage, y, *leaves)


def wnet_apply(params, x, cfg, bn_stats=None):
    """MIMO forward: x (N, T, H, W, C_in) -> (N, T, H, W, out_ch).

    With shift_mode='TSM' this is whole-clip BSVD inference when T is the
    clip length (and the TSN training forward when T == num_segments).
    Norm 'bn': with ``bn_stats`` None, eval mode (BN folded into the
    convs); with a list, train mode (batch statistics, appended to it for
    ``nn.layers.bn_update``). ``cfg.remat`` under autograd recomputes each
    stage in the backward (``_RematStage``)."""
    nrm = _Norms(cfg, bn_stats)
    if not nrm.normed:
        params = _folded(params)
    n, t, h, w, c = x.shape
    y = x.reshape(n * t, h, w, c)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.stage_num):
        stage = _remat_stage if remat else _stage_apply
        y = stage(params[f'stage{i}'], y, cfg, t, nrm)
    return y.reshape(n, t, h, w, y.shape[-1])


# ---------------------------------------------------------------------------
# chunked MIMO with per-site carries (bsvd_tpu/archs/wnet_arch.py
# _ChunkShiftSite, _chunk_shift_conv_site, wnet_apply_chunk)
# ---------------------------------------------------------------------------

def _frames(v, t_len):
    """(N*T, H, W, C) -> (N, T, H, W, C), a view."""
    nt, h, w, c = v.shape
    return v.view(nt // t_len, t_len, h, w, c)


class _ChunkShiftSite:
    """One carry-threaded temporal-shift site of the chunked protocol:
    ``carry`` is what the previous chunk left at this site (None on the
    first chunk: zeros), and ``record`` writes the outgoing carry into
    slot ``idx`` of ``out``. The site's input is ``x`` (+ ``x_add`` at
    up1's first conv), summed only on the frames and lanes read here."""

    def __init__(self, cfg, carry, future, out, idx):
        self.cfg, self.carry, self.future = cfg, carry, future
        self.out, self.idx = out, idx

    def _lanes(self, x, x_add, t_len):
        """``lanes(j, lo, hi)`` of nn/shift.chunk_frame0 / chunk_carry over
        the site's input, summing ``x_add`` only on what is read."""
        def lanes(j, lo, hi):
            f = _frames(x, t_len)[:, j, ..., lo:hi]
            return f if x_add is None else (
                f + _frames(x_add, t_len)[:, j, ..., lo:hi])
        return lanes

    def record(self, x, x_add, t_len):
        """The outgoing carry, in the compute dtype (no lanes where
        fold_div exceeds the channels: the stems of shift_input)."""
        self.out[self.idx] = chunk_carry(
            self._lanes(x, x_add, t_len), x.shape[-1], t_len, self.future,
            self.cfg.fold_div, self.cfg.shift_mode)

    def frame0(self, x, x_add, t_len):
        """Frame 0's shifted input under the chunk boundary, (N, H, W, C)
        contiguous (K1's 16-byte loader needs it)."""
        return chunk_frame0(self._lanes(x, x_add, t_len), x.shape[-1], t_len,
                            self.carry, self.cfg.fold_div,
                            self.cfg.shift_mode)


def _chunk_shift_conv(cw, x, cfg, t_len, site, act, x_add=None):
    """A shift conv site of the chunked path. K1 runs the whole chunk with
    the zero-boundary shift, which is already right on frames 1..T-1; frame
    0, the only frame whose shifted input differs, is recomputed by K1 at
    one frame from ``site.frame0`` and written into K1's output in place
    (no second full tensor)."""
    causal = 'toFutureOnly' in cfg.shift_mode
    if x_add is None:
        y = shift_conv(x, cw, None, t_len, cfg.fold_div, act, causal)
    else:
        y = shift_conv_add2(x, x_add, cw, None, t_len, cfg.fold_div, act,
                            causal)
    y0 = conv3x3(site.frame0(x, x_add, t_len), cw, act=act)
    site.record(x, x_add, t_len)
    _frames(y, t_len)[:, 0] = y0
    return y


def wnet_apply_chunk(params, x, cfg, carries, future_buffer_len=0):
    """Forward one chunk (N, T, H, W, C_in) of the chunked MIMO protocol,
    threading a carry through each of the ``cfg.shift_num`` shift sites.

    Carries are keyed by position: site ``stage * per_stage + k``
    (per_stage 8, or 10 with shift_input), k in the order of
    ``_stage_apply``'s ``sites``, the two inc sites first. ``carries`` is
    None on the first chunk (the zero boundary). Returns (out (N, T, H, W,
    out_ch), new_carries); with ``shift_mode='none'`` there is nothing to
    carry (all None). Inference only: no autograd graph is recorded, BN
    runs folded.
    """
    n, t, h, w, c = x.shape
    per_stage = cfg.shift_num // cfg.stage_num
    new_carries = [None] * cfg.shift_num
    params = _folded(params)
    nrm = _Norms(cfg)
    y = x.reshape(n * t, h, w, c)
    with torch.no_grad():
        for i in range(cfg.stage_num):
            sites = [_ChunkShiftSite(
                cfg, None if carries is None else carries[k],
                future_buffer_len, new_carries, k)
                for k in range(i * per_stage, (i + 1) * per_stage)]
            y = _stage_apply(params[f'stage{i}'], y, cfg, t, nrm, sites)
    return y.reshape(n, t, h, w, y.shape[-1]), new_carries


# ---------------------------------------------------------------------------
# nn.Module wrappers with reference-compatible construction / IO
# ---------------------------------------------------------------------------

class _BNLeaf(nn.Module):
    """A BN site: ``scale`` and ``bias`` are parameters; the running
    ``mean`` and ``var`` are buffers, which no optimizer updates
    (``nn.layers.bn_update`` does, once a train step)."""

    def __init__(self, leaf):
        super().__init__()
        self.scale = nn.Parameter(leaf['scale'])
        self.bias = nn.Parameter(leaf['bias'])
        self.register_buffer('mean', leaf['mean'])
        self.register_buffer('var', leaf['var'])

    def tree(self):
        return {'scale': self.scale, 'bias': self.bias, 'mean': self.mean,
                'var': self.var}


def _to_module(tree):
    if is_bn_leaf(tree):
        return _BNLeaf(tree)
    if _is_conv_leaf(tree):
        return nn.ParameterDict({k: nn.Parameter(v)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_tree(mod):
    if isinstance(mod, _BNLeaf):
        return mod.tree()
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
        self.cfg = cfg
        self.params = _to_module(params if params is not None
                                 else wnet_init(cfg, seed))
        self._prepared = {}

    @property
    def shift_num(self):
        return self.cfg.shift_num

    def _leaves(self):
        """(name, tensor) of every parameter and buffer (BN running
        statistics)."""
        return list(self.named_parameters()) + list(self.named_buffers())

    def param_tree(self):
        """The parameters (and BN running statistics) as the nested dict
        ``wnet_apply`` takes, detached (they share storage with the
        module's; ``train_forward`` uses the parameters themselves)."""
        return _map_tree(_to_tree(self.params), torch.Tensor.detach)

    def prepared(self, device, dtype):
        """Parameters cast to ``dtype`` on ``device`` as ConvWeights (BN
        folded), cached until any parameter or running statistic changes
        (kernels pack them once)."""
        stamp = tuple((t.data_ptr(), t._version) for _, t in self._leaves())
        key = (torch.device(device), dtype)
        hit = self._prepared.get(key)
        if hit is None or hit[0] != stamp:
            hit = (stamp, prepare_params(self.param_tree(), key[0], dtype))
            self._prepared[key] = hit
        return hit[1]

    def load_params(self, params):
        """Replace the parameters (and BN running statistics) with a port
        tree (e.g. from convert.from_jax_params / load_tsn_state_dict)."""
        with torch.no_grad():
            for name, t in self._leaves():
                node = params
                for part in name.split('.')[1:]:
                    node = node[part]
                t.copy_(torch.as_tensor(node).to(t.device, t.dtype))
        return self

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_ckpt import load_tsn_state_dict
        return self.load_params(load_tsn_state_dict(path, self.cfg,
                                                    param_key=param_key))

    def forward(self, input, noise_map=None):
        """input (N, F, C, H, W) [+ noise_map (N, F, 1, H, W)] ->
        (N, F, out_ch, H, W), computed in input's dtype. Inference (BN on
        its running statistics): no autograd graph is recorded."""
        if noise_map is not None:
            input = torch.cat([input, noise_map.to(input.dtype)], dim=2)
        x = input.permute(0, 1, 3, 4, 2)
        with torch.no_grad():
            y = wnet_apply(self.prepared(x.device, x.dtype), x, self.cfg)
        return y.permute(0, 1, 4, 2, 3)

    def train_forward(self, x, amp=False, bn_stats=None, apply=wnet_apply):
        """The training forward with autograd on: x (N, T, H, W, C_in) ->
        fp32 (N, T, H, W, out_ch). With ``amp`` the parameters are cast to
        bf16 differentiably (their gradients come back to the fp32 masters
        through the cast, each rounded to bf16 first) and x is cast too
        (bsvd_tpu/models/denoising_model.py make_train_step, amp=True).
        ``bn_stats``: a list for train-mode BN (see ``wnet_apply``), its
        entries holding the module's own running statistics; fp32 only.
        ``apply(params, x, cfg, bn_stats)``: the forward (the spatially
        sharded train step passes its per-rank one)."""
        params = _to_tree(self.params)
        if amp:
            if bn_stats is not None:
                raise ValueError('train-mode BN runs in fp32 (its statistics '
                                 'would update bf16 copies): amp must be off')
            params = _map_tree(params, lambda t: t.to(torch.bfloat16))
            x = x.to(torch.bfloat16)
        with torch.enable_grad():
            return apply(params, x, self.cfg, bn_stats).float()


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
            fold_div=shift_div, residual_ch=opt.pop('residual_ch', 3),
            remat=opt.pop('remat', False))
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
