"""Weights into the port: JAX parameter trees and reference ``.pth`` TSN
state dicts (counterpart of bsvd_tpu/convert/torch_ckpt.py).

The published BSVD checkpoints hold ``{'params': state_dict, 'params_ema':
...}`` in the TSN training layout ``(module.)?base_model.nets_list.{s}.
<block>...``, temporal convs wrapped as ``...c1.net.weight``. The port's
tree uses torch OIHW weights, so a state dict maps onto it without a
transpose; JAX trees (HWIO) are transposed.
"""

import numpy as np
import torch

__all__ = ['tsn_key_map', 'from_jax_params', 'to_jax_params',
           'from_jax_stream_state', 'load_tsn_state_dict',
           'to_tsn_state_dict']

_PREFIXES = ('module.base_model.nets_list.', 'base_model.nets_list.',
             'module.nets_list.', 'nets_list.')


def tsn_key_map(cfg):
    """Yield (torch_key_prefix, path_tuple, kind) for every parameter;
    ``kind`` is 'conv' or 'bn', the prefix relative to ``nets_list.`` without
    ``.weight`` / ``.bias``. Temporal convs carry ``.net`` unless
    shift_mode is 'none'."""
    net = '' if cfg.shift_mode == 'none' else '.net'
    for s in range(cfg.stage_num):
        st = f'stage{s}'
        if cfg.shift_input:
            yield f'{s}.inc.c1{net}', (st, 'inc', 'c1'), 'conv'
            yield f'{s}.inc.b1', (st, 'inc', 'n1'), 'bn'
            yield f'{s}.inc.c2{net}', (st, 'inc', 'c2'), 'conv'
            yield f'{s}.inc.b2', (st, 'inc', 'n2'), 'bn'
        else:
            yield f'{s}.inc.convblock.0', (st, 'inc', 'c1'), 'conv'
            yield f'{s}.inc.convblock.1', (st, 'inc', 'n1'), 'bn'
            yield f'{s}.inc.convblock.3', (st, 'inc', 'c2'), 'conv'
            yield f'{s}.inc.convblock.4', (st, 'inc', 'n2'), 'bn'
        for name, mine in (('downc0', 'down0'), ('downc1', 'down1')):
            yield f'{s}.{name}.convblock.0', (st, mine, 'conv'), 'conv'
            yield f'{s}.{name}.convblock.1', (st, mine, 'n'), 'bn'
            yield f'{s}.{name}.convblock.3.c1{net}', (st, mine, 'cv', 'c1'), 'conv'
            yield f'{s}.{name}.convblock.3.b1', (st, mine, 'cv', 'n1'), 'bn'
            yield f'{s}.{name}.convblock.3.c2{net}', (st, mine, 'cv', 'c2'), 'conv'
            yield f'{s}.{name}.convblock.3.b2', (st, mine, 'cv', 'n2'), 'bn'
        for name, mine in (('upc2', 'up2'), ('upc1', 'up1')):
            yield f'{s}.{name}.convblock.0.c1{net}', (st, mine, 'cv', 'c1'), 'conv'
            yield f'{s}.{name}.convblock.0.b1', (st, mine, 'cv', 'n1'), 'bn'
            yield f'{s}.{name}.convblock.0.c2{net}', (st, mine, 'cv', 'c2'), 'conv'
            yield f'{s}.{name}.convblock.0.b2', (st, mine, 'cv', 'n2'), 'bn'
            yield f'{s}.{name}.convblock.1', (st, mine, 'conv'), 'conv'
        yield f'{s}.outc.convblock.0', (st, 'outc', 'c1'), 'conv'
        yield f'{s}.outc.convblock.1', (st, 'outc', 'n1'), 'bn'
        yield f'{s}.outc.convblock.3', (st, 'outc', 'c2'), 'conv'


def _conv_keys(cfg):
    cfg.check_supported()
    return [(k, p) for k, p, kind in tsn_key_map(cfg) if kind == 'conv']


def _set_path(tree, path, leaf):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def _get_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(v):
    return torch.tensor(np.asarray(v), dtype=torch.float32)


def from_jax_params(np_tree, cfg):
    """A bsvd_tpu ``wnet_init`` tree (numpy or array leaves, HWIO weights)
    -> the port's tree (OIHW, fp32)."""
    params = {}
    for _, path in _conv_keys(cfg):
        leaf = _get_path(np_tree, path)
        out = {'w': _tensor(np.transpose(np.asarray(leaf['w']), (3, 2, 0, 1)))}
        if 'b' in leaf:
            out['b'] = _tensor(leaf['b'])
        _set_path(params, path, out)
    return params


def to_jax_params(params, cfg):
    """The port's tree (tensor or numpy leaves, OIHW) -> a bsvd_tpu
    ``wnet_init`` tree of fp32 numpy arrays: HWIO weights, and the empty
    norm slots (``n1`` / ``n2`` / ``n``) that norm='none' nets carry, so
    that ``bsvd_tpu.models.checkpoint`` saves and loads it structure-exact.
    The inverse of ``from_jax_params``."""
    cfg.check_supported()

    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, np.float32)

    tree = {}
    for _, path, kind in tsn_key_map(cfg):
        if kind == 'bn':
            _set_path(tree, path, {})
            continue
        leaf = _get_path(params, path)
        out = {'w': np.ascontiguousarray(np.transpose(arr(leaf['w']),
                                                      (2, 3, 1, 0)))}
        if leaf.get('b') is not None:
            out['b'] = arr(leaf['b'])
        _set_path(tree, path, out)
    return tree


def from_jax_stream_state(np_state, cfg):
    """A bsvd_tpu ``stream_init`` / ``StreamDenoiser.state`` tree (numpy or
    array leaves, natural layout) -> the port's streaming state: packed
    buffers and ring buffers as CPU tensors of their own dtype,
    ``has_center`` as a bool and the ring counters ``w`` / ``r`` as ints.
    Move it with ``.to`` to resume on another device."""
    def tensor(v):
        return torch.from_numpy(np.array(v))

    def bib(node):
        return {'packed': tensor(node['packed']),
                'has_center': bool(np.asarray(node['has_center']))}

    out = []
    for st in np_state[:cfg.stage_num]:
        new = {}
        for k, v in st.items():
            if k.startswith('skip'):
                new[k] = {'buf': tensor(v['buf']), 'w': int(np.asarray(v['w'])),
                          'r': int(np.asarray(v['r']))}
            else:
                new[k] = [bib(b) for b in v]
        out.append(new)
    return out


def _strip_prefix(state):
    out = {}
    for k, v in state.items():
        for pre in _PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


def load_tsn_state_dict(state, cfg, param_key='params'):
    """A reference TSN state dict (tensors or numpy), or the path of a
    ``.pth`` holding one (optionally under ``param_key``), -> the port's
    tree (fp32). Accepts the ``module.`` / ``base_model.nets_list.``
    prefixes."""
    if not isinstance(state, dict):
        state = torch.load(str(state), map_location='cpu', weights_only=True)
    if param_key and param_key in state:
        state = state[param_key]
    state = _strip_prefix(state)
    params = {}
    for tkey, path in _conv_keys(cfg):
        if f'{tkey}.weight' not in state:
            raise KeyError(f'missing conv weight {tkey}.weight '
                           f'(have e.g. {sorted(state)[:4]})')
        leaf = {'w': _tensor(state[f'{tkey}.weight'])}
        if f'{tkey}.bias' in state:
            leaf['b'] = _tensor(state[f'{tkey}.bias'])
        _set_path(params, path, leaf)
    return params


def to_tsn_state_dict(params, cfg):
    """The port's tree -> a reference TSN state dict (CPU tensors)."""
    state = {}
    for tkey, path in _conv_keys(cfg):
        leaf = _get_path(params, path)
        state[f'base_model.nets_list.{tkey}.weight'] = leaf['w'].detach().cpu()
        if 'b' in leaf:
            state[f'base_model.nets_list.{tkey}.bias'] = leaf['b'].detach().cpu()
    return state
