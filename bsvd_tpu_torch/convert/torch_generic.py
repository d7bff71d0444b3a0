"""Weights of the zoo's modules between the port's ``nn.Module``s and the
JAX package's parameter trees (counterpart of bsvd_tpu/convert/
torch_generic.py, with the port's own copy of its leaf rules).

The port's modules carry BasicSR's parameter names (``conv_first``,
``body.0.conv1``, ``upconv1``, ``vgg_net.conv5_4``, ``linear1``, ...), so a
published BasicSR ``.pth`` loads with ``load_state_dict``; the JAX trees
mirror the same names, so converting one into the other is a key walk and
a transpose per leaf:

- ``weight`` 4D OIHW <-> ``w`` HWIO; 2D linear (O, I) <-> ``w`` (I, O);
  other ``weight``s (a norm's scale outside BN) <-> ``w``;
- ``bias`` <-> ``b``;
- spectral norm: ``weight_orig`` <-> ``w``, ``weight_u`` <-> ``u`` (the
  persistent power-iteration vector); ``weight_v`` is recomputed from
  (w, u) and not carried into the tree;
- BatchNorm (a module with running statistics): ``weight`` / ``bias`` /
  ``running_mean`` / ``running_var`` <-> ``scale`` / ``bias`` / ``mean`` /
  ``var``; ``num_batches_tracked`` is dropped;
- a module's constant buffers (named in its ``CONSTANT_BUFFERS``, such as
  SpyNet's ImageNet ``mean`` / ``std``) are in BasicSR's state dicts but
  not in the JAX trees: ``to_jax_tree`` leaves them out, and
  ``from_jax_tree(tree, module)`` puts the module's own back.
"""

import numpy as np
import torch

_BN_TO_TREE = {'weight': 'scale', 'bias': 'bias', 'running_mean': 'mean',
               'running_var': 'var'}
_BN_FROM_TREE = {v: k for k, v in _BN_TO_TREE.items()}
_BN_TREE_KEYS = frozenset(_BN_FROM_TREE)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _weight_to_tree(arr):
    if arr.ndim == 4:
        return np.transpose(arr, (2, 3, 1, 0))
    if arr.ndim == 2:
        return np.transpose(arr, (1, 0))
    return arr


def _weight_from_tree(arr):
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:
        return np.transpose(arr, (1, 0))
    return arr


def _sn_v(w_hwio, u):
    """torch spectral_norm's ``weight_v`` for (w, u): W^T u normalised, on
    the (cout, cin*k*k) matrix of the JAX layout."""
    mat = w_hwio.reshape(-1, w_hwio.shape[-1]).T
    v = mat.T @ u
    return (v / (np.linalg.norm(v) + 1e-12)).astype(np.float32)


def state_dict_to_tree(state, dtype=np.float32):
    """A torch state dict (tensors or arrays; a ``module.`` prefix is
    stripped) -> the JAX package's nested tree of numpy leaves."""
    groups = {}
    for key, val in state.items():
        key = key[len('module.'):] if key.startswith('module.') else key
        *path, leaf = key.split('.')
        groups.setdefault(tuple(path), {})[leaf] = _np(val)
    tree = {}
    for path, leaves in groups.items():
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        bn = 'running_mean' in leaves
        for leaf, arr in leaves.items():
            if leaf in ('num_batches_tracked', 'weight_v'):
                continue
            if bn and leaf in _BN_TO_TREE:
                name = _BN_TO_TREE[leaf]
            elif leaf in ('weight', 'weight_orig'):
                name, arr = 'w', _weight_to_tree(arr)
            elif leaf == 'weight_u':
                name = 'u'
            elif leaf == 'bias':
                name = 'b'
            else:
                name = leaf
            node[name] = arr.astype(dtype)
    return tree


def tree_to_state_dict(tree, prefix=''):
    """The inverse of ``state_dict_to_tree``: {dotted key: numpy array}.
    A node holding ``u`` is a spectral-norm conv (``weight_orig``,
    ``weight_u`` and its ``weight_v``); one holding ``scale`` / ``mean`` /
    ``var`` is a BatchNorm."""
    state = {}
    leaves = {k: np.asarray(v) for k, v in tree.items()
              if not isinstance(v, dict)}
    if leaves and _BN_TREE_KEYS <= set(leaves):
        for k, v in leaves.items():
            state[f'{prefix}{_BN_FROM_TREE.get(k, k)}'] = v
    else:
        sn = 'u' in leaves
        for k, v in leaves.items():
            if k == 'w':
                state[f'{prefix}{"weight_orig" if sn else "weight"}'] = \
                    _weight_from_tree(v)
            elif k == 'b':
                state[f'{prefix}bias'] = v
            elif k == 'u':
                state[f'{prefix}weight_u'] = v
                state[f'{prefix}weight_v'] = _sn_v(leaves['w'], v)
            else:
                state[f'{prefix}{k}'] = v
    for k, v in tree.items():
        if isinstance(v, dict):
            state.update(tree_to_state_dict(v, f'{prefix}{k}.'))
    return state


def _constant_keys(module):
    """State-dict keys of the buffers that ``module``'s submodules name in
    their ``CONSTANT_BUFFERS``."""
    return {f'{name}.{b}' if name else b
            for name, m in module.named_modules()
            for b in getattr(m, 'CONSTANT_BUFFERS', ())}


def from_jax_tree(tree, module=None):
    """A JAX parameter tree (numpy or JAX leaves) -> a state dict of fp32
    CPU tensors for the port's module of the same arch; with ``module``,
    its constant buffers too (a complete state dict for a strict
    ``load_state_dict``)."""
    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
             for k, v in tree_to_state_dict(tree).items()}
    if module is not None:
        own = module.state_dict()
        state.update({k: own[k].detach().cpu()
                      for k in _constant_keys(module)})
    return state


def to_jax_tree(module):
    """A port module's parameters and buffers -> the JAX package's tree
    (numpy fp32 leaves); non-persistent and constant buffers are not in
    it."""
    skip = _constant_keys(module)
    return state_dict_to_tree({k: v for k, v in module.state_dict().items()
                               if k not in skip})


def _tree_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_torch_generic(path, module, param_key='params', strict=True):
    """Load a torch ``.pth`` (a BasicSR state dict, under ``param_key``
    where the file has that key) or an ``.npz`` of either package (the
    tree under ``param_key``) into ``module``; returns the module.

    As in the JAX package, every parameter of the module must be in the
    file with its shape (KeyError / ValueError name the first that is
    not); entries of the file that the module lacks are ignored. With
    ``strict=False`` a missing entry keeps the module's value."""
    path = str(path)
    if path.endswith('.npz'):
        from bsvd_tpu_torch.models.checkpoint import load_npz_params
        tree = load_npz_params(path, param_key)
    else:
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        if param_key and param_key in ckpt:
            ckpt = ckpt[param_key]
        tree = state_dict_to_tree(ckpt)
    have = dict(_tree_paths(tree))
    want = to_jax_tree(module)
    for pth, tmpl in _tree_paths(want):
        if pth not in have:
            if strict:
                raise KeyError(f'checkpoint missing parameter '
                               f'{"/".join(pth)}')
            have[pth] = tmpl
            continue
        if np.shape(have[pth]) != tmpl.shape:
            raise ValueError(f'shape mismatch at {"/".join(pth)}: '
                             f'{np.shape(have[pth])} vs {tmpl.shape}')

    def build(node, prefix=()):
        return {k: build(v, prefix + (k,)) if isinstance(v, dict)
                else have[prefix + (k,)] for k, v in node.items()}
    state = from_jax_tree(build(want))
    module.load_state_dict(state, strict=False)
    return module
