"""Checkpoint files (counterpart of bsvd_tpu/models/checkpoint.py).

Parameter trees go to flat-key ``.npz`` files in the JAX package's format
(``<param_key>/<flat/path>`` keys, the empty-dict sentinel for parameter-
less subtrees), so a file written by either package loads in the other
(with ``convert.torch_ckpt.to_jax_params`` / ``from_jax_params`` between
the two tree layouts). Training state (epoch, iteration, the optimizer's
moments) is the port's own format: ``torch.save`` of tensors, ints and
dicts. Saves are atomic (a temporary file, then a rename) and retried.
"""

import os
import time

import numpy as np
import torch

# Parameter-less subtrees (the norm slots of 'none' and 'in') are kept through a
# sentinel key so that a save/load round trip is structure-exact.
_EMPTY_SENTINEL = '__empty_dict__'


def flatten_tree(tree, prefix=''):
    """Nested dict/list tree -> {flat/key/path: np.ndarray}."""
    flat = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            return {f'{prefix}{_EMPTY_SENTINEL}': np.zeros((0,), np.float32)}
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        return {prefix.rstrip('/'): np.asarray(tree)}
    for k, v in items:
        flat.update(flatten_tree(v, f'{prefix}{k}/'))
    return flat


def unflatten_tree(flat):
    """Inverse of flatten_tree (all containers become dicts)."""
    tree = {}
    for key, val in flat.items():
        parts = key.split('/')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != _EMPTY_SENTINEL:
            node[parts[-1]] = val
    return tree


def _atomic_retry_write(path, write_fn, retries=3):
    tmp = str(path) + '.tmp'
    for attempt in range(retries):
        try:
            write_fn(tmp)
            os.replace(tmp, path)
            return
        except Exception:
            if attempt == retries - 1:
                raise
            time.sleep(1)


def save_npz_params(path, params_dict):
    """Save {'params': tree, 'params_ema': tree, ...} (numpy or tensor
    leaves) into one npz, keys ``<param_key>/<flat/path>``."""
    flat = {}
    for param_key, tree in params_dict.items():
        if tree is None:
            continue
        for k, v in flatten_tree(tree).items():
            flat[f'{param_key}/{k}'] = v

    def write(p):
        with open(p, 'wb') as f:   # a file handle: np.savez appends no .npz
            np.savez(f, **flat)
    _atomic_retry_write(path, write)


def load_npz_params(path, param_key='params'):
    """One parameter tree (numpy leaves) by key from an npz checkpoint."""
    with np.load(path) as z:
        prefix = f'{param_key}/'
        flat = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
        avail = sorted({k.split('/', 1)[0] for k in z.files})
    if not flat:
        raise KeyError(f'param key {param_key!r} not in checkpoint '
                       f'(available: {avail})')
    return unflatten_tree(flat)


def save_training_state(path, state):
    """Write a training state (tensors moved to the CPU, ints, dicts)."""
    state = _to_cpu(state)
    _atomic_retry_write(path, lambda p: torch.save(state, p))


def load_training_state(path, map_location='cpu'):
    return torch.load(path, map_location=map_location, weights_only=True)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree
