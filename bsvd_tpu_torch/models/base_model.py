"""BaseModel: the train engine's checkpointing and EMA (counterpart of
bsvd_tpu/models/base_model.py). Parameters are the network module's; the
EMA copy and the optimizer state live on the model's device.

Network files are ``.npz`` in the JAX package's tree layout (HWIO, BN
leaves or empty norm slots), so each package loads the other's; a reference ``.pth`` TSN
state dict loads too. Training states are the port's own format
(``models/checkpoint.py``).
"""

import os
from collections import OrderedDict
from os import path as osp

import torch

from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               load_tsn_state_dict,
                                               to_jax_params)
from bsvd_tpu_torch.models.checkpoint import (load_npz_params,
                                              save_npz_params,
                                              save_training_state)
from bsvd_tpu_torch.parallel.mesh import is_main_process
from bsvd_tpu_torch.utils.logger import get_root_logger


def _zip_leaves(a, b, fn):
    if isinstance(a, dict):
        for k in a:
            _zip_leaves(a[k], b[k], fn)
    else:
        fn(a, b)


class BaseModel:

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt['is_train']
        self.log_dict = OrderedDict()
        self.current_iter = 0

    def get_current_log(self):
        """The last step's losses as floats (read back here, not per step)."""
        return OrderedDict((k, float(v)) for k, v in self.log_dict.items())

    def update_learning_rate(self, current_iter, warmup_iter=-1):
        """A no-op, as in the JAX package: the learning rate is a function
        of the optimizer's step (``models/lr_scheduler.py``), its warm-up
        the options' ``train.warmup_iter``. Another ``warmup_iter`` than -1
        or that one raises: this call cannot change the schedule."""
        train_opt = self.opt.get('train') or {}
        if warmup_iter not in (-1, None, train_opt.get('warmup_iter', -1)):
            raise NotImplementedError(
                f'update_learning_rate(warmup_iter={warmup_iter}): the '
                f'schedule is a function of the step; its warm-up is '
                f'train.warmup_iter ({train_opt.get("warmup_iter", -1)})')

    def print_network(self, net):
        """Log the network's class, its parameter count and its config."""
        n = sum(p.numel() for p in net.parameters())
        logger = get_root_logger()
        logger.info(f'Network: {net.__class__.__name__}, with {n:,d} '
                    f'parameters.')
        cfg = getattr(net, 'cfg', None)
        if cfg is not None:
            logger.info(str(cfg))

    def get_current_learning_rate(self):
        """The schedule at the current iteration (as the JAX package logs
        it; the update itself used the optimizer's count)."""
        sched = getattr(self, 'lr_schedule', None)
        return [0.0] if sched is None else [float(sched(self.current_iter))]

    @staticmethod
    @torch.no_grad()
    def ema_update(ema_params, params, decay):
        """ema = ema * decay + params * (1 - decay), in place, leaf by leaf
        of two trees of one structure."""
        def upd(e, p):
            e.copy_(e * decay + p.to(e.dtype) * (1 - decay))
        _zip_leaves(ema_params, params, upd)

    # ---- checkpoint io --------------------------------------------------
    def save_network(self, param_trees, net_label, current_iter,
                     param_key='params'):
        """Port trees (one or a list) into models/net_<label>_<iter>.npz,
        in the JAX package's layout; ``current_iter`` -1 writes 'latest'.
        Rank 0 writes (every rank holds the same parameters); the others
        return None."""
        if not is_main_process():
            return None
        if current_iter == -1:
            current_iter = 'latest'
        path = osp.join(self.opt['path']['models'],
                        f'net_{net_label}_{current_iter}.npz')
        trees = param_trees if isinstance(param_trees, (list, tuple)) \
            else [param_trees]
        keys = param_key if isinstance(param_key, (list, tuple)) \
            else [param_key]
        if len(trees) != len(keys):
            raise ValueError('one param_key per tree')
        save_npz_params(path, {k: to_jax_params(t, self.cfg)
                               for k, t in zip(keys, trees)})
        return path

    def load_network(self, load_path, param_key='params', strict=True):
        """A port tree (fp32 CPU tensors) from a .npz of either package or a
        reference .pth."""
        try:
            if str(load_path).endswith('.npz'):
                return from_jax_params(load_npz_params(load_path, param_key),
                                       self.cfg)
            return load_tsn_state_dict(load_path, self.cfg, param_key)
        except KeyError:
            if strict:
                raise
            return load_tsn_state_dict(load_path, self.cfg, None)

    def save_training_state(self, epoch, current_iter, opt_state=None,
                            extra=None):
        """training_states/<iter>.state: epoch, iteration, the optimizer
        state and ``extra`` (a dict of more training state, {} by
        default); nothing for iteration -1, and nothing on ranks other
        than 0."""
        if current_iter == -1 or not is_main_process():
            return None
        path = osp.join(self.opt['path']['training_states'],
                        f'{current_iter}.state')
        save_training_state(path, {'epoch': epoch, 'iter': current_iter,
                                   'opt_state': opt_state,
                                   'extra': extra or {}})
        return path

    def resume_training(self, resume_state):
        """Restore the optimizer state. Schedules are functions of the
        optimizer's count, which the state carries."""
        if resume_state.get('opt_state') is not None:
            self.optimizer.load_state_dict(resume_state['opt_state'])


def latest_resume_state(state_dir):
    """The highest-iteration .state file of a directory, or None."""
    if not osp.isdir(state_dir):
        return None
    iters = sorted(int(float(f[:-len('.state')])) for f in os.listdir(
        state_dir) if f.endswith('.state'))
    return osp.join(state_dir, f'{iters[-1]}.state') if iters else None

