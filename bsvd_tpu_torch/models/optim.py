"""Adam / AdamW as optax computes them (counterpart of the optimizer that
bsvd_tpu/models/denoising_model.py ``_build_optimizer`` chains), written
out rather than taken from ``torch.optim``: optax adds eps outside the
square root of the bias-corrected second moment, evaluates the schedule at
its own update count (0 on the first update), decays AdamW's weights
before the learning-rate scale, and clips by ``g * max_norm / norm`` with
no epsilon, each a small step away from torch.optim's and
``clip_grad_norm_``'s.

Every operation is fp32, one tensor op per optax op in optax's order, and
the moments live on the parameters' device. Nothing reads a value back to
the host: the clip's branch is a ``torch.where``.
"""

import numpy as np
import torch


class Adam:
    """Updates ``params`` (named tensors) from their ``.grad``.

    optax.chain(clip_by_global_norm(max_grad_norm)?, adam(schedule, b1, b2,
    eps)) when ``weight_decay`` is 0, and with adamw's
    add_decayed_weights(weight_decay) between the Adam scale and the
    learning rate otherwise."""

    def __init__(self, named_params, schedule, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, max_grad_norm=None):
        self.names, self.params = zip(*named_params)
        self.schedule = schedule
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay or 0.0)
        self.max_grad_norm = (None if max_grad_norm is None
                              else float(max_grad_norm))
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _grads(self):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / norm) * self.max_grad_norm)
                     for g in grads]
        return grads

    @torch.no_grad()
    def step(self):
        grads = self._grads()
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        step_size = float(-np.float32(lr))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.copy_(p + step_size * u)

    def state_dict(self):
        return {'count': self.count,
                'mu': dict(zip(self.names, self.mu)),
                'nu': dict(zip(self.names, self.nu))}

    def load_state_dict(self, state):
        if set(state['mu']) != set(self.names):
            raise KeyError('optimizer state does not match the parameters: '
                           f'{sorted(set(state["mu"]) ^ set(self.names))[:4]}')
        self.count = int(state['count'])
        for name, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state['mu'][name])
            v.copy_(state['nu'][name])
