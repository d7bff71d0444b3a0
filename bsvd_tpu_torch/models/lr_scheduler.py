"""Learning-rate schedules as plain functions of the step (counterpart of
bsvd_tpu/models/lr_scheduler.py). Each returns an fp32 numpy scalar
computed with the JAX package's fp32 operations, in the same order, so the
two agree exactly.

The optimizer evaluates the schedule at its own update count (0 on the
first update), as optax's scale_by_learning_rate does, not at the train
loop's iteration.
"""

import numpy as np

_F = np.float32


def multi_step_restart_lr(base_lr, milestones, gamma=0.1, restarts=(0,),
                          restart_weights=(1,)):
    """lr = base * weight_at_restart * gamma^(#milestones passed since the
    restart); with the single restart at 0 this is torch MultiStepLR."""
    milestones = np.asarray(sorted(int(m) for m in milestones), np.int64)
    restarts = np.asarray(sorted(int(r) for r in restarts), np.int64)
    weights = np.asarray(restart_weights, _F)
    if len(restarts) != len(weights):
        raise ValueError('restarts and restart_weights differ in length')

    def schedule(step):
        r_idx = int(np.clip(np.searchsorted(restarts, step, side='right') - 1,
                            0, len(restarts) - 1))
        n_passed = int(np.sum((milestones > restarts[r_idx])
                              & (milestones <= step)))
        return _F(base_lr) * weights[r_idx] * np.power(_F(gamma),
                                                       _F(n_passed))

    return schedule


def cosine_annealing_restart_lr(base_lr, periods, restart_weights=(1,),
                                eta_min=0):
    """Cosine annealing with restarts; a step on a period boundary still
    belongs to the period that ends there."""
    periods = [int(p) for p in periods]
    if len(periods) != len(restart_weights):
        raise ValueError('periods and restart_weights differ in length')
    cum = np.cumsum([0] + periods)
    weights = np.asarray(restart_weights, _F)
    periods_f = np.asarray(periods, _F)

    def schedule(step):
        step = _F(step)
        idx = int(np.clip(np.searchsorted(cum[1:], step, side='left'), 0,
                          len(periods) - 1))
        frac = np.clip((step - _F(cum[idx])) / max(periods_f[idx], _F(1)),
                       _F(0), _F(1))
        return (_F(eta_min) + weights[idx] * _F(0.5) * _F(base_lr - eta_min)
                * (_F(1) + _F(np.cos(np.float64(_F(np.pi) * frac)))))

    return schedule


def with_warmup(schedule, warmup_iter=-1):
    """Linear warmup from 0 over ``warmup_iter`` steps."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def warmed(step):
        factor = np.clip(_F(step) / _F(warmup_iter), _F(0), _F(1))
        return schedule(step) * factor

    return warmed


def build_schedule(train_opt):
    """The schedule of an options ``train`` block (optim_g.lr +
    scheduler{type, ...} + warmup_iter)."""
    base_lr = float(train_opt['optim_g']['lr'])
    sch = dict(train_opt.get('scheduler') or {})
    sch_type = sch.pop('type', 'constant') if sch else 'constant'
    if sch_type in ('MultiStepLR', 'MultiStepRestartLR'):
        schedule = multi_step_restart_lr(
            base_lr, sch.get('milestones', []), sch.get('gamma', 0.1),
            sch.get('restarts', (0,)), sch.get('restart_weights', (1,)))
    elif sch_type == 'CosineAnnealingRestartLR':
        schedule = cosine_annealing_restart_lr(
            base_lr, sch['periods'], sch.get('restart_weights', (1,)),
            sch.get('eta_min', 0))
    elif sch_type == 'constant':
        def schedule(step):
            return _F(base_lr)
    else:
        raise NotImplementedError(f'scheduler {sch_type!r}')
    return with_warmup(schedule, train_opt.get('warmup_iter', -1))
