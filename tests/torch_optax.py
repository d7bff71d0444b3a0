"""Hold a port model's optimizer steps against the JAX model's.

A GAN step of the port and of the JAX package cannot be held parameter
by parameter after Adam's first step: that step moves each element by lr
x g / (|g| + eps), so where the true gradient is 0 or nearly (a conv bias
before instance norm) fp32 rounding decides the sign of a whole step.
The model tests therefore split each step in two, each checked tightly:

- ``grads_close``: the port's gradients against the JAX step's, read off
  its Adam moments (``jax_grads``: mu = (1 - b1) g + b1 mu_before);
- ``step_matches_optax``: the port's update (parameters and moments
  after it) against the JAX model's own optax transform run on the
  port's recorded gradients, parameters, moments and count.

``recording`` wraps a port ``Adam`` so that each ``step`` first records
those inputs.
"""

import numpy as np
import torch


def recording(optim):
    """Wrap ``optim.step``; returns the list that each step appends its
    record to: ``count``, ``grads``, ``params``, ``mu``, ``nu`` (name ->
    tensor, as they were before the step)."""
    records, step = [], optim.step

    def record():
        st = optim.state_dict()
        records.append({
            'count': st['count'],
            'grads': {n: torch.zeros_like(p) if p.grad is None
                      else p.grad.detach().clone()
                      for n, p in zip(optim.names, optim.params)},
            'params': {n: p.detach().clone()
                       for n, p in zip(optim.names, optim.params)},
            'mu': {n: m.clone() for n, m in st['mu'].items()},
            'nu': {n: v.clone() for n, v in st['nu'].items()}})
        step()
    optim.step = record
    return records


def adam_state(opt_state):
    """The ``ScaleByAdamState`` of an optax state."""
    if hasattr(opt_state, 'mu'):
        return opt_state
    for s in opt_state:
        if isinstance(s, tuple):
            found = adam_state(s)
            if found is not None:
                return found
    return None


def jax_grads(before, after, b1):
    """The gradient of the JAX step between two optax states (numpy
    copies): (mu_after - b1 mu_before) / (1 - b1), as a tree."""
    import jax
    return jax.tree.map(lambda a, b: (np.asarray(a, np.float64)
                                      - b1 * np.asarray(b, np.float64))
                        / (1 - b1),
                        adam_state(after).mu, adam_state(before).mu)


def grads_close(grads, want, tol, floor):
    """Each recorded gradient against ``want`` (tensors or arrays by the
    same names): within tol x its own max|ref| + floor x the net's largest
    |ref| (the floor covers tensors whose true gradient is 0)."""
    want = {n: np.asarray(want[n], np.float64) for n in grads}
    g_max = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for n, g in grads.items():
        ref = want[n]
        err = float(np.abs(g.numpy() - ref).max())
        bound = tol * float(np.abs(ref).max()) + floor * g_max
        assert err <= bound, (n, err, bound)
        worst = max(worst, err / bound)
    return worst


def _filled(state, count, mu, nu):
    import jax.numpy as jnp
    if hasattr(state, '_fields'):
        kw = {}
        if 'count' in state._fields:
            kw['count'] = jnp.asarray(count, state.count.dtype)
        if 'mu' in state._fields:
            kw.update(mu=mu, nu=nu)
        return state._replace(**kw)
    if isinstance(state, tuple):
        return tuple(_filled(s, count, mu, nu) for s in state)
    return state


def step_matches_optax(tx, rec, optim, tol=1e-6):
    """The port's parameters and Adam moments after the step recorded in
    ``rec`` against ``tx`` (the JAX model's optax transform) applied to
    the same gradients, parameters, moments and count: each tensor
    within tol x its max|ref| (fp32 rounding)."""
    import jax.numpy as jnp
    import optax

    def tree(d):
        return {n: jnp.asarray(v.numpy()) for n, v in d.items()}
    params = tree(rec['params'])
    state = _filled(tx.init(params), rec['count'], tree(rec['mu']),
                    tree(rec['nu']))
    updates, new = tx.update(tree(rec['grads']), state, params)
    want = optax.apply_updates(params, updates)
    adam = adam_state(new)
    st = optim.state_dict()
    assert st['count'] == rec['count'] + 1
    for n, p in zip(optim.names, optim.params):
        for what, got, ref in (('param', p.detach(), want[n]),
                               ('mu', st['mu'][n], adam.mu[n]),
                               ('nu', st['nu'][n], adam.nu[n])):
            ref = np.asarray(ref, np.float64)
            err = float(np.abs(got.numpy() - ref).max())
            assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
                (what, n, err, float(np.abs(ref).max()))
