"""Operation counts of the port's convolutions, for ``profiler.
flops_and_memory`` (counterpart of the FLOPs in XLA's cost analysis, which
the JAX package reads).

A convolution counts 2 * Cin * Cout for every kernel tap that lands inside
the unpadded input, summed over the output pixels: taps on the zero
padding do no work, as XLA counts them. Each op wrapper of ``ops/`` (K1-K7)
adds its count where it computes, on the kernel route and on the plain
route alike, from one formula; its plain route runs under ``hidden()`` so
that ``profiler``'s TorchFunctionMode does not count the plain version's
``F.conv2d`` a second time. Nothing is counted unless a ``Count`` is
active in the thread (``counting``)."""

import contextlib
import threading

_tls = threading.local()


class Count:
    """FLOPs added while it is active."""

    def __init__(self):
        self.flops = 0


def _state():
    st = getattr(_tls, 'st', None)
    if st is None:
        st = _tls.st = _State()
    return st


class _State:
    def __init__(self):
        self.counts = []
        self.hidden = 0


@contextlib.contextmanager
def counting():
    """Activate a new ``Count`` in this thread; yields it."""
    st, c = _state(), Count()
    st.counts.append(c)
    try:
        yield c
    finally:
        st.counts.remove(c)


def is_hidden():
    """Whether an op wrapper's plain route is running in this thread."""
    return _state().hidden > 0


@contextlib.contextmanager
def hidden():
    """The plain route of an op wrapper: torch calls inside are part of an
    op already counted."""
    st = _state()
    st.hidden += 1
    try:
        yield
    finally:
        st.hidden -= 1


def add(flops):
    """Add ``flops`` to every active count of this thread."""
    for c in _state().counts:
        c.flops += flops


def valid_taps(n_in, n_out, k, stride=1, pad=1, dilation=1):
    """Kernel taps along one axis that land inside the unpadded input,
    summed over the ``n_out`` outputs (output o, tap t reads input o *
    stride + t * dilation - pad)."""
    total = 0
    for t in range(k):
        off = t * dilation - pad
        lo = max(0, -(off // stride))
        hi = min(n_out - 1, (n_in - 1 - off) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv3x3_flops(n, h, w, cin, cout, stride=1):
    """FLOPs of a 3x3 conv (torch padding 1) over n frames of h x w."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return (2 * n * cin * cout * valid_taps(h, ho, 3, stride)
            * valid_taps(w, wo, 3, stride))


def conv3x3(n, h, w, cin, cout, stride=1):
    """Count one 3x3 conv where a count is active (and no plain route is
    running: its convs belong to the op that counted them)."""
    st = _state()
    if st.counts and not st.hidden:
        add(conv3x3_flops(n, h, w, cin, cout, stride))
