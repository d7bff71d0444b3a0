"""The train batch: normalize + random augment + Gaussian noise synthesis
(counterpart of bsvd_tpu/data/video_train_loader.py ``normalize_augment``
and ``train_video_loader.__next__``), pure numpy. Both draw from the
numpy Generator in the same order as the JAX package's loader, so the same
Generator state and uint8 clips give bit-equal batches.

Decoding clips from video files or frame folders is not ported (it needs
cv2, which the card's machine lacks); ``SyntheticVideoLoader`` makes
seeded uint8 clips instead, and the train loop takes any iterable of
batches.
"""

import numpy as np


def normalize_augment(batch, rng):
    """uint8 [0, 255] (N, F, C, H, W) -> [0, 1] fp32, then one random
    transform for the whole batch (weights 32 : 12 x 8 over do-nothing,
    flips / rotations and a per-sample constant offset). Returns the
    augmented clip twice (input and target), as the JAX package does."""
    x = batch.astype(np.float32) / 255.0
    n, f, c, h, w = x.shape
    x = x.reshape(n, f * c, h, w)
    choice = rng.choice(9, p=np.array([32, 12, 12, 12, 12, 12, 12, 12, 12],
                                      np.float64) / 128.0)
    if choice == 8:
        x = x + rng.normal(0.0, 5 / 255., (n, 1, 1, 1)).astype(np.float32)
    elif choice:
        # 1 flipud, 2 rot90, 3 rot90+flip, 4 rot180, 5 rot180+flip,
        # 6 rot270, 7 rot270+flip
        k, flip = {1: (0, True), 2: (1, False), 3: (1, True), 4: (2, False),
                   5: (2, True), 6: (3, False), 7: (3, True)}[choice]
        if k:
            x = np.rot90(x, k=k, axes=(2, 3))
        if flip:
            x = np.flip(x, axis=2)
    # a quarter turn swaps H and W: reshape with the dims x has now
    x = np.ascontiguousarray(x).reshape(n, f, c, *x.shape[-2:])
    return x, x


def noisy_batch(batch, rng, noise_ival, noise_shape='NF', blind=False):
    """One train batch from uint8 clips (N, F, 3, H, W): ``gt`` the
    augmented clip, ``lq`` plus Gaussian noise of sigma ~ U[noise_ival]/255
    per clip ('N') or per frame ('NF'), ``noise_map`` that sigma (dropped
    for blind nets)."""
    img_train, gt_train = normalize_augment(batch, rng)
    n, f, c, h, w = img_train.shape
    lo, hi = noise_ival
    shape = (n, f, 1, 1, 1) if noise_shape == 'NF' else (n, 1, 1, 1, 1)
    stdn = rng.uniform(lo / 255., hi / 255., shape).astype(np.float32)
    noise = rng.normal(0.0, 1.0, img_train.shape).astype(np.float32) * stdn
    out = {'gt': gt_train, 'lq': img_train + noise,
           'noise_map': np.broadcast_to(stdn, (n, f, 1, h, w)).astype(
               np.float32)}
    if blind:
        out.pop('noise_map')
    return out


def synthetic_clips(rng, n, t, h, w):
    """``n`` uint8 clips (n, t, 3, h, w): smooth colour waves drifting over
    time plus fine texture, drawn from ``rng``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, t, 3, h, w), np.uint8)
    for i in range(n):
        freq = rng.uniform(0.02, 0.2, size=(3, 2)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
        drift = rng.uniform(-0.3, 0.3, size=(3, 2)).astype(np.float32)
        texture = rng.uniform(-20, 20, size=(3, h, w)).astype(np.float32)
        for k in range(t):
            for c in range(3):
                wave = np.sin(freq[c, 0] * (yy + drift[c, 0] * k)
                              + freq[c, 1] * (xx + drift[c, 1] * k)
                              + phase[c])
                out[i, k, c] = np.clip(128 + 90 * wave + texture[c], 0, 255)
    return out


class SyntheticVideoLoader:
    """Train batches from seeded synthetic clips through ``noisy_batch``:
    an iterable of ``epoch_size`` batches per epoch, with the reference
    loader's option names (batch_size_per_gpu, temp_patch_size,
    patch_size, noise_ival, noise_shape, blind, manual_seed)."""

    def __init__(self, opt, epoch_size=100):
        self.opt = dict(opt)
        self.batch_size = int(opt['batch_size_per_gpu'])
        self.seq_len = int(opt['temp_patch_size'])
        ps = opt['patch_size']
        self.crop_hw = tuple(ps) if isinstance(ps, (list, tuple)) else (ps,
                                                                         ps)
        self.epoch_size = epoch_size
        self.rng = np.random.default_rng(opt.get('manual_seed', 12))

    def __len__(self):
        return self.epoch_size

    def __iter__(self):
        for _ in range(self.epoch_size):
            yield self.next_batch()

    def next_batch(self):
        clips = synthetic_clips(self.rng, self.batch_size, self.seq_len,
                                *self.crop_hw)
        return noisy_batch(clips, self.rng, self.opt['noise_ival'],
                           self.opt.get('noise_shape', 'NF'),
                           self.opt.get('blind', False))
