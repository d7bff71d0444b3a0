"""The train data (counterpart of bsvd_tpu/data/video_train_loader.py):
``train_video_loader`` over folders of frames, its batch (normalize +
random augment + Gaussian noise synthesis), and a seeded synthetic clip
source for tests.

The loader draws from numpy Generators in the JAX package's order: one
seed per worker thread from the loader's Generator; in each worker the
clip, the window's start, then its row and column; in the main thread
the augmentation and the noise. With ``num_workers: 1`` and the same
``manual_seed`` its batches equal the JAX package's bit for bit; with
more workers the order of the windows follows the threads' timing, in
both packages.

Across ranks (``num_devices`` > 1, this loader's ``rank``) the global
batch is ``batch_size_per_gpu * num_devices`` clips and a rank returns its
rows ``[rank * b, (rank + 1) * b)``. Every rank makes every window draw of
the global stream and decodes only its own: a worker's j-th window is
slot ``j * num_workers + worker`` of that stream, so the ranks split the
slots between them. With one worker a rank also makes the augmentation
and noise draws of the whole global batch and keeps its rows, so its
batch is those rows of the JAX package's batch, bit for bit; that costs
every rank the noise of ``num_devices`` batches. With more workers, where
the windows' order follows the threads' timing anyway, a rank draws the
augmentation and noise of its own rows only, from a stream of its own
(seeded from ``manual_seed`` and the rank).

Frames are read by their file type (``data/utils_common.route``): PNG
through the port's zlib reader, JPEG through the native decoder. mp4 clips
(``.mp4`` / ``.m4v`` / ``.mov``, H.264 4:2:0 8-bit) are demuxed by the
port's own reader (``data/mp4_demux``), decoded on the card's NVDEC
(``data/nvdec``: one decoder per worker thread and clip, as the JAX
package keeps a ``VideoCapture``), and their NV12 frames stay on the card
until the window is drawn; the kernel ``csrc/nv12_rgb.cu``
(``data/yuv``) converts only the window, as cv2's swscale would, and
the window reaches the queue as the frame route gives it, (T, 3, ch, cw)
uint8 on the host. A video window draws its clip and start, is decoded,
then draws its row and column, the JAX package's order for video. An mp4
on a CPU device raises NotImplementedError naming NVDEC; ``.avi`` /
``.mkv`` / ``.webm`` raise NotImplementedError naming the container.
"""

import os
import queue
import threading

import numpy as np
import torch

from bsvd_tpu_torch.data import mp4_demux, nvdec, utils_common, yuv
from bsvd_tpu_torch.data.utils_common import get_imagenames
from bsvd_tpu_torch.utils.logger import get_root_logger
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY

# undecodable windows a worker draws in a row before it gives up
MAX_REDRAWS = 1000


class _ClipIndex:
    """The frame folders and mp4 clips under ``root`` and their frame
    counts; mp4 clips decode on ``device``."""

    def __init__(self, root, device='cuda'):
        self.entries = []   # (path, kind 'frames' | 'video', num_frames)
        self._tracks = {}   # path -> mp4_demux.Track
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if os.path.isdir(path):
                frames = get_imagenames(path)
                if frames:
                    self.entries.append((path, 'frames', len(frames)))
            elif name.lower().endswith(mp4_demux.VIDEO_EXTS):
                track = mp4_demux.open_track(path)
                # the count cv2.CAP_PROP_FRAME_COUNT gives, as JAX draws
                if track.frame_count > 0:
                    self._tracks[path] = track
                    self.entries.append((path, 'video', track.frame_count))
        if not self.entries:
            raise IOError(f'no video files or frame folders under {root}')
        self.device = nvdec.require(device) if self._tracks else None
        self._dims = {}                  # path -> (H, W)
        self._lock = threading.Lock()
        self._tls = threading.local()    # a worker's decoders and stream

    def _frame_dims(self, path, files):
        """Cached (H, W) of a frame folder (one header probe per clip)."""
        with self._lock:
            dims = self._dims.get(path)
        if dims is None:
            dims = utils_common.image_dims(files[0])
            with self._lock:
                self._dims[path] = dims
        return dims

    def holds(self, i, seq_len, crop_hw):
        """Whether clip ``i`` has ``seq_len`` frames of at least
        ``crop_hw`` (False where its first frame cannot be read)."""
        path, kind, n = self.entries[i]
        if n < seq_len:
            return False
        if kind == 'video':
            h, w = self._tracks[path].hw
            return h >= crop_hw[0] and w >= crop_hw[1]
        try:
            h, w = self._frame_dims(path, get_imagenames(path))
        except NotImplementedError:      # a frame not read yet: tell
            raise
        except IOError:
            return False
        return h >= crop_hw[0] and w >= crop_hw[1]

    def sample(self, rng, seq_len, crop_hw, decode=True):
        """A random window -> (T, ch, cw, 3) uint8 RGB (None without
        ``decode``: the draws only); IOError where it cannot be read (a
        short clip, a corrupt frame)."""
        path, kind, n = self.entries[rng.integers(len(self.entries))]
        if n < seq_len:
            raise IOError(f'clip {path} shorter ({n}) than temp_patch_size '
                          f'{seq_len}')
        start = int(rng.integers(0, n - seq_len + 1))
        ch, cw = crop_hw
        if kind == 'video':
            return self._video_window(rng, path, start, seq_len, crop_hw,
                                      decode)
        files = get_imagenames(path)[start:start + seq_len]
        h, w = self._frame_dims(path, files)
        if h < ch or w < cw:
            raise IOError(f'clip {path} smaller than crop {crop_hw}')
        # one window position for every frame of the clip
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        if not decode:
            return None
        return utils_common.load_crop_seq(files, y0, x0, ch, cw)

    def _video_window(self, rng, path, start, seq_len, crop_hw, decode):
        """An mp4 window: decoded before its row and column are drawn, as
        the JAX package draws (a window that fails to decode draws
        neither)."""
        track = self._tracks[path]
        ch, cw = crop_hw
        with torch.cuda.stream(self._stream()):
            if decode:
                frames = self._decoder(path).decode(track, start, seq_len)
            else:           # the frames every rank can tell are missing
                track.window_samples(start, seq_len)
            h, w = track.hw
            if h < ch or w < cw:
                raise IOError(f'clip {path} smaller than crop {crop_hw}')
            y0 = int(rng.integers(0, h - ch + 1))
            x0 = int(rng.integers(0, w - cw + 1))
            if not decode:
                return None
            return yuv.nv12_to_rgb(frames, y0, x0, ch, cw).cpu().numpy()

    def _decoder(self, path):
        """This thread's decoder of clip ``path``, kept alive."""
        decoders = getattr(self._tls, 'decoders', None)
        if decoders is None:
            decoders = self._tls.decoders = {}
        if path not in decoders:
            decoders[path] = nvdec.Decoder(self.device)
        return decoders[path]

    def _stream(self):
        """This thread's CUDA stream (its decodes and conversions)."""
        stream = getattr(self._tls, 'stream', None)
        if stream is None:
            stream = self._tls.stream = torch.cuda.Stream(self.device)
        return stream

    def release(self):
        """Close the calling thread's decoders."""
        for dec in getattr(self._tls, 'decoders', {}).values():
            dec.close()
        self._tls.decoders = {}


def normalize_augment(batch, rng, total=None):
    """uint8 [0, 255] (N, F, C, H, W) -> [0, 1] fp32, then one random
    transform for the whole batch (weights 32 : 12 x 8 over do-nothing,
    flips / rotations and a per-sample constant offset). Returns the
    augmented clip twice (input and target), as the JAX package does.
    ``total`` (start, size): as for ``noisy_batch``."""
    x = batch.astype(np.float32) / 255.0
    n, f, c, h, w = x.shape
    start, size = total or (0, n)
    x = x.reshape(n, f * c, h, w)
    choice = rng.choice(9, p=np.array([32, 12, 12, 12, 12, 12, 12, 12, 12],
                                      np.float64) / 128.0)
    if choice == 8:
        x = x + rng.normal(0.0, 5 / 255., (size, 1, 1, 1)).astype(
            np.float32)[start:start + n]
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


def noisy_batch(batch, rng, noise_ival, noise_shape='NF', blind=False,
                total=None):
    """One train batch from uint8 clips (N, F, 3, H, W): ``gt`` the
    augmented clip, ``lq`` plus Gaussian noise of sigma ~ U[noise_ival]/255
    per clip ('N') or per frame ('NF'), ``noise_map`` that sigma (dropped
    for blind nets). ``total`` (start, size): ``batch`` is rows start..
    start + N - 1 of a batch of ``size`` clips, every draw made for all
    of them (a rank's share of the global batch)."""
    img_train, gt_train = normalize_augment(batch, rng, total)
    n, f, c, h, w = img_train.shape
    start, size = total or (0, n)
    lo, hi = noise_ival
    shape = (size, f, 1, 1, 1) if noise_shape == 'NF' else (size, 1, 1, 1, 1)
    stdn = rng.uniform(lo / 255., hi / 255., shape).astype(
        np.float32)[start:start + n]
    noise = rng.normal(0.0, 1.0, (size,) + img_train.shape[1:]).astype(
        np.float32)[start:start + n] * stdn
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
    """Train batches from seeded synthetic clips through ``noisy_batch``
    (for tests and the card's smoke run):
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


@DATASET_REGISTRY.register()
class train_video_loader:
    """Self-iterating train loader over folders of frames (the loader is the
    dataset, as the reference's DALI object is).

    opt keys (the reference's): trainset_dir, batch_size_per_gpu,
    temp_patch_size, patch_size, max_number_patches, noise_ival,
    noise_shape ('N' | 'NF'), blind, prefetch_size; the JAX package's:
    num_workers, manual_seed, num_devices (the ranks: the global batch is
    ``batch_size_per_gpu * num_devices`` clips); the port's: rank (whose
    rows of the global batch this loader returns, default 0).

    Worker threads decode random windows into a bounded queue; ``__next__``
    stacks ``batch_size_per_gpu`` of them and makes the batch with
    ``noisy_batch``. An epoch is ``max_number_patches`` windows, in global
    batches (ceil). ``close()`` stops the workers.

    A window that cannot be read (a corrupt frame, a clip shorter than
    ``temp_patch_size`` or smaller than ``patch_size``) is redrawn, as the
    JAX package's worker does; ``skipped`` counts them and each reason is
    logged once. ``MAX_REDRAWS`` of them in a row, or a frame of a kind
    not read yet (an Adam7 PNG), raise in ``__next__``.
    """

    def __init__(self, opt):
        self.opt = dict(opt)
        self.opt.setdefault('noise_shape', 'NF')
        self.num_devices = int(opt.get('num_devices', 1))
        self.rank = int(opt.get('rank', 0))
        if not 0 <= self.rank < self.num_devices:
            raise ValueError(f'train_video_loader: rank {self.rank} of '
                             f'num_devices {self.num_devices}')
        self.batch_size = int(opt['batch_size_per_gpu'])
        self.global_batch = self.batch_size * self.num_devices
        self.seq_len = int(opt['temp_patch_size'])
        ps = opt['patch_size']
        self.crop_hw = (ps[0], ps[1]) if isinstance(ps, (list, tuple)) \
            else (ps, ps)
        self.index = _ClipIndex(opt['trainset_dir'],
                                opt.get('device', 'cuda'))
        if not any(self.index.holds(i, self.seq_len, self.crop_hw)
                   for i in range(len(self.index.entries))):
            raise IOError(f"no clip under {opt['trainset_dir']} has "
                          f'temp_patch_size {self.seq_len} frames of at '
                          f'least patch_size {self.crop_hw}')
        patches = int(opt.get('max_number_patches', -1))
        if patches <= 0:
            total = sum(n for _, _, n in self.index.entries)
            patches = max(total // self.seq_len, 1)
        self.epoch_size = max(-(-patches // self.global_batch), 1)

        self.rng = np.random.default_rng(opt.get('manual_seed', 12))
        self._num_workers = int(opt.get('num_workers',
                                        min(8, os.cpu_count() or 4)))
        self._queue = queue.Queue(maxsize=int(opt.get('prefetch_size', 16)))
        self._stop = threading.Event()
        self._emitted = 0
        self.skipped = 0                 # undecodable windows redrawn
        self._skip_lock, self._skip_reasons = threading.Lock(), set()
        self._workers = []
        for wid in range(self._num_workers):
            seed = int(self.rng.integers(2**63))
            t = threading.Thread(target=self._worker, args=(seed, wid),
                                 daemon=True)
            t.start()
            self._workers.append(t)
        # the augmentation and noise draws (module docstring)
        if self.num_devices > 1 and self._num_workers > 1:
            self._batch_rng = np.random.default_rng(
                [int(self.rng.integers(2**63)), self.rank])
            self._rows = None
        else:
            self._batch_rng = self.rng
            self._rows = (self.rank * self.batch_size, self.global_batch)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self, seed, wid):
        try:
            self._draw_windows(seed, wid)
        finally:
            self.index.release()         # this thread's decoders

    def _draw_windows(self, seed, wid):
        rng = np.random.default_rng(seed)
        in_a_row = 0
        slot = wid               # of the global stream of windows
        while not self._stop.is_set():
            mine = (slot % self.global_batch) // self.batch_size == self.rank
            try:
                if mine:
                    window = self.index.sample(rng, self.seq_len,
                                               self.crop_hw)
                else:       # another rank's window: the draws only
                    self.index.sample(rng, self.seq_len, self.crop_hw,
                                      decode=False)
            except NotImplementedError as e:   # a frame not read yet
                self._put(e)
                return
            except IOError as e:
                # an undecodable window (corrupt frame, short clip): draw
                # another, up to MAX_REDRAWS in a row
                in_a_row += 1
                self._skip(e)
                if in_a_row >= MAX_REDRAWS:
                    self._put(IOError(f'{in_a_row} windows in a row could '
                                      f'not be read; the last: {e}'))
                    return
                continue
            except Exception as e:         # hand the fault to __next__
                self._put(e)
                return
            in_a_row = 0
            slot += self._num_workers
            if mine:
                # (T, H, W, 3) -> (T, 3, H, W)
                self._put(np.transpose(window, (0, 3, 1, 2)))

    def _skip(self, err):
        """Count a redrawn window; log each reason once."""
        with self._skip_lock:
            self.skipped += 1
            new = str(err) not in self._skip_reasons
            self._skip_reasons.add(str(err))
        if new:
            get_root_logger().warning(f'train_video_loader: windows skipped '
                                      f'and redrawn: {err}')

    def close(self):
        """Stop the worker threads (each ends within its current window)."""
        self._stop.set()
        for t in self._workers:
            t.join(timeout=10)

    def __len__(self):
        return self.epoch_size

    def __iter__(self):
        self._emitted = 0
        return self

    def __next__(self):
        if self._emitted >= self.epoch_size:
            raise StopIteration
        self._emitted += 1
        samples = []
        for _ in range(self.batch_size):
            item = self._queue.get()
            if isinstance(item, Exception):
                raise RuntimeError('train_video_loader: a worker failed') \
                    from item
            samples.append(item)
        return noisy_batch(np.stack(samples), self._batch_rng,
                           self.opt['noise_ival'], self.opt['noise_shape'],
                           self.opt.get('blind', False), self._rows)


@DATASET_REGISTRY.register()
class train_dali_loader(train_video_loader):
    """The reference's name for the train loader (its DALI loader)."""
