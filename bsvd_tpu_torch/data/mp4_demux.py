"""The mp4 (ISO base media) reader of the train loader's video clips: the
port's own, standard library and numpy only (the JAX package opens the
same files with cv2's FFmpeg demuxer, bsvd_tpu/data/video_train_loader.py
:50-55, :114-127).

``open_track(path)`` reads ``ftyp`` and ``moov`` (the first video track:
``tkhd``, ``edts/elst``, ``mdia/mdhd``, ``hdlr``, ``minf/stbl``: ``stsd``
with ``avc1`` / ``avc3`` and its ``avcC``, ``stts``, ``ctts``, ``stss``,
``stsc``, ``stsz``, ``stco`` / ``co64``) and gives a ``Track``:

- the samples in decode order: file offset, size, composition time, sync
  flag;
- the display order after the edit list, as FFmpeg's mov demuxer applies
  it: the samples sorted by composition time, kept where that time lies in
  the first non-empty edit ``[media_time, media_time + duration)``;
- ``frame_count``: what ``cv2.CAP_PROP_FRAME_COUNT`` gives for the file
  (FFmpeg's ``nb_frames``: the samples ``stts`` counts, whatever the edit
  list keeps);
- the SPS / PPS of ``avcC`` and, through the SPS (``h264_headers``), the
  displayed size;
- ``window(start, count)``: the access units NVDEC needs for display
  frames ``start .. start + count - 1``, from the last sync sample at or
  before ``start``, as Annex-B (each NAL unit after a start code instead
  of its ``lengthSizeMinusOne + 1``-byte length, the SPS and PPS before
  each sync sample).

Unreadable or inconsistent files raise IOError naming the file. Valid
files of a kind not read here raise NotImplementedError naming the box
or the codec: fragmented files (``moof`` / ``mvex``), a video track in
another codec (``hvc1``, ``av01``, ...), more than one non-empty edit,
compact sample sizes (``stz2``).
"""

import os
import struct

import numpy as np

from bsvd_tpu_torch.data import h264_headers

# the containers of the JAX package's _VIDEO_EXTS: those read here, and
# those that raise NotImplementedError naming the container
ISO_EXTS = ('.mp4', '.m4v', '.mov')
OTHER_CONTAINERS = {'.avi': 'AVI', '.mkv': 'Matroska', '.webm': 'WebM'}
VIDEO_EXTS = ISO_EXTS + tuple(OTHER_CONTAINERS)
START_CODE = b'\x00\x00\x00\x01'


def check_container(path):
    """Raise NotImplementedError for a video file in a container the port
    does not read (``.avi``, ``.mkv``, ``.webm``)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in OTHER_CONTAINERS:
        raise NotImplementedError(
            f'{path}: {OTHER_CONTAINERS[ext]} ({ext}) video is not read by '
            f'the port (mp4 / m4v / mov only; ROADMAP Queue 1)')


def _boxes(data, path, start=0, end=None):
    """(type, payload start, payload end) of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack_from('>I4s', data, at)
        head = 8
        if size == 1:
            if at + 16 > end:
                raise IOError(f'{path}: truncated box header')
            size = struct.unpack_from('>Q', data, at + 8)[0]
            head = 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            raise IOError(f'{path}: box {kind!r} of {size} bytes overruns '
                          f'its parent')
        yield kind, at + head, at + size
        at += size


def _top_level(path):
    """The file's top-level box types and the ``moov`` payload."""
    kinds, moov = [], None
    size = os.path.getsize(path)
    with open(path, 'rb') as f:
        at = 0
        while at + 8 <= size:
            f.seek(at)
            head = f.read(16)
            box_size, kind = struct.unpack_from('>I4s', head)
            hlen = 8
            if box_size == 1:
                box_size = struct.unpack_from('>Q', head, 8)[0]
                hlen = 16
            elif box_size == 0:
                box_size = size - at
            if box_size < hlen or at + box_size > size:
                raise IOError(f'{path}: top-level box {kind!r} of '
                              f'{box_size} bytes overruns the file')
            kinds.append(kind)
            if kind == b'moov':
                f.seek(at + hlen)
                moov = f.read(box_size - hlen)
            at += box_size
    return kinds, moov


def _find(data, path, start, end, *kinds):
    """Payload (start, end) of the first box of each type in ``kinds``,
    nested: _find(d, p, s, e, b'mdia', b'minf') is mdia/minf."""
    for kind in kinds:
        for k, s, e in _boxes(data, path, start, end):
            if k == kind:
                start, end = s, e
                break
        else:
            return None
    return start, end


def _full(data, s):
    """version, flags, payload start of a full box."""
    vf = struct.unpack_from('>I', data, s)[0]
    return vf >> 24, vf & 0xFFFFFF, s + 4


class Track:
    """One H.264 video track of an mp4 file (module docstring)."""

    def __init__(self, path, offsets, sizes, cts, sync, display,
                 frame_count, sps, pps, length_size):
        self.path = path
        self.offsets, self.sizes = offsets, sizes
        self.cts, self.sync = cts, sync
        self.display = display              # decode index per display frame
        self.disp_index = np.full(len(sizes), -1, np.int64)
        self.disp_index[display] = np.arange(len(display))
        self.frame_count = frame_count
        self.sps, self.pps = sps, pps
        self.length_size = length_size
        self.header = h264_headers.parse_sps(sps[0])
        self.hw = self.header['hw']
        self.coded_hw = self.header['coded_hw']
        self.crop = self.header['crop']

    def window_samples(self, start, count):
        """Decode indices from the last sync sample at or before display
        frame ``start`` to the last sample display frames ``start ..
        start + count - 1`` need. IOError where the display order has no
        such frames (a window past the edit list's end: a short read) or
        no sync sample precedes them."""
        if start < 0 or start + count > len(self.display):
            raise IOError(f'decode failed at {self.path}@{start}: '
                          f'{len(self.display)} frames displayed')
        need = self.display[start:start + count]
        first, last = int(need.min()), int(need.max())
        keys = np.nonzero(self.sync[:first + 1] & (
            self.cts[:first + 1] <= self.cts[self.display[start]]))[0]
        if not len(keys):
            raise IOError(f'decode failed at {self.path}@{start}: no sync '
                          f'sample before it')
        return int(keys[-1]), last

    def annexb(self, sample, i):
        """Sample ``i``'s bytes (length-prefixed NAL units) as Annex-B,
        the SPS and PPS before a sync sample."""
        out = bytearray()
        if self.sync[i]:
            for p in self.sps + self.pps:
                out += START_CODE + p
        at, n = 0, self.length_size
        while at < len(sample):
            if at + n > len(sample):
                raise IOError(f'{self.path}: sample {i} truncated')
            size = int.from_bytes(sample[at:at + n], 'big')
            at += n
            if size == 0 or at + size > len(sample):
                raise IOError(f'{self.path}: sample {i} has a NAL unit of '
                              f'{size} bytes past its end')
            out += START_CODE + sample[at:at + size]
            at += size
        return bytes(out)

    def window(self, start, count):
        """The Annex-B access units of display frames ``start .. start +
        count - 1``: (bytes, offsets (n + 1,) int64 into them, display
        index of each (n,) int64, -1 for frames not displayed)."""
        first, last = self.window_samples(start, count)
        units = []
        with open(self.path, 'rb') as f:
            for i in range(first, last + 1):
                f.seek(int(self.offsets[i]))
                data = f.read(int(self.sizes[i]))
                if len(data) != self.sizes[i]:
                    raise IOError(f'{self.path}: sample {i} past the end of '
                                  f'the file')
                units.append(self.annexb(data, i))
        offsets = np.zeros(len(units) + 1, np.int64)
        offsets[1:] = np.cumsum([len(u) for u in units])
        return (b''.join(units), offsets,
                self.disp_index[first:last + 1].copy())


def _sample_table(data, path, s, e):
    """The stbl boxes: (codec, avcC payload, stts, ctts, stss, stsc, sizes,
    chunk offsets)."""
    got = {k: (bs, be) for k, bs, be in _boxes(data, path, s, e)}
    if b'stsd' not in got:
        raise IOError(f'{path}: no stsd box')
    _, _, at = _full(data, got[b'stsd'][0])
    entries = _boxes(data, path, at + 4, got[b'stsd'][1])
    kind, es, ee = next(iter(entries), (None, 0, 0))
    if kind is None:
        raise IOError(f'{path}: empty stsd box')
    if kind not in (b'avc1', b'avc3'):
        raise NotImplementedError(
            f'{path}: video codec {kind.decode("latin-1")!r}: the port '
            f'decodes H.264 (avc1 / avc3) only')
    # VisualSampleEntry: 8 bytes of SampleEntry, 70 of visual fields
    avcc = _find(data, path, es + 78, ee, b'avcC')
    if avcc is None:
        raise IOError(f'{path}: avc1 sample entry without avcC')

    def table(kind, fmt, width):
        if kind not in got:
            return None
        _, _, at = _full(data, got[kind][0])
        n = struct.unpack_from('>I', data, at)[0]
        if at + 4 + n * width * struct.calcsize('>' + fmt) > got[kind][1]:
            raise IOError(f'{path}: {kind.decode()} box truncated')
        flat = np.array(struct.unpack_from('>' + fmt * (n * width), data,
                                           at + 4), np.int64)
        return flat.reshape(n, width)

    stts = table(b'stts', 'I', 2)
    if stts is None:
        raise IOError(f'{path}: no stts box')
    ctts = None
    if b'ctts' in got:
        version = data[got[b'ctts'][0]]
        ctts = table(b'ctts', 'i' if version else 'I', 2)
    stss = table(b'stss', 'I', 1)
    stsc = table(b'stsc', 'I', 3)
    if stsc is None:
        raise IOError(f'{path}: no stsc box')
    if b'stsz' in got:
        _, _, at = _full(data, got[b'stsz'][0])
        size, n = struct.unpack_from('>II', data, at)
        sizes = np.full(n, size, np.int64) if size else np.array(
            struct.unpack_from(f'>{n}I', data, at + 8), np.int64)
    elif b'stz2' in got:
        raise NotImplementedError(f'{path}: compact sample sizes (stz2 box)')
    else:
        raise IOError(f'{path}: no stsz box')
    if b'stco' in got:
        chunks = table(b'stco', 'I', 1)[:, 0]
    elif b'co64' in got:
        chunks = table(b'co64', 'Q', 1)[:, 0]
    else:
        raise IOError(f'{path}: no stco / co64 box')
    return avcc, stts, ctts, stss, stsc, sizes, chunks


def _avcc(data, path, s, e):
    """(SPS list, PPS list, NAL length size) of an avcC payload."""
    if e - s < 7 or data[s] != 1:
        raise IOError(f'{path}: bad avcC box')
    length_size = (data[s + 4] & 3) + 1
    at = s + 5
    lists = []
    for mask in (0x1F, 0xFF):
        n = data[at] & mask
        at += 1
        items = []
        for _ in range(n):
            size = struct.unpack_from('>H', data, at)[0]
            items.append(bytes(data[at + 2:at + 2 + size]))
            at += 2 + size
        if at > e:
            raise IOError(f'{path}: avcC box truncated')
        lists.append(items)
    if not lists[0] or not lists[1]:
        raise IOError(f'{path}: avcC without an SPS or a PPS')
    return lists[0], lists[1], length_size


def _sample_offsets(stsc, sizes, chunks, path):
    """File offset of every sample from the chunk table."""
    n = len(sizes)
    per_chunk = np.zeros(len(chunks), np.int64)
    for i, (first, count, _) in enumerate(stsc):
        stop = stsc[i + 1][0] if i + 1 < len(stsc) else len(chunks) + 1
        per_chunk[first - 1:stop - 1] = count
    if per_chunk.sum() < n:
        raise IOError(f'{path}: the chunk table holds {per_chunk.sum()} of '
                      f'{n} samples')
    chunk_of = np.repeat(np.arange(len(chunks)), per_chunk)[:n]
    first_in_chunk = np.concatenate([[0], np.cumsum(per_chunk)[:-1]])
    within = np.cumsum(sizes) - sizes         # bytes before each sample
    offsets = chunks[chunk_of] + within - within[first_in_chunk[chunk_of]]
    return offsets


def _edit(data, path, trak, mvhd_scale, media_scale):
    """(media_time, duration in media units or None) of the first
    non-empty edit; None without an edit list."""
    elst = _find(data, path, *trak, b'edts', b'elst')
    if elst is None:
        return None
    version, _, at = _full(data, elst[0])
    n = struct.unpack_from('>I', data, at)[0]
    fmt, width = ('>Qq', 16) if version else ('>Ii', 8)
    edits = []
    for i in range(n):
        dur, media_time = struct.unpack_from(fmt, data, at + 4 + i * (
            width + 4))
        if media_time != -1:                  # -1: an empty edit
            edits.append((media_time, dur))
    if not edits:
        return None
    if len(edits) > 1:
        raise NotImplementedError(f'{path}: an elst box with {len(edits)} '
                                  f'non-empty edits')
    media_time, dur = edits[0]
    return media_time, (dur * media_scale // mvhd_scale if dur else None)


def open_track(path):
    """The first video track of the mp4 file at ``path`` (a ``Track``)."""
    check_container(path)
    try:
        kinds, moov = _top_level(path)
    except (OSError, struct.error) as e:
        raise IOError(f'{path}: not a readable mp4 file ({e})') from e
    for frag in (b'moof', b'mvex'):
        if frag in kinds or (moov is not None and _find(
                moov, path, 0, len(moov), frag) is not None):
            raise NotImplementedError(
                f'{path}: a fragmented mp4 ({frag.decode()} box) is not read '
                f'by the port')
    if moov is None:
        top = [k.decode('latin-1') for k in kinds]
        raise IOError(f'{path}: not a readable mp4 file (no moov box; '
                      f'top-level boxes {top})')
    try:
        return _track(moov, path)
    except (struct.error, IndexError, ValueError) as e:
        raise IOError(f'{path}: malformed mp4 ({e})') from e


def _track(moov, path):
    mvhd = _find(moov, path, 0, len(moov), b'mvhd')
    if mvhd is None:
        raise IOError(f'{path}: no mvhd box')
    version, _, at = _full(moov, mvhd[0])
    mvhd_scale = struct.unpack_from('>I', moov, at + (16 if version else 8))[0]
    for kind, s, e in _boxes(moov, path):
        if kind != b'trak':
            continue
        hdlr = _find(moov, path, s, e, b'mdia', b'hdlr')
        if hdlr is None or moov[hdlr[0] + 8:hdlr[0] + 12] != b'vide':
            continue
        mdhd = _find(moov, path, s, e, b'mdia', b'mdhd')
        if mdhd is None:
            raise IOError(f'{path}: video track without an mdhd box')
        version, _, at = _full(moov, mdhd[0])
        media_scale = struct.unpack_from('>I', moov,
                                         at + (16 if version else 8))[0]
        stbl = _find(moov, path, s, e, b'mdia', b'minf', b'stbl')
        if stbl is None:
            raise IOError(f'{path}: video track without an stbl box')
        avcc, stts, ctts, stss, stsc, sizes, chunks = _sample_table(
            moov, path, *stbl)
        sps, pps, length_size = _avcc(moov, path, *avcc)
        n = len(sizes)
        deltas = np.repeat(stts[:, 1], stts[:, 0])
        frame_count = int(stts[:, 0].sum())
        if len(deltas) < n:
            raise IOError(f'{path}: stts covers {len(deltas)} of {n} '
                          f'samples')
        dts = np.concatenate([[0], np.cumsum(deltas[:n - 1])]) if n else \
            np.zeros(0, np.int64)
        cts = dts.copy()
        if ctts is not None:
            cts += np.repeat(ctts[:, 1], ctts[:, 0])[:n]
        sync = np.ones(n, bool)
        if stss is not None:
            sync[:] = False
            sync[stss[:, 0] - 1] = True
        offsets = _sample_offsets(stsc, sizes, chunks, path)
        order = np.argsort(cts, kind='stable')
        edit = _edit(moov, path, (s, e), mvhd_scale, media_scale)
        if edit is not None:
            media_time, dur = edit
            keep = cts[order] >= media_time
            if dur is not None:
                keep &= cts[order] < media_time + dur
            order = order[keep]
        return Track(path, offsets, sizes, cts, sync, order, frame_count,
                     sps, pps, length_size)
    raise IOError(f'{path}: no video track')
