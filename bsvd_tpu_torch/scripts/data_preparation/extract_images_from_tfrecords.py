"""FFHQ / CelebA images out of TFRecords into a PNG folder or an lmdb
store (counterpart of the JAX repo's scripts/data_preparation/
extract_images_from_tfrecords.py, BasicSR's).

    python -m bsvd_tpu_torch.scripts.data_preparation.extract_images_from_tfrecords \\
        --dataset ffhq --tf_file datasets/ffhq/ffhq-r10.tfrecords \\
        --log_resolution 10 --save_root datasets/ffhq/ [--save_type img|lmdb] \\
        [--compress_level 1]

No TensorFlow: the record framing (u64 length, its masked CRC-32C, the
payload, its CRC; the CRCs are not checked) and the ``tf.train.Example``
message (a varint / length-delimited wire-format walk) are read here.
FFHQ records hold CHW RGB under 'data' with 'shape' (c, h, w), CelebA's
HWC RGB with (h, w, c); images are written BGR as ``<idx:08d>.png``, or
stored through ``utils/lmdb_util.LmdbMaker`` under ``<idx:08d>/r<log
res:02d>`` as PNGs of zlib level ``compress_level``.
"""

import argparse
import glob
import os
import struct

import numpy as np

from bsvd_tpu_torch.utils.img_util import encode_png, imfrombytes, imwrite


def iter_tfrecord(path):
    """The payload bytes of each record of a TFRecord file."""
    with open(path, 'rb') as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack('<Q', header[:8])
            payload = f.read(length)
            if len(payload) < length:
                raise EOFError(f'truncated record in {path}')
            f.read(4)
            yield payload


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    """(field number, wire type, value) of a serialized message: an int
    for varint / fixed fields, a memoryview for length-delimited ones."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from('<Q', buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = memoryview(buf)[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from('<I', buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, val


def _feature_values(feature):
    """The values of a Feature: bytes_list (1), float_list (2) or
    int64_list (3), each a repeated field 1, packed or not."""
    values = []
    for kind, _, lst in _iter_fields(feature):
        for f, wire, item in _iter_fields(lst):
            if f != 1:
                continue
            if kind == 1:
                values.append(bytes(item))
            elif kind == 2 and wire == 2:
                values.extend(np.frombuffer(item, '<f4').tolist())
            elif kind == 2:
                values.append(struct.unpack('<f', struct.pack('<I', item))[0])
            elif kind == 3 and wire == 2:
                pos = 0
                while pos < len(item):
                    v, pos = _read_varint(item, pos)
                    values.append(v)
            elif kind == 3:
                values.append(item)
    return values


def parse_example(buf):
    """A serialized tf.train.Example -> {feature name: [values]}
    (Example.features (1) -> Features.feature (1) map entries of key (1)
    and Feature (2))."""
    feats = {}
    for f, _, features in _iter_fields(buf):
        if f != 1:
            continue
        for f2, _, entry in _iter_fields(features):
            if f2 != 1:
                continue
            name, values = None, []
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v3).decode()
                elif f3 == 2:
                    values = _feature_values(v3)
            if name is not None:
                feats[name] = values
    return feats


class _Sink:
    """Where the images go: ``<save_root>/<basename>/`` as PNG files, or
    the store ``<save_root>/<basename>.lmdb``."""

    def __init__(self, save_root, basename, save_type, log_resolution,
                 compress_level):
        self.log_resolution = log_resolution
        self.compress_level = compress_level
        self.maker = None
        if save_type == 'lmdb':
            from bsvd_tpu_torch.utils.lmdb_util import LmdbMaker
            self.path = os.path.join(save_root, f'{basename}.lmdb')
            self.maker = LmdbMaker(self.path,
                                   compress_level=compress_level)
        elif save_type == 'img':
            self.path = os.path.join(save_root, basename)
            os.makedirs(self.path, exist_ok=True)
        else:
            raise ValueError('Wrong save type.')

    def put(self, img, idx):
        """``img`` (H, W, 3) BGR uint8, the dataset's ``idx``-th image."""
        if self.maker is None:
            imwrite(img, os.path.join(self.path, f'{idx:08d}.png'))
        else:
            self.maker.put(encode_png(img, level=self.compress_level),
                           f'{idx:08d}/r{self.log_resolution:02d}',
                           img.shape)

    def close(self):
        if self.maker is not None:
            self.maker.close()


def _convert(tf_file, sink, to_bgr):
    idx = 0
    for record in sorted(glob.glob(tf_file)):
        print('Processing record: ', record)
        for payload in iter_tfrecord(record):
            feats = parse_example(payload)
            sink.put(np.ascontiguousarray(to_bgr(feats)), idx)
            idx += 1
    sink.close()
    return idx


def _ffhq_bgr(feats):
    c, h, w = feats['shape']
    img = np.frombuffer(feats['data'][0], np.uint8).reshape((c, h, w))
    return img.transpose(1, 2, 0)[:, :, ::-1]


def _celeba_bgr(feats):
    h, w, c = feats['shape']
    img = np.frombuffer(feats['data'][0], np.uint8).reshape((h, w, c))
    return img[:, :, ::-1]


def convert_ffhq_tfrecords(tf_file, log_resolution, save_root,
                           save_type='img', compress_level=1):
    """FFHQ's records (a glob) -> ``ffhq_<2^log_resolution>``; returns
    the count."""
    return _convert(tf_file, _Sink(save_root, f'ffhq_{2**log_resolution}',
                                   save_type, log_resolution,
                                   compress_level), _ffhq_bgr)


def convert_celeba_tfrecords(tf_file, log_resolution, save_root,
                             save_type='img', compress_level=1):
    """CelebA's records (a glob) -> ``celeba_<2^log_resolution>_<phase>``,
    the phase 'validation' where the file name says so, else 'train';
    returns the count."""
    phase = 'validation' if 'validation' in tf_file else 'train'
    return _convert(tf_file, _Sink(
        save_root, f'celeba_{2**log_resolution}_{phase}', save_type,
        log_resolution, compress_level), _celeba_bgr)


def make_ffhq_lmdb_from_imgs(folder_path, log_resolution, save_root,
                             save_type='lmdb', compress_level=1):
    """A folder of (cropped) FFHQ images, sorted, into the store
    ``ffhq_<2^log_resolution>_crop1.2.lmdb``."""
    if save_type != 'lmdb':
        raise ValueError('Wrong save type.')
    sink = _Sink(save_root, f'ffhq_{2**log_resolution}_crop1.2', 'lmdb',
                 log_resolution, compress_level)
    for idx, img_path in enumerate(sorted(glob.glob(
            os.path.join(folder_path, '*')))):
        print(f'Processing {idx}: ', img_path)
        with open(img_path, 'rb') as f:
            sink.put(imfrombytes(f.read(), 'color'), idx)
    sink.close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset', type=str, default='ffhq',
                        help="'ffhq' | 'celeba'")
    parser.add_argument('--tf_file', type=str,
                        default='datasets/ffhq/ffhq-r10.tfrecords',
                        help='TFRecord file (a glob for celeba; quote it so '
                             'the shell does not expand it)')
    parser.add_argument('--log_resolution', type=int, default=10)
    parser.add_argument('--save_root', type=str, default='datasets/ffhq/')
    parser.add_argument('--save_type', type=str, default='img',
                        help="'img' | 'lmdb'")
    parser.add_argument('--compress_level', type=int, default=1)
    args = parser.parse_args(argv)
    convert = (convert_ffhq_tfrecords if args.dataset == 'ffhq'
               else convert_celeba_tfrecords)
    convert(args.tf_file, args.log_resolution, args.save_root,
            save_type=args.save_type, compress_level=args.compress_level)


if __name__ == '__main__':
    main()
