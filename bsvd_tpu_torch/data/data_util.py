"""Dataset path helpers (counterpart of bsvd_tpu/data/data_util.py):
paired paths from two folders or a meta-info file, one folder's paths,
the temporal neighbour indices of the video datasets, and DUF's official
Gaussian downsampling (scipy, as in the JAX package). An lmdb folder's
keys come from its ``meta_info.txt`` (``utils/lmdb_util``)."""

from os import path as osp

import numpy as np

from bsvd_tpu_torch.utils.misc import scandir

def paired_paths_from_folders(folders, keys, filename_tmpl='{}'):
    """[{'<input key>_path', '<gt key>_path'}] of a [input folder, gt
    folder] pair, matched by basename (``filename_tmpl`` formats the input
    name), in sorted gt order."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    assert len(input_paths) == len(gt_paths), (
        f'{input_key} and {gt_key} datasets have different number of images: '
        f'{len(input_paths)}, {len(gt_paths)}.')
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        assert input_name in input_paths, \
            f'{input_name} is not in {input_key}_paths.'
        paths.append({f'{input_key}_path': osp.join(input_folder, input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl='{}'):
    """As ``paired_paths_from_folders``, the gt names read from the first
    column of ``meta_info_file``, in its order."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, 'r') as fin:
        gt_names = [line.strip().split(' ')[0] for line in fin]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        paths.append({f'{input_key}_path': osp.join(input_folder, input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_name)})
    return paths


def _lmdb_keys(folder):
    """The keys of an lmdb folder: each ``meta_info.txt`` line up to its
    first '.'."""
    with open(osp.join(folder, 'meta_info.txt')) as fin:
        return [line.split('.')[0] for line in fin]


def paired_paths_from_lmdb(folders, keys):
    """[{'<input key>_path': key, '<gt key>_path': key}] of two lmdb
    folders' shared keys, sorted. ValueError where a folder lacks the
    ``.lmdb`` suffix or the two key sets differ."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (input_folder.endswith('.lmdb') and gt_folder.endswith('.lmdb')):
        raise ValueError(f'{input_key} and {gt_key} folders should both be '
                         f'lmdb, got {input_folder} / {gt_folder}')
    input_lmdb_keys = _lmdb_keys(input_folder)
    if set(input_lmdb_keys) != set(_lmdb_keys(gt_folder)):
        raise ValueError(f'Keys in {input_key}_folder and {gt_key}_folder '
                         f'differ.')
    return [{f'{input_key}_path': k, f'{gt_key}_path': k}
            for k in sorted(input_lmdb_keys)]


def paths_from_folder(folder):
    """Every file of ``folder`` (scandir order), joined to it."""
    return [osp.join(folder, p) for p in list(scandir(folder))]


def paths_from_lmdb(folder):
    """The keys of an lmdb folder in ``meta_info.txt``'s order; ValueError
    without the ``.lmdb`` suffix."""
    if not folder.endswith('.lmdb'):
        raise ValueError(f'Folder {folder} should be in lmdb format.')
    return _lmdb_keys(folder)


def generate_frame_indices(crt_idx, max_frame_num, num_frames,
                           padding='reflection'):
    """The ``num_frames`` (odd) indices around ``crt_idx``, padded at the
    ends by 'replicate', 'reflection', 'reflection_circle' or 'circle'."""
    assert num_frames % 2 == 1, 'num_frames should be an odd number.'
    assert padding in ('replicate', 'reflection', 'reflection_circle',
                       'circle')
    max_frame_num = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            if padding == 'replicate':
                pad_idx = 0
            elif padding == 'reflection':
                pad_idx = -i
            elif padding == 'reflection_circle':
                pad_idx = crt_idx + num_pad - i
            else:
                pad_idx = num_frames + i
        elif i > max_frame_num:
            if padding == 'replicate':
                pad_idx = max_frame_num
            elif padding == 'reflection':
                pad_idx = max_frame_num * 2 - i
            elif padding == 'reflection_circle':
                pad_idx = (crt_idx - num_pad) - (i - max_frame_num)
            else:
                pad_idx = i - num_frames
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def generate_gaussian_kernel(kernel_size=13, sigma=1.6):
    """DUF's Gaussian kernel: a centred unit impulse through
    ``scipy.ndimage.gaussian_filter``."""
    from scipy.ndimage import gaussian_filter
    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x, kernel_size=13, scale=4):
    """DUF's official downsampling of float frames (..., H, W) in [0, 1]:
    reflect-pad by kernel_size // 2 + 2 * scale, blur by the Gaussian of
    sigma 0.4 * scale, keep every ``scale``-th pixel (a 'valid' strided
    correlation), crop 2 pixels a side -> float32 (..., h, w)."""
    from scipy.ndimage import correlate
    assert scale in (2, 3, 4), (f'Only support scale (2, 3, 4), but got '
                                f'{scale}.')
    kern = generate_gaussian_kernel(kernel_size, 0.4 * scale)
    pad = kernel_size // 2 + scale * 2
    k2 = kernel_size // 2
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    out = []
    for img in x.reshape(-1, h, w):
        p = np.pad(img, pad, mode='reflect')
        full = correlate(p, kern, mode='constant')
        # output i of the strided 'valid' correlation is padded row
        # i * scale + kernel_size // 2
        nh = (p.shape[0] - kernel_size) // scale + 1
        nw = (p.shape[1] - kernel_size) // scale + 1
        sub = full[k2:k2 + nh * scale:scale, k2:k2 + nw * scale:scale]
        out.append(sub[2:-2, 2:-2])
    out = np.stack(out).astype(np.float32)
    return out.reshape(*lead, *out.shape[-2:])
