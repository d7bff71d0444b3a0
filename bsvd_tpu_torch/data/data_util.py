"""Dataset path helpers (counterpart of bsvd_tpu/data/data_util.py):
paired paths from two folders or a meta-info file, one folder's paths,
and the temporal neighbour indices of the video datasets. The lmdb
readers raise NotImplementedError (ROADMAP.md Queue 1); the DUF
downsampling comes with the video family."""

from os import path as osp

from bsvd_tpu_torch.utils.misc import scandir

_LMDB = ('lmdb folders are not ported (ROADMAP.md Queue 1: lmdb with '
         'utils/lmdb_util and _lmdb_compat)')


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


def paired_paths_from_lmdb(folders, keys):
    raise NotImplementedError(_LMDB)


def paths_from_folder(folder):
    """Every file of ``folder`` (scandir order), joined to it."""
    return [osp.join(folder, p) for p in list(scandir(folder))]


def paths_from_lmdb(folder):
    raise NotImplementedError(_LMDB)


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
