"""Experiment folders, time stamps and the frame sort key (counterpart of
bsvd_tpu/utils/misc.py get_time_str, mkdir_and_rename, make_exp_dirs,
digit_sort_key), for one process."""

import os
import re
import time
from os import path as osp


def get_time_str():
    return time.strftime('%Y%m%d_%H%M%S', time.localtime())


def mkdir_and_rename(path):
    """mkdir; an existing folder is first renamed with a time stamp."""
    if osp.exists(path):
        new_name = path + '_archived_' + get_time_str()
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt):
    """The run's folder tree: experiments_root (train) or results_root
    (test) afresh, then every other folder of opt['path']."""
    path_opt = dict(opt['path'])
    root = 'experiments_root' if opt['is_train'] else 'results_root'
    mkdir_and_rename(path_opt.pop(root))
    for key, p in path_opt.items():
        if ('strict_load' in key or 'pretrain_network' in key
                or 'resume' in key or 'param_key' in key):
            continue
        if isinstance(p, str):
            os.makedirs(p, exist_ok=True)


def digit_sort_key(path):
    """Sort key: the integer formed by all digits in the file name
    (reference get_imagenames sort, utils_common.py:94)."""
    digits = ''.join(re.findall(r'\d+', osp.basename(path)))
    return int(digits) if digits else 0


def scandir(dir_path, suffix=None, recursive=False, full_path=False):
    """Yield file paths under dir_path, optionally filtered by suffix."""
    if (suffix is not None) and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith('.') and entry.is_file():
                return_path = entry.path if full_path else osp.relpath(
                    entry.path, root)
                if (suffix is None) or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix=suffix,
                                    recursive=recursive)

    return _scandir(dir_path, suffix=suffix, recursive=recursive)


def check_resume(opt, resume_iter):
    """On resume, point every pretrain_network_* at the checkpoint of the
    resumed iteration, unless path.ignore_resume_networks names it."""
    if not opt['path'].get('resume_state'):
        return
    networks = [key for key in opt if key.startswith('network_')]
    if any(opt['path'].get(f'pretrain_{n}') is not None for n in networks):
        print('pretrain_network path will be ignored during resuming.',
              flush=True)
    ignore = opt['path'].get('ignore_resume_networks') or ()
    for network in networks:
        if network in ignore:
            continue
        name = f'pretrain_{network}'
        opt['path'][name] = osp.join(
            opt['path']['models'],
            f"net_{network.replace('network_', '')}_{resume_iter}.npz")
        print(f"Set {name} to {opt['path'][name]}", flush=True)


def sizeof_fmt(size, suffix='B'):
    for unit in ('', 'K', 'M', 'G', 'T', 'P', 'E', 'Z'):
        if abs(size) < 1024.0:
            return f'{size:3.1f} {unit}{suffix}'
        size /= 1024.0
    return f'{size:3.1f} Y{suffix}'
