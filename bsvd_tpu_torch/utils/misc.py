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
