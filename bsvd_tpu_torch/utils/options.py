"""The experiment options: the YAML option files, the command line and the
paths derived from them (counterpart of bsvd_tpu/utils/options.py).

The same files and the same command line as the JAX package: ``-opt``,
``--launcher``, ``--auto_resume``, ``--debug``, ``--force_yml
key:sub=value``, and ``--local_rank`` accepted and ignored (torchrun
passes LOCAL_RANK in the environment). The port adds ``--device`` (the
card by default, or ``cpu``). YAML is read by the port's own reader
(``utils/yaml_lite``), with PyYAML's scalar rules.

``--launcher pytorch|slurm`` joins the process group that the launcher's
environment describes (``parallel.mesh.init_distributed``: NCCL on the
card, gloo with ``--device cpu``; nothing where it describes none), and
``dist``, ``rank`` and ``world_size`` come from the process group.
``num_gpu`` keeps the JAX package's meaning, the cards of the mesh:
'auto' is the world size, and a number must equal it, so ``num_gpu: 2``
needs two processes (``python -m torch.distributed.run --nproc_per_node 2
-m bsvd_tpu_torch.train -opt ... --launcher pytorch``).
"""

import argparse
import random
import shutil
import sys
import time
from os import path as osp

import numpy as np
import torch
import torch.distributed as dist

from bsvd_tpu_torch.parallel.mesh import init_distributed, master_only, world
from bsvd_tpu_torch.utils import yaml_lite


def yaml_load(f):
    """The document of a YAML file path, or of a YAML string."""
    if osp.isfile(f):
        return yaml_lite.load(f)
    return yaml_lite.loads(f)


def dict2str(opt, indent_level=1):
    msg = '\n'
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_level * 2) + k + ':['
            msg += dict2str(v, indent_level + 1)
            msg += ' ' * (indent_level * 2) + ']\n'
        else:
            msg += ' ' * (indent_level * 2) + k + ': ' + str(v) + '\n'
    return msg


def _set_by_keypath(opt, keys, value):
    node = opt
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def apply_force_yml(opt, entries):
    """Apply ``--force_yml train:ema_decay=0.999``-style overrides; each
    value is read as a YAML document (spaces are dropped first, as the JAX
    package drops them)."""
    if not entries:
        return
    for entry in entries:
        entry = entry.replace(' ', '')
        keys, value = entry.split('=', 1)
        _set_by_keypath(opt, keys.split(':'), yaml_lite.loads(
            value, source=f'--force_yml {entry}'))


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def _num_gpu(opt, world_size):
    """``num_gpu``: 'auto' is the world size; a number must equal it."""
    num_gpu = opt.get('num_gpu', 'auto')
    if num_gpu == 'auto':
        return world_size
    if int(num_gpu) != world_size:
        raise ValueError(
            f'num_gpu {num_gpu} with {world_size} process(es): the port runs '
            f'one process per card; launch them with python -m '
            f'torch.distributed.run --nproc_per_node {num_gpu} -m '
            f'bsvd_tpu_torch.train -opt <yml> --launcher pytorch')
    return world_size


def parse_options(root_path, is_train=True, cmd=None, opt_path=None):
    """Command line + YAML -> (opt, args).

    Args:
        root_path: the experiments/ and results/ folders are made under it.
        is_train: the train or the test layout of the paths.
        cmd: an explicit argv list (else sys.argv).
        opt_path: read this option file and no command line.
    """
    if opt_path is not None:
        args = argparse.Namespace(opt=opt_path, launcher='none',
                                  auto_resume=False, debug=False,
                                  force_yml=None, device=None)
    else:
        parser = argparse.ArgumentParser()
        parser.add_argument('-opt', type=str, required=True,
                            help='Path to option YAML file.')
        parser.add_argument('--launcher', choices=['none', 'pytorch',
                                                   'slurm'],
                            default='none',
                            help='join the process group of torchrun '
                                 '(pytorch) or srun (slurm)')
        parser.add_argument('--auto_resume', action='store_true')
        parser.add_argument('--debug', action='store_true')
        parser.add_argument('--local_rank', type=int, default=0)
        parser.add_argument('--force_yml', nargs='+', default=None,
                            help='Force to update yml files. Examples: '
                                 'train:ema_decay=0.999')
        parser.add_argument('--device', default=None,
                            help="'cuda' (the default) or 'cpu'")
        args = parser.parse_args(cmd)

    opt = yaml_load(args.opt)
    opt['dist'] = False
    opt['rank'], opt['world_size'] = 0, 1

    if args.force_yml is not None:
        apply_force_yml(opt, args.force_yml)
    if args.device is not None:
        opt['device'] = args.device

    if args.launcher != 'none':
        on_cpu = str(opt.get('device', 'cuda')).startswith('cpu')
        init_distributed(backend='gloo' if on_cpu else None)
    opt['dist'] = dist.is_available() and dist.is_initialized()
    opt['rank'], opt['world_size'] = world()

    if args.debug and not opt['name'].startswith('debug'):
        opt['name'] = 'debug_' + opt['name']

    opt['num_gpu'] = _num_gpu(opt, opt['world_size'])

    seed = opt.get('manual_seed')
    if seed is None:
        seed = random.randint(1, 10000)
        opt['manual_seed'] = seed
    set_random_seed(seed + opt['rank'])

    opt['auto_resume'] = args.auto_resume
    opt['is_train'] = is_train

    for phase, dataset in (opt.get('datasets') or {}).items():
        dataset['phase'] = phase.split('_')[0]
        if 'scale' in opt:
            dataset['scale'] = opt['scale']
        for key in ('dataroot_gt', 'dataroot_lq'):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    opt.setdefault('path', {})
    for key, val in opt['path'].items():
        if (val is not None) and ('resume_state' in key
                                  or 'pretrain_network' in key):
            opt['path'][key] = osp.expanduser(val)

    if is_train:
        experiments_root = osp.join(root_path, 'experiments', opt['name'])
        opt['path']['experiments_root'] = experiments_root
        opt['path']['models'] = osp.join(experiments_root, 'models')
        opt['path']['training_states'] = osp.join(experiments_root,
                                                  'training_states')
        opt['path']['log'] = experiments_root
        opt['path']['visualization'] = osp.join(experiments_root,
                                                'visualization')
        if 'debug' in opt['name']:
            if 'val' in opt:
                opt['val']['val_freq'] = 8
            opt['logger']['print_freq'] = 1
            opt['logger']['save_checkpoint_freq'] = 8
    else:
        results_root = osp.join(root_path, 'results', opt['name'])
        opt['path']['results_root'] = results_root
        opt['path']['log'] = results_root
        opt['path']['visualization'] = osp.join(results_root,
                                                'visualization')

    return opt, args


@master_only
def copy_opt_file(opt_file, experiments_root):
    """Copy the option file into the experiment folder, stamped with the
    launch time and command (rank 0 only)."""
    cmd = ' '.join(sys.argv)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    shutil.copyfile(opt_file, filename)
    with open(filename, 'r+') as f:
        lines = f.readlines()
        lines.insert(0, f'# GENERATE TIME: {time.asctime()}\n# CMD:\n'
                        f'# {cmd}\n\n')
        f.seek(0)
        f.writelines(lines)
