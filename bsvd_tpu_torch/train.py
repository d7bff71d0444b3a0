"""The training entry point (counterpart of bsvd_tpu/train.py): options ->
loaders -> DenoisingModel -> the iteration loop, with periodic log, save
and validation, on the card unless the options or the caller name the CPU.

    python -m bsvd_tpu_torch.train -opt options/train/bsvd_c64_unblind.yml \\
        [--auto_resume] [--debug] [--device cpu] \\
        [--force_yml datasets:train:trainset_dir=<frame folders> ...]

On several cards, one process each::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m bsvd_tpu_torch.train -opt <yml> --launcher pytorch

(``num_gpu: auto``, ``parallel: {spatial: S}`` to split rows over S of
them). Every rank steps; rank 0 logs, saves, writes the validation's
CSVs and finds the state to resume from.

``train_pipeline(root_path, cmd, opt_path)`` is what the command runs;
``train_loop(opt, train_loader)`` is its loop over a loader of batches
with ``__len__`` (dicts of numpy or tensor ``lq`` / ``gt`` / ``noise_map``,
e.g. ``data.video_train_loader.SyntheticVideoLoader``) for an options
dict whose paths are set.
"""

import copy
import logging
import math
import os
import time
from os import path as osp

from bsvd_tpu_torch.data import build_dataloader, build_dataset
from bsvd_tpu_torch.models.base_model import (build_model,
                                              latest_resume_state)
from bsvd_tpu_torch.models.checkpoint import load_training_state
from bsvd_tpu_torch.parallel.mesh import (barrier, broadcast_object,
                                          is_main_process)
from bsvd_tpu_torch.utils.logger import (AvgTimer, MessageLogger,
                                         get_env_info, get_root_logger,
                                         init_tb_logger, init_wandb_logger)
from bsvd_tpu_torch.utils.misc import (check_resume, get_time_str,
                                       make_exp_dirs)
from bsvd_tpu_torch.utils.options import (copy_opt_file, dict2str,
                                          parse_options)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def create_train_val_dataloader(opt, logger):
    """The train loader, the val loaders, and the epochs and iterations to
    run (bsvd_tpu/train.py:19-51)."""
    train_loader, val_loaders, total_epochs, total_iters = None, [], 0, 0
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            dataset_opt.setdefault('manual_seed', opt.get('manual_seed', 0))
            dataset_opt.setdefault('num_devices', opt.get('num_gpu', 1))
            dataset_opt.setdefault('rank', opt.get('rank', 0))
            # where mp4 clips decode (NVDEC on the card)
            dataset_opt.setdefault('device', opt.get('device', 'cuda'))
            train_loader = build_dataloader(build_dataset(dataset_opt),
                                            dataset_opt,
                                            num_gpu=opt['num_gpu'],
                                            dist=opt.get('dist', False))
            num_iter_per_epoch = len(train_loader)
            total_iters = int(opt['train']['total_iter'])
            total_epochs = math.ceil(total_iters / max(num_iter_per_epoch, 1))
            logger.info('Training statistics:'
                        f'\n\tNumber of train batches per epoch: '
                        f'{num_iter_per_epoch}'
                        f'\n\tTotal epochs: {total_epochs}; iters: '
                        f'{total_iters}.')
        elif phase.split('_')[0] == 'val':
            val_loaders.append(_val_loader(opt, dataset_opt))
            logger.info(f"Number of val videos in {dataset_opt['name']}: "
                        f'{len(val_loaders[-1])}')
        else:
            raise ValueError(f'Dataset phase {phase} is not recognized.')
    return train_loader, val_loaders, total_epochs, total_iters


def _val_loader(opt, dataset_opt):
    """The loader of one val dataset, blind where the network is."""
    net = opt['network_g']
    dataset_opt.setdefault('phase', 'val')
    dataset_opt.setdefault('manual_seed', opt.get('manual_seed', 0))
    if net.get('blind', False) or (net.get('net2d_opt') or {}).get(
            'blind', False):
        dataset_opt['blind'] = True
    return build_dataloader(build_dataset(dataset_opt), dataset_opt,
                            num_gpu=opt.get('num_gpu', 1))


def build_val_loaders(opt):
    """Loaders of the ``val_*`` datasets of ``opt['datasets']``."""
    return [_val_loader(opt, dict(dataset_opt))
            for phase, dataset_opt in (opt.get('datasets') or {}).items()
            if phase.split('_')[0] == 'val']


def load_resume_state(opt):
    """The training state to resume from (``auto_resume``: the latest in
    path.training_states; else path.resume_state), with the networks'
    pretrain paths pointed at its checkpoint; None to start afresh.

    The JAX package looks for auto-resume states under
    ``experiments/<name>`` of the working directory (bsvd_tpu/train.py:57);
    the port looks where the run writes them, under ``root_path``. Rank 0
    searches and tells the others."""
    path = None
    if opt.get('auto_resume'):
        path = broadcast_object(
            latest_resume_state(opt['path']['training_states'])
            if is_main_process() else None)
        if path:
            opt['path']['resume_state'] = path
    elif opt['path'].get('resume_state'):
        path = opt['path']['resume_state']
    if path is None:
        return None
    state = load_training_state(path)
    check_resume(opt, state['iter'])
    return state


def train_loop(opt, train_loader, device=None, val_loaders=None,
               resume_state=None, tb_logger=None):
    """Train for ``opt['train']['total_iter']`` iterations over
    ``train_loader`` (an iterable with ``__len__``, the batches of one
    epoch; re-iterated per epoch, as bsvd_tpu/train.py:118-162 does);
    returns the model. The iteration and data times go to the log every
    ``logger.print_freq`` iterations. Resumes from ``resume_state``, else from
    what ``load_resume_state(opt)`` finds. With ``val.val_freq`` the model
    is validated on ``val_loaders`` (default: ``build_val_loaders(opt)``)
    every ``val_freq`` iterations and after the last. ``tb_logger`` (a
    ``utils.logger.TBLogger``) receives the losses and the validation
    metrics; the caller closes it."""
    opt = copy.deepcopy(opt)
    logger = get_root_logger()
    val_freq = (opt.get('val') or {}).get('val_freq')
    if val_freq and val_loaders is None:
        val_loaders = build_val_loaders(opt)
    opt['is_train'] = True
    for key in ('models', 'training_states'):
        os.makedirs(opt['path'][key], exist_ok=True)
    if resume_state is None:
        resume_state = load_resume_state(opt)
    model = build_model(opt, device=device)
    start_epoch, current_iter = 0, 0
    if resume_state is not None:
        model.resume_training(resume_state)
        start_epoch, current_iter = resume_state['epoch'], resume_state['iter']
        logger.info(f'Resuming training from epoch: {start_epoch}, iter: '
                    f'{current_iter}.')

    total_iters = int(opt['train']['total_iter'])
    total_epochs = math.ceil(total_iters / max(len(train_loader), 1))
    print_freq = int(opt['logger']['print_freq'])
    save_freq = int(opt['logger']['save_checkpoint_freq'])
    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    logger.info(f'Start training from epoch: {start_epoch}, iter: '
                f'{current_iter}')
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    start_time = time.time()
    epoch, stop = start_epoch, False
    while not stop and epoch < total_epochs + 1:
        fed = False
        for train_data in train_loader:
            data_timer.record()
            current_iter += 1
            if current_iter > total_iters:
                stop = True
                break
            fed = True
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
            iter_timer.record()
            if current_iter == 1:
                msg_logger.reset_start_time()
            if current_iter % print_freq == 0:
                log_vars = {'epoch': epoch, 'iter': current_iter,
                            'lrs': model.get_current_learning_rate(),
                            'time': iter_timer.get_avg_time(),
                            'data_time': data_timer.get_avg_time()}
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)
            if current_iter % save_freq == 0:
                logger.info('Saving models and training states.')
                model.save(epoch, current_iter)
            if val_freq and current_iter % int(val_freq) == 0:
                validate(model, opt, val_loaders, current_iter, tb_logger)
            data_timer.start()
            iter_timer.start()
        if not fed and not stop:
            raise ValueError('the train loader yielded no batch')
        epoch += 1
    logger.info(f'End of training. Time consumed: '
                f'{(time.time() - start_time) / 3600:.2f} h')
    logger.info('Save the latest model.')
    model.save(epoch=-1, current_iter=-1)
    if val_freq:
        validate(model, opt, val_loaders, min(current_iter, total_iters),
                 tb_logger)
    return model


def validate(model, opt, val_loaders, current_iter, tb_logger=None):
    """One validation of ``model`` on each loader, its metrics also written
    to ``tb_logger``."""
    for val_loader in val_loaders:
        model.validation(val_loader, current_iter, tb_logger,
                         opt['val'].get('save_img', False))


def train_pipeline(root_path, cmd=None, opt_path=None, device=None):
    """The command line's run (bsvd_tpu/train.py:71-165): parse the options
    (``cmd``, else sys.argv; or the file ``opt_path``), which first joins
    the process group under ``--launcher`` (``parallel.mesh.
    init_distributed``), make the experiment folder unless resuming, copy
    the option file there, log, build the loaders and train. ``device``
    overrides the options'. Returns the model."""
    opt, args = parse_options(root_path, is_train=True, cmd=cmd,
                              opt_path=opt_path)
    if device is not None:
        opt['device'] = device
    resume_state = load_resume_state(opt)
    if resume_state is None and is_main_process():
        make_exp_dirs(opt)
    barrier()
    if getattr(args, 'opt', None) and osp.isfile(args.opt):
        copy_opt_file(args.opt, opt['path']['experiments_root'])

    logger = get_root_logger(log_level=logging.INFO, log_file=osp.join(
        opt['path']['log'], f"train_{opt['name']}_{get_time_str()}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    wandb = opt['logger'].get('wandb')
    if wandb is not None and wandb.get('project') is not None:
        init_wandb_logger(opt)
    tb_logger = None
    if opt['logger'].get('use_tb_logger'):
        tb_logger = init_tb_logger(osp.join(opt['path']['experiments_root'],
                                            'tb_logger'))

    train_loader, val_loaders, _, _ = create_train_val_dataloader(opt,
                                                                  logger)
    try:
        return train_loop(opt, train_loader, val_loaders=val_loaders,
                          resume_state=resume_state, tb_logger=tb_logger)
    finally:
        if hasattr(train_loader, 'close'):
            train_loader.close()
        if tb_logger is not None:
            tb_logger.close()


def main():
    train_pipeline(ROOT)


if __name__ == '__main__':
    main()
