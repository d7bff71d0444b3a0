"""Logging of the port (counterpart of bsvd_tpu/utils/logger.py): the root
logger (rank-gated: ranks other than 0 log errors only, to no file), the
train loop's timers and message logger, the TensorBoard scalar writer
(event files written by ``utils/tb_events``, no package), and the
environment line.

wandb is not ported: a ``logger.wandb.project`` raises (it needs a package
and the network)."""

import datetime
import logging
import time

import torch

from bsvd_tpu_torch.parallel.mesh import is_main_process
from bsvd_tpu_torch.utils.tb_events import EventWriter

LOGGER = 'bsvd_tpu_torch'


def get_root_logger(logger_name=LOGGER, log_level=logging.INFO,
                    log_file=None):
    """The logger ``logger_name`` with a console handler (added once) at
    ``log_level`` and, when ``log_file`` is given, a file handler writing
    there at ``log_level`` (in place of an earlier run's). On ranks other
    than 0 of a process group it logs at ERROR level with no file handler
    (JAX bsvd_tpu/utils/logger.py:14-28)."""
    main = is_main_process()
    if not main:
        log_file = None
    logger = logging.getLogger(logger_name)
    fmt = logging.Formatter('%(asctime)s %(levelname)s: %(message)s')
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(fmt)
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(log_level)
    if log_file is not None:
        for old in [h for h in logger.handlers
                    if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(old)
            old.close()
        handler = logging.FileHandler(log_file, 'w')
        handler.setFormatter(fmt)
        handler.setLevel(log_level)
        logger.addHandler(handler)
        logger.setLevel(log_level)
    if not main:
        logger.setLevel(logging.ERROR)
    return logger


class AvgTimer:
    """Running-average interval timer (the train loop's iteration and data
    times), reset every ``window`` records."""

    def __init__(self, window=200):
        self.window = window
        self.current_time = 0
        self.total_time = 0
        self.count = 0
        self.avg_time = 0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """The train loop's periodic line: epoch, iteration, learning rates,
    ETA, iteration and data time, and the losses, each loss also written to
    ``tb_logger`` (``losses/<k>`` for keys starting with ``l_``, else
    ``<k>``)."""

    def __init__(self, opt, start_iter=1, tb_logger=None):
        self.exp_name = opt['name']
        self.interval = opt['logger']['print_freq']
        self.start_iter = start_iter
        self.max_iters = int(opt['train']['total_iter'])
        self.use_tb_logger = opt['logger'].get('use_tb_logger', False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    def __call__(self, log_vars):
        epoch = log_vars.pop('epoch')
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs')

        message = (f'[{self.exp_name[:31]}..][epoch:{epoch:3d}, '
                   f'iter:{current_iter:8,d}, lr:(')
        for v in lrs:
            message += f'{v:.3e},'
        message += ')] '

        if 'time' in log_vars:
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time')
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f'[eta: {eta_str}, '
            message += f'time (data): {iter_time:.3f} ({data_time:.3f})] '

        for k, v in log_vars.items():
            message += f'{k}: {v:.4e} '
            if self.tb_logger is not None:
                label = f'losses/{k}' if k.startswith('l_') else k
                self.tb_logger.add_scalar(label, v, current_iter)
        self.logger.info(message)


# the JAX package's TensorBoard scalar writer: add_scalar / flush / close
# on one event file under log_dir, each scalar as tf.summary.scalar writes
# it
TBLogger = EventWriter


def init_tb_logger(log_dir):
    """The TensorBoard writer on the main process; None on the other ranks
    (callers treat None as no writer)."""
    if not is_main_process():
        return None
    return TBLogger(log_dir)


def init_wandb_logger(opt):
    """wandb is not ported: a configured project raises."""
    raise NotImplementedError(
        f"logger.wandb.project {opt['logger']['wandb']['project']!r}: wandb "
        f"is not ported (ROADMAP Queue 1); set it to ~")


def get_env_info():
    """Framework, torch and CUDA versions, and the card (if any)."""
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else 'none')
    return ('\nFramework: bsvd_tpu_torch'
            f'\n\tPyTorch: {torch.__version__}'
            f'\n\tCUDA: {torch.version.cuda}'
            f'\n\tCard: {card}')
