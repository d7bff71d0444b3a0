"""The test entry point (counterpart of bsvd_tpu/test.py): options -> val
datasets -> DenoisingModel -> each dataset's validation (metrics,
per-scene CSVs, denoised frames), on the card unless the options or the
caller name the CPU.

    python -m bsvd_tpu_torch.test -opt options/test/bsvd_c64.yml \\
        [--force_yml key:sub=value ...] [--device cpu]

prints {dataset name: metric averages} as JSON. ``test_pipeline(root_path,
cmd, opt_path)`` is what the command runs; ``evaluate(opt)`` runs an
options dict whose paths are set. Under torchrun with ``--launcher
pytorch`` every rank evaluates (``DenoisingModel.validation`` shares the
folders out) and rank 0 writes and prints.
"""

import copy
import json
import logging
from os import path as osp

from bsvd_tpu_torch.data import build_dataloader, build_dataset
from bsvd_tpu_torch.models.denoising_model import build_model
from bsvd_tpu_torch.parallel.mesh import barrier, is_main_process
from bsvd_tpu_torch.utils.logger import get_env_info, get_root_logger
from bsvd_tpu_torch.utils.misc import get_time_str, make_exp_dirs
from bsvd_tpu_torch.utils.options import dict2str, parse_options

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def evaluate(opt, device=None):
    """Validate the model of ``opt`` on each of its datasets (sorted by
    phase key); returns {dataset name: metric averages}."""
    opt = copy.deepcopy(opt)
    opt['is_train'] = False
    if is_main_process():
        make_exp_dirs(opt)
    barrier()
    logger = get_root_logger(log_level=logging.INFO, log_file=osp.join(
        opt['path']['log'], f"test_{opt['name']}_{get_time_str()}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        dataset_opt.setdefault('manual_seed', opt.get('manual_seed', 0))
        if opt['network_g'].get('blind', False):
            dataset_opt['blind'] = True
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt,
                                             num_gpu=opt['num_gpu']))
        logger.info(f"Number of test videos in {dataset_opt['name']}: "
                    f'{len(test_set)}')

    model = build_model(opt, device=device)
    results = {}
    for test_loader in test_loaders:
        name = test_loader.dataset.opt['name']
        logger.info(f'Testing {name}...')
        results[name] = model.validation(
            test_loader, current_iter=opt['name'], tb_logger=None,
            save_img=opt['val'].get('save_img', False))
    return results


def test_pipeline(root_path, cmd=None, opt_path=None, device=None):
    """The command line's run (bsvd_tpu/test.py:13-43): parse the options
    (``cmd``, else sys.argv; or the file ``opt_path``; under ``--launcher``
    this joins the process group first) and evaluate. ``device``
    overrides the options'."""
    opt, _ = parse_options(root_path, is_train=False, cmd=cmd,
                           opt_path=opt_path)
    return evaluate(opt, device=device)


def main():
    results = test_pipeline(ROOT)
    if is_main_process():
        print(json.dumps(results))


if __name__ == '__main__':
    main()
