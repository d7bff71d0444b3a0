"""The test pipeline (counterpart of bsvd_tpu/test.py test_pipeline):
options -> val datasets -> DenoisingModel -> each dataset's validation
(metrics, per-scene CSVs, denoised frames), on the card unless the options
or the caller name the CPU.

It takes the options dict that ``bsvd_tpu.utils.options.parse_options``
returns for a test YAML (``is_train=False``: path.results_root, log and
visualization set), or a JSON file of that dict: the card's machine has no
PyYAML, so parse there where it is and dump JSON.

    python -m bsvd_tpu_torch.test --opt opt.json [--device cpu]
"""

import argparse
import copy
import json
from os import path as osp

import torch

from bsvd_tpu_torch.data import build_dataloader, build_dataset
from bsvd_tpu_torch.models.denoising_model import build_model
from bsvd_tpu_torch.utils.logger import get_root_logger
from bsvd_tpu_torch.utils.misc import get_time_str, make_exp_dirs


def load_options(opt):
    """A deep copy of an options dict, or the dict a JSON file holds."""
    if isinstance(opt, dict):
        return copy.deepcopy(opt)
    with open(opt) as f:
        return json.load(f)


def test_pipeline(opt, device=None):
    """Validate the model of ``opt`` on each of its datasets (sorted by
    phase key); returns {dataset name: metric averages}."""
    opt = load_options(opt)
    opt['is_train'] = False
    make_exp_dirs(opt)
    logger = get_root_logger(log_file=osp.join(
        opt['path']['log'], f"test_{opt['name']}_{get_time_str()}.log"))
    logger.info(f'torch {torch.__version__}, CUDA {torch.version.cuda}')
    logger.info(json.dumps(opt, indent=1))

    test_loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        dataset_opt.setdefault('manual_seed', opt.get('manual_seed', 0))
        if opt['network_g'].get('blind', False):
            dataset_opt['blind'] = True
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt))
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--opt', required=True,
                        help='JSON file of the parsed test options')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    print(json.dumps(test_pipeline(args.opt, device=args.device)))


if __name__ == '__main__':
    main()
