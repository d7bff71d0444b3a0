"""The published pretrained checkpoints into
``experiments/pretrained_models/<method>/`` (counterpart of the JAX
repo's scripts/download_pretrained_models.py, BasicSR's, with the BSVD
README's checkpoint table).

    python -m bsvd_tpu_torch.scripts.download_pretrained_models BSVD [--yes]

BSVD's checkpoints are OneDrive share links (the reference README); a
source may also be ('gdrive', file_id). An existing file is asked about
(Y/N) unless ``--yes``. Needs the network; without it
``utils/download_util`` raises OSError. The ``.pth`` files load into the
port directly (``convert.torch_ckpt.load_tsn_state_dict``).
"""

import argparse
import os
from os import path as osp

from bsvd_tpu_torch.utils.download_util import (
    download_file_from_google_drive, load_file_from_url)

# method -> {file name: a URL, or ('gdrive', file id)}
SOURCES = {
    'BSVD': {
        'bsvd-64.pth': ('https://hkustconnect-my.sharepoint.com/:f:/g/'
                        'personal/cqiaa_connect_ust_hk/'
                        'Em-latu2Zm1MpPoxstOmpCQBzNTkyGVqdUEODK3oxcz6eA'
                        '?download=1'),
        'bsvd-64-blind.pth': ('https://hkustconnect-my.sharepoint.com/:f:/g/'
                              'personal/cqiaa_connect_ust_hk/'
                              'EkmrwTvtKYlLha2G1-8XIskBXOwWt33YUy7rl2yXnj-maw'
                              '?download=1'),
        'bsvd-64-unidirection.pth': (
            'https://hkustconnect-my.sharepoint.com/:f:/g/personal/'
            'cqiaa_connect_ust_hk/'
            'EtJVxVxBDSBDv5qOvRfM9xcBjkpPLbl4sfhBzpIPAWVMiw'
            '?download=1'),
    },
}


def download_pretrained_models(method, sources, assume_yes=False):
    save_path_root = f'./experiments/pretrained_models/{method}'
    os.makedirs(save_path_root, exist_ok=True)
    for file_name, src in sources.items():
        save_path = osp.abspath(osp.join(save_path_root, file_name))
        if osp.exists(save_path):
            if not assume_yes:
                resp = input(f'{file_name} already exists. Overwrite? Y/N\n')
                if resp.lower() != 'y':
                    print(f'Skipping {file_name}')
                    continue
            os.remove(save_path)
        print(f'Downloading {file_name} to {save_path}')
        if isinstance(src, tuple) and src[0] == 'gdrive':
            download_file_from_google_drive(src[1], save_path)
        else:
            load_file_from_url(src, model_dir=save_path_root,
                               file_name=file_name)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('method', type=str,
                        help=f"one of {sorted(SOURCES)} or 'all'")
    parser.add_argument('--yes', action='store_true')
    args = parser.parse_args(argv)
    methods = sorted(SOURCES) if args.method == 'all' else [args.method]
    for m in methods:
        download_pretrained_models(m, SOURCES[m], assume_yes=args.yes)


if __name__ == '__main__':
    main()
