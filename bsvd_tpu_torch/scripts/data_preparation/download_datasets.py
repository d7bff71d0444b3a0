"""The SR evaluation sets Set5 / Set14 from Google Drive, unpacked under
``./datasets/`` (counterpart of the JAX repo's scripts/data_preparation/
download_datasets.py, BasicSR's).

    python -m bsvd_tpu_torch.scripts.data_preparation.download_datasets Set5
    python -m bsvd_tpu_torch.scripts.data_preparation.download_datasets all

An archive that exists is asked about (Y/N). Each ``<name>.zip`` is
extracted into ``<name>/``, and a single folder of the archive's own
name inside it is flattened into it. Needs the network; without it
``utils/download_util`` raises OSError.
"""

import argparse
import glob
import os
import shutil
import zipfile
from os import path as osp

from bsvd_tpu_torch.utils.download_util import \
    download_file_from_google_drive

# dataset -> {archive name: Google Drive file id}
FILE_IDS = {
    'Set5': {'Set5.zip': '1RtyIeUFTyW8u7oa4z7a0lSzT3T1FwZE9'},
    'Set14': {'Set14.zip': '1vsw07sV8wGrRQ8UARe2fO5jjgy9QJy_E'},
}


def _unzip(archive_path):
    extracted = archive_path[:-len('.zip')]
    print(f'Extract {archive_path} to {extracted}')
    with zipfile.ZipFile(archive_path, 'r') as zf:
        zf.extractall(extracted)
    nested = osp.join(extracted, osp.basename(extracted))
    if osp.isdir(nested):
        print(f'Move {nested} to {extracted}')
        for path in glob.glob(osp.join(nested, '*')):
            shutil.move(path, extracted)
        shutil.rmtree(nested)


def download_dataset(dataset, save_root='./datasets/', overwrite=None):
    """Every archive of ``dataset``; ``overwrite`` None asks (Y/N),
    True / False answers."""
    os.makedirs(save_root, exist_ok=True)
    for file_name, file_id in FILE_IDS[dataset].items():
        save_path = osp.abspath(osp.join(save_root, file_name))
        if osp.exists(save_path):
            cover = overwrite
            if cover is None:
                ans = input(f'{file_name} already exists. Cover it? Y/N\n')
                if ans.lower() not in ('y', 'n'):
                    raise ValueError('Wrong input. Only accepts Y/N.')
                cover = ans.lower() == 'y'
            if not cover:
                print(f'Skipping {file_name}')
                continue
            print(f'Covering {file_name} at {save_path}')
        else:
            print(f'Downloading {file_name} to {save_path}')
        download_file_from_google_drive(file_id, save_path)
        if save_path.endswith('.zip'):
            _unzip(save_path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        'dataset', type=str,
        help="Options: 'Set5', 'Set14', or 'all' for everything.")
    args = parser.parse_args(argv)
    names = list(FILE_IDS) if args.dataset == 'all' else [args.dataset]
    for name in names:
        download_dataset(name)


if __name__ == '__main__':
    main()
