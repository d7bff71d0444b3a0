"""REDS's val clips merged into its train folder, val clip i as 240 + i,
so the datasets hold out the official val split by index (counterpart
of the JAX repo's scripts/data_preparation/regroup_reds_dataset.py,
BasicSR's).

    python -m bsvd_tpu_torch.scripts.data_preparation.regroup_reds_dataset \\
        --train datasets/REDS/train_sharp --val datasets/REDS/val_sharp
"""

import argparse
import glob
import os
import shutil


def regroup_reds_dataset(train_path, val_path):
    val_folders = sorted(glob.glob(os.path.join(val_path, '*')))
    for folder in val_folders:
        dst = os.path.join(train_path,
                           str(int(os.path.basename(folder)) + 240))
        print(f'{folder} -> {dst}')
        shutil.copytree(folder, dst, dirs_exist_ok=True)
    print(f'moved {len(val_folders)} val clips into {train_path}')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--train', required=True)
    ap.add_argument('--val', required=True)
    a = ap.parse_args(argv)
    regroup_reds_dataset(a.train, a.val)


if __name__ == '__main__':
    main()
