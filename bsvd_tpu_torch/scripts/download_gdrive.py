"""One Google Drive file by id (counterpart of the JAX repo's
scripts/download_gdrive.py, BasicSR's).

    python -m bsvd_tpu_torch.scripts.download_gdrive --id <file_id> \\
        --output <save_path>

Needs the network; without it ``utils/download_util`` raises OSError.
"""

import argparse

from bsvd_tpu_torch.utils.download_util import \
    download_file_from_google_drive


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--id', type=str, required=True, help='File id')
    parser.add_argument('--output', type=str, required=True, help='Save path')
    args = parser.parse_args(argv)
    download_file_from_google_drive(args.id, args.output)


if __name__ == '__main__':
    main()
