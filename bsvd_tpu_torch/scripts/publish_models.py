"""Checkpoints made ready for release (counterpart of the JAX repo's
scripts/publish_models.py, BasicSR's): each file renamed to
``<name>-<sha8>.<ext>`` (the first 8 hex digits of its SHA-256; a stale
trailing 8-hex-digit hash is replaced, a descriptive suffix such as
``bsvd-64`` kept), its keys checked for ``params`` / ``params_ema``, and
a ``.pth`` re-saved first in torch's legacy (not zip) format that old
torch versions read. ``.npz`` checkpoints get the rename and the check.

    python -m bsvd_tpu_torch.scripts.publish_models \\
        [--glob 'experiments/pretrained_models/*.pth'] [--yes]
"""

import argparse
import glob
import hashlib
import os
import re
from os import path as osp


def file_sha8(path):
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()[:8]


def check_keys(path, assume_yes=False):
    """Warn (and ask, unless ``assume_yes``) where a checkpoint has no
    ``params`` / ``params_ema``; a 'N' raises ValueError."""
    keys = None
    if path.endswith('.npz'):
        import numpy as np
        with np.load(path) as z:
            keys = set(k.split('/', 1)[0].split('.', 1)[0] for k in z.files)
            has = any(f == k or f.startswith((k + '.', k + '/'))
                      for f in z.files for k in ('params', 'params_ema'))
    else:
        import torch
        net = torch.load(path, map_location='cpu', weights_only=True)
        has = isinstance(net, dict) and ('params' in net
                                         or 'params_ema' in net)
    if not has:
        msg = (f'WARN: Model {osp.basename(path)} does not have '
               f'"params"/"params_ema" key (top-level: {keys}).')
        if assume_yes:
            print(msg + ' Continuing (--yes).')
        else:
            resp = input(msg + ' Do you still want to continue? Y/N\n')
            if resp.lower() != 'y':
                raise ValueError('Aborted; please fix the checkpoint keys.')


def convert_to_backward_compatible_models(paths):
    """Each zip-format ``.pth`` re-saved in the legacy format."""
    print('# Convert to backward compatible pth files ...')
    import torch
    for idx, path in enumerate(paths):
        if not path.endswith('.pth'):
            continue
        print(f'{idx+1:03d}: Processing {path}')
        if zipfile_format(path):
            net = torch.load(path, map_location='cpu', weights_only=True)
            print('\tConverting to compatible pth file...')
            torch.save(net, path, _use_new_zipfile_serialization=False)


def zipfile_format(path):
    """Whether torch wrote ``path`` in its zip format (torch >= 1.6's
    default): a zip archive starts with 'PK\\x03\\x04'."""
    with open(path, 'rb') as f:
        return f.read(4) == b'PK\x03\x04'


def update_sha(paths, assume_yes=False):
    """Each file renamed to ``<name>-<sha8>.<ext>``; returns the new
    paths."""
    print('# Update sha ...')
    renamed = []
    for idx, path in enumerate(paths):
        print(f'{idx+1:03d}: Processing {path}')
        check_keys(path, assume_yes)
        ext = osp.splitext(path)[1]
        sha = file_sha8(path)
        stem = osp.basename(path)[:-len(ext)]
        tail = stem.rsplit('-', 1)[-1] if '-' in stem else ''
        if re.fullmatch(r'[0-9a-f]{8}', tail):
            if tail == sha:
                renamed.append(path)
                continue
            final = path.rsplit('-', 1)[0] + f'-{sha}{ext}'
        else:
            final = path[:-len(ext)] + f'-{sha}{ext}'
        print(f'\tSave from {path} to {final}')
        os.replace(path, final)
        renamed.append(final)
    return renamed


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--glob',
                        default='experiments/pretrained_models/*.pth',
                        help='checkpoint glob (pth and/or npz)')
    parser.add_argument('--yes', action='store_true',
                        help='non-interactive: continue past key warnings')
    args = parser.parse_args(argv)
    paths = sorted(glob.glob(args.glob))
    if not paths:
        print(f'no checkpoints match {args.glob!r}')
        return []
    if any(p.endswith('.pth') for p in paths):
        convert_to_backward_compatible_models(paths)
    return update_sha(paths, assume_yes=args.yes)


if __name__ == '__main__':
    main()
