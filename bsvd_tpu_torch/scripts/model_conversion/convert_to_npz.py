"""A torch ``.pth`` checkpoint into the ``.npz`` the JAX repo's
scripts/model_conversion/convert_to_npz.py writes: keys ``params/<flat/
path>`` of the JAX package's tree (HWIO convs, (I, O) linears; the
layout of ``bsvd_tpu/models/checkpoint.py``), which both packages load.

Generic nets (a ``network_g`` dict of a registered arch; the file's
entries under ``--param_key`` loaded into it by
``convert.torch_generic.load_torch_generic``, every parameter of the
arch required, then its tree by ``to_jax_tree``):

    python -m bsvd_tpu_torch.scripts.model_conversion.convert_to_npz \\
        --arch "{'type': 'RRDBNet', 'num_feat': 64, 'num_block': 23}" \\
        --input ESRGAN_x4.pth --output esrgan_x4.npz [--param_key params]

BSVD / TSN denoisers (the reference's TSN key layout, through
``convert.torch_ckpt.load_tsn_state_dict`` and ``to_jax_params``; the
net's configuration from ``--arch``, by default the ``network_g`` of
options/test/bsvd_c64.yml, the published bsvd-64's):

    python -m bsvd_tpu_torch.scripts.model_conversion.convert_to_npz --tsn \\
        --input bsvd-64.pth --output bsvd-64.npz

Everything runs on the CPU.
"""

import argparse
import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BSVD_C64_YML = os.path.join(ROOT, 'options', 'test', 'bsvd_c64.yml')


def tsn_arch():
    """options/test/bsvd_c64.yml's network_g, without its checkpoint."""
    from bsvd_tpu_torch.utils.options import yaml_load
    arch = dict(yaml_load(BSVD_C64_YML)['network_g'])
    arch.pop('pretrain_ckpt', None)
    return arch


def convert(input_path, arch=None, tsn=False, param_key='params'):
    """The JAX package's parameter tree (numpy leaves) of a ``.pth``."""
    from bsvd_tpu_torch.archs import build_network
    if tsn:
        from bsvd_tpu_torch.convert.torch_ckpt import (load_tsn_state_dict,
                                                       to_jax_params)
        cfg = build_network(arch or tsn_arch(), device='cpu').cfg
        return to_jax_params(load_tsn_state_dict(input_path, cfg,
                                                 param_key), cfg)
    from bsvd_tpu_torch.convert.torch_generic import (load_torch_generic,
                                                      to_jax_tree)
    net = build_network(arch, device='cpu')
    return to_jax_tree(load_torch_generic(input_path, net, param_key))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--input', required=True, help='torch .pth checkpoint')
    ap.add_argument('--output', required=True, help='output .npz path')
    ap.add_argument('--param_key', default='params',
                    help='key inside the .pth (params | params_ema | ...)')
    ap.add_argument('--arch', default=None,
                    help="a network_g dict, e.g. \"{'type': 'EDSR'}\"")
    ap.add_argument('--tsn', action='store_true',
                    help='use the BSVD/TSN-specific converter')
    a = ap.parse_args(argv)
    if not a.tsn and not a.arch:
        ap.error('--arch is required unless --tsn is set')
    from bsvd_tpu_torch.models.checkpoint import save_npz_params
    arch = ast.literal_eval(a.arch) if a.arch else None
    save_npz_params(a.output, {'params': convert(a.input, arch, a.tsn,
                                                 a.param_key)})
    print(f'wrote {a.output} (param key: params)')


if __name__ == '__main__':
    main()
