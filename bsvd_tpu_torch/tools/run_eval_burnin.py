"""The eval protocol at its full size on the card: the reference's
integration test (``run_test.py -opt bsvd_c64.yml``, reference
README.md:65-71) on Set8- and DAVIS-shaped synthetic folders
(counterpart of the JAX repo's tools/run_eval_burnin.py).

    python -m bsvd_tpu_torch.tools.run_eval_burnin [--root DIR]
        [--set8-clips 8] [--davis-clips 8] [--frames 85] [--save-img]
        [--only set8|davis] [--sigmas 10 20 30 40 50] [--format png|tif]
        [--device cpu]

Writes (where missing) Set8-shaped (960 x 540) and DAVIS-480p-shaped (854
x 480) folders of ``--frames`` frames with ``make_synth_dataset``, then the
JAX tool's option file (``YML_TMPL``, one ``BLOCK`` a family and sigma:
whole-clip bf16 inference, padding to 64, PSNR / psnr_float / SSIM,
per-scene CSVs, the frames saved with ``--save-img``), and runs
``test.test_pipeline`` on it. The net has random weights (the real
``bsvd-64.pth`` is not in the repository), so the metrics say nothing of
quality: what this times is the harness at the protocol's size.

Prints one JSON line: ``wall_s``, ``frames_total``, ``ms_per_frame_e2e``,
per block its metrics and ``s_per_clip`` (read, denoise, metrics, save:
the host seconds of its validation over its clips), and
``peak_allocated_gb``.
"""

import argparse
import os
import sys
import time

import torch

from bsvd_tpu_torch.models.denoising_model import DenoisingModel
from bsvd_tpu_torch.test import test_pipeline
from bsvd_tpu_torch.tools import _common as c
from bsvd_tpu_torch.tools.make_synth_dataset import write

YML_TMPL = """\
name: bsvd_c64_burnin
model_type: DenoisingModel
num_gpu: auto
manual_seed: 10

datasets:
{datasets}

network_g:
  type: BSVD
  chns: [{chns}]
  mid_ch: {mid_ch}
  shift_input: False
  norm: 'none'
  interm_ch: {interm_ch}
  act: 'relu6'
  pretrain_ckpt: ~

path:
  pretrain_network_g: ~
  strict_load_g: true
  resume_state: ~

val:
  val_freq: !!float 1e0
  save_img: {save_img}
  temp_psz: -1
  future_buffer_len: 0
  patch_mod: 64
  fp16: True

  metrics:
    psnr:
      type: calculate_psnr
      crop_border: 2
      test_y_channel: false
    psnr_float:
      type: calculate_psnr_float
      crop_border: 2
      test_y_channel: false
    ssim:
      type: calculate_ssim
      crop_border: 2
      test_y_channel: false

logger:
  print_freq: 100
  save_checkpoint_freq: !!float 5e3
  use_tb_logger: false
"""

BLOCK = """\
  val_{key}:
    name: {name}
    type: ValFolderDataset
    valsetdir: {dir}
    num_validation_frames: {frames}
    valnoisestd: {sigma}
"""

FAMILIES = (('set8', 'Set8', 540, 960), ('davis', 'DAVIS', 480, 854))


def ensure_data(args):
    """The two families' folders, written where a folder lacks its last
    frame."""
    dirs = {}
    for key, name, h, w in FAMILIES:
        if args.only not in (None, key):
            continue
        d = os.path.join(args.root, f'{name}_{args.format}')
        clips = args.set8_clips if key == 'set8' else args.davis_clips
        probe = os.path.join(d, 'clip00', f'{args.frames - 1:05d}.'
                             f'{args.format}')
        if not os.path.exists(probe):
            write(d, num_clips=clips, t=args.frames, h=args.height or h,
                  w=args.width or w, seed=sum(map(ord, name)) % 1000,
                  fmt=args.format)
        dirs[key] = (name, d, clips)
    return dirs


class ValSeconds:
    """Each validation's ``val_seconds`` (read, denoise, metrics, save)
    while the pipeline runs, by dataset name."""

    def __enter__(self):
        self.orig, self.runs = DenoisingModel.nondist_validation, {}
        spy = self

        def run(model, dataloader, *a, **k):
            out = spy.orig(model, dataloader, *a, **k)
            spy.runs[dataloader.dataset.opt['name']] = dict(
                model.val_seconds)
            return out
        DenoisingModel.nondist_validation = run
        return self

    def __exit__(self, *exc):
        DenoisingModel.nondist_validation = self.orig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    ap.add_argument('--root', default=None,
                    help='data and results folder (a temporary one by '
                         'default)')
    ap.add_argument('--set8-clips', type=int, default=8)
    ap.add_argument('--davis-clips', type=int, default=8)
    ap.add_argument('--frames', type=int, default=85)
    ap.add_argument('--save-img', action='store_true')
    ap.add_argument('--only', choices=['set8', 'davis'])
    ap.add_argument('--sigmas', type=int, nargs='+',
                    default=[10, 20, 30, 40, 50])
    ap.add_argument('--format', default='png', choices=['png', 'tif'])
    ap.add_argument('--chns', default='64, 128, 256')
    ap.add_argument('--mid_ch', type=int, default=64)
    ap.add_argument('--interm_ch', type=int, default=64)
    ap.add_argument('--height', type=int, default=None,
                    help="every family's frame height (its own by default)")
    ap.add_argument('--width', type=int, default=None)
    args = ap.parse_args(argv)
    device, _ = c.setup(args)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        args.root = args.root or tmp
        return _run(args, device)


def _run(args, device):
    dirs = ensure_data(args)
    blocks = []
    for sigma in args.sigmas:
        for key, (name, d, _) in dirs.items():
            blocks.append(BLOCK.format(key=f'{key[0]}{sigma}',
                                       name=f'{name}_{sigma}', dir=d,
                                       frames=args.frames, sigma=sigma))
    yml = YML_TMPL.format(datasets=''.join(blocks),
                          save_img=str(bool(args.save_img)).lower(),
                          chns=args.chns, mid_ch=args.mid_ch,
                          interm_ch=args.interm_ch)
    opt_path = os.path.join(args.root, 'bsvd_c64_burnin.yml')
    with open(opt_path, 'w') as f:
        f.write(yml)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    before = c.launches()
    t0 = time.perf_counter()
    with ValSeconds() as spy:
        results = test_pipeline(args.root, cmd=['-opt', opt_path,
                                                '--device', device.type])
    wall = time.perf_counter() - t0
    clips = {f'{name}_{s}': n for s in args.sigmas
             for name, _, n in dirs.values()}
    frames_total = args.frames * sum(clips.values())
    return c.emit('run_eval_burnin', device, {
        'format': args.format, 'frames': args.frames, 'wall_s': wall,
        'blocks': len(results), 'frames_total': frames_total,
        'ms_per_frame_e2e': wall / frames_total * 1e3,
        'launches': c.launches_since(before),
        'results': {k: {m: float(x) for m, x in v.items()}
                    for k, v in results.items()},
        's_per_clip': {k: {part: s / clips[k] for part, s in v.items()}
                       for k, v in spy.runs.items()},
        'peak_allocated_gb': (torch.cuda.max_memory_allocated() / 1e9
                              if device.type == 'cuda' else None)})


if __name__ == '__main__':
    main(sys.argv[1:])
