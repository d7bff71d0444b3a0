"""The training loop (counterpart of bsvd_tpu/train.py train_pipeline's
iteration loop): feed, step, log, periodic save, auto-resume.

It runs over an options dict (``bsvd_tpu.utils.options.parse_options`` of
a train YAML, parsed where PyYAML exists) and any iterable of batches
(dicts of numpy or tensor ``lq`` / ``gt`` / ``noise_map``), for example
``data.video_train_loader.SyntheticVideoLoader``. Validation during
training raises until the eval protocol is ported.

    model = train_pipeline(opt, loader, device='cuda')
"""

import copy
import logging
import os
import time

from bsvd_tpu_torch.models.base_model import check_resume, latest_resume_state
from bsvd_tpu_torch.models.checkpoint import load_training_state
from bsvd_tpu_torch.models.denoising_model import build_model

_log = logging.getLogger('bsvd_tpu_torch')


def load_resume_state(opt):
    """The training state to resume from (``auto_resume``: the latest in
    path.training_states; else path.resume_state), with the networks'
    pretrain paths pointed at its checkpoint; None to start afresh."""
    path = None
    if opt.get('auto_resume'):
        path = latest_resume_state(opt['path']['training_states'])
        if path:
            opt['path']['resume_state'] = path
    elif opt['path'].get('resume_state'):
        path = opt['path']['resume_state']
    if path is None:
        return None
    state = load_training_state(path)
    check_resume(opt, state['iter'])
    return state


def train_pipeline(opt, train_loader, device=None):
    """Train for ``opt['train']['total_iter']`` iterations over
    ``train_loader`` (re-iterated per epoch); returns the model."""
    if (opt.get('val') or {}).get('val_freq'):
        raise NotImplementedError('validation during training waits for the '
                                  'eval protocol (ROADMAP.md Queue 1 item 4)')
    opt = copy.deepcopy(opt)
    opt['is_train'] = True
    for key in ('models', 'training_states'):
        os.makedirs(opt['path'][key], exist_ok=True)
    resume_state = load_resume_state(opt)
    model = build_model(opt, device=device)
    epoch, current_iter = 0, 0
    if resume_state is not None:
        model.resume_training(resume_state)
        epoch, current_iter = resume_state['epoch'], resume_state['iter']
        _log.info(f'Resuming training from epoch {epoch}, iter '
                  f'{current_iter}.')

    total_iters = int(opt['train']['total_iter'])
    print_freq = int(opt['logger']['print_freq'])
    save_freq = int(opt['logger']['save_checkpoint_freq'])
    start = time.time()
    while current_iter < total_iters:
        fed = False
        for data in train_loader:
            if current_iter >= total_iters:
                break
            current_iter += 1
            fed = True
            model.feed_data(data)
            model.optimize_parameters(current_iter)
            if current_iter % print_freq == 0:
                logs = ', '.join(f'{k}: {v:.4e}' for k, v in
                                 model.get_current_log().items())
                _log.info(f'[epoch {epoch}, iter {current_iter}, lr '
                          f'{model.get_current_learning_rate()[0]:.3e}] '
                          f'{logs}')
            if current_iter % save_freq == 0:
                model.save(epoch, current_iter)
        if not fed:
            raise ValueError('the train loader yielded no batch')
        epoch += 1
    _log.info(f'End of training: {time.time() - start:.1f} s.')
    model.save(epoch=-1, current_iter=-1)
    return model
