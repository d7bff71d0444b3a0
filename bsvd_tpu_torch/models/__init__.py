"""The port's train / eval engines; importing the package registers
DenoisingModel, SRModel, SRGANModel, ESRGANModel and VideoRecurrentModel
in MODEL_REGISTRY (``base_model.build_model`` makes one from the
options)."""

from bsvd_tpu_torch.models import (denoising_model, sr_model,  # noqa: F401
                                   srgan_model, video_recurrent_model)
