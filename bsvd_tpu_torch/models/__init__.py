"""The port's train / eval engines; importing the package registers
DenoisingModel, SRModel, SRGANModel, ESRGANModel, VideoRecurrentModel,
VideoBaseModel, EDVRModel, VideoGANModel, VideoRecurrentGANModel,
HiFaceGANModel, StyleGAN2Model and SwinIRModel in MODEL_REGISTRY
(``base_model.build_model`` makes one from the options)."""

from bsvd_tpu_torch.models import (denoising_model,  # noqa: F401
                                   hifacegan_model, sr_model, srgan_model,
                                   stylegan2_model, video_base_model,
                                   video_gan_model, video_recurrent_model)
