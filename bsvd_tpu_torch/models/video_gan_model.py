"""The video GAN engines (counterpart of bsvd_tpu/models/video_gan_model.py,
BasicSR's video_gan_model and video_recurrent_gan_model), SRGANModel's
step on video:

- ``VideoGANModel``: an (N, T, C, H, W) window in, its centre frame out
  (an EDVR-style G), the adversarial loss on that frame; VideoBaseModel's
  feed and sliding-window validation;
- ``VideoRecurrentGANModel``: a clip in, a clip out (a BasicVSR-style G);
  the frames fold into the discriminator's batch, (N, T, ...) -> (N*T,
  ...), for G's and D's GAN losses; VideoRecurrentModel's feed and
  whole-clip validation. One Adam for G (no flow schedule), as in the
  JAX package.
"""

from bsvd_tpu_torch.models.srgan_model import SRGANModel
from bsvd_tpu_torch.models.video_base_model import VideoBaseModel
from bsvd_tpu_torch.models.video_recurrent_model import VideoRecurrentModel
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class VideoGANModel(SRGANModel):
    """Sliding-window video GAN."""

    feed_data = VideoBaseModel.feed_data
    nondist_validation = VideoBaseModel.nondist_validation


def _frames(x):
    """(N, T, C, H, W) -> (N*T, C, H, W); a 4D tensor passes as it is."""
    return x.flatten(0, 1) if x.ndim == 5 else x


@MODEL_REGISTRY.register()
class VideoRecurrentGANModel(SRGANModel):
    """Recurrent video GAN."""

    feed_data = VideoRecurrentModel.feed_data
    nondist_validation = VideoRecurrentModel.nondist_validation

    def _gan_g(self, fake, gt):
        return super()._gan_g(_frames(fake), _frames(gt))

    def _gan_d(self, fake, gt):
        return super()._gan_d(_frames(fake), _frames(gt))
