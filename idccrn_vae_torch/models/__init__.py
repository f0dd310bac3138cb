"""Model modules of the port, under the reference's state_dict names."""

from idccrn_vae_torch.models.config import (  # noqa: F401
    StftConfig,
    DccrnConfig,
    encoder_plan,
    decoder_plan,
    bottleneck_dims,
)
from idccrn_vae_torch.models.reparam import CGauss, reparameterize  # noqa: F401
from idccrn_vae_torch.models.vae import VaeEncoder, VaeDecoder  # noqa: F401
from idccrn_vae_torch.models.nsvae import NsvaeEncoder  # noqa: F401
from idccrn_vae_torch.models.dccrn import SupervisedDccrn  # noqa: F401
from idccrn_vae_torch.models.discriminator import Discriminator  # noqa: F401
