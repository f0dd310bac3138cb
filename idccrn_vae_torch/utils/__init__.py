"""Host utilities of the port."""

from idccrn_vae_torch.utils.config import IniConfig, load_ini  # noqa: F401
from idccrn_vae_torch.utils.logger import get_logger  # noqa: F401
