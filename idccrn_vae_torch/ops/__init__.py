"""Tensor ops of the port (cpack layouts, torch weight layouts).

The JAX package's `ops` exports its functions `stft` and `lstm` under
the names of their modules, which shadows the modules. Here
`idccrn_vae_torch.ops.stft` and `idccrn_vae_torch.ops.lstm` stay the
modules; the functions are `ops.stft.stft` and `ops.lstm.lstm`.
"""

from idccrn_vae_torch.ops.complex import (  # noqa: F401
    cpack,
    creal,
    cimag,
    csplit,
    pair_to_cpack,
    cpack_to_pair,
)
from idccrn_vae_torch.ops.stft import istft, hann_window  # noqa: F401
from idccrn_vae_torch.ops.conv import (  # noqa: F401
    complex_conv2d,
    complex_conv_transpose2d,
)
from idccrn_vae_torch.ops.dense import complex_dense  # noqa: F401
from idccrn_vae_torch.ops.lstm import complex_lstm  # noqa: F401
from idccrn_vae_torch.ops.batchnorm import complex_batch_norm  # noqa: F401
