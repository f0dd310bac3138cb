"""Host-side audio I/O, file discovery, segment datasets and batch
loaders, corpus statistics files and the synthetic corpus (numpy/scipy)."""

from idccrn_vae_torch.data.audio_io import (  # noqa: F401
    read_wav,
    write_wav,
    resample,
)
from idccrn_vae_torch.data.segments import (  # noqa: F401
    build_segment_index,
    SegmentDataset,
)
from idccrn_vae_torch.data.loader import BatchLoader  # noqa: F401
