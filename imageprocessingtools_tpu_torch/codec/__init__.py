"""Host codec (counterpart of ``imageprocessingtools_tpu/codec``)."""

from imageprocessingtools_tpu_torch.codec.ppm import (  # noqa: F401
    PPMError,
    decode_ppm,
    decode_pnm,
    encode_ppm,
    read_ppm,
    read_pnm,
    write_ppm,
    FILETYPE_PPM,
    FILETYPE_PGM,
    FILETYPE_PBM,
)
