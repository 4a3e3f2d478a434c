"""Hand-written CUDA kernels (``csrc/*.cu``), their wrappers and plain torch versions.

Counterpart of ``imageprocessingtools_tpu/kernels`` (the Pallas kernels).
``TooLarge`` is the wrappers' refusal of a tensor that one launch cannot take.
"""

from imageprocessingtools_tpu_torch.kernels._build import TooLarge  # noqa: F401
