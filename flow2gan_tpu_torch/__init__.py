"""PyTorch / CUDA port of flow2gan_tpu for NVIDIA Hopper.

The JAX package `flow2gan_tpu` is the reference; this package imports none
of it. Entry point: `get_model(...)` -> `VocoderModel.infer/mel/reconstruct`.
"""

from flow2gan_tpu_torch.api import VocoderModel, get_model  # noqa: F401
