"""The grounding tokenizers and downsamplers; importing the package
registers every one of them."""

from gligen_tpu_torch.models.grounding import (  # noqa: F401
    downsamplers,
    keypoint,
    spatial,
    text,
    text_image,
)
