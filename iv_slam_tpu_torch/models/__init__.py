"""The introspection FCN (MobileNetV2-dilated + C1-DeepSup) for inference,
and the loaders of its weights."""

from .convert import convert_checkpoint, from_jax_variables  # noqa: F401
from .introspection import (  # noqa: F401
    C1DeepSup,
    IntrospectionNet,
    inference_cost_map,
    normalize_image,
    predict,
)
from .mobilenet import ConvBN, InvertedResidual, MobileNetV2Dilated  # noqa: F401
