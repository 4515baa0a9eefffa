"""The introspection FCN (MobileNetV2-dilated + C1-DeepSup), its model zoo
of encoders and decoders, the loaders of their weights, and TorchScript
export of the cost-map inference."""

from .convert import convert_checkpoint, from_jax_variables  # noqa: F401
from .introspection import (  # noqa: F401
    C1DeepSup,
    IntrospectionNet,
    inference_cost_map,
    normalize_image,
    predict,
)
from .layers import BatchNorm2d, flax_init_, set_process_group  # noqa: F401
from .mobilenet import ConvBN, InvertedResidual, MobileNetV2Dilated  # noqa: F401
from .zoo import (  # noqa: F401
    ENCODER_FC_DIM,
    HRNetV2,
    ResNetEncoder,
    SegmentationModel,
    UPerNet,
    build_decoder,
    build_encoder,
    encoder_channels,
)
