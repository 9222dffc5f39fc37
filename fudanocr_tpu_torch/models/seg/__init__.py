from fudanocr_tpu_torch.core.registry import BACKBONES, HEADS, SEGMENTORS
from fudanocr_tpu_torch.models.seg.cascade_mit import CascadeMiT  # noqa: F401
from fudanocr_tpu_torch.models.seg.det_guided import (  # noqa: F401
    CascadeMiTDetGuided, instance_labels)
from fudanocr_tpu_torch.models.seg.encoder_decoder import (  # noqa: F401
    CascadeEncoderDecoder, DetGuidedEncoderDecoder, EncoderDecoder,
    slide_inference, tta_inference)
from fudanocr_tpu_torch.models.seg.segformer_head import (  # noqa: F401
    SegformerHead)

# the JAX package's registrations (fudanocr_tpu/models/seg/__init__.py)
BACKBONES.register("CascadeMiT")(CascadeMiT)
BACKBONES.register("CascadeMiTDetGuided")(CascadeMiTDetGuided)
HEADS.register("SegformerHead")(SegformerHead)
SEGMENTORS.register("EncoderDecoder")(EncoderDecoder)
SEGMENTORS.register("CascadeEncoderDecoder")(CascadeEncoderDecoder)
SEGMENTORS.register("DetGuidedEncoderDecoder")(DetGuidedEncoderDecoder)
