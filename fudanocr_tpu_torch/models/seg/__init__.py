from fudanocr_tpu_torch.models.seg.cascade_mit import CascadeMiT  # noqa: F401
from fudanocr_tpu_torch.models.seg.det_guided import (  # noqa: F401
    CascadeMiTDetGuided, instance_labels)
from fudanocr_tpu_torch.models.seg.encoder_decoder import (  # noqa: F401
    DetGuidedEncoderDecoder, EncoderDecoder, slide_inference)
from fudanocr_tpu_torch.models.seg.segformer_head import (  # noqa: F401
    SegformerHead)
