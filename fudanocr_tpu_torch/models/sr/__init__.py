from fudanocr_tpu_torch.models.sr.baselines import (  # noqa: F401
    EDSR, RDN, SRCNN, RRDBNet, SRDiscriminator, SRResNet, build_baseline)
from fudanocr_tpu_torch.models.sr.tbsrn import TBSRN  # noqa: F401
from fudanocr_tpu_torch.models.sr.tsrn import TSRN  # noqa: F401
