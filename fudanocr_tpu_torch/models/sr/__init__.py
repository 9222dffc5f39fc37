from fudanocr_tpu_torch.models.sr.tbsrn import TBSRN  # noqa: F401
