from fudanocr_tpu_torch.models.rec.crnn import CRNN  # noqa: F401
