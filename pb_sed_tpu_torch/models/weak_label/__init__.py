from pb_sed_tpu_torch.models.weak_label.crnn import CRNN  # noqa: F401
