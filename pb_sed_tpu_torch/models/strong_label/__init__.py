from pb_sed_tpu_torch.models.strong_label.crnn import CRNN  # noqa: F401
