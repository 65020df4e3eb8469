"""Models of the port: the SoundEventModel base, the inference engine, the
weak-label FBCRNN and the strong-label BiCRNN."""
from pb_sed_tpu_torch.models import (  # noqa: F401
    base, strong_label, weak_label)
from pb_sed_tpu_torch.models.weak_label.crnn import CRNN  # noqa: F401
