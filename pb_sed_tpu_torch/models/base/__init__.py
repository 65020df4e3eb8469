from pb_sed_tpu_torch.models.base.inference import (  # noqa: F401
    boundaries_detection, inference, sound_event_detection, tagging)
from pb_sed_tpu_torch.models.base.model import SoundEventModel  # noqa: F401
