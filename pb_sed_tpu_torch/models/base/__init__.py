from pb_sed_tpu_torch.models.base.model import SoundEventModel  # noqa: F401
from pb_sed_tpu_torch.models.base.inference import (  # noqa: F401
    boundaries_detection, inference, filtering, scores_to_dataframes,
    sound_event_detection, tagging)
from pb_sed_tpu_torch.models.base.pseudo_label import (  # noqa: F401
    pseudo_label)
from pb_sed_tpu_torch.models.base.tuning import (  # noqa: F401
    boundaries_from_events, f_collar, f_tag, psd_auc,
    tune_boundaries_detection, tune_sound_event_detection, tune_tagging,
    update_leaderboard)
