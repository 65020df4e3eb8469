"""DESED database handle (reference ``database/desed/database.py:6-8``)."""
from pb_sed_tpu_torch.data.lazy import JsonDatabase
from pb_sed_tpu_torch.paths import database_jsons_dir


class DESED(JsonDatabase):
    def __init__(self, json_path=database_jsons_dir / 'desed.json'):
        super().__init__(json_path=json_path)
