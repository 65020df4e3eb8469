"""Storage roots resolved from environment variables.

Capability parity with the reference's path module
(``pb_sed/paths.py:4-6``): ``storage_root`` and ``database_jsons_dir``
come from the ``STORAGE_ROOT`` / ``DATABASE_JSONS_DIR`` environment
variables with in-repo defaults.
"""
import os
from pathlib import Path

pkg_dir = Path(__file__).resolve().parent
repo_dir = pkg_dir.parent

storage_root = Path(os.environ.get('STORAGE_ROOT', repo_dir / 'exp')).expanduser()
database_jsons_dir = Path(
    os.environ.get('DATABASE_JSONS_DIR', repo_dir / 'jsons')
).expanduser()
