"""Lightweight energy/emissions tracking (codecarbon-surface parity).

Counterpart of ``pb_sed_tpu/train/emissions.py``: the reference wraps
tuning, inference and training in codecarbon's ``EmissionsTracker``; this
one has the same start/stop API and appends to ``emissions.csv`` the JAX
package's estimate, wall clock x a board power per platform, in its
``*_estimated`` columns. The platform is read from torch: ``gpu`` with
the CUDA cards torch sees, else ``cpu``. Nothing here reads a power
counter.
"""
import csv
import time
from pathlib import Path

import torch

# rough board powers (W) for the energy estimate (the JAX package's)
_TDP_BY_PLATFORM = {'tpu': 200., 'gpu': 300., 'cpu': 50.}


def _platform():
    """(platform, number of devices) as torch sees them."""
    if torch.cuda.is_available():
        return 'gpu', torch.cuda.device_count()
    return 'cpu', 1


class EmissionsTracker:
    def __init__(self, output_dir, on_csv_write='update',
                 carbon_intensity_g_per_kwh=450.):
        self.output_dir = Path(output_dir)
        self.carbon_intensity = carbon_intensity_g_per_kwh
        self.start_time = None
        self.on_csv_write = on_csv_write

    def start(self):
        self.start_time = time.time()

    def __enter__(self):
        self.start()
        return self

    def stop(self):
        if self.start_time is None:
            return None
        duration = time.time() - self.start_time
        platform, n = _platform()
        tdp = _TDP_BY_PLATFORM.get(platform, 100.)
        energy_kwh = tdp * n * duration / 3600. / 1000.
        emissions_kg = energy_kwh * self.carbon_intensity / 1000.
        self._write(duration, energy_kwh, emissions_kg, platform, n)
        self.start_time = None
        return emissions_kg

    def __exit__(self, *exc):
        self.stop()

    def _write(self, duration, energy_kwh, emissions_kg, platform, n):
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / 'emissions.csv'
        new = not path.exists()
        with path.open('a', newline='') as fid:
            writer = csv.writer(fid)
            if new:
                # *_estimated: wall-clock x TDP guess, NOT a measured
                # power draw — do not compare against metered numbers
                writer.writerow([
                    'timestamp', 'duration_s', 'platform', 'num_devices',
                    'energy_kwh_estimated', 'emissions_kg_estimated'])
            writer.writerow([
                time.strftime('%Y-%m-%dT%H:%M:%S'), f'{duration:.1f}',
                platform, n, f'{energy_kwh:.6f}', f'{emissions_kg:.6f}'])
