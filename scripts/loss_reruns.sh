#!/bin/bash
# Whether the weak training CLI's losses move between two runs of one
# seed: each package's CLI (JAX and the port, device=cpu) runs twice on one
# synthetic database (tests/util_synth.py) with the tiny overrides of
# scripts/verify_chain.sh, the loader's threads on (prefetch_workers=2),
# and the logged loss of every step of each run is printed.
# Usage: scripts/loss_reruns.sh [workdir] [override ...]
#   e.g. data_provider.train_fetcher.prefetch_workers=0 (no threads), or
#   data_provider.epoch_shuffle_seed=0 (a seeded shuffle)
set -e
V=${1:-$(mktemp -d /tmp/loss_reruns.XXXX)}
shift || true
cd "$(dirname "$0")/.."
if [ ! -f "$V/db/db.json" ]; then
python - <<EOF2
import sys; sys.path.insert(0, 'tests')
from util_synth import build_database
build_database("$V/db")
EOF2
fi
export DATABASE_JSONS_DIR=$V/db
ARGS=(device=cpu debug=True batch_size=4 num_iterations=8 checkpoint_interval=8
  summary_interval=1 lr_rampup_steps=2 'lr_decay_steps=[]' validation_set_name=None
  data_provider.json_path=$V/db/db.json
  data_provider.train_set.train_weak=1 data_provider.train_set.train_strong=1
  data_provider.train_set.train_synthetic20=0 data_provider.train_set.train_synthetic21=0
  data_provider.train_set.train_unlabel_in_domain=0
  data_provider.cached_datasets=None data_provider.min_audio_length=0.2
  data_provider.mix_interval=None
  data_provider.train_fetcher.batch_size=4 data_provider.train_fetcher.prefetch_workers=2
  data_provider.train_fetcher.pad_to_multiple=16
  data_provider.train_fetcher.min_label_diversity_in_batch=0
  data_provider.train_fetcher.min_dataset_examples_in_batch=None
  data_provider.test_fetcher.batch_size=4 data_provider.test_fetcher.prefetch_workers=0
  data_provider.train_transform.stft.shift=160
  data_provider.train_transform.stft.window_length=480
  data_provider.train_transform.stft.size=512
  data_provider.train_transform.anchor_sampling_fn=None
  data_provider.train_transform.anchor_shift_sampling_fn=None
  trainer.model.feature_extractor.stft_size=512
  trainer.model.feature_extractor.stft_shift=160
  trainer.model.feature_extractor.stft_window_length=480
  trainer.model.feature_extractor.number_of_filters=16
  'trainer.model.cnn.cnn_2d.out_channels=[16,16]'
  'trainer.model.cnn.cnn_2d.pool_size=[[2,1],[2,1]]'
  trainer.model.cnn.cnn_2d.kernel_size=3
  'trainer.model.cnn.cnn_1d.out_channels=[8,8]'
  trainer.model.cnn.cnn_1d.kernel_size=3
  trainer.model.rnn_fwd.rnn.hidden_size=8 trainer.model.rnn_fwd.rnn.num_layers=1
  'trainer.model.rnn_fwd.output_net.out_channels=[8,3]'
  trainer.model.rnn_fwd.output_net.kernel_size=1)
for pkg in pb_sed_tpu_torch pb_sed_tpu; do
  for run in 1 2; do
    root=$V/storage_${pkg}_$run
    rm -rf "$root"
    STORAGE_ROOT=$root JAX_PLATFORMS=cpu python -m $pkg.experiments.weak_label_crnn.training \
      with "${ARGS[@]}" "$@" > "$V/log_${pkg}_$run.txt" 2>&1
    python - "$root" "$pkg" "$run" <<'EOF2'
import json, sys
from pathlib import Path
(summary,) = Path(sys.argv[1]).rglob('summary.jsonl')
losses = [round(json.loads(line)['loss'], 6)
          for line in summary.read_text().splitlines() if 'loss' in line]
print(sys.argv[2], 'run', sys.argv[3], 'losses', losses)
EOF2
  done
done
