#!/bin/bash
# End-to-end verify of the PyTorch port on the CPU: weak_label_crnn
# training -> tuning -> inference on a synthetic DB (the overrides of
# scripts/verify_chain.sh, with the port's conv widths in multiples of 16),
# then a weak inference run that pseudo-labels train_unlabel_in_domain and
# a strong_label_crnn training on those pseudo-labels -> strong tuning ->
# inference.
# Usage: [NPROC=N] scripts/verify_chain_torch.sh [workdir]
# With NPROC=N every stage runs under torchrun on N ranks (gloo on the
# CPU): data-parallel training over the ranks' fetcher shards, the
# ensemble engine over the ranks, rank 0 writing every file.
set -e
V=${1:-$(mktemp -d /tmp/verify_pbsed_torch.XXXX)}
cd "$(dirname "$0")/.."
if [ ! -f "$V/db/db.json" ]; then
python - <<EOF2
import sys; sys.path.insert(0, 'tests')
from util_synth import build_database
print(build_database("$V/db")[1])
EOF2
fi
export STORAGE_ROOT=$V/storage DATABASE_JSONS_DIR=$V/db
if [ -n "$NPROC" ]; then
  RUN=(torchrun --standalone --nproc-per-node "$NPROC")
else
  RUN=(python)
fi
DATA=(
  data_provider.cached_datasets=None data_provider.min_audio_length=0.2
  data_provider.mix_interval=None
  data_provider.train_fetcher.batch_size=4 data_provider.train_fetcher.prefetch_workers=0
  data_provider.train_fetcher.pad_to_multiple=16
  data_provider.train_fetcher.min_label_diversity_in_batch=0
  data_provider.train_fetcher.min_dataset_examples_in_batch=None
  data_provider.test_fetcher.batch_size=4 data_provider.test_fetcher.prefetch_workers=0
  data_provider.test_fetcher.pad_to_multiple=16
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
)
STEPS=(
  device=cpu debug=True batch_size=4 checkpoint_interval=3
  summary_interval=2 lr_rampup_steps=2 'lr_decay_steps=[]'
  hyper_params_tuning_batch_size=4
  data_provider.train_set.train_synthetic20=0 data_provider.train_set.train_synthetic21=0
)

echo "### weak: training -> tuning -> inference"
"${RUN[@]}" -m pb_sed_tpu_torch.experiments.weak_label_crnn.training with \
  "${STEPS[@]}" "${DATA[@]}" num_iterations=6 \
  data_provider.json_path=$V/db/db.json \
  data_provider.train_set.train_weak=1 data_provider.train_set.train_strong=1 \
  data_provider.train_set.train_unlabel_in_domain=0 \
  trainer.model.rnn_fwd.rnn.hidden_size=8 trainer.model.rnn_fwd.rnn.num_layers=1 \
  'trainer.model.rnn_fwd.output_net.out_channels=[8,3]' \
  trainer.model.rnn_fwd.output_net.kernel_size=1
HP=$(ls -d "$STORAGE_ROOT"/weak_label_crnn/desed/hyper_params/*/ | tail -n 1)

echo "### weak: pseudo-labels of train_unlabel_in_domain"
"${RUN[@]}" -m pb_sed_tpu_torch.experiments.weak_label_crnn.inference with \
  device=cpu hyper_params_dir=$HP storage_dir=$V/pseudo \
  'dataset_name=["train_unlabel_in_domain"]' \
  'weak_pseudo_labeling=[True]' 'strong_pseudo_labeling=[True]'

echo "### strong: training on the pseudo-labels -> tuning -> inference"
"${RUN[@]}" -m pb_sed_tpu_torch.experiments.strong_label_crnn.training with \
  "${STEPS[@]}" "${DATA[@]}" num_iterations=4 \
  weak_label_crnn_hyper_params_dir=$HP \
  data_provider.json_path=$V/pseudo/db.json \
  data_provider.train_set.train_weak=1 data_provider.train_set.train_strong=1 \
  data_provider.train_set.train_unlabel_in_domain=1 \
  data_provider.train_transform.provide_strong_targets=True \
  data_provider.train_transform.provide_boundary_targets=False \
  trainer.model.rnn.rnn.hidden_size=8 trainer.model.rnn.rnn.num_layers=2 \
  'trainer.model.rnn.output_net.out_channels=[8,3]' \
  trainer.model.rnn.output_net.kernel_size=1
