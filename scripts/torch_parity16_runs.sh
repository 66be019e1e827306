#!/usr/bin/env bash
# The runs of PERF.md's "Quality on trained weights", on one card: the JAX
# package's committed parity16 recipe (runs/parity16_retained) through the
# PyTorch port at seed 42 (A), at seed 43 (B, the port's seed spread; the
# seed also draws the corpus), at seed 42 with flash attention and the
# log-mel kernels on (C, K1-K4 in a learning run), and at seeds 44-47 (D-G,
# more of the seed spread). Each run is followed by the int8 eval of its
# best-gap model over the whole 2,048-clip test pool; D-G also evaluate
# their epoch-6 and epoch-8 checkpoints the same way (JAX's best-gap model
# is its epoch 6: a fixed-epoch comparison of retrieval), into
# int8_quality_eval_epoch{6,8}.json. Each writes runs/torch_parity16_*/:
# .gitignore admits its small artifacts and keeps the checkpoints out. A
# run whose directory holds a `latest` checkpoint resumes from it.
#
#   bash scripts/torch_parity16_runs.sh [-j] [A] [B] [C] [D] [E] [F] [G]
#
# (default: A B C). With -j the named runs share the card concurrently,
# two host threads each, each run's output in runs/torch_parity16_*.out;
# their clips/s are then not those of a run alone.
set -euo pipefail
cd "$(dirname "$0")/.."
RECIPE=(--preset-retrieval --samples 8192 --acc 1 --epochs 8
        --schedule-epochs 16)

run() {
  local dir=$1 epochs=$2
  shift 2
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python scripts/torch_proxy_quality_run.py "$dir" "${RECIPE[@]}" "$@"
  python scripts/torch_int8_quality_eval.py --checkpoint "$dir/best_model_gap"
  for e in $epochs; do
    python scripts/torch_int8_quality_eval.py \
      --checkpoint "$dir/checkpoint_epoch_$e" \
      --out "$dir/int8_quality_eval_epoch$e.json"
  done
}

one() {
  case $1 in
    A) run runs/torch_parity16_s42 "" ;;
    B) run runs/torch_parity16_s43 "" --extra train.seed=43 ;;
    C) run runs/torch_parity16_s42_kernels "" --extra \
         model.audio.use_flash_attention=true model.frontend.use_pallas=true ;;
    D) run runs/torch_parity16_s44 "6 8" --extra train.seed=44 ;;
    E) run runs/torch_parity16_s45 "6 8" --extra train.seed=45 ;;
    F) run runs/torch_parity16_s46 "6 8" --extra train.seed=46 ;;
    G) run runs/torch_parity16_s47 "6 8" --extra train.seed=47 ;;
    *) echo "unknown run $1 (use A-G)" >&2; return 2 ;;
  esac
}

declare -A DIR=([A]=s42 [B]=s43 [C]=s42_kernels [D]=s44 [E]=s45 [F]=s46
                [G]=s47)
parallel=
if [[ ${1:-} == -j ]]; then parallel=1; shift; fi
pids=()
for r in ${*:-A B C}; do
  if [[ -n $parallel ]]; then
    OMP_NUM_THREADS=2 MKL_NUM_THREADS=2 one "$r" \
      > "runs/torch_parity16_${DIR[$r]:-x}.out" 2>&1 &
    pids+=($!)
  else
    one "$r"
  fi
done
status=0
for p in ${pids[@]+"${pids[@]}"}; do wait "$p" || status=1; done
exit $status
