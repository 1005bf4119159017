#!/bin/bash
# The dry run's full sweep, every architecture x shape on both production
# meshes, one cell a process, JOBS processes at once (the largest models'
# training cells first, as they take longest), then the report's tables.
#
#     bash tools/dryrun_sweep.sh OUT_DIR [DEVICE] [JOBS]
#
# DEVICE is the dry run's --device (cuda by default; cpu without a card),
# JOBS defaults to 8.  Each cell's record and log go to OUT_DIR.  Cells
# whose record reads ok or skipped are kept (the dry run's --resume).
set -u
OUT=${1:?usage: tools/dryrun_sweep.sh OUT_DIR [DEVICE] [JOBS]}
DEVICE=${2:-cuda}
JOBS=${3:-8}
cd "$(dirname "$0")/.."
mkdir -p "$OUT"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for s in train_4k prefill_32k decode_32k long_500k; do
  for a in qwen2_vl_72b arctic_480b mixtral_8x7b seamless_m4t_large_v2 \
           zamba2_2_7b granite_3_2b chatglm3_6b llama3_2_3b mamba2_780m \
           tinyllama_1_1b; do
    for m in single multi; do echo "$a $s $m"; done
  done
done | xargs -P "$JOBS" -L 1 sh -c "PYTHONPATH=src python -m \
repro_torch.launch.dryrun --arch \$0 --shape \$1 --mesh \$2 \
--device $DEVICE --out $OUT --resume > $OUT/\$0__\$1__\$2.log 2>&1"
grep -h "^\[ *[a-z]*\]" "$OUT"/*.log | cut -c1-160
for m in single multi; do
  PYTHONPATH=src python -m repro_torch.roofline.report --dir "$OUT" --mesh $m
done
PYTHONPATH=src python -m repro_torch.roofline.report --dir "$OUT" --table status
