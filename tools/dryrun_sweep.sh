#!/bin/bash
# The dry run over every arch x shape x mesh and the ising-fleet cell, one
# (arch, mesh) a process, 8 at once, on the host's cores (no GPU):
#   bash tools/dryrun_sweep.sh [OUT_DIR]        (default experiments/dryrun_torch)
# Prints each process's exit, the sweep's wall and every cell's record line.
set -o pipefail
out=${1:-experiments/dryrun_torch}
mkdir -p "$out"
export PYTHONPATH=src CUDA_VISIBLE_DEVICES= OMP_NUM_THREADS=1 OUT="$out"
t0=$(date +%s)
for a in llama-3.2-vision-11b qwen2-moe-a2.7b mixtral-8x22b whisper-medium zamba2-2.7b \
         qwen2.5-32b minitron-8b gemma-2b tinyllama-1.1b xlstm-1.3b ising-fleet; do
  for m in single multi; do echo "$a $m"; done
done | xargs -P 8 -L 1 sh -c 'python3 -m repro_torch.launch.dryrun --arch $0 --mesh $1 \
    --shape all --out "$OUT" > "$OUT/log_$0_$1.txt" 2>&1; echo "$0 $1 exit $?"'
echo "sweep wall $(( $(date +%s) - t0 )) s"
cat "$out"/log_*.txt | grep "^\[" | sort
