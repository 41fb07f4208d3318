#!/bin/bash
# What the trainer's start-up and its debugging tools cost on the card:
# builds the kernels, then runs the trainer CLI at m7c width (configs/m7c_125m.yaml,
# synthetic data, 8 steps, a log line every step) without tools, with
# --detect-anomaly alone, and with every tool at 1 and 2 layers, printing each
# run's step lines and wall time; first, twice, what a fresh process takes to
# import torch and then torch._dynamo (which torch.utils.checkpoint imports at
# its first call; the port's remat, models/remat.py, does not).
# Run from anywhere:  bash scripts/trainer_start_probe.sh
cd "$(dirname "$0")/.." || exit 1
python3 -c "import chip_smoke as cs; cs.phase_build()" > /dev/null 2>&1 || exit 5
for i in 1 2; do
  python3 -c 'import time; t = time.perf_counter(); import torch; a = time.perf_counter()
import torch._dynamo; b = time.perf_counter()
print(f"== a fresh process: import torch {a - t:.2f} s, then torch._dynamo {b - a:.2f} s")'
done
T="python3 -m nsa_vibe_tpu_torch.train.trainer --config configs/m7c_125m.yaml --data synthetic --steps 8 --log-every 1"
for case in "2 plain:" "2 anomaly:--detect-anomaly" \
            "1 all:--detect-anomaly --watchdog --profile 2 --mem-dump-every 4" \
            "2 all:--detect-anomaly --watchdog --profile 2 --mem-dump-every 4"; do
  n=${case%% *}; rest=${case#* }; name=${rest%%:*}; flags=${rest#*:}
  s=$(date +%s%N)
  $T --n-layers "$n" $flags --out-dir "artifacts/probe_${n}_${name}" 2>&1 \
    | grep "^\[trainer\] step\|summary" | tr '\n' ' '
  e=$(date +%s%N)
  echo; echo "== layers $n $name: $(( (e - s) / 1000000 )) ms"
done
