#!/usr/bin/env bash
# Quickstart-drift gate of the PyTorch + CUDA port: run README's port
# commands on the CPU.
#
# Every command of README's port section that runs without a card, with
# --device cpu: the golden PAF and GAF byte for byte (1 and 2 shards,
# traced), the trainer and its resume, LM serving, one cell of the dry
# run and its tables, the edit-distance snippet, and the five port
# examples.  Then the reference gate's own checks at its sizes (SMALL):
# offline, online, another align backend, sharded and traced runs all
# emit the same PAF (cmp).  Left out: the whole-grid dry run (`--all`,
# minutes; the one cell runs the same entry point), the pytest lines
# (tier-1 runs them) and the commands that need a card.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
SG="python -m repro_torch.launch.serve_genomics"
GOLD="--ref-len 3000 --reads 10 --read-len 100 --batch 4 --buckets 128 --device cpu"
SMALL="--ref-len 4000 --reads 12 --read-len 100 --batch 4 --device cpu"
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT

echo "== golden PAF, GAF (1 and 2 shards) and traced, on the CPU"
$SG $GOLD --out "$OUT/g.paf"
cmp "$OUT/g.paf" tests/data/serve_golden.paf
$SG --mode graph $GOLD --align-backend graph_cuda --out "$OUT/g.gaf"
cmp "$OUT/g.gaf" tests/data/serve_graph_golden.gaf
$SG $GOLD --num-shards 2 --out "$OUT/s.paf"
cmp "$OUT/s.paf" tests/data/serve_golden.paf
$SG --mode graph $GOLD --num-shards 2 --align-backend graph_cuda \
    --out "$OUT/s.gaf"
cmp "$OUT/s.gaf" tests/data/serve_graph_golden.gaf
$SG $GOLD --trace-out "$OUT/trace.json" --http-port 0 --out "$OUT/t.paf"
cmp "$OUT/t.paf" tests/data/serve_golden.paf

echo "== the trainer, its resume, and LM serving"
python -m repro_torch.launch.train --arch yi-6b --smoke --steps 8 \
    --device cpu --ckpt-dir "$OUT/ck" --save-every 4
python -m repro_torch.launch.train --arch yi-6b --smoke --steps 8 \
    --device cpu --ckpt-dir "$OUT/ck" --save-every 4 | tee "$OUT/resume.log"
grep -q "resumed from step 8" "$OUT/resume.log"
python -c "
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models import model_zoo
from repro_torch.train.serve import greedy_generate
cfg = reduced(get_config('internlm2-1.8b'))
model = model_zoo.init(cfg, device='cpu')
print(greedy_generate(cfg, model, torch.tensor([[1, 2, 3, 4]]), steps=6, max_len=32))"

echo "== one cell of the dry run, and its tables"
python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \
    --multi-pod single --results "$OUT/d.json"
python -c "
import sys
from pathlib import Path
from repro_torch.launch import report
report.main(Path(sys.argv[1]))" "$OUT/d.json"

echo "== the edit-distance snippet"
python -c "
import numpy as np, torch
from repro_torch.core import edit_distance as ed
from repro_torch.genomics import simulate
a = simulate.random_reference(1000, seed=1)
b = simulate.mutate(a, simulate.ILLUMINA, np.random.default_rng(0))
pat = torch.full((1, 1064), 4, dtype=torch.int8); pat[0, :len(a)] = torch.from_numpy(a)
txt = torch.full((1, 1192), 4, dtype=torch.int8); txt[0, :len(b)] = torch.from_numpy(b)
la, lb = torch.tensor([len(a)]), torch.tensor([len(b)])
print('GenASM', ed.genasm_distance_batch(pat, txt, la, lb).item(),
      'Myers', ed.myers_distance_batch(txt, pat[:, :1024], la, m_bits=1024, mode='semiglobal').item())"

echo "== the port's examples"
python examples/torch_quickstart.py --device cpu
python examples/torch_read_mapping.py --device cpu > "$OUT/rm.log"
grep "position-correct" "$OUT/rm.log"
python examples/torch_graph_alignment.py --device cpu
python examples/torch_edit_distance_demo.py --device cpu
python examples/torch_train_lm.py --steps 2 --device cpu --ckpt-dir "$OUT/lm_ck"

echo "== the reference gate's checks, at its sizes"
$SG $SMALL --out "$OUT/out.paf"
$SG --online --rate 200 $SMALL --out "$OUT/online.paf"
cmp "$OUT/out.paf" "$OUT/online.paf"  # both modes emit identical PAF
$SG --align-backend cuda_dc_v2 $SMALL --out "$OUT/v2.paf"
cmp "$OUT/out.paf" "$OUT/v2.paf"  # the v2 kernel's plain version: same bytes
$SG --mode graph --online --rate 200 $SMALL --out "$OUT/out.gaf"
test -s "$OUT/out.gaf"
$SG --num-shards 2 $SMALL --out "$OUT/sharded.paf"
cmp "$OUT/out.paf" "$OUT/sharded.paf"
$SG --trace-out "$OUT/trace2.json" --http-port 0 $SMALL --out "$OUT/traced.paf"
cmp "$OUT/out.paf" "$OUT/traced.paf"  # tracing never changes output
python - "$OUT/trace2.json" <<'PY'
import json, sys
doc = json.load(open(sys.argv[1]))
assert any(e.get("name") == "flush" for e in doc["traceEvents"])
print(f"trace.json: {len(doc['traceEvents'])} events")
PY

echo "quickstart smoke (port): all README port commands ran on the CPU"
