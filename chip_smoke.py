#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, reproduces
the golden PAF and GAF on the card, and serves bacterial-scale linear
and sequence-to-graph read-mapping deployments end to end through
`repro_torch.launch.serve_genomics`:

  1. card      — nvidia-smi name and power limit, torch and CUDA versions
  2. build     — nvcc build seconds and the ptxas register/spill report;
                 no kernel's entry function may spill
  3. kernels   — each kernel against its plain version (0 mismatches) at
                 its main-path shapes and a sweep; CUDA-event times of
                 kernel and plain version and the card's bound for the
                 same work; each site's device time from torch.profiler;
                 each kernel's launch geometry (warps, blocks, shared
                 memory per block) at each site.  GenASM-DC at B=256, w=64, k=24; BitAlign at
                 the graph filter's B=1,024, N=1,536, m_bits=128, k=11
                 (R off and on) and the graph align loop's B=256, N=64,
                 m_bits=64, k=24; Myers at the edit-distance sites (B=1,024,
                 n=1,192, m_bits=1,024, semiglobal and global; B=256,
                 n=5,192, m_bits=5,056) and once at L = 100,000 (B=8:
                 timed here, held against its plain version in the LM
                 lane); the linear mapper's filter at the benchmark's
                 262,144 reads x 4 candidates (216-base regions, 128
                 bits, k=12) against a 46,709,983-base buffer
  4. golden    — tests/data/serve_golden.paf byte for byte with cuda_dc and
                 cuda_dc_v2, offline and online
  5. serve     — a 4,641,652 bp reference (the length of E. coli K-12
                 MG1655) and 8,192 Illumina 150 bp reads at 5% error,
                 batch 256: offline on cuda_dc_v2 and cuda_dc (PAFs
                 identical), online with 2,048 reads, the first 256 reads
                 served on the CPU by the plain path (same rows), >= 90%
                 mapped and position-correct, every kernel launched
  6. breakdown — where one 256-read flush's time goes: seed+filter, and
                 within align the DC kernel, the traceback and the rest
  7. obs       — the card's rate of the counted word operations
                 (`csrc/word_ops.cu`, equal to its plain version, beside
                 the h100_sxm spec's peak_word_ops); the observability
                 plane (`repro_torch.obs`): the launcher
                 at its defaults with --trace-out and --http-port, PAF
                 identical to the untraced run; then, in a child process
                 (a fresh CUDA context for torch.profiler), the serve
                 phase's deployment: the card's idle share of 256-read
                 flushes on cuda_dc_v2 (profiled with the CUDA activity
                 only, with the CPU's too, and not at all), 256 reads
                 untraced and traced in turns, four runs each (the
                 tracer's cost; rows identical), and 2,048 reads
                 traced on cuda_dc_v2 and cuda_dc with a roofline manager
                 and an HTTP endpoint read while it serves (PAF rows
                 identical to the untraced run, stage coverage >= 90%, the
                 h100_sxm spec, 6 DC kernel records for one call at cap
                 160, 0 < pct_of_roof_kernel <= 1.05)
  8. graph     — tests/data/serve_graph_golden.gaf byte for byte with
                 graph_cuda, offline and online; the same reference as a
                 variation graph with 23,208 variants (--mode graph):
                 8,192 reads offline, 2,048 online at half the offline
                 rate, the first 256 reads on the CPU with graph_torch
                 (same rows), >= 90% mapped and position-correct, the
                 BitAlign kernel launched at both call sites (filter and
                 align), one flush's breakdown, and 1,024 reads traced
                 (attribution has prefilter, dc_filter and align; rows
                 identical to the untraced run)
  9. edit_distance — use case 3 at the edit-distance benchmark's three
                 settings (L = 1,000 at 95% and 80% similarity, 1,024
                 pairs; L = 5,000 at 95%, 256 pairs): the Myers kernel
                 (semiglobal) and GenASM's windowed distance (cuda_dc) on
                 the card, both equal to the CPU plain path on the first 16
                 pairs, global Myers equal to the Levenshtein oracle on 4
                 pairs, every mapped pair inside the demo's band of Myers
 10. prealign_filter — use case 2 at the filter benchmark's shapes (read
                 100, k = 5; read 250, k = 15; 256 pairs each): accept and
                 dist identical to the CPU, false-accept and false-reject
                 rates against the prefix-Levenshtein oracle
 11. segram    — direct SeGraM mapping: the graph phase's 4,641,652 bp
                 reference and 23,208 variants, 256 Illumina 100 bp reads
                 mapped on the card, identical to the CPU on the first 32
                 reads, >= 90% mapped and position-correct
 12. shard     — sharded serving (`repro_torch.shard`) on cuda:0, every
                 shard on the one card: the golden PAF at 2 and 3 shards
                 (cuda_dc and cuda_dc_v2, offline and online; at 2 shards
                 --align-sharded and --pipelined too) and the golden GAF at
                 2 shards (graph_cuda); the 4,641,652 bp linear deployment
                 at 2 shards, the first 2,048 of the serve phase's reads on
                 cuda_dc_v2, timed and --pipelined, each PAF identical to
                 those reads' rows of the serve phase's 1-shard PAF; the
                 graph deployment at 2 shards, 2,048
                 reads, identical to the graph phase's first 2,048 rows;
                 the device merge equal to the host merge on the card (the
                 deployment's stage outputs, and seeded stages with forced
                 ties and graph distances past 2048); a failover drill
                 that loses shard 1 in the scatter and again between merge
                 and align and gives the fault-free result; every kernel
                 of the path (v1, v2, the linear filter, BitAlign at both
                 sites) launched
 13. lm        — the model zoo's dense decoder LM (`repro_torch.models`,
                 `train`, `ckpt`; plain PyTorch, no kernel of the port):
                 reduced internlm2-1.8b with one set of weights on the card
                 and the CPU (prefill logits, loss, 8 decode steps, greedy
                 tokens, at the CPU tests' tolerances); full internlm2-1.8b
                 (1,889.6 M parameters) serving 4 prompts of 2,048 tokens:
                 prefill, 32 greedy tokens at max_len 2,080 twice (equal),
                 prefill's last logits against step-by-step decode, the
                 int8 KV cache teacher-forced on the same tokens (its
                 quantizer on the first cache's rows bit for bit against
                 the CPU's); and the
                 trainer's entry point (`python -m repro_torch.launch.train
                 --arch internlm2-1.8b --steps 6 --seq 512 --batch 4`) in a
                 subprocess, with checkpoints, then again to resume
 14. lm_zoo    — the rest of the model zoo (`repro_torch.models.moe`,
                 `mamba`, `rwkv6`, `encdec`; plain PyTorch, no kernel of the
                 port): the five reduced configs with one set of weights on
                 the card and the CPU (prefill logits, loss and aux, 8
                 decode steps teacher-forced, greedy tokens; the CPU tests'
                 tolerances and MoE flip rule; jamba and RWKV-6 with fp32
                 activations; mixtral's prompt past its reduced window);
                 mixtral-8x7b at full width, 8 of 32 layers (a 4 x 2,048
                 prefill, 32 greedy tokens after 128, twice; the choices
                 dropped per layer) and trained in process at 2 layers;
                 qwen3-moe-235b-a22b, 2 of 94 layers (a 4 x 1,024 prefill,
                 16 greedy tokens); rwkv6-7b at full size (a 4 x 512
                 prefill against step-by-step decode, 32 greedy tokens
                 twice) and trained in process at 4 layers; jamba's Mamba
                 layer alone at full width (apply on [2, 1,024] against
                 1,024 decode steps); seamless-m4t-medium at full size
                 (prefill with frames at 4 x 1,024, decode against its
                 memory, the trainer's entry point in a subprocess and its
                 resume)
 15. dist      — the distribution and dry-run plane: the serve phase's
                 reference and its first 2,048 reads through
                 `genomics.pipeline` (ReadBatches -> Prefetcher on cuda:0 ->
                 map_stream on cuda_dc_v2, 256 a batch), each batch equal to
                 `map_batch` called directly and the rows equal to the serve
                 phase's PAF rows, reads/s beside the direct loop's; then
                 (in the LM lane, after lm_zoo) in a child process with a
                 one-rank NCCL world, internlm2-1.8b
                 at full size trained 2 steps (microbatches 2, 4 x 512) on a
                 1x1 ("data", "model") mesh with `dist.sharding` DTensor
                 parameters, optimizer state and batches, against the
                 unsharded step from the same weights (loss within 1e-2,
                 grad norm 3e-2 relative), the reduced mixtral the same way
                 (the MoE dispatch constraint), `train.grad_compress` on
                 internlm2's whole fp32 gradient (the first 2^20 values bit
                 for bit against the CPU; CUDA-event times beside the bytes
                 bound) and the pod mean over a one-rank pod group against
                 its formula; then the sharded dry run, started after the
                 kernels phase and run beside the phases that follow:
                 `python -m repro_torch.launch.dryrun --all --multi-pod M`
                 for both meshes, one process each on one thread (rank 0
                 of a fake 256- or 512-rank group on this host's CPU); 66
                 cells, each with its sharded step and no error,
                 collectives in every train cell, cross-pod bytes in every
                 2x16x16 train cell and in no 16x16 cell; cells that fit
                 80 GB per mesh, by the spec count and by rank 0's
                 measured peak (of the cells whose step ran at their
                 length)
 16. surface   — the reference's one-read and one-pair entry points and
                 public wrappers on the card: `core.mapper.map_read` on 32
                 reads of a seeded 100 kbp reference against `map_batch`'s
                 rows (position, distance, ops); `graph.batched_graph_align`
                 on 64 windows of a small graph index's tiles, card against
                 CPU tensors; the four `kernels.ops` wrappers at B = 37
                 (and `squeeze`), card against CPU; one pair through
                 `genasm_distance` (cuda_dc) and `myers_distance`; the 22
                 names of `repro_torch.graph` in a fresh interpreter; bit
                 for bit, every kernel launched (site `surface`)
 17. examples  — each `examples/torch_*.py` as a subprocess on the card at
                 its default sizes (`torch_train_lm.py --steps 4`), each
                 exit code 0
 18. shard_per_device — `--device cuda:0,cuda:0` (and `cuda:0,cuda:0,cuda:0`
                 at 3 shards): one one-row block per listed device, winners
                 copied to the first; the golden PAF (offline and
                 `--pipelined`) and GAF at 2 and 3 shards byte for byte, and
                 the first 512 of the serve phase's reads at full width on
                 2 shards (cuda_dc_v2) against those reads' rows of its
                 1-shard PAF

The Myers check at L = 100 kbp, phases 13, 14 and the dist child run in
the LM lane, a process of its own (`--lm-child`) started after serve, beside phases 7-12 and the read
pipeline: they share the card and the host with them.  Phases 16-18 run
in the surface child (`--surface-child`), started right after the LM
lane, beside both; the parent collects it after segram, before dist.  Each phase prints
one JSON line, its "t" the seconds since the script started, on one
clock in every process (a phase's seconds are the difference to the line
before it in its lane); the LM lane's lines are relayed when it ends.
The kernels line precedes the card's nvidia-smi line, and the last line
is ``{"ok": true, "device": {...}}``.
Any failed check raises: the script then exits non-zero without that
line.  It imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
GOLDEN = ROOT / "tests" / "data" / "serve_golden.paf"
GOLDEN_GAF = ROOT / "tests" / "data" / "serve_graph_golden.gaf"
GOLDEN_ARGS = ["--ref-len", "3000", "--reads", "10", "--read-len", "100",
               "--batch", "4", "--buckets", "128"]
FULL_ARGS = ["--ref-len", "4641652", "--read-len", "150", "--batch", "256"]
# the same reference as a variation graph: 4641652 // 200 = 23,208 variants
GRAPH_ARGS = ["--mode", "graph"] + FULL_ARGS
FULL_READS, ONLINE_READS, CPU_READS = 8192, 2048, 256

# Device-memory bytes/s by card name, from NVIDIA's data sheets (H100 SXM,
# H100 PCIe and H200 SXM); a card not listed fails the bound rather than
# borrow another card's rate.
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# the H100's device spec: its peak_word_ops is the rate of every
# operations bound, the word operations as the *_work functions count them
# a second, as csrc/word_ops.cu measured them on the card (word_ops_phase)
H100_SPEC = ROOT / "src" / "repro_torch" / "obs" / "device_specs" / "h100_sxm.json"
# each kernel's CUDA entry functions, as ptxas and the profiler name them:
# ptxas must report each of them, with no spills
KERNEL_ENTRIES = {"window_dc_batch": ("dc_wave_v1",),
                  "window_dc_batch_v2": ("dc_wave_v2",),
                  "bitalign_dc_batch": ("bitalign_wave",),
                  "myers_distance_batch": ("myers_lanes", "myers_pipe"),
                  "bitap_filter_batch": ("bitap_filter_scan",)}
# per kernel: its main-path call sites (site, shape) and a sweep of shapes
WINDOW_SITES = [("window_step", dict(b=256, w=64, k=24))]
WINDOW_SWEEP = [dict(b=b, w=w, k=k) for b, w, k in (
    (16, 64, 8), (16, 96, 16), (16, 128, 24), (5, 64, 24), (16, 32, 0),
    (130, 64, 32), (37, 96, 31), (5, 32, 0), (7, 128, 32))]
SITES = {
    "window_dc_batch": WINDOW_SITES,
    "window_dc_batch_v2": WINDOW_SITES,
    "bitalign_dc_batch": [
        ("filter", dict(b=1024, n=1536, m_bits=128, k=11, store_r=False)),
        ("filter_with_r", dict(b=1024, n=1536, m_bits=128, k=11,
                               store_r=True)),
        ("align", dict(b=256, n=64, m_bits=64, k=24, store_r=True)),
    ],
    # the edit-distance benchmark's buffers: text L + 192, pattern cut to
    # ((L + 63) // 64) * 64 bits
    "myers_distance_batch": [
        ("edit_distance_1k", dict(b=1024, n=1192, m_bits=1024,
                                  mode="semiglobal")),
        ("edit_distance_5k", dict(b=256, n=5192, m_bits=5056,
                                  mode="semiglobal")),
        ("global_1k", dict(b=1024, n=1192, m_bits=1024, mode="global")),
    ],
    # the linear mapper's filter at the benchmark's batch: 262,144 reads x 4
    # candidates against a chromosome-21-length buffer
    "bitap_filter_batch": [
        ("filter", dict(b=262_144, c=4, filter_bits=128, k=12,
                        ref_len=46_709_983)),
    ],
}
# one long pair set, L = 100,000: held against the plain version once
MYERS_LONG = dict(b=8, n=100_192, m_bits=100_032, mode="semiglobal")
SWEEPS = {
    "window_dc_batch": WINDOW_SWEEP,
    "window_dc_batch_v2": WINDOW_SWEEP,
    # ragged batches, p_lens < m_bits, dense hops (hops past N included);
    # the main-path sites draw hops at the served graph's density
    "bitalign_dc_batch": [
        dict(b=37, n=200, m_bits=128, k=11, store_r=True, short=True,
             hop_rate=0.2),
        dict(b=5, n=64, m_bits=96, k=16, store_r=False, short=True,
             hop_rate=0.5),
        dict(b=40, n=100, m_bits=128, k=32, store_r=True, short=True,
             hop_rate=0.05),
        dict(b=300, n=64, m_bits=64, k=24, store_r=True, short=True,
             hop_rate=0.1),
        dict(b=1024, n=1536, m_bits=128, k=11, store_r=False,
             hop_rate=0.02),
        # the wavefront's packing edges: two graph lanes a warp up to k = 15
        # (b = 37 leaves the last block 5 of its 8), one from k = 16, every
        # lane at k = 31
        dict(b=37, n=120, m_bits=128, k=15, store_r=True, short=True,
             hop_rate=0.2),
        dict(b=13, n=90, m_bits=64, k=16, store_r=True, short=True,
             hop_rate=0.3),
        dict(b=6, n=150, m_bits=96, k=31, store_r=False, short=True,
             hop_rate=0.3),
    ],
    # m_lens drawn in [0, m_bits] with 0, 1 and m_bits always present, both
    # modes, ragged batches (several pairs a warp up to 16 words), a last
    # lane with fewer words than the others, the two widths on either side
    # of one warp a pair and a pipeline of warps, the first design's widest
    # pattern (26 warps a pair) and this one's (32 warps, 1,024 threads);
    # then L = 100 kbp, in the LM lane (myers_long_check)
    "myers_distance_batch": [
        *(dict(b=37, n=150, m_bits=m_bits, mode=mode, short=True)
          for m_bits in (32, 64, 96, 128) for mode in ("global", "semiglobal")),
        dict(b=5, n=300, m_bits=64, mode="semiglobal", short=True),
        dict(b=130, n=200, m_bits=1056, mode="global", short=True),
        dict(b=3, n=64, m_bits=10240, mode="semiglobal", short=True),
        dict(b=3, n=64, m_bits=10272, mode="global", short=True),
        dict(b=3, n=400, m_bits=265_632, mode="global", short=True),
        dict(b=3, n=400, m_bits=327_680, mode="semiglobal", short=True),
    ],
    # nw 1..4, k = 0 and the edges of the 8-, 16- and 32-row instantiations,
    # regions off both ends of a buffer that starts off a 16-byte boundary,
    # short reads, planted ties, ragged lane counts
    "bitap_filter_batch": [
        dict(b=300, filter_bits=32, k=3), dict(b=300, filter_bits=64, k=5),
        dict(b=300, filter_bits=96, k=9, offset=5),
        dict(b=300, filter_bits=128, k=0),
        *(dict(b=130, filter_bits=128, k=k) for k in (7, 8, 15, 16, 31)),
        dict(b=500, filter_bits=128, k=12, ref_len=3000, edge=True, offset=7),
        dict(b=500, filter_bits=128, k=12, short=True, ties=True, offset=1),
        dict(b=37, c=3, filter_bits=64, k=12, region_len=17),
    ],
}
ED_SETTINGS = ((1000, 0.95, 1024), (1000, 0.80, 1024), (5000, 0.95, 256))
ED_CPU_PAIRS, ED_ORACLE_PAIRS = 16, 4
FILTER_SETTINGS = ((100, 5), (250, 15))
FILTER_PAIRS = 256
SEGRAM_READS, SEGRAM_CPU_READS = 256, 32
SEGRAM_KW = dict(m_bits=128, k=16, win_len=192, max_candidates=4,
                 minimizer_w=8, minimizer_k=12)
# the sharded deployments serve the first 2,048 reads of the 1-shard runs
# (8,192 reads took the run past half its time limit)
SHARD_LINEAR_READS, SHARD_GRAPH_READS, SHARD_DRILL_READS = 2048, 2048, 256
# the obs phase: linear reads traced, graph reads traced, reads a run of
# the tracer's cost, and the idle share's 256-read flushes, each profiled
# with the CUDA activity only ("cuda"), with the CPU's too, or not at all
OBS_READS, OBS_GRAPH_READS, COST_READS = 2048, 1024, 256
COST_ORDER = (False, True, True, False, False, True, True, False)
IDLE_BATCH = 256
IDLE_PROFILES = (None, None, "cuda", "cpu+cuda", None, "cuda")
# the lm phase: internlm2-1.8b; the CPU tests' tolerances (logits rtol/atol
# 2e-2, loss 1e-2 absolute; tests/test_torch_lm_*.py)
LM_ARCH = "internlm2-1.8b"
LM_TOL, LM_LOSS_TOL = 2e-2, 1e-2
LM_PARITY = dict(batch=2, seq=64, prompt=16, steps=8)
LM_SERVE = dict(batch=4, prompt=2048, steps=32, int8_steps=8)
LM_TRAIN_ARGS = ["--arch", LM_ARCH, "--steps", "6", "--seq", "512", "--batch",
                 "4", "--ckpt-dir", "build/lm_ck", "--save-every", "3"]
# the lm_zoo phase: the other five LM configurations at their published
# widths, depth cut to what one 80 GB card holds (parameters as the
# reference's init counts them); the CPU tests' tolerances and flip rule
# (tests/torch_lm_common.py): jamba and RWKV-6 compared card to CPU with
# fp32 activations, a routing flip allowed below a top-k gap of 5e-2
ZOO_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
             "rwkv6-7b", "seamless-m4t-medium")
ZOO_FP32 = ("jamba-1.5-large-398b", "rwkv6-7b")
ZOO_ROUTE_EPS, ZOO_AUX_TOL = 5e-2, 1e-3
# mixtral's prompt runs past its reduced sliding window of 32
ZOO_PARITY = dict(batch=2, seq=48, prompt=40, steps=8)
MIXTRAL = dict(layers=8, batch=4, prefill=2048, prompt=128, steps=32,
               train_layers=2, train_batch=4, train_seq=512, train_steps=4)
QWEN = dict(layers=2, batch=4, prefill=1024, prompt=16, steps=16)
RWKV = dict(batch=4, prompt=512, steps=32, train_layers=4, train_batch=4,
            train_seq=512, train_steps=4)
JAMBA_MAMBA = dict(batch=2, seq=1024)
S2S = dict(batch=4, seq=1024, prefix=16)
S2S_TRAIN_ARGS = ["--arch", "seamless-m4t-medium", "--steps", "4", "--seq",
                  "512", "--batch", "4", "--ckpt-dir", "build/lm_ck_s2s",
                  "--save-every", "2"]
# the dist phase: the serve phase's reference and first reads through the
# read pipeline on cuda_dc_v2; in a child process (a one-rank NCCL world)
# internlm2-1.8b trained at full size on a 1x1 ("data", "model") mesh
# against the unsharded step from the same weights (the CPU tests'
# tolerances, tests/test_torch_dist.py), the reduced mixtral the same way
# with fp32 activations, the int8 compression on internlm2's whole fp32
# gradient (card against CPU on its first values) and the pod mean over a
# one-rank pod group; the sharded dry run of every cell (DryRun)
DIST_READS, DIST_BATCH = 2048, 256
# the sharded dry run: one process per mesh (a fake group's world size is
# fixed for its life), each on one CPU thread
DRYRUN_MESHES = ("single", "multi")
# the LM lane (lm, lm_zoo and the dist child in a process of its own,
# beside the genomics phases after serve) and the dry run must end this
# many seconds after the script started
LANE_DEADLINE_S = 1100.0
DIST_TRAIN = dict(steps=2, microbatches=2, batch=4, seq=512)
DIST_LOSS_TOL, DIST_REL_TOL = 1e-2, 3e-2
DIST_BITWISE, DIST_PSUM = 1 << 20, 1 << 26


# each line's "t": seconds since the script started, on the host's
# monotonic clock, which the child processes share (they inherit T0)
T0 = float(os.environ.setdefault("CHIP_SMOKE_T0", repr(time.monotonic())))


def since_start() -> float:
    return time.monotonic() - T0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "t": since_start()}),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30).stdout.strip()


# --------------------------------------------------------------- build ----
def ptxas_spills(log: str) -> dict[str, list[int]]:
    """[spill store bytes, spill load bytes] per entry function of an
    ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            out[fn] = [int(m.group(1)), int(m.group(2))]
    return out


def kernel_spills(infos, ops) -> dict[str, list[int]]:
    """The spills of every entry function in the libraries this run built;
    fails if one spills or a kernel's entry went unreported."""
    got = {}
    for info in infos:
        if not info.log:  # already built: no ptxas report this run
            continue
        found = ptxas_spills(info.log)
        for kern in ops.KERNELS:
            if Path(kern.source).stem != info.name:
                continue
            for entry in KERNEL_ENTRIES[kern.name]:
                check(any(entry in fn for fn in found),
                      f"no ptxas report for {entry} in csrc/{info.name}.cu")
        got.update(found)
    spilled = {fn: v for fn, v in got.items() if any(v)}
    check(not spilled, f"kernels spill: {spilled}")
    return got


# ------------------------------------------------------------- kernels ----
def launch_geometry(name: str, args, kw, dev) -> dict:
    """The launch a kernel makes for these inputs: warps in the grid,
    blocks, shared memory bytes per block (and Myers' words a lane, lanes
    a pair and warps a pair)."""
    from repro_torch.kernels import (bitalign, bitap_filter, genasm_dc,
                                     genasm_dc_v2, myers)

    if name == "bitap_filter_batch":
        return bitap_filter.launch_geometry(args[1].numel(), kw["filter_bits"],
                                            kw["k"])
    b = args[0].shape[0]
    if name == "window_dc_batch":
        return genasm_dc.launch_geometry(b, kw["w"], kw["k"])
    if name == "window_dc_batch_v2":
        return genasm_dc_v2.launch_geometry(b, kw["w"], kw["k"])
    if name == "myers_distance_batch":
        return myers.launch_geometry(b, kw["m_bits"], dev)
    return bitalign.launch_geometry(b, kw["m_bits"], kw["k"], kw["store_r"], dev)


def dc_work(name: str, args, kw) -> tuple[int, int]:
    """(bytes, int32 operations) one GenASM-DC call must move and do.

    Bytes: each input read once, each output written once.  Operations:
    per text char and word, row 0 is shl1 + OR (4 ops) and each row d >= 1
    three shl1 (3 ops each), three ANDs and one OR (13 ops).
    """
    b, w, k = args[0].shape[0], kw["w"], kw["k"]
    nw = w // 32
    store = (w * (k + 1) * 3 * nw if name == "window_dc_batch"
             else (w + 1) * (k + 1) * nw) * 4
    return b * (2 * w + 4 + store), b * w * nw * (4 + 13 * k)


def bitalign_work(args, kw) -> tuple[int, int]:
    """(bytes, int32 operations) one BitAlign call must move and do, for
    these inputs.

    Bytes: bases, hopBits, patterns and p_lens read once; dists, and R
    when stored, written once.  Operations: per node and word, row 0 is
    shl1 + OR + the tail AND (5 ops), each row d >= 1 three shl1 (9), one
    OR and four ANDs (14); the hop combine is one AND per row and word
    for each hop bit these inputs set.
    """
    from repro_torch.graph.index import popcount32

    bases, succ, _, _ = args
    b, n = bases.shape
    m_bits, k = kw["m_bits"], kw["k"]
    nw = m_bits // 32
    r_bytes = b * n * (k + 1) * nw * 4 if kw["store_r"] else 0
    hops = int(popcount32(succ).sum())
    return (b * n * (1 + 4 + 4) + b * (m_bits + 4) + r_bytes,
            b * n * nw * (5 + 14 * k) + hops * (k + 1) * nw)


def myers_work(args, kw) -> tuple[int, int]:
    """(bytes, int32 operations) one Myers call must move and do.

    Bytes: texts, patterns and m_lens read once, distances written once.
    Operations, exactly B·n·(23·nw + 7): per text char and word 23 -- Xv
    (1), Eq & Pv (1), the add with carry (add, compare, add the carry in,
    compare, OR: 5), ^ Pv and | Eq (2), Ph = Mv | ~(Xh | Pv) (3), Mh (1),
    the shifts of Ph and Mh with their incoming bits (3 each), Pv =
    Mh | ~(Xv | Ph) (3) and Mv (1); per text char 7 -- the Ph and Mh
    score bits (shift and AND, 2 each), the score update (2) and the
    running minimum (1).
    """
    texts, _, _ = args
    b, n = texts.shape
    m_bits = kw["m_bits"]
    return b * (n + m_bits + 4 + 4), b * n * (23 * (m_bits // 32) + 7)


def filter_work(args, kw) -> tuple[int, int]:
    """(bytes, int32 operations) one call of the linear mapper's filter must
    move and do.

    Bytes: each lane's region bases and start read once, each read's
    filter_bits bases and length read once, each lane's distance and
    offset written once.  Operations, per region base of every lane: per
    word, row 0 is shl1 + OR (4 ops) and each row d >= 1 two shl1 (3 ops
    each), three ANDs and one OR (10 ops), since shl1(R_old[d]) serves row
    d's M term and row d+1's S term; then one op a row to gather the rows'
    top bits, two to find the first zero, and three for the running
    minimum and its position (compare and two selects).  The mask table,
    built once a lane, is not counted.
    """
    _, starts, _, _ = args
    b, lanes = starts.shape[0], starts.numel()
    bits, k, n = kw["filter_bits"], kw["k"], kw["region_len"]
    return (lanes * (n + 8 + 8) + b * (bits + 8),
            lanes * n * ((bits // 32) * (4 + 10 * k) + (k + 1) + 5))


def work(name: str, args, kw) -> tuple[int, int]:
    """(bytes, int32 operations) of one call of kernel ``name``."""
    if name == "bitap_filter_batch":
        return filter_work(args, kw)
    if name == "bitalign_dc_batch":
        return bitalign_work(args, kw)
    if name == "myers_distance_batch":
        return myers_work(args, kw)
    return dc_work(name, args, kw)


def bound(card: str, n_bytes: int, n_ops: int) -> dict:
    """The card's least time for the work: the larger of bytes over the
    memory rate and int32 operations over the peak integer rate."""
    bytes_ms = n_bytes / memory_bytes_per_s(card) * 1e3
    ops_ms = n_ops / int32_ops_per_s() * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "int32_ops": n_ops}


def int32_ops_per_s() -> float:
    """The spec's peak_word_ops: the card's measured rate of the counted
    word operations (`word_ops_phase`)."""
    return json.loads(H100_SPEC.read_text())["peak_word_ops"]


def memory_bytes_per_s(card: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in card:
            return rate
    raise RuntimeError(f"no data-sheet memory rate for {card!r}")


def time_ms(torch, fn, trials: int, per_trial: int = 1) -> float:
    """Median over ``trials`` of the CUDA-event time of ``per_trial``
    back-to-back calls of ``fn()``, per call, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_trial):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_trial)
    return statistics.median(times)


def device_ms(torch, fn, entries: tuple[str, ...], calls: int = 10):
    """Mean device time of the CUDA kernels whose name holds one of
    ``entries`` (one per call), from `torch.profiler` over ``calls`` calls
    after a warm-up: the kernel's own time, without the host's time to
    launch it.
    The mean is over the kernel records the profiler returns, which can
    be fewer than the launches; None when it returns none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if any(entry in ev.key for entry in entries)]
    n = sum(ev.count for ev in evs)
    us = sum(getattr(ev, "device_time_total", None)
             or getattr(ev, "cuda_time_total", 0.0) for ev in evs)
    return us / n / 1e3 if n else None


def compare(torch, got, want, what: str) -> tuple[int, int]:
    """(mismatching words, max abs difference) of two output tuples, words
    compared as uint32; an output one side leaves out (None) must be left
    out by both."""
    mism, err = 0, 0
    for g, w in zip(got, want):
        check((g is None) == (w is None), f"{what}: outputs present differ")
        if g is None or g.numel() == 0:
            continue
        mism += int((g != w).sum())
        err = max(err, int(((g.long() & 0xFFFFFFFF) - (w.long() & 0xFFFFFFFF))
                           .abs().max()))
    return mism, err


def kernel_phase(torch, np, ops, dev) -> dict:
    """Each kernel against its plain version on the card; returns rows."""
    card = torch.cuda.get_device_name(dev)
    # device times first: after the plain versions' many small launches the
    # profiler returns fewer kernel records, and none after the Myers long set
    dev_ms = {}
    for kern in ops.KERNELS:
        for site, shape in SITES[kern.name]:
            args, kw = kern.make_inputs(np.random.default_rng(7), dev, **shape)
            dev_ms[kern.name, site] = device_ms(
                torch, lambda: kern.wrapper(*args, **kw), KERNEL_ENTRIES[kern.name])
    args, kw = ops.KERNELS[3].make_inputs(np.random.default_rng(7), dev,
                                          **MYERS_LONG)
    dev_ms["myers_distance_batch", "long"] = device_ms(
        torch, lambda: ops.KERNELS[3].wrapper(*args, **kw),
        KERNEL_ENTRIES["myers_distance_batch"], calls=3)
    rows = {}
    for kern in ops.KERNELS:
        sweep, sites = [], []
        for i, shape in enumerate([s for _, s in SITES[kern.name]]
                                  + SWEEPS[kern.name]):
            args, kw = kern.make_inputs(np.random.default_rng(100 + i), dev,
                                        **shape)
            mism, err = compare(torch, kern.wrapper(*args, **kw),
                                kern.plain(*args, **kw), kern.name)
            torch.cuda.synchronize()
            sweep.append({**shape, "mismatches": mism, "max_abs_err": err})
            check(mism == 0, f"{kern.name} {shape}: {mism} mismatches")
        slow_plain = kern.name in ("bitalign_dc_batch", "myers_distance_batch",
                                   "bitap_filter_batch")
        geometry = []
        for site, shape in SITES[kern.name]:
            args, kw = kern.make_inputs(np.random.default_rng(7), dev, **shape)
            geometry.append({"site": site, "shape": shape,
                             **launch_geometry(kern.name, args, kw, dev)})
            kernel_ms = time_ms(torch, lambda: kern.wrapper(*args, **kw), 20, 10)
            plain_ms = time_ms(torch, lambda: kern.plain(*args, **kw),
                               3 if slow_plain else 20)
            sites.append({"site": site, "shape": shape, "ms": kernel_ms,
                          "device_ms": dev_ms[kern.name, site],
                          "plain_ms": plain_ms,
                          **bound(card, *work(kern.name, args, kw))})
        main = sites[0]  # the row's numbers: the first call site
        rows[kern.name] = {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "shape": main["shape"],
            "mismatches": sum(r["mismatches"] for r in sweep),
            "max_abs_err": max(r["max_abs_err"] for r in sweep),
            "ms": main["ms"], "kernel_ms": main["ms"],
            "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "bytes": main["bytes"],
            "int32_ops": main["int32_ops"],
            # no single PyTorch call computes GenASM-DC, BitAlign, Myers or
            # the Bitap filter
            "library_ms": None, "sites": sites, "sweep": sweep,
        }
        if kern.name == "myers_distance_batch":  # the kernel alone, 3 trials
            args, kw = kern.make_inputs(np.random.default_rng(7), dev,
                                        **MYERS_LONG)
            geometry.append({"site": "long", "shape": MYERS_LONG,
                             **launch_geometry(kern.name, args, kw, dev)})
            rows[kern.name]["long"] = {
                "shape": MYERS_LONG, "trials": 3,
                "ms": time_ms(torch, lambda: kern.wrapper(*args, **kw), 3),
                "device_ms": dev_ms[kern.name, "long"],
                **bound(card, *work(kern.name, args, kw))}
        emit("launch_geometry", name=kern.name,
             entries=KERNEL_ENTRIES[kern.name], sites=geometry)
        emit("kernels_vs_plain", **rows[kern.name])
    return rows


def myers_long_check(torch, np, ops, dev) -> dict:
    """The Myers kernel against its plain version at L = 100 kbp
    (MYERS_LONG), the last shape of its sweep, on the inputs it would have
    there.  The plain version takes ~100,000 host-bound steps, so this runs
    in the LM lane, beside the genomics phases; the kernels line takes its
    result from the lane's line."""
    kern = next(k for k in ops.KERNELS if k.name == "myers_distance_batch")
    i = len(SITES[kern.name]) + len(SWEEPS[kern.name])
    args, kw = kern.make_inputs(np.random.default_rng(100 + i), dev,
                                **MYERS_LONG)
    mism, err = compare(torch, kern.wrapper(*args, **kw),
                        kern.plain(*args, **kw), kern.name)
    torch.cuda.synchronize()
    line = {**MYERS_LONG, "mismatches": mism, "max_abs_err": err}
    emit("kernels_vs_plain_long", name=kern.name, **line)
    check(mism == 0, f"{kern.name} {MYERS_LONG}: {mism} mismatches")
    return line


# ------------------------------------------------------------- serving ----
def golden_phase(sg) -> None:
    want = GOLDEN.read_bytes()
    runs = []
    for backend in ("cuda_dc", "cuda_dc_v2"):
        for online in (False, True):
            out = OUT / f"golden_{backend}{'_online' if online else ''}.paf"
            args = GOLDEN_ARGS + ["--align-backend", backend, "--device", "cuda"]
            if online:
                args += ["--online", "--rate", "2000"]
            sg.main(args + ["--out", str(out)])
            same = out.read_bytes() == want
            runs.append({"backend": backend, "online": online, "identical": same})
            check(same, f"golden PAF on the card, {backend} online={online}")
    emit("golden", runs=runs)


def flush_breakdown(torch, svc, backend: str) -> dict:
    """Time one 256-read flush stage by stage, synchronising around the DC
    and traceback calls inside the align loop (measurement only)."""
    from repro_torch.align import batched
    from repro_torch.core import genasm
    from repro_torch.genomics import encode
    from repro_torch.core.mapper import LinearMapExecutor

    cfg = svc.config
    cap = cfg.bucket_for(150)
    ex = LinearMapExecutor(cfg=cfg.genasm, p_cap=cap,
                           filter_bits=min(cfg.filter_bits, cap),
                           filter_k=cfg.filter_k,
                           max_candidates=cfg.max_candidates,
                           minimizer_w=cfg.minimizer_w,
                           minimizer_k=cfg.minimizer_k, backend=backend)
    arr, lens = encode.batch_reads(svc.reads[:cfg.max_batch], cap)
    index = svc.index.index
    ex(index, arr, lens)  # warm-up
    spent = {"dc": 0.0, "tb": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return res
        return run

    saved = (batched.window_dc_batch, batched.window_dc_batch_v2,
             genasm.window_tb, genasm.window_tb_r)
    batched.window_dc_batch = timed("dc", saved[0])
    batched.window_dc_batch_v2 = timed("dc", saved[1])
    genasm.window_tb = timed("tb", saved[2])
    genasm.window_tb_r = timed("tb", saved[3])
    try:
        ex(index, arr, lens)
    finally:
        (batched.window_dc_batch, batched.window_dc_batch_v2,
         genasm.window_tb, genasm.window_tb_r) = saved
    times = {name: t1 - t0 for name, t0, t1, _ in ex.last_times}
    align_s = times["align"]
    return {
        "backend": backend, "batch": cfg.max_batch, "bucket_cap": cap,
        "n_windows": cfg.genasm.n_windows(cap),
        "seed_filter_s": times["seed_filter"], "align_s": align_s,
        "dc_s": spent["dc"], "tb_s": spent["tb"],
        "align_other_s": align_s - spent["dc"] - spent["tb"],
        "dc_share_of_align": spent["dc"] / align_s,
        "tb_share_of_align": spent["tb"] / align_s,
        "filter_vs_align": times["seed_filter"] / align_s,
    }


def serve_phase(torch, ops, sg) -> tuple[dict, float]:
    """Full-size serving on the card; returns the main path's launch counts
    and the cuda_dc_v2 run's reads/s."""
    full = FULL_ARGS + ["--reads", str(FULL_READS), "--device", "cuda"]
    results, launches = {}, {}
    for backend in ("cuda_dc_v2", "cuda_dc"):
        ops.reset_launch_counts()
        s = sg.main(full + ["--align-backend", backend,
                            "--out", str(OUT / f"full_{backend}.paf")])
        counts = ops.launch_counts()
        results[backend] = s
        launches[backend] = counts
        m = s["metrics"]
        emit("serve_offline", backend=backend, reads=s["reads"],
             mapped=s["mapped"], position_correct=s["correct"],
             seconds=s["seconds"], reads_per_s=s["reads_per_s"],
             seed_filter_s=m.get("stage_seed_filter_s"),
             align_s=m.get("stage_align_s"),
             flushes=m.get("batches_flushed"), launches=counts)
        check(s["mapped"] >= 0.9 * s["reads"], f"{backend}: mapped < 90%")
        check(s["correct"] >= 0.9 * s["reads"], f"{backend}: correct < 90%")
    check((OUT / "full_cuda_dc.paf").read_bytes()
          == (OUT / "full_cuda_dc_v2.paf").read_bytes(),
          "cuda_dc and cuda_dc_v2 PAFs differ")
    check(launches["cuda_dc_v2"]["window_dc_batch_v2"] > 0, "v2 kernel not launched")
    check(launches["cuda_dc"]["window_dc_batch"] > 0, "v1 kernel not launched")
    for backend, counts in launches.items():
        check(counts["bitap_filter_batch"] > 0,
              f"{backend}: filter kernel not launched")

    for backend in ("cuda_dc", "cuda_dc_v2"):
        ops.reset_launch_counts()
        s = sg.main(FULL_ARGS + ["--reads", str(ONLINE_READS), "--device",
                                 "cuda", "--align-backend", backend,
                                 "--online", "--rate", "20000",
                                 "--max-delay-ms", "20",
                                 "--out", str(OUT / f"online_{backend}.paf")])
        counts = ops.launch_counts()
        m = s["metrics"]
        emit("serve_online", backend=backend, reads=s["reads"],
             mapped=s["mapped"], position_correct=s["correct"],
             reads_per_s=s["reads_per_s"], p50_ms=s["p50_ms"],
             p99_ms=s["p99_ms"], flushes=m.get("batches_flushed"),
             batch_occupancy_mean=m.get("batch_occupancy_mean"),
             seed_filter_s=m.get("stage_seed_filter_s"),
             align_s=m.get("stage_align_s"), launches=counts)
        check(s["mapped"] >= 0.9 * s["reads"], f"online {backend}: mapped < 90%")
        check(s["correct"] >= 0.9 * s["reads"], f"online {backend}: correct < 90%")
        check(max(counts.values()) > 0, f"online {backend}: no kernel launched")

    # the first 256 reads on the CPU, plain path, against the card's rows
    args = sg.parse_args(FULL_ARGS + ["--reads", str(FULL_READS), "--device",
                                      "cpu", "--align-backend", "torch"])
    svc = sg.setup(args)
    with sg.ServeEngine(svc.index, svc.config) as engine:
        cpu_rows = sg.run_offline(
            engine, svc.reads, list(range(CPU_READS)), batch=CPU_READS,
            lease_s=600.0, row_fn=lambda g, r: sg.paf_row(g, r, svc.ref_len))
    gpu_rows = [r for r in results["cuda_dc_v2"]["rows"] if r["gid"] < CPU_READS]
    same = cpu_rows == gpu_rows
    emit("cpu_vs_card", reads=CPU_READS, cpu_rows=len(cpu_rows),
         card_rows=len(gpu_rows), identical=same)
    check(same, "CPU plain path and card disagree on the first 256 reads")

    # where one full flush's time goes, on the card
    gsvc = sg.setup(sg.parse_args(FULL_ARGS + ["--reads", str(CPU_READS),
                                               "--device", "cuda"]))
    for backend in ("cuda_dc_v2", "cuda_dc"):
        emit("breakdown", **flush_breakdown(torch, gsvc, backend))
    return ({"window_dc_batch": launches["cuda_dc"]["window_dc_batch"],
             "window_dc_batch_v2": launches["cuda_dc_v2"]["window_dc_batch_v2"],
             "bitap_filter_batch": launches["cuda_dc"]["bitap_filter_batch"]},
            results["cuda_dc_v2"]["reads_per_s"])


# ------------------------------------------------------------------ obs ----
def http_get(url: str) -> tuple[int, str]:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.read().decode()


class EndpointReader(threading.Thread):
    """Reads the obs endpoints while a run serves: /healthz, /metrics,
    /attrib and /trace?n=64 once each, then the roofline table measured
    (a profiled kernel run) as soon as the first flush has registered its
    site.  ``served`` is set when the run has ended."""

    def __init__(self, url: str) -> None:
        super().__init__(daemon=True)
        self.url, self.served = url, threading.Event()
        self.got: dict[str, dict] = {}
        self.error: BaseException | None = None

    def fetch(self, path: str) -> str:
        during, t0 = not self.served.is_set(), time.perf_counter()
        code, body = http_get(self.url + path)
        self.got[path] = {"status": code, "during_serving": during,
                          "seconds": time.perf_counter() - t0}
        return body

    def run(self) -> None:
        try:
            for path in ("/healthz", "/metrics", "/attrib", "/trace?n=64"):
                self.fetch(path)
            deadline = time.monotonic() + 600
            while not json.loads(http_get(
                    self.url + "/roofline?measure=0")[1])["kernels"]:
                check(time.monotonic() < deadline, "no roofline site in 600 s")
                time.sleep(0.2)
            self.fetch("/roofline?measure=1")
        except Exception as e:  # noqa: BLE001 — the phase reports it
            self.error = e


def paf_lines_below(path: Path, n_reads: int) -> list[str]:
    """The PAF lines of reads ``read0`` .. ``read<n_reads - 1>``."""
    return [ln for ln in path.read_text().splitlines()
            if int(ln.split("\t", 1)[0][4:]) < n_reads]


def obs_cli_phase(sg) -> None:
    """The launcher at its defaults on the card with --trace-out and
    --http-port, against the same run untraced."""
    from repro_torch.obs.attrib import STAGE_ORDER

    traced, plain, trace = (OUT / "obs_cli_traced.paf", OUT / "obs_cli.paf",
                            OUT / "obs_cli_trace.json")
    s = sg.main(["--device", "cuda", "--trace-out", str(trace),
                 "--http-port", "0", "--out", str(traced)])
    sg.main(["--device", "cuda", "--out", str(plain)])
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] in ("X", "b", "e")}
    kernels = [r["kernel"] for r in s["roofline"]["kernels"]]
    same = traced.read_bytes() == plain.read_bytes()
    emit("obs_cli", reads=s["reads"], mapped=s["mapped"],
         identical_to_untraced=same, trace_events=len(events),
         span_names=sorted(names), roofline_kernels=kernels,
         coverage=s["attrib"]["coverage"])
    check(same, "--trace-out/--http-port changed the PAF")
    check(names - {"flush"} <= set(STAGE_ORDER) and "align" in names,
          f"trace span names {sorted(names)}")
    check("cuda_dc/cap160" in kernels, f"roofline rows {kernels}")


def obs_linear_phase(torch, ops, sg, svc, untraced: Path) -> dict:
    """The linear deployment traced, on each DC kernel: a tracer, a roofline
    manager and an HTTP endpoint on port 0 read while the run serves;
    returns each backend's roofline row."""
    from repro_torch.obs import (DeviceSpec, ObsServer, RooflineManager,
                                 Tracer, build_ledger)
    from repro_torch.obs.roofline import n_windows
    from repro_torch.serve import Metrics

    dev = torch.device("cuda", 0)
    want = paf_lines_below(untraced, OBS_READS)
    rows = {}
    for backend in ("cuda_dc_v2", "cuda_dc"):
        out = OUT / f"obs_{backend}.paf"
        args = sg.parse_args(FULL_ARGS + [
            "--reads", str(OBS_READS), "--device", "cuda",
            "--align-backend", backend, "--out", str(out)])
        tracer, metrics = Tracer(), Metrics()
        rf = RooflineManager(spec=DeviceSpec.for_device(dev), device=dev,
                             tracer=tracer, metrics=metrics)
        with ObsServer(metrics=metrics, tracer=tracer, roofline=rf,
                       port=0) as srv:
            reader = EndpointReader(srv.url)
            reader.start()
            ops.reset_launch_counts()
            s = sg.serve(svc, args, tracer=tracer, roofline=rf,
                         metrics=metrics)
            reader.served.set()
            reader.join(timeout=600)
            check(not reader.is_alive() and reader.error is None,
                  f"{backend}: endpoint reader failed: {reader.error!r}")
            # the tables as the run left them (the site's measurement is
            # the one the reader's request made)
            roof = json.loads(http_get(srv.url + "/roofline?measure=1")[1])
            spans = json.loads(http_get(srv.url + "/trace?n=64")[1])["spans"]
            attrib = json.loads(http_get(srv.url + "/attrib")[1])
        counts = ops.launch_counts()
        (row,) = [r for r in roof["kernels"] if r["bucket_cap"] == 160]
        rows[backend] = row
        ledger = build_ledger(tracer.log).report()
        same = out.read_text().splitlines() == want
        emit("obs_linear", backend=backend, reads=s["reads"],
             mapped=s["mapped"], position_correct=s["correct"],
             reads_per_s=s["reads_per_s"], identical_to_untraced=same,
             coverage=attrib["coverage"],
             serial_fraction=attrib["serial_fraction"],
             n_flushes=attrib["n_flushes"],
             stages={r["stage"]: {k: r[k] for k in
                                  ("calls", "total_s", "frac", "p50_ms",
                                   "p99_ms")} for r in attrib["stages"]},
             device_spec=roof["device_spec"], roofline=row,
             endpoints=reader.got, trace_spans=len(spans),
             launches=counts, card=card_line())
        check(same, f"{backend}: traced PAF rows differ from the untraced run")
        check(s["mapped"] >= 0.9 * s["reads"], f"obs {backend}: mapped < 90%")
        check(attrib["coverage"] >= 0.9 and ledger.coverage >= 0.9,
              f"{backend}: stage coverage {attrib['coverage']}")
        check(all(g["status"] == 200 for g in reader.got.values()),
              f"{backend}: endpoint statuses {reader.got}")
        check(0 < len(spans) <= 64, f"{backend}: /trace?n=64 gave {len(spans)}")
        check(roof["device_spec"]["name"] == "h100_sxm",
              f"device spec {roof['device_spec']}")
        check(row["measure_error"] is None, f"measure error {row}")
        check(row["measured_launches"] == n_windows(160) == 6,
              f"{backend}: {row['measured_launches']} DC kernel records for "
              f"one call at cap 160")
        check(row["pct_of_roof_kernel"] is not None
              and 0 < row["pct_of_roof_kernel"] <= 1.05,
              f"{backend}: pct_of_roof_kernel {row['pct_of_roof_kernel']}")
    return rows


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def idle_share(torch, ops, sg, svc) -> dict:
    """The card's idle share of a flush: serve the first 1,536 reads of
    ``svc`` on cuda_dc_v2, one 256-read flush at a time, and profile
    flushes 2 and 5 with the CUDA activity only and flush 3 with the CPU
    activity too (flushes 0, 1 and 4 unprofiled): the union of the
    card's kernel intervals over each flush span's wall time.  The CPU
    activity slows the host; the CUDA-only flushes are the measurement,
    the unprofiled ones the profiler's cost."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer
    from repro_torch.obs.roofline import device_records

    # a flush deadline past the quantum's submission: one full flush each
    cfg = sg.engine_config(sg.parse_args(FULL_ARGS + [
        "--align-backend", "cuda_dc_v2", "--max-delay-ms", "1000"]))
    tracer = Tracer()
    flushes = []
    activities = {"cuda": [ProfilerActivity.CUDA],
                  "cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    with sg.ServeEngine(svc.index, cfg, tracer=tracer) as engine:
        for q, mode in enumerate(IDLE_PROFILES):
            before = ops.launch_counts()["window_dc_batch_v2"]
            n_before = sum(sp.name == "flush" for sp in tracer.log.spans())
            with profile(activities=activities[mode]) if mode \
                    else contextlib.nullcontext() as prof:
                sg.run_offline(engine, svc.reads,
                               list(range(q * IDLE_BATCH, (q + 1) * IDLE_BATCH)),
                               batch=IDLE_BATCH, lease_s=600.0,
                               row_fn=svc.row_fn)
                engine.drain()  # the flush span has closed
                torch.cuda.synchronize()
            spans = [sp for sp in tracer.log.spans() if sp.name == "flush"]
            row = {"flush": q, "profiled": mode,
                   "flushes": len(spans) - n_before,
                   "flush_s": spans[-1].duration_s,
                   "v2_launches": ops.launch_counts()["window_dc_batch_v2"]
                   - before}
            if mode:
                dev = device_records(prof)
                kern = [r for r in dev
                        if not r[0].startswith(("Memcpy", "Memset"))]
                busy = union_s(r[1:] for r in kern)
                busy_all = union_s(r[1:] for r in dev)
                row.update(
                    kernel_records=len(kern), copy_records=len(dev) - len(kern),
                    dc_records=sum("dc_wave_v2" in r[0] for r in kern),
                    kernel_busy_s=busy, device_busy_s=busy_all,
                    idle_share=1 - busy / row["flush_s"],
                    idle_share_with_copies=1 - busy_all / row["flush_s"])
            flushes.append(row)
    cuda_only = [f["idle_share"] for f in flushes if f["profiled"] == "cuda"]
    emit("idle_share", backend="cuda_dc_v2", batch=IDLE_BATCH,
         idle_share_cuda_only=cuda_only,
         idle_share_cpu_cuda=[f["idle_share"] for f in flushes
                              if f["profiled"] == "cpu+cuda"],
         unprofiled_flush_s=[f["flush_s"] for f in flushes[1:]
                             if not f["profiled"]],
         flushes=flushes, card=card_line())
    for f in flushes:
        check(f["flushes"] == 1 and f["v2_launches"] == 6,
              f"flush {f['flush']}: {f['flushes']} flushes, "
              f"{f['v2_launches']} v2 launches")
        if f["profiled"]:
            check(f["dc_records"] == f["v2_launches"],
                  f"flush {f['flush']}: {f['dc_records']} dc_wave_v2 records "
                  f"for {f['v2_launches']} launches")
            check(0 <= f["idle_share"] <= 1,
                  f"flush {f['flush']}: idle share {f['idle_share']}")
    return flushes


def tracer_cost(sg, svc) -> list[dict]:
    """What the obs plane costs a run that serves: the first 256 reads
    (one flush) on cuda_dc_v2, eight runs, untraced and traced (a tracer
    and a roofline manager, no endpoint and no measured run) in the
    order of `COST_ORDER`, so that a drift of the host's speed falls on
    both alike; the PAF rows of all eight identical."""
    from repro_torch.obs import DeviceSpec, RooflineManager, Tracer

    runs = []
    for i, traced in enumerate(COST_ORDER):
        out = OUT / f"obs_cost_{i}.paf"
        args = sg.parse_args(FULL_ARGS + [
            "--reads", str(COST_READS), "--device", "cuda",
            "--align-backend", "cuda_dc_v2", "--out", str(out)])
        kw = {}
        if traced:
            kw["tracer"] = Tracer()
            kw["roofline"] = RooflineManager(
                spec=DeviceSpec.for_device("cuda:0"), device="cuda:0",
                tracer=kw["tracer"])
        s = sg.serve(svc, args, **kw)
        m = s["metrics"]
        runs.append({"traced": traced, "reads_per_s": s["reads_per_s"],
                     "seconds": s["seconds"],
                     "seed_filter_s": m["stage_seed_filter_s"],
                     "align_s": m["stage_align_s"],
                     "rows": out.read_text()})
    same = len({r.pop("rows") for r in runs}) == 1
    median = {t: statistics.median(r["reads_per_s"] for r in runs
                                   if r["traced"] == t) for t in (False, True)}
    emit("obs_cost", backend="cuda_dc_v2", reads=COST_READS, runs=runs,
         median_reads_per_s={"untraced": median[False], "traced": median[True]},
         traced_over_untraced=median[True] / median[False],
         identical=same, card=card_line())
    check(same, "tracing changed the PAF rows")
    return runs


def obs_child() -> int:
    """``chip_smoke.py --obs-child``: the obs phase's profiled runs, in a
    fresh process.  `torch.profiler` returns fewer kernel records than
    launches late in a process that has made many small launches (the
    kernel phase's plain versions), so the runs it counts have a CUDA
    context of their own: the idle share, the tracer's cost, then the
    linear deployment traced on each DC kernel."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_genomics as sg

    # the serve phase's reads: a smaller --reads simulates other reads
    svc = sg.setup(sg.parse_args(FULL_ARGS + ["--reads", str(FULL_READS),
                                              "--device", "cuda"]))
    idle_share(torch, ops, sg, svc)
    tracer_cost(sg, svc)
    obs_linear_phase(torch, ops, sg, svc, OUT / "full_cuda_dc_v2.paf")
    return 0


def word_ops_phase(torch) -> dict:
    """The card's rate of the word operations the operations bounds count
    (`repro_torch.kernels.word_ops`, `csrc/word_ops.cu`): each mix held
    against its plain version on a short run, then timed; the larger rate
    beside `h100_sxm.json`'s ``peak_word_ops``, which every operations
    bound of this script divides by."""
    from repro_torch.kernels import word_ops

    dev = torch.device("cuda", 0)
    check(word_ops.shape() == {"nw": word_ops.NW, "rows": word_ops.ROWS,
                               "windows": word_ops.WINDOWS, "threads": 256},
          f"csrc/word_ops.cu constants {word_ops.shape()}")
    rates = {}
    for mix in word_ops.MIXES:
        got = word_ops.word_ops_chain(mix, 16, 1000, device=dev).cpu()
        want = word_ops.word_ops_chain(mix, 16, 1000, device="cpu")
        check(torch.equal(got, want),
              f"word_ops {mix}: the kernel differs from its plain version")
        rates[mix] = word_ops.rate(mix, device=dev)
    measured = max(r["ops_per_s"] for r in rates.values())
    spec = int32_ops_per_s()
    emit("peak_word_ops", rates=rates, measured_ops_per_s=measured,
         spec_ops_per_s=spec, measured_over_spec=measured / spec,
         clocks_sm=card_line("clocks.sm,clocks.max.sm"), card=card_line())
    return rates


def obs_phase(torch, sg) -> None:
    """The observability plane on the card: the word-op rate and the
    launcher's flags here, then `obs_child` in a child process (its lines
    are relayed)."""
    t_phase = time.perf_counter()
    word_ops_phase(torch)
    obs_cli_phase(sg)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--obs-child"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"obs child exited {proc.returncode}: {proc.stderr[-3000:]}")
    emit("obs_done", seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------- graph serving ----
def golden_graph_phase(sg) -> None:
    want = GOLDEN_GAF.read_bytes()
    runs = []
    for online in (False, True):
        out = OUT / f"golden_graph{'_online' if online else ''}.gaf"
        args = ["--mode", "graph"] + GOLDEN_ARGS + [
            "--align-backend", "graph_cuda", "--device", "cuda",
            "--out", str(out)]
        if online:
            args += ["--online", "--rate", "2000"]
        sg.main(args)
        same = out.read_bytes() == want
        runs.append({"backend": "graph_cuda", "online": online,
                     "identical": same})
        check(same, f"golden GAF on the card, online={online}")
    emit("golden_graph", runs=runs)


def graph_breakdown(torch, svc) -> dict:
    """Time one 256-read graph flush stage by stage, synchronising around
    the BitAlign kernel at both call sites and the graph traceback
    (measurement only)."""
    from repro_torch.genomics import encode
    from repro_torch.graph import backends, mapper, windowed

    cfg = svc.config
    cap = cfg.bucket_for(150)
    gidx = svc.index.index
    ex = mapper.GraphMapExecutor(
        tile_stride=gidx.tile_stride, cfg=cfg.genasm, p_cap=cap,
        filter_bits=min(cfg.filter_bits, cap), filter_k=cfg.filter_k,
        max_candidates=cfg.max_candidates, minimizer_w=cfg.minimizer_w,
        minimizer_k=cfg.minimizer_k, backend="graph_cuda",
        prefilter=cfg.graph_prefilter)
    arr, lens = encode.batch_reads(svc.reads[:cfg.max_batch], cap)
    ex(gidx.arrays, arr, lens)  # warm-up
    spent = {"filter_kernel": 0.0, "dc": 0.0, "tb": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return res
        return run

    saved = (mapper.bitalign_dc_batch, backends.bitalign_dc_batch,
             windowed.window_tb_graph)
    mapper.bitalign_dc_batch = timed("filter_kernel", saved[0])
    backends.bitalign_dc_batch = timed("dc", saved[1])
    windowed.window_tb_graph = timed("tb", saved[2])
    try:
        ex(gidx.arrays, arr, lens)
    finally:
        (mapper.bitalign_dc_batch, backends.bitalign_dc_batch,
         windowed.window_tb_graph) = saved
    times = {name: t1 - t0 for name, t0, t1, _ in ex.last_times}
    align_s = times["align"]
    return {
        "backend": "graph_cuda", "batch": cfg.max_batch, "bucket_cap": cap,
        "n_windows": cfg.genasm.n_windows(cap),
        "dc_rows": ex.last_stats["dc_rows"],
        "prefilter_s": times["prefilter"], "dc_filter_s": times["dc_filter"],
        "filter_kernel_s": spent["filter_kernel"], "align_s": align_s,
        "dc_s": spent["dc"], "tb_s": spent["tb"],
        "align_other_s": align_s - spent["dc"] - spent["tb"],
        "dc_share_of_align": spent["dc"] / align_s,
        "tb_share_of_align": spent["tb"] / align_s,
    }


def graph_serve_phase(torch, ops, sg) -> dict:
    """The graph deployment on the card; returns the main path's launch
    counts of the BitAlign kernel, the deployment (``svc``) and its rows."""
    import dataclasses

    from repro_torch.graph.index import EpochedGraphIndex, GraphArrays
    from repro_torch.kernels.bitalign import bitalign_dc_batch

    args = sg.parse_args(GRAPH_ARGS + ["--reads", str(FULL_READS),
                                       "--device", "cuda", "--align-backend",
                                       "graph_cuda", "--out",
                                       str(OUT / "full_graph.gaf")])
    svc = sg.setup(args)  # one graph build serves every run below
    ops.reset_launch_counts()
    s = sg.serve(svc, args)
    counts = ops.launch_counts()
    sites = {"filter": bitalign_dc_batch.launches_by_store["no_r"],
             "align": bitalign_dc_batch.launches_by_store["r"]}
    m = s["metrics"]
    emit("serve_graph_offline", backend="graph_cuda", index_s=s["index_s"],
         n_nodes=svc.index.index.n_nodes, n_tiles=svc.index.index.n_tiles,
         reads=s["reads"], mapped=s["mapped"], position_correct=s["correct"],
         seconds=s["seconds"], reads_per_s=s["reads_per_s"],
         prefilter_s=m.get("stage_prefilter_s"),
         dc_filter_s=m.get("stage_dc_filter_s"),
         align_s=m.get("stage_align_s"), flushes=m.get("batches_flushed"),
         tiles_live=m.get("graph_tiles_live"),
         tiles_pruned=m.get("graph_tiles_pruned"),
         dc_rows=m.get("graph_dc_rows"), launches=counts,
         bitalign_launches_by_site=sites)
    check(s["mapped"] >= 0.9 * s["reads"], "graph: mapped < 90%")
    check(s["correct"] >= 0.9 * s["reads"], "graph: correct < 90%")
    check(sites["filter"] > 0, "BitAlign kernel not launched by the filter")
    check(sites["align"] > 0, "BitAlign kernel not launched by the align loop")

    # online at half the offline rate: p50/p99 measure a flush, not a backlog
    rate = s["reads_per_s"] / 2
    online = sg.parse_args(GRAPH_ARGS + [
        "--reads", str(ONLINE_READS), "--device", "cuda", "--align-backend",
        "graph_cuda", "--online", "--rate", str(rate), "--max-delay-ms", "20",
        "--out", str(OUT / "online_graph.gaf")])
    ops.reset_launch_counts()
    so = sg.serve(svc, online)
    mo = so["metrics"]
    emit("serve_graph_online", backend="graph_cuda", rate_offered=rate,
         max_delay_ms=online.max_delay_ms,
         reads=so["reads"], mapped=so["mapped"],
         position_correct=so["correct"], reads_per_s=so["reads_per_s"],
         p50_ms=so["p50_ms"], p99_ms=so["p99_ms"],
         flushes=mo.get("batches_flushed"),
         batch_occupancy_mean=mo.get("batch_occupancy_mean"),
         prefilter_s=mo.get("stage_prefilter_s"),
         dc_filter_s=mo.get("stage_dc_filter_s"),
         align_s=mo.get("stage_align_s"), launches=ops.launch_counts())
    check(so["mapped"] >= 0.9 * so["reads"], "online graph: mapped < 90%")
    check(so["correct"] >= 0.9 * so["reads"], "online graph: correct < 90%")

    # traced (attribution only: the graph backends have no roofline model)
    from repro_torch.obs import Tracer

    st = sg.serve(svc, sg.parse_args(GRAPH_ARGS + [
        "--reads", str(OBS_GRAPH_READS), "--device", "cuda",
        "--align-backend", "graph_cuda"]), tracer=Tracer())
    stages = {r["stage"]: {k: r[k] for k in ("calls", "total_s", "frac")}
              for r in st["attrib"]["stages"]}
    same = st["rows"] == [r for r in s["rows"] if r["gid"] < OBS_GRAPH_READS]
    emit("obs_graph", backend="graph_cuda", reads=st["reads"],
         reads_per_s=st["reads_per_s"], identical_to_untraced=same,
         coverage=st["attrib"]["coverage"],
         serial_fraction=st["attrib"]["serial_fraction"], stages=stages,
         roofline_kernels=st["roofline"]["kernels"] if st["roofline"] else None)
    check(same, "traced graph rows differ from the untraced run")
    check({"prefilter", "dc_filter", "align"} <= set(stages),
          f"graph attribution stages {sorted(stages)}")

    # the first 256 reads on the CPU, plain path, on the card's index
    gidx = svc.index.index
    cpu_index = EpochedGraphIndex(dataclasses.replace(
        gidx, arrays=GraphArrays(*(a.cpu() for a in gidx.arrays))))
    cpu_cfg = dataclasses.replace(svc.config, align_backend="graph_torch")
    t0 = time.perf_counter()
    with sg.ServeEngine(cpu_index, cpu_cfg) as engine:
        cpu_rows = sg.run_offline(engine, svc.reads, list(range(CPU_READS)),
                                  batch=CPU_READS, lease_s=600.0,
                                  row_fn=svc.row_fn)
    gpu_rows = [r for r in s["rows"] if r["gid"] < CPU_READS]
    same = cpu_rows == gpu_rows
    emit("cpu_vs_card_graph", reads=CPU_READS, cpu_rows=len(cpu_rows),
         card_rows=len(gpu_rows), identical=same,
         cpu_seconds=time.perf_counter() - t0)
    check(same, "CPU plain graph path and card disagree on the first 256 reads")

    emit("breakdown_graph", **graph_breakdown(torch, svc))
    return {"bitalign_dc_batch": counts["bitalign_dc_batch"],
            "bitalign_launches_by_site": sites, "svc": svc,
            "rows": s["rows"], "reads_per_s": s["reads_per_s"]}


# ------------------------------------------------------- sharded serving ----
def tied_stage(np, s: int, b: int, rng, *, graph: bool):
    """[S, B] shard winners with ties at every level of the merge key
    (full-key ties, which the lowest shard must win, included) and dead
    candidates; graph distances fall on both sides of 2048."""
    sentinel = 2 ** 31 - 1
    if graph:
        d = rng.choice(np.array([0, 3, 2047, 2048, 4094]), size=(s, b))
    else:
        d = rng.integers(0, 14, size=(s, b))
    pos = rng.integers(0, 5000, size=(s, b))
    tile = rng.integers(0, 2000, size=(s, b))
    for frac, cols in ((0.4, (d,)), (0.3, (d, pos)), (0.2, (d, pos, tile))):
        tie = rng.random(b) < frac
        for a in cols:
            a[:, tie] = a[0, tie]
    dead = rng.random((s, b)) < 0.3
    dead[:, 0] = True
    d[dead] = 4094 if graph else 13
    pos[dead] = sentinel
    tile[dead] = sentinel
    return [x.astype(np.int32) for x in (d, pos, tile)]


def merges_agree(torch, np, host, dev) -> bool:
    return all(np.array_equal(h, g.cpu().numpy()) for h, g in zip(host, dev))


def shard_merge_checks(torch, np, dev, stage) -> dict:
    """`merge_device` on the card against `merge_host`: on a deployment's
    stage outputs and on seeded [S, B] stages with forced ties, linear
    and graph keys; the device merge's CUDA-event time at the stage's
    shape."""
    from repro_torch.graph.mapper import CandidateStageResult
    from repro_torch.shard.graph_mapper import ShardedGraphMapExecutor as GX
    from repro_torch.shard.mapper import ShardedMapExecutor as LX
    from repro_torch.shard.mapper import ShardStageResult

    out = {"stage_shape": list(stage.text.shape),
           "stage_identical": merges_agree(torch, np, LX.merge_host(stage),
                                           LX.merge_device(stage)),
           "merge_ms": time_ms(torch, lambda: LX.merge_device(stage), 20, 10)}
    tied = []
    for s in (2, 3, 4):
        rng = np.random.default_rng(90 + s)
        d, pos, _ = tied_stage(np, s, 256, rng, graph=False)
        text = rng.integers(0, 4, size=(s, 256, 16)).astype(np.int8)
        st = ShardStageResult(*(torch.from_numpy(x).to(dev) for x in
                                (d, pos, text, np.abs(d) % 17)))
        lin = LX.merge_device(st)
        win = lin[4].cpu().numpy()
        full_tie = ((d == d[0]) & (pos == pos[0])).all(0)
        d, origin, tile = tied_stage(np, s, 256, rng, graph=True)
        gst = CandidateStageResult(*(torch.from_numpy(x).to(dev) for x in (
            d, origin, tile,
            rng.integers(0, 2 ** 31, size=(s, 256, 8)).astype(np.int32),
            origin[..., None].astype(np.int64) + np.arange(8),
            np.abs(d) % 9, d < 2048)))
        tied.append({
            "shards": s, "full_ties": int(full_tie.sum()),
            "low_shard_wins": bool((win[full_tie] == 0).all()),
            "linear_identical": merges_agree(torch, np, LX.merge_host(st), lin),
            "graph_identical": merges_agree(torch, np, GX.merge_host(gst),
                                            GX.merge_device(gst))})
    out["tied"] = tied
    check(out["stage_identical"], "device merge != host merge on the card")
    for t in tied:
        check(t["full_ties"] > 0 and t["low_shard_wins"],
              f"{t['shards']} shards: full-key ties not won by shard 0")
        check(t["linear_identical"] and t["graph_identical"],
              f"{t['shards']} shards: tied merges differ on the card")
    return out


def shard_phase(torch, np, ops, sg, dev, graph, one_shard_rps) -> dict:
    """Sharded serving on cuda:0; returns each kernel's launches at the
    sharded sites (counts set to 0 before each path, read after it)."""
    from repro_torch import shard
    from repro_torch.genomics import encode
    from repro_torch.kernels.bitalign import bitalign_dc_batch

    t_phase = time.perf_counter()
    sites = {}

    # the goldens at 2 and 3 shards, every shard on the one card
    want, runs = GOLDEN.read_bytes(), []
    ops.reset_launch_counts()
    for shards in (2, 3):
        modes = [(), ("--online", "--rate", "2000")]
        if shards == 2:
            modes += [("--align-sharded",), ("--pipelined",)]
        for backend in ("cuda_dc", "cuda_dc_v2"):
            for extra in modes:
                out = OUT / f"golden_s{shards}_{backend}_{len(runs)}.paf"
                sg.main(GOLDEN_ARGS + ["--align-backend", backend, "--device",
                                       "cuda", "--num-shards", str(shards),
                                       *extra, "--out", str(out)])
                same = out.read_bytes() == want
                runs.append({"shards": shards, "backend": backend,
                             "mode": " ".join(extra), "identical": same})
                check(same, f"golden PAF, {shards} shards, {backend} {extra}")
    out = OUT / "golden_graph_s2.gaf"
    sg.main(["--mode", "graph"] + GOLDEN_ARGS + [
        "--align-backend", "graph_cuda", "--device", "cuda", "--num-shards",
        "2", "--out", str(out)])
    same = out.read_bytes() == GOLDEN_GAF.read_bytes()
    runs.append({"shards": 2, "backend": "graph_cuda", "mode": "",
                 "identical": same})
    check(same, "golden GAF at 2 shards on the card")
    golden = ops.launch_counts()
    sites["shard_golden"] = golden
    emit("shard_golden", runs=runs, launches=golden)
    check(golden["window_dc_batch"] > 0 and golden["window_dc_batch_v2"] > 0
          and golden["bitalign_dc_batch"] > 0
          and golden["bitap_filter_batch"] > 0,
          "a kernel of the sharded golden runs was not launched")

    # the linear deployment at 2 shards, timed and pipelined: the serve
    # phase's first SHARD_LINEAR_READS reads, against their rows of its
    # 1-shard PAF
    one = paf_lines_below(OUT / "full_cuda_dc_v2.paf", SHARD_LINEAR_READS)
    lsvc8k = sg.setup(sg.parse_args(FULL_ARGS + ["--reads", str(FULL_READS),
                                                 "--device", "cuda"]))
    full = {}
    for extra in ((), ("--pipelined",)):
        tag = "shard2" + "".join(e.replace("--", "_") for e in extra)
        ops.reset_launch_counts()
        s = sg.serve(lsvc8k, sg.parse_args(
            FULL_ARGS + ["--reads", str(SHARD_LINEAR_READS), "--device",
                         "cuda", "--align-backend", "cuda_dc_v2",
                         "--num-shards", "2", *extra,
                         "--out", str(OUT / f"{tag}.paf")]))
        counts = ops.launch_counts()
        sites[tag] = counts
        m = s["metrics"]
        flushes = m.get("batches_flushed", 0)
        per_flush = {f"{st}_s_per_flush": m.get(f"stage_{st}_s", 0.0) / flushes
                     for st in ("scatter", "merge_device", "align")}
        same = (OUT / f"{tag}.paf").read_text().splitlines() == one
        full[tag] = s["reads_per_s"]
        emit("shard_linear", shards=2, pipelined=bool(extra),
             backend="cuda_dc_v2", reads=s["reads"], mapped=s["mapped"],
             position_correct=s["correct"], seconds=s["seconds"],
             reads_per_s=s["reads_per_s"],
             one_shard_reads_per_s=one_shard_rps,
             one_shard_reads=FULL_READS,
             flushes=flushes, **per_flush, identical_to_one_shard=same,
             launches=counts, card=card_line())
        check(same, f"{tag}: PAF differs from the 1-shard PAF's rows")
        check(counts["window_dc_batch_v2"] > 0, f"{tag}: v2 not launched")
        check(counts["bitap_filter_batch"] > 0, f"{tag}: filter not launched")
    del lsvc8k

    # the graph deployment at 2 shards: the graph phase's first rows
    svc = graph["svc"]
    args = sg.parse_args(GRAPH_ARGS + [
        "--reads", str(SHARD_GRAPH_READS), "--device", "cuda",
        "--align-backend", "graph_cuda", "--num-shards", "2",
        "--out", str(OUT / "shard2_graph.gaf")])
    ops.reset_launch_counts()
    s = sg.serve(svc, args)
    counts = ops.launch_counts()
    by_store = dict(bitalign_dc_batch.launches_by_store)
    sites["shard2_graph"] = {**counts, "bitalign_filter": by_store["no_r"],
                             "bitalign_align": by_store["r"]}
    want_rows = [r for r in graph["rows"] if r["gid"] < SHARD_GRAPH_READS]
    same = s["rows"] == want_rows
    m = s["metrics"]
    flushes = m.get("batches_flushed", 0)
    emit("shard_graph", shards=2, backend="graph_cuda", reads=s["reads"],
         mapped=s["mapped"], position_correct=s["correct"],
         seconds=s["seconds"], reads_per_s=s["reads_per_s"],
         one_shard_reads_per_s=graph["reads_per_s"], flushes=flushes,
         **{f"{st}_s_per_flush": m.get(f"stage_{st}_s", 0.0) / flushes
            for st in ("prefilter", "dc_filter", "merge_device", "align")},
         identical_to_one_shard=same, launches=counts,
         bitalign_launches_by_site={"filter": by_store["no_r"],
                                    "align": by_store["r"]},
         card=card_line())
    check(same, "2-shard GAF differs from the 1-shard rows")
    check(by_store["no_r"] > 0 and by_store["r"] > 0,
          "BitAlign not launched at both sharded graph sites")

    # the device merge on the card, and a failover drill, at full width
    lsvc = sg.setup(sg.parse_args(FULL_ARGS + ["--reads",
                                               str(SHARD_DRILL_READS),
                                               "--device", "cuda"]))
    cfg = lsvc.config
    cap = cfg.bucket_for(150)
    arr, lens = encode.batch_reads(lsvc.reads, cap)
    kw = dict(cfg=cfg.genasm, p_cap=cap, filter_bits=min(cfg.filter_bits, cap),
              filter_k=cfg.filter_k, shard_candidates=cfg.max_candidates,
              backend="cuda_dc_v2")
    halo = max(shard.DEFAULT_HALO, shard.required_halo(
        p_cap=max(cfg.buckets), filter_bits=cfg.filter_bits,
        filter_k=cfg.filter_k, t_cap=max(cfg.buckets) + 2 * cfg.genasm.w))
    esi = shard.from_epoched(lsvc.index, 2, halo=halo)
    ex = shard.get_executor(esi.index, **kw)
    merges = shard_merge_checks(torch, np, dev,
                                ex.stage(esi.index.parts, arr, lens))
    emit("shard_merge", **merges, card=card_line())

    clean = shard.map_batch_sharded(esi.index, arr, lens, **kw)
    lost = []

    def lose_shard_1(i, attempt):
        if i == 1 and attempt == 1:
            lost.append(i)
            raise RuntimeError("drill: shard 1 lost")

    drill = shard.map_batch_with_failover(
        esi, arr, lens, fault_hook=lose_shard_1, align_fault_hook=lose_shard_1,
        pipelined=True, **kw)
    same = all(torch.equal(a, b) for a, b in zip(clean, drill))
    emit("shard_failover", reads=len(lens), faults=len(lost),
         epochs=esi.epochs, identical=same,
         mapped=int((clean.position >= 0).sum()))
    check(lost == [1, 1] and esi.epochs == [0, 2], "the drill's faults")
    check(same, "failover drill changed the result")
    emit("shard_done", seconds=time.perf_counter() - t_phase,
         reads_per_s=full)
    return sites


# ------------------------------------------------- use cases 2 and 3 ----
def wall_s(torch, fn, trials: int = 1):
    """(result, median host seconds) of ``fn()`` ended by a synchronise;
    with ``trials`` > 1, after one warm-up call."""
    if trials > 1:
        fn()
    times, res = [], None
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return res, statistics.median(times)


def edit_pairs(np, simulate, length: int, similarity: float, batch: int):
    """Pairs as `benchmarks/edit_distance.py` makes them: a random
    sequence (pattern, buffer L + 64) and its mutated copy (text, buffer
    L + 192), seed 7."""
    rng = np.random.default_rng(7)
    prof = simulate.ErrorProfile("x", 1 - similarity, 0.4, 0.3, 0.3)
    p_cap = length + 64
    a = np.full((batch, p_cap), 4, np.int8)
    b = np.full((batch, p_cap + 128), 4, np.int8)
    a_lens = np.zeros(batch, np.int32)
    b_lens = np.zeros(batch, np.int32)
    for i in range(batch):
        s = rng.integers(0, 4, size=length).astype(np.int8)
        t = simulate.mutate(s, prof, rng)
        a[i, :len(s)] = s
        b[i, :len(t)] = t[:b.shape[1]]
        a_lens[i], b_lens[i] = len(s), min(len(t), b.shape[1])
    return a, b, a_lens, b_lens


def edit_distance_phase(torch, np, ops, dev) -> int:
    """Use case 3 on the card; returns the Myers kernel's launches."""
    from repro_torch.core import edit_distance as ed
    from repro_torch.core import oracle
    from repro_torch.core.genasm import GenASMConfig
    from repro_torch.genomics import simulate

    cfg = GenASMConfig(w=64, o=24, k=24)
    card = card_line()
    myers_launches = 0
    for length, similarity, batch in ED_SETTINGS:
        a, b, al, bl = edit_pairs(np, simulate, length, similarity, batch)
        m_bits = ((length + 63) // 64) * 64
        pats = np.ascontiguousarray(a[:, :m_bits])
        on = [torch.from_numpy(x).to(dev) for x in (a, b, al, bl, pats)]
        ops.reset_launch_counts()
        dm, myers_s = wall_s(torch, lambda: ed.myers_distance_batch(
            on[1], on[4], on[2], m_bits=m_bits, mode="semiglobal"), 3)
        d, genasm_s = wall_s(torch, lambda: ed.genasm_distance_batch(
            on[0], on[1], on[2], on[3], cfg=cfg))
        counts = ops.launch_counts()
        myers_launches += counts["myers_distance_batch"]
        dm, d = dm.cpu().numpy(), d.cpu().numpy()

        c = min(ED_CPU_PAIRS, batch)
        cpu = [torch.from_numpy(x[:c]) for x in (a, b, al, bl, pats)]
        dm_cpu = ed.myers_distance_batch(cpu[1], cpu[4], cpu[2], m_bits=m_bits,
                                         mode="semiglobal").numpy()
        d_cpu = ed.genasm_distance_batch(*cpu[:4], cfg=cfg).numpy()
        same = bool((dm_cpu == dm[:c]).all() and (d_cpu == d[:c]).all())
        ok = d >= 0
        in_band = (dm[ok] <= d[ok]) & (d[ok] <= dm[ok] + np.maximum(5, dm[ok] // 20))
        oracle_ok = None
        if length == 1000 and similarity == 0.95:
            got, want = [], []
            for i in range(ED_ORACLE_PAIRS):
                t = on[1][i:i + 1, :int(bl[i])]
                got.append(int(ed.myers_distance_batch(
                    t, on[4][i:i + 1], on[2][i:i + 1], m_bits=m_bits,
                    mode="global")[0]))
                want.append(oracle.levenshtein(a[i, :al[i]], b[i, :bl[i]]))
            oracle_ok = got == want
            check(oracle_ok, f"global Myers {got} != Levenshtein {want}")
        emit("edit_distance", length=length, similarity=similarity,
             pairs=batch, m_bits=m_bits, myers_s=myers_s,
             myers_pairs_per_s=batch / myers_s, genasm_s=genasm_s,
             genasm_pairs_per_s=batch / genasm_s,
             myers_mean=float(dm.mean()), genasm_mean=float(d[ok].mean()),
             genasm_failed=int((~ok).sum()), in_band=int(in_band.sum()),
             cpu_pairs=c, cpu_identical=same, global_oracle_ok=oracle_ok,
             myers_launches=counts["myers_distance_batch"],
             genasm_dc_launches=counts["window_dc_batch"], card=card)
        check(same, f"L={length}: card and CPU distances differ")
        check(bool(in_band.all()), f"L={length}: windowed distance outside "
              f"the band of Myers on {int((~in_band).sum())} pairs")
        check(counts["myers_distance_batch"] > 0, "Myers kernel not launched")
        check(counts["window_dc_batch"] > 0, "GenASM-DC kernel not launched")
    return myers_launches


def prealign_filter_phase(torch, np, dev) -> None:
    """Use case 2 at `benchmarks/prealign_filter.py`'s shapes: even pairs
    a read and its mutated copy, odd pairs unrelated (seed 5)."""
    from repro_torch.core import filter as gfilter
    from repro_torch.core import oracle
    from repro_torch.genomics import simulate

    card = card_line()
    for read_len, k in FILTER_SETTINGS:
        rng = np.random.default_rng(5)
        m_bits = 128 if read_len <= 100 else 256
        n = m_bits + 2 * k + 16
        texts = np.full((FILTER_PAIRS, n), 4, np.int8)
        reads = np.full((FILTER_PAIRS, m_bits), 4, np.int8)
        truth = np.zeros(FILTER_PAIRS, bool)
        for i in range(FILTER_PAIRS):
            r = rng.integers(0, 4, size=read_len).astype(np.int8)
            if i % 2 == 0:
                t = simulate.mutate(r, simulate.ErrorProfile(
                    "x", k / read_len / 2, .5, .25, .25), rng)
            else:
                t = rng.integers(0, 4, size=read_len + 2 * k).astype(np.int8)
            texts[i, :min(len(t), n)] = t[:n]
            reads[i, :read_len] = r
            truth[i] = oracle.levenshtein_prefix(r, t) <= k
        tt, rr = torch.from_numpy(texts), torch.from_numpy(reads)
        (acc, dist), sec = wall_s(torch, lambda: gfilter.filter_candidates(
            tt.to(dev), rr.to(dev), None, m_bits=m_bits, k=k), 3)
        acc_c, dist_c = gfilter.filter_candidates(tt, rr, None, m_bits=m_bits,
                                                  k=k)
        acc, dist = acc.cpu(), dist.cpu()
        same = bool(torch.equal(acc, acc_c) and torch.equal(dist, dist_c))
        a = acc.numpy()
        emit("prealign_filter", read_len=read_len, k=k, m_bits=m_bits,
             pairs=FILTER_PAIRS, seconds=sec, pairs_per_s=FILTER_PAIRS / sec,
             accepted=int(a.sum()), true_within_k=int(truth.sum()),
             false_accept=float((a & ~truth).sum() / max((~truth).sum(), 1)),
             false_reject=float((~a & truth).sum() / max(truth.sum(), 1)),
             cpu_identical=same, card=card)
        check(same, f"filter read {read_len}: card and CPU differ")


def segram_phase(torch, np, dev) -> None:
    """Direct SeGraM mapping of 256 reads on the graph phase's graph."""
    from repro_torch.core.segram import graph as sgraph
    from repro_torch.core.segram import segram
    from repro_torch.genomics import encode, simulate

    ref_len = int(FULL_ARGS[FULL_ARGS.index("--ref-len") + 1])
    t0 = time.perf_counter()
    ref = simulate.random_reference(ref_len, seed=1)
    n_var = ref_len // 200  # as serve_genomics --mode graph: seed 3
    variants = simulate.simulate_variants(
        ref, n_snp=n_var // 2, n_ins=n_var // 4, n_del=n_var // 4, seed=3)
    g = sgraph.build_graph(ref, variants)
    idx = segram.preprocess(ref, g, w=8, k=12, device=dev)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    rs = simulate.simulate_reads(ref, n_reads=SEGRAM_READS, read_len=100,
                                 profile=simulate.ILLUMINA, seed=2)
    reads, lens = encode.batch_reads(rs.reads, SEGRAM_KW["m_bits"])
    rt, lt = torch.from_numpy(reads), torch.from_numpy(lens)
    out, sec = wall_s(torch, lambda: segram.map_batch(
        idx, rt.to(dev), lt.to(dev), **SEGRAM_KW), 3)
    out = {key: v.cpu() for key, v in out.items()}
    c = SEGRAM_CPU_READS
    cpu_idx = segram.SeGraMIndex(*(x.cpu() for x in idx))
    t1 = time.perf_counter()
    cpu = segram.map_batch(cpu_idx, rt[:c], lt[:c], **SEGRAM_KW)
    cpu_s = time.perf_counter() - t1
    same = all(torch.equal(cpu[key], out[key][:c]) for key in cpu)
    mapped = ~out["failed"].numpy()
    want = g.node_of_backbone[rs.true_pos]
    correct = mapped & (np.abs(out["node"].numpy() - want) <= 16)
    emit("segram", ref_len=ref_len, variants=len(variants), n_nodes=g.n_nodes,
         index_s=index_s, reads=SEGRAM_READS, mapped=int(mapped.sum()),
         position_correct=int(correct.sum()), seconds=sec,
         reads_per_s=SEGRAM_READS / sec, cpu_reads=c, cpu_seconds=cpu_s,
         cpu_identical=same, **{k: v for k, v in SEGRAM_KW.items()},
         card=card_line())
    check(same, "SeGraM: card and CPU differ on the first 32 reads")
    check(mapped.sum() >= 0.9 * SEGRAM_READS, "SeGraM: mapped < 90%")
    check(correct.sum() >= 0.9 * SEGRAM_READS, "SeGraM: correct < 90%")


# --------------------------------------------------- the dense LM ----
def lm_near_tie(np, logits, tol: float) -> list[int]:
    """Per row, the steps before the first whose top-2 margin is at most
    2 * tol; ``logits`` is [B, steps, V].  Greedy tokens are compared up to
    it, as the CPU tests compare them (tests/test_torch_lm_serve.py)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tied = top2[..., 1] - top2[..., 0] <= 2 * tol
    return [int(np.argmax(t)) if t.any() else logits.shape[1] for t in tied]


def lm_same_until(got, want, counts) -> bool:
    """Generated tokens ([B, 1 + steps]) equal on each row's first counts[r]."""
    return all(bool((got[r, 1: 1 + c] == want[r, 1: 1 + c]).all())
               for r, c in enumerate(counts))


def lm_parity_phase(torch, np, dev) -> None:
    """reduced(internlm2-1.8b), one set of weights on the card and the CPU:
    prefill logits, the loss, 8 decode steps and greedy tokens."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import model_zoo
    from repro_torch.train import serve

    cfg = reduced(get_config(LM_ARCH))
    cpu = model_zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    b, s, p, n = (LM_PARITY[k] for k in ("batch", "seq", "prompt", "steps"))
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (b, s + 1))
    batch = {"tokens": toks[:, :s], "targets": toks[:, 1:],
             "mask": np.ones((b, s), np.float32)}

    def on(d, arrays):
        return {k: torch.as_tensor(v, device=d, dtype=torch.float32
                                   if k == "mask" else torch.int32)
                for k, v in arrays.items()}

    pre = [model_zoo.prefill_fn(cfg, m, on(d, batch)).cpu().numpy()
           for m, d in ((cpu, "cpu"), (card, dev))]
    with torch.no_grad():
        loss = [float(model_zoo.loss_fn(cfg, m, on(d, batch))[0])
                for m, d in ((cpu, "cpu"), (card, dev))]
    prompt = {"tokens": toks[:, :p]}
    want = serve.greedy_generate(cfg, cpu, on("cpu", prompt)["tokens"],
                                 steps=n, max_len=p + n).numpy()
    got = serve.greedy_generate(cfg, card, on(dev, prompt)["tokens"],
                                steps=n, max_len=p + n).cpu().numpy()
    # teacher-forced on the CPU's sequence: the logits of every decode step
    seq = np.concatenate([toks[:, :p], want[:, 1:]], axis=1)
    logits = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        st = model_zoo.decode_state_init(cfg, b, p + n, device=d)
        steps = []
        for i in range(p + n - 1):
            lo, st = model_zoo.decode_fn(cfg, m, st, on(d, {"tokens": seq[:, i: i + 1]}),
                                         i)
            steps.append(lo.cpu().numpy())
        logits.append(np.stack(steps[p - 1:], axis=1))  # the n generated steps
    compared = lm_near_tie(np, logits[0], LM_TOL)
    ok_pre = np.allclose(pre[1], pre[0], rtol=LM_TOL, atol=LM_TOL)
    ok_dec = np.allclose(logits[1], logits[0], rtol=LM_TOL, atol=LM_TOL)
    same = lm_same_until(got, want, compared)
    emit("lm_parity", arch=cfg.name, batch=b, seq=s, prompt=p, decode_steps=n,
         prefill_max_abs_err=float(np.abs(pre[1] - pre[0]).max()),
         loss_cpu=loss[0], loss_card=loss[1],
         decode_max_abs_err=float(np.abs(logits[1] - logits[0]).max()),
         greedy_compared_steps=compared,
         greedy_equal_all_steps=bool((got == want).all()), tol=LM_TOL,
         loss_tol=LM_LOSS_TOL, card=card_line())
    check(ok_pre, "lm_parity: card prefill logits differ from the CPU's")
    check(abs(loss[1] - loss[0]) <= LM_LOSS_TOL, "lm_parity: loss differs")
    check(ok_dec, "lm_parity: card decode logits differ from the CPU's")
    check(same, "lm_parity: greedy tokens differ before a near-tie")


def lm_serve_phase(torch, np, dev) -> int:
    """Full internlm2-1.8b on the card: a 4 x 2,048 prefill, then 32 greedy
    tokens at max_len 2,080 (the prompt fed a token at a time, as
    greedy_generate does), twice, and once more on the int8 KV cache.
    Returns the parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo, transformer
    from repro_torch.train import serve

    cfg = get_config(LM_ARCH)
    b, s0, n, n8 = (LM_SERVE[k] for k in ("batch", "prompt", "steps", "int8_steps"))
    max_len = s0 + n
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = model_zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = torch.as_tensor(
        np.random.default_rng(12).integers(0, cfg.vocab, (b, s0)),
        dtype=torch.int32, device=dev)
    prefill = serve.build_prefill_step(cfg)
    prefill_s = []
    for _ in range(2):  # the first call pays the libraries' warm-up
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        pre = prefill(model, {"tokens": prompts})
        torch.cuda.synchronize(dev)
        prefill_s.append(time.perf_counter() - t)
    check(pre.shape == (b, cfg.padded_vocab) and bool(torch.isfinite(pre).all()),
          "lm_serve: prefill logits not finite or misshapen")

    def greedy(steps, forced=None):
        """serve.greedy_generate written out (on its GraphedDecode), keeping
        each generated step's logits and the time of the prompt feed and of
        the generation; with ``forced``, feeds those tokens instead of its
        own argmax (teacher forcing)."""
        st = model_zoo.decode_state_init(cfg, b, max_len, device=dev)
        decode = serve.GraphedDecode(cfg, model, st)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for i in range(s0 - 1):
            decode(prompts[:, i: i + 1], i)
        torch.cuda.synchronize(dev)
        feed_s = time.perf_counter() - t
        tok, out, logits = prompts[:, -1:], [prompts[:, :1]], []
        t = time.perf_counter()
        for j in range(steps):
            lo = decode(tok, s0 - 1 + j).clone()
            logits.append(lo)
            tok = torch.argmax(lo, dim=-1)[:, None].to(prompts.dtype)
            out.append(tok)
            if forced is not None:
                tok = forced[:, 1 + j: 2 + j]
        torch.cuda.synchronize(dev)
        gen_s = time.perf_counter() - t
        return torch.cat(out, 1), torch.stack(logits, 1), feed_s, gen_s

    tokens, logits, feed_s, gen_s = greedy(n)
    last = logits[:, 0].cpu().numpy()
    pre = pre.cpu().numpy()
    t = time.perf_counter()
    again = serve.greedy_generate(cfg, model, prompts, steps=n, max_len=max_len)
    torch.cuda.synchronize(dev)
    greedy_s = time.perf_counter() - t
    transformer.KV_INT8 = True
    quant, first = transformer._quant, []

    def recorded(x):  # the first cache's K rows and their int8 form
        q, sc = quant(x)
        if not first:
            first.append((x.detach().clone(), q.clone(), sc.clone()))
        return q, sc

    transformer._quant = recorded
    try:  # teacher-forced on the bf16 run's tokens, as tests/test_serving.py
        tokens8, logits8, _, _ = greedy(n8, forced=tokens)
    finally:
        transformer.KV_INT8 = False
        transformer._quant = quant
    x, q_card, s_card = (t.cpu() for t in first[0])
    q_cpu, s_cpu = quant(x)
    quant_bitwise = bool(torch.equal(q_card, q_cpu) and torch.equal(s_card, s_cpu))
    lo, lo8 = logits[:, :n8].cpu().numpy(), logits8.cpu().numpy()
    compared8 = lm_near_tie(np, lo, LM_TOL)
    same8 = lm_same_until(tokens8.cpu().numpy(), tokens.cpu().numpy(), compared8)
    rel8 = float(np.abs(lo8 - lo).max() / np.abs(lo).max())
    excess = np.abs(last - pre) / (LM_TOL + LM_TOL * np.abs(pre))
    emit("lm_serve", arch=cfg.name, params=n_params, batch=b, prompt=s0,
         steps=n, max_len=max_len, init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=b * s0 / prefill_s[-1],
         prompt_feed_s=feed_s, prompt_feed_ms_per_token=1e3 * feed_s / (s0 - 1),
         decode_ms_per_token=1e3 * gen_s / n, decode_tokens_per_s=b * n / gen_s,
         greedy_generate_s=greedy_s,
         prefill_vs_decode_max_abs_err=float(np.abs(last - pre).max()),
         prefill_vs_decode_worst_over_tol=float(excess.max()),
         prefill_vs_decode_over_tol=int((excess > 1).sum()),
         prefill_logits_max_abs=float(np.abs(pre).max()),
         prefill_vs_decode_argmax_equal=bool(
             (last.argmax(-1) == pre.argmax(-1)).all()),
         runs_identical=bool(torch.equal(tokens, again)),
         int8_steps=n8, int8_max_rel_err=rel8, int8_compared_steps=compared8,
         int8_argmax_equal=int((tokens8[:, 1:] == tokens[:, 1: 1 + n8]).sum()),
         int8_argmax_of=b * n8, int8_quant_values=x.numel(),
         int8_quant_bitwise=quant_bitwise,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         card=card_line())
    # at 24 layers a logit's error is set by the hidden state's, not by the
    # logit's own size: held to LM_TOL of the largest logit (the CPU tests'
    # bound for hidden states), the elementwise excess reported above
    check(np.abs(last - pre).max() <= LM_TOL * np.abs(pre).max(),
          "lm_serve: prefill's last logits differ from step-by-step decode")
    check(torch.equal(tokens, again), "lm_serve: two greedy runs differ")
    check(rel8 < 0.05, "lm_serve: int8 KV logits off by >= 5% of the largest")
    check(same8, "lm_serve: int8 KV argmax differs before a near-tie")
    check(quant_bitwise, "lm_serve: the int8 KV quantizer differs card to CPU")
    return n_params


LM_STEP = re.compile(r"step\s+(\d+) loss=(\S+) acc=(\S+) gnorm=(\S+)")


def lm_train_phase(torch, n_params: int, argv=LM_TRAIN_ARGS, saves=(3, 6),
                   phase: str = "lm_train") -> None:
    """The trainer's entry point (``argv``) in a subprocess, then once more
    to resume from its last checkpoint; ``saves`` are the checkpoints the
    first run leaves."""
    import math
    import os
    import shutil

    arch = argv[argv.index("--arch") + 1]
    ck = ROOT / argv[argv.index("--ckpt-dir") + 1]
    shutil.rmtree(ck, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = []
    for i in range(2):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        (OUT / f"{phase}_{i}.log").write_text(proc.stdout + proc.stderr)
        check(proc.returncode == 0,
              f"{phase} run {i}: exit {proc.returncode}: {proc.stderr[-3000:]}")
        runs.append((proc.stdout, time.perf_counter() - t))
    out, wall = runs[0]
    params = re.search(r"arch=(\S+) params=([0-9.]+)M", out)
    steps = [(int(a), float(l), float(c), float(g))
             for a, l, c, g in LM_STEP.findall(out)]
    timing = dict(kv.split("=", 1) for kv in re.search(
        r"timing: (.*)", out).group(1).split(" ") if "=" in kv)
    saved = sorted(int(p.name.split("_")[1]) for p in ck.glob("step_*"))
    resumed, wall2 = runs[1]
    steps_n = int(argv[argv.index("--steps") + 1])
    tokens = int(argv[argv.index("--batch") + 1]) * int(
        argv[argv.index("--seq") + 1])
    emit(phase, argv=argv, wall_s=wall,
         params_m=float(params.group(2)),
         steps=[dict(step=a, loss=l, acc=c, gnorm=g) for a, l, c, g in steps],
         step_s_median=float(timing["step_s_median"]),
         tokens_per_s=float(timing["tokens_per_s"]), tokens_per_step=tokens,
         peak_mem_bytes=int(timing["peak_mem_bytes"]), checkpoints=saved,
         resume_wall_s=wall2, card=card_line())
    check(params.group(1) == arch and
          abs(float(params.group(2)) - n_params / 1e6) < 0.05,
          f"{phase}: not the full configuration")
    check([a for a, *_ in steps] == [0, steps_n - 1], f"{phase}: step lines")
    check(all(math.isfinite(v) for _, l, _, g in steps for v in (l, g)),
          f"{phase}: a loss or grad norm is not finite")
    check(saved == list(saves), f"{phase}: checkpoints {saved}")
    check(f"done: {steps_n} steps" in out, f"{phase}: no done line")
    check(f"resumed from step {steps_n}" in resumed and "done: 0 steps" in resumed
          and not LM_STEP.findall(resumed), f"{phase}: the resume")
    shutil.rmtree(ck)


def lm_phase(torch, np, dev) -> None:
    """The model zoo's dense LM (`repro_torch.models`): parity with the CPU,
    serving and training internlm2-1.8b at full size.  No kernel of the
    port lies on this path: attention, the MLPs and the loss are plain
    PyTorch, as the reference's are plain jnp."""
    t_phase = time.perf_counter()
    lm_parity_phase(torch, np, dev)
    n_params = lm_serve_phase(torch, np, dev)
    torch.cuda.empty_cache()  # the trainer's process needs the card's memory
    lm_train_phase(torch, n_params)
    emit("lm_done", seconds=time.perf_counter() - t_phase, card=card_line())


# ---------------------------------------------- the rest of the zoo ----
@contextlib.contextmanager
def zoo_fp32(torch):
    """``COMPUTE_DTYPE`` float32 in the port's model modules: the CPU tests'
    fp32 activations for jamba and RWKV-6 (tests/torch_lm_common.py)."""
    import importlib

    mods = [importlib.import_module(f"repro_torch.models.{n}") for n in
            ("layers", "transformer", "encdec", "mamba", "rwkv6", "model_zoo")]
    saved = [(m, m.COMPUTE_DTYPE) for m in mods if hasattr(m, "COMPUTE_DTYPE")]
    for m, _ in saved:
        m.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, dt in saved:
            m.COMPUTE_DTYPE = dt


@contextlib.contextmanager
def zoo_routing(torch):
    """While open, every MoE dispatch group of the port is recorded on the
    host, in call order, as (probs, top-k, keep)."""
    from repro_torch.models import moe

    rec, real = [], moe._moe_chunk

    def chunk(cfg, p, xt):
        with torch.no_grad():
            probs, _, tope = moe.route(cfg, p, xt)
            _, keep = moe.slots(cfg, tope, moe.capacity(cfg, xt.shape[0]))
        rec.append((probs.cpu().numpy(), tope.cpu().numpy(),
                    keep.reshape(tope.shape).cpu().numpy()))
        return real(cfg, p, xt)

    moe._moe_chunk = chunk
    try:
        yield rec
    finally:
        moe._moe_chunk = real


@contextlib.contextmanager
def zoo_drops(torch, groups: int, dev):
    """While open, each MoE layer's dropped choices (past an expert's
    capacity) add up on the device, ``groups`` layers a forward in turn:
    the count is part of the step, so a CUDA graph replays it too."""
    from repro_torch.models import moe

    counts = torch.zeros(groups, dtype=torch.int64, device=dev)
    real, calls = moe.slots, [0]

    def slots(cfg, tope, cap):
        slot, keep = real(cfg, tope, cap)
        counts[calls[0] % groups].add_((~keep).sum())
        calls[0] += 1
        return slot, keep

    moe.slots = slots
    try:
        yield counts
    finally:
        moe.slots = real


def zoo_group_diff(np, want, got):
    """One dispatch group, CPU (``want``) against the card (``got``), by
    the CPU tests' rule (tests/torch_lm_common.py::routing_diff): (tokens
    whose experts or kept experts differ, flips [(token, gap)], bad)."""
    probs, wt, wk = want
    _, gt, gk = got
    e, k = probs.shape[1], wt.shape[1]

    def experts(tope, keep):
        rows = np.arange(len(tope))[:, None]
        out = np.zeros((len(tope), 2 * e), bool)
        out[rows, tope] = True
        out[rows, e + tope] = keep
        return out

    wx, gx = experts(wt, wk), experts(gt, gk)
    chose = (wx[:, :e] != gx[:, :e]).any(1)
    kept = (wx[:, e:] != gx[:, e:]).any(1)
    srt = np.sort(probs, axis=-1)[:, ::-1]
    gap = srt[:, k - 1] - srt[:, k]
    flips = [(int(t), float(gap[t])) for t in np.flatnonzero(chose)]
    bad = [f for f in flips if f[1] >= ZOO_ROUTE_EPS]
    first = np.flatnonzero(chose)[0] if chose.any() else len(chose)
    bad += [(int(t), None) for t in np.flatnonzero(kept & ~chose) if t <= first]
    return chose | kept, flips, bad


def zoo_taint(np, want, got, b: int, n: int, decode: bool):
    """Rows and positions [b, n] whose values may rightly differ after the
    recorded groups: prefill (each group over b * n tokens; a token and the
    rest of its row) or decode (n steps, each the same number of groups
    over b tokens; a row from that step on).  Returns (taint, flips, bad)."""
    taint = np.zeros((b, n), bool)
    flips, bad = [], []
    per = len(want) // n if decode else len(want)
    for g, (w, c) in enumerate(zip(want, got)):
        diff, fl, bd = zoo_group_diff(np, w, c)
        clean = ~(taint[:, g // per] if decode else taint.reshape(-1))
        flips += [(g, t, gap) for t, gap in fl if clean[t]]
        bad += [(g, t, gap) for t, gap in bd if clean[t]]
        if decode:
            taint[:, g // per:] |= diff[:, None]
        else:
            taint = np.maximum.accumulate(taint | diff.reshape(b, n), axis=1)
    return taint, flips, bad


def zoo_parity(torch, np, dev, arch: str) -> dict:
    """reduced(arch), one set of weights on the CPU and the card: prefill
    logits, loss and aux, teacher-forced decode and greedy tokens."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import encdec, model_zoo
    from repro_torch.train import serve

    cfg = reduced(get_config(arch))
    b, s, p, n = (ZOO_PARITY[k] for k in ("batch", "seq", "prompt", "steps"))
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    host = {"tokens": toks[:, :s].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32)}
    if cfg.enc_layers:
        fd = cfg.frontend_dim or cfg.d_model
        host["frames"] = rng.normal(0, 0.02, (b, s, fd)).astype(np.float32)
    cpu = model_zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    runs = (("cpu", cpu), (dev, card))

    def on(d, arrays):
        return {k: torch.as_tensor(v, device=d) for k, v in arrays.items()}

    pre, loss, aux, routes = [], [], [], []
    for d, m in runs:
        with zoo_routing(torch) as rec, torch.no_grad():
            pre.append(model_zoo.prefill_fn(cfg, m, on(d, host)).cpu().numpy())
            lo, met = model_zoo.loss_fn(cfg, m, on(d, host))
        loss.append(float(lo))
        aux.append(float(met["aux"]))
        routes.append(rec[: len(rec) // 2])  # prefill's groups (loss repeats them)
    taint, flips, bad = zoo_taint(np, *routes, b, s, decode=False)

    # greedy on the CPU, then both devices teacher-forced on its tokens
    memory = None
    if cfg.enc_layers:
        with torch.no_grad():
            memory = encdec.encode(cfg, cpu, on("cpu", host)["frames"])

    def step_batch(d, col):
        out = {"tokens": torch.as_tensor(col, device=d)}
        if memory is not None:
            out["memory"] = memory.to(d)
        return out

    def greedy(d, m):
        if memory is None:
            return serve.greedy_generate(
                cfg, m, torch.as_tensor(host["tokens"][:, :p], device=d),
                steps=n, max_len=p + n).cpu().numpy()
        st = model_zoo.decode_state_init(cfg, b, p + n, device=d)
        out, tok = [host["tokens"][:, :1]], None
        for i in range(p + n - 1):
            col = host["tokens"][:, i: i + 1] if i < p else tok
            lo, st = model_zoo.decode_fn(cfg, m, st, step_batch(d, col), i)
            if i >= p - 1:
                tok = lo.argmax(-1)[:, None].cpu().numpy().astype(np.int32)
                out.append(tok)
        return np.concatenate(out, axis=1)

    want = greedy("cpu", cpu)
    got = greedy(dev, card)
    seq = np.concatenate([host["tokens"][:, :p], want[:, 1:]], axis=1)
    logits, droutes = [], []
    for d, m in runs:
        st = model_zoo.decode_state_init(cfg, b, p + n, device=d)
        steps = []
        with zoo_routing(torch) as rec:
            for i in range(p + n - 1):
                lo, st = model_zoo.decode_fn(cfg, m, st,
                                             step_batch(d, seq[:, i: i + 1]), i)
                steps.append(lo.cpu().numpy())
        logits.append(np.stack(steps[p - 1:], axis=1))  # the n generated steps
        droutes.append(rec)
    dtaint, dflips, dbad = zoo_taint(np, *droutes, b, p + n - 1, decode=True)
    dtaint = dtaint[:, p - 1:]
    compared = lm_near_tie(np, logits[0], LM_TOL)
    compared = [min(c, int(np.argmax(t)) if t.any() else n)
                for c, t in zip(compared, dtaint)]
    rows = ~taint[:, -1]
    ok_pre = np.allclose(pre[1][rows], pre[0][rows], rtol=LM_TOL, atol=LM_TOL)
    clean = ~dtaint
    ok_dec = np.allclose(logits[1][clean], logits[0][clean], rtol=LM_TOL,
                         atol=LM_TOL)
    aux_tol = ZOO_AUX_TOL if not taint.any() else LM_TOL
    line = dict(arch=cfg.name, fp32_activations=arch in ZOO_FP32, batch=b,
                seq=s, prompt=p, decode_steps=n,
                prefill_max_abs_err=float(np.abs(pre[1] - pre[0])[rows].max())
                if rows.any() else None,
                loss_cpu=loss[0], loss_card=loss[1], aux_cpu=aux[0],
                aux_card=aux[1],
                decode_max_abs_err=float(np.abs(logits[1] - logits[0])[clean].max())
                if clean.any() else None,
                routing_flips=flips + dflips, tokens_tainted=int(taint.sum()),
                decode_steps_tainted=int(dtaint.sum()),
                greedy_compared_steps=compared,
                greedy_equal_all_steps=bool((got == want).all()))
    emit("lm_zoo_parity", **line, tol=LM_TOL, loss_tol=LM_LOSS_TOL,
         route_eps=ZOO_ROUTE_EPS, card=card_line())
    check(not bad and not dbad, f"{arch}: a routing flip above {ZOO_ROUTE_EPS}")
    check(ok_pre, f"{arch}: card prefill logits differ from the CPU's")
    check(abs(loss[1] - loss[0]) <= LM_LOSS_TOL, f"{arch}: loss differs")
    check(abs(aux[1] - aux[0]) <= aux_tol * abs(aux[0]), f"{arch}: aux differs")
    check(ok_dec, f"{arch}: card decode logits differ from the CPU's")
    check(lm_same_until(got, want, compared),
          f"{arch}: greedy tokens differ before a near-tie or a flip")
    return line


def zoo_greedy(torch, cfg, model, prompts, steps: int, max_len: int):
    """serve.greedy_generate written out on its GraphedDecode: (tokens
    [B, 1 + steps], the prompt's last logits, prompt feed s, generation
    s)."""
    from repro_torch.models import model_zoo
    from repro_torch.train import serve

    dev = prompts.device
    b, s0 = prompts.shape
    decode = serve.GraphedDecode(
        cfg, model, model_zoo.decode_state_init(cfg, b, max_len, device=dev))
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for i in range(s0 - 1):
        decode(prompts[:, i: i + 1], i)
    torch.cuda.synchronize(dev)
    feed_s = time.perf_counter() - t
    tok, out = prompts[:, -1:], [prompts[:, :1]]
    t = time.perf_counter()
    for j in range(steps):
        lo = decode(tok, s0 - 1 + j)
        if j == 0:
            first = lo.float().cpu().numpy()
        tok = torch.argmax(lo, dim=-1)[:, None].to(prompts.dtype)
        out.append(tok)
    torch.cuda.synchronize(dev)
    return torch.cat(out, 1), first, feed_s, time.perf_counter() - t


def zoo_prefill(torch, model_zoo, cfg, model, batch, dev, runs: int = 2):
    """``prefill_fn`` ``runs`` times (the first pays the libraries'
    warm-up): (last-position logits on the host, seconds of each run)."""
    secs = []
    for _ in range(runs):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        pre = model_zoo.prefill_fn(cfg, model, batch)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t)
    check(pre.shape == (batch["tokens"].shape[0], cfg.padded_vocab)
          and bool(torch.isfinite(pre).all()),
          f"{cfg.name}: prefill logits not finite or misshapen")
    return pre.float().cpu().numpy(), secs


def zoo_init(torch, cfg, dev):
    from repro_torch.models import model_zoo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model = model_zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize(dev)
    return model, sum(q.numel() for q in model.parameters()), \
        time.perf_counter() - t


def zoo_tokens(torch, np, cfg, shape, seed, dev):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, shape), dtype=torch.int32, device=dev)


def zoo_serve_moe(torch, np, dev, arch: str, spec: dict) -> None:
    """An MoE LM at full width, ``spec["layers"]`` layers: a prefill, then
    greedy tokens after a prompt, twice; the choices dropped per layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo, moe
    from repro_torch.train import serve

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    b, k = spec["batch"], cfg.moe.top_k
    groups = cfg.n_blocks * len(cfg.moe_slots)
    model, n_params, init_s = zoo_init(torch, cfg, dev)
    with zoo_drops(torch, groups, dev) as drops:
        pre, prefill_s = zoo_prefill(
            torch, model_zoo, cfg, model,
            {"tokens": zoo_tokens(torch, np, cfg, (b, spec["prefill"]), 31, dev)},
            dev)
        prefill_drops = (drops // len(prefill_s)).tolist()
        drops.zero_()
        prompts = zoo_tokens(torch, np, cfg, (b, spec["prompt"]), 32, dev)
        max_len = spec["prompt"] + spec["steps"]
        tokens, _, feed_s, gen_s = zoo_greedy(torch, cfg, model, prompts,
                                              spec["steps"], max_len)
        decode_steps = max_len - 1
        decode_drops = drops.tolist()
    again = serve.greedy_generate(cfg, model, prompts, steps=spec["steps"],
                                  max_len=max_len)
    torch.cuda.synchronize(dev)
    emit("lm_zoo_serve", arch=arch, layers=f"{cfg.n_layers} of {full.n_layers}",
         reduced={"n_layers": [full.n_layers, cfg.n_layers]}, params=n_params,
         init_s=init_s, batch=b, prefill=spec["prefill"], prefill_s=prefill_s,
         prefill_tokens_per_s=b * spec["prefill"] / prefill_s[-1],
         capacity_prefill=moe.capacity(cfg, b * spec["prefill"]),
         capacity_decode=moe.capacity(cfg, b),
         prefill_dropped_per_layer=prefill_drops,
         prefill_choices_per_layer=b * spec["prefill"] * k,
         prompt=spec["prompt"], steps=spec["steps"],
         decode_dropped_per_layer=decode_drops,
         decode_choices_per_layer=decode_steps * b * k,
         prompt_feed_ms_per_token=1e3 * feed_s / (spec["prompt"] - 1),
         decode_ms_per_token=1e3 * gen_s / spec["steps"],
         decode_tokens_per_s=b * spec["steps"] / gen_s,
         runs_identical=bool(torch.equal(tokens, again)),
         prefill_logits_max_abs=float(np.abs(pre).max()),
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         card=card_line())
    check(torch.equal(tokens, again), f"{arch}: two greedy runs differ")
    check(bool(np.isfinite(pre).all()), f"{arch}: prefill not finite")


def zoo_train_in_process(torch, np, dev, arch: str, spec: dict,
                         moe_leaf: str | None = None) -> None:
    """``train/loop.py`` at full width, ``spec["train_layers"]`` layers:
    ``train_steps`` AdamW steps on B x S random tokens; loss, aux and grad
    norm finite, and with ``moe_leaf`` the router's first moment non-zero
    after the first step (its gradient was) and the aux loss positive."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.train import loop as train_loop
    from repro_torch.train.optimizer import AdamWConfig

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=spec["train_layers"])
    b, s, n = spec["train_batch"], spec["train_seq"], spec["train_steps"]
    tcfg = train_loop.TrainConfig(
        adamw=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=n))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt = train_loop.init_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(q.numel() for q in params.parameters())
    step_fn = train_loop.build_train_step(cfg, tcfg)
    rng = np.random.default_rng(33)
    out, step_s, router_moment = [], [], None
    for i in range(n):
        toks = rng.integers(0, cfg.vocab, (b, s))
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev),
                 "targets": torch.as_tensor(np.roll(toks, -1, 1),
                                            dtype=torch.int32, device=dev),
                 "mask": torch.ones((b, s), dtype=torch.float32, device=dev)}
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t)
        out.append(dict(step=i, loss=float(met["loss"]),
                        grad_norm=float(met["grad_norm"])))
        if i == 0 and moe_leaf:
            router_moment = float(opt["m"][moe_leaf].float().abs().max())
    with torch.no_grad():
        _, met = model_zoo.loss_fn(cfg, params, batch)
    aux = float(met["aux"])
    emit("lm_zoo_train", arch=arch, layers=f"{cfg.n_layers} of {full.n_layers}",
         reduced={"n_layers": [full.n_layers, cfg.n_layers]}, params=n_params,
         batch=b, seq=s, steps=out, step_s=step_s,
         step_s_median=statistics.median(step_s),
         tokens_per_s=b * s / statistics.median(step_s), aux_after=aux,
         router_first_moment_max=router_moment,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         card=card_line())
    check(all(math.isfinite(v) for r in out for v in (r["loss"], r["grad_norm"]))
          and math.isfinite(aux), f"{arch} train: a loss or grad norm not finite")
    if moe_leaf:
        check(aux > 0, f"{arch} train: aux loss not positive")
        check(router_moment and router_moment > 0,
              f"{arch} train: the router got no gradient")
    del params, opt
    torch.cuda.empty_cache()


def zoo_rwkv(torch, np, dev) -> None:
    """rwkv6-7b at full size: a prefill, then greedy tokens after the same
    prompt, twice (the first run's decode logits of the prompt's last
    token beside the prefill's), all in bf16; then the prefill held
    against step-by-step decode of the same tokens with fp32 activations,
    as the CPU tests hold RWKV-6 (in bf16 its 32 layers amplify the two
    paths' rounding: the bf16 difference is reported beside it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.train import serve

    cfg = get_config("rwkv6-7b")
    b, s0, n = RWKV["batch"], RWKV["prompt"], RWKV["steps"]
    model, n_params, init_s = zoo_init(torch, cfg, dev)
    prompts = zoo_tokens(torch, np, cfg, (b, s0), 34, dev)
    pre, prefill_s = zoo_prefill(torch, model_zoo, cfg, model,
                                 {"tokens": prompts}, dev)
    tokens, last, feed_s, gen_s = zoo_greedy(torch, cfg, model, prompts, n,
                                             s0 + n)
    again = serve.greedy_generate(cfg, model, prompts, steps=n, max_len=s0 + n)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    with zoo_fp32(torch):
        pre32, prefill32_s = zoo_prefill(torch, model_zoo, cfg, model,
                                         {"tokens": prompts}, dev, runs=1)
        _, last32, _, _ = zoo_greedy(torch, cfg, model, prompts, 1, s0 + 1)
    err, err32 = float(np.abs(last - pre).max()), float(np.abs(last32 - pre32).max())
    emit("lm_zoo_serve", arch=cfg.name, layers=f"{cfg.n_layers} of {cfg.n_layers}",
         reduced={}, params=n_params, init_s=init_s, batch=b, prefill=s0,
         prefill_s=prefill_s, prefill_tokens_per_s=b * s0 / prefill_s[-1],
         prefill_wkv_steps=s0 * cfg.n_layers,
         prefill_vs_decode_max_abs_err_bf16=err,
         prefill_logits_max_abs_bf16=float(np.abs(pre).max()),
         prefill_vs_decode_argmax_equal_bf16=bool(
             (last.argmax(-1) == pre.argmax(-1)).all()),
         prefill_vs_decode_max_abs_err_fp32=err32,
         prefill_logits_max_abs_fp32=float(np.abs(pre32).max()),
         prefill_s_fp32=prefill32_s,
         prompt=s0, steps=n,
         prompt_feed_ms_per_token=1e3 * feed_s / (s0 - 1),
         decode_ms_per_token=1e3 * gen_s / n,
         decode_tokens_per_s=b * n / gen_s,
         runs_identical=bool(torch.equal(tokens, again)),
         max_memory_allocated=peak, card=card_line())
    check(err32 <= LM_TOL * np.abs(pre32).max(),
          "rwkv6-7b: prefill's last logits differ from step-by-step decode")
    check(torch.equal(tokens, again), "rwkv6-7b: two greedy runs differ")
    del model
    torch.cuda.empty_cache()


def zoo_jamba_mamba(torch, np, dev) -> None:
    """jamba-1.5-large-398b's Mamba layer alone at full width (no depth of
    the model fits one card): ``mamba_apply`` on [2, 1,024] against 1,024
    ``mamba_decode`` steps from zero states, and timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba

    cfg = get_config("jamba-1.5-large-398b")
    mc = cfg.mamba
    b, L = JAMBA_MAMBA["batch"], JAMBA_MAMBA["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = mamba.mamba_init(cfg, generator=gen, device=dev)
    n_params = sum(q.numel() for q in p.parameters())
    x = torch.randn((b, L, cfg.d_model), generator=gen, device=dev).bfloat16()
    apply_s = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            y = mamba.mamba_apply(cfg, p, x)
            torch.cuda.synchronize(dev)
            apply_s.append(time.perf_counter() - t)
        st = mamba.mamba_decode_init(cfg, b, 1, device=dev)
        outs = []
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for i in range(L):
            outs.append(mamba.mamba_decode(cfg, p, x[:, i: i + 1],
                                           st["conv"][0], st["h"][0]))
        torch.cuda.synchronize(dev)
        decode_s = time.perf_counter() - t
        dec = torch.cat(outs, 1).float()
        y = y.float()
        # the same layer with fp32 activations (the scan inputs stay bf16)
        y32 = mamba.mamba_apply(cfg, p, x.float())
        st = mamba.mamba_decode_init(cfg, b, 1, device=dev)
        st = {k: v.float() for k, v in st.items()}
        dec32 = torch.cat([mamba.mamba_decode(cfg, p, x[:, i: i + 1].float(),
                                              st["conv"][0], st["h"][0])
                           for i in range(L)], 1)
    err, top = float((dec - y).abs().max()), float(y.abs().max())
    err32 = float((dec32 - y32).abs().max())
    emit("lm_zoo_mamba", arch=cfg.name, d_model=cfg.d_model,
         d_inner=mc.expand * cfg.d_model, d_state=mc.d_state, chunk=mc.chunk,
         batch=b, seq=L, params=n_params,
         reduced={"layers": "one Mamba layer alone; one 8-layer block is "
                            "45.238 B parameters"},
         apply_s=apply_s, decode_ms_per_step=1e3 * decode_s / L,
         apply_vs_decode_max_abs_err=err, apply_max_abs=top,
         apply_vs_decode_max_abs_err_fp32=err32,
         apply_max_abs_fp32=float(y32.abs().max()),
         finite=bool(torch.isfinite(y).all()),
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         card=card_line())
    check(bool(torch.isfinite(y).all()), "jamba Mamba: output not finite")
    check(err <= LM_TOL * top, "jamba Mamba: apply differs from decode")
    del p, x, y, dec, outs, y32, dec32
    torch.cuda.empty_cache()


def zoo_seamless(torch, np, dev) -> int:
    """seamless-m4t-medium at full size: ``prefill_fn`` with frames, then
    ``decode_fn`` steps against its encoder memory, held against a prefill
    of the same tokens.  Returns the parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, model_zoo

    cfg = get_config("seamless-m4t-medium")
    b, s, k = S2S["batch"], S2S["seq"], S2S["prefix"]
    model, n_params, init_s = zoo_init(torch, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    fd = cfg.frontend_dim or cfg.d_model
    frames = torch.randn((b, s, fd), generator=gen, device=dev) * 0.02
    toks = zoo_tokens(torch, np, cfg, (b, s), 35, dev)
    pre, prefill_s = zoo_prefill(torch, model_zoo, cfg, model,
                                 {"tokens": toks, "frames": frames}, dev)
    short, _ = zoo_prefill(torch, model_zoo, cfg, model,
                           {"tokens": toks[:, :k], "frames": frames}, dev, runs=1)
    with torch.no_grad():
        memory = encdec.encode(cfg, model, frames)
    st = model_zoo.decode_state_init(cfg, b, k, device=dev)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for i in range(k):
        lo, st = model_zoo.decode_fn(cfg, model, st, {
            "tokens": toks[:, i: i + 1], "memory": memory}, i)
    torch.cuda.synchronize(dev)
    decode_s = time.perf_counter() - t
    lo = lo.float().cpu().numpy()
    err = float(np.abs(lo - short).max())
    emit("lm_zoo_serve", arch=cfg.name, layers=f"{cfg.enc_layers} + {cfg.n_layers}",
         reduced={}, params=n_params, init_s=init_s, batch=b, prefill=s,
         frames=list(frames.shape), prefill_s=prefill_s,
         prefill_tokens_per_s=b * s / prefill_s[-1], memory_rows=s,
         decode_steps=k, decode_ms_per_token=1e3 * decode_s / k,
         decode_vs_prefill_max_abs_err=err,
         prefill_logits_max_abs=float(np.abs(short).max()),
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         card=card_line())
    check(bool(np.isfinite(lo).all()), "seamless: decode logits not finite")
    check(err <= LM_TOL * np.abs(short).max(),
          "seamless: decode against the memory differs from prefill")
    del model, memory, st
    torch.cuda.empty_cache()
    return n_params


def lm_zoo_phase(torch, np, dev) -> None:
    """The rest of the model zoo (`repro_torch.models.{moe,mamba,rwkv6,
    encdec}`): parity of the five reduced configs between the card and the
    CPU, then each at its published width.  Plain PyTorch, as the
    reference's plain jnp: no kernel of the port on this path."""
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    for arch in ZOO_ARCHS:
        ctx = zoo_fp32(torch) if arch in ZOO_FP32 else contextlib.nullcontext()
        with ctx:
            timed(f"parity_{arch}", zoo_parity, torch, np, dev, arch)
    timed("mixtral_serve", zoo_serve_moe, torch, np, dev, "mixtral-8x7b", MIXTRAL)
    timed("mixtral_train", zoo_train_in_process, torch, np, dev,
          "mixtral-8x7b", MIXTRAL, "blocks.0.slot0.moe.router")
    timed("qwen3_serve", zoo_serve_moe, torch, np, dev,
          "qwen3-moe-235b-a22b", QWEN)
    timed("rwkv_serve", zoo_rwkv, torch, np, dev)
    timed("rwkv_train", zoo_train_in_process, torch, np, dev, "rwkv6-7b", RWKV)
    timed("jamba_mamba", zoo_jamba_mamba, torch, np, dev)
    n_params = timed("seamless_serve", zoo_seamless, torch, np, dev)
    timed("seamless_train", lm_train_phase, torch, n_params, S2S_TRAIN_ARGS,
          (2, 4), "lm_zoo_train_s2s")
    emit("lm_zoo_done", seconds=time.perf_counter() - t_phase,
         seconds_by_run=seconds, card=card_line())


# ------------------------------------------------------------------ dist ----
def dist_pipeline(torch, ops, sg, device: str = "cuda:0") -> int:
    """The read pipeline on the card: the serve phase's first DIST_READS
    reads through ReadBatches -> Prefetcher -> map_stream on cuda_dc_v2,
    against `map_batch` called directly on the same batches and against
    the serve phase's PAF rows.  Returns the stream's v2 launches."""
    from types import SimpleNamespace

    from repro_torch.core import mapper
    from repro_torch.genomics import io, pipeline

    dev = torch.device(device)
    svc = sg.setup(sg.parse_args(FULL_ARGS + ["--reads", str(FULL_READS),
                                              "--device", device]))
    reads = list(svc.reads[:DIST_READS])
    c = svc.config
    cap = min(b for b in c.buckets if b >= max(len(r) for r in reads))
    kw = dict(cfg=c.genasm, p_cap=cap, filter_bits=min(c.filter_bits, cap),
              filter_k=c.filter_k, max_candidates=c.max_candidates,
              minimizer_w=c.minimizer_w, minimizer_k=c.minimizer_k,
              backend="cuda_dc_v2")
    index, _ = svc.index.current()
    batches = pipeline.ReadBatches(reads, batch=DIST_BATCH, cap=cap)

    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    direct = {b: mapper.map_batch(index, torch.from_numpy(arr).to(dev),
                                  torch.from_numpy(lens).to(dev), **kw)
              for b, arr, lens in batches}
    torch.cuda.synchronize(dev)
    direct_s = time.perf_counter() - t

    ops.reset_launch_counts()
    t = time.perf_counter()
    streamed = {}
    with pipeline.Prefetcher(iter(batches), device=dev) as pf:
        for b, res in pipeline.map_stream(index, pf, **kw):
            streamed[b] = res
    torch.cuda.synchronize(dev)
    stream_s = time.perf_counter() - t
    launches = ops.launch_counts()

    same = sorted(streamed) == sorted(direct) and all(
        torch.equal(getattr(streamed[b], f), getattr(direct[b], f))
        for b in direct for f in direct[b]._fields)
    rows = []
    for b, res in sorted(streamed.items()):
        fields = {f: getattr(res, f).cpu().numpy() for f in
                  ("position", "distance", "ops", "n_ops")}
        for i in range(DIST_BATCH):
            gid = b * DIST_BATCH + i
            if gid < len(reads) and fields["position"][i] >= 0:
                rows.append(sg.paf_row(gid, SimpleNamespace(
                    read_len=min(len(reads[gid]), cap),
                    position=int(fields["position"][i]),
                    distance=int(fields["distance"][i]),
                    ops=fields["ops"][i], n_ops=int(fields["n_ops"][i])),
                    svc.ref_len))
    io.write_paf(OUT / "dist_stream.paf", sg.strip_gids(rows))
    want = paf_lines_below(OUT / "full_cuda_dc_v2.paf", DIST_READS)
    got = (OUT / "dist_stream.paf").read_text().splitlines()
    emit("dist_stream", reads=len(reads), batch=DIST_BATCH, cap=cap,
         batches=len(streamed), rows=len(got), serve_rows=len(want),
         identical_rows=got == want, equal_to_map_batch=same,
         stream_s=stream_s, stream_reads_per_s=len(reads) / stream_s,
         direct_s=direct_s, direct_reads_per_s=len(reads) / direct_s,
         launches=launches, card=card_line())
    check(same, "map_stream differs from map_batch on the same batches")
    check(got == want, "the stream's PAF rows differ from the serve phase's")
    check(launches["window_dc_batch_v2"] > 0, "dist stream: v2 not launched")
    return launches["window_dc_batch_v2"]


def dist_batch(torch, np, cfg, rng, b: int, s: int, dev) -> dict:
    toks = rng.integers(0, cfg.vocab, (b, s))
    return {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev),
            "targets": torch.as_tensor(np.roll(toks, -1, 1), dtype=torch.int32,
                                       device=dev),
            "mask": torch.ones((b, s), dtype=torch.float32, device=dev)}


def dist_steps(torch, dev, step, model, opt, batches, mesh=None) -> list[dict]:
    """``step`` over ``batches``: loss, grad norm and seconds of each; with
    a mesh the batches go in as DTensors (``batch_specs``)."""
    from repro_torch.dist import sharding as shd

    out = []
    for b in batches:
        if mesh is not None:
            b = shd.shard_put(b, mesh, shd.batch_specs(b, mesh))
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        _, opt, met = step(model, opt, b)
        torch.cuda.synchronize(dev)
        out.append(dict(loss=float(met["loss"]),
                        grad_norm=float(met["grad_norm"]),
                        step_s=time.perf_counter() - t))
    return out


def dist_sharded_vs_plain(torch, dev, cfg, tcfg, model, batches) -> dict:
    """Train ``model`` over ``batches`` unsharded, then from the same
    weights on a 1x1 ("data", "model") mesh with DTensor parameters,
    optimizer state and batches; returns both runs and their peak device
    memory."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt_mod

    w0 = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = opt_mod.init(tcfg.adamw, dict(model.named_parameters()))
    plain = dist_steps(torch, dev, loop.build_train_step(cfg, tcfg), model,
                       opt, batches)
    plain_peak = torch.cuda.max_memory_allocated(dev)
    del opt
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w0[k])
    del w0
    mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cuda")
    pspecs = shd.param_specs(model, mesh)
    opt = opt_mod.init(tcfg.adamw, dict(model.named_parameters()))
    opt = {"step": opt["step"], "m": shd.shard_put(opt["m"], mesh, pspecs),
           "v": shd.shard_put(opt["v"], mesh, pspecs)}
    shd.shard_put(model, mesh, pspecs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sharded = dist_steps(torch, dev, loop.build_train_step(cfg, tcfg, mesh),
                         model, opt, batches, mesh)
    return {"plain": plain, "plain_peak": plain_peak, "sharded": sharded,
            "sharded_peak": torch.cuda.max_memory_allocated(dev),
            "placements": {k: [repr(x) for x in p.placements]
                           for k, p in list(model.named_parameters())[:3]}}


def dist_close(runs: dict) -> bool:
    return all(abs(s["loss"] - p["loss"]) <= DIST_LOSS_TOL and
               abs(s["grad_norm"] - p["grad_norm"]) <= DIST_REL_TOL * abs(p["grad_norm"])
               for s, p in zip(runs["sharded"], runs["plain"]))


def dist_compress(torch, dev, grad) -> None:
    """`train.grad_compress` on ``grad`` (one fp32 vector) on the card: the
    first DIST_BITWISE values' int8 payload, scales and dequantized values
    against the CPU bit for bit; CUDA-event times beside the bytes bound;
    the pod mean over a one-rank pod group against its formula."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import grad_compress as gc

    card = card_line()
    n = grad.numel()
    q, scale, _ = gc._quantize(grad)
    m, blocks = DIST_BITWISE, DIST_BITWISE // gc.BLOCK
    cq, cs, _ = gc._quantize(grad[:m].cpu())
    bitwise = (torch.equal(q[:blocks].cpu(), cq)
               and torch.equal(scale[:blocks].cpu(), cs)
               and torch.equal(gc._dequantize(q[:blocks], scale[:blocks], m).cpu(),
                               gc._dequantize(cq, cs, m)))
    quant_ms = time_ms(torch, lambda: gc._quantize(grad), trials=3)
    deq_ms = time_ms(torch, lambda: gc._dequantize(q, scale, n), trials=3)
    n_pad = q.numel()
    quant_bytes = 4 * n + n_pad + 4 * scale.numel()
    deq_bytes = n_pad + 4 * scale.numel() + 4 * n
    del q, scale

    pod = make_debug_mesh((1,), ("pod",), device_type="cuda")
    x = grad[:DIST_PSUM]
    r = 1e-3 * torch.roll(x, 1)
    mean, resid = gc.compressed_psum_mean(x, r, pod.get_group("pod"))
    xf = x + r
    q1, s1, _ = gc._quantize(xf)
    local = gc._dequantize(q1, s1, x.numel())
    # the reference's formula at one pod: qsum = q, ssum = scale, nsh = 1
    want = (q1.to(torch.int32).float() * (s1 / 1.0)).reshape(-1)[:x.numel()] / 1.0
    tree = gc.make_pod_compressed_allreduce(pod, {"g": ()})({"g": x}, {"g": r})
    psum_ok = (torch.equal(mean, want) and torch.equal(resid, xf - local)
               and torch.equal(tree[0]["g"], mean))
    emit("dist_compress", values=n, bytes=4 * n, block=gc.BLOCK,
         bitwise_values=m, card_equals_cpu=bitwise,
         quantize_ms=quant_ms,
         quantize_bound_ms=quant_bytes / memory_bytes_per_s(card) * 1e3,
         dequantize_ms=deq_ms,
         dequantize_bound_ms=deq_bytes / memory_bytes_per_s(card) * 1e3,
         pod_mean_values=x.numel(), pod_mean_equals_formula=psum_ok,
         card=card)
    check(bitwise, "int8 compression: the card differs from the CPU")
    check(psum_ok, "the one-pod mean differs from its formula")


def dist_train(torch, np, dev) -> None:
    """internlm2-1.8b at full size, sharded against unsharded, and the
    compression on its whole gradient."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config(LM_ARCH)
    spec = DIST_TRAIN
    tcfg = loop.TrainConfig(microbatches=spec["microbatches"],
                            adamw=AdamWConfig(warmup_steps=1))
    model = model_zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(40)
    batches = [dist_batch(torch, np, cfg, rng, spec["batch"], spec["seq"], dev)
               for _ in range(spec["steps"])]
    # the gradient that the compression runs on: one forward and backward
    loss, _ = model_zoo.loss_fn(cfg, model, batches[0])
    loss.backward()
    grad = torch.cat([p.grad.flatten() for p in model.parameters()])
    for p in model.parameters():
        p.grad = None
    dist_compress(torch, dev, grad)
    del grad, loss
    runs = dist_sharded_vs_plain(torch, dev, cfg, tcfg, model, batches)
    ok = dist_close(runs)
    emit("dist_train", arch=LM_ARCH, params=n_params, mesh="1x1 (data, model)",
         **spec, adamw=tcfg.adamw._asdict(), **runs,
         loss_tol=DIST_LOSS_TOL, grad_norm_rel_tol=DIST_REL_TOL, close=ok,
         card=card_line())
    check(n_params > 1.88e9, "dist train: not the full configuration")
    check(ok, "dist train: the sharded steps differ from the unsharded")
    del model
    torch.cuda.empty_cache()


def dist_moe(torch, np, dev) -> None:
    """The CPU tests' reduced mixtral, sharded against unsharded with fp32
    activations: `moe._constrain` runs on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import model_zoo, moe
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamWConfig

    cfg = reduced(get_config("mixtral-8x7b"))
    tcfg = loop.TrainConfig(microbatches=2, adamw=AdamWConfig(
        lr=5e-3, warmup_steps=2, total_steps=50))
    calls, real = [0], moe._constrain

    def counted(x, mesh, want):
        calls[0] += mesh is not None
        return real(x, mesh, want)

    moe._constrain = counted
    try:
        with zoo_fp32(torch):
            model = model_zoo.init(cfg, torch.Generator(device=dev).manual_seed(1),
                                   device=dev)
            rng = np.random.default_rng(41)
            batches = [dist_batch(torch, np, cfg, rng, 4, 32, dev)]
            runs = dist_sharded_vs_plain(torch, dev, cfg, tcfg, model, batches)
    finally:
        moe._constrain = real
    ok = dist_close(runs)
    emit("dist_moe", arch=cfg.name, plain=runs["plain"], sharded=runs["sharded"],
         constrain_calls=calls[0], close=ok, card=card_line())
    check(calls[0] > 0, "dist moe: the dispatch constraint did not run")
    check(ok, "dist moe: the sharded step differs from the unsharded")


def dist_child() -> int:
    """``chip_smoke.py --dist-child``: the dist phase's parts that need a
    process group, in a process of their own (the rest of the script never
    sees one): a one-rank NCCL world on cuda:0 through a file store."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = OUT / "dist_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        dist_train(torch, np, dev)
        dist_moe(torch, np, dev)
    finally:
        dist.destroy_process_group()
    return 0


class DryRun:
    """The sharded dry run (`repro_torch.launch.dryrun --all`) of every cell
    on this host's CPU: one process per mesh, each rank 0 of a fake 256- or
    512-rank group (its world size is fixed for its life), on one thread,
    beside the phases that follow (the card's torch has other DTensor rules
    than the CPU tests', so every cell runs here too)."""

    def __init__(self) -> None:
        self.dir = OUT / "dryrun"
        self.dir.mkdir(parents=True, exist_ok=True)
        for old in self.dir.glob("*"):
            old.unlink()
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "OMP_NUM_THREADS": "1"}
        self.started, self.started_wall = since_start(), time.time()
        self.procs = {}
        for mesh in DRYRUN_MESHES:
            with open(self.dir / f"{mesh}.log", "w") as log:
                self.procs[mesh] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--all", "--multi-pod", mesh,
                     "--results", str(self.results(mesh))],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)

    def results(self, mesh: str) -> Path:
        return self.dir / f"{mesh}.json"

    def wait(self) -> tuple[dict, dict, float]:
        """Wait for both processes (until LANE_DEADLINE_S): their exit codes
        (None: still running), the seconds each ran to its last record (its
        results file's last write), the seconds waited."""
        t = since_start()
        codes, seconds = {}, {}
        for mesh, proc in self.procs.items():
            try:
                codes[mesh] = proc.wait(max(1.0, LANE_DEADLINE_S - since_start()))
            except subprocess.TimeoutExpired:
                codes[mesh] = None
            path = self.results(mesh)
            seconds[mesh] = (path.stat().st_mtime - self.started_wall
                             if path.exists() else None)
        return codes, seconds, since_start() - t

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dist_dryrun_check(dryrun: DryRun) -> None:
    """The dry run's records: 66 cells, none in error, each with a sharded
    step and its collectives; train cells with collectives, every 2x16x16
    train cell with cross-pod bytes and no 16x16 cell with any; the cells
    that fit 80 GB per mesh by the spec count and by rank 0's measured
    peak (of the cells whose step ran at their length), and a few cells'
    numbers."""
    codes, seconds, waited = dryrun.wait()
    failed = {m: c for m, c in codes.items() if c != 0}
    res = {}
    for mesh in DRYRUN_MESHES:
        path = dryrun.results(mesh)
        if path.exists():
            res.update(json.loads(path.read_text()))
    errors = sorted(k for k, v in res.items()
                    if "error" in v or (v.get("sharded") or {}).get("error")
                    is not None or "sharded" not in v)
    fits, cells = {}, {}
    for key, v in sorted(res.items()):
        if key in errors:
            continue
        f = fits.setdefault(v["mesh"], [0, 0, 0, 0])
        mem, coll = v["memory"], v["collectives"]
        f[0] += mem["fits"]
        f[2] += 1
        if mem["measured"]["fits_measured"] is not None:  # not cut to LOOP_SEQ
            f[1] += mem["measured"]["fits_measured"]
            f[3] += 1
        cells[key] = dict(
            sharded_s=v["sharded"]["lower_s"], n_ops=coll["n_ops"],
            link_gb=coll["link_bytes"] / 1e9,
            cross_pod_gb=coll["cross_pod_bytes"] / 1e9,
            spec_gb=mem["per_device_total"] / 1e9,
            measured_gb=mem["measured"]["peak_bytes_full_depth_est"] / 1e9,
            seq_cut=coll.get("lower_seq"))
    train = {k: v for k, v in res.items() if v.get("shape") == "train_4k"}
    no_ops = sorted(k for k, v in train.items() if k not in errors
                    and v["collectives"]["n_ops"] <= 0)
    no_cross = sorted(k for k, v in train.items() if k not in errors
                      and v["mesh"] == "2x16x16"
                      and v["collectives"]["cross_pod_bytes"] <= 0)
    crossing = sorted(k for k, v in res.items() if k not in errors
                      and v["mesh"] == "16x16"
                      and v["collectives"]["cross_pod_bytes"] != 0)
    (OUT / "dist_dryrun.json").write_text(json.dumps(res, indent=1))
    emit("dist_dryrun", cells=len(res), errors=errors, failed_processes=failed,
         seconds=seconds, started_t=dryrun.started, waited_s=waited,
         processes=len(dryrun.procs), host_cpus=os.cpu_count(),
         fits_80gb={m: f"{a} of {n}" for m, (a, _, n, _) in fits.items()},
         fits_80gb_measured={m: f"{b} of {k}"
                             for m, (_, b, _, k) in fits.items()},
         train_without_collectives=no_ops, multi_pod_train_without_cross=no_cross,
         single_pod_with_cross=crossing, per_cell=cells, card=card_line())
    check(not failed, f"dry-run processes failed: {failed}")
    check(not errors, f"dry-run cells recorded errors: {errors}")
    check(len(res) == 66, f"dry run: {len(res)} cells, not 66")
    check(not no_ops, f"dry run: train cells without collectives: {no_ops}")
    check(not no_cross, f"dry run: 2x16x16 train cells without cross-pod "
                        f"bytes: {no_cross}")
    check(not crossing, f"dry run: 16x16 cells with cross-pod bytes: {crossing}")


# ------------------------------------------------------- surface child ----
# the surface phase: map_read on SURFACE_READS reads of a seeded
# SURFACE_REF_LEN bp reference; batched_graph_align on SURFACE_GRAPH_B
# windows of a small graph index; the kernels.ops wrappers at a batch that
# is not a multiple of 4; one pair through each single-pair entry point
SURFACE_REF_LEN, SURFACE_READS, SURFACE_CAP = 100_000, 32, 160
SURFACE_GRAPH_B, SURFACE_OPS_B = 64, 37
GRAPH_EXPORTS = (
    "EpochedGraphIndex", "GraphArrays", "GraphIndex", "GraphMapExecutor",
    "GraphMapResult", "as_graph_text", "batched_graph_align",
    "bitalign_search", "build_epoched_graph_index", "build_graph_index",
    "graph_align", "graph_backend_name", "load_graph_index", "map_batch",
    "map_batch_index", "pack_graph_text", "pack_linear_text",
    "save_graph_index", "tile_prefilter", "tile_rung", "unmapped_result",
    "unpack_graph_text")
# the port's examples, run on the card at their default sizes
EXAMPLE_RUNS = (("torch_quickstart",), ("torch_read_mapping",),
                ("torch_graph_alignment",), ("torch_edit_distance_demo",),
                ("torch_train_lm", "--steps", "4"))
# the per-device shard placement: every shard on its own listed device
# (here all cuda:0), the goldens at 2 and 3 shards and the first
# PER_DEVICE_READS reads of the serve phase's deployment at 2 shards
PER_DEVICE_READS = 512


def tensors_equal(torch, got, want) -> int:
    """Mismatching elements over the fields of two results (None fields
    must agree); the card's side is moved to the CPU."""
    bad = 0
    for g, w in zip(got, want):
        if g is None or w is None:
            bad += int((g is None) != (w is None))
            continue
        g = g.cpu()
        bad += g.numel() if g.shape != w.shape else int((g != w).sum())
    return bad


def surface_phase(torch, np, ops, dev) -> dict:
    """The reference's single-read, single-pair and graph entry points and
    the public kernel wrappers on the card, each held bit for bit against
    the same call on CPU tensors (or, for map_read, against map_batch's
    rows); returns the kernels' launches in the phase."""
    from repro_torch.core import edit_distance, mapper, minimizer_index, myers
    from repro_torch.core.genasm import GenASMConfig
    from repro_torch.core.segram.graph import build_graph
    from repro_torch.genomics import encode, simulate
    from repro_torch.graph import backends, index as graph_index

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    mism = {}

    # map_read, read by read, against map_batch's rows of the same reads
    ref = simulate.random_reference(SURFACE_REF_LEN, seed=11)
    rs = simulate.simulate_reads(ref, n_reads=SURFACE_READS, read_len=150,
                                 profile=simulate.ILLUMINA, seed=12)
    reads, lens = encode.batch_reads(rs.reads, SURFACE_CAP)
    idx = minimizer_index.build_reference_index(ref, w=8, k=12, device=dev)
    kw = dict(p_cap=SURFACE_CAP, minimizer_w=8, minimizer_k=12)
    batch = mapper.map_batch(idx, torch.from_numpy(reads),
                             torch.from_numpy(lens), **kw)
    bad = 0
    for i in range(SURFACE_READS):
        one = mapper.map_read(idx, torch.from_numpy(reads[i]), int(lens[i]),
                              **kw)
        bad += sum(int((getattr(one, f) != getattr(batch, f)[i]).sum())
                   for f in one._fields)
    mapped = int((batch.position >= 0).sum())
    correct = int(sum(abs(int(p) - int(t)) <= 16 for p, t in
                      zip(batch.position.cpu(), rs.true_pos)))
    mism["map_read"] = bad
    check(mapped >= 0.9 * SURFACE_READS and correct >= 0.9 * SURFACE_READS,
          f"map_batch on {SURFACE_READS} reads: mapped {mapped}, correct "
          f"{correct}")

    # batched_graph_align: 64 windows of a small graph index's tiles, reads
    # spelled along the graph from each tile's first node
    gref = simulate.random_reference(20_000, seed=21)
    variants = simulate.simulate_variants(gref, n_snp=50, n_ins=25,
                                          n_del=25, seed=22)
    g = build_graph(gref, variants)
    gidx = graph_index.build_graph_index(gref, variants, w=8, k=12,
                                         window=192, graph=g, device=dev)
    rng = np.random.default_rng(23)
    tiles = rng.choice(gidx.n_tiles - 2, SURFACE_GRAPH_B, replace=False)
    pats = np.full((SURFACE_GRAPH_B, 128), 4, np.int8)
    p_lens = np.zeros(SURFACE_GRAPH_B, np.int32)
    for i, t in enumerate(tiles):
        p = simulate.spell_graph_path(g, int(t) * gidx.tile_stride,
                                      int(rng.integers(60, 128)), rng)
        p[rng.integers(0, len(p), size=3)] = rng.integers(0, 4, size=3)
        pats[i, :len(p)], p_lens[i] = p, len(p)
    sel = torch.from_numpy(tiles).to(dev)
    args = (gidx.arrays.tile_gtext[sel], torch.from_numpy(pats).to(dev),
            torch.from_numpy(p_lens).to(dev), gidx.arrays.tile_valid[sel])
    got = backends.batched_graph_align(*args, cfg=GenASMConfig(), p_cap=128)
    want = backends.batched_graph_align(*(a.cpu() for a in args),
                                        cfg=GenASMConfig(), p_cap=128)
    mism["batched_graph_align"] = tensors_equal(torch, got, want)
    graph_aligned = int((want.distance >= 0).sum())
    check(graph_aligned >= SURFACE_GRAPH_B // 2,
          f"batched_graph_align aligned {graph_aligned} of {SURFACE_GRAPH_B}")

    # the four kernels.ops wrappers, card against CPU, squeeze included
    rng = np.random.default_rng(31)
    calls = {
        "window_dc": (ops.window_dc, ops.window_inputs, dict(w=64, k=24)),
        "window_dc_v2": (ops.window_dc_v2, ops.window_inputs,
                         dict(w=64, k=24)),
        "myers_distance": (ops.myers_distance, ops.myers_inputs,
                           dict(n=1192, m_bits=1024, short=True)),
        "bitalign_dc": (ops.bitalign_dc, ops.bitalign_inputs,
                        dict(n=64, m_bits=64, k=24, short=True)),
    }
    for name, (fn, make, shape) in calls.items():
        a, kw_ = make(rng, dev, b=SURFACE_OPS_B, **shape)
        kw_.pop("store_r", None)  # ops.bitalign_dc always stores R
        got = fn(*a, **kw_)
        want = fn(*(x.cpu() for x in a), **kw_)
        mism[f"ops.{name}"] = tensors_equal(
            torch, got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,))
        if name.startswith("window_dc"):
            one = [x[:1] for x in a]
            got = fn(*one, squeeze=True, **kw_)
            want = fn(*(x.cpu() for x in one), squeeze=True, **kw_)
            mism[f"ops.{name}.squeeze"] = tensors_equal(torch, got, want)

    # one pair each through genasm_distance (cuda_dc) and myers_distance
    prng = np.random.default_rng(41)
    a = simulate.random_reference(1000, seed=42)
    b = simulate.mutate(a, simulate.ILLUMINA, prng)
    pbuf = np.full(1064, 4, np.int8); pbuf[:len(b)] = b
    tbuf = np.full(1192, 4, np.int8); tbuf[:len(a)] = a
    mbuf = np.full(1024, 4, np.int8); mbuf[:len(b)] = b[:1024]
    pair = [torch.from_numpy(x) for x in (pbuf, tbuf, mbuf)]
    distances = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        pb, tb, mb = (x.to(where) for x in pair)
        distances[key] = (
            int(edit_distance.genasm_distance(pb, tb, len(b), len(a))),
            int(myers.myers_distance(tb, mb, min(len(b), 1024), m_bits=1024,
                                     mode="semiglobal")))
    mism["single_pair"] = int(distances["card"] != distances["cpu"])

    # the package's exports in a fresh interpreter, without JAX
    code = ("import sys\nfrom repro_torch.graph import (" + ", ".join(
        GRAPH_EXPORTS) + ")\nassert not [m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'repro.'))]\nprint(len(["
        + ", ".join(GRAPH_EXPORTS) + "]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0 and proc.stdout.strip() == "22",
          f"from repro_torch.graph import the 22 names: {proc.stderr[-2000:]}")

    counts = ops.launch_counts()
    emit("surface", mismatches=mism, mismatches_total=sum(mism.values()),
         map_read_reads=SURFACE_READS, mapped=mapped, position_correct=correct,
         graph_windows=SURFACE_GRAPH_B, graph_aligned=graph_aligned,
         ops_batch=SURFACE_OPS_B, pair_distances=distances["card"],
         graph_exports=22, launches=counts,
         seconds=time.perf_counter() - t_phase, card=card_line())
    check(sum(mism.values()) == 0, f"surface mismatches: {mism}")
    check(min(counts.values()) > 0, f"surface: a kernel was not launched "
                                    f"({counts})")
    return counts


def examples_phase() -> None:
    """Each `examples/torch_*.py` as a user runs it, on the card (its
    default device), at its default sizes; each must exit 0."""
    runs = []
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ck = OUT / "torch_train_lm_ckpt"
    for script, *args in EXAMPLE_RUNS:
        if script == "torch_train_lm":
            args += ["--ckpt-dir", str(ck)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{script}.py"), *args],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        (OUT / f"example_{script}.log").write_text(proc.stdout + proc.stderr)
        runs.append({"script": script, "args": args, "rc": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "last_line": (proc.stdout.strip().splitlines()
                                   or [""])[-1][-200:]})
        check(proc.returncode == 0, f"examples/{script}.py exited "
                                    f"{proc.returncode}: {proc.stderr[-2000:]}")
    emit("examples", runs=runs)


def shard_per_device_phase(torch, ops, sg, device: str = "cuda:0") -> dict:
    """``--device cuda:0,cuda:0`` (one one-row block per listed device)
    through the launcher: the goldens at 2 and 3 shards, offline and
    pipelined, linear and graph, byte for byte; then the serve phase's
    first PER_DEVICE_READS reads at full width on 2 shards against their
    rows of its 1-shard PAF.  Returns the kernels' launches."""
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    runs = []
    for mode, golden, backend in (("linear", GOLDEN, "cuda_dc"),
                                  ("graph", GOLDEN_GAF, "graph_cuda")):
        for shards in (2, 3):
            extras = [()] + ([("--pipelined",)] if mode == "linear" else [])
            for extra in extras:
                out = OUT / (f"per_device_{mode}_s{shards}"
                             f"{''.join(extra).replace('--', '_')}"
                             f"{golden.suffix}")
                sg.main((["--mode", "graph"] if mode == "graph" else [])
                        + GOLDEN_ARGS + [
                            "--align-backend", backend, "--device",
                            ",".join([device] * shards), "--num-shards",
                            str(shards), *extra, "--out", str(out)])
                same = out.read_bytes() == golden.read_bytes()
                runs.append({"mode": mode, "shards": shards,
                             "extra": " ".join(extra), "identical": same})
                check(same, f"per-device golden {mode}, {shards} shards "
                            f"{extra}")
    golden_counts = ops.launch_counts()

    one = paf_lines_below(OUT / "full_cuda_dc_v2.paf", PER_DEVICE_READS)
    devices = f"{device},{device}"
    full = FULL_ARGS + ["--device", devices, "--num-shards", "2"]
    svc = sg.setup(sg.parse_args(full + ["--reads", str(FULL_READS)]))
    out = OUT / "per_device_full.paf"
    ops.reset_launch_counts()
    s = sg.serve(svc, sg.parse_args(full + [
        "--reads", str(PER_DEVICE_READS), "--align-backend", "cuda_dc_v2",
        "--out", str(out)]))
    full_counts = ops.launch_counts()
    same = out.read_text().splitlines() == one
    emit("shard_per_device", golden_runs=runs,
         golden_launches=golden_counts, reads=s["reads"], mapped=s["mapped"],
         position_correct=s["correct"], reads_per_s=s["reads_per_s"],
         backend="cuda_dc_v2", devices=devices,
         identical_to_one_shard=same, launches=full_counts,
         seconds=time.perf_counter() - t_phase, card=card_line())
    check(same, "per-device 2-shard PAF differs from the 1-shard rows")
    check(full_counts["window_dc_batch_v2"] > 0, "per-device: v2 not launched")
    check(full_counts["bitap_filter_batch"] > 0,
          "per-device: filter not launched")
    return {k: golden_counts[k] + full_counts[k] for k in golden_counts}


def surface_child() -> int:
    """``chip_smoke.py --surface-child``: the surface, examples and
    shard_per_device phases in a process of their own, started after
    serve beside the genomics phases and the LM lane."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_genomics as sg

    dev = torch.device("cuda", 0)
    surface = surface_phase(torch, np, ops, dev)
    examples_phase()
    per_device = shard_per_device_phase(torch, ops, sg)
    emit("surface_done", launches_surface=surface,
         launches_shard_per_device=per_device)
    return 0


def lm_child() -> int:
    """``chip_smoke.py --lm-child``: the LM lane in a process of its own,
    beside the genomics phases after serve: the Myers kernel's check at
    L = 100 kbp, lm, lm_zoo, then `dist_child` (after lm_zoo, so that
    their card memory never adds up)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    myers_long_check(torch, np, ops, dev)
    lm_phase(torch, np, dev)
    lm_zoo_phase(torch, np, dev)
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--dist-child"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    (OUT / "dist_child.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0,
          f"dist child exited {proc.returncode}: {proc.stderr[-3000:]}")
    return 0


class Lane:
    """``chip_smoke.py <flag>`` started now as a process of its own; its
    lines go to build/chip_smoke/<name>.log and are relayed when it is
    collected (each carries its "t").  The LM lane is ``--lm-child``, the
    surface child ``--surface-child``."""

    def __init__(self, flag: str, name: str) -> None:
        self.name = name
        self.log = OUT / f"{name}.log"
        self.err = OUT / f"{name}.err"
        self.started = since_start()
        with open(self.log, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag],
                cwd=ROOT, stdout=out, stderr=err)

    def collect(self) -> float:
        """Wait for the lane (until LANE_DEADLINE_S), relay its lines and
        check it; returns the seconds waited.  ``lines``: its phase lines."""
        t = since_start()
        try:
            code = self.proc.wait(max(1.0, LANE_DEADLINE_S - since_start()))
        except subprocess.TimeoutExpired:
            code = None
        waited = since_start() - t
        text = self.log.read_text()
        print(text, end="", flush=True)
        check(code == 0, f"{self.name} exited {code}: "
                         f"{self.err.read_text()[-3000:]}")
        self.lines = {d["phase"]: d for d in map(json.loads, (
            ln for ln in text.splitlines() if ln.startswith('{"phase"')))}
        return waited

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def dist_phase(torch, ops, sg, lane: Lane, dryrun: DryRun) -> int:
    """The distribution and dry-run plane on the card: the read pipeline
    (its reads/s are host-bound), then the LM lane, which ran `dist_child`
    after lm_zoo, and the sharded dry run, both collected; returns the read
    pipeline's v2 launches."""
    t_phase = time.perf_counter()
    launches = dist_pipeline(torch, ops, sg)
    lane_waited = lane.collect()
    dist_dryrun_check(dryrun)
    emit("dist_done", seconds=time.perf_counter() - t_phase,
         lm_lane_started_t=lane.started, lm_lane_waited_s=lane_waited,
         max_memory_reserved=torch.cuda.max_memory_reserved(),
         card=card_line())
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch.kernels import _build, ops
        from repro_torch.launch import serve_genomics as sg
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    OUT.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    emit("card", nvidia_smi=card, max_sm_clock=card_line("clocks.max.sm"),
         torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    infos = _build.build_all()
    (OUT / "build.log").write_text("\n".join(i.log for i in infos))
    emit("build", seconds=max(i.seconds for i in infos),
         libraries=[str(i.path.relative_to(ROOT)) if i.path.is_relative_to(ROOT)
                    else str(i.path) for i in infos],
         ptxas=[ln.strip() for i in infos for ln in i.log.splitlines()
                if "registers" in ln or "spill" in ln],
         spills=kernel_spills(infos, ops))

    dev = torch.device("cuda", 0)
    rows = kernel_phase(torch, np, ops, dev)
    # from here on the dry run runs on the CPU beside every phase to dist,
    # and from after serve the LM lane and the surface child beside the
    # genomics phases
    dryrun, lane, surface = DryRun(), None, None
    try:
        golden_phase(sg)
        launches, one_shard_rps = serve_phase(torch, ops, sg)
        torch.cuda.empty_cache()  # the LM lane needs the card's memory
        lane = Lane("--lm-child", "lm_lane")
        surface = Lane("--surface-child", "surface_lane")
        obs_phase(torch, sg)
        golden_graph_phase(sg)
        graph = graph_serve_phase(torch, ops, sg)
        launches["bitalign_dc_batch"] = graph["bitalign_dc_batch"]
        sharded = shard_phase(torch, np, ops, sg, dev, graph, one_shard_rps)
        for name in ("window_dc_batch", "window_dc_batch_v2",
                     "bitap_filter_batch"):
            rows[name]["launches_by_site"] = {
                "serve": launches[name],
                **{site: c[name] for site, c in sharded.items() if c.get(name)}}
        rows["bitalign_dc_batch"]["launches_by_site"] = {
            **graph["bitalign_launches_by_site"],
            "shard_golden": sharded["shard_golden"]["bitalign_dc_batch"],
            "shard_filter": sharded["shard2_graph"]["bitalign_filter"],
            "shard_align": sharded["shard2_graph"]["bitalign_align"]}
        del graph  # the graph deployment's device memory
        launches["myers_distance_batch"] = edit_distance_phase(torch, np, ops,
                                                               dev)
        prealign_filter_phase(torch, np, dev)
        segram_phase(torch, np, dev)
        surface_waited = surface.collect()
        done = surface.lines["surface_done"]
        for name, row in rows.items():
            by_site = row.setdefault("launches_by_site", {})
            if name == "myers_distance_batch":
                by_site["edit_distance"] = launches[name]
            by_site["surface"] = done["launches_surface"][name]
            by_site["shard_per_device"] = \
                done["launches_shard_per_device"][name]
        emit("surface_collected", started_t=surface.started,
             waited_s=surface_waited, ended_t=done["t"])
        rows["window_dc_batch_v2"]["launches_by_site"]["dist_stream"] = \
            dist_phase(torch, ops, sg, lane, dryrun)
        long = lane.lines["kernels_vs_plain_long"]
        row = rows["myers_distance_batch"]
        row["mismatches"] += long["mismatches"]
        row["max_abs_err"] = max(row["max_abs_err"], long["max_abs_err"])
        row["long"].update(mismatches=long["mismatches"],
                           max_abs_err=long["max_abs_err"])
    finally:
        dryrun.stop()
        for child in (lane, surface):
            if child is not None:
                child.stop()
    for name, n in launches.items():
        rows[name]["launches"] = n
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        {key: r[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "mismatches", "max_abs_err", "ms",
                                 "kernel_ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "sites",
                                 "launches_by_site", "long") if key in r}
        for r in rows.values()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    CHILDREN = {"--obs-child": obs_child, "--dist-child": dist_child,
                "--lm-child": lm_child, "--surface-child": surface_child}
    sys.exit(CHILDREN[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in CHILDREN
             else main())
