#!/usr/bin/env python3
"""Drive the PyTorch port (video2music_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which fails the run (non-zero exit) when it fails:
  1. set-up: require CUDA, build the port's CUDA kernels from csrc/ (into
     video2music_tpu_torch/_build/), print the card and its power limit,
     turn TF32 off;
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the product shapes, in float32 and bfloat16, with both times, its
     bound and, where one PyTorch call computes the same function, that
     call's time; the batched decode kernels at B=16 (timed at B=64 too),
     flash attention and the scan at B=16 as well; the dropout attention
     forward and backward at the training shape (B=16, H=8, L=S=300,
     D=64, rate 0.1, causal and not, plus a small case with a bias):
     output, mask entry for entry, and dq / dk / dv (/ dbias); the three
     variant decode kernels in every wiring they cover (base AMT RPR +
     ReLU + LayerNorm, V1.0 / V1.1 shared-less MLP / GLU experts, V3.1 and
     V3.2 differential + RMSNorm, post- and pre-norm): the B=1 layer and
     the batched pair at B=16 (the 3.1 deep layer timed at B=64 too), and
     flash attention at the V3 encoder's 2H = 16 heads; the cooperative
     whole-run kernel (csrc/decode_stack.cu) behind its three wrappers,
     all six layers with the embed and head folded, a two-layer middle
     run, the MoE and SwiGLU segments and the monolith over (L, S, D)
     caches, and the decode layer with int8 weights; the int8-KV form of
     the batched layer at B=16 (timed at B=64 too), shallow with the embed
     and deep, on int8 caches filled to pos 150: the output, and the int8
     K/V rows and scales it writes at pos; the variant layer with int8
     weights on the deep 3.1 and 3.2 layers at B=1;
  2a. scan shapes: the selective scan at b in {1, 16}, d_state N in {12,
     16, 64, 1024} and L in {1, 65, 300} against its plain version, f32
     and bf16, timed at L = 300; stack positions: the cooperative kernel
     (the whole six-layer step) at pos 0, 1, 150, S - 1 with Sm = 300 and
     37, and with splits of several tiles (Sm = 1500, a 1100-row self
     cache), f32 and bf16, the routers' expert ids compared; stack
     breakdown: the cooperative kernel's probe instance on the six-layer
     bf16 run at pos 150, microseconds per phase kind summed over the
     layers and of the grid barriers' waits, with block 0's and the last
     block's stamps inside layer 1, beside the first design's breakdown
     (PREV_STACK_BREAKDOWN);
  2b. decode breakdown: one bf16 call of row 8 (the deep 3.1 layer, B=1),
     row 6 (the deep batched layer, B=16 and B=64), row 2 (the deep 2.2
     layer, B=1), row 7 (the batched MoE half with the head, B=16 and
     B=64) and row 10 (the 3.1 MoE half, B=16) at pos 150 by CUDA-graph
     replay under torch.profiler, each kernel of the chain with its
     launches and microseconds per call, a line each ("breakdown
     row ..."); the batched GEMV alone at the QKV shape (1536 x 512, bf16,
     B=16 and B=64) beside torch.nn.functional.linear ("gemv yardstick");
     rows 6-10 at d_ff 2048 against their plain versions, f32 and bf16;
     rows 1 and 11 at head sizes 48, 96, 128 and 256 (output, mask,
     gradients; timed at 128); the B=1 layer, the one-layer cooperative
     run, the batched MoE half (B=16 and B=4) and the 3.1 variant layer
     and MoE half at 40 experts, top-10; the bf16 MoE halves (rows 7 and
     10) with their experts dense and routed side by side at B = 2-8, 6
     experts top-2 and 40 top-10 ("expert cut", the readings behind
     decode_batch.dense_experts);
  3. slice: a full-width Video2music (AMT 2.2 + bimamba+, random weights
     from seed 0) in bfloat16 answers three requests from seeded synthetic
     features; the outputs are checked, and each kernel's launch count over
     those requests must equal what the path implies;
  4. teacher-forced: 16 decode steps of the kernel path against the plain
     path on the card, float32 and bfloat16;
  4b. B=1 backends: the same bf16 model decodes one 300 s request through
     generate_chords for each B=1 backend ("layer", "stack", "monolith",
     the whole step as one launch (split=False), int8 "layer", and "ends"
     for comparison) and one Video2music.generate(quantize="int8"); every
     clip is checked, each backend's launches must equal its path's, and
     a torch.profiler window reads each backend's step;
  4c. teacher-forced backends: 16 steps of each of those backends against
     its plain counterpart, float32 and bfloat16, with the expert ids every
     router chose compared (the positions and layers where they differ);
  5. serving: the same Video2music decodes batches through generate_batch
     at B=16 and B=64 and through a DynamicBatcher (max_batch 16) fed 24
     requests at once; every clip is checked, and the launch counts must
     equal what the widths that ran imply;
  5b. int8 KV: generate_batch(kv_quant="int8") at B=16 beside the same
     batch on bf16 caches, every clip checked, launches equal to the
     path's, clips/s and ms/step of both;
  6. teacher-forced batch: 16 steps of the batched kernel step against the
     batched plain step at B=8, float32 and bfloat16, and the same on int8
     KV caches, with the expert ids every router chose compared too;
  7. V3 slice: full-width bfloat16 Video2music at 3.1 (three requests at
     B=1, generate_batch at B=16) and at 3.2 (one request, one B=16
     batch); every clip is checked, and the launches of the variant
     kernels, flash attention (at 2H heads) and the scan must equal what
     the V3 path implies;
  7b. V3 int8: at 3.1, generate(quantize="int8") for one 300 s request
     (the int8 variant layer) and generate_batch(quantize="int8") at B=16
     (the plain step on fake-quantized weights: no decode kernel), each
     beside the same call in bf16, with their launches, ms/token, clips/s;
  8. V3 teacher-forced: 16 steps of the variant kernel step against the
     plain step at B=1 and B=8, for 3.1 and 3.2, float32 and bfloat16;
     then the int8-weight B=1 step of each, expert ids compared too;
  8a. wirings: full-width bf16 Video2music for the base AMT, 1.1,
     1.3.4, 2.0, KAN 2.3 and 2.2 with grouped-query attention (kv_heads
     2), random weights from seed 0: where the variant kernels cover the
     wiring, 16 teacher-forced steps of the kernel step against the plain
     step at B=1 and B=8 (float32 and bfloat16, expert ids compared) and
     rows 8-10 on the wiring's own packed layers (the base AMT's RPR +
     ReLU layer, the 1.3.4 MLP-expert layer without a shared expert:
     ms_rpr / ms_mlp with their bounds); for each, one 300 s generate and
     one generate_batch at B=16 (every clip checked, ms/token, clips/s),
     the launches of those two calls equal to what the path implies (no
     decode kernel for 2.3 and GQA, which decode on the plain step), and
     the decode step profiled at B=1 and B=16;
  8b. regression zoo: every Mamba-family backbone (mamba, mamba+,
     moemamba with d_state 1024, bimamba, bimamba+, moe_bimamba+,
     sharedmoe_bimamba+, and mamba with use_kan) at full width, float32
     and bfloat16, B=1 and B=16: the forward through the scan kernel
     against the same weights through the plain scan (bfloat16: at most
     one position in BF16_ROUTE_SHARE outside BF16_REL, for the MoE
     routers' near-ties), the scan's launches, the forward ms; the scan on
     moemamba's own inputs against its plain version (ms_moemamba); the
     gradients through the scan's wrapper against the plain scan's at
     d_state 16 and 1024, on the scan alone and through every parameter
     of mamba and moemamba;
  8c. raw video: row 1 in the extractors' forms (CLIP-L vision B=30,
     H=16, L=577, D=64; CLIP text B=6, H=12, L=77, causal; MaxViT-T stage
     0 B=1920, H=2, L=49, D=32 and stage 3 B=30, H=16, with the shared
     relative-position bias and the scale C^-0.5) against its plain
     version, f32 and bf16, timed beside its bound and
     F.scaled_dot_product_attention; full-width CLIP ViT-L/14@336 and
     MaxViT-T on seeded weights, f32 on the card against the CPU (2
     frames) and bf16 against f32 (30 frames), with their forward ms; a
     full-width bf16 Video2music with both extractors (motion_type 1):
     generate(video=...) on a 62 s multi-scene clip written with cv2,
     extract_features_batch over three clips against per-clip
     extraction, a DynamicBatcher with four video requests, every clip
     checked, the launches equal to the path's (row 1: 24 a CLIP chunk,
     22 a MaxViT chunk, 6 an AMT encoder), the extraction's stage times;
     ffmpeg and fluidsynth are missing on the H100 machine, so no audio is
     rendered and nothing is muxed there (the line says so);
  8d. new backbones: bilstm, bigru, lstm, gru, cnngru, cnnbigru and
     mingru at full width behind a full-width 2.2: generate_batch at B=1
     and B=16 in f32 and bf16, every clip checked, the f32 regression
     outputs against the CPU's, bf16 against f32, the forward ms;
  8e. deep model: a full-width 2.2 with 20 decoder layers, 16
     teacher-forced steps of "monolith", "stack" and split=False against
     their plain steps, float32 and bfloat16; the cooperative kernel takes
     at most 16 layers, so each step launches it once per run (2, 3, 2);
  9. train: a full-width AMT 2.2 (total_vf_dim 1287, motion_type 1) on a
     synthetic feature tree of 32 clips of 300 s that the script writes:
     one train_amt epoch at B=16 (bf16 mixed precision, AdamW lr 1e-4)
     with results.csv and a checkpoint that restores, then 60 steps on one
     fixed batch (the loss must drop), ms/step from CUDA events; the
     dropout kernels must launch 18 forward and 18 backward times a step;
     then the checkpoints served: train_regression (bimamba+, one epoch
     at B=16) on the same tree, Video2music(amt_checkpoint=...,
     reg_checkpoint=...) against a Video2music given the trained state
     dicts (a 90 s request, token for token, bf16), and a seeded
     Video2music behind a DynamicBatcher swapped to the checkpoints by
     load_checkpoints through submit_control (its next answer the served
     one's);
  10. teacher-forced train step: one step's loss and gradients through
     the dropout kernels against the same step through the plain dropout
     attention, from the same weights, batch and generator seed, in f32
     and in bf16 mixed precision;
  11. train zoo: six bf16 train steps (AdamW, B=16, L=300) each of V3.1,
     2.1 (top-k scheduler), the base AMT, the MusicTransformer, bimamba+
     and bilstm at full width: ms/step, finite losses, the launches of
     rows 11 and 12 equal to the path's, row 11's forms (2H heads for
     V3.1, the full RPR bias for the base AMT and the MusicTransformer);
     two steps of each optimizer on the card; the scan's plain-recompute
     backward at a bimamba+ step's shapes and its share of the step;
  12. CLIs: the port's command line at full width on a synthetic feature
     tree of 64 clips of 300 s (motion_type 1; four steps at B=16):
     train_amt (2.2, f32, -profile 3 and the default TensorBoard: results
     .csv, the checkpoint, the four tags at step 1, a trace naming row
     11's kernels), train_regression (bimamba+), evaluate (-confusion and
     the expert-emotion counts, each MoE layer's summing to k_top x its
     labelled positions), evaluate_regression, generate (output.lab token
     for token with Video2music on the two checkpoints), the serve CLI in
     a subprocess (8 concurrent requests, one answer batched, a stream,
     /reload, then the generate CLI's chords; 404 and 400), one demo form
     POST, and extract_features semantic / emotion / scene / motion on a
     cv2 clip against Video2music.extract_features; every step's kernel
     launches equal to what its path implies ("launches_clis");
  14. published layouts (after "multi-GPU" and "CLIs"): generate_chords
     on AMT 2.2 at a shape the decode kernels refuse (d_model 36 / 2
     heads) decodes on the plain step, fused="on" warning, at head size
     12 (d_model 96 / 8 heads) on the kernels with no warning, and int8
     KV caches at head size 8 (B=2) stay int8 on the batched kernels,
     with no warning; CLIP ViT-L/14@336 converted from a
     seeded transformers CLIPModel (convert_hf_clip) and MaxViT-T from a
     seeded tools/torch_maxvit_mirror.py model (convert_torchvision_maxvit)
     against their sources on 30 frames, f32 and bf16, with row 1's
     launches and ms; a full-width 2.2 and base-AMT state dict in the
     reference's names, converted by the convert_reference_checkpoint
     CLI in subprocesses and served by Video2music(amt_checkpoint=...):
     a 300 s request (2.2: "ends", then "monolith" through
     generate_chords; the base AMT: row 8) and generate_batch at B=16,
     every clip checked, launches as the path implies
     ("launches_published"), the tokens equal to the same model loaded
     from the in-memory conversion;
  15. head size 512 path ("launches_wide"): the train_amt
     CLI at -num_heads 1 (head size 512, f32, one epoch at B=16 on 32
     synthetic clips: row 11 at hd 512 every step, row 1 in its eval),
     its checkpoint served in bf16 with the moemamba regression at
     d_hidden 2048 (d_state 2048): a 300 s request and a B=16 batch, row 1
     encoding at hd 512, the decode kernels decoding, each scan in two
     state chunks, launches as the path implies; then every
     B=1 backend through generate_chords and generate_batch at B=16 on
     bf16 and int8 KV caches, no warning ("launches_hd512");
  16. head size 8 int8 KV: the product 2.2 at 64 heads: row 6's int8-KV
     form at hd 8 against its plain version (B=16, 64; "ms_int8_hd8"),
     generate_batch(kv_quant="int8") at B=16 (no warning, int8 caches,
     rows 6 and 7 every step), 16 teacher-forced int8-KV steps at B=8;
  17. head size 4 path ("launches_hd4"): the product 2.2 at
     128 heads of 4, one 300 s generate, every B=1 backend and B=16 on
     bf16 and int8 KV caches as in 15.; then V3.1 at one head (512: rows
     8 and 9 with two 512-wide query / key heads a value head) for one
     request and a B=16 batch; every clip checked, no warning, launches as
     each path implies.
After "head sizes": "wide heads" holds rows 1 and 11 at head
sizes 264, 320, 512, 576 and 1024 (the head split into 64-column slices,
one thread-block cluster a query tile; in f32 split TF32 and the
backward a cluster a query or key tile) to their plain versions in f32
and bf16 (+bias, +causal; output, mask entry for entry, dq / dk / dv /
dbias from the forward's stats), also past each dtype's one-pass cut
(bf16: head size 264 at L = S = 2000; f32: 4096 at 700, and 4608 with q
streamed) and at the B=16 grids of the timed forms (clusters of 5, 4 and
8), forward and backward timed at 320, 512 and 1024 in both dtypes
beside F.scaled_dot_product_attention (its backend named) and the bound
("ms_d320", "ms_d512", "ms_d1024"); "wide states" the scan at d_state 1025 and 2048 (two
state chunks), timed at 2048 ("ms_n2048"); "decode head sizes" rows
2-6, 8 and 9 at head sizes 2, 4, 12, 512 and 1024 (d_model
1024 / 512 heads, 512 / 128, 384 / 32, 512 / 1, 1024 / 1; the attention
instances of any even head size) against their plain versions in f32
and bf16, with int8 weights (rows 2, 8) and int8 KV caches (row 6), each
bf16 form timed beside its plain version and bound ("ms_hd2" ...
"ms_int8_hd1024");
"probes" rows 13 and 14: the
kv traffic probe's four modes at B = 16, 32, 64 (bf16 core beside SDPA,
the no-cache form beside torch.mul, the floor beside row 6) and the
dot_general probe's three forms in TF32 and bf16 against the f32 product
beside torch.matmul (TF32 off, and on for the TF32 forms), each warm and
cold (calls rotating over input copies that read twice the L2); then
each kernel at the edge shapes of its plan, the floor's bits over two
calls, the profiler's count of one kernel and no memset in a call of
every mode and form, and both tools' command lines. To keep the run within its limit the "multi-GPU" worlds
train 2+2 layers (pp 6+6) and start two at a time, the wirings run 2+2
layers, and "new backbones" serves a 2+2-layer 2.2.
The "dropout forms" phase (after "dropout kernels") holds the dropout
attention in its two training forms to its plain version in f32 and bf16
(output, mask entry for entry, dq / dk / dv / dbias) with its times,
bounds and F.scaled_dot_product_attention's: 2H = 16 heads with v
repeated (V3, "ms_2h") and the causal RPR form with the full f32 bias
("ms_rpr"), B=16, L=S=300, D=64.
Each phase's wall seconds are printed.
The last three lines of stdout are a JSON object listing the kernels with
their launches, errors, times and bounds, the card's name and power limit
as nvidia-smi gives them, and {"ok": true, "device": ...}.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# f32: another summation order only; bf16: 8-bit mantissa over sums of
# 512-2048 terms, relative to the largest reference magnitude
F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_REL = 2e-2
# teacher-forced logits pass through 6 layers of such sums
F32_LOGIT_ATOL = 1e-4
# batched bf16 teacher forcing: at most one clip-position in this many may
# leave BF16_REL (a router near-tie flipped by a one-ulp input difference)
BF16_ROUTE_SHARE = 16
# the sampler emits chord ids in [1, CHORD_END): "N" (0) is banned and the
# end / pad ids lie at CHORD_END and above
CHORD_END = 157
# int8 rows a kernel writes against its plain version's: at most this share
# of the elements one quantum apart (an f32 value on a rounding boundary of
# x / s, which the two sum orders put on either side), none further
INT8_QUANTUM_SHARE = 1e-3

KERNELS = {
    "flash_attention": dict(
        source="video2music_tpu_torch/csrc/flash_attention.cu",
        replaces="video2music_tpu/ops/pallas_attention.py:68"),
    "decode_layer": dict(
        source="video2music_tpu_torch/csrc/decode_layer.cu",
        replaces="video2music_tpu/ops/pallas_decode.py:316"),
    "decode_ends": dict(
        source="video2music_tpu_torch/csrc/decode_layer.cu",
        replaces="video2music_tpu/ops/pallas_decode_stack.py:519"),
    "selective_scan": dict(
        source="video2music_tpu_torch/csrc/selective_scan.cu",
        replaces="video2music_tpu/ops/pallas_scan.py:59"),
    "batched_layer_step": dict(
        source="video2music_tpu_torch/csrc/decode_batch.cu",
        replaces="video2music_tpu/ops/pallas_decode_batch.py:609"),
    "batched_moe_ffn": dict(
        source="video2music_tpu_torch/csrc/decode_batch.cu",
        replaces="video2music_tpu/ops/pallas_decode_batch.py:761"),
    "flash_attention_dropout_fwd": dict(
        source="video2music_tpu_torch/csrc/flash_attention_dropout.cu",
        replaces="video2music_tpu/ops/pallas_attention_dropout.py:175"),
    "flash_attention_dropout_bwd": dict(
        source="video2music_tpu_torch/csrc/flash_attention_dropout.cu",
        replaces="video2music_tpu/ops/pallas_attention_dropout.py:214"),
    "decode_variant_layer": dict(
        source="video2music_tpu_torch/csrc/decode_variant.cu",
        replaces="video2music_tpu/ops/pallas_decode_variant.py:373"),
    "batched_variant_layer_step": dict(
        source="video2music_tpu_torch/csrc/decode_variant.cu",
        replaces="video2music_tpu/ops/pallas_decode_batch_variant.py:383"),
    "batched_variant_moe_ffn": dict(
        source="video2music_tpu_torch/csrc/decode_variant.cu",
        replaces="video2music_tpu/ops/pallas_decode_batch_variant.py:479"),
    "decode_monolith": dict(
        source="video2music_tpu_torch/csrc/decode_stack.cu",
        replaces="video2music_tpu/ops/pallas_decode_stack.py:624"),
    "decode_segment": dict(
        source="video2music_tpu_torch/csrc/decode_stack.cu",
        replaces="video2music_tpu/ops/pallas_decode_stack.py:699"),
    "decode_flat_monolith": dict(
        source="video2music_tpu_torch/csrc/decode_stack.cu",
        replaces="video2music_tpu/ops/pallas_decode_stack.py:519"),
    "kv_traffic_probe": dict(
        source="video2music_tpu_torch/csrc/probes.cu",
        replaces="tools/kv_traffic_probe.py:128"),
    "probe_dotgeneral": dict(
        source="video2music_tpu_torch/csrc/probes.cu",
        replaces="tools/probe_dotgeneral.py:35"),
}
# the kernels of the B=1 slice and of batched serving
SLICE_KERNELS = ("flash_attention", "decode_layer", "decode_ends",
                 "selective_scan")
SERVING_KERNELS = ("flash_attention", "batched_layer_step",
                   "batched_moe_ffn", "selective_scan")
TRAIN_KERNELS = ("flash_attention_dropout_fwd", "flash_attention_dropout_bwd")
# the kernels of the V3 serving path (B=1 and B>1)
V3_KERNELS = ("flash_attention", "decode_variant_layer",
              "batched_variant_layer_step", "batched_variant_moe_ffn",
              "selective_scan")
# the B=1 backends of generate_chords: (fused, quantize, split) and the
# decode kernel each launches per step
BACKENDS = {"ends": ("auto", None, True, None),
            "layer": ("layer", None, True, "decode_layer"),
            "stack": ("stack", None, True, "decode_segment"),
            "monolith": ("monolith", None, True, "decode_monolith"),
            "whole": ("auto", None, False, "decode_flat_monolith"),
            "int8": ("auto", "int8", True, "decode_layer")}
STACK_KERNELS = ("decode_monolith", "decode_segment", "decode_flat_monolith")

# bf16 device ms of the redesigned kernels before their redesign, from
# earlier chip_smoke.py runs on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md): rows 1, 11, 6 and 8 on their first designs, rows 2, 3 (one
# layer), 7 and 10 on the tree at 04068b2, rows 3-5 (the cooperative
# kernel) and 12 on the tree at e773164, rows 13 and 14 (the probes) on
# the tree at 18aa1a8, rows 1 and 11's head-size-512 forms (ms_d512) on
# their first wide design (the tree at c9ea41e); not measured by this run, so
# they stay out of the kernels line and are printed on a line of their
# own, marked so, beside this run's times
PREV_MS = {
    "flash_attention": dict(ms=0.1330, ms_b16=0.3117, ms_2h=0.1325,
                            ms_d512=0.0826),
    "flash_attention_dropout_fwd": dict(ms=0.4301, ms_causal=0.4121,
                                        ms_d512=0.2739),
    "flash_attention_dropout_bwd": dict(ms=3.3249, ms_causal=2.2283),
    "batched_layer_step": dict(ms=0.0539, ms_b64=0.0998, ms_int8=0.0589),
    "decode_variant_layer": dict(ms=0.0613, ms_int8=0.0646),
    "decode_layer": dict(ms=0.0432, ms_int8=0.0440),
    "decode_ends": dict(ms=0.0467),
    "batched_moe_ffn": dict(ms=0.0603, ms_b64=0.1337),
    "batched_variant_moe_ffn": dict(ms=0.0515, ms_b64=0.1290),
    # rows 3-5 and 12 on the tree at e773164 (PERF.md)
    "decode_flat_monolith": dict(ms=0.3105),
    "decode_monolith": dict(ms=0.3097),
    "decode_segment": dict(ms=0.1574),
    "selective_scan": dict(ms=0.1439, ms_b16=0.1481),
    # rows 13 and 14 on the tree at 18aa1a8 (PERF.md, PR 17's chip run)
    "kv_traffic_probe": dict(ms=0.0103, ms_b16=0.0094, ms_b64=0.0194,
                             ms_int8=0.0104, ms_int8_b16=0.0095,
                             ms_int8_b64=0.0129, ms_floor=0.0097,
                             ms_floor_b16=0.0076, ms_floor_b64=0.0173),
    "probe_dotgeneral": dict(ms=0.0168, ms_tn=0.0177, ms_diag=0.0103),
}
# per-launch breakdowns before a redesign (decode_breakdown_phase,
# PERF.md; NVIDIA H100 80GB HBM3, 700.00 W; us per call, launches): rows 8
# and 6 on their first FMA chains, rows 2, 7 and 10 on the tree at
# 04068b2; not measured by this run, printed on a line of their own
PREV_BREAKDOWN = {
    "row 2 decode_layer_step deep B=1": dict(
        total_us=39.50, launches=10, kernels=[
            ["cached_attention_kernel", 2, 10.864],
            ["gemv_kernel rope", 2, 7.469], ["moe_down_kernel", 1, 5.651],
            ["gemv_kernel plain", 2, 4.643], ["router_kernel", 1, 4.416],
            ["moe_up_kernel", 1, 3.676], ["layernorm_kernel", 1, 2.777]]),
    "row 7 batched_moe_ffn +head B=16": dict(
        total_us=56.58, launches=6, kernels=[
            ["bgemv plain (w2 slots)", 1, 21.005],
            ["bgemv swiglu (w1g slots)", 1, 18.273],
            ["mgemv plain (head)", 1, 7.707], ["close_kernel", 1, 5.088],
            ["router_kernel", 1, 3.637], ["Memset", 1, 0.869]]),
    "row 7 batched_moe_ffn +head B=64": dict(
        total_us=129.50, launches=6, kernels=[
            ["bgemv swiglu (w1g slots)", 1, 63.005],
            ["bgemv plain (w2 slots)", 1, 47.924],
            ["mgemv plain (head)", 1, 8.806], ["close_kernel", 1, 5.122],
            ["router_kernel", 1, 3.695], ["Memset", 1, 0.944]]),
    "row 10 batched_variant_moe_ffn 3.1 B=16": dict(
        total_us=50.18, launches=6, kernels=[
            ["bgemv plain (w2 slots)", 1, 20.982],
            ["bgemv swiglu (w1g slots)", 1, 18.601],
            ["close_kernel", 2, 6.052], ["router_kernel", 1, 3.62],
            ["Memset", 1, 0.929]]),
    "row 8 decode_variant_layer 3.1 deep B=1": dict(
        total_us=60.25, launches=13, kernels=[
            ["attn_kernel", 2, 20.186], ["bgemv plain", 3, 10.775],
            ["bgemv rope", 2, 9.435], ["close_kernel", 3, 8.797],
            ["bgemv swiglu", 1, 6.64], ["router_kernel", 1, 3.487],
            ["Memset", 1, 0.931]]),
    "row 6 batched_layer_step deep B=16": dict(
        total_us=52.95, launches=7, kernels=[
            ["bgemv rope", 2, 19.619], ["bgemv plain", 2, 16.124],
            ["attn_kernel", 2, 14.045], ["close_kernel", 1, 3.158]]),
    "row 6 batched_layer_step deep B=64": dict(
        total_us=97.07, launches=7, kernels=[
            ["attn_kernel", 2, 36.503], ["bgemv rope", 2, 34.217],
            ["bgemv plain", 2, 21.5], ["close_kernel", 1, 4.847]]),
}

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12   # tensor cores
PEAK_F32 = 67e12     # outside the tensor cores (elementwise work)
TF32_PEAK = 495e12   # TF32 on the tensor cores (rows 1, 11 and 14 in f32)


class SmokeFailure(RuntimeError):
    pass


def fail_unless(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def errors(got, want):
    """(max abs error, max abs error / max |want|)."""
    d = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-30)
    return d, d / scale


def check_close(name, dtype, got, want, atol=F32_ATOL):
    import torch
    abs_err, rel_err = errors(got, want)
    if dtype == torch.float32:
        ok = torch.allclose(got.float(), want.float(), rtol=F32_RTOL,
                            atol=atol)
        tol = f"rtol {F32_RTOL} atol {atol}"
    else:
        ok = rel_err <= BF16_REL
        tol = f"rel {BF16_REL}"
    print(f"  {name} [{str(dtype)[6:]}] max_abs {abs_err:.3e} "
          f"max_rel {rel_err:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
    fail_unless(ok, f"{name} [{dtype}] disagrees with its plain version")
    return abs_err


def check_int8_rows(name, got, want):
    """int8 rows a kernel wrote against its plain version's: equal, or at
    most INT8_QUANTUM_SHARE of the elements one quantum apart."""
    d = (got.int() - want.int()).abs()
    worst = int(d.max().item())
    share = (d > 0).float().mean().item()
    ok = worst <= 1 and share <= INT8_QUANTUM_SHARE
    print(f"  {name}: {'equal' if worst == 0 else f'max {worst} quanta'}, "
          f"share one quantum apart {share:.2e} (limit {INT8_QUANTUM_SHARE})"
          f" {'ok' if ok else 'FAIL'}")
    fail_unless(ok, f"{name}: int8 rows differ from the plain version's")


def eager_ms(fn, iters=20):
    """ms per call of fn as Python issues it (host included), from CUDA
    events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters=20, reps=5):
    """(device ms, eager ms) per call of fn. Device: iters calls captured
    into one CUDA graph and replayed, so the host's launch overhead is
    excluded. Eager: iters calls as Python issues them, host included.
    Both from CUDA events after a warm-up."""
    import torch
    eager = eager_ms(fn, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters), eager


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_layer(gen, D, F, E, deep, dtype, dev):
    import torch

    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    p = dict(wqkv=r(3 * D, D, scale=D ** -0.5), bqkv=r(3 * D, scale=0.1),
             wo=r(D, D, scale=D ** -0.5), bo=r(D, scale=0.1),
             cwq=r(D, D, scale=D ** -0.5), cbq=r(D, scale=0.1),
             cwo=r(D, D, scale=D ** -0.5), cbo=r(D, scale=0.1),
             norm_scale=(1 + r(3, D, scale=0.1)), norm_bias=r(3, D, scale=0.1),
             w1g=r(2 * F, D, scale=D ** -0.5), b1g=r(2 * F, scale=0.1),
             w2=r(D, F, scale=F ** -0.5), b2=r(D, scale=0.1))
    if deep:
        p.update(gate_w=r(E, D, scale=D ** -0.5), gate_b=r(E, scale=0.1),
                 ew1g=r(E, 2 * F, D, scale=D ** -0.5),
                 eb1g=r(E, 2 * F, scale=0.1),
                 ew2=r(E, D, F, scale=F ** -0.5), eb2=r(E, D, scale=0.1))
    return {k: v.contiguous() for k, v in p.items()}


def random_head(gen, D, dtype, dev):
    """Embedding / Linear_chord / final norm / head weights (pack_ends)."""
    import torch
    return dict(
        emb_root=torch.randn(15, D, generator=gen).to(dev, dtype),
        emb_attr=torch.randn(16, D, generator=gen).to(dev, dtype),
        lc_w=(torch.randn(D, D, generator=gen) * D ** -0.5).to(dev, dtype),
        lc_krow=torch.randn(D, generator=gen).to(dev, dtype),
        lc_b=(torch.randn(D, generator=gen) * 0.1).to(dev, dtype),
        dn_scale=(1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dtype),
        dn_bias=(0.1 * torch.randn(D, generator=gen)).to(dev, dtype),
        wout=(torch.randn(159, D, generator=gen) * D ** -0.5).to(dev, dtype),
        bout=(0.1 * torch.randn(159, generator=gen)).to(dev, dtype))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def note_bound(report, name, n_bytes, flops, peak=PEAK_BF16):
    """The least time the card needs for the work of the call timed under
    "ms": its bytes (each input read once, each output written once) over
    the memory rate, or its operations over the peak rate of their type,
    whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    report[name]["bound_ms"] = max(t_bytes, t_ops)
    report[name]["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def yardstick_of(dtype):
    """(report key suffix, peak rate of the products) of a dtype's forms:
    ("", the bf16 peak) for bf16, the kernels line's main numbers;
    ("_f32", the TF32 peak) for float32, whose attention kernels run split
    TF32 on the tensor cores."""
    import torch
    return ("_f32", TF32_PEAK) if dtype == torch.float32 else ("", PEAK_BF16)


def note_f32_yardsticks(report, name, key, work, library_ms, backend):
    """An f32 form's bound (its bytes at f32 sizes, its operations at
    TF32_PEAK: the f32 attention kernels run split TF32 on the tensor
    cores) and the library call's f32 time (TF32 off), kept as
    form_bound_<key>_f32 and library_<key>_f32 (the kernels line carries
    both) and printed with the backend the library took."""
    r = report[name]
    r[f"form_bound_{key}_f32"] = form_bound(*work, peak=TF32_PEAK)
    r[f"library_{key}_f32"] = library_ms
    b_ms, by = r[f"form_bound_{key}_f32"]
    print(f"  {name} ({key}) [float32]: bound {b_ms:.5f} ms by {by}; "
          f"F.scaled_dot_product_attention {library_ms:.4f} ms ({backend})")


EXPERT_KEYS = ("ew1g", "eb1g", "ew2", "eb2")
EXPERT_SCALES = ("ew1g_s", "ew2_s")  # the experts' int8 row scales


def layer_work(p, keys, expert_rows=None):
    """(bytes, flops) of the weights ``keys`` of a packed layer read once
    and applied to one row each (2 flops per weight); experts count only
    where ``expert_rows`` (E,) has rows, each applied to that many rows."""
    b = f = 0
    for key in keys:
        t = p[key]
        if key in EXPERT_KEYS + EXPERT_SCALES:
            per = t[0].numel()
            used = int((expert_rows > 0).sum())
            b += used * per * t.element_size()
            f += 2 * per * int(expert_rows.sum())
        else:
            b += nbytes(t)
            f += 2 * t.numel()
    return b, f


def note_error(report, name, dtype, err):
    errs = report[name].setdefault("err", {})
    errs[dtype] = max(err, errs.get(dtype, 0.0))


def note_times(report, name, dtype, kernel_fn, plain_fn, plain_iters=20,
               key="ms"):
    """(kernel device, kernel eager, plain device, plain eager) ms, kept
    under report[name][key][dtype]."""
    times = time_ms(kernel_fn) + time_ms(plain_fn, iters=plain_iters)
    report[name].setdefault(key, {})[dtype] = times
    tag = "" if key == "ms" else f" ({key})"
    print(f"  {name}{tag} [{str(dtype)[6:]}] kernel {times[0]:.4f} ms "
          f"device ({times[1]:.4f} ms eager), plain {times[2]:.4f} ms device "
          f"({times[3]:.4f} ms eager)")


def kernel_phase(report, v2m):
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from video2music_tpu_torch.ops.scan import (selective_scan,
                                                selective_scan_plain)

    dev = v2m.device
    cfg = v2m.amt_cfg  # the product shapes
    D, F, E, H = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.num_heads
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    mamba = v2m.model_reg.backbone.layers[0].mamba_forward.cfg
    hd = D // H
    gen = torch.Generator().manual_seed(1234)
    rope = rope_tables(v2m.model, dev)
    for dtype in (torch.float32, torch.bfloat16):
        print(f"kernels, {dtype}:")
        # kernel 1: flash attention, encoder self-attention shape
        q, k, v = (torch.randn(1, H, Sm, hd, generator=gen).to(dev, dtype)
                   for _ in range(3))
        bias = torch.randn(1, H, Sm, Sm, generator=gen).to(dev)
        for tag, kw in (("", {}), ("+bias", dict(bias=bias)),
                        ("+causal", dict(causal=True))):
            err = check_close(f"flash_attention{tag}", dtype,
                              flash_attention(q, k, v, **kw),
                              flash_attention_plain(q, k, v, **kw))
            note_error(report, "flash_attention", dtype, err)
        note_times(report, "flash_attention", dtype,
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention_plain(q, k, v))
        work = (nbytes(q, k, v, q), 4 * H * Sm * Sm * hd)
        lib = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))[0]
        if dtype == torch.bfloat16:
            note_bound(report, "flash_attention", *work)
            report["flash_attention"]["library_ms"] = lib
        else:
            note_f32_yardsticks(report, "flash_attention", "ms", work, lib,
                                sdpa_backend(q, k, v))

        # kernels 2 and 3: decode layer, shallow and deep, plain and ends
        pos = S // 2
        kx, vx = (torch.randn(Sm, D, generator=gen).to(dev, dtype)
                  for _ in range(2))
        caches = [torch.randn(S, D, generator=gen).to(dev, dtype)
                  for _ in range(2)]
        x = torch.randn(1, D, generator=gen).to(dev, dtype)
        head = random_head(gen, D, dtype, dev)
        root = torch.tensor([3], device=dev, dtype=torch.int32)
        attr = torch.tensor([5], device=dev, dtype=torch.int32)
        key = torch.tensor([1.0], device=dev)
        kw = dict(n_heads=H, k_top=2, rope=rope)
        for deep in (False, True):
            p = random_layer(gen, D, F, E, deep, dtype, dev)
            tag = "deep" if deep else "shallow"
            kc1, vc1 = (c.clone() for c in caches)
            kc2, vc2 = (c.clone() for c in caches)
            got = dl.decode_layer_step(x, pos, p, kc1, vc1, kx, vx, **kw)
            want = dl.decode_layer_plain(x, pos, p, kc2, vc2, kx, vx, **kw)
            err = check_close(f"decode_layer {tag}", dtype, got, want)
            check_close(f"decode_layer {tag} k row", dtype, kc1[pos], kc2[pos])
            check_close(f"decode_layer {tag} v row", dtype, vc1[pos], vc2[pos])
            note_error(report, "decode_layer", dtype, err)
            if deep:
                note_times(report, "decode_layer", dtype,
                           lambda: dl.decode_layer_step(
                               x, pos, p, kc1, vc1, kx, vx, **kw),
                           lambda: dl.decode_layer_plain(
                               x, pos, p, kc2, vc2, kx, vx, **kw))
                # one row: the k_top experts its router picks, the self
                # cache rows 0..pos, all cross rows; the new K/V row out
                el = x.element_size()
                rows = torch.zeros(E)
                rows[:2] = 1
                w_b, w_f = layer_work(p, p.keys(), rows)
                c_b = 2 * (pos + 1) * D * el + nbytes(kx, vx)
                c_f = 4 * (pos + 1) * D + 4 * Sm * D
                if dtype == torch.bfloat16:
                    note_bound(report, "decode_layer",
                               w_b + c_b + nbytes(x) * 2 + 2 * D * el,
                               w_f + c_f)
                    report["decode_layer"]["library_ms"] = None
            # ends: embed prologue on the shallow layer, head on the deep one
            ends = dict(embed=not deep, fold_head=deep, x=None if not deep else x)
            kc1, vc1 = (c.clone() for c in caches)
            kc2, vc2 = (c.clone() for c in caches)
            got = dl.decode_ends_step(root, attr, key, pos, p, head, kc1, vc1,
                                      kx, vx, **kw, **ends)
            want = dl.decode_ends_plain(root, attr, key, pos, p, head, kc2,
                                        vc2, kx, vx, **kw, **ends)
            err = check_close(f"decode_ends {'head' if deep else 'embed'}",
                              dtype, got, want)
            note_error(report, "decode_ends", dtype, err)
            if deep:
                note_times(report, "decode_ends", dtype,
                           lambda: dl.decode_ends_step(
                               root, attr, key, pos, p, head, kc1, vc1, kx,
                               vx, **kw, **ends),
                           lambda: dl.decode_ends_plain(
                               root, attr, key, pos, p, head, kc2, vc2, kx,
                               vx, **kw, **ends))
                if dtype == torch.bfloat16:  # the deep layer + the head
                    h_b, h_f = layer_work(head, ("dn_scale", "dn_bias",
                                                 "wout", "bout"))
                    note_bound(report, "decode_ends",
                               w_b + c_b + h_b + nbytes(x) + 2 * D * el
                               + 159 * el, w_f + c_f + h_f)
                    report["decode_ends"]["library_ms"] = None

        # kernel 4: selective scan, bimamba+ block shape
        L, ED, N = Sm, mamba.d_inner, mamba.d_state
        xs = torch.randn(1, L, ED, generator=gen).to(dev, dtype)
        dt = (torch.rand(1, L, ED, generator=gen) * 0.1).to(dev, dtype)
        A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(ED, 1).to(dev)
        Bm, Cm = (torch.randn(1, L, N, generator=gen).to(dev, dtype)
                  for _ in range(2))
        Dv = torch.ones(ED, device=dev)
        err = check_close("selective_scan", dtype,
                          selective_scan(xs, dt, A, Bm, Cm, Dv),
                          selective_scan_plain(xs, dt, A, Bm, Cm, Dv))
        note_error(report, "selective_scan", dtype, err)
        note_times(report, "selective_scan", dtype,
                   lambda: selective_scan(xs, dt, A, Bm, Cm, Dv),
                   lambda: selective_scan_plain(xs, dt, A, Bm, Cm, Dv),
                   plain_iters=3)
        if dtype == torch.bfloat16:
            # per (step, channel, state): exp, 4 mul, 2 add, 1 fma, in f32
            note_bound(report, "selective_scan",
                       nbytes(xs, dt, A, Bm, Cm, Dv, xs), 8 * L * ED * N,
                       peak=PEAK_F32)
            report["selective_scan"]["library_ms"] = None


def run_work(layers, pos, Sm, el):
    """(bytes, flops) of a run of packed layers at one position: every
    weight read once (the experts: two per MoE layer, what top-2 reads),
    the self cache rows 0..pos, all cross rows and the new K/V rows."""
    import torch
    b = f = 0
    for p in layers:
        D = p["wqkv"].shape[-1]
        rows = None
        if "gate_w" in p:
            rows = torch.zeros(p["gate_w"].shape[0])
            rows[:2] = 1
        w_b, w_f = layer_work(p, p.keys(), rows)
        b += w_b + 2 * (pos + 1) * D * el + 2 * Sm * D * el + 2 * D * el
        f += w_f + 4 * (pos + 1) * D + 4 * Sm * D
    return b, f


def stack_kernel_phase(report, v2m):
    """The cooperative whole-run kernel behind its three wrappers, on the
    full-width 2.2 model's packed weights (random from seed 0), pos 150,
    random caches: all six layers with the embed and head folded and a
    two-layer middle run (decode_flat_monolith_step), the SwiGLU and MoE
    segments (decode_segment_step), the monolith over (L, S, D) caches;
    then the decode layer with int8 weights, shallow and deep."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops import decode_stack as ds

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, H, S, Sm = cfg.d_model, cfg.num_heads, cfg.max_seq_chord, \
        cfg.max_seq_video
    L = len(cfg.decoder_layers)
    pos = S // 2
    gen = torch.Generator().manual_seed(4321)
    root = torch.tensor([3], device=dev, dtype=torch.int32)
    attr = torch.tensor([5], device=dev, dtype=torch.int32)
    key = torch.tensor([1.0], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        print(f"stack kernels, {dtype}:")
        model, _ = v2m._models(name)
        kw = dict(n_heads=H, k_top=cfg.moe.n_experts_per_token,
                  rope=rope_tables(model, dev))
        packed = ds.pack_monolith(model)
        layers = packed["layers"]
        el = torch.finfo(dtype).bits // 8

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(dev, dtype)

        kc, vc = rnd(L, S, D), rnd(L, S, D)
        kx, vx = rnd(L, Sm, D), rnd(L, Sm, D)
        x = rnd(1, D)

        def flat_caches(k, v, idx):
            return [(k[i], v[i], kx[i], vx[i]) for i in idx]

        # the whole run: six layers, embed and head folded
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = ds.decode_flat_monolith_step(root, attr, key, pos, layers,
                                           packed, flat_caches(k1, v1,
                                                               range(L)),
                                           **kw)
        want = ds.decode_flat_monolith_plain(root, attr, key, pos, layers,
                                             packed, flat_caches(k2, v2,
                                                                 range(L)),
                                             **kw)
        err = check_close("decode_flat_monolith all layers", dtype, got,
                          want)
        check_close("decode_flat_monolith caches", dtype, k1, k2)
        note_error(report, "decode_flat_monolith", dtype, err)
        plans = {}
        caches = flat_caches(k1, v1, range(L))
        note_times(report, "decode_flat_monolith", dtype,
                   lambda: ds.decode_flat_monolith_step(
                       root, attr, key, pos, layers, packed, caches,
                       plans=plans, **kw),
                   lambda: ds.decode_flat_monolith_plain(
                       root, attr, key, pos, layers, packed,
                       flat_caches(k2, v2, range(L)), **kw), plain_iters=5)
        # a middle run, a SwiGLU and a MoE layer, no ends
        mid = [L // 2 - 1, L // 2]
        got = ds.decode_flat_monolith_step(
            None, None, None, pos, [layers[i] for i in mid], None,
            flat_caches(k1, v1, mid), embed=False, fold_head=False, x=x,
            **kw)
        want = ds.decode_flat_monolith_plain(
            None, None, None, pos, [layers[i] for i in mid], None,
            flat_caches(k2, v2, mid), embed=False, fold_head=False, x=x,
            **kw)
        note_error(report, "decode_flat_monolith", dtype, check_close(
            "decode_flat_monolith middle run", dtype, got, want))
        # the monolith over stacked caches
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = ds.decode_monolith_step(root, attr, key, pos, packed, k1, v1,
                                      kx, vx, **kw)
        want = ds.decode_monolith_plain(root, attr, key, pos, packed, k2,
                                        v2, kx, vx, **kw)
        note_error(report, "decode_monolith", dtype, check_close(
            "decode_monolith", dtype, got, want))
        check_close("decode_monolith caches", dtype, v1, v2)
        plans_m = {}
        note_times(report, "decode_monolith", dtype,
                   lambda: ds.decode_monolith_step(
                       root, attr, key, pos, packed, k1, v1, kx, vx,
                       plans=plans_m, **kw),
                   lambda: ds.decode_monolith_plain(
                       root, attr, key, pos, packed, k2, v2, kx, vx, **kw),
                   plain_iters=5)
        # the segments: SwiGLU then MoE (the MoE one timed)
        segs = ds.pack_decoder_segments(model)
        for seg in segs:
            idx = slice(seg["start"], seg["start"] + len(seg["layers"]))
            sk1, sv1 = kc[idx].clone(), vc[idx].clone()
            sk2, sv2 = kc[idx].clone(), vc[idx].clone()
            skx, svx = kx[idx].contiguous(), vx[idx].contiguous()
            got = ds.decode_segment_step(x, pos, seg, sk1, sv1, skx, svx,
                                         **kw)
            want = ds.decode_segment_plain(x, pos, seg, sk2, sv2, skx, svx,
                                           **kw)
            note_error(report, "decode_segment", dtype, check_close(
                f"decode_segment {seg['kind']}", dtype, got, want))
            check_close(f"decode_segment {seg['kind']} caches", dtype, sk1,
                        sk2)
            if seg["kind"] == "moe":
                plans_s = {}
                note_times(report, "decode_segment", dtype,
                           lambda: ds.decode_segment_step(
                               x, pos, seg, sk1, sv1, skx, svx,
                               plans=plans_s, **kw),
                           lambda: ds.decode_segment_plain(
                               x, pos, seg, sk2, sv2, skx, svx, **kw),
                           plain_iters=5)
                seg_work = run_work(seg["layers"], pos, Sm, el)
        # int8 decode layer, shallow and deep (the deep one timed)
        q_layers = dl.pack_decoder_layers(model, quantize="int8")
        for i in (0, L - 1):
            p = q_layers[i]
            k1, v1 = kc[i].clone(), vc[i].clone()
            k2, v2 = kc[i].clone(), vc[i].clone()
            got = dl.decode_layer_step(x, pos, p, k1, v1, kx[i], vx[i], **kw)
            want = dl.decode_layer_plain(x, pos, p, k2, v2, kx[i], vx[i],
                                         **kw)
            tag = "deep" if i else "shallow"
            err = check_close(f"decode_layer int8 {tag}", dtype, got, want)
            errs = report["decode_layer"].setdefault("err_int8", {})
            errs[dtype] = max(err, errs.get(dtype, 0.0))
            if i:
                note_times(report, "decode_layer", dtype,
                           lambda: dl.decode_layer_step(
                               x, pos, p, k1, v1, kx[i], vx[i], **kw),
                           lambda: dl.decode_layer_plain(
                               x, pos, p, k2, v2, kx[i], vx[i], **kw),
                           key="ms_int8")
                q_work = run_work([p], pos, Sm, el)
        if dtype == torch.bfloat16:
            # the ends: two embedding rows, Linear_chord, the final norm
            # and the head
            h_b, h_f = layer_work(packed, ("lc_w", "lc_krow", "lc_b",
                                           "dn_scale", "dn_bias", "wout",
                                           "bout"))
            h_b += 2 * D * el
            w_b, w_f = run_work(layers, pos, Sm, el)
            for name in ("decode_flat_monolith", "decode_monolith"):
                note_bound(report, name, w_b + h_b + 159 * el, w_f + h_f)
                report[name]["library_ms"] = None
            note_bound(report, "decode_segment",
                       seg_work[0] + 2 * nbytes(x), seg_work[1])
            report["decode_segment"]["library_ms"] = None
            report["decode_layer"]["bound_ms_int8"] = max(
                (q_work[0] + 2 * nbytes(x)) / HBM_BYTES_PER_S * 1e3,
                q_work[1] / PEAK_BF16 * 1e3)


def stack_positions_phase(report, v2m):
    """The cooperative kernel over the whole six-layer step with the embed
    and the head (decode_monolith_step) against its plain version at pos
    0, 1, 150 and S - 1, with Sm = 300 and an odd Sm = 37, and at two
    shapes whose attention splits take several tiles each (Sm = 1500 at
    pos 150; a 1100-row self cache at pos 1099); float32 and bfloat16,
    random caches: the logits, and the K / V rows written at pos. Every
    router's expert ids are compared too: in bfloat16 a case whose ids
    differ (a near-tie flipped by a one-ulp difference) may leave the
    tolerance, at most one case in BF16_ROUTE_SHARE and at least one."""
    import torch
    from video2music_tpu_torch.ops import decode_stack as ds
    from video2music_tpu_torch.ops.embeddings import rope_table

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, H, S, Sm = cfg.d_model, cfg.num_heads, cfg.max_seq_chord, \
        cfg.max_seq_video
    L = len(cfg.decoder_layers)
    gen = torch.Generator().manual_seed(1357)
    tokens = (torch.tensor([3], device=dev, dtype=torch.int32),
              torch.tensor([5], device=dev, dtype=torch.int32),
              torch.tensor([1.0], device=dev))
    cases = [(S, m, pos) for m in (Sm, 37) for pos in (0, 1, S // 2, S - 1)]
    cases += [(S, 1500, S // 2), (1100, Sm, 1099)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        model, _ = v2m._models(name)
        packed = ds.pack_monolith(model)
        outliers = []
        for S_, Sm_, pos in cases:
            table = rope_table(max(S_, Sm_), D // H, dev)
            kw = dict(n_heads=H, k_top=cfg.moe.n_experts_per_token,
                      rope=(table[..., 0].contiguous(),
                            table[..., 1].contiguous()))
            kc, vc = (torch.randn(L, S_, D, generator=gen).to(dev, dtype)
                      for _ in range(2))
            kx, vx = (torch.randn(L, Sm_, D, generator=gen).to(dev, dtype)
                      for _ in range(2))
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got, k_routes = routed_step(
                lambda *_: ds.decode_monolith_step(
                    *tokens, pos, packed, k1, v1, kx, vx, **kw),
                None, None, None, None, pos)
            want, p_routes = routed_step(
                lambda *_: ds.decode_monolith_plain(
                    *tokens, pos, packed, k2, v2, kx, vx, **kw),
                None, None, None, None, pos)
            tag = f"decode_monolith S={S_} Sm={Sm_} pos={pos}"
            diffs = route_diffs(pos, k_routes, p_routes)
            if dtype == torch.bfloat16 and diffs:
                abs_err, rel_err = errors(got, want)
                outliers.append((S_, Sm_, pos, round(rel_err, 4)))
                print(f"  {tag} [{name}] expert ids differ {diffs}: max_rel "
                      f"{rel_err:.3e}, counted as a router near-tie")
                continue
            note_error(report, "decode_monolith", dtype,
                       check_close(tag, dtype, got, want))
            for c1, c2, kv in ((k1, k2, "k"), (v1, v2, "v")):
                check_close(f"{tag} {kv} rows at pos", dtype, c1[:, pos],
                            c2[:, pos])
        fail_unless(len(outliers) * BF16_ROUTE_SHARE <= max(16, len(cases)),
                    f"stack positions [{name}]: {len(outliers)} of "
                    f"{len(cases)} cases took other experts {outliers}")


# the selective scan's shapes beyond the product's: batch rows, d_state N
# (12: odd; 16: the product's bimamba+; 64; 1024: moemamba's d_state =
# d_hidden) and L (one step, the kernel's chunk + 1, a 300 s clip)
SCAN_CASES = dict(b=(1, 16), N=(12, 16, 64, 1024), L=(1, 65, 300))


def scan_shapes_phase(report, v2m):
    """The selective scan against its plain version at every (b, N, L) of
    SCAN_CASES, ED the bimamba+ block's d_inner, float32 and bfloat16; the
    kernel's device ms at L = 300 for each (b, N), bfloat16 and float32."""
    import itertools

    import torch
    from video2music_tpu_torch.ops.scan import (selective_scan,
                                                selective_scan_plain)

    dev = v2m.device
    ED = v2m.model_reg.backbone.layers[0].mamba_forward.cfg.d_inner
    gen = torch.Generator().manual_seed(2468)
    out = report.setdefault("scan_shapes", {})
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b, N, L in itertools.product(*SCAN_CASES.values()):
            x = torch.randn(b, L, ED, generator=gen).to(dev, dtype)
            dt = (torch.rand(b, L, ED, generator=gen) * 0.1).to(dev, dtype)
            A = (-0.5 - 4 * torch.rand(ED, N, generator=gen)).to(dev)
            Bm, Cm = (torch.randn(b, L, N, generator=gen).to(dev, dtype)
                      for _ in range(2))
            Dv = torch.randn(ED, generator=gen).to(dev)
            got = selective_scan(x, dt, A, Bm, Cm, Dv)
            want = selective_scan_plain(x, dt, A, Bm, Cm, Dv)
            note_error(report, "selective_scan", dtype, check_close(
                f"selective_scan b={b} N={N} L={L}", dtype, got, want))
            if L == 300:
                ms = time_ms(lambda: selective_scan(x, dt, A, Bm, Cm, Dv))[0]
                out[f"{name} b={b} N={N}"] = ms
                print(f"  selective_scan b={b} N={N} L={L} [{name}] kernel "
                      f"{ms:.4f} ms device")
            del got, want


# the probe's breakdown of the cooperative kernel before its redesign
# (stack_breakdown_phase on the tree at e773164 with the probe added, an
# earlier run, PERF.md; NVIDIA H100 80GB HBM3, 700.00 W; us summed over
# the six layers, the mean of 10 launches; 8 grid barriers a layer); not
# measured by this run
PREV_STACK_BREAKDOWN = {
    "embed": 3.933, "qkv": 33.798, "self_attention": 40.24, "wo": 16.989,
    "cross_q": 33.571, "cross_attention": 61.274, "cwo": 17.098,
    "ffn_up_router": 45.376, "down": 40.886, "head": 7.466,
    "barrier_wait": 43.61, "total": 344.24}


def stack_breakdown_phase(report, v2m, card):
    """The cooperative kernel's probe instance (ops/decode_stack.py
    _Run.probe) on the six-layer bf16 run with the embed and the head at
    pos 150, full width, random caches: microseconds of each phase kind
    summed over the layers (from the previous boundary to the last block
    finishing it), of the embed and the head, and of the grid barriers'
    waits; the means of 10 launches, one line, beside the first design's
    (PREV_STACK_BREAKDOWN)."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_stack as ds

    dev, dtype = v2m.device, torch.bfloat16
    cfg = v2m.amt_cfg
    D, S, Sm = cfg.d_model, cfg.max_seq_chord, cfg.max_seq_video
    L = len(cfg.decoder_layers)
    pos = S // 2
    model, _ = v2m._models("bfloat16")
    kw = dict(n_heads=cfg.num_heads, k_top=cfg.moe.n_experts_per_token,
              rope=rope_tables(model, dev))
    packed = ds.pack_monolith(model)
    gen = torch.Generator().manual_seed(97)
    caches = [tuple(torch.randn(n, D, generator=gen).to(dev, dtype)
                    for n in (S, S, Sm, Sm)) for _ in range(L)]
    tokens = (torch.tensor([3], device=dev, dtype=torch.int32),
              torch.tensor([5], device=dev, dtype=torch.int32),
              torch.tensor([1.0], device=dev))
    plans = {}
    ds.decode_flat_monolith_step(*tokens, pos, packed["layers"], packed,
                                 caches, plans=plans, **kw)
    reads = [plans["run"].probe(pos, tokens=tokens) for _ in range(10)]
    mean = {k: round(sum(r[k] for r in reads) / len(reads), 3)
            for k in reads[0] if not k.startswith("marks")}
    for k in ("marks_block0", "marks_last"):
        mean[k] = [None if r0 is None else round(
            sum(r[k][j] for r in reads) / len(reads), 2)
            for j, r0 in enumerate(reads[0][k])]
    report["stack_breakdown"] = mean
    print(f"stack breakdown bf16 {L} layers + embed + head pos {pos} (this "
          f"run, probe instance, mean of 10 launches, us): "
          f"{json.dumps(mean)} [{card}]")
    print(f"stack breakdown before the redesign (an earlier run's, PERF.md; "
          f"not measured by this run): {json.dumps(PREV_STACK_BREAKDOWN)}")


def batched_kernel_phase(report, v2m):
    """The batched decode kernels at B=16 (and timed at B=64), product
    widths, pos 150; flash attention and the scan at B=16."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from video2music_tpu_torch.ops.scan import (selective_scan,
                                                selective_scan_plain)

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, F, E, H = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.num_heads
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    k_top = cfg.moe.n_experts_per_token
    mamba = v2m.model_reg.backbone.layers[0].mamba_forward.cfg
    hd = D // H
    pos = S // 2
    gen = torch.Generator().manual_seed(4321)
    kw = dict(n_heads=H, rope=rope_tables(v2m.model, dev))
    for dtype in (torch.float32, torch.bfloat16):
        print(f"batched kernels, {dtype}:")
        head = random_head(gen, D, dtype, dev)
        shallow = random_layer(gen, D, F, E, False, dtype, dev)
        deep = random_layer(gen, D, F, E, True, dtype, dev)
        for B in (16, 64):
            caches = [torch.randn(B, S, D, generator=gen).to(dev, dtype)
                      for _ in range(2)]
            kx, vx = (torch.randn(B, Sm, D, generator=gen).to(dev, dtype)
                      for _ in range(2))
            x = torch.randn(B, D, generator=gen).to(dev, dtype)
            tokens = (torch.randint(15, (B,), generator=gen).to(dev),
                      torch.randint(16, (B,), generator=gen).to(dev),
                      torch.randint(2, (B,), generator=gen).to(dev).float())
            key = "ms" if B == 16 else f"ms_b{B}"
            for tag, p, x_in, tok in (("shallow+embed", shallow, None, tokens),
                                      ("deep", deep, x, None)):
                kc1, vc1 = (c.clone() for c in caches)
                kc2, vc2 = (c.clone() for c in caches)
                lkw = dict(kw, tokens=tok, embed_pack=head if tok else None)
                got = db.batched_layer_step(x_in, pos, p, kc1, vc1, kx, vx,
                                            **lkw)
                want = db.batched_layer_step_plain(x_in, pos, p, kc2, vc2,
                                                   kx, vx, **lkw)
                name = f"batched_layer_step {tag} B={B}"
                err = check_close(name, dtype, got, want)
                check_close(name + " k row", dtype, kc1[:, pos], kc2[:, pos])
                check_close(name + " v row", dtype, vc1[:, pos], vc2[:, pos])
                fail_unless(torch.equal(kc1[:, :pos], kc2[:, :pos]),
                            f"{name}: cache rows other than pos changed")
                if B == 16:
                    note_error(report, "batched_layer_step", dtype, err)
                if tag == "deep":
                    note_times(report, "batched_layer_step", dtype,
                               lambda: db.batched_layer_step(
                                   x, pos, p, kc1, vc1, kx, vx, **kw),
                               lambda: db.batched_layer_step_plain(
                                   x, pos, p, kc2, vc2, kx, vx, **kw),
                               key=key)
                if tag == "deep" and dtype == torch.bfloat16:
                    # the attention block's weights once for the batch;
                    # per clip self rows 0..pos and all cross rows
                    el = x.element_size()
                    w_b, w_f = layer_work(p, db._LAYER_KEYS)
                    work = (w_b + B * (2 * (pos + 1) * D * el)
                            + nbytes(kx, vx) + 4 * nbytes(x),
                            B * (w_f + 4 * (pos + 1) * D + 4 * Sm * D))
                    if B == 16:
                        note_bound(report, "batched_layer_step", *work)
                        report["batched_layer_step"]["library_ms"] = None
                    else:
                        report["batched_layer_step"][
                            "form_bound_" + key] = form_bound(*work)
            for tag, hp in (("", None), ("+head", head)):
                got = db.batched_moe_ffn(x, deep, k_top=k_top, head_pack=hp)
                want = db.batched_moe_ffn_plain(x, deep, k_top=k_top,
                                                head_pack=hp)
                err = check_close(f"batched_moe_ffn{tag} B={B}", dtype, got,
                                  want)
                if B == 16:
                    note_error(report, "batched_moe_ffn", dtype, err)
            note_times(report, "batched_moe_ffn", dtype,
                       lambda: db.batched_moe_ffn(x, deep, k_top=k_top,
                                                  head_pack=head),
                       lambda: db.batched_moe_ffn_plain(
                           x, deep, k_top=k_top, head_pack=head), key=key)
            if dtype == torch.bfloat16:
                # shared expert, router, norm and head for every clip; each
                # expert its router picked, for the clips that picked it
                rows = (db.route_plain(x, deep["gate_w"], deep["gate_b"],
                                       k_top) != 0).sum(0).cpu()
                s_b, s_f = layer_work(deep, ("w1g", "b1g", "w2", "b2",
                                             "gate_w", "gate_b",
                                             "norm_scale", "norm_bias"))
                e_b, e_f = layer_work(deep, EXPERT_KEYS, rows)
                h_b, h_f = layer_work(head, ("dn_scale", "dn_bias", "wout",
                                             "bout"))
                work = (s_b + e_b + h_b + nbytes(x) + B * 159
                        * x.element_size(), B * (s_f + h_f) + e_f)
                if B == 16:
                    note_bound(report, "batched_moe_ffn", *work)
                    report["batched_moe_ffn"]["library_ms"] = None
                else:
                    report["batched_moe_ffn"]["form_bound_" + key] = \
                        form_bound(*work)

        # flash attention and the scan at the batch of the serving path
        B = 16
        q, k, v = (torch.randn(B, H, Sm, hd, generator=gen).to(dev, dtype)
                   for _ in range(3))
        err = check_close(f"flash_attention B={B}", dtype,
                          flash_attention(q, k, v),
                          flash_attention_plain(q, k, v))
        note_error(report, "flash_attention", dtype, err)
        note_times(report, "flash_attention", dtype,
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention_plain(q, k, v), key="ms_b16")
        work = (nbytes(q, k, v, q), 4 * B * H * Sm * Sm * hd)
        lib = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))[0]
        if dtype == torch.bfloat16:
            report["flash_attention"]["library_ms_b16"] = lib
            report["flash_attention"]["form_bound_ms_b16"] = form_bound(
                *work)
        else:
            note_f32_yardsticks(report, "flash_attention", "ms_b16", work,
                                lib, sdpa_backend(q, k, v))
        L, ED, N = Sm, mamba.d_inner, mamba.d_state
        xs = torch.randn(B, L, ED, generator=gen).to(dev, dtype)
        dt = (torch.rand(B, L, ED, generator=gen) * 0.1).to(dev, dtype)
        A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(ED, 1).to(dev)
        Bm, Cm = (torch.randn(B, L, N, generator=gen).to(dev, dtype)
                  for _ in range(2))
        Dv = torch.ones(ED, device=dev)
        err = check_close(f"selective_scan B={B}", dtype,
                          selective_scan(xs, dt, A, Bm, Cm, Dv),
                          selective_scan_plain(xs, dt, A, Bm, Cm, Dv))
        note_error(report, "selective_scan", dtype, err)
        note_times(report, "selective_scan", dtype,
                   lambda: selective_scan(xs, dt, A, Bm, Cm, Dv),
                   lambda: selective_scan_plain(xs, dt, A, Bm, Cm, Dv),
                   plain_iters=3, key="ms_b16")
        if dtype == torch.bfloat16:
            report["selective_scan"]["form_bound_ms_b16"] = form_bound(
                nbytes(xs, dt, A, Bm, Cm, Dv, xs), 8 * B * L * ED * N,
                peak=PEAK_F32)


def int8_kv_kernel_phase(report, v2m, tag=""):
    """The int8-KV form of batched_layer_step at B=16 (timed at B=64 too),
    v2m's widths (the product's; ``tag`` "_hd8": its 64 heads of 8, the
    times kept under "ms_int8_hd8"), float32 and bfloat16: the shallow
    layer with the embed prologue and the deep layer, on int8 self caches
    whose rows 0..149 hold quantized random rows (pos 150) and int8 cross
    K/V, against the plain version: the output, the int8 K/V rows and the
    scales written at pos, and the rows before pos untouched."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch as db

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, F, E, H = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.num_heads
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    pos = S // 2
    gen = torch.Generator().manual_seed(1357)
    kw = dict(n_heads=H, rope=rope_tables(v2m.model, dev))
    r = report["batched_layer_step"]
    for dtype in (torch.float32, torch.bfloat16):
        print(f"int8-KV batched layer, {dtype}:")
        head = random_head(gen, D, dtype, dev)
        shallow = random_layer(gen, D, F, E, False, dtype, dev)
        deep = random_layer(gen, D, F, E, True, dtype, dev)
        for B in (16, 64):
            def quantized(rows, filled):
                q, s = db.quantize_kv_rows(
                    torch.randn(B, rows, D, generator=gen).to(dev))
                q[:, filled:] = 0
                s[:, filled:] = 0
                return q, s
            (kc, ks), (vc, vs) = quantized(S, pos), quantized(S, pos)
            (kx, kxs), (vx, vxs) = quantized(Sm, Sm), quantized(Sm, Sm)
            x = torch.randn(B, D, generator=gen).to(dev, dtype)
            tokens = (torch.randint(15, (B,), generator=gen).to(dev),
                      torch.randint(16, (B,), generator=gen).to(dev),
                      torch.randint(2, (B,), generator=gen).to(dev).float())
            key = f"ms_int8{tag}" if B == 16 else f"ms_int8{tag}_b{B}"
            for form, p, x_in, tok in (
                    ("shallow+embed", shallow, None, tokens),
                    ("deep", deep, x, None)):
                one, two = ([t.clone() for t in (kc, vc, ks, vs)]
                            for _ in range(2))
                lkw = dict(kw, tokens=tok, embed_pack=head if tok else None)
                got = db.batched_layer_step(
                    x_in, pos, p, one[0], one[1], kx, vx,
                    kv_scales=(one[2], one[3], kxs, vxs), **lkw)
                want = db.batched_layer_step_plain(
                    x_in, pos, p, two[0], two[1], kx, vx,
                    kv_scales=(two[2], two[3], kxs, vxs), **lkw)
                name = (f"batched_layer_step int8 KV {form} B={B}"
                        f"{' hd ' + str(D // H) if tag else ''}")
                err = check_close(name, dtype, got, want)
                for i, row in enumerate(("k", "v")):
                    check_int8_rows(f"{name} {row} row", one[i][:, pos],
                                    two[i][:, pos])
                    check_close(f"{name} {row} scale", torch.float32,
                                one[i + 2][:, pos], two[i + 2][:, pos])
                fail_unless(all(torch.equal(a[:, :pos], b[:, :pos])
                                for a, b in zip(one, two)),
                            f"{name}: cache rows other than pos changed")
                if B == 16:
                    errs = r.setdefault(f"err_int8{tag}", {})
                    errs[dtype] = max(err, errs.get(dtype, 0.0))
                if form != "deep":
                    continue
                scales = (one[2], one[3], kxs, vxs)
                note_times(report, "batched_layer_step", dtype,
                           lambda: db.batched_layer_step(
                               x, pos, p, one[0], one[1], kx, vx,
                               kv_scales=scales, **kw),
                           lambda: db.batched_layer_step_plain(
                               x, pos, p, two[0], two[1], kx, vx,
                               kv_scales=(two[2], two[3], kxs, vxs), **kw),
                           key=key)
                if dtype == torch.bfloat16:
                    # the attention block's weights once for the batch; per
                    # clip self rows 0..pos and all cross rows at one byte
                    # an element and four a row scale; x in, y and the new
                    # int8 rows with their scales out
                    w_b, w_f = layer_work(p, db._LAYER_KEYS)
                    c_b = B * (2 * (pos + 1) * (D + 4) + 2 * Sm * (D + 4))
                    bound = form_bound(
                        w_b + c_b + 2 * nbytes(x) + 2 * B * (D + 4),
                        B * (w_f + 4 * (pos + 1) * D + 4 * Sm * D))
                    if B == 16 and not tag:
                        r["bound_ms_int8"] = bound[0]
                    else:
                        r["form_bound_" + key] = bound


def dropout_kernel_phase(report, cfg):
    """The dropout attention kernels at the training shape (B=16, H=8,
    L=S=300, D=64, rate 0.1), causal and not, f32 and bf16, plus a small
    case with a bias: the output and the gradients against the plain
    versions, the mask entry for entry (f32, read through identity values),
    row 11's shard forms (:func:`dropout_origin_form`), the times of both
    and of F.scaled_dot_product_attention with the same dropout rate
    (which draws another mask)."""
    import torch
    from video2music_tpu_torch.ops import flash_attention_dropout as fad

    dev = "cuda"
    B, H, L, D, rate = 16, cfg.num_heads, cfg.max_seq_chord, cfg.head_dim, \
        cfg.dropout
    gen = torch.Generator().manual_seed(99)
    seed = torch.tensor([20241016], dtype=torch.int32, device=dev)
    fwd_name, bwd_name = TRAIN_KERNELS
    for dtype in (torch.float32, torch.bfloat16):
        print(f"dropout attention kernels, {dtype}:")
        cases = [(B, H, L, D, causal, False) for causal in (False, True)]
        cases.append((2, H, 77, D, True, True))
        for (b, h, l, d, causal, use_bias) in cases:
            q, k, v, do = (torch.randn(b, h, l, d, generator=gen).to(dev, dtype)
                           for _ in range(4))
            bias = (torch.randn(b, h, l, l, generator=gen).to(dev)
                    if use_bias else None)
            tag = f" B={b} L={l}" + (" causal" if causal else "") + \
                (" +bias" if use_bias else "")
            out, stats = fad.flash_attention_dropout_fwd(q, k, v, bias, seed,
                                                         causal, rate)
            want = fad.flash_attention_dropout_plain(
                q, k, v, bias=bias, causal=causal, dropout_rate=rate,
                seed=seed)
            err = check_close(f"{fwd_name}{tag}", dtype, out, want)
            note_error(report, fwd_name, dtype, err)
            grads = fad.flash_attention_dropout_bwd(q, k, v, bias, do, seed,
                                                    stats, out, causal, rate)
            wants = fad.flash_attention_dropout_plain_bwd(
                q, k, v, do, bias=bias, causal=causal, dropout_rate=rate,
                seed=seed)
            for gname, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wants):
                if w is not None:
                    err = check_close(f"{bwd_name} {gname}{tag}", dtype, g, w)
                    note_error(report, bwd_name, dtype, err)
            # the mask, read back through identity values: f32 from the
            # split-TF32 kernel, bf16 from the bf16 one (its weights
            # rounded to bf16, so held to BF16_REL)
            got = fad.extract_dropped_probs(q, k, bias=bias, causal=causal,
                                            dropout_rate=rate, seed=seed)
            ref = fad._probs(q, k, bias, causal) * fad.dropout_mask(
                b, h, l, l, rate, seed, dev)
            same = torch.equal(got == 0, ref == 0)
            kept = (ref != 0).float().mean().item()
            print(f"  mask{tag} [{str(dtype)[6:]}]: kernel and plain drop the "
                  f"same entries: {same} (kept share {kept:.4f})")
            fail_unless(same, f"dropout mask{tag} [{dtype}] differs from the "
                        "plain version's")
            check_close(f"dropped probabilities{tag}", dtype, got, ref)
        dropout_origin_form(report, dtype, gen, seed, rate, H, D, B, L)
        # times at the training shape: "ms" without, "ms_causal" with the
        # causal mask
        for causal in (False, True):
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen).to(dev, dtype)
                           for _ in range(4))
            out, stats = fad.flash_attention_dropout_fwd(q, k, v, None, seed,
                                                         causal, rate)
            kw = dict(causal=causal, dropout_rate=rate, seed=seed)
            key = "ms_causal" if causal else "ms"
            note_times(report, fwd_name, dtype,
                       lambda: fad.flash_attention_dropout_fwd(
                           q, k, v, None, seed, causal, rate),
                       lambda: fad.flash_attention_dropout_plain(q, k, v, **kw),
                       plain_iters=5, key=key)
            note_times(report, bwd_name, dtype,
                       lambda: fad.flash_attention_dropout_bwd(
                           q, k, v, None, do, seed, stats, out, causal, rate),
                       lambda: fad.flash_attention_dropout_plain_bwd(
                           q, k, v, do, **kw),
                       plain_iters=5, key=key)
            # one (L, S, D) product; the causal form's lower triangle
            pairs = L * (L + 1) // 2 if causal else L * L
            flops = 2 * B * H * pairs * D
            fwd_work = (nbytes(q, k, v, q), 2 * flops)
            bwd_work = (nbytes(q, k, v, do, q, k, v), 5 * flops)
            if dtype == torch.float32:
                for name, work in ((fwd_name, fwd_work), (bwd_name, bwd_work)):
                    report[name][f"form_bound_{key}_f32"] = form_bound(
                        *work, peak=TF32_PEAK)
            elif not causal:
                note_bound(report, fwd_name, *fwd_work)
                note_bound(report, bwd_name, *bwd_work)
            else:
                report[fwd_name]["form_bound_ms_causal"] = \
                    form_bound(*fwd_work)
                report[bwd_name]["form_bound_ms_causal"] = \
                    form_bound(*bwd_work)
            library_dropout_times(report, q, k, v, do, rate, causal)


def origin_shard_forms(B, H, L):
    """(b, heads, L, S, causal, (b0, h0, H)) of row 11's shards: a toy
    (2 of 4 batch rows, H/2 heads at h0 H/2, L 77, causal), then the
    shards the multi-GPU worlds give it at B, L (the video stream) and
    L - 1 (the chord stream): a model rank's H/2 heads (tp, sp), a data
    rank's B/2 rows (dp) and a 2x2 rank's both, each as encoder
    self-attention (L, L), causal decoder self-attention (L-1, L-1) and
    cross-attention (L-1, L)."""
    forms = [(2, H // 2, 77, 77, True, (1, H // 2, H))]
    for b, h, b0, h0 in ((B, H // 2, 0, H // 2), (B // 2, H, B // 2, 0),
                         (B // 2, H // 2, B // 2, H // 2)):
        forms += [(b, h, L, L, False, (b0, h0, H)),
                  (b, h, L - 1, L - 1, True, (b0, h0, H)),
                  (b, h, L - 1, L, False, (b0, h0, H))]
    return forms


def dropout_origin_form(report, dtype, gen, seed, rate, H, D, B, L):
    """Row 11 as a shard of a sharded step runs it, at
    :func:`origin_shard_forms`: the kernels (forward, dK/dV and dQ)
    against the plain version at the shard's origin, and the
    probabilities they drop against the whole (b0 + b, H) grid's mask,
    sliced."""
    import torch
    from video2music_tpu_torch.ops import flash_attention_dropout as fad

    fwd_name, bwd_name = TRAIN_KERNELS
    for b, h, l, sl, causal, origin in origin_shard_forms(B, H, L):
        b0, h0, _ = origin
        q, do = (torch.randn(b, h, l, D, generator=gen).to("cuda", dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, h, sl, D, generator=gen).to("cuda", dtype)
                for _ in range(2))
        tag = (f" origin (b0 {b0}, h0 {h0}, H {H}) B={b} h={h} L={l} S={sl}"
               + (" causal" if causal else ""))
        kw = dict(causal=causal, dropout_rate=rate, seed=seed, origin=origin)
        out, stats = fad.flash_attention_dropout_fwd(q, k, v, None, seed,
                                                     causal, rate, origin)
        note_error(report, fwd_name, dtype, check_close(
            f"{fwd_name}{tag}", dtype, out,
            fad.flash_attention_dropout_plain(q, k, v, **kw)))
        grads = fad.flash_attention_dropout_bwd(q, k, v, None, do, seed,
                                                stats, out, causal, rate,
                                                origin)
        wants = fad.flash_attention_dropout_plain_bwd(q, k, v, do, **kw)
        for gname, g, w in zip(("dq", "dk", "dv"), grads, wants):
            note_error(report, bwd_name, dtype,
                       check_close(f"{bwd_name} {gname}{tag}", dtype, g, w))
        got = fad.extract_dropped_probs(q, k, **kw)
        whole = fad.dropout_mask(b0 + b, H, l, sl, rate, seed, "cuda")
        ref = fad._probs(q, k, None, causal) * whole[b0:, h0:h0 + h]
        same = torch.equal(got == 0, ref == 0)
        print(f"  mask{tag} [{str(dtype)[6:]}]: the kernels drop the whole "
              f"grid's mask, sliced: {same}")
        fail_unless(same, f"dropout mask{tag} [{dtype}] is not the slice of "
                    "the whole grid's mask")
        check_close(f"dropped probabilities{tag}", dtype, got, ref)
        del got, ref, whole


def dropout_forms_phase(report, cfg):
    """Row 11 in the two forms the training zoo gives it, f32 and bf16,
    each against its plain version (output, the mask entry for entry, dq,
    dk, dv / dbias) and timed with its bound and the library's time:
      * "ms_2h", differential attention (V3 training): q and k at 2H = 16
        heads, v repeated from H to 2H per pair, B=16, L=S=300, D=64, not
        causal (the encoder's and the cross-attention's form);
      * "ms_rpr", the RPR decoder self-attention (base AMT,
        MusicTransformer): B=16, H=8, L=300, causal, the full (B, H, L, L)
        f32 bias q_scaled . Er and its dbias.
    The library call is F.scaled_dot_product_attention with the same
    dropout rate (its own mask) and, for RPR, the bias with the causal
    mask folded in as a float attn_mask (its backward then also returns
    the mask's gradient)."""
    import torch
    from torch.nn import functional as F
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.ops.rpr import rpr_bias_full

    dev = "cuda"
    B, H, L, D, rate = 16, cfg.num_heads, cfg.max_seq_chord, cfg.head_dim, \
        cfg.dropout
    gen = torch.Generator().manual_seed(123)
    seed = torch.tensor([20251017], dtype=torch.int32, device=dev)
    fwd_name, bwd_name = TRAIN_KERNELS
    for key, heads, causal in (("ms_2h", 2 * H, False),
                               ("ms_rpr", H, True)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, do = (torch.randn(B, heads, L, D, generator=gen)
                        .to(dev, dtype) for _ in range(3))
            if key == "ms_2h":
                v = torch.randn(B, H, L, D, generator=gen).to(dev, dtype) \
                    .repeat_interleave(2, dim=1)
                bias = None
            else:
                v = torch.randn(B, H, L, D, generator=gen).to(dev, dtype)
                er = (torch.randn(L, D, generator=gen) * D ** -0.5).to(dev)
                bias = rpr_bias_full(q.float() * D ** -0.5, er).contiguous()
            tag = f" {key[3:]} B={B} heads={heads} L={L}" + (
                " causal" if causal else "") + (" +bias" if bias is not None
                                                else "")
            out, stats = fad.flash_attention_dropout_fwd(q, k, v, bias, seed,
                                                         causal, rate)
            kw = dict(bias=bias, causal=causal, dropout_rate=rate, seed=seed)
            err = check_close(f"{fwd_name}{tag}", dtype, out,
                              fad.flash_attention_dropout_plain(q, k, v,
                                                                **kw))
            errs = report[fwd_name].setdefault("err_" + key, {})
            errs[dtype] = max(err, errs.get(dtype, 0.0))
            grads = fad.flash_attention_dropout_bwd(q, k, v, bias, do, seed,
                                                    stats, out, causal, rate)
            wants = fad.flash_attention_dropout_plain_bwd(q, k, v, do, **kw)
            for gname, g, w in zip(("dq", "dk", "dv", "dbias"), grads, wants):
                if w is not None:
                    err = check_close(f"{bwd_name} {gname}{tag}", dtype, g, w)
                    errs = report[bwd_name].setdefault("err_" + key, {})
                    errs[dtype] = max(err, errs.get(dtype, 0.0))
            got = fad.extract_dropped_probs(q, k, **kw)
            ref = fad._probs(q, k, bias, causal) * fad.dropout_mask(
                B, heads, L, L, rate, seed, dev)
            same = torch.equal(got == 0, ref == 0)
            print(f"  mask{tag} [{str(dtype)[6:]}]: kernel and plain drop the "
                  f"same entries: {same}")
            fail_unless(same, f"dropout mask{tag} [{dtype}] differs from the "
                        "plain version's")
            del got, ref
            note_times(report, fwd_name, dtype,
                       lambda: fad.flash_attention_dropout_fwd(
                           q, k, v, bias, seed, causal, rate),
                       lambda: fad.flash_attention_dropout_plain(q, k, v,
                                                                 **kw),
                       plain_iters=3, key=key)
            note_times(report, bwd_name, dtype,
                       lambda: fad.flash_attention_dropout_bwd(
                           q, k, v, bias, do, seed, stats, out, causal, rate),
                       lambda: fad.flash_attention_dropout_plain_bwd(
                           q, k, v, do, **kw),
                       plain_iters=3, key=key)
            # the bound: each input read once, each output written once
            # (the bias read by both, dbias written by the backward); the
            # causal form does about half the products
            tag, peak = yardstick_of(dtype)
            flops = 2 * B * heads * L * L * D * (0.5 if causal else 1.0)
            report[fwd_name]["form_bound_" + key + tag] = form_bound(
                nbytes(q, k, v, q, bias), 2 * flops, peak)
            report[bwd_name]["form_bound_" + key + tag] = form_bound(
                nbytes(q, k, v, do, q, k, v, bias, bias), 5 * flops, peak)
            mask = None
            if bias is not None:
                cm = torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)
                mask = bias.masked_fill(cm, float("-inf")).to(dtype)
            ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
            ml = None if mask is None else mask.clone().requires_grad_()

            def lib_fwd():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      dropout_p=rate)

            def lib_fwd_bwd():
                o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml,
                                                   dropout_p=rate)
                args = (ql, kl, vl) + (() if ml is None else (ml,))
                return torch.autograd.grad(o, args, do)
            t_f = time_ms(lib_fwd)[0]
            try:
                t_fb = time_ms(lib_fwd_bwd)[0]
            except RuntimeError as e:  # no backend differentiates the mask
                print(f"  (the library's backward without the mask's "
                      f"gradient: {str(e).splitlines()[0][:80]})")
                ml = None
                mask_fwd = mask

                def lib_fwd_bwd():
                    o = F.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=mask_fwd, dropout_p=rate)
                    return torch.autograd.grad(o, (ql, kl, vl), do)
                t_fb = time_ms(lib_fwd_bwd)[0]
            report[fwd_name]["library_" + key + tag] = t_f
            report[bwd_name]["library_" + key + tag] = t_fb - t_f
            print(f"  F.scaled_dot_product_attention({key[3:]} form, "
                  f"dropout_p={rate}) [{str(dtype)[6:]}]: forward "
                  f"{t_f:.4f} ms, backward {t_fb - t_f:.4f} ms (graph "
                  f"replay; another mask; "
                  f"{sdpa_backend(q, k, v, mask, dropout_p=rate)})")
            for name in TRAIN_KERNELS:
                b_ms, by = report[name]["form_bound_" + key + tag]
                print(f"  {name} ({key}) [{str(dtype)[6:]}] bound "
                      f"{b_ms:.4f} ms by {by}")


def library_dropout_times(report, q, k, v, do, rate, causal, key=None,
                          backward=True):
    """F.scaled_dot_product_attention with the same dropout rate (its own
    random mask), timed as the kernels are (time_ms: CUDA-graph replay):
    the forward, and (where ``backward``) the backward as (forward +
    backward) less the forward, since autograd runs a backward on its
    forward's stream. Kept as "library_" + key ("ms", or "ms_causal" when
    causal, by default), + "_f32" for float32 inputs (TF32 off)."""
    import torch
    from torch.nn import functional as F

    fwd_name, bwd_name = TRAIN_KERNELS
    key = key or ("ms_causal" if causal else "ms")
    suffix = key[2:] + yardstick_of(q.dtype)[0]
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, dropout_p=rate,
                                              is_causal=causal)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=rate,
                                           is_causal=causal)
        return torch.autograd.grad(o, (ql, kl, vl), do)

    t_f = time_ms(fwd)[0]
    report[fwd_name]["library_ms" + suffix] = t_f
    bwd = ""
    if backward:
        t_fb = time_ms(fwd_bwd)[0]
        report[bwd_name]["library_ms" + suffix] = t_fb - t_f
        bwd = f", backward {t_fb - t_f:.4f} ms"
    print(f"  F.scaled_dot_product_attention(dropout_p={rate}"
          f"{', is_causal=True' if causal else ''}) [{str(q.dtype)[6:]}]: "
          f"forward {t_f:.4f} ms{bwd} (graph replay; another mask; "
          f"{sdpa_backend(q, k, v, dropout_p=rate, is_causal=causal)})")


# ---------------------------------------------------------------------------
# phase 3: the slice, three requests
# ---------------------------------------------------------------------------

REQUESTS = (
    dict(n_sec=30, primer="C Am F G", key="C major", temperature=1.0),
    dict(n_sec=120, primer="", key=None, temperature=1.0),
    dict(n_sec=300, primer="", key=None, temperature=0.8),
)


def synthetic_features(n_sec, seed):
    import numpy as np
    r = np.random.default_rng(seed)
    emo = r.uniform(size=(n_sec, 6)).astype(np.float32)
    return {"semantic": r.standard_normal((n_sec, 768)).astype(np.float32),
            "emotion": emo / emo.sum(-1, keepdims=True),
            "scene_offset": np.repeat(np.arange(n_sec // 10 + 1),
                                      10)[:n_sec].astype(np.float32) + 1.0,
            "motion": r.standard_normal((n_sec, 512)).astype(np.float32)}


def wrappers():
    """The kernel wrappers, by their names in KERNELS. Each counts the
    launches of its kernel in ``.launches``."""
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops import decode_stack as ds
    from video2music_tpu_torch.ops import decode_variant as dv
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.ops.flash_attention import flash_attention
    from video2music_tpu_torch.ops.scan import selective_scan
    from video2music_tpu_torch.tools import kv_traffic_probe as kvp
    from video2music_tpu_torch.tools import probe_dotgeneral as pdg
    return {"flash_attention": flash_attention,
            "decode_layer": dl.decode_layer_step,
            "decode_ends": dl.decode_ends_step,
            "selective_scan": selective_scan,
            "batched_layer_step": db.batched_layer_step,
            "batched_moe_ffn": db.batched_moe_ffn,
            "flash_attention_dropout_fwd": fad.flash_attention_dropout_fwd,
            "flash_attention_dropout_bwd": fad.flash_attention_dropout_bwd,
            "decode_variant_layer": dv.decode_variant_layer_step,
            "batched_variant_layer_step": dbv.batched_variant_layer_step,
            "batched_variant_moe_ffn": dbv.batched_variant_moe_ffn,
            "decode_monolith": ds.decode_monolith_step,
            "decode_segment": ds.decode_segment_step,
            "decode_flat_monolith": ds.decode_flat_monolith_step,
            "kv_traffic_probe": kvp.attend,
            "probe_dotgeneral": pdg.probe_dot}


def path_launches(v2m, width: int, T: int = 300, backend: str = "ends",
                  regression: bool = True, plain_decode: bool = False):
    """Kernel launches one generate call of ``width`` clips implies: the
    B=1 kernels at width 1 (of ``backend``, a key of BACKENDS), the batched
    ones above; the V2 kernels for the V2 family, the variant kernels for
    the others (V3), none with ``plain_decode`` (int8 weights at B>1 decode
    on the plain step); the scan unless ``regression`` is False (a bare
    generate_chords)."""
    from video2music_tpu_torch.ops.decode_layer import fused_decode_eligible
    from video2music_tpu_torch.ops.decode_stack import decoder_segments
    cfg, rcfg = v2m.amt_cfg, v2m.reg_cfg
    L = len(cfg.decoder_layers)
    n_deep = sum(spec.ffn == "moe" for spec in cfg.decoder_layers)
    out = dict.fromkeys(KERNELS, 0)
    out.update(flash_attention=len(cfg.encoder_layers),
               selective_scan=scan_launches(rcfg) if regression else 0)
    v2 = fused_decode_eligible(cfg)
    per_step = {"layer": L, "int8": L, "stack": len(decoder_segments(cfg)),
                "monolith": 1, "whole": 1}
    if plain_decode:
        pass
    elif width == 1 and v2 and backend != "ends":
        out[BACKENDS[backend][3]] = (T - 1) * per_step[backend]
    elif width == 1 and v2:
        out.update(decode_layer=(T - 1) * (L - 2), decode_ends=(T - 1) * 2)
    elif v2:
        out.update(batched_layer_step=(T - 1) * L,
                   batched_moe_ffn=(T - 1) * n_deep)
    elif width == 1:
        out.update(decode_variant_layer=(T - 1) * L)
    else:
        out.update(batched_variant_layer_step=(T - 1) * L,
                   batched_variant_moe_ffn=(T - 1) * n_deep)
    return out


def scan_launches(rcfg):
    """Scan kernel launches of one regression forward: a scan a Mamba layer
    (two in the bidirectional encoders), each in its state chunks (d_state
    16, moemamba's its d_hidden); none for the other backbones."""
    from video2music_tpu_torch.core.config import MambaBackboneConfig
    from video2music_tpu_torch.ops.scan import state_chunks
    rm = rcfg.reg_model
    if "mamba" not in rm:
        return 0
    N = rcfg.d_hidden if rm == "moemamba" else MambaBackboneConfig().d_state
    return rcfg.n_layers * (2 if "bimamba" in rm else 1) * state_chunks(N)


def check_launches(report, v2m, widths, names, record, key="launches",
                   **path):
    """Compare the counters with what generate calls of ``widths`` imply
    (``path``: path_launches' backend / regression); every kernel of
    ``names`` must have launched; record the launches of ``record`` under
    ``key`` (added to what an earlier run recorded)."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in KERNELS:
        want = sum(path_launches(v2m, w, **path)[name] for w in widths)
        print(f"  launches {name}: {counts[name]} (path implies {want})")
        fail_unless(counts[name] == want,
                    f"{name}: {counts[name]} launches, path implies {want}")
    for name in names:
        fail_unless(counts[name] > 0, f"{name}: never launched")
    for name in record:
        report[name][key] = report[name].get(key, 0) + counts[name]


def check_ids(tag, ids, primer, n):
    """The repo's own checks of one clip's chord ids: n ids in [1, 157),
    the primer kept, no three equal tokens in a row after it."""
    import numpy as np
    from video2music_tpu_torch.pipeline.primer import parse_primer
    ids = np.asarray(ids)
    fail_unless(ids.shape == (n,), f"{tag}: {ids.shape} ids")
    fail_unless(((ids >= 1) & (ids < CHORD_END)).all(),
                f"{tag}: chord ids outside [1, 157)")
    primer_ids = parse_primer(primer)[0] if primer else np.zeros(0, np.int64)
    P = len(primer_ids) if primer else 1
    fail_unless((ids[:len(primer_ids)] == primer_ids).all(),
                f"{tag}: primer tokens not kept")
    gen_part = ids[max(P - 2, 0):]
    triples = (gen_part[2:] == gen_part[1:-1]) & \
        (gen_part[1:-1] == gen_part[:-2])
    fail_unless(not triples.any(), f"{tag}: three equal consecutive tokens")


def check_clip(tag, res, primer, n, inst=None, ln_nd=None):
    """The repo's own checks of one rendered clip."""
    import numpy as np
    check_ids(tag, res.chord_ids, primer, n)
    fail_unless(np.isfinite(res.instruments).all(),
                f"{tag}: non-finite instruments")
    fail_unless(os.path.getsize(res.midi_path) > 0, f"{tag}: empty output.mid")
    if ln_nd is not None:
        fail_unless(ln_nd.shape == (300, 2) and inst.shape == (300, 40),
                    f"{tag}: regression shapes {ln_nd.shape} {inst.shape}")
        fail_unless(np.isfinite(ln_nd).all() and np.isfinite(inst).all()
                    and (inst >= 0).all() and (inst <= 1).all(),
                    f"{tag}: ln_nd / instrument out of range")


def slice_phase(v2m, card, report):
    T = 300
    with tempfile.TemporaryDirectory() as tmp:
        v2m.generate(features=synthetic_features(30, 99),  # warm-up
                     output_dir=os.path.join(tmp, "warm_up"))
        for fn in wrappers().values():
            fn.launches = 0
        for i, req in enumerate(REQUESTS):
            out_dir = os.path.join(tmp, f"clip_{i}")
            t0 = time.perf_counter()
            res = v2m.generate(primer=req["primer"], key=req["key"],
                               temperature=req["temperature"],
                               features=synthetic_features(req["n_sec"], i),
                               output_dir=out_dir, seed=i)
            wall = time.perf_counter() - t0
            tm = v2m.last_timings
            check_clip(f"request {i}", res, req["primer"], req["n_sec"],
                       v2m.last_regression["instrument"],
                       v2m.last_regression["ln_nd"])
            print(f"request {i} ({req['n_sec']} s, primer {req['primer']!r}, "
                  f"temperature {req['temperature']}): wall {wall:.3f} s, "
                  f"encode {tm['encode']:.3f} ms, prime {tm['prime']:.3f} ms, "
                  f"decode {tm['decode']:.1f} ms = "
                  f"{tm['decode'] / (T - 1):.4f} ms/token, regression "
                  f"{tm['regression']:.3f} ms, postprocess "
                  f"{tm['postprocess']:.1f} ms [{card}]")
    check_launches(report, v2m, [1] * len(REQUESTS), SLICE_KERNELS,
                   SLICE_KERNELS)


# ---------------------------------------------------------------------------
# phase 4: teacher-forced kernel path against the plain path
# ---------------------------------------------------------------------------

def plain_ends_step(model):
    """decode/fused.make_fused_ends_step through the plain versions."""
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_layer as dl

    layers = dl.pack_decoder_layers(model)
    head = dl.pack_ends(model)
    cfg = model.cfg
    kw = dict(n_heads=cfg.num_heads, k_top=cfg.moe.n_experts_per_token,
              rope=rope_tables(model, layers[0]["wqkv"].device))

    def kv(c, i):
        return c[f"k{i}"], c[f"v{i}"], c[f"ck{i}"], c[f"cv{i}"]

    def run(caches, root, attr, key, pos):
        x = dl.decode_ends_plain(root, attr, key, pos, layers[0], head,
                                 *kv(caches, 0), embed=True, fold_head=False,
                                 **kw)
        for i in range(1, len(layers) - 1):
            x = dl.decode_layer_plain(x, pos, layers[i], *kv(caches, i), **kw)
        return dl.decode_ends_plain(None, None, None, pos, layers[-1], head,
                                    *kv(caches, len(layers) - 1), embed=False,
                                    fold_head=True, x=x, **kw)
    return run


def teacher_forced_phase(v2m):
    """16 positions of seeded random (root, attr) tokens through the kernel
    step and the plain step, each on its own copy of the caches."""
    import torch
    from video2music_tpu_torch.decode.fused import (init_fused_caches,
                                                    make_fused_ends_step)

    gen = torch.Generator().manual_seed(7)
    roots = torch.randint(v2m.model.embedding_root.num_embeddings, (16,),
                          generator=gen)
    attrs = torch.randint(v2m.model.embedding_attr.num_embeddings, (16,),
                          generator=gen)
    feats = synthetic_features(300, 7)
    dev = v2m.device
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        model, _ = v2m._models(name)
        f = {k: torch.as_tensor(a, device=dev).to(dtype)[None]
             for k, a in feats.items()}
        key = torch.tensor([0.0], device=dev)
        with torch.no_grad():
            cross = model.prime(model.encode(**f))
            kernel_caches = init_fused_caches(model, cross)
            plain_caches = {k: v.clone() for k, v in kernel_caches.items()}
            kernel_step = make_fused_ends_step(model)
            plain_step = plain_ends_step(model)
            worst = 0.0
            for pos in range(16):
                root = roots[pos:pos + 1].to(dev, torch.int32)
                attr = attrs[pos:pos + 1].to(dev, torch.int32)
                got = kernel_step(kernel_caches, root, attr, key, pos)
                want = plain_step(plain_caches, root, attr, key, pos)
                worst = max(worst, check_close(
                    f"teacher-forced logits pos {pos}", dtype, got, want,
                    atol=F32_LOGIT_ATOL))
        print(f"teacher-forced {name}: max abs logit error over 16 "
              f"positions {worst:.3e}")


# ---------------------------------------------------------------------------
# phases 4b and 4c: the B=1 backends
# ---------------------------------------------------------------------------

def request_inputs(v2m, feats, primer, dtype):
    """generate_chords' arguments for one request, as generate_batch makes
    them (features padded to 300 s, key and primer resolved)."""
    import torch
    from video2music_tpu_torch.core import constants as C
    from video2music_tpu_torch.pipeline.api import _FEATURES, _prepare
    p = _prepare(feats, None, primer)
    dev = v2m.device
    ids = torch.full((1, 300), C.CHORD_PAD, dtype=torch.int32, device=dev)
    roots = torch.full_like(ids, C.CHORD_ROOT_PAD)
    attrs = torch.full_like(ids, C.CHORD_ATTR_PAD)
    n = len(p["primer_ids"])
    for t, k in ((ids, "primer_ids"), (roots, "primer_roots"),
                 (attrs, "primer_attrs")):
        t[0, :n] = torch.as_tensor(p[k], dtype=torch.int32)
    out = {k: torch.as_tensor(p[k], device=dev)[None].to(dtype)
           for k in _FEATURES}
    out.update(key=torch.tensor([[p["key_feature"]]], device=dev,
                                dtype=dtype),
               primer=ids, primer_root=roots, primer_attr=attrs,
               num_primer=n)
    return out


def backends_phase(v2m, card, report):
    """One 300 s request through generate_chords for each B=1 backend on
    the full-width bf16 2.2 model (ends for comparison), then
    Video2music.generate(quantize="int8"): every clip checked, each
    backend's launches equal to its path's, ms/token, and a torch.profiler
    window over each backend's step."""
    import torch
    from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                      generate_chords)
    T = 300
    model, _ = v2m._models("bfloat16")
    primer = "C Am F G"
    inputs = request_inputs(v2m, synthetic_features(T, 11), primer,
                            torch.bfloat16)
    report["backends"] = {}
    for name, (fused, quantize, split, kernel) in BACKENDS.items():
        kw = dict(fused=fused, quantize=quantize, split=split, **inputs)
        generate_chords(model, gcfg=GenerateConfig(target_seq_length=8),
                        generator=torch.Generator(device=v2m.device)
                        .manual_seed(0), **kw)  # warm-up
        for fn in wrappers().values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = generate_chords(model, generator=torch.Generator(
            device=v2m.device).manual_seed(5), **kw)
        ids = out["gen_seq"][0].cpu().numpy()
        wall = time.perf_counter() - t0
        check_ids(f"backend {name}", ids, primer, T)
        ms = out["timings_ms"]["decode"] / (T - 1)
        report["backends"][name] = ms
        print(f"backend {name} (fused={fused!r}, quantize={quantize!r}, "
              f"split={split}): 300 s request, wall {wall:.3f} s, decode "
              f"{out['timings_ms']['decode']:.1f} ms = {ms:.4f} ms/token "
              f"[{card}]")
        check_launches(report, v2m, [1], (kernel,) if kernel else (),
                       (kernel,) if kernel in STACK_KERNELS else (),
                       backend=name, regression=False)
        if name == "int8":
            report["decode_layer"]["launches_int8"] = \
                wrappers()["decode_layer"].launches
    with tempfile.TemporaryDirectory() as tmp:
        for fn in wrappers().values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = v2m.generate(features=synthetic_features(T, 12),
                           primer=primer, quantize="int8", seed=3,
                           output_dir=os.path.join(tmp, "int8"))
        wall = time.perf_counter() - t0
        check_clip("generate(quantize='int8')", res, primer, T,
                   v2m.last_regression["instrument"],
                   v2m.last_regression["ln_nd"])
        tm = v2m.last_timings
        print(f"Video2music.generate(quantize='int8'): 300 s request, wall "
              f"{wall:.3f} s, decode {tm['decode']:.1f} ms = "
              f"{tm['decode'] / (T - 1):.4f} ms/token [{card}]")
        check_launches(report, v2m, [1], ("decode_layer",), (),
                       backend="int8")
    report["b1_step"] = {
        name: profile_steps(model, 1, card, fused=fused, quantize=quantize,
                            split=split)
        for name, (fused, quantize, split, _) in BACKENDS.items()}


def plain_backend_step(model, backend):
    """The plain counterpart of a B=1 backend's step, on its caches."""
    from video2music_tpu_torch.decode.fused import _embed, rope_tables
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops import decode_stack as ds

    cfg = model.cfg
    kw = dict(n_heads=cfg.num_heads, k_top=cfg.moe.n_experts_per_token,
              rope=rope_tables(model, model.wout.weight.device))
    if backend == "monolith":
        packed = ds.pack_monolith(model)
        return lambda c, r, a, k, pos: ds.decode_monolith_plain(
            r, a, k, pos, packed, c["k"], c["v"], c["ck"], c["cv"], **kw)
    if backend == "whole":
        layers, head = dl.pack_decoder_layers(model), dl.pack_ends(model)
        return lambda c, r, a, k, pos: ds.decode_flat_monolith_plain(
            r, a, k, pos, layers, head,
            [(c[f"k{i}"], c[f"v{i}"], c[f"ck{i}"], c[f"cv{i}"])
             for i in range(len(layers))], **kw)
    if backend == "stack":
        segs = ds.pack_decoder_segments(model)

        def run_stack(c, r, a, k, pos):
            x = _embed(model, None, r, a, k, pos)
            for s, seg in enumerate(segs):
                x = ds.decode_segment_plain(x, pos, seg, c[f"sk{s}"],
                                            c[f"sv{s}"], c[f"sck{s}"],
                                            c[f"scv{s}"], **kw)
            return model.head(x)
        return run_stack
    layers = dl.pack_decoder_layers(
        model, quantize="int8" if backend == "int8" else None)

    def run_layers(c, r, a, k, pos):
        x = _embed(model, None, r, a, k, pos)
        for i, p in enumerate(layers):
            x = dl.decode_layer_plain(x, pos, p, c[f"k{i}"], c[f"v{i}"],
                                      c[f"ck{i}"], c[f"cv{i}"], **kw)
        return model.head(x)
    return run_layers


def teacher_forced_backends_phase(v2m):
    """16 positions of seeded random tokens through each new B=1 backend's
    kernel step and its plain counterpart, float32 and bfloat16 (see
    teacher_force_backends)."""
    teacher_force_backends(
        {name: v2m._models(name)[0] for name in ("float32", "bfloat16")},
        ("layer", "stack", "monolith", "whole", "int8"))


def deep_model_phase(card):
    """A full-width AMT 2.2 with 20 decoder layers (3 SwiGLU + 17 MoE;
    random weights from seed 0; encoder as deep), B=1: 16 teacher-forced
    steps of "monolith", "stack" and split=False against their plain
    steps, float32 and bfloat16. The cooperative kernel takes at most 16
    layers a launch, so a step launches it once per run: 2 for "monolith"
    and split=False (16 + 4 layers), 3 for "stack" (3; 16 + 1)."""
    import copy

    import torch
    from video2music_tpu_torch.core.config import amt_config
    from video2music_tpu_torch.models import VideoMusicTransformer
    from video2music_tpu_torch.weights import init_weights_

    t0 = time.perf_counter()
    cfg = amt_config("2.2", n_layers=20, total_vf_dim=768 + 1 + 512 + 6)
    model = init_weights_(VideoMusicTransformer(cfg),
                          torch.Generator().manual_seed(0)).to("cuda").eval()
    models = {"float32": model,
              "bfloat16": copy.deepcopy(model).to(torch.bfloat16)}
    print(f"built a full-width AMT 2.2 with {len(cfg.decoder_layers)} "
          f"decoder layers in {time.perf_counter() - t0:.1f} s [{card}]")
    teacher_force_backends(models, ("monolith", "stack", "whole"),
                           runs={"monolith": 2, "stack": 3, "whole": 2},
                           reset=True)


def teacher_force_backends(models, backends, runs=None, reset=False):
    """16 positions of seeded random tokens through each B=1 backend of
    ``backends`` (keys of BACKENDS) on ``models`` (dtype name -> model): its
    kernel step against its plain counterpart. In bf16 at most one
    position in BF16_ROUTE_SHARE may leave BF16_REL (a router near-tie
    flipped by a one-ulp input difference); after such a position the plain
    caches take the kernel's, so the flip is counted once (``reset``: before
    every bf16 step, as the batched phases do). The expert ids each MoE
    router chose (route_log) are compared with the plain step's, and the
    (position, MoE layer) pairs that differ are printed, so a near-tie
    that a kernel's other summation order flips shows by name. ``runs``:
    the launches of its kernel each backend's step must make."""
    import torch
    from video2music_tpu_torch.decode.sampler import fused_backend

    gen = torch.Generator().manual_seed(8)
    roots = torch.randint(13, (16,), generator=gen)
    attrs = torch.randint(14, (16,), generator=gen)
    feats = synthetic_features(300, 8)
    for name, model in models.items():
        dtype = getattr(torch, name)
        dev = model.wout.weight.device
        f = {k: torch.as_tensor(a, device=dev).to(dtype)[None]
             for k, a in feats.items()}
        key = torch.tensor([1.0], device=dev)
        with torch.no_grad():
            cross = model.prime(model.encode(**f))
            for backend in backends:
                fused, quantize, split, kernel = BACKENDS[backend]
                init_caches, make_step = fused_backend(model.cfg, 1, fused,
                                                       quantize, split)
                kernel_caches = init_caches(model, cross)
                plain_caches = {k: v.clone()
                                for k, v in kernel_caches.items()}
                kernel_step = make_step(model)
                plain_step = plain_backend_step(model, backend)
                worst, outliers, diffs = 0.0, [], []
                wrappers()[kernel].launches = 0
                for pos in range(16):
                    root = roots[pos:pos + 1].to(dev, torch.int32)
                    attr = attrs[pos:pos + 1].to(dev, torch.int32)
                    if reset and dtype == torch.bfloat16:
                        for k, v in plain_caches.items():
                            v.copy_(kernel_caches[k])
                    got, k_routes = routed_step(kernel_step, kernel_caches,
                                                root, attr, key, pos)
                    want, p_routes = routed_step(plain_step, plain_caches,
                                                 root, attr, key, pos)
                    diffs += [(p, layer) for p, layer, _ in
                              route_diffs(pos, k_routes, p_routes)]
                    abs_err, rel_err = errors(got, want)
                    if dtype == torch.float32:
                        fail_unless(abs_err <= F32_LOGIT_ATOL,
                                    f"teacher-forced {backend} [{name}] pos "
                                    f"{pos}: max abs {abs_err:.3e}")
                    elif rel_err > BF16_REL:
                        outliers.append((pos, round(rel_err, 4)))
                        for k, v in plain_caches.items():
                            v.copy_(kernel_caches[k])
                        continue
                    worst = max(worst, abs_err)
                n = wrappers()[kernel].launches
                print(f"teacher-forced {backend} {name}: max abs logit "
                      f"error over 16 positions {worst:.3e}" + (
                          f"; positions outside rel {BF16_REL}: {outliers}"
                          if outliers else "") + f"; expert ids differing "
                      f"(pos, MoE layer): {diffs}; {n} launches of "
                      f"{kernel}")
                fail_unless(len(outliers) * BF16_ROUTE_SHARE <= 16,
                            f"teacher-forced {backend} [{name}]: "
                            f"{len(outliers)} of 16 positions disagree")
                fail_unless(runs is None or n == 16 * runs[backend],
                            f"{kernel}: {n} launches in 16 steps, the path "
                            f"implies {16 * (runs or {}).get(backend, 0)}")


# ---------------------------------------------------------------------------
# phase 5: batched serving
# ---------------------------------------------------------------------------

SERVE_PRIMERS = ("C Am F G", "", "G", "Dm G C", "")


def serving_requests(n, seed0):
    """n requests with mixed primers, keys, clip lengths and temperatures."""
    reqs, temps = [], []
    for i in range(n):
        primer = SERVE_PRIMERS[i % len(SERVE_PRIMERS)]
        reqs.append(dict(features=synthetic_features(30 + (i * 37) % 271,
                                                     seed0 + i),
                         primer=primer,
                         key="C major" if primer else None))
        temps.append(0.8 + 0.1 * (i % 5))
    return reqs, temps


class WidthLog:
    """A Video2music stand-in for the DynamicBatcher that records the width
    of every generate_batch call it forwards."""

    def __init__(self, v2m):
        self.v2m = v2m
        self.widths = []

    def generate_batch(self, requests, **kwargs):
        self.widths.append(len(requests))
        return self.v2m.generate_batch(requests, **kwargs)

    def extract_features_batch(self, video_paths):
        return self.v2m.extract_features_batch(video_paths)


def check_batch(tag, v2m, reqs, results):
    reg = v2m.last_regression
    for i, (req, res) in enumerate(zip(reqs, results)):
        n = min(req["features"]["semantic"].shape[0], 300)
        check_clip(f"{tag} clip {i}", res, req["primer"], n,
                   reg["instrument"][i], reg["ln_nd"][i])


def serving_phase(v2m, card, report):
    from video2music_tpu_torch.pipeline.serving import DynamicBatcher

    T = 300
    widths = []
    with tempfile.TemporaryDirectory() as tmp:
        reqs, temps = serving_requests(2, 500)  # warm-up
        v2m.generate_batch(reqs, temperature=temps,
                           output_dir=os.path.join(tmp, "warm_up"))
        for fn in wrappers().values():
            fn.launches = 0
        for B in (16, 64):
            reqs, temps = serving_requests(B, 1000 * B)
            t0 = time.perf_counter()
            results = v2m.generate_batch(reqs, temperature=temps, seed=B,
                                         output_dir=os.path.join(tmp, f"b{B}"))
            wall = time.perf_counter() - t0
            widths.append(B)
            fail_unless(len(results) == B, f"B={B}: {len(results)} results")
            check_batch(f"generate_batch B={B}", v2m, reqs, results)
            tm = v2m.last_timings
            print(f"generate_batch B={B}: wall {wall:.3f} s = "
                  f"{B / wall:.2f} clips/s, encode {tm['encode']:.3f} ms, "
                  f"prime {tm['prime']:.3f} ms, decode {tm['decode']:.1f} ms "
                  f"= {tm['decode'] / (T - 1):.4f} ms/step, regression "
                  f"{tm['regression']:.3f} ms, postprocess "
                  f"{tm['postprocess']:.1f} ms [{card}]")
        log = WidthLog(v2m)
        batcher = DynamicBatcher(log, max_batch=16, max_wait_ms=2000,
                                 output_dir=os.path.join(tmp, "serve"))
        try:
            reqs, temps = serving_requests(24, 7000)
            t0 = time.perf_counter()
            futures = [batcher.submit(r, temperature=t)
                       for r, t in zip(reqs, temps)]
            out = [f.result(timeout=600) for f in futures]
            wall = time.perf_counter() - t0
        finally:
            batcher.stop()
        for i, (req, (res, width)) in enumerate(zip(reqs, out)):
            check_clip(f"batcher request {i} (width {width})", res,
                       req["primer"], req["features"]["semantic"].shape[0])
        stats = batcher.stats
        fail_unless(stats["batches"] == len(log.widths)
                    and stats["batched_requests"] == 24,
                    f"batcher stats {stats}, widths run {log.widths}")
        fail_unless(max(log.widths) > 1, f"no batch wider than 1: {log.widths}")
        widths += log.widths
        print(f"DynamicBatcher(max_batch=16): 24 requests in {wall:.3f} s = "
              f"{24 / wall:.2f} clips/s, batches of widths {log.widths} "
              f"(the gather window is 2 s) [{card}]")
    check_launches(report, v2m, widths, SERVING_KERNELS,
                   SERVING_KERNELS[1:3])


def run_batch(tag, v2m, card, reqs, temps, out_dir, **kw):
    """One checked generate_batch call: (clips/s, decode ms/step)."""
    T = 300
    t0 = time.perf_counter()
    results = v2m.generate_batch(reqs, temperature=temps, seed=len(reqs),
                                 output_dir=out_dir, **kw)
    wall = time.perf_counter() - t0
    fail_unless(len(results) == len(reqs), f"{tag}: {len(results)} results")
    check_batch(tag, v2m, reqs, results)
    tm = v2m.last_timings
    ms_step = tm["decode"] / (T - 1)
    print(f"{tag}: wall {wall:.3f} s = {len(reqs) / wall:.2f} clips/s, decode "
          f"{tm['decode']:.1f} ms = {ms_step:.4f} ms/step, postprocess "
          f"{tm['postprocess']:.1f} ms [{card}]")
    return len(reqs) / wall, ms_step


def int8_kv_phase(v2m, card, report):
    """generate_batch(kv_quant="int8") at B=16 on the bf16 2.2 model beside
    the same batch on bf16 caches: every clip checked, the launches of each
    equal to the batched path's (the int8-KV form launches through
    batched_layer_step), clips/s and decode ms/step of both."""
    B = 16
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        reqs, temps = serving_requests(2, 500)  # warm-up of the int8 path
        v2m.generate_batch(reqs, temperature=temps, kv_quant="int8",
                           output_dir=os.path.join(tmp, "warm_up"))
        reqs, temps = serving_requests(B, 9000)
        for kv in ("int8", None):
            for fn in wrappers().values():
                fn.launches = 0
            rates[kv] = run_batch(
                f"generate_batch B={B} kv_quant={kv!r}", v2m, card, reqs,
                temps, os.path.join(tmp, str(kv)), kv_quant=kv)
            check_launches(report, v2m, [B], SERVING_KERNELS, ())
            if kv:
                report["batched_layer_step"]["launches_int8"] = \
                    wrappers()["batched_layer_step"].launches
    report["int8_kv_b16"] = {str(k): dict(clips_s=v[0], ms_step=v[1])
                             for k, v in rates.items()}
    print(f"generate_batch B={B}: int8 KV caches {rates['int8'][0]:.2f} "
          f"clips/s, {rates['int8'][1]:.4f} ms/step; bf16 caches "
          f"{rates[None][0]:.2f} clips/s, {rates[None][1]:.4f} ms/step "
          f"[{card}]")


def v3_int8_phase(v2m, card, report):
    """At 3.1 (bf16 model): generate(quantize="int8") for one 300 s request,
    which runs the int8 variant layer, beside the same request with bf16
    weights; then generate_batch(quantize="int8") at B=16, which decodes on
    the plain step with fake-quantized weights (no decode kernel), beside
    the same batch in bf16. Every clip checked, launches equal to each
    path's; ms/token and clips/s of each."""
    T = 300
    B = 16
    primer = "C Am F G"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        v2m.generate(features=synthetic_features(30, 99), quantize="int8",
                     output_dir=os.path.join(tmp, "warm_up"))  # warm-up
        for q in ("int8", None):
            for fn in wrappers().values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = v2m.generate(features=synthetic_features(T, 13),
                               primer=primer, quantize=q, seed=4,
                               output_dir=os.path.join(tmp, f"b1_{q}"))
            wall = time.perf_counter() - t0
            check_clip(f"V3.1 generate(quantize={q!r})", res, primer, T,
                       v2m.last_regression["instrument"],
                       v2m.last_regression["ln_nd"])
            ms = v2m.last_timings["decode"] / (T - 1)
            out[f"b1_{q}_ms_token"] = ms
            print(f"V3.1 generate(quantize={q!r}): 300 s request, wall "
                  f"{wall:.3f} s, decode {ms:.4f} ms/token [{card}]")
            check_launches(report, v2m, [1], ("decode_variant_layer",), ())
            if q:
                report["decode_variant_layer"]["launches_int8"] = \
                    wrappers()["decode_variant_layer"].launches
        reqs, temps = serving_requests(B, 11000)
        for q in ("int8", None):
            for fn in wrappers().values():
                fn.launches = 0
            out[f"b16_{q}"] = run_batch(
                f"V3.1 generate_batch B={B} quantize={q!r}", v2m, card, reqs,
                temps, os.path.join(tmp, f"b16_{q}"), quantize=q)
            check_launches(report, v2m, [B], ("flash_attention",), (),
                           plain_decode=q is not None)
    report["v3_int8"] = out
    print(f"V3.1 int8 weights: B=1 {out['b1_int8_ms_token']:.4f} ms/token "
          f"(bf16 {out['b1_None_ms_token']:.4f}); B={B} "
          f"{out['b16_int8'][0]:.2f} clips/s (bf16 {out['b16_None'][0]:.2f})"
          f" [{card}]")


# ---------------------------------------------------------------------------
# phase 6: teacher-forced batched kernel step against the plain step
# ---------------------------------------------------------------------------

def routed_step(step, caches, root, attr, key, pos):
    """step's logits, and the expert ids each of its MoE routers chose, in
    layer order ((B, k) each, sorted)."""
    from video2music_tpu_torch.ops import decode_layer as dl
    dl.route_log = []
    try:
        logits = step(caches, root, attr, key, pos)
        routes = [r.long().sort(dim=-1).values for r in dl.route_log]
    finally:
        dl.route_log = None
    return logits, routes


def route_diffs(pos, got, want, routed=True):
    """(pos, MoE layer, clip) of every router choice of the kernel step
    ``got`` that differs from the plain step's ``want``; ``routed``: the
    step has MoE layers (else neither may log a route)."""
    fail_unless(len(got) == len(want) and (len(got) > 0) == routed,
                f"pos {pos}: {len(got)} kernel routes, {len(want)} plain")
    return [(pos, layer, b) for layer, (g, w) in enumerate(zip(got, want))
            for b in (g != w).any(-1).nonzero().flatten().tolist()]


def plain_batch_step(model, kv_quant=None):
    """decode/fused.make_fused_batch_step through the plain versions."""
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_layer as dl

    layers = dl.pack_decoder_layers(model)
    head = dl.pack_ends(model)
    cfg = model.cfg
    kw = dict(n_heads=cfg.num_heads,
              rope=rope_tables(model, layers[0]["wqkv"].device))
    k_top = cfg.moe.n_experts_per_token

    def run(c, root, attr, key, pos):
        x = None
        for i, p in enumerate(layers):
            x = db.batched_layer_step_plain(
                x, pos, p, c[f"k{i}"], c[f"v{i}"], c[f"ck{i}"], c[f"cv{i}"],
                tokens=(root, attr, key) if i == 0 else None,
                embed_pack=head if i == 0 else None,
                kv_scales=None if kv_quant is None else tuple(
                    c[f"{n}{i}"] for n in ("ksc", "vsc", "cksc", "cvsc")),
                **kw)
            if "gate_w" in p:
                x = db.batched_moe_ffn_plain(
                    x, p, k_top=k_top,
                    head_pack=head if i == len(layers) - 1 else None)
        return x
    return run


def teacher_forced_batch_phase(v2m, B=8, kv_quant=None):
    """16 positions of seeded random (root, attr) tokens for B clips
    through the batched kernel step and the batched plain step, comparing
    the expert ids of every router too. float32: each path carries its own
    caches and every logit must agree. bfloat16: the plain caches are reset
    to the kernel's before each step, and a clip-position may leave the
    tolerance only rarely (at most one in BF16_ROUTE_SHARE): a near-tie in
    a router's gate logits, which a one-ulp difference of its bf16 input
    can flip, sends that clip to other experts. ``kv_quant="int8"``: int8
    caches, reset before each step in both dtypes. In float32 the int8
    rows a step writes are at most one quantum apart, rarely (as
    check_int8_rows), and a clip whose row took the other side of a
    rounding tie may leave the float32 tolerance, counted under the
    one-in-BF16_ROUTE_SHARE rule and held to BF16_REL. (In bfloat16 a
    deeper layer's input already differs by a bf16 ulp between the two
    steps, so its rows may differ by more; the kernel phase holds the rows
    on equal inputs.)"""
    import torch
    from video2music_tpu_torch.decode.fused import (init_fused_batch_caches,
                                                    make_fused_batch_step)

    gen = torch.Generator().manual_seed(8)
    roots = torch.randint(v2m.model.embedding_root.num_embeddings, (16, B),
                          generator=gen)
    attrs = torch.randint(v2m.model.embedding_attr.num_embeddings, (16, B),
                          generator=gen)
    feats = [synthetic_features(300, 70 + b) for b in range(B)]
    dev = v2m.device
    tag = "teacher-forced batch" + (" int8 KV" if kv_quant else "")
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        model, _ = v2m._models(name)
        f = {k: torch.stack([torch.as_tensor(x[k]) for x in feats]).to(
            dev, dtype) for k in feats[0]}
        key = (torch.arange(B, device=dev) % 2).float()
        with torch.no_grad():
            cross = model.prime(model.encode(**f))
            kernel_caches = init_fused_batch_caches(model, cross, kv_quant)
            plain_caches = {k: v.clone() for k, v in kernel_caches.items()}
            kernel_step = make_fused_batch_step(model, kv_quant=kv_quant)
            plain_step = plain_batch_step(model, kv_quant)
            worst, outliers, diffs = 0.0, [], []
            quanta = [0, 0]  # int8 row elements one quantum apart, of all
            for pos in range(16):
                root = roots[pos].to(dev, torch.int32)
                attr = attrs[pos].to(dev, torch.int32)
                if dtype == torch.bfloat16 or kv_quant:
                    for k, v in kernel_caches.items():
                        plain_caches[k].copy_(v)
                got, k_routes = routed_step(kernel_step, kernel_caches, root,
                                            attr, key, pos)
                want, p_routes = routed_step(plain_step, plain_caches, root,
                                             attr, key, pos)
                diffs += route_diffs(pos, k_routes, p_routes)
                fail_unless(bool(torch.isfinite(got).all()),
                            f"{tag} pos {pos}: non-finite")
                tied = set()  # clips whose new int8 rows differ (f32)
                check_rows = kv_quant and dtype == torch.float32
                for i in range(len(model.decoder_layers) if check_rows
                               else 0):
                    for c in (f"k{i}", f"v{i}"):
                        d = (kernel_caches[c][:, pos].int()
                             - plain_caches[c][:, pos].int()).abs()
                        fail_unless(d.max().item() <= 1,
                                    f"{tag} pos {pos} {c}: int8 rows "
                                    f"{d.max().item()} quanta apart")
                        tied |= set(d.any(-1).nonzero().flatten().tolist())
                        quanta[0] += int((d > 0).sum())
                        quanta[1] += d.numel()
                for b in range(B):
                    abs_err, rel_err = errors(got[b], want[b])
                    if dtype == torch.float32:
                        ok = torch.allclose(got[b], want[b], rtol=F32_RTOL,
                                            atol=F32_LOGIT_ATOL)
                        fail_unless(ok or (b in tied and rel_err <= BF16_REL),
                                    f"{tag} pos {pos} clip {b} [{name}]: max "
                                    f"abs {abs_err:.3e}, rel {rel_err:.3e}")
                    else:
                        ok = rel_err <= BF16_REL
                    if ok:
                        worst = max(worst, abs_err)
                    else:
                        outliers.append((pos, b, round(rel_err, 4)))
        if kv_quant and dtype == torch.float32:
            share = quanta[0] / max(quanta[1], 1)
            print(f"  {name} int8 rows written: {quanta[0]} of {quanta[1]} "
                  f"elements one quantum apart ({share:.2e}, limit "
                  f"{INT8_QUANTUM_SHARE})")
            fail_unless(share <= INT8_QUANTUM_SHARE,
                        f"{tag} {name}: int8 rows differ")
        print(f"  {name} clip-positions outside the tolerance: "
              f"{len(outliers)} of {16 * B} {outliers}; expert ids differing "
              f"(pos, MoE layer, clip): {diffs}")
        fail_unless(len(outliers) * BF16_ROUTE_SHARE <= 16 * B,
                    f"{tag} {name}: {len(outliers)} of {16 * B} "
                    f"clip-positions disagree")
        print(f"{tag} B={B} {name}: max abs logit error over 16 positions "
              f"{worst:.3e}")


# ---------------------------------------------------------------------------
# phases 7-8 (and the variant part of 2): the V3 serving path
# ---------------------------------------------------------------------------

# every wiring the variant kernels cover, as (name, layers, norm, pre_norm,
# rope): base AMT (RPR + ReLU + LayerNorm), V1.0 (shared-less SiLU-MLP
# experts), V1.1 (shared-less GLU experts), the V3.0 / 3.1 decoder
# (differential + RMSNorm, post-norm) and V3.2 (pre-norm); a layer is
# (meta fields, expert hidden width as a multiple of D or None)
VARIANT_CASES = (
    ("AMT", (("rpr", "vanilla", "relu", "glu", False),), "layernorm", False,
     False),
    ("1.0", (("vanilla", "vanilla", "moe", "mlp", False),), "layernorm",
     False, False),
    ("1.1", (("vanilla", "vanilla", "moe", "glu", False),), "layernorm",
     False, False),
    ("3.1", (("differential", "differential", "swiglu", "glu", True),
             ("differential", "differential", "moe", "glu", True)),
     "rmsnorm", False, True),
    ("3.2", (("differential", "differential", "swiglu", "glu", True),
             ("differential", "differential", "moe", "glu", True)),
     "rmsnorm", True, True),
)


def random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev):
    """A packed variant layer (ops/decode_variant.py layout) at width D:
    2D-wide q/k for differential attention, the RPR table (S, D), the FFN
    of the meta (SiLU-MLP experts 2D wide, GLU experts and FFNs F wide)."""
    import torch

    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def f32(t):
        return t.to(dev, torch.float32).contiguous()

    nq = 2 if meta.attn == "differential" else 1
    nc = 2 if meta.cross == "differential" else 1
    hd = D // H
    p = dict(wqkv=r((2 * nq + 1) * D, D, scale=D ** -0.5),
             bqkv=r((2 * nq + 1) * D, scale=0.1),
             wo=r(D, D, scale=D ** -0.5), bo=r(D, scale=0.1),
             cwq=r(nc * D, D, scale=D ** -0.5), cbq=r(nc * D, scale=0.1),
             cwo=r(D, D, scale=D ** -0.5), cbo=r(D, scale=0.1),
             norm_scale=1 + r(3, D, scale=0.1), norm_bias=r(3, D, scale=0.1))
    for prefix, kind in (("", meta.attn), ("c", meta.cross)):
        if kind == "differential":
            p[prefix + "lam"] = f32(0.5 + 0.1 * torch.randn(1, generator=gen))
            p[prefix + "subw"] = f32(
                0.4 * (1 + 0.1 * torch.randn(D, generator=gen)))
    if meta.attn == "rpr":
        p["er"] = f32((torch.randn(S, hd, generator=gen) * hd ** -0.5)
                      .repeat(1, H))
    if meta.ffn != "moe":
        G = 2 * F if meta.ffn == "swiglu" else F
        p.update(fw1g=r(G, D, scale=D ** -0.5), fb1g=r(G, scale=0.1),
                 fw2=r(D, F, scale=F ** -0.5), fb2=r(D, scale=0.1))
    else:
        Fe = F if meta.expert == "glu" else 2 * D
        G = 2 * Fe if meta.expert == "glu" else Fe
        p.update(gate_w=r(E, D, scale=D ** -0.5), gate_b=r(E, scale=0.1),
                 ew1g=r(E, G, D, scale=D ** -0.5), eb1g=r(E, G, scale=0.1),
                 ew2=r(E, D, Fe, scale=Fe ** -0.5), eb2=r(E, D, scale=0.1))
        if meta.shared:
            p.update(sw1g=r(G, D, scale=D ** -0.5), sb1g=r(G, scale=0.1),
                     sw2=r(D, Fe, scale=Fe ** -0.5), sb2=r(D, scale=0.1))
    return {k: v.contiguous() for k, v in p.items()}


VARIANT_ATTN_KEYS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
                     "norm_scale", "norm_bias", "lam", "subw", "clam",
                     "csubw")
VARIANT_SHARED_KEYS = ("gate_w", "gate_b", "sw1g", "sb1g", "sw2", "sb2")


def variant_attention_work(p, B, pos, Sm, D, el):
    """(bytes, flops) of B clips' self-attention over rows 0..pos and
    cross-attention over Sm rows: K (2D wide for differential) and V read
    once, the new K/V rows written; 2 flops per q.k and per p.v term."""
    Dk, Dc = (p["wqkv"].shape[0] - D) // 2, p["cwq"].shape[0]
    rows_s, rows_c = pos + 1, Sm
    b = B * el * (rows_s * (Dk + D) + rows_c * (Dc + D) + Dk + D)
    f = B * 2 * (rows_s * (Dk + Dk) + rows_c * (Dc + Dc))
    return b, f


def variant_kernel_phase(report, v2m):
    """The three variant kernels against their plain versions at full
    width (d_model 512, 8 heads, d_ff 1024, 6 experts top-2, S = Sm = 300,
    pos 150), float32 and bfloat16, every wiring case of VARIANT_CASES:
    the B=1 layer, the batched layer at B=16 and the batched MoE at B=16
    (plus the 3.1 deep layer timed at B=64); flash attention at the V3
    encoder's 2H = 16 heads. Times and bounds on the 3.1 deep layer."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_variant as dv
    from video2music_tpu_torch.ops.decode_batch import route_plain
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, F, E, H = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.num_heads
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    k_top = cfg.moe.n_experts_per_token
    hd = D // H
    pos = S // 2
    gen = torch.Generator().manual_seed(2468)
    rope = rope_tables(v2m.model, dev)
    for dtype in (torch.float32, torch.bfloat16):
        print(f"variant kernels, {dtype}:")
        el = torch.tensor([], dtype=dtype).element_size()
        q, k, v = (torch.randn(1, 2 * H, Sm, hd, generator=gen).to(dev, dtype)
                   for _ in range(3))
        err = check_close("flash_attention 2H heads", dtype,
                          flash_attention(q, k, v),
                          flash_attention_plain(q, k, v))
        note_error(report, "flash_attention", dtype, err)
        note_times(report, "flash_attention", dtype,
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention_plain(q, k, v), key="ms_2h")
        work = (nbytes(q, k, v, q), 4 * 2 * H * Sm * Sm * hd)
        lib = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))[0]
        if dtype == torch.bfloat16:
            report["flash_attention"]["library_ms_2h"] = lib
            report["flash_attention"]["form_bound_ms_2h"] = form_bound(
                *work)
        else:
            note_f32_yardsticks(report, "flash_attention", "ms_2h", work,
                                lib, sdpa_backend(q, k, v))
        for name, layer_metas, norm, pre_norm, use_rope in VARIANT_CASES:
            for fields in layer_metas:
                meta = dv.VariantLayerMeta(*fields)
                p = random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev)
                nq = 2 if meta.attn == "differential" else 1
                nc = 2 if meta.cross == "differential" else 1
                kw = dict(n_heads=H, rope=rope if use_rope else None,
                          norm=norm, pre_norm=pre_norm)
                tag = f"{name} {meta.attn}/{meta.ffn}"
                deep = meta.ffn == "moe"
                # B=1: the whole layer
                kc, vc = (torch.randn(S, w * D, generator=gen).to(dev, dtype)
                          for w in (nq, 1))
                kx, vx = (torch.randn(Sm, w * D, generator=gen).to(dev, dtype)
                          for w in (nc, 1))
                x = torch.randn(1, D, generator=gen).to(dev, dtype)
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                args1 = (x, pos, p, meta, k1, v1, kx, vx)
                args2 = (x, pos, p, meta, k2, v2, kx, vx)
                got = dv.decode_variant_layer_step(*args1, k_top=k_top, **kw)
                want = dv.decode_variant_layer_plain(*args2, k_top=k_top,
                                                     **kw)
                err = check_close(f"decode_variant_layer {tag}", dtype, got,
                                  want)
                check_close(f"decode_variant_layer {tag} k row", dtype,
                            k1[pos], k2[pos])
                check_close(f"decode_variant_layer {tag} v row", dtype,
                            v1[pos], v2[pos])
                note_error(report, "decode_variant_layer", dtype, err)
                if name == "3.1" and deep:
                    note_times(report, "decode_variant_layer", dtype,
                               lambda: dv.decode_variant_layer_step(
                                   *args1, k_top=k_top, **kw),
                               lambda: dv.decode_variant_layer_plain(
                                   *args2, k_top=k_top, **kw))
                    if dtype == torch.bfloat16:
                        rows = torch.zeros(E)
                        rows[:k_top] = 1
                        w_b, w_f = layer_work(
                            p, VARIANT_ATTN_KEYS + VARIANT_SHARED_KEYS)
                        e_b, e_f = layer_work(p, EXPERT_KEYS, rows)
                        a_b, a_f = variant_attention_work(p, 1, pos, Sm, D,
                                                          el)
                        note_bound(report, "decode_variant_layer",
                                   w_b + e_b + a_b + 2 * nbytes(x),
                                   w_f + e_f + a_f)
                        report["decode_variant_layer"]["library_ms"] = None
                if deep and name in ("3.1", "3.2"):
                    variant_int8_layer(report, name, dtype, p, meta,
                                       (x, pos, kc, vc, kx, vx),
                                       dict(kw, k_top=k_top))
                # B=16 (and B=64 for the timed layer): the batched pair
                for B in (16, 64) if name == "3.1" and deep else (16,):
                    kc, vc = (torch.randn(B, S, w * D, generator=gen)
                              .to(dev, dtype) for w in (nq, 1))
                    kx, vx = (torch.randn(B, Sm, w * D, generator=gen)
                              .to(dev, dtype) for w in (nc, 1))
                    x = torch.randn(B, D, generator=gen).to(dev, dtype)
                    k1, v1 = kc.clone(), vc.clone()
                    k2, v2 = kc.clone(), vc.clone()
                    args1 = (x, pos, p, meta, k1, v1, kx, vx)
                    args2 = (x, pos, p, meta, k2, v2, kx, vx)
                    got = dbv.batched_variant_layer_step(*args1, **kw)
                    want = dbv.batched_variant_layer_plain(*args2, **kw)
                    bname = f"batched_variant_layer_step {tag} B={B}"
                    err = check_close(bname, dtype, got, want)
                    check_close(bname + " k row", dtype, k1[:, pos],
                                k2[:, pos])
                    check_close(bname + " v row", dtype, v1[:, pos],
                                v2[:, pos])
                    fail_unless(torch.equal(k1[:, :pos], kc[:, :pos]),
                                f"{bname}: cache rows other than pos changed")
                    if B == 16:
                        note_error(report, "batched_variant_layer_step",
                                   dtype, err)
                    key = "ms" if B == 16 else f"ms_b{B}"
                    nkw = dict(norm=norm, pre_norm=pre_norm)
                    if name == "3.1" and deep:
                        note_times(report, "batched_variant_layer_step",
                                   dtype,
                                   lambda: dbv.batched_variant_layer_step(
                                       *args1, **kw),
                                   lambda: dbv.batched_variant_layer_plain(
                                       *args2, **kw), key=key)
                    if name == "3.1" and deep and dtype == torch.bfloat16:
                        w_b, w_f = layer_work(p, VARIANT_ATTN_KEYS)
                        a_b, a_f = variant_attention_work(p, B, pos, Sm, D,
                                                          el)
                        work = (w_b + a_b + 2 * nbytes(x), B * w_f + a_f)
                        if B == 16:
                            note_bound(report, "batched_variant_layer_step",
                                       *work)
                            report["batched_variant_layer_step"][
                                "library_ms"] = None
                        else:
                            report["batched_variant_layer_step"][
                                "form_bound_" + key] = form_bound(*work)
                    if not deep:
                        continue
                    got = dbv.batched_variant_moe_ffn(want, p, meta,
                                                      k_top=k_top, **nkw)
                    ref = dbv.batched_variant_moe_plain(want, p, meta,
                                                        k_top=k_top, **nkw)
                    err = check_close(f"batched_variant_moe_ffn {tag} B={B}",
                                      dtype, got, ref)
                    if B == 16:
                        note_error(report, "batched_variant_moe_ffn", dtype,
                                   err)
                    if name != "3.1":
                        continue
                    note_times(report, "batched_variant_moe_ffn", dtype,
                               lambda: dbv.batched_variant_moe_ffn(
                                   want, p, meta, k_top=k_top, **nkw),
                               lambda: dbv.batched_variant_moe_plain(
                                   want, p, meta, k_top=k_top, **nkw),
                               key=key)
                    if dtype == torch.bfloat16:
                        xn = want
                        if pre_norm:
                            xn = dv._norm(want, p["norm_scale"][2],
                                          p["norm_bias"][2], norm).to(dtype)
                        rows = (route_plain(xn, p["gate_w"], p["gate_b"],
                                            k_top) != 0).sum(0).cpu()
                        s_b, s_f = layer_work(
                            p, VARIANT_SHARED_KEYS + ("norm_scale",
                                                      "norm_bias"))
                        e_b, e_f = layer_work(p, EXPERT_KEYS, rows)
                        work = (s_b + e_b + 2 * nbytes(want), B * s_f + e_f)
                        if B == 16:
                            note_bound(report, "batched_variant_moe_ffn",
                                       *work)
                            report["batched_variant_moe_ffn"][
                                "library_ms"] = None
                        else:
                            report["batched_variant_moe_ffn"][
                                "form_bound_" + key] = form_bound(*work)


def short_kernel_name(name: str) -> str:
    """A profiler kernel name without its namespaces, return type and
    argument list: bgemv_kernel<__nv_bfloat16, 1, __nv_bfloat16>."""
    name = name.replace("void ", "").replace("v2m::batch::", "")
    name = name.replace("v2m::variant::", "").replace("v2m::", "")
    depth, out = 0, []
    for ch in name:  # drop the top-level argument list
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()


def graph_breakdown(fn, iters=20):
    """(rows, span us) of one call of fn: iters calls captured into one
    CUDA graph, the graph replayed once under torch.profiler. Each device
    kernel (and copy or memset) by name with its launches and its
    microseconds per call: the part of its span that no earlier kernel
    covers, since a kernel launched with programmatic dependent launch
    starts (and waits) while the one before it runs; the rows add up to the
    device's busy span. Largest first."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for attempt in range(3):
        # CUPTI now and then hands back a session without device events
        # (once in four full runs on an H100 80GB HBM3): the replay is
        # profiled again, up to three times, and fails after
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break
        print(f"  profiler: no device events in session {attempt + 1}, "
              f"profiling the replay again")
    own, count = collections.defaultdict(float), collections.Counter()
    covered, early = -float("inf"), 0
    for e in events:
        name = short_kernel_name(e.name)
        start, end = e.time_range.start, e.time_range.end
        own[name] += max(0.0, end - max(start, covered))
        count[name] += 1
        early += start < covered  # started before the one before it ended
        covered = max(covered, end)
    rows = [(n, count[n] / iters, own[n] / iters) for n in own]
    rows.sort(key=lambda r: -r[2])
    fail_unless(rows, "the profiler saw no device time in the graph replay")
    return rows, sum(r[2] for r in rows), early / max(1, len(events))


def decode_breakdown_phase(report, v2m, card):
    """Per-launch breakdown of one bf16 call, product widths, pos 150, of
    row 8 (the deep V3.1 layer at B=1), row 6 (the deep batched layer at
    B=16 and B=64), row 2 (the deep 2.2 layer at B=1), row 7 (the batched
    MoE half with the head at B=16 and B=64) and row 10 (the 3.1 MoE half
    at B=16): each kernel of the chain with its launches and microseconds
    per call, from graph_breakdown. One line each."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops import decode_variant as dv

    dev, dtype = v2m.device, torch.bfloat16
    cfg = v2m.amt_cfg
    D, F, E, H = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.num_heads
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    k_top = cfg.moe.n_experts_per_token
    pos = S // 2
    rope = rope_tables(v2m.model, dev)
    gen = torch.Generator().manual_seed(8642)
    _, metas, norm, pre_norm, _ = VARIANT_CASES[3]  # 3.1
    meta = dv.VariantLayerMeta(*metas[1])           # its deep layer
    p = random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev)
    kc = torch.randn(S, 2 * D, generator=gen).to(dev, dtype)
    vc = torch.randn(S, D, generator=gen).to(dev, dtype)
    kx = torch.randn(Sm, 2 * D, generator=gen).to(dev, dtype)
    vx = torch.randn(Sm, D, generator=gen).to(dev, dtype)
    x = torch.randn(1, D, generator=gen).to(dev, dtype)
    calls = {"row 8 decode_variant_layer 3.1 deep B=1": (
        lambda: dv.decode_variant_layer_step(
            x, pos, p, meta, kc, vc, kx, vx, n_heads=H, rope=rope,
            k_top=k_top, norm=norm, pre_norm=pre_norm))}
    deep6 = random_layer(gen, D, F, E, True, dtype, dev)
    for B in (16, 64):
        kcb, vcb, kxb, vxb = (torch.randn(B, n, D, generator=gen)
                              .to(dev, dtype) for n in (S, S, Sm, Sm))
        xb = torch.randn(B, D, generator=gen).to(dev, dtype)
        calls[f"row 6 batched_layer_step deep B={B}"] = (
            lambda kcb=kcb, vcb=vcb, kxb=kxb, vxb=vxb, xb=xb:
            db.batched_layer_step(xb, pos, deep6, kcb, vcb, kxb, vxb,
                                  n_heads=H, rope=rope))
    # row 2: the deep 2.2 layer at B=1 (the chain of the "ends" backend)
    deep1 = random_layer(gen, D, F, E, True, dtype, dev)
    kc1, vc1 = (torch.randn(S, D, generator=gen).to(dev, dtype)
                for _ in range(2))
    kx1, vx1 = (torch.randn(Sm, D, generator=gen).to(dev, dtype)
                for _ in range(2))
    calls["row 2 decode_layer_step deep B=1"] = (
        lambda: dl.decode_layer_step(x, pos, deep1, kc1, vc1, kx1, vx1,
                                     n_heads=H, k_top=k_top, rope=rope))
    deep = random_layer(gen, D, F, E, True, dtype, dev)
    head = random_head(gen, D, dtype, dev)
    for B in (16, 64):  # row 7: the MoE half with the head, as the path
        xb = torch.randn(B, D, generator=gen).to(dev, dtype)
        calls[f"row 7 batched_moe_ffn +head B={B}"] = (
            lambda xb=xb: db.batched_moe_ffn(xb, deep, k_top=k_top,
                                             head_pack=head))
    xv = torch.randn(16, D, generator=gen).to(dev, dtype)
    calls["row 10 batched_variant_moe_ffn 3.1 B=16"] = (
        lambda: dbv.batched_variant_moe_ffn(xv, p, meta, k_top=k_top,
                                            norm=norm, pre_norm=pre_norm))
    out = report.setdefault("breakdown", {})
    for label, fn in calls.items():
        rows, total, early = graph_breakdown(fn)
        out[label] = dict(total_us=total, launches=sum(r[1] for r in rows),
                          overlapped=early,
                          kernels=[[n, c, round(t, 3)] for n, c, t in rows])
        print(f"breakdown {label} bf16 pos {pos} (this run, CUDA-graph "
              f"replay under torch.profiler, per call): {total:.2f} us in "
              f"{out[label]['launches']:.0f} launches, {early:.2f} of them "
              f"started before the previous ended (PDL) "
              f"{json.dumps(out[label]['kernels'])} [{card}]")


def gemv_yardstick_phase(report, card):
    """The batched GEMV alone at the QKV shape (1536 x 512, bf16; the
    tensor-core instance) at B=16 and B=64 beside torch.nn.functional.linear
    on the same tensors, both by CUDA-graph replay: a yardstick of the block,
    not a row's library_ms."""
    import torch
    from video2music_tpu_torch.ops import decode_batch as db

    gen = torch.Generator().manual_seed(975)
    N, K = 1536, 512
    w = (torch.randn(N, K, generator=gen) * K ** -0.5).to("cuda",
                                                         torch.bfloat16)
    bias = (0.1 * torch.randn(N, generator=gen)).to("cuda", torch.bfloat16)
    out = report.setdefault("gemv_qkv", {})
    for B in (16, 64):
        x = torch.randn(B, K, generator=gen).to("cuda", torch.bfloat16)
        check_close(f"batched_gemv {N}x{K} B={B}", torch.bfloat16,
                    db.batched_gemv(x, w, bias),
                    db.batched_gemv_plain(x, w, bias))
        ms = time_ms(lambda: db.batched_gemv(x, w, bias))[0]
        lib = time_ms(lambda: torch.nn.functional.linear(x, w, bias))[0]
        bound = (nbytes(w, bias) + 2 * nbytes(x)) / HBM_BYTES_PER_S * 1e3
        out[f"B={B}"] = dict(ms=ms, linear_ms=lib, bound_ms=bound)
        print(f"gemv yardstick {N}x{K} B={B} bf16: kernel {ms:.4f} ms, "
              f"F.linear {lib:.4f} ms, bytes bound {bound:.4f} ms (this "
              f"run, CUDA-graph replay) [{card}]")


def wide_ffn_phase(report, v2m):
    """Rows 6-10 at d_ff 2048 (product d_model 512, 8 heads, 6 experts
    top-2, pos 150) against their plain versions, float32 and bfloat16: the
    batched pair at B=16 (shallow with the embed, deep), the deep V3.1
    variant layer at B=1 and the batched variant pair at B=16. The kernels
    carry no width limit; the JAX kernels take such a model."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_variant as dv

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, E, H = cfg.d_model, cfg.moe.n_experts, cfg.num_heads
    F = 2048
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    k_top = cfg.moe.n_experts_per_token
    pos = S // 2
    rope = rope_tables(v2m.model, dev)
    gen = torch.Generator().manual_seed(2048)
    _, metas, norm, pre_norm, _ = VARIANT_CASES[3]  # 3.1
    for dtype in (torch.float32, torch.bfloat16):
        print(f"d_ff {F}, {dtype}:")
        B = 16
        head = random_head(gen, D, dtype, dev)
        x = torch.randn(B, D, generator=gen).to(dev, dtype)
        tokens = (torch.randint(15, (B,), generator=gen).to(dev),
                  torch.randint(16, (B,), generator=gen).to(dev),
                  torch.randint(2, (B,), generator=gen).to(dev).float())
        kc, vc, kx, vx = (torch.randn(B, n, D, generator=gen).to(dev, dtype)
                          for n in (S, S, Sm, Sm))
        for tag, deep, x_in, tok in (("shallow+embed", False, None, tokens),
                                     ("deep", True, x, None)):
            p = random_layer(gen, D, F, E, deep, dtype, dev)
            c1, c2 = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
            lkw = dict(n_heads=H, rope=rope, tokens=tok,
                       embed_pack=head if tok else None)
            got = db.batched_layer_step(x_in, pos, p, *c1, kx, vx, **lkw)
            want = db.batched_layer_step_plain(x_in, pos, p, *c2, kx, vx,
                                               **lkw)
            check_close(f"batched_layer_step d_ff {F} {tag}", dtype, got,
                        want)
            check_close(f"batched_layer_step d_ff {F} {tag} k row", dtype,
                        c1[0][:, pos], c2[0][:, pos])
            if deep:
                check_close(f"batched_moe_ffn d_ff {F}", dtype,
                            db.batched_moe_ffn(want, p, k_top=k_top,
                                               head_pack=head),
                            db.batched_moe_ffn_plain(want, p, k_top=k_top,
                                                     head_pack=head))
        for fields in metas:
            meta = dv.VariantLayerMeta(*fields)
            p = random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev)
            kw = dict(n_heads=H, rope=rope, norm=norm, pre_norm=pre_norm)
            tag = f"3.1 {meta.attn}/{meta.ffn} d_ff {F}"
            kc1, vc1, kx1, vx1 = (torch.randn(n, w * D, generator=gen)
                                  .to(dev, dtype)
                                  for n, w in ((S, 2), (S, 1), (Sm, 2),
                                               (Sm, 1)))
            x1 = torch.randn(1, D, generator=gen).to(dev, dtype)
            a1 = (x1, pos, p, meta, kc1.clone(), vc1.clone(), kx1, vx1)
            a2 = (x1, pos, p, meta, kc1.clone(), vc1.clone(), kx1, vx1)
            check_close(f"decode_variant_layer {tag}", dtype,
                        dv.decode_variant_layer_step(*a1, k_top=k_top, **kw),
                        dv.decode_variant_layer_plain(*a2, k_top=k_top,
                                                      **kw))
            kcb, vcb, kxb, vxb = (torch.randn(B, n, w * D, generator=gen)
                                  .to(dev, dtype)
                                  for n, w in ((S, 2), (S, 1), (Sm, 2),
                                               (Sm, 1)))
            b1 = (x, pos, p, meta, kcb.clone(), vcb.clone(), kxb, vxb)
            b2 = (x, pos, p, meta, kcb.clone(), vcb.clone(), kxb, vxb)
            got = dbv.batched_variant_layer_step(*b1, **kw)
            want = dbv.batched_variant_layer_plain(*b2, **kw)
            check_close(f"batched_variant_layer_step {tag} B={B}", dtype,
                        got, want)
            if meta.ffn == "moe":
                mkw = dict(k_top=k_top, norm=norm, pre_norm=pre_norm)
                check_close(f"batched_variant_moe_ffn {tag} B={B}", dtype,
                            dbv.batched_variant_moe_ffn(want, p, meta, **mkw),
                            dbv.batched_variant_moe_plain(want, p, meta,
                                                          **mkw))


# built (16, 32, 128, 256; 64 is the product's) and padded (48, 96)
HEAD_SIZES = (16, 32, 48, 96, 128, 256)


def head_size_phase(report, card):
    """Rows 1 and 11 at head sizes the product does not use (the JAX
    kernels take any): encoder flash attention (plain, +bias, +causal) and
    the dropout attention (output, mask entry for entry, gradients) at
    16, 32, 48, 96 (zero-padded to 64 / 128 in the wrappers), 128 and 256,
    f32 and bf16, against the plain versions; both timed at 128 (d_model
    512 at 4 heads) beside their bounds and the library: flash attention at
    B=1, the dropout pair at B=16, L=S=300."""
    import torch
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    dev, H, L, rate = "cuda", 4, 300, 0.1
    gen = torch.Generator().manual_seed(128)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    fwd_name, bwd_name = TRAIN_KERNELS
    for dtype in (torch.float32, torch.bfloat16):
        print(f"head sizes, {dtype}:")
        for D in HEAD_SIZES:
            q, k, v, do = (torch.randn(2, H, L, D, generator=gen)
                           .to(dev, dtype) for _ in range(4))
            bias = torch.randn(2, H, L, L, generator=gen).to(dev)
            for tag, kw in (("", {}), ("+bias", dict(bias=bias)),
                            ("+causal", dict(causal=True))):
                check_close(f"flash_attention D={D}{tag}", dtype,
                            flash_attention(q, k, v, **kw),
                            flash_attention_plain(q, k, v, **kw))
            for causal in (False, True):
                tag = f" D={D}" + (" causal" if causal else "")
                out, stats = fad.flash_attention_dropout_fwd(
                    q, k, v, None, seed, causal, rate)
                dkw = dict(causal=causal, dropout_rate=rate, seed=seed)
                check_close(f"{fwd_name}{tag}", dtype, out,
                            fad.flash_attention_dropout_plain(q, k, v, **dkw))
                grads = fad.flash_attention_dropout_bwd(
                    q, k, v, None, do, seed, stats, out, causal, rate)
                wants = fad.flash_attention_dropout_plain_bwd(q, k, v, do,
                                                              **dkw)
                for gname, g, w in zip(("dq", "dk", "dv"), grads, wants):
                    check_close(f"{bwd_name} {gname}{tag}", dtype, g, w)
                got = fad.extract_dropped_probs(q, k, causal=causal,
                                                dropout_rate=rate, seed=seed)
                ref = fad._probs(q, k, None, causal) * fad.dropout_mask(
                    2, H, L, L, rate, seed, dev)
                fail_unless(torch.equal(got == 0, ref == 0),
                            f"dropout mask{tag} [{dtype}] differs from the "
                            "plain version's")
        D = 128
        q, k, v = (torch.randn(1, H, L, D, generator=gen).to(dev, dtype)
                   for _ in range(3))
        note_times(report, "flash_attention", dtype,
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention_plain(q, k, v), key="ms_d128")
        work = (nbytes(q, k, v, q), 4 * H * L * L * D)
        lib = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))[0]
        if dtype == torch.bfloat16:
            report["flash_attention"]["form_bound_ms_d128"] = form_bound(
                *work)
            report["flash_attention"]["library_ms_d128"] = lib
        else:
            note_f32_yardsticks(report, "flash_attention", "ms_d128", work,
                                lib, sdpa_backend(q, k, v))
        q, k, v, do = (torch.randn(16, H, L, D, generator=gen).to(dev, dtype)
                       for _ in range(4))
        out, stats = fad.flash_attention_dropout_fwd(q, k, v, None, seed,
                                                     False, rate)
        dkw = dict(dropout_rate=rate, seed=seed)
        note_times(report, fwd_name, dtype,
                   lambda: fad.flash_attention_dropout_fwd(
                       q, k, v, None, seed, False, rate),
                   lambda: fad.flash_attention_dropout_plain(q, k, v, **dkw),
                   plain_iters=5, key="ms_d128")
        note_times(report, bwd_name, dtype,
                   lambda: fad.flash_attention_dropout_bwd(
                       q, k, v, None, do, seed, stats, out, False, rate),
                   lambda: fad.flash_attention_dropout_plain_bwd(
                       q, k, v, do, **dkw),
                   plain_iters=5, key="ms_d128")
        flops = 2 * 16 * H * L * L * D  # one (L, S, D) product
        tag, peak = yardstick_of(dtype)
        report[fwd_name]["form_bound_ms_d128" + tag] = form_bound(
            nbytes(q, k, v, q), 2 * flops, peak)
        report[bwd_name]["form_bound_ms_d128" + tag] = form_bound(
            nbytes(q, k, v, do, q, k, v), 5 * flops, peak)
        library_dropout_times(report, q, k, v, do, rate, False,
                              key="ms_d128")


# ---------------------------------------------------------------------------
# rows 1, 11 and 12 above the narrow instances' limits: head sizes above
# 256 (the head split across blocks), d_state above 1024 (state chunks)
# ---------------------------------------------------------------------------

# 5, 5, 8, 9 and 16 slices of 64 columns: at B=2, H=2, L=300 clusters of
# 5, 5, 8, 8 (one block owning two slices, the others one) and 8 (two each)
WIDE_HEADS = (264, 320, 512, 576, 1024)
# bf16 past the wide forward's one-pass cut: head size 264 (a cluster of 5
# blocks a tile, one pass to 1984 keys) at L = S = 2000, two passes
WIDE_PAST_CUT = (264, 2000)
# f32's own edges (B=1, H=1; head size, L = S, what it runs): past the f32
# forward's one-pass cut (head size 4096: 8 blocks of 8 slices, one pass
# to 640 keys; the backward in four groups of two slices, its own side
# streamed), and q streamed through the forward's ring (4608: 9 slices a
# block, five groups)
WIDE_F32_EDGES = ((4096, 700, "two passes, four groups"),
                  (4608, 130, "q streamed, five groups"))
# the forms timed beside SDPA and the bound; at B=16, H=1, L=300 (row 11's
# form, and the encoder's of "head size 512 path"'s generate_batch) the
# wide clusters are 5, 4 (halved: 4 blocks of two slices) and 8 in both
# dtypes, held there against the plain versions too
WIDE_TIMED = (320, 512, 1024)
WIDE_TIMED_CLUSTERS = {320: 5, 512: 4, 1024: 8}
WIDE_STATES = (1025, 2048)     # two state chunks each


def sdpa_backend(q, k, v, mask=None, dropout_p=0.0, is_causal=False):
    """The backend F.scaled_dot_product_attention picks for these inputs
    (torch._fused_sdp_choice, the dispatcher's own choice), by name."""
    import torch
    from torch.nn.attention import SDPBackend
    names = {int(v): n for n, v in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(
        q, k, v, attn_mask=mask, dropout_p=dropout_p, is_causal=is_causal)),
        "unknown")


def wide_head_phase(report, card):
    """Rows 1 and 11 at head sizes 264, 320, 512, 576 and 1024 (the wide
    instances, csrc/attention_wide.cuh: one thread-block cluster a query
    tile, its blocks splitting the head's 64-column slices; in f32 split
    TF32, the backward a cluster a query or key tile), f32 and bf16, B=2,
    H=2, L=S=300, against the plain versions: flash attention plain,
    +bias, +causal, +bias +causal; the dropout attention (rate 0.1) with
    and without the causal mask and its bias: output, dq / dk / dv (/
    dbias; the backward reads the forward's stats), and the mask entry for
    entry. The same past each dtype's one-pass cut (WIDE_PAST_CUT in bf16,
    WIDE_F32_EDGES in f32, B=1, H=1: two passes; in f32 also q streamed).
    Timed at 320, 512 (train_amt -num_heads 1 at d_model 512) and 1024 in
    both dtypes: row 1 at B=1, H=1, L=300 beside
    F.scaled_dot_product_attention, whose backend is named (its flash
    backend stops at head size 256), row 11's forward and backward at
    B=16, H=1, L=S=300 beside SDPA with the same dropout rate, each with
    its bound; at that B=16 grid (its clusters WIDE_TIMED_CLUSTERS) row 1
    plain and causal, row 11's forward, its backward from the forward's
    stats and the mask against the plain versions too."""
    import torch
    from video2music_tpu_torch import kernels
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    dev, H, L, rate = "cuda", 2, 300, 0.1
    sms = kernels.device_sms(dev)
    gen = torch.Generator().manual_seed(512)
    seed = torch.tensor([11], dtype=torch.int32, device=dev)
    fwd_name, bwd_name = TRAIN_KERNELS
    for dtype in (torch.float32, torch.bfloat16):
        print(f"wide heads, {dtype}:")
        for D in WIDE_HEADS:
            q, k, v, do = (torch.randn(2, H, L, D, generator=gen)
                           .to(dev, dtype) for _ in range(4))
            bias = torch.randn(2, H, L, L, generator=gen).to(dev)
            for tag, kw in (("", {}), ("+bias", dict(bias=bias)),
                            ("+causal", dict(causal=True)),
                            ("+bias+causal", dict(bias=bias, causal=True))):
                note_error(report, "flash_attention", dtype, check_close(
                    f"flash_attention D={D}{tag}", dtype,
                    flash_attention(q, k, v, **kw),
                    flash_attention_plain(q, k, v, **kw)))
            for causal in (False, True):
                for b in (None, bias):
                    tag = f" D={D}" + (" causal" if causal else "") + \
                        (" +bias" if b is not None else "")
                    out, stats = fad.flash_attention_dropout_fwd(
                        q, k, v, b, seed, causal, rate)
                    dkw = dict(bias=b, causal=causal, dropout_rate=rate,
                               seed=seed)
                    note_error(report, fwd_name, dtype, check_close(
                        f"{fwd_name}{tag}", dtype, out,
                        fad.flash_attention_dropout_plain(q, k, v, **dkw)))
                    grads = fad.flash_attention_dropout_bwd(
                        q, k, v, b, do, seed, stats, out, causal, rate)
                    wants = fad.flash_attention_dropout_plain_bwd(q, k, v,
                                                                  do, **dkw)
                    for gname, g, w in zip(("dq", "dk", "dv", "dbias"),
                                           grads, wants):
                        # dbias (dlogits) sums D products of dO and v: its
                        # f32 summation-order error grows with the head
                        # (3e-5 at 512), the logits' allowance
                        atol = F32_LOGIT_ATOL if gname == "dbias" else \
                            F32_ATOL
                        if w is not None:
                            note_error(report, bwd_name, dtype, check_close(
                                f"{bwd_name} {gname}{tag}", dtype, g, w,
                                atol=atol))
                got = fad.extract_dropped_probs(q, k, causal=causal,
                                                dropout_rate=rate, seed=seed)
                ref = fad._probs(q, k, None, causal) * fad.dropout_mask(
                    2, H, L, L, rate, seed, dev)
                fail_unless(torch.equal(got == 0, ref == 0),
                            f"dropout mask D={D} causal={causal} [{dtype}] "
                            "differs from the plain version's")
            plan = kernels.wide_plan(D, L, "wide heads", 2 * H * -(-L // 64),
                                     sms, f32=dtype == torch.float32)
            print(f"  dropout mask D={D} [{str(dtype)[6:]}]: equal entry "
                  f"for entry (causal and not); plan {tuple(plan)}")
        f32 = dtype == torch.float32
        for D, Lc, what in (WIDE_F32_EDGES if f32 else
                            (WIDE_PAST_CUT + ("two passes",),)):
            plan = kernels.wide_plan(D, Lc, "wide heads", -(-Lc // 64), sms,
                                     f32=f32)
            fail_unless((plan.passes == 2) == what.startswith("two"),
                        f"D={D} L=S={Lc}: plan {plan} is not {what}")
            if f32:
                fail_unless(kernels.wide_resident_f32(
                    plan.cluster, plan.slices) != ("streamed" in what),
                    f"D={D}: plan {plan} is not {what}")
            q, k, v, do = (torch.randn(1, 1, Lc, D, generator=gen)
                           .to(dev, dtype) for _ in range(4))
            tag = f" D={D} L=S={Lc} ({what})"
            for ctag, causal in (("", False), (" causal", True)):
                note_error(report, "flash_attention", dtype, check_close(
                    f"flash_attention{tag}{ctag}", dtype,
                    flash_attention(q, k, v, causal=causal),
                    flash_attention_plain(q, k, v, causal=causal)))
                out, stats = fad.flash_attention_dropout_fwd(
                    q, k, v, None, seed, causal, rate)
                dkw = dict(causal=causal, dropout_rate=rate, seed=seed)
                note_error(report, fwd_name, dtype, check_close(
                    f"{fwd_name}{tag}{ctag}", dtype, out,
                    fad.flash_attention_dropout_plain(q, k, v, **dkw)))
                grads = fad.flash_attention_dropout_bwd(
                    q, k, v, None, do, seed, stats, out, causal, rate)
                wants = fad.flash_attention_dropout_plain_bwd(q, k, v, do,
                                                              **dkw)
                for gname, g, w in zip(("dq", "dk", "dv"), grads, wants):
                    note_error(report, bwd_name, dtype, check_close(
                        f"{bwd_name} {gname}{tag}{ctag}", dtype, g, w))
                got = fad.extract_dropped_probs(q, k, causal=causal,
                                                dropout_rate=rate, seed=seed)
                ref = fad._probs(q, k, None, causal) * fad.dropout_mask(
                    1, 1, Lc, Lc, rate, seed, dev)
                fail_unless(torch.equal(got == 0, ref == 0),
                            f"dropout mask{tag}{ctag} differs from the "
                            "plain version's")
            print(f"  dropout mask{tag} [{str(dtype)[6:]}]: equal entry for "
                  f"entry (causal and not); plan {tuple(plan)}")
        for D in WIDE_TIMED:
            key = f"ms_d{D}"
            q, k, v = (torch.randn(1, 1, L, D, generator=gen).to(dev, dtype)
                       for _ in range(3))
            note_times(report, "flash_attention", dtype,
                       lambda: flash_attention(q, k, v),
                       lambda: flash_attention_plain(q, k, v), key=key)
            work = (nbytes(q, k, v, q), 4 * L * L * D)
            lib = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v))[0]
            if dtype == torch.float32:
                note_f32_yardsticks(report, "flash_attention", key, work, lib,
                                    sdpa_backend(q, k, v))
            else:
                r = report["flash_attention"]
                r["form_bound_" + key] = form_bound(*work)
                r["library_" + key] = lib
                backend = sdpa_backend(q, k, v)
                report.setdefault("wide", {})["sdpa_backend_d%d" % D] = \
                    backend
                print(f"  F.scaled_dot_product_attention at head size {D}: "
                      f"backend {backend} (its flash backend stops at head "
                      f"size 256) [{card}]")
            q, k, v, do = (torch.randn(16, 1, L, D, generator=gen)
                           .to(dev, dtype) for _ in range(4))
            out, stats = fad.flash_attention_dropout_fwd(q, k, v, None, seed,
                                                         False, rate)
            dkw = dict(dropout_rate=rate, seed=seed)
            wide_b16_checks(report, D, q, k, v, do, out, stats, seed, rate,
                            sms)
            note_times(report, fwd_name, dtype,
                       lambda: fad.flash_attention_dropout_fwd(
                           q, k, v, None, seed, False, rate),
                       lambda: fad.flash_attention_dropout_plain(q, k, v,
                                                                 **dkw),
                       plain_iters=5, key=key)
            note_times(report, bwd_name, dtype,
                       lambda: fad.flash_attention_dropout_bwd(
                           q, k, v, None, do, seed, stats, out, False, rate),
                       lambda: fad.flash_attention_dropout_plain_bwd(
                           q, k, v, do, **dkw),
                       plain_iters=5, key=key)
            flops = 2 * 16 * L * L * D  # one (L, S, D) product
            tag, peak = yardstick_of(dtype)
            report[fwd_name]["form_bound_" + key + tag] = form_bound(
                nbytes(q, k, v, q), 2 * flops, peak)
            report[bwd_name]["form_bound_" + key + tag] = form_bound(
                nbytes(q, k, v, do, q, k, v), 5 * flops, peak)
            library_dropout_times(report, q, k, v, do, rate, False, key=key)


def wide_b16_checks(report, D, q, k, v, do, out, stats, seed, rate, sms):
    """Row 1 (plain and causal), row 11's forward ``out``, its backward
    from ``stats`` and the mask against the plain versions at row 11's
    B=16, H=1 timing grid, where the wide cluster is
    WIDE_TIMED_CLUSTERS[D] (checked) in either dtype; the phase's
    tolerances."""
    import torch
    from video2music_tpu_torch import kernels
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    B, H, L, _ = q.shape
    dtype, dev = q.dtype, q.device
    fwd_name, bwd_name = TRAIN_KERNELS
    plan = kernels.wide_plan(D, L, "wide heads", B * H * -(-L // 64), sms,
                             f32=dtype == torch.float32)
    fail_unless(plan.cluster == WIDE_TIMED_CLUSTERS[D],
                f"D={D} B={B}: plan {tuple(plan)}, not a cluster of "
                f"{WIDE_TIMED_CLUSTERS[D]}")
    tag = f" D={D} B={B} (cluster {plan.cluster})"
    for ctag, causal in (("", False), (" causal", True)):
        note_error(report, "flash_attention", dtype, check_close(
            f"flash_attention{tag}{ctag}", dtype,
            flash_attention(q, k, v, causal=causal),
            flash_attention_plain(q, k, v, causal=causal)))
    dkw = dict(dropout_rate=rate, seed=seed)
    note_error(report, fwd_name, dtype, check_close(
        f"{fwd_name}{tag}", dtype, out,
        fad.flash_attention_dropout_plain(q, k, v, **dkw)))
    grads = fad.flash_attention_dropout_bwd(q, k, v, None, do, seed, stats,
                                            out, False, rate)
    wants = fad.flash_attention_dropout_plain_bwd(q, k, v, do, **dkw)
    for gname, g, w in zip(("dq", "dk", "dv"), grads, wants):
        note_error(report, bwd_name, dtype, check_close(
            f"{bwd_name} {gname}{tag}", dtype, g, w))
    got = fad.extract_dropped_probs(q, k, dropout_rate=rate, seed=seed)
    ref = fad._probs(q, k, None, False) * fad.dropout_mask(
        B, H, L, L, rate, seed, dev)
    fail_unless(torch.equal(got == 0, ref == 0),
                f"dropout mask{tag} differs from the plain version's")
    print(f"  dropout mask{tag} [{str(dtype)[6:]}]: equal entry for entry; "
          f"plan {tuple(plan)}")


def wide_state_phase(report, card):
    """Row 12 at d_state 1025 and 2048 (two state chunks of at most 1024,
    their partial C . h added in an f32 workspace), b 1 and 16, L 300, ED
    128 (bimamba+'s d_inner), f32 and bf16, against its plain version, two
    launches a call; timed at 2048, b=1 (ms_n2048), with its bound."""
    import torch
    from video2music_tpu_torch.ops.scan import (selective_scan,
                                                selective_scan_plain,
                                                state_chunks)

    dev, L, ED = "cuda", 300, 128
    gen = torch.Generator().manual_seed(2049)
    for dtype in (torch.float32, torch.bfloat16):
        for N in WIDE_STATES:
            for b in (1, 16):
                x = torch.randn(b, L, ED, generator=gen).to(dev, dtype)
                dt = (torch.rand(b, L, ED, generator=gen) * 0.1).to(dev, dtype)
                A = (-0.5 - 4 * torch.rand(ED, N, generator=gen)).to(dev)
                Bm, Cm = (torch.randn(b, L, N, generator=gen).to(dev, dtype)
                          for _ in range(2))
                Dv = torch.randn(ED, generator=gen).to(dev)
                n0 = selective_scan.launches
                got = selective_scan(x, dt, A, Bm, Cm, Dv)
                fail_unless(selective_scan.launches - n0 == state_chunks(N),
                            f"selective_scan N={N}: "
                            f"{selective_scan.launches - n0} launches")
                note_error(report, "selective_scan", dtype, check_close(
                    f"selective_scan b={b} N={N} L={L} ({state_chunks(N)} "
                    f"state chunks)", dtype, got,
                    selective_scan_plain(x, dt, A, Bm, Cm, Dv)))
                if N == 2048 and b == 1:
                    args = (x, dt, A, Bm, Cm, Dv)
                    note_times(report, "selective_scan", dtype,
                               lambda: selective_scan(*args),
                               lambda: selective_scan_plain(*args),
                               plain_iters=3, key="ms_n2048")
                    if dtype == torch.bfloat16:
                        report["selective_scan"]["form_bound_ms_n2048"] = \
                            form_bound(nbytes(x, dt, A, Bm, Cm, Dv, x),
                                       8 * b * L * ED * N, peak=PEAK_F32)


# the decode kernels' head-size forms: (tag, d_model, heads), d_ff 1024,
# 6 experts top-2, S = Sm = 300, pos 150: head size 2 (d_model 1024 at
# 512 heads: the RoPE pair is the head; the cooperative kernel's split
# triples need fewer splits to fit its shared memory), 4 (the product's
# d_model at 128 heads), 12 (d_model 384 at 32), 512 (one head) and 1024
# (d_model 1024 at one head); each runs the attention instances of any
# even head size (csrc/common.cuh narrow_head)
HEAD_FORMS = (("hd2", 1024, 512), ("hd4", 512, 128), ("hd12", 384, 32),
              ("hd512", 512, 1), ("hd1024", 1024, 1))
# the kernels-line keys of those forms: the compute-dtype form, and the
# int8 one (int8 weights for rows 2 and 8, int8 KV caches for row 6)
HEAD_FORM_KEYS = tuple(f"ms_{t}" for t, _, _ in HEAD_FORMS) + tuple(
    f"ms_int8_{t}" for t, _, _ in HEAD_FORMS)


def plain_on_rows(db, caches, pos, plain):
    """``plain(caches)``: the plain int8-KV step on copies of the caches
    before the kernel's step, its quantizer returning the K and V rows and
    scales the kernel wrote at pos. Its attention then reads the rows the
    kernel's did: check_int8_rows holds those to the plain quantizer's
    (equal, or a share one quantum apart, where the two GEMVs' sum orders
    put an f32 value on either side of a rounding boundary), and the
    output check holds the attention and the rest of the step."""
    rows = iter([(caches[0][:, pos].clone(), caches[2][:, pos].clone()),
                 (caches[1][:, pos].clone(), caches[3][:, pos].clone())])
    real = db.quantize_kv_rows
    db.quantize_kv_rows = lambda x: next(rows)
    try:
        return plain([t.clone() for t in caches])
    finally:
        db.quantize_kv_rows = real


def head_form_check(report, row, key, dtype, name, got, want):
    """check_close of one head-size form, its error kept under
    ``err_<key>`` of the row."""
    err = check_close(name, dtype, got, want)
    errs = report[row].setdefault("err_" + key, {})
    errs[dtype] = max(err, errs.get(dtype, 0.0))
    return err


def head_form_times(report, row, key, dtype, kernel_fn, plain_fn, work):
    """The bf16 form's times (note_times under ``key``, the plain version
    over 5 calls) and its bound from ``work`` (bytes, flops); f32 forms
    are checked, not timed."""
    import torch
    if dtype != torch.bfloat16:
        return
    note_times(report, row, dtype, kernel_fn, plain_fn, plain_iters=5,
               key=key)
    report[row]["form_bound_" + key] = form_bound(*work)


def decode_head_sizes_phase(report, card):
    """Rows 2-6, 8 and 9 at the head sizes of HEAD_FORMS, f32 and bf16,
    against their plain versions, pos 150 over 300-row caches: row 2 (the
    deep layer at B=1, and with int8 weights), row 3 (one layer with the
    embed prologue and with the head), rows 3-5 (the cooperative kernel's
    instance of any even head size: a two-layer run with the ends, the
    monolith over (2, S, D) caches, a MoE segment), row 6 (the deep
    batched layer at B=16, and on int8 KV caches: output, int8 rows and
    scales at pos), row 8 (the deep 3.1 layer at B=1, and with int8
    weights; the base AMT's RPR layer) and row 9 (the deep 3.1 and the
    base AMT's batched layer at B=16); each K / V row written at pos
    compared too. The bf16 forms are timed beside their plain versions
    and bounds (keys ms_hd4 ... and ms_int8_hd4 ...)."""
    import torch
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops import decode_stack as ds
    from video2music_tpu_torch.ops import decode_variant as dv
    from video2music_tpu_torch.ops.embeddings import rope_table

    dev, F, E, k_top, S, Sm, pos, B = "cuda", 1024, 6, 2, 300, 300, 150, 16
    gen = torch.Generator().manual_seed(5120)
    root = torch.tensor([3], device=dev, dtype=torch.int32)
    attr = torch.tensor([5], device=dev, dtype=torch.int32)
    key1 = torch.tensor([1.0], device=dev)
    for tag, D, H in HEAD_FORMS:
        hd = D // H
        table = rope_table(S, hd, dev)
        rope = (table[..., 0].contiguous(), table[..., 1].contiguous())
        kw = dict(n_heads=H, k_top=k_top, rope=rope)
        k8 = f"ms_int8_{tag}"
        key = f"ms_{tag}"
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)[6:]
            print(f"decode kernels at head size {hd} (d_model {D}, {H} "
                  f"heads), {dn}:")
            el = torch.tensor([], dtype=dtype).element_size()

            def rnd(*shape):
                return torch.randn(*shape, generator=gen).to(dev, dtype)

            shallow = random_layer(gen, D, F, E, False, dtype, dev)
            deep = random_layer(gen, D, F, E, True, dtype, dev)
            head = random_head(gen, D, dtype, dev)
            kc, vc, kx, vx = rnd(S, D), rnd(S, D), rnd(Sm, D), rnd(Sm, D)
            x = rnd(1, D)
            # row 2: the deep layer, then with int8 weights
            q8 = dict(deep)
            for k in dl.QUANT_KEYS + dl.QUANT_DEEP_KEYS:
                q8[k], q8[k + "_s"] = dl.quantize_weight(q8[k])
            for form, p, rk in (("", deep, key), (" int8", q8, k8)):
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                name = f"decode_layer{form} {tag}"
                head_form_check(report, "decode_layer", rk, dtype, name,
                                dl.decode_layer_step(x, pos, p, k1, v1, kx,
                                                     vx, **kw),
                                dl.decode_layer_plain(x, pos, p, k2, v2, kx,
                                                      vx, **kw))
                check_close(name + " k row", dtype, k1[pos], k2[pos])
                check_close(name + " v row", dtype, v1[pos], v2[pos])
                rows = torch.zeros(E)
                rows[:k_top] = 1
                own = [k for k in p if k not in EXPERT_KEYS + EXPERT_SCALES]
                w_b, w_f = layer_work(p, own)
                e_b, e_f = layer_work(p, [k for k in EXPERT_KEYS
                                          + EXPERT_SCALES if k in p], rows)
                head_form_times(
                    report, "decode_layer", rk, dtype,
                    lambda: dl.decode_layer_step(x, pos, p, k1, v1, kx, vx,
                                                 **kw),
                    lambda: dl.decode_layer_plain(x, pos, p, k2, v2, kx, vx,
                                                  **kw),
                    (w_b + e_b + 2 * (pos + 1) * D * el + nbytes(kx, vx)
                     + 2 * nbytes(x) + 2 * D * el,
                     w_f + e_f + 4 * (pos + 1) * D + 4 * Sm * D))
            # row 3, one layer: the embed prologue, then the head epilogue
            for ends in (dict(embed=True, fold_head=False),
                         dict(embed=False, fold_head=True, x=x)):
                p = shallow if ends["embed"] else deep
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                name = f"decode_ends {'embed' if ends['embed'] else 'head'}"
                head_form_check(report, "decode_ends", key, dtype,
                                f"{name} {tag}",
                                dl.decode_ends_step(root, attr, key1, pos, p,
                                                    head, k1, v1, kx, vx,
                                                    **kw, **ends),
                                dl.decode_ends_plain(root, attr, key1, pos,
                                                     p, head, k2, v2, kx, vx,
                                                     **kw, **ends))
                check_close(f"{name} {tag} k row", dtype, k1[pos], k2[pos])
            h_b, h_f = layer_work(head, ("dn_scale", "dn_bias", "wout",
                                         "bout"))
            w_b, w_f = run_work([deep], pos, Sm, el)
            head_form_times(
                report, "decode_ends", key, dtype,
                lambda: dl.decode_ends_step(root, attr, key1, pos, deep,
                                            head, k1, v1, kx, vx, **kw,
                                            **ends),
                lambda: dl.decode_ends_plain(root, attr, key1, pos, deep,
                                             head, k2, v2, kx, vx, **kw,
                                             **ends),
                (w_b + h_b + nbytes(x) + 159 * el, w_f + h_f))
            # rows 3-5: the cooperative kernel, shallow + deep
            layers = [shallow, deep]
            packed = dict(head, layers=layers)
            sk, sv = rnd(2, S, D), rnd(2, S, D)
            skx, svx = rnd(2, Sm, D), rnd(2, Sm, D)

            def flat(k, v):
                return [(k[i], v[i], skx[i], svx[i]) for i in range(2)]

            e_b, e_f = layer_work(head, ("lc_w", "lc_krow", "lc_b",
                                         "dn_scale", "dn_bias", "wout",
                                         "bout"))
            r_b, r_f = run_work(layers, pos, Sm, el)
            ends_work = (r_b + e_b + 2 * D * el + 159 * el, r_f + e_f)
            k1, v1, k2, v2 = sk.clone(), sv.clone(), sk.clone(), sv.clone()
            head_form_check(
                report, "decode_flat_monolith", key, dtype,
                f"decode_flat_monolith two layers {tag}",
                ds.decode_flat_monolith_step(root, attr, key1, pos, layers,
                                             packed, flat(k1, v1), **kw),
                ds.decode_flat_monolith_plain(root, attr, key1, pos, layers,
                                              packed, flat(k2, v2), **kw))
            check_close(f"decode_flat_monolith {tag} caches", dtype, k1, k2)
            plans = {}
            caches = flat(k1, v1)
            head_form_times(
                report, "decode_flat_monolith", key, dtype,
                lambda: ds.decode_flat_monolith_step(
                    root, attr, key1, pos, layers, packed, caches,
                    plans=plans, **kw),
                lambda: ds.decode_flat_monolith_plain(
                    root, attr, key1, pos, layers, packed, flat(k2, v2),
                    **kw), ends_work)
            k1, v1, k2, v2 = sk.clone(), sv.clone(), sk.clone(), sv.clone()
            head_form_check(
                report, "decode_monolith", key, dtype,
                f"decode_monolith {tag}",
                ds.decode_monolith_step(root, attr, key1, pos, packed, k1,
                                        v1, skx, svx, **kw),
                ds.decode_monolith_plain(root, attr, key1, pos, packed, k2,
                                         v2, skx, svx, **kw))
            check_close(f"decode_monolith {tag} caches", dtype, v1, v2)
            plans_m = {}
            head_form_times(
                report, "decode_monolith", key, dtype,
                lambda: ds.decode_monolith_step(
                    root, attr, key1, pos, packed, k1, v1, skx, svx,
                    plans=plans_m, **kw),
                lambda: ds.decode_monolith_plain(
                    root, attr, key1, pos, packed, k2, v2, skx, svx, **kw),
                ends_work)
            seg = dict(kind="moe", start=1, layers=[deep])
            k1, v1, k2, v2 = (t[1:].clone() for t in (sk, sv, sk, sv))
            gx, gvx = skx[1:].contiguous(), svx[1:].contiguous()
            head_form_check(
                report, "decode_segment", key, dtype,
                f"decode_segment moe {tag}",
                ds.decode_segment_step(x, pos, seg, k1, v1, gx, gvx, **kw),
                ds.decode_segment_plain(x, pos, seg, k2, v2, gx, gvx, **kw))
            check_close(f"decode_segment {tag} caches", dtype, k1, k2)
            plans_s = {}
            s_b, s_f = run_work([deep], pos, Sm, el)
            head_form_times(
                report, "decode_segment", key, dtype,
                lambda: ds.decode_segment_step(x, pos, seg, k1, v1, gx, gvx,
                                               plans=plans_s, **kw),
                lambda: ds.decode_segment_plain(x, pos, seg, k2, v2, gx,
                                                gvx, **kw),
                (s_b + 2 * nbytes(x), s_f))
            # row 6: the deep batched layer at B=16, then on int8 caches
            bkw = dict(n_heads=H, rope=rope)
            bc = [rnd(B, S, D) for _ in range(2)]
            bx, bvx = rnd(B, Sm, D), rnd(B, Sm, D)
            xb = rnd(B, D)
            k1, v1, k2, v2 = (c.clone() for c in bc + bc)
            name = f"batched_layer_step deep B={B} {tag}"
            head_form_check(report, "batched_layer_step", key, dtype, name,
                            db.batched_layer_step(xb, pos, deep, k1, v1, bx,
                                                  bvx, **bkw),
                            db.batched_layer_step_plain(xb, pos, deep, k2, v2,
                                                        bx, bvx, **bkw))
            check_close(name + " k row", dtype, k1[:, pos], k2[:, pos])
            check_close(name + " v row", dtype, v1[:, pos], v2[:, pos])
            w_b, w_f = layer_work(deep, db._LAYER_KEYS)
            head_form_times(
                report, "batched_layer_step", key, dtype,
                lambda: db.batched_layer_step(xb, pos, deep, k1, v1, bx, bvx,
                                              **bkw),
                lambda: db.batched_layer_step_plain(xb, pos, deep, k2, v2,
                                                    bx, bvx, **bkw),
                (w_b + B * 2 * (pos + 1) * D * el + nbytes(bx, bvx)
                 + 4 * nbytes(xb),
                 B * (w_f + 4 * (pos + 1) * D + 4 * Sm * D)))

            def quantized(rows, filled):
                q, s = db.quantize_kv_rows(
                    torch.randn(B, rows, D, generator=gen).to(dev))
                q[:, filled:] = 0
                s[:, filled:] = 0
                return q, s
            (qk, qks), (qv, qvs) = quantized(S, pos), quantized(S, pos)
            (qx, qxs), (qvx, qvxs) = quantized(Sm, Sm), quantized(Sm, Sm)
            one, two = ([t.clone() for t in (qk, qv, qks, qvs)]
                        for _ in range(2))
            name = f"batched_layer_step int8 KV deep B={B} {tag}"
            got = db.batched_layer_step(
                xb, pos, deep, one[0], one[1], qx, qvx,
                kv_scales=(one[2], one[3], qxs, qvxs), **bkw)
            db.batched_layer_step_plain(
                xb, pos, deep, two[0], two[1], qx, qvx,
                kv_scales=(two[2], two[3], qxs, qvxs), **bkw)
            for i, row in enumerate(("k", "v")):
                check_int8_rows(f"{name} {row} row", one[i][:, pos],
                                two[i][:, pos])
                check_close(f"{name} {row} scale", torch.float32,
                            one[i + 2][:, pos], two[i + 2][:, pos])
            head_form_check(report, "batched_layer_step", k8, dtype, name,
                            got, plain_on_rows(db, one, pos, lambda c: (
                                db.batched_layer_step_plain(
                                    xb, pos, deep, c[0], c[1], qx, qvx,
                                    kv_scales=(c[2], c[3], qxs, qvxs),
                                    **bkw))))
            head_form_times(
                report, "batched_layer_step", k8, dtype,
                lambda: db.batched_layer_step(
                    xb, pos, deep, one[0], one[1], qx, qvx,
                    kv_scales=(one[2], one[3], qxs, qvxs), **bkw),
                lambda: db.batched_layer_step_plain(
                    xb, pos, deep, two[0], two[1], qx, qvx,
                    kv_scales=(two[2], two[3], qxs, qvxs), **bkw),
                (w_b + B * (2 * (pos + 1) * (D + 4) + 2 * Sm * (D + 4))
                 + 2 * nbytes(xb) + 2 * B * (D + 4),
                 B * (w_f + 4 * (pos + 1) * D + 4 * Sm * D)))
            # rows 8 and 9: the deep 3.1 layer (differential pairs, RMSNorm,
            # RoPE), timed, and the base AMT's RPR layer
            for vname, fields, norm, use_rope in (
                    ("3.1", ("differential", "differential", "moe", "glu",
                             True), "rmsnorm", True),
                    ("AMT", ("rpr", "vanilla", "relu", "glu", False),
                     "layernorm", False)):
                meta = dv.VariantLayerMeta(*fields)
                p = random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev)
                nq = 2 if meta.attn == "differential" else 1
                nc = 2 if meta.cross == "differential" else 1
                vkw = dict(n_heads=H, rope=rope if use_rope else None,
                           norm=norm, pre_norm=False)
                timed = vname == "3.1"
                vk, vv = rnd(S, nq * D), rnd(S, D)
                vkx, vvx = rnd(Sm, nc * D), rnd(Sm, D)
                qp = dict(p)
                for k in dv.QUANT_KEYS:
                    if k in qp:
                        qp[k], qp[k + "_s"] = dl.quantize_weight(qp[k])
                forms = (("", p, key), (" int8", qp, k8)) if timed else \
                    (("", p, key),)
                for form, lp, rk in forms:
                    k1, v1, k2, v2 = (vk.clone(), vv.clone(), vk.clone(),
                                      vv.clone())
                    a1 = (x, pos, lp, meta, k1, v1, vkx, vvx)
                    a2 = (x, pos, lp, meta, k2, v2, vkx, vvx)
                    name = f"decode_variant_layer{form} {vname} {tag}"
                    head_form_check(
                        report, "decode_variant_layer", rk, dtype, name,
                        dv.decode_variant_layer_step(*a1, k_top=k_top,
                                                     **vkw),
                        dv.decode_variant_layer_plain(*a2, k_top=k_top,
                                                      **vkw))
                    check_close(name + " k row", dtype, k1[pos], k2[pos])
                    if not timed:
                        continue
                    rows = torch.zeros(E)
                    rows[:k_top] = 1
                    own = [k for k in lp
                           if k not in EXPERT_KEYS + EXPERT_SCALES]
                    w_b, w_f = layer_work(lp, own)
                    e_b, e_f = layer_work(lp, [k for k in EXPERT_KEYS
                                               + EXPERT_SCALES if k in lp],
                                          rows)
                    a_b, a_f = variant_attention_work(lp, 1, pos, Sm, D, el)
                    head_form_times(
                        report, "decode_variant_layer", rk, dtype,
                        lambda: dv.decode_variant_layer_step(
                            *a1, k_top=k_top, **vkw),
                        lambda: dv.decode_variant_layer_plain(
                            *a2, k_top=k_top, **vkw),
                        (w_b + e_b + a_b + 2 * nbytes(x), w_f + e_f + a_f))
                bk, bv = rnd(B, S, nq * D), rnd(B, S, D)
                bkx, bvx2 = rnd(B, Sm, nc * D), rnd(B, Sm, D)
                k1, v1, k2, v2 = bk.clone(), bv.clone(), bk.clone(), bv.clone()
                a1 = (xb, pos, p, meta, k1, v1, bkx, bvx2)
                a2 = (xb, pos, p, meta, k2, v2, bkx, bvx2)
                name = f"batched_variant_layer_step {vname} B={B} {tag}"
                head_form_check(report, "batched_variant_layer_step", key,
                                dtype, name,
                                dbv.batched_variant_layer_step(*a1, **vkw),
                                dbv.batched_variant_layer_plain(*a2, **vkw))
                check_close(name + " k row", dtype, k1[:, pos], k2[:, pos])
                check_close(name + " v row", dtype, v1[:, pos], v2[:, pos])
                if timed:
                    w_b, w_f = layer_work(p, VARIANT_ATTN_KEYS)
                    a_b, a_f = variant_attention_work(p, B, pos, Sm, D, el)
                    head_form_times(
                        report, "batched_variant_layer_step", key, dtype,
                        lambda: dbv.batched_variant_layer_step(*a1, **vkw),
                        lambda: dbv.batched_variant_layer_plain(*a2, **vkw),
                        (w_b + a_b + 2 * nbytes(xb), B * w_f + a_f))
    print(f"  decode head-size forms checked [{card}]")


def wide_head_path_phase(card, report):
    """Head size 512 and d_state 2048 through the entry points, at full
    width (AMT 2.2: d_model 512, d_ff 1024, 6+6 layers, 3 SharedMoE of 6
    experts top-2): the train_amt CLI at -num_heads 1 (f32, one epoch at
    B=16 on a synthetic tree of 32 clips: row 11's forward and backward at
    hd 512 every step, row 1 in its eval passes), then its checkpoint
    served in bf16 by Video2music(num_heads=1) with the moemamba
    regression at d_hidden 2048 (its d_state is its d_hidden; the Mamba
    family's one configurable d_state: bimamba+ keeps 16): one 300 s
    request and a generate_batch at B=16, every clip checked. Row 1
    encodes at hd 512; the decode kernels decode (their attention
    instances of any even head size), with no warning under
    fused="auto"; each scan of the regression launches in two state
    chunks. Launches as the path implies. Then every B=1 backend and
    generate_batch at B=16 with and without int8 KV caches
    (head_size_paths)."""
    import torch
    from video2music_tpu_torch.cli import train_amt as train_amt_cli
    from video2music_tpu_torch.pipeline.api import Video2music

    clips, T = 32, 300
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vevo")
        write_feature_tree(root, clips, T, seed=17)
        out = os.path.join(tmp, "amt")
        steps = -(-clips // 16)
        eval_batches = steps + -(-(clips // 2) // 16)
        n_attn = 3 * 6
        zero_launches()
        t0 = time.perf_counter()
        state = train_amt_cli.main([
            "-dataset_dir", root, "-output_dir", out, "-music_gen_version",
            "2.2", "-motion_type", "1", "-epochs", "1", "-batch_size", "16",
            "-num_heads", "1", "-device", "cuda"])
        torch.cuda.synchronize()
        train_s = wall = time.perf_counter() - t0
        fail_unless(state.model.cfg.head_dim == 512 and state.step == steps,
                    f"train_amt -num_heads 1: head size "
                    f"{state.model.cfg.head_dim}, {state.step} steps")
        check_path_launches("train_amt CLI -num_heads 1", dict(
            flash_attention=n_attn * eval_batches,
            flash_attention_dropout_fwd=n_attn * steps,
            flash_attention_dropout_bwd=n_attn * steps))
        add_wide_launches(report)
        ckpt = os.path.join(out, "weights", "best_loss_weights")
        fail_unless(os.path.isfile(ckpt), "no weights/best_loss_weights")
        print(f"train_amt CLI -num_heads 1 (2.2, head size 512, f32, B=16, "
              f"{steps} steps): {wall:.2f} s with the eval passes [{card}]")
        v2m = Video2music(seed=0, device="cuda", amt_checkpoint=ckpt,
                          amt_overrides=dict(num_heads=1),
                          reg_model="moemamba",
                          reg_overrides=dict(d_hidden=2048))
        zero_launches()
        req = REQUESTS[0]
        with warnings_caught() as caught:
            t0 = time.perf_counter()
            res = v2m.generate(primer=req["primer"], key=req["key"],
                               temperature=req["temperature"],
                               features=synthetic_features(T, 5),
                               output_dir=os.path.join(tmp, "clip"), seed=5)
            wall = time.perf_counter() - t0
            check_clip("head size 512 request", res, req["primer"], T,
                       v2m.last_regression["instrument"],
                       v2m.last_regression["ln_nd"])
            tm = v2m.last_timings
            print(f"head size 512 request (its checkpoint, 300 s): wall "
                  f"{wall:.3f} s, encode {tm['encode']:.3f} ms, decode "
                  f"{tm['decode'] / (T - 1):.4f} ms/token (\"ends\"), "
                  f"regression (moemamba, d_state 2048) "
                  f"{tm['regression']:.3f} ms "
                  f"[{card}]")
            B = 16
            reqs, temps = serving_requests(B, 5120)
            rate, ms_step = run_batch("head size 512 generate_batch B=16",
                                      v2m, card, reqs, temps,
                                      os.path.join(tmp, "b16"))
        fail_unless(not caught, f"head size 512 under fused='auto' warned: "
                    f"{[str(w.message)[:80] for w in caught]}")
        check_launches(report, v2m, [1, B], SLICE_KERNELS + SERVING_KERNELS,
                       ())
        add_wide_launches(report)
        add_wide_launches(report, "launches_hd512")
        report.setdefault("wide", {}).update(
            hd512_train_s=train_s, hd512_ms_token=tm["decode"] / (T - 1),
            hd512_clips_s_b16=rate, hd512_ms_step_b16=ms_step)
        head_size_paths(v2m, card, report, "hd512")
        del v2m
        torch.cuda.empty_cache()


def head_size_paths(v2m, card, report, tag, T=300):
    """The decode paths of a Video2music at a head size the narrow
    attention instances do not take: one 300 s request through
    generate_chords on every B=1 backend (BACKENDS: "ends", "layer",
    "stack", "monolith", split=False and int8 weights), then
    generate_batch at B=16 on bf16 and on int8 KV caches; every clip
    checked, no warning under any of them, each call's launches as its
    path implies (the decode kernels every step, no plain step), added to
    ``launches_<tag>``; ms/token and clips/s into report["wide"]."""
    import torch
    from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                      generate_chords)
    model, _ = v2m._models("bfloat16")
    primer = "C Am F G"
    inputs = request_inputs(v2m, synthetic_features(T, 13), primer,
                            torch.bfloat16)
    wide = report.setdefault("wide", {})
    with warnings_caught() as caught:
        for name, (fused, quantize, split, kernel) in BACKENDS.items():
            kw = dict(fused=fused, quantize=quantize, split=split, **inputs)
            generate_chords(model, gcfg=GenerateConfig(target_seq_length=4),
                            generator=torch.Generator(device=v2m.device)
                            .manual_seed(0), **kw)  # warm-up
            zero_launches()
            out = generate_chords(model, generator=torch.Generator(
                device=v2m.device).manual_seed(7), **kw)
            check_ids(f"{tag} backend {name}", out["gen_seq"][0].cpu()
                      .numpy(), primer, T)
            ms = out["timings_ms"]["decode"] / (T - 1)
            wide[f"{tag}_{name}_ms_token"] = ms
            print(f"{tag} backend {name} (fused={fused!r}, quantize="
                  f"{quantize!r}, split={split}): 300 s request, decode "
                  f"{ms:.4f} ms/token [{card}]")
            check_launches(report, v2m, [1],
                           (kernel,) if kernel else ("decode_layer",
                                                     "decode_ends"), (),
                           backend=name, regression=False)
            add_wide_launches(report, "launches_" + tag)
        B = 16
        with tempfile.TemporaryDirectory() as tmp:
            for kv in (None, "int8"):
                reqs, temps = serving_requests(B, 7700)
                zero_launches()
                rate, ms_step = run_batch(
                    f"{tag} generate_batch B={B} kv_quant={kv!r}", v2m, card,
                    reqs, temps, os.path.join(tmp, str(kv)), kv_quant=kv)
                names = SERVING_KERNELS if fused_v2(v2m) else V3_KERNELS
                check_launches(report, v2m, [B], names, ())
                add_wide_launches(report, "launches_" + tag)
                wide[f"{tag}_clips_s_b16_{kv or 'bf16'}"] = rate
                wide[f"{tag}_ms_step_b16_{kv or 'bf16'}"] = ms_step
    fail_unless(not caught, f"{tag} paths warned: "
                f"{[str(w.message)[:80] for w in caught]}")


def fused_v2(v2m) -> bool:
    """True for the V2-family wiring (rows 2-7), False for the variant
    kernels' (rows 8-10)."""
    from video2music_tpu_torch.ops.decode_layer import fused_decode_eligible
    return fused_decode_eligible(v2m.amt_cfg)


def narrow_head_path_phase(card, report):
    """Head size 4 at full width: the product 2.2 (d_model 512, d_ff 1024,
    6+6 layers, 3 SharedMoE of 6 experts top-2, bimamba+) at 128 heads,
    random weights from seed 0, in bf16: one 300 s Video2music.generate
    ("ends") and every path of head_size_paths; then V3.1 at one head
    (head size 512: two 512-wide query / key heads beside one 512-wide
    value head, rows 8 and 9): one 300 s request and generate_batch at
    B=16, every clip checked, no warning, launches as the path implies
    (launches_hd512)."""
    import torch
    from video2music_tpu_torch.pipeline.api import Video2music

    T = 300
    for tag, kw in (("hd4", dict(amt_overrides=dict(num_heads=128))),
                    ("hd512", dict(music_gen_version="3.1",
                                   amt_overrides=dict(num_heads=1)))):
        v2m = Video2music(seed=0, device="cuda", **kw)
        hd = v2m.amt_cfg.head_dim
        fail_unless(hd == int(tag[2:]), f"{tag}: head size {hd}")
        label = f"{v2m.amt_cfg.version} at head size {hd}"
        req = REQUESTS[0]
        with tempfile.TemporaryDirectory() as tmp, \
                warnings_caught() as caught:
            zero_launches()
            res = v2m.generate(primer=req["primer"], key=req["key"],
                               temperature=req["temperature"],
                               features=synthetic_features(T, 6),
                               output_dir=os.path.join(tmp, "clip"), seed=6)
            check_clip(f"{label} request", res, req["primer"], T,
                       v2m.last_regression["instrument"],
                       v2m.last_regression["ln_nd"])
            tm = v2m.last_timings
            print(f"{label} request (300 s): encode {tm['encode']:.3f} ms, "
                  f"decode {tm['decode'] / (T - 1):.4f} ms/token [{card}]")
            widths = [1]
            if not fused_v2(v2m):  # V3.1: its B=16 batch here
                B = 16
                reqs, temps = serving_requests(B, 6600)
                rate, ms_step = run_batch(f"{label} generate_batch B={B}",
                                          v2m, card, reqs, temps,
                                          os.path.join(tmp, "b16"))
                widths.append(B)
                report.setdefault("wide", {}).update(
                    v31_hd512_clips_s_b16=rate, v31_hd512_ms_step_b16=ms_step,
                    v31_hd512_ms_token=tm["decode"] / (T - 1))
        fail_unless(not caught, f"{label} warned: "
                    f"{[str(w.message)[:80] for w in caught]}")
        check_launches(report, v2m, widths,
                       SLICE_KERNELS if fused_v2(v2m) else V3_KERNELS, ())
        add_wide_launches(report, "launches_" + tag)
        if fused_v2(v2m):
            report.setdefault("wide", {})[f"{tag}_ms_token"] = \
                tm["decode"] / (T - 1)
            head_size_paths(v2m, card, report, tag)
        del v2m
        torch.cuda.empty_cache()


@contextlib.contextmanager
def warnings_caught():
    """Every warning raised inside, as a list."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield caught


def add_wide_launches(report, key="launches_wide"):
    """Add the counters to each launched kernel's ``key``: launches_wide
    (the head size 512 and head size 8 int8-KV paths), launches_hd512 and
    launches_hd4 (the decode paths at head sizes 512 and 4)."""
    for name, fn in wrappers().items():
        if fn.launches:
            report[name][key] = report[name].get(key, 0) + fn.launches


def int8_kv_hd8_phase(card, report):
    """Head size 8 with int8 KV caches at full width (the product 2.2 at 64
    heads): row 6's int8-KV form at hd 8 against its plain version at
    B=16 and 64 (int8_kv_kernel_phase, forms ms_int8_hd8); then
    generate_batch(kv_quant="int8") at B=16: no warning, the sampler's
    batched caches int8, rows 6 and 7 launched every step as the path
    implies, every clip checked; then 16 teacher-forced steps of the
    kernel step at B=8 on int8 caches against the plain batched int8-KV
    step (teacher_forced_batch_phase)."""
    import torch
    from video2music_tpu_torch.decode import sampler
    from video2music_tpu_torch.pipeline.api import Video2music

    v2m = Video2music(seed=0, device="cuda", amt_overrides=dict(num_heads=64))
    fail_unless(v2m.amt_cfg.head_dim == 8, "64 heads of d_model 512")
    int8_kv_kernel_phase(report, v2m, tag="_hd8")
    seen = []
    real = sampler.init_fused_batch_caches

    def recorded(model, cross, kv_quant=None):
        caches = real(model, cross, kv_quant=kv_quant)
        seen.append((kv_quant, caches["k0"].dtype))
        return caches

    B = 16
    with tempfile.TemporaryDirectory() as tmp:
        reqs, temps = serving_requests(B, 8800)
        zero_launches()
        sampler.init_fused_batch_caches = recorded
        try:
            with warnings_caught() as caught:
                rate, ms_step = run_batch(
                    "head size 8 generate_batch B=16 kv_quant='int8'", v2m,
                    card, reqs, temps, tmp, kv_quant="int8")
        finally:
            sampler.init_fused_batch_caches = real
    fail_unless(not caught, f"head size 8, kv_quant='int8' warned: "
                f"{[str(w.message)[:80] for w in caught]}")
    fail_unless(seen == [("int8", torch.int8)],
                f"head size 8: the batched caches were {seen}")
    check_launches(report, v2m, [B], SERVING_KERNELS, ())
    add_wide_launches(report)
    report.setdefault("wide", {}).update(hd8_int8_clips_s_b16=rate,
                                         hd8_int8_ms_step_b16=ms_step)
    teacher_forced_batch_phase(v2m, 8, "int8")
    del v2m
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# rows 13 and 14: the probes (video2music_tpu_torch/tools/, csrc/probes.cu)
# ---------------------------------------------------------------------------

PROBE_BS = (16, 32, 64)  # row 6's widths and the JAX probe's B=32
# the edge shapes the probes' kernels plan for differently: (B, S, D, H,
# pos, what) for the core (pos 0, one below and at the first cluster split
# of kv_traffic_probe.attend_plan, S - 1, head sizes 8 / 16 / 48 / 128, and
# a cache longer than any ring: S 5000 over a cluster of 8)
PROBE_ATTEND_EDGES = (
    (2, 300, 512, 8, 0, "pos 0"), (2, 300, 512, 8, 30, "pos 30"),
    (2, 300, 512, 8, 31, "pos 31 (cluster split)"),
    (2, 300, 512, 8, 299, "pos 299"), (2, 300, 512, 64, 299, "hd 8"),
    (2, 300, 512, 32, 299, "hd 16"), (2, 300, 512, 4, 299, "hd 128"),
    (3, 17, 96, 2, 16, "hd 48, B 3"), (2, 5000, 512, 4, 4999, "S 5000"))
# (B, S, D, block, what) for the floor: one group, D 8 with groups of
# one, a last column slice of 8 (D 2056), D below the slice width
PROBE_FLOOR_EDGES = ((8, 300, 512, 8, "one group"), (3, 7, 8, 1, "D 8"),
                     (16, 33, 2056, 8, "D 2056"), (4, 300, 40, 2, "D 40"))
# (form, M, N, K, what) for the products: 1 x 1 x 1, K no multiple of 16
# or 64 (staged element by element where the rows are no multiple of 16
# bytes), M and N no multiple of the 64-wide tile
PROBE_DOT_EDGES = (("NT", 1, 1, 1, "1 x 1 x 1"), ("TN", 1, 1, 1, "1 x 1 x 1"),
                   ("NT", 70, 65, 37, "K 37"), ("NT", 130, 100, 104, "K 104"),
                   ("TN", 65, 100, 70, "M 65"),
                   ("TN", 72, 136, 1000, "K 1000"))


# the profiler's count of device kernels and memsets in one eager call of
# each probe mode and form, run in a fresh process: after the earlier
# phases' profiling sessions, CUPTI in this process dropped device events
# (a replayed graph of 5 calls read as 2)
PROBE_LAUNCH_CHECK = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from video2music_tpu_torch.tools import kv_traffic_probe as kvp
from video2music_tpu_torch.tools import probe_dotgeneral as pdg
dev = torch.device("cuda")
x = kvp.inputs(32, 300, 512, dev)
calls = {m: c[0] for m, c in kvp.modes(x, 299, 8).items()}
shapes = dict(rows=2400, D=512, C=64)
for dtype in (torch.float32, torch.bfloat16):
    for name, (ash, bsh, form) in pdg.FORMS.items():
        a, b = (torch.randn(*(shapes[s] for s in sh.split()), device=dev)
                .to(dtype) for sh in (ash, bsh))
        calls[name + " " + str(dtype)[6:]] = (
            lambda a=a, b=b, form=form: pdg.probe_dot(a, b, form))
out = {}
for what, fn in calls.items():
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session without device events: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    out[what] = dict(
        kernels=[n for n in names if "memset" not in n.lower()],
        memsets=[n for n in names if "memset" in n.lower()])
print(json.dumps(out))
"""


def probes_phase(report, card):
    """Rows 13 and 14, on no serving or training path (launches 0 there):
    the kv traffic probe's four modes (tools/kv_traffic_probe.py: the
    bf16 and int8 decode-attention core, the slab-reading floor, the
    no-cache form) at B = 16, 32 and 64 (S 300, D 512, 8 heads, pos 299)
    against their plain versions, timed warm (the same slabs every call,
    B=32 under "ms") and cold (calls rotating over copies that read twice
    the L2), the bf16 core beside F.scaled_dot_product_attention, the
    no-cache form beside one torch.mul, and the floor's read rate set
    beside row 6's time at B=16 and 64 (the share of row 6 its cache
    bytes explain, at the warm and at the cold rate); the dot_general
    probe's three forms (tools/probe_dotgeneral.py) in f32 (TF32) and bf16
    against the f32 product, warm and cold, beside torch.matmul (TF32 off,
    and on for the TF32 forms). Then each kernel at the edge shapes of
    PROBE_*_EDGES, the floor's bits over two calls, the profiler's count
    of device kernels and memsets in one call of each mode and form (one
    kernel, no memset; PROBE_LAUNCH_CHECK, in a fresh process), and both
    tools from their command lines, one JSON line each."""
    import torch
    from video2music_tpu_torch.tools import cold_us
    from video2music_tpu_torch.tools import kv_traffic_probe as kvp
    from video2music_tpu_torch.tools import probe_dotgeneral as pdg

    dev, S, D, H = torch.device("cuda"), 300, 512, 8
    pos = S - 1
    bf = torch.bfloat16
    l2 = kvp.l2_bytes(dev)
    r = report["kv_traffic_probe"]
    out = report.setdefault("probes", {})
    kvp.attend.launches = kvp.floor.launches = kvp.noattn.launches = 0
    for B in PROBE_BS:
        x = kvp.inputs(B, S, D, dev)
        q = x["q"]
        sfx = "" if B == 32 else f"_b{B}"
        row = out[f"kv B={B}"] = {}
        for mode, (kernel, plain) in kvp.modes(x, pos, H).items():
            key = ("ms" if mode == "bf16" else f"ms_{mode}") + sfx
            err = check_close(f"kv_traffic_probe {mode} B={B}", bf, kernel(),
                              plain())
            if key == "ms":
                note_error(report, "kv_traffic_probe", bf, err)
            elif "err_" + key not in r:
                r["err_" + key] = {bf: err}
            note_times(report, "kv_traffic_probe", bf, kernel, plain,
                       plain_iters=5, key=key)
            row[mode] = r[key][bf][0]
            calls = kvp.cold_calls(x, mode, pos, H, l2)
            row["cold_" + mode] = r["cold_" + key] = \
                cold_us(calls) * 1e-3
            del calls
        sb = kvp.slab_bytes(B, S, D)
        rest = 2 * nbytes(q)  # q in, out out
        r["form_bound_ms" + sfx] = form_bound(
            sb["bf16"] + rest, 4 * B * H * (pos + 1) * (D // H))
        r["form_bound_ms_int8" + sfx] = form_bound(
            sb["int8"] + rest, 4 * B * H * (pos + 1) * (D // H))
        r["form_bound_ms_floor" + sfx] = form_bound(sb["bf16"] + rest, 0)
        r["form_bound_ms_noattn" + sfx] = form_bound(rest, 0)
        r["library_ms" + sfx] = row["sdpa"] = time_ms(
            kvp.sdpa_call(x, pos, H))[0]
        r["cold_library_ms" + sfx] = row["cold_sdpa"] = \
            kvp.cold_sdpa_us(x, pos, H, l2) * 1e-3
        # the no-cache form's library call: one torch.mul
        r["library_ms_noattn" + sfx] = row["torch_mul"] = time_ms(
            lambda: q * 1.0001)[0]
        for rate in ("", "cold_"):
            floor_rate = sb["bf16"] / (row[rate + "floor"] * 1e-3)  # B/s
            row[rate + "floor_TB_s"] = floor_rate / 1e12
            if B in (16, 64):  # row 6's deep layer at pos 150
                row6 = report["batched_layer_step"]
                ms6 = row6["ms" if B == 16 else "ms_b64"][bf][0]
                cache = 2 * B * (151 + 300) * D * 2  # self 0..150, cross 300
                row["row6_ms"] = ms6
                row[f"row6_cache_share_at_{rate}floor_rate"] = \
                    cache / floor_rate * 1e3 / ms6
        print(f"kv_traffic_probe B={B} (warm / cold ms): bf16 "
              f"{row['bf16']:.4f} / {row['cold_bf16']:.4f}, int8 "
              f"{row['int8']:.4f} / {row['cold_int8']:.4f}, floor "
              f"{row['floor']:.4f} / {row['cold_floor']:.4f} "
              f"({row['floor_TB_s']:.2f} / {row['cold_floor_TB_s']:.2f} "
              f"TB/s), noattn {row['noattn']:.4f} / {row['cold_noattn']:.4f} "
              f"(torch.mul {row['torch_mul']:.4f}), SDPA {row['sdpa']:.4f} / "
              f"{row['cold_sdpa']:.4f}; bounds bf16 "
              f"{sb['bf16'] / HBM_BYTES_PER_S * 1e3:.5f}, int8 "
              f"{sb['int8'] / HBM_BYTES_PER_S * 1e3:.5f} ms" + (
                  f"; row 6 at B={B} {row['row6_ms']:.4f} ms, its cache "
                  f"bytes at the floor's warm rate "
                  f"{row['row6_cache_share_at_floor_rate']:.1%} of it, at "
                  f"the cold rate "
                  f"{row['row6_cache_share_at_cold_floor_rate']:.1%}"
                  if "row6_ms" in row else "") + f" [{card}]")
        del x
        torch.cuda.empty_cache()
    r["launches_probe"] = (kvp.attend.launches + kvp.floor.launches
                           + kvp.noattn.launches)
    r["launches"] = 0  # on no path
    r["bound_ms"], r["bound_by"] = r.pop("form_bound_ms")

    d = report["probe_dotgeneral"]
    pdg.probe_dot.launches = 0
    rows, C, Dd = 2400, 64, 512
    gen = torch.Generator().manual_seed(35)
    keys = {"NT logits": "ms", "TN pv": "ms_tn", "NT tiny-diag": "ms_diag"}
    shapes = dict(rows=rows, D=Dd, C=C)
    dot_out = out["dot_general"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for name, (ash, bsh, form) in pdg.FORMS.items():
            a, b = (torch.randn(*(shapes[s] for s in sh.split()),
                                generator=gen).to(dev, dtype)
                    for sh in (ash, bsh))
            got, want = pdg.probe_dot(a, b, form), pdg.probe_dot_plain(a, b,
                                                                       form)
            err, rel = errors(got, want)
            tol = pdg.TOL[str(dtype)[6:]]
            print(f"  probe_dotgeneral {name} [{str(dtype)[6:]}, "
                  f"{'TF32' if f32 else 'bf16'} tensor "
                  f"cores] max_abs {err:.3e} rel {rel:.3e} (limit {tol}) "
                  f"{'ok' if rel <= tol else 'FAIL'}")
            fail_unless(rel <= tol, f"probe_dotgeneral {name} [{dtype}] "
                        "disagrees with the f32 product")
            key = keys[name]
            if key == "ms":
                note_error(report, "probe_dotgeneral", dtype, err)
            else:
                d.setdefault("err_" + key, {})[dtype] = err
            note_times(report, "probe_dotgeneral", dtype,
                       lambda: pdg.probe_dot(a, b, form),
                       lambda: pdg.probe_dot_plain(a, b, form), key=key)
            tag = "_f32" if f32 else ""
            K = a.shape[1] if form == "NT" else a.shape[0]
            M, N = got.shape
            d["form_bound_" + key + tag] = form_bound(
                nbytes(a, b, got), 2 * M * N * K,
                peak=TF32_PEAK if f32 else PEAK_BF16)
            lib_key = "library_" + key if key != "ms" else "library_ms"
            d[lib_key + tag] = time_ms(pdg.library_call(a, b, form))[0]
            d["cold_" + key + tag] = pdg.cold_dot_us(a, b, form, l2) * 1e-3
            d["cold_" + lib_key + tag] = pdg.cold_dot_us(
                a, b, form, l2, call=pdg.library_call) * 1e-3
            if f32:  # the TF32 forms' yardstick: torch.matmul in TF32
                torch.backends.cuda.matmul.allow_tf32 = True
                d["library_tf32_" + key] = time_ms(
                    pdg.library_call(a, b, form))[0]
                torch.backends.cuda.matmul.allow_tf32 = False
            dot_out[f"{name} {'tf32' if f32 else 'bf16'}"] = dict(
                ms=d[key][dtype][0], cold_ms=d["cold_" + key + tag],
                matmul_ms=d[lib_key + tag],
                cold_matmul_ms=d["cold_" + lib_key + tag],
                **({"matmul_tf32_ms": d["library_tf32_" + key]} if f32
                   else {}),
                bound_ms=d["form_bound_" + key + tag][0])
            print(f"  probe_dotgeneral {name} [{str(dtype)[6:]}] (warm / cold "
                  f"ms): {d[key][dtype][0]:.4f} / "
                  f"{d['cold_' + key + tag]:.4f}, torch.matmul "
                  f"{d[lib_key + tag]:.4f} / {d['cold_' + lib_key + tag]:.4f}"
                  + (f", TF32 {d['library_tf32_' + key]:.4f}" if f32 else "")
                  + f"; bound {d['form_bound_' + key + tag][0]:.5f} [{card}]")
    d["launches_probe"] = pdg.probe_dot.launches
    d["launches"] = 0  # on no path
    d["bound_ms"], d["bound_by"] = d.pop("form_bound_ms")

    # the edge shapes, against the plain versions
    for B, S_, D_, H_, p_, what in PROBE_ATTEND_EDGES:
        x = kvp.inputs(B, S_, D_, dev, seed=B + p_)
        for mode in ("bf16", "int8"):
            if kvp.attend_fault(B, S_, D_, H_, p_, mode == "int8"):
                continue  # int8 needs head sizes that are multiples of 16
            kernel, plain = kvp.modes(x, p_, H_)[mode]
            check_close(f"kv_traffic_probe {mode} {what} (plan "
                        f"{kvp.attend_plan(B, H_, p_ + 1)})", bf, kernel(),
                        plain())
        del x
    for B, S_, D_, block, what in PROBE_FLOOR_EDGES:
        x = kvp.inputs(B, S_, D_, dev, seed=S_)
        one = kvp.floor(x["q"], x["k"], x["v"], block)
        two = kvp.floor(x["q"], x["k"], x["v"], block)
        check_close(f"kv_traffic_probe floor {what} (plan "
                    f"{kvp.floor_plan(B, S_, D_, block)})", bf, one,
                    kvp.floor_plain(x["q"], x["k"], x["v"], block))
        fail_unless(torch.equal(one, two), f"kv_traffic_probe floor {what}: "
                    "two calls gave other bits")
        del x
    x = kvp.inputs(64, S, D, dev)
    same = torch.equal(kvp.floor(x["q"], x["k"], x["v"]),
                       kvp.floor(x["q"], x["k"], x["v"]))
    fail_unless(same, "kv_traffic_probe floor: two calls at B=64 gave "
                "other bits")
    print(f"  kv_traffic_probe floor: the same bits over two calls at the "
          f"edge shapes and at B=64")
    for form, M, N, K, what in PROBE_DOT_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(M + N + K)
            shp = ((M, K), (N, K)) if form == "NT" else ((K, M), (K, N))
            a, b = (torch.randn(*sh, generator=g).to(dev, dtype)
                    for sh in shp)
            got, want = pdg.probe_dot(a, b, form), pdg.probe_dot_plain(a, b,
                                                                       form)
            _, rel = errors(got, want)
            tol = pdg.TOL[str(dtype)[6:]]
            print(f"  probe_dotgeneral {form} {what} [{str(dtype)[6:]}] (plan "
                  f"{pdg.dot_plan(form, M, N, K, a.element_size())}) rel "
                  f"{rel:.3e} (limit {tol}) {'ok' if rel <= tol else 'FAIL'}")
            fail_unless(rel <= tol, f"probe_dotgeneral {form} {what} "
                        f"[{dtype}] disagrees with the f32 product")
    # one launch a call, no memset: the profiler's count (a fresh process)
    proc = subprocess.run([sys.executable, "-c", PROBE_LAUNCH_CHECK],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    fail_unless(proc.returncode == 0, "the probes' launch count exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
    counts = out["device_events_a_call"] = {}
    for what, seen in json.loads(proc.stdout.strip().splitlines()[-1]
                                 ).items():
        counts[what] = dict(kernels=len(seen["kernels"]),
                            memsets=len(seen["memsets"]))
        print(f"  profiler, one call of {what}: {len(seen['kernels'])} "
              f"kernel(s) {[short_kernel_name(k_) for k_ in seen['kernels']]}"
              f", {len(seen['memsets'])} memset(s)")
        fail_unless(len(seen["kernels"]) == 1 and not seen["memsets"],
                    f"{what}: {len(seen['kernels'])} kernels and "
                    f"{len(seen['memsets'])} memsets in one call, not one "
                    "kernel")
    del x
    torch.cuda.empty_cache()
    for module, args in (("kv_traffic_probe", ["-B", "32"]),
                         ("probe_dotgeneral", [])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"video2music_tpu_torch.tools.{module}",
             *args], capture_output=True, text=True, cwd=ROOT, timeout=300)
        fail_unless(proc.returncode == 0, f"{module} CLI exited "
                    f"{proc.returncode}: {proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        out[f"{module} CLI"] = line
        print(f"python -m video2music_tpu_torch.tools.{module} "
              f"{' '.join(args)} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(line)}")


def many_experts_phase(report, v2m):
    """The decode kernels at 40 experts, top-10 (product d_model 512, 8
    heads, d_ff 1024, pos 150) against their plain versions, float32 and
    bfloat16: the deep B=1 layer (decode_layer_step) and a one-layer run of
    the cooperative kernel (decode_flat_monolith_step), the batched MoE
    half at B=16 (dense expert slots in bf16) and B=4 (routed), the deep
    3.1 variant layer at B=1 and the batched variant MoE half at B=16 and
    B=3. The routers keep no fixed-size selection; the JAX kernels take
    any E and k_top."""
    import torch
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_layer as dl
    from video2music_tpu_torch.ops import decode_stack as ds
    from video2music_tpu_torch.ops import decode_variant as dv

    dev = v2m.device
    cfg = v2m.amt_cfg
    D, F, H = cfg.d_model, cfg.d_ff, cfg.num_heads
    E, k_top = 40, 10
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    pos = S // 2
    rope = rope_tables(v2m.model, dev)
    gen = torch.Generator().manual_seed(40)
    _, metas, norm, pre_norm, _ = VARIANT_CASES[3]  # 3.1
    for dtype in (torch.float32, torch.bfloat16):
        print(f"{E} experts top-{k_top}, {dtype}:")
        p = random_layer(gen, D, F, E, True, dtype, dev)
        kc, vc = (torch.randn(S, D, generator=gen).to(dev, dtype)
                  for _ in range(2))
        kx, vx = (torch.randn(Sm, D, generator=gen).to(dev, dtype)
                  for _ in range(2))
        x = torch.randn(1, D, generator=gen).to(dev, dtype)
        kw = dict(n_heads=H, k_top=k_top, rope=rope)
        c1, c2 = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
        check_close(f"decode_layer E={E} k={k_top}", dtype,
                    dl.decode_layer_step(x, pos, p, *c1, kx, vx, **kw),
                    dl.decode_layer_plain(x, pos, p, *c2, kx, vx, **kw))
        c1, c2 = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
        rkw = dict(embed=False, fold_head=False, x=x, **kw)
        check_close(f"decode_flat_monolith E={E} k={k_top}", dtype,
                    ds.decode_flat_monolith_step(
                        None, None, None, pos, [p], None, [(*c1, kx, vx)],
                        **rkw),
                    ds.decode_flat_monolith_plain(
                        None, None, None, pos, [p], None, [(*c2, kx, vx)],
                        **rkw))
        for B in (16, 4):
            xb = torch.randn(B, D, generator=gen).to(dev, dtype)
            check_close(f"batched_moe_ffn E={E} k={k_top} B={B}", dtype,
                        db.batched_moe_ffn(xb, p, k_top=k_top),
                        db.batched_moe_ffn_plain(xb, p, k_top=k_top))
        meta = dv.VariantLayerMeta(*metas[1])  # the deep 3.1 layer
        pv = random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev)
        vkw = dict(n_heads=H, rope=rope, norm=norm, pre_norm=pre_norm)
        kc1, vc1, kx1, vx1 = (torch.randn(n, w * D, generator=gen)
                              .to(dev, dtype)
                              for n, w in ((S, 2), (S, 1), (Sm, 2), (Sm, 1)))
        a1 = (x, pos, pv, meta, kc1.clone(), vc1.clone(), kx1, vx1)
        a2 = (x, pos, pv, meta, kc1.clone(), vc1.clone(), kx1, vx1)
        check_close(f"decode_variant_layer 3.1 E={E} k={k_top}", dtype,
                    dv.decode_variant_layer_step(*a1, k_top=k_top, **vkw),
                    dv.decode_variant_layer_plain(*a2, k_top=k_top, **vkw))
        mkw = dict(k_top=k_top, norm=norm, pre_norm=pre_norm)
        for B in (16, 3):
            xb = torch.randn(B, D, generator=gen).to(dev, dtype)
            check_close(f"batched_variant_moe_ffn 3.1 E={E} k={k_top} B={B}",
                        dtype, dbv.batched_variant_moe_ffn(xb, pv, meta, **mkw),
                        dbv.batched_variant_moe_plain(xb, pv, meta, **mkw))


@contextlib.contextmanager
def experts_forced(dense: bool):
    """Every MoE step runs its experts dense (True) or routed (False),
    whatever decode_batch.dense_experts would choose."""
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_variant as dv
    saved = db.dense_experts, dv.dense_experts
    db.dense_experts = dv.dense_experts = lambda *args: dense
    try:
        yield
    finally:
        db.dense_experts, dv.dense_experts = saved


def expert_cut_phase(report, v2m, card):
    """The bf16 MoE halves with their experts dense and routed, side by
    side, at B = 2, 3, 4, 6 and 8, for the product's 6 experts top-2 and
    for 40 experts top-10 (product widths): batched_moe_ffn (row 7) and the
    3.1 batched_variant_moe_ffn (row 10), each path held to the plain
    version and timed by CUDA-graph replay. These lines set
    decode_batch.dense_experts."""
    import torch
    from video2music_tpu_torch.ops import decode_batch as db
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_variant as dv

    dev, dtype = v2m.device, torch.bfloat16
    cfg = v2m.amt_cfg
    D, F, H, S = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.max_seq_chord
    gen = torch.Generator().manual_seed(2468)
    _, metas, norm, pre_norm, _ = VARIANT_CASES[3]  # 3.1
    meta = dv.VariantLayerMeta(*metas[1])           # its deep layer
    out = report.setdefault("expert_cut", {})
    for E, k_top in ((cfg.moe.n_experts, cfg.moe.n_experts_per_token),
                     (40, 10)):
        p = random_layer(gen, D, F, E, True, dtype, dev)
        pv = random_variant_layer(gen, meta, D, H, F, E, S, dtype, dev)
        for B in (2, 3, 4, 5, 6, 8):
            xb = torch.randn(B, D, generator=gen).to(dev, dtype)
            calls = {
                "batched_moe_ffn": (
                    lambda: db.batched_moe_ffn(xb, p, k_top=k_top),
                    lambda: db.batched_moe_ffn_plain(xb, p, k_top=k_top)),
                "batched_variant_moe_ffn 3.1": (
                    lambda: dbv.batched_variant_moe_ffn(
                        xb, pv, meta, k_top=k_top, norm=norm,
                        pre_norm=pre_norm),
                    lambda: dbv.batched_variant_moe_plain(
                        xb, pv, meta, k_top=k_top, norm=norm,
                        pre_norm=pre_norm))}
            for name, (fn, plain) in calls.items():
                label = f"{name} E={E} k={k_top} B={B}"
                ms = {}
                for dense in (True, False):
                    path = "dense" if dense else "routed"
                    with experts_forced(dense):
                        check_close(f"{label} {path}", dtype, fn(), plain())
                        ms[path] = time_ms(fn)[0]
                chosen = db.dense_experts(B, E, k_top, dtype)
                out[label] = dict(ms, chosen="dense" if chosen else "routed")
                print(f"expert cut {label} bf16: dense {ms['dense']:.4f} ms, "
                      f"routed {ms['routed']:.4f} ms, dense_experts picks "
                      f"{out[label]['chosen']} (this run, CUDA-graph "
                      f"replay) [{card}]")


def variant_int8_layer(report, name, dtype, p, meta, inputs, kw):
    """The B=1 variant layer with int8 weights (every QUANT_KEYS weight of
    the packed layer ``p`` quantized per output row) against its plain
    version; on the deep 3.1 layer its times and bound too."""
    import torch
    from video2music_tpu_torch.ops import decode_variant as dv
    from video2music_tpu_torch.ops.decode_layer import quantize_weight

    x, pos, kc, vc, kx, vx = inputs
    q = dict(p)
    for key in dv.QUANT_KEYS:
        if key in q:
            q[key], q[key + "_s"] = quantize_weight(q[key])
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    args1 = (x, pos, q, meta, k1, v1, kx, vx)
    args2 = (x, pos, q, meta, k2, v2, kx, vx)
    tag = f"decode_variant_layer int8 {name} {meta.attn}/{meta.ffn}"
    err = check_close(tag, dtype, dv.decode_variant_layer_step(*args1, **kw),
                      dv.decode_variant_layer_plain(*args2, **kw))
    check_close(tag + " k row", dtype, k1[pos], k2[pos])
    r = report["decode_variant_layer"]
    errs = r.setdefault("err_int8", {})
    errs[dtype] = max(err, errs.get(dtype, 0.0))
    if name != "3.1":
        return
    note_times(report, "decode_variant_layer", dtype,
               lambda: dv.decode_variant_layer_step(*args1, **kw),
               lambda: dv.decode_variant_layer_plain(*args2, **kw),
               key="ms_int8")
    if dtype == torch.bfloat16:
        # the int8 weights at a byte each with their f32 row scales, the
        # two experts its router picks; the caches as the bf16 layer's
        rows = torch.zeros(q["gate_w"].shape[0])
        rows[:kw["k_top"]] = 1
        own = tuple(k for k in q if k not in EXPERT_KEYS + EXPERT_SCALES)
        w_b, w_f = layer_work(q, own)
        e_b, e_f = layer_work(q, EXPERT_KEYS + EXPERT_SCALES, rows)
        a_b, a_f = variant_attention_work(q, 1, pos, kx.shape[0],
                                          x.shape[-1], x.element_size())
        r["bound_ms_int8"] = max(
            (w_b + e_b + a_b + 2 * nbytes(x)) / HBM_BYTES_PER_S * 1e3,
            (w_f + e_f + a_f) / PEAK_BF16 * 1e3)


def v3_slice_phase(card, report):
    """Full-width bf16 Video2music at 3.1 (three B=1 requests, then
    generate_batch at B=16) and at 3.2 (one B=1 request, one B=16 batch),
    random weights from seed 0: every clip checked, and each kernel's
    launches equal to what the V3 path implies (the variant kernels,
    flash attention at 2H heads, the scan). Returns the two models."""
    from video2music_tpu_torch.pipeline.api import Video2music

    T = 300
    models = {}
    for version in ("3.1", "3.2"):
        t0 = time.perf_counter()
        v2m = Video2music(music_gen_version=version, seed=0, device="cuda")
        print(f"built full-width Video2music (AMT {version} + bimamba+) in "
              f"{time.perf_counter() - t0:.1f} s")
        models[version] = v2m
        requests = REQUESTS if version == "3.1" else REQUESTS[:1]
        widths = []
        with tempfile.TemporaryDirectory() as tmp:
            v2m.generate(features=synthetic_features(30, 99),  # warm-up
                         output_dir=os.path.join(tmp, "warm_up"))
            reqs, temps = serving_requests(2, 500)
            v2m.generate_batch(reqs, temperature=temps,
                               output_dir=os.path.join(tmp, "warm_up_b"))
            for fn in wrappers().values():
                fn.launches = 0
            for i, req in enumerate(requests):
                t0 = time.perf_counter()
                res = v2m.generate(primer=req["primer"], key=req["key"],
                                   temperature=req["temperature"],
                                   features=synthetic_features(req["n_sec"],
                                                               i),
                                   output_dir=os.path.join(tmp, f"clip_{i}"),
                                   seed=i)
                wall = time.perf_counter() - t0
                widths.append(1)
                tm = v2m.last_timings
                check_clip(f"V{version} request {i}", res, req["primer"],
                           req["n_sec"], v2m.last_regression["instrument"],
                           v2m.last_regression["ln_nd"])
                print(f"V{version} request {i} ({req['n_sec']} s, primer "
                      f"{req['primer']!r}): wall {wall:.3f} s, encode "
                      f"{tm['encode']:.3f} ms, prime {tm['prime']:.3f} ms, "
                      f"decode {tm['decode']:.1f} ms = "
                      f"{tm['decode'] / (T - 1):.4f} ms/token, regression "
                      f"{tm['regression']:.3f} ms, postprocess "
                      f"{tm['postprocess']:.1f} ms [{card}]")
            B = 16
            reqs, temps = serving_requests(B, 3000 + B)
            t0 = time.perf_counter()
            results = v2m.generate_batch(reqs, temperature=temps, seed=B,
                                         output_dir=os.path.join(tmp, "b16"))
            wall = time.perf_counter() - t0
            widths.append(B)
            fail_unless(len(results) == B, f"B={B}: {len(results)} results")
            check_batch(f"V{version} generate_batch B={B}", v2m, reqs,
                        results)
            tm = v2m.last_timings
            print(f"V{version} generate_batch B={B}: wall {wall:.3f} s = "
                  f"{B / wall:.2f} clips/s, encode {tm['encode']:.3f} ms, "
                  f"prime {tm['prime']:.3f} ms, decode {tm['decode']:.1f} ms "
                  f"= {tm['decode'] / (T - 1):.4f} ms/step, regression "
                  f"{tm['regression']:.3f} ms, postprocess "
                  f"{tm['postprocess']:.1f} ms [{card}]")
        check_launches(report, v2m, widths, V3_KERNELS, V3_KERNELS[1:4])
        fl = wrappers()["flash_attention"].launches
        report["flash_attention"]["launches_2h"] = \
            report["flash_attention"].get("launches_2h", 0) + fl
        if version == "3.1":  # after the launch check: the profile launches
            model, _ = v2m._models("bfloat16")
            report["v3_step"] = {f"B={B}": profile_steps(model, B, card)
                                 for B in (1, 16)}
    return models


def profile_steps(model, B, card, n=20, fused="auto", quantize=None,
                  split=True):
    """The decode step of ``model`` alone (no sampler) at width B and
    backend (``fused``, ``quantize``, ``split`` as generate_chords takes
    them): ms/step from CUDA events over n steps, then
    torch.profiler over n more: device time per step, the device's busy
    share, launches per step and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from video2music_tpu_torch.decode.sampler import fused_backend

    feats = [synthetic_features(300, 40 + b) for b in range(B)]
    f = {k: torch.stack([torch.as_tensor(x[k]) for x in feats])
         .to("cuda", torch.bfloat16) for k in feats[0]}
    init_caches, make_step = fused_backend(model.cfg, B, fused, quantize,
                                           split)
    ids = torch.arange(B, device="cuda", dtype=torch.int32) % 12 + 1
    key = torch.zeros(B, device="cuda")
    with torch.no_grad():
        caches = init_caches(model, model.prime(model.encode(**f)))
        step = make_step(model)
        for pos in range(5):  # warm-up
            step(caches, ids, ids, key, pos)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for pos in range(5, 5 + n):
            step(caches, ids, ids, key, pos)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(5 + n, 5 + 2 * n):
                step(caches, ids, ids, key, pos)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"V{model.cfg.version} decode step B={B}, fused={fused!r}, "
          f"quantize={quantize!r}, split={split} (bf16, no sampler): "
          f"{ms:.4f} ms/step (CUDA events, {n} steps); "
          f"profiler on: wall {wall:.4f} ms/step, device {busy:.4f} ms/step "
          f"in {launches:.0f} kernels and copies, busy share "
          f"{busy / wall:.3f} [{card}]")
    for t, count, name in rows[:8]:
        print(f"  {t:8.4f} ms/step  {count:5.0f} calls/step  {name[:90]}")
    return dict(ms_step=ms, device_ms=busy, busy=busy / wall,
                launches_step=launches)


def plain_variant_step(model, batched, quantize=None):
    """decode/fused.make_fused_(batch_)variant_step through the plain
    versions."""
    from video2music_tpu_torch.decode.fused import _embed, _variant_setup
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_variant as dv

    layers, metas, kw = _variant_setup(model, quantize)
    k_top = model.cfg.moe.n_experts_per_token
    nkw = dict(norm=kw["norm"], pre_norm=kw["pre_norm"])

    def run(c, root, attr, key, pos, token=None):
        x = _embed(model, token, root, attr, key, pos)
        for i, (p, meta) in enumerate(zip(layers, metas)):
            caches = (c[f"k{i}"], c[f"v{i}"], c[f"ck{i}"], c[f"cv{i}"])
            if not batched:
                x = dv.decode_variant_layer_plain(x, pos, p, meta, *caches,
                                                  k_top=k_top, **kw)
                continue
            x = dbv.batched_variant_layer_plain(x, pos, p, meta, *caches,
                                                **kw)
            if meta.ffn == "moe":
                x = dbv.batched_variant_moe_plain(x, p, meta, k_top=k_top,
                                                  **nkw)
        return model.head(x)
    return run


def v3_teacher_forced_phase(models, cases=((1, None), (8, None))):
    """16 positions of seeded random tokens through the V3 kernel step and
    the plain step for each (B, quantize) of ``cases`` (B=1 and B=8; the
    int8-weight step at B=1), for 3.1 and 3.2, float32 and bfloat16,
    comparing the expert ids of every router too. float32: each path
    carries its own caches and every logit must agree. bfloat16: the plain
    caches are reset to the kernel's before each step, and a clip-position
    may leave the tolerance only rarely (a router near-tie, as in
    teacher_forced_batch_phase)."""
    import torch
    from video2music_tpu_torch.decode import fused

    for version, v2m in models.items():
        dev = v2m.device
        routed = any(spec.ffn == "moe" for spec in v2m.amt_cfg.decoder_layers)
        for B, quantize in cases:
            tag = f"V{version} teacher-forced B={B}" + (
                f" quantize={quantize!r}" if quantize else "")
            gen = torch.Generator().manual_seed(9 + B)
            n_root = v2m.model.embedding_root.num_embeddings
            n_attr = v2m.model.embedding_attr.num_embeddings
            roots = torch.randint(n_root, (16, B), generator=gen)
            attrs = torch.randint(n_attr, (16, B), generator=gen)
            feats = [synthetic_features(300, 90 + b) for b in range(B)]
            for name in ("float32", "bfloat16"):
                dtype = getattr(torch, name)
                model, _ = v2m._models(name)
                f = {k: torch.stack([torch.as_tensor(x[k]) for x in feats])
                     .to(dev, dtype) for k in feats[0]}
                key = (torch.arange(B, device=dev) % 2).float()
                with torch.no_grad():
                    cross = model.prime(model.encode(**f))
                    if B == 1:
                        kc = fused.init_fused_variant_caches(model, cross)
                        kernel_step = fused.make_fused_variant_step(
                            model, quantize=quantize)
                    else:
                        kc = fused.init_fused_batch_variant_caches(model,
                                                                   cross)
                        kernel_step = fused.make_fused_batch_variant_step(
                            model)
                    pc = {k: v.clone() for k, v in kc.items()}
                    plain_step = plain_variant_step(model, B > 1, quantize)
                    worst, outliers, diffs = 0.0, [], []
                    for pos in range(16):
                        root = roots[pos].to(dev, torch.int32)
                        attr = attrs[pos].to(dev, torch.int32)
                        if dtype == torch.bfloat16:
                            for k, v in kc.items():
                                pc[k].copy_(v)
                        got, k_routes = routed_step(kernel_step, kc, root,
                                                    attr, key, pos)
                        want, p_routes = routed_step(plain_step, pc, root,
                                                     attr, key, pos)
                        diffs += route_diffs(pos, k_routes, p_routes,
                                             routed)
                        fail_unless(bool(torch.isfinite(got).all()),
                                    f"{tag} pos {pos}: non-finite logits")
                        if dtype == torch.float32:
                            worst = max(worst, check_close(
                                f"{tag} pos {pos}", dtype, got, want,
                                atol=F32_LOGIT_ATOL))
                            continue
                        for b in range(B):
                            abs_err, rel_err = errors(got[b], want[b])
                            worst = max(worst, abs_err)
                            if rel_err > BF16_REL:
                                outliers.append((pos, b, round(rel_err, 4)))
                if dtype == torch.bfloat16:
                    print(f"  bf16 clip-positions outside rel {BF16_REL}: "
                          f"{len(outliers)} of {16 * B} {outliers}")
                    fail_unless(len(outliers) * BF16_ROUTE_SHARE <= 16 * B,
                                f"{tag} bf16: {len(outliers)} of {16 * B} "
                                f"disagree")
                print(f"{tag} {name}: max abs logit error over 16 positions "
                      f"{worst:.3e}; expert ids differing (pos, MoE layer, "
                      f"clip): {diffs}")


# ---------------------------------------------------------------------------
# phase 8a: the variant wirings at full width
# ---------------------------------------------------------------------------

# (label, music_gen_version, amt_overrides): full-width wirings; each
# decodes through the variant kernels where fused_variant_eligible holds
# (the base AMT, 1.1, 1.3.4, 2.0) and on the plain step where it does not
# (KAN 2.3, grouped-query attention), as in the JAX sampler
# depth cut to keep the run within its limit: every wiring at 2+2 layers,
# the least depth that keeps each one's layer kinds (a shallow and a deep
# layer where it splits them, core/config.py _shallow_deep); the two that
# decode on the plain step (KAN 2.3, GQA) took 60 s of the run at 6+6, the
# variant-kernel ones ran 3+3 until the f32 wide kernels' build time had
# to be made up
WIRINGS = (("AMT", None, dict(n_layers=2)), ("1.1", "1.1", dict(n_layers=2)),
           ("1.3.4", "1.3.4", dict(n_layers=2)),
           ("2.0", "2.0", dict(n_layers=2)), ("2.3", "2.3", dict(n_layers=2)),
           ("2.2 GQA", "2.2", dict(kv_heads=2, n_layers=2)))
WIRING_KERNELS = ("flash_attention", "decode_variant_layer",
                  "batched_variant_layer_step", "batched_variant_moe_ffn")
# (label, decoder layer, key): the layer forms of rows 8-10 timed on a
# wiring's own packed weights: the base AMT's RPR + ReLU layer and the
# 1.3.4 deep layer (SiLU-MLP experts, no shared expert)
WIRING_FORMS = (("AMT", 0, "ms_rpr"), ("1.3.4", -1, "ms_mlp"))


def form_bound(n_bytes, flops, peak=PEAK_BF16):
    """(bound ms, "bytes" or "operations") as note_bound computes them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def wiring_form_phase(report, v2m, layer_idx, key):
    """Rows 8-10 on one packed decoder layer of ``v2m``'s model against
    their plain versions at pos 150 on random caches, float32 and
    bfloat16: the B=1 layer and the batched layer (and the MoE half of a
    deep layer) at B=16, times and bounds kept under ``key`` (a row's
    ms_rpr / ms_mlp beside its main ms)."""
    import torch
    from video2music_tpu_torch.decode.fused import _variant_setup
    from video2music_tpu_torch.ops import decode_batch_variant as dbv
    from video2music_tpu_torch.ops import decode_variant as dv
    from video2music_tpu_torch.ops.decode_batch import route_plain

    cfg, dev = v2m.amt_cfg, v2m.device
    D, S, Sm = cfg.d_model, cfg.max_seq_chord, cfg.max_seq_video
    k_top = cfg.moe.n_experts_per_token
    pos = S // 2
    gen = torch.Generator().manual_seed(97)
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        el = torch.tensor([], dtype=dtype).element_size()
        model, _ = v2m._models(name)
        layers, metas, kw = _variant_setup(model)
        p, meta = layers[layer_idx], metas[layer_idx]
        tag = f"{key[3:]} ({meta.attn}/{meta.ffn}/{meta.expert}" \
              f"{'' if meta.shared else ', no shared expert'})"
        deep = meta.ffn == "moe"
        nkw = dict(norm=kw["norm"], pre_norm=kw["pre_norm"])
        keys = [k for k in VARIANT_ATTN_KEYS if k in p]
        ffn = VARIANT_SHARED_KEYS if deep else ("fw1g", "fb1g", "fw2", "fb2")
        ffn = [k for k in ffn if k in p]
        rpr = (pos + 1) * D * 4 if "er" in p else 0  # the Er rows read
        for B in (1, 16):
            lead = () if B == 1 else (B,)
            kc, vc = (torch.randn(*lead, S, D, generator=gen).to(dev, dtype)
                      for _ in range(2))
            kx, vx = (torch.randn(*lead, Sm, D, generator=gen).to(dev, dtype)
                      for _ in range(2))
            x = torch.randn(B, D, generator=gen).to(dev, dtype)
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            args1 = (x, pos, p, meta, k1, v1, kx, vx)
            args2 = (x, pos, p, meta, k2, v2, kx, vx)
            if B == 1:
                rows = torch.zeros(cfg.moe.n_experts)
                rows[:k_top] = 1
                kernel = lambda: dv.decode_variant_layer_step(
                    *args1, k_top=k_top, **kw)
                plain = lambda: dv.decode_variant_layer_plain(
                    *args2, k_top=k_top, **kw)
                rname = "decode_variant_layer"
                w_b, w_f = layer_work(p, keys + ffn)
                e_b, e_f = layer_work(p, EXPERT_KEYS, rows) if deep \
                    else (0, 0)
                a_b, a_f = variant_attention_work(p, 1, pos, Sm, D, el)
                work = (w_b + e_b + a_b + rpr + 2 * nbytes(x),
                        w_f + e_f + a_f + 2 * (pos + 1) * D)
            else:
                kernel = lambda: dbv.batched_variant_layer_step(*args1, **kw)
                plain = lambda: dbv.batched_variant_layer_plain(*args2, **kw)
                rname = "batched_variant_layer_step"
                w_b, w_f = layer_work(p, keys + ([] if deep else ffn))
                a_b, a_f = variant_attention_work(p, B, pos, Sm, D, el)
                work = (w_b + a_b + rpr + 2 * nbytes(x),
                        B * w_f + a_f + B * 2 * (pos + 1) * D)
            got, want = kernel(), plain()
            err = check_close(f"{rname} {tag} B={B}", dtype, got, want)
            check_close(f"{rname} {tag} B={B} k row", dtype, k1[..., pos, :],
                        k2[..., pos, :])
            note_error(report, rname, dtype, err)
            note_times(report, rname, dtype, kernel, plain, key=key)
            if dtype == torch.bfloat16:
                report[rname]["form_bound_" + key] = form_bound(*work)
            if B == 1 or not deep:
                continue
            kernel = lambda: dbv.batched_variant_moe_ffn(
                want, p, meta, k_top=k_top, **nkw)
            plain = lambda: dbv.batched_variant_moe_plain(
                want, p, meta, k_top=k_top, **nkw)
            err = check_close(f"batched_variant_moe_ffn {tag} B={B}", dtype,
                              kernel(), plain())
            note_error(report, "batched_variant_moe_ffn", dtype, err)
            note_times(report, "batched_variant_moe_ffn", dtype, kernel,
                       plain, key=key)
            if dtype == torch.bfloat16:
                rows = (route_plain(want, p["gate_w"], p["gate_b"], k_top)
                        != 0).sum(0).cpu()
                s_b, s_f = layer_work(p, [k for k in VARIANT_SHARED_KEYS
                                          if k in p] + ["norm_scale",
                                                        "norm_bias"])
                e_b, e_f = layer_work(p, EXPERT_KEYS, rows)
                report["batched_variant_moe_ffn"]["form_bound_" + key] = \
                    form_bound(s_b + e_b + 2 * nbytes(want), B * s_f + e_f)


def wirings_phase(card, report):
    """Each wiring of WIRINGS at full width (d_model 512, 8 heads, d_ff
    1024; depth cut to 2 + 2 layers), 300 positions,
    6 experts top-2; bimamba+
    regression), random weights from seed 0, bfloat16 serving: the kernel
    step held to the plain step under teacher forcing at B=1 and B=8 (f32
    and bf16, expert ids compared) where a kernel covers the wiring; one
    300 s generate and one generate_batch at B=16, every clip checked,
    ms/token and clips/s; the kernel launches of those two calls equal to
    what the path implies (none of the decode kernels for a plain-step
    wiring); each wiring's decode step profiled at B=1 and B=16; rows 8-10
    in the base AMT's RPR + ReLU form and the 1.3.4 MLP-expert form
    (WIRING_FORMS)."""
    import torch
    from video2music_tpu_torch.ops.decode_variant import (
        fused_variant_eligible)
    from video2music_tpu_torch.pipeline.api import Video2music

    T = 300
    out = report.setdefault("wirings", {})
    for label, version, over in WIRINGS:
        t0 = time.perf_counter()
        v2m = Video2music(music_gen_version=version, seed=0, device="cuda",
                          amt_overrides=over or None)
        eligible = fused_variant_eligible(v2m.amt_cfg)
        print(f"built full-width Video2music (AMT {label} + bimamba+) in "
              f"{time.perf_counter() - t0:.1f} s; decode through "
              f"{'the variant kernels' if eligible else 'the plain step'}")
        if eligible:
            v3_teacher_forced_phase({label: v2m}, ((1, None), (8, None)))
        for form_label, layer_idx, key in WIRING_FORMS:
            if form_label == label:
                wiring_form_phase(report, v2m, layer_idx, key)
        row = out[label] = {}
        with tempfile.TemporaryDirectory() as tmp:
            v2m.generate(features=synthetic_features(30, 99),  # warm-up
                         output_dir=os.path.join(tmp, "warm_up"))
            reqs, temps = serving_requests(2, 500)
            v2m.generate_batch(reqs, temperature=temps,
                               output_dir=os.path.join(tmp, "warm_up_b"))
            for fn in wrappers().values():
                fn.launches = 0
            req = REQUESTS[0]
            t0 = time.perf_counter()
            res = v2m.generate(primer=req["primer"], key=req["key"],
                               temperature=req["temperature"],
                               features=synthetic_features(T, 7),
                               output_dir=os.path.join(tmp, "clip"), seed=7)
            wall = time.perf_counter() - t0
            check_clip(f"{label} request", res, req["primer"], T,
                       v2m.last_regression["instrument"],
                       v2m.last_regression["ln_nd"])
            tm = v2m.last_timings
            row["ms_token"] = tm["decode"] / (T - 1)
            row["b1_wall_s"] = wall
            print(f"{label} request (300 s, primer {req['primer']!r}): wall "
                  f"{wall:.3f} s, encode {tm['encode']:.3f} ms, decode "
                  f"{tm['decode']:.1f} ms = {row['ms_token']:.4f} ms/token, "
                  f"regression {tm['regression']:.3f} ms [{card}]")
            B = 16
            reqs, temps = serving_requests(B, 3000 + B)
            t0 = time.perf_counter()
            results = v2m.generate_batch(reqs, temperature=temps, seed=B,
                                         output_dir=os.path.join(tmp, "b16"))
            wall = time.perf_counter() - t0
            fail_unless(len(results) == B, f"B={B}: {len(results)} results")
            check_batch(f"{label} generate_batch B={B}", v2m, reqs, results)
            tm = v2m.last_timings
            row["clips_s_b16"] = B / wall
            row["ms_step_b16"] = tm["decode"] / (T - 1)
            print(f"{label} generate_batch B={B}: wall {wall:.3f} s = "
                  f"{B / wall:.2f} clips/s, decode {tm['decode']:.1f} ms = "
                  f"{row['ms_step_b16']:.4f} ms/step [{card}]")
        implied = [path_launches(v2m, w, plain_decode=not eligible)
                   for w in (1, B)]
        names = tuple(n for n in WIRING_KERNELS + ("selective_scan",)
                      if any(i[n] for i in implied))
        check_launches(report, v2m, [1, B], names, names,
                       key="launches_wirings", plain_decode=not eligible)
        model, _ = v2m._models("bfloat16")
        row["step"] = {f"B={b}": profile_steps(model, b, card)
                       for b in (1, 16)}
        del v2m, model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8b: the Mamba-family regression backbones at full width
# ---------------------------------------------------------------------------

# (reg_model, use_kan): every Mamba-family backbone, and the KAN
# projections on mamba
ZOO = (("mamba", False), ("mamba+", False), ("moemamba", False),
       ("bimamba", False), ("bimamba+", False), ("moe_bimamba+", False),
       ("sharedmoe_bimamba+", False), ("mamba", True))


@contextlib.contextmanager
def plain_scan():
    """Run the Mamba blocks through the plain scan (the comparison's
    reference) while the context is open."""
    from video2music_tpu_torch.models import mamba
    from video2music_tpu_torch.ops.scan import selective_scan_plain
    kernel = mamba.selective_scan
    mamba.selective_scan = selective_scan_plain
    try:
        yield
    finally:
        mamba.selective_scan = kernel


def bf16_positions(name, got, want):
    """bf16 regression outputs (B, L, n) against the plain scan's: a
    position (clip, second) may leave BF16_REL, relative to the largest
    magnitude, only rarely (at most one in BF16_ROUTE_SHARE): the scan's
    one-ulp differences can flip a MoE router's near-tie and send that
    position to other experts, as in the teacher-forced phases."""
    scale = max(want.float().abs().max().item(), 1e-30)
    rel = (got.float() - want.float()).abs().amax(-1) / scale
    outliers = int((rel > BF16_REL).sum())
    n = rel.numel()
    ok = outliers * BF16_ROUTE_SHARE <= n
    print(f"  {name} [bfloat16] max_rel {rel.max().item():.3e}, positions "
          f"outside rel {BF16_REL}: {outliers} of {n} "
          f"{'ok' if ok else 'FAIL'}")
    fail_unless(ok, f"{name} [bfloat16]: {outliers} of {n} positions "
                f"disagree with the plain scan's")


def scan_grads(fn, args, g):
    import torch
    leaves = [a.detach().requires_grad_() for a in args]
    y = fn(*leaves)
    return y, torch.autograd.grad(y, leaves, g)


def regression_zoo_phase(card, report):
    """Each ZOO backbone at full width (RegressionConfig defaults: d_model
    64, 2 layers, d_hidden 1024, so moemamba runs d_state 1024 with d_conv
    8), random weights from seed 0, over a 300 s clip at B=1 and B=16:
    the forward through the scan kernel against the same weights through
    the plain scan, float32 and bfloat16, the scan's launches per forward,
    the forward ms (CUDA events); the scan inside moemamba on the inputs
    the path gives it against its plain version (times under
    ms_moemamba); then torch.autograd.grad through the kernel's wrapper
    against the plain scan's gradients at d_state 16 and 1024, on the scan
    alone and through the mamba and moemamba models (every parameter's
    gradient)."""
    import copy

    import torch
    from video2music_tpu_torch.core.config import RegressionConfig
    from video2music_tpu_torch.models import VideoRegression, mamba
    from video2music_tpu_torch.ops.scan import (selective_scan,
                                                selective_scan_plain)
    from video2music_tpu_torch.weights import init_weights_

    dev = torch.device("cuda")
    out = report.setdefault("zoo", {})
    feats = [synthetic_features(300, 60 + b) for b in range(16)]
    selective_scan.launches = 0
    launches = 0
    for rm, use_kan in ZOO:
        tag = rm + (" use_kan" if use_kan else "")
        cfg = RegressionConfig(reg_model=rm, total_vf_dim=768 + 6,
                               use_kan=use_kan)
        model = init_weights_(VideoRegression(cfg),
                              torch.Generator().manual_seed(0))
        model.to(dev).eval()
        per_forward = cfg.n_layers * (2 if "bimamba" in rm else 1)
        row = out[tag] = {}
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            m = model if dtype == torch.float32 else \
                copy.deepcopy(model).to(dtype)
            for B in (1, 16):
                sem = torch.stack([torch.as_tensor(f["semantic"])
                                   for f in feats[:B]]).to(dev, dtype)
                emo = torch.stack([torch.as_tensor(f["emotion"])
                                   for f in feats[:B]]).to(dev, dtype)
                with torch.no_grad():
                    n0 = selective_scan.launches
                    got = m(sem, None, None, emo)
                    fail_unless(selective_scan.launches - n0 == per_forward,
                                f"{tag}: {selective_scan.launches - n0} scan"
                                f" launches a forward, {per_forward} implied")
                    launches += per_forward
                    with plain_scan():
                        want = m(sem, None, None, emo)
                for i, part in enumerate(("ln_nd", "instrument")):
                    fail_unless(bool(torch.isfinite(got[i]).all()),
                                f"{tag}: non-finite {part}")
                    if dtype == torch.float32:
                        check_close(f"regression {tag} B={B} {part}", dtype,
                                    got[i], want[i])
                    else:
                        bf16_positions(f"regression {tag} B={B} {part}",
                                       got[i], want[i])
                with torch.no_grad():
                    n0 = selective_scan.launches
                    ms = eager_ms(lambda: m(sem, None, None, emo), iters=10)
                    selective_scan.launches = n0  # timing, not the path
                row[f"ms_b{B}_{name}"] = ms
                print(f"  regression {tag} forward B={B} [{name}]: "
                      f"{ms:.3f} ms (eager, CUDA events) [{card}]")
        if rm == "moemamba":  # row 12 on the path's own inputs
            seen = []
            record = lambda *a: seen.append(a) or selective_scan_plain(*a)
            for name in ("float32", "bfloat16"):
                dtype = getattr(torch, name)
                m = model if dtype == torch.float32 else \
                    copy.deepcopy(model).to(dtype)
                sem = torch.as_tensor(feats[0]["semantic"])[None].to(dev,
                                                                     dtype)
                emo = torch.as_tensor(feats[0]["emotion"])[None].to(dev,
                                                                    dtype)
                seen.clear()
                mamba.selective_scan, kernel = record, mamba.selective_scan
                try:
                    with torch.no_grad():
                        m(sem, None, None, emo)
                finally:
                    mamba.selective_scan = kernel
                args = seen[0]
                n0 = selective_scan.launches
                err = check_close(
                    f"selective_scan in moemamba {tuple(args[0].shape)} "
                    f"N={args[2].shape[1]}", dtype, selective_scan(*args),
                    selective_scan_plain(*args))
                note_error(report, "selective_scan", dtype, err)
                note_times(report, "selective_scan", dtype,
                           lambda: selective_scan(*args),
                           lambda: selective_scan_plain(*args),
                           plain_iters=3, key="ms_moemamba")
                selective_scan.launches = n0
                if dtype == torch.bfloat16:
                    x, _, A, Bm, _, _ = args
                    b, L, ED = x.shape
                    N = A.shape[1]
                    # as the kernels phase: 8 f32 operations a (step,
                    # channel, state)
                    report["selective_scan"]["form_bound_ms_moemamba"] = \
                        form_bound(nbytes(*args) + nbytes(x),
                                   8 * b * L * ED * N, PEAK_F32)
        del model
    fail_unless(selective_scan.launches == launches,
                f"selective_scan: {selective_scan.launches} launches over the"
                f" zoo's forwards, {launches} implied")
    report["selective_scan"]["launches_zoo"] = launches
    # gradients through the wrapper (CUDA forward, recomputed backward)
    gen = torch.Generator().manual_seed(31)
    for N in (16, 1024):
        b, L, ED = 2, 300, 128
        x = torch.randn(b, L, ED, generator=gen).to(dev)
        dt = (torch.rand(b, L, ED, generator=gen) * 0.1).to(dev)
        A = (-0.5 - 4 * torch.rand(ED, N, generator=gen)).to(dev)
        Bm, Cm = (torch.randn(b, L, N, generator=gen).to(dev)
                  for _ in range(2))
        Dv = torch.randn(ED, generator=gen).to(dev)
        g = torch.randn(b, L, ED, generator=gen).to(dev)
        y, got = scan_grads(selective_scan, (x, dt, A, Bm, Cm, Dv), g)
        fail_unless(y.grad_fn is not None,
                    "selective_scan on CUDA tensors: no grad_fn")
        _, want = scan_grads(selective_scan_plain, (x, dt, A, Bm, Cm, Dv), g)
        for part, a, w in zip(("x", "delta", "A", "B", "C", "D"), got, want):
            check_close(f"selective_scan grad d{part} N={N}", torch.float32,
                        a, w, atol=F32_RTOL * w.abs().max().item())
    for rm in ("mamba", "moemamba"):
        cfg = RegressionConfig(reg_model=rm, total_vf_dim=768 + 6)
        model = init_weights_(VideoRegression(cfg),
                              torch.Generator().manual_seed(0)).to(dev)
        sem = torch.as_tensor(feats[0]["semantic"])[None].to(dev)
        emo = torch.as_tensor(feats[0]["emotion"])[None].to(dev)
        params = [p for p in model.parameters() if p.requires_grad]

        def grads():
            # the training forward drops in_proj's outputs (as the JAX
            # model): the same seed gives both scans the same mask
            torch.manual_seed(0)
            ln_nd, inst = model(sem, None, None, emo)
            return torch.autograd.grad(ln_nd.square().mean() + inst.mean(),
                                       params)
        got = grads()
        with plain_scan():
            want = grads()
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        worst = 0.0
        for n, a, w in zip(names, got, want):
            fail_unless(bool(torch.isfinite(a).all()) and
                        (a.abs().max() > 0 or w.abs().max() == 0),
                        f"{rm} grad {n}: missing or non-finite")
            abs_err, rel = errors(a, w)
            worst = max(worst, rel)
            fail_unless(rel <= 1e-3, f"{rm} grad {n}: relative error {rel}")
        print(f"  {rm} gradients through the scan kernel against the plain "
              f"scan: {len(names)} parameters, worst relative error "
              f"{worst:.3e} (limit 1e-3)")
        del model


# ---------------------------------------------------------------------------
# phases 8c-8d: raw video in (CLIP ViT-L/14@336, MaxViT-T, scene cuts) and
# the RNN / CNN-GRU / minGRU regressions
# ---------------------------------------------------------------------------

# row 1 in the forms the extractors give it: (key, B, H, L, D, causal,
# bias heads or 0, scale or None); MaxViT scales by its full channel width
RAW_VIDEO_FORMS = (
    ("ms_clip", 30, 16, 577, 64, False, 0, None),        # CLIP-L vision
    ("ms_clip_text", 6, 12, 77, 64, True, 0, None),      # CLIP text tower
    ("ms_maxvit_s0", 1920, 2, 49, 32, False, 2, 64 ** -0.5),
    ("ms_maxvit_s3", 30, 16, 49, 32, False, 16, 512 ** -0.5),
)
# full-width extractors, f32 on the card against the CPU: 24 layers of
# sums in another order (and the CPU's own blocking), relative to the
# largest magnitude
EXTRACT_F32_REL = 1e-3
# bf16 against f32 on the card: 24 pre-LN blocks (CLIP-L) or 22 partition
# attentions and 11 MBConvs (MaxViT-T) of bf16 rounding on random weights
EXTRACT_BF16_REL = 6e-2
# the clips of the pipeline phase: (seconds, scenes, seed)
RAW_CLIPS = ((62, 4, 1), (23, 2, 2), (37, 3, 3), (51, 5, 4))
NEW_BACKBONES = ("bilstm", "bigru", "lstm", "gru", "cnngru", "cnnbigru",
                 "mingru")


def write_clip(path, seconds, n_scenes, seed, fps=10.0, w=320, h=240):
    """A multi-scene clip written with cv2: n_scenes flat colours with hard
    cuts between them, a bar moving across each and a little noise, so
    scene cuts, 1 fps frames and motion differences all have content."""
    import cv2
    import numpy as np
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    fail_unless(writer.isOpened(), "cv2.VideoWriter cannot encode mp4v")
    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 225, (n_scenes, 3))
    n = int(seconds * fps)
    for i in range(n):
        img = np.empty((h, w, 3), np.uint8)
        img[:] = colors[min(i * n_scenes // n, n_scenes - 1)]
        x = (i * 9) % (w - 40)
        img[:, x:x + 40] = 255 - img[:, x:x + 40]
        img = np.clip(img + rng.integers(-6, 7, img.shape), 0, 255)
        writer.write(img.astype(np.uint8))
    writer.release()
    return path


def raw_video_kernel_phase(report, card):
    """Row 1 at the extractors' shapes against its plain version, f32 (the
    extract_features CLI's) and bf16, timed beside its bound and
    F.scaled_dot_product_attention on the same call (the shared bias cast
    to q's dtype, as SDPA takes it)."""
    import torch
    import torch.nn.functional as F
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(77)
    r = report["flash_attention"]
    n0 = flash_attention.launches
    for key, B, H, L, D, causal, bias_heads, scale in RAW_VIDEO_FORMS:
        bias = None if not bias_heads else \
            (0.02 * torch.randn(1, H, L, L, generator=gen)).to(dev)
        kw = dict(causal=causal, bias=bias, scale=scale)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, H, L, D, generator=gen).to(dev, dtype)
                       for _ in range(3))
            err = check_close(f"flash_attention {key[3:]} ({B}, {H}, {L}, "
                              f"{D})", dtype, flash_attention(q, k, v, **kw),
                              flash_attention_plain(q, k, v, **kw))
            errs = r.setdefault("err_" + key, {})
            errs[dtype] = max(err, errs.get(dtype, 0.0))
            note_times(report, "flash_attention", dtype,
                       lambda: flash_attention(q, k, v, **kw),
                       lambda: flash_attention_plain(q, k, v, **kw),
                       plain_iters=5, key=key)
            pairs = L * (L + 1) // 2 if causal else L * L
            work = (nbytes(q, k, v, q, bias), 4 * B * H * pairs * D)
            mask = None if bias is None else bias.to(q.dtype)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal, scale=scale))[0]
            if dtype == torch.float32:
                note_f32_yardsticks(report, "flash_attention", key, work, lib,
                                    sdpa_backend(q, k, v, mask,
                                                 is_causal=causal))
            else:
                r["form_bound_" + key] = form_bound(*work)
                r["library_" + key] = lib
        t = r[key][torch.bfloat16]
        print(f"  row 1 {key[3:]}: kernel {t[0]:.4f} ms, plain {t[2]:.4f}, "
              f"bound {r['form_bound_' + key][0]:.4f} "
              f"({r['form_bound_' + key][1]}), SDPA "
              f"{r['library_' + key]:.4f} ms [bf16, {card}]")
    flash_attention.launches = n0  # comparisons, not the path


def seeded_extractors(dev):
    """Full-width CLIP ViT-L/14@336 and MaxViT-T with the port's seeded
    initialisation, as float32 state dicts on ``dev``, and the six emotion
    text embeddings."""
    import torch
    from video2music_tpu_torch.features.clip import (CLIP,
                                                     clip_vit_l14_336_config)
    from video2music_tpu_torch.features.maxvit import MaxViT, maxvit_t_config
    from video2music_tpu_torch.weights import init_weights_
    gen = torch.Generator().manual_seed(0)
    with torch.device(dev):
        clip = CLIP(clip_vit_l14_336_config())
        mv = MaxViT(maxvit_t_config())
    init_weights_(clip, gen)
    init_weights_(mv, gen)
    text = torch.randn(6, 768, generator=gen).numpy()
    return clip.state_dict(), mv.state_dict(), text


def extractor_phase(card, report):
    """CLIP-L and MaxViT-T at full width on seeded weights: float32 on the
    card (through row 1) against the same modules on the CPU (the plain
    attention) on 2 frames, then bf16 against f32 on the card over a
    30-frame chunk, with the forward ms of each (CUDA events)."""
    import copy

    import numpy as np
    import torch
    from video2music_tpu_torch.features.clip import (
        CLIP, clip_vit_l14_336_config, normalize_pixels)
    from video2music_tpu_torch.features.maxvit import (
        MaxViT, maxvit_t_config, normalize_diff_pixels)
    from video2music_tpu_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    clip_sd, mv_sd, text = seeded_extractors(dev)
    text = torch.as_tensor(text, device=dev)
    rng = np.random.default_rng(5)
    out = report.setdefault("extractors", {})
    n0 = flash_attention.launches
    for name, cls, cfg, sd, size, norm, per_call in (
            ("CLIP ViT-L/14@336", CLIP, clip_vit_l14_336_config(), clip_sd,
             336, normalize_pixels, 24),
            ("MaxViT-T", MaxViT, maxvit_t_config(), mv_sd, 224,
             normalize_diff_pixels, 22)):
        model = cls(cfg)
        model.load_state_dict(sd)
        model.to(dev).eval()
        u8 = torch.from_numpy(rng.integers(0, 256, (30, size, size, 3),
                                           dtype=np.uint8)).to(dev)
        fwd = (lambda m, x: m.semantic_and_emotion(
            x, text.to(x.device))[0]) if cls is CLIP else (lambda m, x: m(x))
        with torch.no_grad():
            x32 = norm(u8)
            launches = flash_attention.launches
            got = fwd(model, x32[:2])
            fail_unless(flash_attention.launches - launches == per_call,
                        f"{name}: {flash_attention.launches - launches} row-1 "
                        f"launches a forward, {per_call} implied")
            cpu = copy.deepcopy(model).cpu()
            want = fwd(cpu, x32[:2].cpu())
            abs_err, rel = errors(got.cpu(), want)
            print(f"  {name} f32 card vs CPU (2 frames): max_abs "
                  f"{abs_err:.3e} max_rel {rel:.3e} (rel {EXTRACT_F32_REL}) "
                  f"{'ok' if rel <= EXTRACT_F32_REL else 'FAIL'}")
            fail_unless(rel <= EXTRACT_F32_REL,
                        f"{name}: f32 on the card differs from the CPU")
            del cpu
            f32 = fwd(model, x32)
            bf = copy.deepcopy(model).to(torch.bfloat16)
            got = fwd(bf, x32.to(torch.bfloat16)).float()
            abs_err, rel = errors(got, f32)
            print(f"  {name} bf16 vs f32 on the card (30 frames): max_abs "
                  f"{abs_err:.3e} max_rel {rel:.3e} (rel {EXTRACT_BF16_REL}) "
                  f"{'ok' if rel <= EXTRACT_BF16_REL else 'FAIL'}")
            fail_unless(bool(torch.isfinite(got).all())
                        and rel <= EXTRACT_BF16_REL,
                        f"{name}: bf16 differs from f32 on the card")
            row = out[name] = {}
            for dt, m, x in (("float32", model, x32),
                             ("bfloat16", bf, x32.to(torch.bfloat16))):
                row[f"ms_30_frames_{dt}"] = eager_ms(lambda: fwd(m, x),
                                                     iters=3)
            print(f"  {name} forward, 30 frames: "
                  f"{row['ms_30_frames_bfloat16']:.2f} ms bf16, "
                  f"{row['ms_30_frames_float32']:.2f} ms f32 (CUDA events)"
                  f" [{card}]")
        del model, bf
        torch.cuda.empty_cache()
    flash_attention.launches = n0  # the extractors alone, not the path


class VideoLog(WidthLog):
    """WidthLog that also records, for every extract_features_batch call,
    the frames and motion rows it ran (which set its row-1 launches)."""

    def __init__(self, v2m):
        super().__init__(v2m)
        self.extracts = []

    def extract_features_batch(self, video_paths):
        feats = self.v2m.extract_features_batch(video_paths)
        self.extracts.append((sum(f["semantic"].shape[0] for f in feats),
                              sum(f["motion"].shape[0] for f in feats)))
        return feats


def extract_launches(n_frames, n_motion, chunk):
    """Row-1 launches of extracting n_frames 1 fps frames and n_motion
    difference images in chunks of ``chunk``: 24 a CLIP-L chunk (its
    layers), 22 a MaxViT-T chunk (two partition attentions a block)."""
    return 24 * -(-n_frames // chunk) + 22 * -(-n_motion // chunk)


def raw_video_phase(card, report):
    """A full-width bf16 Video2music (AMT 2.2 + bimamba+, CLIP-L, MaxViT-T,
    motion_type 1, seeded weights): generate(video=...) on a 62 s
    multi-scene clip written with cv2, extract_features_batch over three
    clips against per-clip extraction, a DynamicBatcher with four video
    requests; every clip checked, the kernels' launches equal to what
    the path implies (row 1: the AMT encoder's 6 a call, 24 a CLIP chunk,
    22 a MaxViT chunk), the extraction's stage times and the walls."""
    import numpy as np
    import torch
    from video2music_tpu_torch.pipeline import video_io
    from video2music_tpu_torch.pipeline.api import MAX_SECONDS, Video2music
    from video2music_tpu_torch.pipeline.serving import DynamicBatcher
    print(f"  ffmpeg {'found' if video_io.has_ffmpeg() else 'missing'}, "
          f"fluidsynth {'found' if video_io.has_fluidsynth() else 'missing'}"
          f": {'muxing runs' if video_io.has_ffmpeg() and video_io.has_fluidsynth() else 'no audio render and no muxing on this machine (the CPU tests hold the muxing call)'}")
    dev = torch.device("cuda")
    clip_sd, mv_sd, text = seeded_extractors(dev)
    v2m = Video2music(seed=0, device="cuda", motion_type=1,
                      clip_params=clip_sd, maxvit_params=mv_sd,
                      emotion_text_embeds=text)
    del clip_sd, mv_sd
    out = report.setdefault("raw_video", {})
    with tempfile.TemporaryDirectory() as tmp:
        paths = [write_clip(os.path.join(tmp, f"clip{i}.mp4"), s, n, seed)
                 for i, (s, n, seed) in enumerate(RAW_CLIPS)]
        v2m.generate(paths[1], output_dir=os.path.join(tmp, "warm_up"))
        n_sec = RAW_CLIPS[0][0]
        feats = v2m.extract_features(paths[0])
        n_motion = feats["motion"].shape[0]
        fail_unless(feats["semantic"].shape == (n_sec, 768)
                    and feats["emotion"].shape == (n_sec, 6)
                    and feats["motion"].shape[1] == 512
                    and feats["scene_offset"].shape == (n_sec,),
                    f"features of shapes "
                    f"{[(k, v.shape) for k, v in feats.items()]}")
        fail_unless(all(np.isfinite(v).all() for v in feats.values()),
                    "non-finite features")
        fail_unless(np.allclose(feats["emotion"].sum(-1), 1, atol=1e-4),
                    "emotion rows do not sum to 1")
        cuts = int((np.diff(feats["scene_offset"]) < 0).sum())
        fail_unless(cuts >= RAW_CLIPS[0][1] - 1,
                    f"{cuts} scene cuts found, {RAW_CLIPS[0][1]} scenes "
                    f"written")
        for fn in wrappers().values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = v2m.generate(paths[0], primer="C Am", key="C major",
                           output_dir=os.path.join(tmp, "g0"))
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in wrappers().items()}
        check_clip("generate(video)", res, "C Am", n_sec,
                   v2m.last_regression["instrument"],
                   v2m.last_regression["ln_nd"])
        want = path_launches(v2m, 1)
        want["flash_attention"] += extract_launches(n_sec, n_motion - 1, 30)
        for name in KERNELS:
            print(f"  launches {name}: {counts[name]} (path implies "
                  f"{want[name]})")
            fail_unless(counts[name] == want[name],
                        f"{name}: {counts[name]} launches, the raw-video "
                        f"path implies {want[name]}")
        fail_unless(counts["flash_attention"] > 0, "row 1 never launched")
        report["flash_attention"]["launches_raw_video"] = \
            counts["flash_attention"]
        T = v2m.last_extract_timings
        out["generate_b1"] = dict(wall_s=wall, n_sec=n_sec, **{
            k: v for k, v in T.items()})
        print(f"generate(video, {n_sec} s, {cuts} cuts): wall {wall:.3f} s; "
              f"extract_features stages (host s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in T.items())
              + f"; decode {v2m.last_timings.get('decode', 0):.1f} ms "
              f"[{card}]")
        # extract_features_batch over three clips against per-clip
        t0 = time.perf_counter()
        batch = v2m.extract_features_batch(paths[1:])
        bwall = time.perf_counter() - t0
        out["extract_batch_3"] = dict(wall_s=bwall, **v2m.last_extract_timings)
        worst = 0.0
        for p, got in zip(paths[1:], batch):
            ref = v2m.extract_features(p)
            np.testing.assert_array_equal(got["scene_offset"],
                                          ref["scene_offset"])
            for k in ("semantic", "emotion", "motion"):
                fail_unless(got[k].shape == ref[k].shape,
                            f"batch {k} {got[k].shape} != {ref[k].shape}")
                d = float(np.abs(got[k] - ref[k]).max()
                          / max(np.abs(ref[k]).max(), 1e-30))
                worst = max(worst, d)
        print(f"extract_features_batch (3 clips, {bwall:.3f} s) against "
              f"per-clip: max_rel {worst:.3e} (rel {BF16_REL}; bf16 GEMMs "
              f"of other widths) {'ok' if worst <= BF16_REL else 'FAIL'}; "
              f"stages (host s): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in v2m.last_extract_timings.items())
              + f" [{card}]")
        fail_unless(worst <= BF16_REL, "batched extraction differs")
        # a DynamicBatcher with four video requests
        for fn in wrappers().values():
            fn.launches = 0
        log = VideoLog(v2m)
        batcher = DynamicBatcher(log, max_batch=4, max_wait_ms=2000,
                                 output_dir=os.path.join(tmp, "serve"))
        try:
            t0 = time.perf_counter()
            futures = [batcher.submit({"video": p, "primer": "G"})
                       for p in paths]
            served = [f.result(timeout=600) for f in futures]
            swall = time.perf_counter() - t0
        finally:
            batcher.stop()
        for (s, _, _), (r_, width) in zip(RAW_CLIPS, served):
            check_clip(f"batcher video request (width {width})", r_, "G", s)
        counts = {n: fn.launches for n, fn in wrappers().items()}
        want = dict.fromkeys(KERNELS, 0)
        for w in log.widths:
            for name, n in path_launches(v2m, w).items():
                want[name] += n
        want["flash_attention"] += sum(
            extract_launches(nf, nm, MAX_SECONDS) for nf, nm in log.extracts)
        for name in KERNELS:
            fail_unless(counts[name] == want[name],
                        f"batcher: {name} {counts[name]} launches, the path "
                        f"implies {want[name]}")
        out["batcher_4"] = dict(wall_s=swall, widths=log.widths,
                                extracts=log.extracts)
        print(f"DynamicBatcher, 4 video requests: {swall:.3f} s, batches of "
              f"widths {log.widths}, extractions of (frames, motion rows) "
              f"{log.extracts}; row-1 launches {counts['flash_attention']} "
              f"(path implies {want['flash_attention']}) [{card}]")
    del v2m
    torch.cuda.empty_cache()


def new_backbones_phase(card, report):
    """The RNN, CNN-GRU and minGRU regressions at full width (the
    RegressionConfig defaults: d_model 64, 2 layers) behind a full-width
    2.2 cut to 2+2 layers (the decode is not what this phase checks),
    seeded: one generate (B=1) and one generate_batch (B=16) each in
    float32 and bfloat16, every clip checked; the f32 regression outputs
    of the card against the same model on the CPU, bf16 against f32 on
    the card; the regression forward's ms at B=1 and B=16 (CUDA events).
    No kernel of the port runs in these backbones (cuDNN's GRU / LSTM,
    torch.logcumsumexp)."""
    import copy

    import numpy as np
    import torch
    from video2music_tpu_torch.pipeline.api import Video2music, _prepare
    out = report.setdefault("new_backbones", {})
    reqs, temps = serving_requests(16, 900)
    with tempfile.TemporaryDirectory() as tmp:
        for rm in NEW_BACKBONES:
            v2m = Video2music(seed=0, device="cuda", reg_model=rm,
                              amt_overrides=dict(n_layers=2))
            cpu = copy.deepcopy(v2m.model_reg).cpu()
            row = out[rm] = {}
            for B in (1, 16):
                got = {}
                for dt in ("float32", "bfloat16"):
                    results = v2m.generate_batch(
                        reqs[:B], temperature=temps[:B], compute_dtype=dt,
                        output_dir=os.path.join(tmp, f"{rm}{B}{dt}"))
                    check_batch(f"{rm} B={B} {dt}", v2m, reqs[:B], results)
                    got[dt] = v2m.last_regression
                prepped = [_prepare(r["features"], r.get("key"),
                                    r.get("primer", "")) for r in reqs[:B]]
                feats = {k: torch.as_tensor(np.stack([p[k] for p in prepped]))
                         for k in ("semantic", "emotion")}
                with torch.no_grad():
                    want = [t.numpy() for t in cpu(
                        feats["semantic"], None, None, feats["emotion"])]
                for i, part in enumerate(("ln_nd", "instrument")):
                    # 300 recurrent steps (minGRU: a 300-step log-space
                    # cumsum, in a parallel order on the card): the error
                    # scales with the largest magnitude
                    w = torch.as_tensor(want[i])
                    check_close(f"{rm} B={B} {part}, card vs CPU",
                                torch.float32,
                                torch.as_tensor(got["float32"][part]), w,
                                atol=F32_RTOL * w.abs().max().item())
                    check_close(f"{rm} B={B} {part}, bf16 vs f32 on the card",
                                torch.bfloat16,
                                torch.as_tensor(got["bfloat16"][part]),
                                torch.as_tensor(got["float32"][part]))
                sem = feats["semantic"].cuda()
                emo = feats["emotion"].cuda()
                for dt in ("float32", "bfloat16"):
                    m = v2m._models(dt)[1]
                    d = getattr(torch, dt)
                    with torch.no_grad():
                        row[f"ms_b{B}_{dt}"] = eager_ms(
                            lambda: m(sem.to(d), None, None, emo.to(d)),
                            iters=10)
                print(f"  {rm} regression forward B={B}: "
                      f"{row[f'ms_b{B}_bfloat16']:.3f} ms bf16, "
                      f"{row[f'ms_b{B}_float32']:.3f} ms f32 (eager, CUDA "
                      f"events) [{card}]")
            del v2m, cpu
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

def write_feature_tree(root, n_clips, n_sec, seed):
    """A MuVi-Sync-layout feature tree (the layout of the test fixture
    tests/test_data.py:_write_fixture_tree) of n_clips clips of n_sec
    seconds, motion_type 1 (512-d motion .npy), from a seed; every clip in
    the train split, the first half in val and test."""
    import numpy as np
    from video2music_tpu_torch.core.vocab import chord_dict

    d = {k: os.path.join(root, *v) for k, v in dict(
        chord=("vevo_chord", "lab_v2_norm", "origin"),
        chord_nn=("vevo_chord", "lab_v2", "origin"),
        emotion=("vevo_emotion", "6c_l14p", "origin"),
        motion=("vevo_motion", "option1"),
        scene=("vevo_scene_offset", "origin"),
        loud=("vevo_loudness", "origin"),
        nd=("vevo_note_density", "origin"),
        instr=("vevo_instrument", "thresholding"),
        sem=("vevo_semantic", "origin", "2d", "clip_l14p"),
        split=("vevo_meta", "split", "v1")).items()}
    for path in d.values():
        os.makedirs(path, exist_ok=True)
    ids = [f"clip{i:03d}" for i in range(n_clips)]
    for split, part in (("train", ids), ("val", ids[:n_clips // 2]),
                        ("test", ids[:n_clips // 2])):
        with open(os.path.join(d["split"], split + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    symbols = [sym for sym in chord_dict() if sym not in ("N",)]
    r = np.random.default_rng(seed)

    def lab(key, fid, lines):
        with open(os.path.join(d[key], fid + ".lab"), "w") as f:
            f.write("\n".join(lines) + "\n")

    for fid in ids:
        chords = r.choice(len(symbols), n_sec)
        lab("chord", fid, ["key C major"] + [
            f"{t} {symbols[c]}" for t, c in enumerate(chords)])
        lab("chord_nn", fid, ["key D major", "0 D"])
        emo = r.dirichlet(np.ones(6), n_sec)
        lab("emotion", fid,
            ["time exciting fearful tense sad relaxing neutral"] + [
                f"{t} " + " ".join(f"{p:.4f}" for p in row)
                for t, row in enumerate(emo)])
        lab("scene", fid, [f"{t} {t // 10}" for t in range(n_sec)])
        for key in ("loud", "nd"):
            lab(key, fid, [f"{t} {v:.4f}"
                           for t, v in enumerate(r.uniform(size=n_sec))])
        with open(os.path.join(d["instr"], fid + ".csv"), "w") as f:
            f.write(",".join(f"i{i}" for i in range(40)) + "\n")
            for row in r.uniform(size=(n_sec, 40)) > 0.8:
                f.write(",".join(str(int(v)) for v in row) + "\n")
        np.save(os.path.join(d["sem"], fid + ".npy"),
                r.standard_normal((n_sec, 768)).astype(np.float32))
        np.save(os.path.join(d["motion"], fid + ".npy"),
                r.standard_normal((n_sec, 512)).astype(np.float32))


def train_phase(card, report):
    """train_amt for one epoch at B=16 on 32 synthetic clips, a checkpoint
    restore, then the learning guard: 60 steps on one fixed batch from a
    fresh state (bench.py's guard), its loss drop and ms/step. The launch
    counters, zeroed before train_amt and read after the 60 steps, must
    show 18 forward and 18 backward dropout-kernel launches per step and
    18 flash_attention launches per eval batch."""
    import csv

    import torch
    from video2music_tpu_torch.core.config import TrainConfig, amt_config
    from video2music_tpu_torch.data import batches, create_vevo_datasets
    from video2music_tpu_torch.data.loader import to_device
    from video2music_tpu_torch.train import (CSV_HEADER, LoopConfig,
                                             create_train_state,
                                             make_amt_train_step,
                                             restore_checkpoint, train_amt)

    cfg = amt_config("2.2", total_vf_dim=768 + 1 + 512 + 6)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-4, mixed_precision=True)
    B, n_attn = 16, 3 * len(cfg.decoder_layers)
    with tempfile.TemporaryDirectory() as tmp:
        root, out = os.path.join(tmp, "vevo"), os.path.join(tmp, "run")
        t0 = time.perf_counter()
        write_feature_tree(root, 32, 300, seed=5)
        train_ds, val_ds, _ = create_vevo_datasets(root, motion_type=1)
        print(f"wrote a feature tree of {len(train_ds)} clips of 300 s in "
              f"{time.perf_counter() - t0:.1f} s")
        for fn in wrappers().values():
            fn.launches = 0
        t0 = time.perf_counter()
        state = train_amt(cfg, tcfg, LoopConfig(epochs=1, batch_size=B,
                                                output_dir=out),
                          train_ds, val_ds, device="cuda")
        torch.cuda.synchronize()
        epoch_steps, trained = state.step, state
        print(f"train_amt: one epoch of {epoch_steps} steps at B={B} plus "
              f"the eval passes in {time.perf_counter() - t0:.2f} s [{card}]")
        with open(os.path.join(out, "results.csv")) as f:
            rows = list(csv.reader(f))
        fail_unless(rows[0] == CSV_HEADER and len(rows) == 2,
                    f"results.csv rows {rows}")
        fail_unless(all(torch.isfinite(torch.tensor(float(v)))
                        for v in rows[1][2:]), f"results.csv {rows[1]}")
        print(f"results.csv: {dict(zip(rows[0], rows[1]))}")
        fresh = restore_checkpoint(
            os.path.join(out, "weights", "epoch_0001"),
            create_train_state(cfg, tcfg, device="cuda"))
        fail_unless(fresh.step == epoch_steps
                    and all(torch.equal(v, state.model.state_dict()[k])
                            for k, v in fresh.model.state_dict().items()),
                    "the epoch checkpoint does not restore the trained state")
        print("checkpoint epoch_0001 restores the trained weights, "
              "optimizer and step")

        batch = to_device(next(batches(train_ds, B, shuffle=False)), "cuda")
        state = create_train_state(cfg, tcfg, device="cuda")
        step = make_amt_train_step(tcfg)
        losses, events = [], [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
        for i in range(60):
            if i == 10:
                events[0].record()
            state, m = step(state, batch)
            losses.append(m["loss"])
        events[1].record()
        events[1].synchronize()
        ms_step = events[0].elapsed_time(events[1]) / 50
        counts = {name: fn.launches for name, fn in wrappers().items()}
        profile_train_steps(step, state, batch, card)
        serve_trained_phase(tmp, out, train_ds, val_ds, trained, tcfg, card)
    losses = torch.stack(losses).float().cpu()
    fail_unless(bool(torch.isfinite(losses).all()), f"losses {losses}")
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    drop = 100.0 * (first - last) / max(first, 1e-9)
    print(f"learning guard: 60 steps on one batch, loss {first:.4f} -> "
          f"{last:.4f} (drop {drop:.2f}%), {ms_step:.2f} ms/step over "
          f"steps 10-59 (CUDA events, bf16, B={B}) [{card}]")
    fail_unless(drop > 0, f"loss did not drop: {first} -> {last}")
    n_steps = epoch_steps + 60
    # train_amt's eval passes: the train split, then the val split
    eval_batches = -(-len(train_ds) // B) + -(-len(val_ds) // B)
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=n_attn * eval_batches,
                flash_attention_dropout_fwd=n_attn * n_steps,
                flash_attention_dropout_bwd=n_attn * n_steps)
    for name in KERNELS:
        print(f"  launches {name}: {counts[name]} (path implies "
              f"{want[name]}: {n_steps} steps, {eval_batches} eval batches)")
        fail_unless(counts[name] == want[name],
                    f"{name}: {counts[name]} launches, path implies "
                    f"{want[name]}")
    for name in TRAIN_KERNELS:
        report[name]["launches"] = counts[name]
    report["train"] = dict(ms_step=ms_step, loss_drop_pct=drop,
                           loss_first=first, loss_last=last)


def zoo_batch(kind, B, L, seed):
    """A full-width bf16-ready training batch on the card from a seed: the
    AMT's (video L, chord L - 1, motion 512-d), the MusicTransformer's
    (chords only) or the regression's (video L, note density, loudness,
    instruments)."""
    import numpy as np
    import torch
    from video2music_tpu_torch.core.vocab import emotion_chord_targets

    r = np.random.default_rng(seed)
    Lc = L - 1
    chords = dict(x=r.integers(0, CHORD_END, (B, Lc)),
                  x_root=r.integers(0, 13, (B, Lc)),
                  x_attr=r.integers(0, 14, (B, Lc)),
                  tgt=r.integers(0, CHORD_END, (B, Lc)),
                  key=r.integers(0, 2, (B, 1)).astype(np.float32))
    video = dict(semantic=r.standard_normal((B, L, 768)).astype(np.float32),
                 scene_offset=(np.arange(L) // 10).astype(np.float32)[None]
                 .repeat(B, 0),
                 motion=r.standard_normal((B, L, 512)).astype(np.float32),
                 emotion=r.dirichlet(np.ones(6), (B, L)).astype(np.float32))
    if kind == "mt":
        batch = chords
    elif kind == "reg":
        batch = dict(video, note_density=r.uniform(size=(B, L)).astype(
            np.float32), loudness=r.uniform(size=(B, L)).astype(np.float32),
            instrument=(r.uniform(size=(B, L, 40)) > 0.8).astype(np.float32))
    else:
        batch = dict(chords, **video, tgt_emotion=emotion_chord_targets()[
            r.integers(0, 6, (B, Lc))],
            tgt_emotion_prob=r.uniform(0.3, 1.0, (B, Lc)).astype(np.float32))
    return {k: torch.as_tensor(v).cuda() for k, v in batch.items()}


def train_zoo_phase(card, report):
    """A few bf16 train steps (AdamW, B=16, L=300) of each model family at
    full width: V3.1 (row 11 at 2H heads), 2.1 under the top-k scheduler,
    the base AMT (row 11 with the full RPR bias), the MusicTransformer
    (RPR, 6 layers), and the bimamba+ (row 12) and bilstm regressions. Per
    model: ms/step over the timed steps (CUDA events), finite losses, the
    launches of rows 11 and 12 in those steps equal to what the path
    implies, and the forms row 11 was called in (heads, bias). Then one
    step of each of the six optimizers on the MusicTransformer, and the
    share of a bimamba+ step the scan's plain-recompute backward takes."""
    import numpy as np
    import torch
    from video2music_tpu_torch.core.config import (MusicTransformerConfig,
                                                   RegressionConfig,
                                                   TrainConfig, amt_config)
    from video2music_tpu_torch.ops import attention
    from video2music_tpu_torch.ops.scan import selective_scan
    from video2music_tpu_torch.train import (create_train_state,
                                             make_amt_train_step,
                                             make_music_transformer_train_step,
                                             make_optimizer,
                                             make_regression_train_step)
    from video2music_tpu_torch.train.optim import OPTIMIZERS

    tcfg = TrainConfig(optimizer="adamw", lr=1e-4, mixed_precision=True)
    B, L, n_steps = 16, 300, 6
    vf = 768 + 1 + 512 + 6
    cases = (("3.1", amt_config("3.1", total_vf_dim=vf), "amt"),
             ("2.1", amt_config("2.1", total_vf_dim=vf), "amt"),
             ("base", amt_config(None, total_vf_dim=vf), "amt"),
             ("music_transformer", MusicTransformerConfig(), "mt"),
             ("bimamba+", RegressionConfig(reg_model="bimamba+"), "reg"),
             ("bilstm", RegressionConfig(reg_model="bilstm"), "reg"))
    makers = {"amt": make_amt_train_step,
              "mt": make_music_transformer_train_step,
              "reg": make_regression_train_step}
    real = attention.flash_attention_dropout
    forms = []

    def spy(q, k, v, *, bias=None, **kw):
        forms.append((q.shape[1], v.shape[1], None if bias is None else
                      (tuple(bias.shape), str(bias.dtype)[6:])))
        return real(q, k, v, bias=bias, **kw)

    fwd_name, bwd_name = TRAIN_KERNELS
    zoo = {}
    for name, cfg, kind in cases:
        state = create_train_state(cfg, tcfg, device="cuda")
        step = makers[kind](tcfg)
        batch = zoo_batch(kind, B, L, seed=len(zoo))
        for _ in range(2):  # warm-up
            state, m = step(state, batch)
        torch.cuda.synchronize()
        for fn in wrappers().values():
            fn.launches = 0
        forms.clear()
        attention.flash_attention_dropout = spy
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        losses = []
        try:
            events[0].record()
            for _ in range(n_steps):
                state, m = step(state, batch)
                losses.append(m["loss"])
            events[1].record()
            events[1].synchronize()
        finally:
            attention.flash_attention_dropout = real
        ms_step = events[0].elapsed_time(events[1]) / n_steps
        counts = {k: fn.launches for k, fn in wrappers().items()}
        losses = torch.stack(losses).float().cpu()
        fail_unless(bool(torch.isfinite(losses).all()),
                    f"{name}: losses {losses}")
        if kind == "amt":
            n_attn = len(cfg.encoder_layers) + 2 * len(cfg.decoder_layers)
        else:
            n_attn = cfg.n_layers if kind == "mt" else 0
        n_scan = (2 * cfg.n_layers if kind == "reg"
                  and "mamba" in cfg.reg_model else 0)
        want = dict.fromkeys(KERNELS, 0)
        want.update({fwd_name: n_attn * n_steps, bwd_name: n_attn * n_steps,
                     "selective_scan": n_scan * n_steps})
        for k in KERNELS:
            fail_unless(counts[k] == want[k], f"{name}: {k} launched "
                        f"{counts[k]} times, the path implies {want[k]}")
        for k in TRAIN_KERNELS + ("selective_scan",):
            if counts[k]:
                report[k]["launches_train_zoo"] = \
                    report[k].get("launches_train_zoo", 0) + counts[k]
        seen = sorted(set(forms), key=str)
        print(f"train zoo {name}: {ms_step:.2f} ms/step (bf16, B={B}, "
              f"L={L}, AdamW, CUDA events over {n_steps} steps), loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches: row 11 "
              f"{counts[fwd_name]} + {counts[bwd_name]}, row 12 "
              f"{counts['selective_scan']}; row 11 forms (q heads, v heads, "
              f"bias): {seen} [{card}]")
        if name == "3.1":
            H = cfg.num_heads
            fail_unless(all(f[0] == f[1] == 2 * H and f[2] is None
                            for f in forms),
                        f"V3.1 trained row 11 in the forms {seen}")
        if name in ("base", "music_transformer"):
            rpr = [f for f in forms if f[2] is not None]
            n_rpr = len(cfg.decoder_layers) if name == "base" else \
                cfg.n_layers
            # the full (B, H, L, L) bias in the model's dtype; the wrapper
            # hands the kernel its f32 copy
            fail_unless(len(rpr) == n_rpr * n_steps and all(
                f[2][0] == (B, cfg.num_heads, L - 1, L - 1) for f in rpr),
                f"{name}: RPR forms {seen}")
        zoo[name] = dict(ms_step=ms_step, loss_first=float(losses[0]),
                         loss_last=float(losses[-1]),
                         launches_row11=counts[fwd_name] + counts[bwd_name],
                         launches_row12=counts["selective_scan"])
        if kind == "mt":  # every optimizer takes a step on the card
            for opt_name in OPTIMIZERS:
                params = [p.detach().clone() for p in state.model.parameters()]
                opt = make_optimizer(TrainConfig(optimizer=opt_name,
                                                 lr=1e-4), params, 512)
                grads = [torch.randn_like(p) for p in params]
                opt.step(grads)
                opt.step(grads)
                fail_unless(all(bool(torch.isfinite(p).all())
                                for p in params), f"{opt_name} on the card")
            print(f"  optimizers {OPTIMIZERS}: two steps each on the "
                  f"MusicTransformer's parameters, finite")
        if name == "bimamba+":
            # the scan at the step's shapes: b=16, L=300, d_inner 128,
            # d_state 16, bf16 inputs (A, the f32 -exp(A_log))
            ED, N = 2 * cfg.d_model, 16
            g = torch.Generator(device="cuda").manual_seed(5)
            mk = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
            x, dl_ = mk(B, L, ED).bfloat16(), (mk(B, L, ED).abs() * 0.1) \
                .bfloat16()
            Bm, Cm = mk(B, L, N).bfloat16(), mk(B, L, N).bfloat16()
            A, Dv = -torch.rand(ED, N, device="cuda") - 0.5, \
                torch.ones(ED, device="cuda").bfloat16()
            leaves = [t.requires_grad_() for t in (x, dl_, Bm, Cm)]
            gy = mk(B, L, ED).bfloat16()

            def fwd():
                with torch.no_grad():
                    return selective_scan(x, dl_, A, Bm, Cm, Dv)

            def fwd_bwd():
                y = selective_scan(x, dl_, A, Bm, Cm, Dv)
                return torch.autograd.grad(y, leaves, gy)
            t_f, t_fb = eager_ms(fwd, 5), eager_ms(fwd_bwd, 5)
            share = n_scan * (t_fb - t_f) / ms_step
            zoo[name].update(scan_fwd_ms=t_f, scan_bwd_ms=t_fb - t_f,
                             scan_bwd_share=share)
            print(f"  the scan at the step's shapes (b={B}, L={L}, ED={ED}, "
                  f"N={N}, bf16): forward {t_f:.3f} ms, plain-recompute "
                  f"backward {t_fb - t_f:.3f} ms (eager, CUDA events); "
                  f"{n_scan} scans a step: the backward is {share:.3f} of "
                  f"the {ms_step:.2f} ms step [{card}]")
        del state, step, batch
        torch.cuda.empty_cache()
    report["train_zoo"] = zoo


def serve_trained_phase(tmp, out, train_ds, val_ds, state, tcfg, card):
    """The checkpoint train_amt wrote (``out``) and a train_regression
    run's (bimamba+, one epoch at B=16) served: Video2music(amt_checkpoint
    =..., reg_checkpoint=...) generates the trained models' chords and
    regression outputs token for token with a Video2music given the
    trained state dicts; a Video2music of other random weights behind a
    DynamicBatcher answers, load_checkpoints through submit_control swaps
    the checkpoints in, and its next answer is the served one."""
    import numpy as np
    from video2music_tpu_torch.core.config import RegressionConfig
    from video2music_tpu_torch.pipeline.api import Video2music
    from video2music_tpu_torch.pipeline.serving import DynamicBatcher
    from video2music_tpu_torch.train import LoopConfig, train_regression

    t0 = time.perf_counter()
    reg_out = os.path.join(tmp, "reg_run")
    reg_state = train_regression(
        RegressionConfig(reg_model="bimamba+"), tcfg,
        LoopConfig(epochs=1, batch_size=16, output_dir=reg_out),
        train_ds, val_ds, device="cuda")
    amt_ckpt = os.path.join(out, "weights", "best_loss_weights")
    reg_ckpt = os.path.join(reg_out, "weights", "best_rmse_weights")
    served = Video2music(amt_checkpoint=amt_ckpt, reg_checkpoint=reg_ckpt,
                         seed=1, device="cuda")
    mem = Video2music(seed=2, device="cuda")
    mem.load_state_dicts(state.model.state_dict(),
                         reg_state.model.state_dict())
    feats = synthetic_features(90, seed=8)
    a = served.generate(features=feats, output_dir=os.path.join(tmp, "a"))
    reg_a = dict(served.last_regression)
    b = mem.generate(features=feats, output_dir=os.path.join(tmp, "b"))
    check_ids("served checkpoint", a.chord_ids, [], 90)
    fail_unless(np.array_equal(a.chord_ids, b.chord_ids),
                "the served checkpoint's chords differ from the trained "
                "model's")
    fail_unless(all(np.array_equal(reg_a[k], v)
                    for k, v in mem.last_regression.items()),
                "the served regression checkpoint's outputs differ")
    print(f"served checkpoints: Video2music(amt_checkpoint=..., "
          f"reg_checkpoint=...) generates the trained models' {len(a.chord_ids)}"
          f" chords and regression outputs token for token (bf16) [{card}]")
    fresh = Video2music(seed=3, device="cuda")
    batcher = DynamicBatcher(fresh, max_batch=4, max_wait_ms=5,
                             output_dir=os.path.join(tmp, "serve"))
    try:
        before, _ = batcher.submit({"features": feats}).result(timeout=600)
        batcher.submit_control(lambda v: v.load_checkpoints(
            amt_ckpt, reg_ckpt)).result(timeout=600)
        after, _ = batcher.submit({"features": feats}).result(timeout=600)
    finally:
        batcher.stop()
    fail_unless(np.array_equal(after.chord_ids, a.chord_ids),
                "load_checkpoints behind the DynamicBatcher did not serve "
                "the checkpoint's chords")
    fail_unless(not np.array_equal(before.chord_ids, after.chord_ids),
                "the batcher's answer did not change with its weights")
    print(f"load_checkpoints through DynamicBatcher.submit_control: the "
          f"next answer is the checkpoint's, token for token "
          f"({time.perf_counter() - t0:.1f} s with the regression's "
          f"training) [{card}]")


def profile_train_steps(step, state, batch, card, n=3):
    """torch.profiler over n train steps: the device time per step by
    kernel (the 15 largest) and the device's busy share of the window.
    Informational: the launch counters are read before it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device-side events only (kernels, copies); the operator rows above
    # them would count the same time twice
    rows = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile of {n} train steps (profiler on): wall {wall_ms:.2f} "
          f"ms/step, device {busy:.2f} ms/step in {launches:.0f} kernels "
          f"and copies, busy share {busy / wall_ms:.3f} [{card}]")
    for ms, count, key in rows[:15]:
        print(f"  {ms:8.3f} ms/step  {count:6.0f} calls/step  {key[:90]}")
    ours = [r for r in rows if "v2m::" in r[2]]  # the port's own kernels
    print(f"  the port's kernels: {sum(r[0] for r in ours):.3f} ms/step in "
          f"{sum(r[1] for r in ours):.0f} launches a step")
    for ms, count, key in ours:
        print(f"  {ms:8.3f} ms/step  {count:6.0f} calls/step  {key[:90]}")


def loss_and_grads(state, batch, tcfg):
    """One training forward and backward of a train state (the step
    without its update; under mixed precision the parameters and float
    inputs cast to bf16, as make_amt_train_step does): (loss, {name:
    gradient of the f32 parameter})."""
    import torch
    from torch.func import functional_call
    from video2music_tpu_torch.train.step import (MODEL_INPUTS, amt_loss,
                                                  maybe_bf16_batch)

    params = dict(state.model.named_parameters())
    fwd = ({n: p.to(torch.bfloat16) for n, p in params.items()}
           if tcfg.mixed_precision else params)
    inputs = maybe_bf16_batch(batch, tcfg)
    logits = functional_call(
        state.model, fwd, tuple(inputs[k] for k in MODEL_INPUTS),
        {"deterministic": False, "generator": state.generator}, strict=False)
    loss = amt_loss(logits, batch, tcfg)[0]
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach().float(), dict(zip(params, grads))


# The teacher-forced train step's limits: (loss, worst gradient, median
# gradient), each relative (see step_gap).
# f32: the same arithmetic in another summation order through 12 layers.
# bf16 (mixed precision): the kernel's forward output agrees with the plain
# one's but for summation order, then rounds to bf16 like every activation
# of the model; its backward rounds P * mask and dS to bf16 operands and
# takes D from the bf16 output, where the plain backward is all f32. That
# bf16 rounding, carried through 12 bf16 layers and flipping near-tied
# router choices, moves the gradients by a few 1e-2 of a tensor's largest
# entry and the routers' gate gradients most. On an NVIDIA H100 80GB HBM3
# at 700 W the kernel step read loss 3.2e-4, worst 8.5e-2, median 2.5e-2
# from the plain step; the plain bf16 step reads 3.7e-4, 0.205, 0.034 from
# the plain f32 step (printed beside as the control). The limits sit
# between the two: the control fails the worst and the median limits, so a
# kernel that adds as much error as switching the model from f32 to bf16
# fails too, and a wrong gradient (O(1)) is far outside them.
TRAIN_STEP_TOL = {"float32": (1e-5, 1e-3, 1e-3),
                  "bfloat16": (1e-3, 0.15, 0.03)}


def teacher_forced_train_phase(card):
    """One training step (B=4, full width) through the dropout kernels and
    through the plain dropout attention, from the same weights, batch and
    generator seed, in f32 and in bf16 mixed precision: every other
    dropout draws the same torch mask and the attention masks come from
    the same hash. The loss, the worst gradient and the median gradient
    (each relative to its tensor's largest entry, that scale floored at
    1e-3 of the model's largest gradient) must agree within
    TRAIN_STEP_TOL."""
    import numpy as np
    import torch
    from video2music_tpu_torch.core.config import TrainConfig, amt_config
    from video2music_tpu_torch.core.vocab import emotion_chord_targets
    from video2music_tpu_torch.ops import attention
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.train import create_train_state

    cfg = amt_config("2.2", total_vf_dim=768 + 1 + 512 + 6)
    B, L = 4, cfg.max_seq_chord
    r = np.random.default_rng(11)
    batch = dict(
        x=r.integers(0, CHORD_END, (B, L - 1)),
        x_root=r.integers(0, 13, (B, L - 1)),
        x_attr=r.integers(0, 14, (B, L - 1)),
        tgt=r.integers(0, CHORD_END, (B, L - 1)),
        tgt_emotion=emotion_chord_targets()[r.integers(0, 6, (B, L - 1))],
        semantic=r.standard_normal((B, L, 768)).astype(np.float32),
        key=r.integers(0, 2, (B, 1)).astype(np.float32),
        scene_offset=(np.arange(L) // 10).astype(np.float32)[None].repeat(
            B, 0),
        motion=r.standard_normal((B, L, 512)).astype(np.float32),
        emotion=r.dirichlet(np.ones(6), (B, L)).astype(np.float32))
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    for mixed in (False, True):
        tcfg = TrainConfig(optimizer="adamw", lr=1e-4, mixed_precision=mixed)
        dtype = "bfloat16" if mixed else "float32"
        results = []
        for plain in (False, True):
            state = create_train_state(cfg, tcfg, device="cuda")
            if plain:
                attention.flash_attention_dropout = \
                    fad.flash_attention_dropout_plain
            try:
                results.append(loss_and_grads(state, batch, tcfg))
            finally:
                attention.flash_attention_dropout = fad.flash_attention_dropout
        (loss_k, _), (loss_p, _) = results
        rel, worst, worst_name, median = step_gap(results[0], results[1])
        loss_tol, grad_tol, median_tol = TRAIN_STEP_TOL[dtype]
        print(f"teacher-forced train step {dtype} B={B}: loss "
              f"{loss_k.item():.6f} (kernel) vs {loss_p.item():.6f} (plain), "
              f"rel {rel:.2e} (tol {loss_tol:g}); worst gradient "
              f"{worst_name} rel {worst:.2e} (tol {grad_tol:g}), median "
              f"{median:.2e} (tol {median_tol:g}) [{card}]")
        if mixed:  # the yardstick: the bf16 model's own distance from f32
            y_rel, y_worst, y_name, y_median = step_gap(results[1], f32_plain)
            print(f"  for scale, the plain bf16 step against the plain f32 "
                  f"step: loss rel {y_rel:.2e}, worst gradient {y_name} rel "
                  f"{y_worst:.2e}, median {y_median:.2e}")
        else:
            f32_plain = results[1]
        fail_unless(rel <= loss_tol, f"{dtype} train step loss differs by "
                    f"{rel}")
        fail_unless(worst <= grad_tol, f"{dtype} gradient {worst_name} "
                    f"differs by {worst}")
        fail_unless(median <= median_tol, f"{dtype} gradients differ by "
                    f"{median} (median)")


def step_gap(got, want):
    """(loss rel, worst gradient rel, its name, median gradient rel) of two
    (loss, grads) results; a gradient's error is relative to its tensor's
    largest entry, that scale floored at 1e-3 of the model's largest
    gradient (the key-projection biases have a gradient that is zero but
    for float noise: softmax is invariant to them)."""
    import numpy as np
    (loss_g, grads_g), (loss_w, grads_w) = got, want
    rel = abs(loss_g.item() - loss_w.item()) / abs(loss_w.item())
    floor = 1e-3 * max(g.abs().max().item() for g in grads_w.values())
    errs = {name: (grads_g[name].float() - gw.float()).abs().max().item()
            / max(gw.abs().max().item(), floor)
            for name, gw in grads_w.items()}
    worst_name = max(errs, key=errs.get)
    return rel, errs[worst_name], worst_name, float(np.median(list(
        errs.values())))


# ---------------------------------------------------------------------------
# phase 12: the command line, on the card
# ---------------------------------------------------------------------------

# the CLIs phase's feature tree: 64 clips of 300 s, so that one epoch at
# B=16 has the four steps -profile 3 traces (steps 1..3 after step 0)
CLI_CLIPS = 64
CLI_PRIMER = "C Am F G"
# row 11's kernels in a float32 trace (the CLI trains in f32): the
# forward, and the backward's dK/dV and dQ kernels
ROW11_TRACE_NAMES = ("attention_dropout_fwd", "attention_dropout_dkv",
                     "attention_dropout_dq")


def zero_launches():
    for fn in wrappers().values():
        fn.launches = 0


def check_path_launches(tag, want, report=None):
    """The counters against ``want`` (name -> launches; every other kernel
    0), each kernel of ``want`` above 0 launched at least once; adds the
    counts to ``report[name]["launches_clis"]``."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in KERNELS:
        w = want.get(name, 0)
        fail_unless(counts[name] == w, f"{tag}: {name} launched "
                    f"{counts[name]} times, the path implies {w}")
        if w and report is not None:
            report[name]["launches_clis"] = \
                report[name].get("launches_clis", 0) + counts[name]
    print(f"  {tag} launches: " + ", ".join(
        f"{n} {counts[n]}" for n in KERNELS if counts[n]) +
        " (each as the path implies; every other kernel 0)")


def read_scalar_events(path):
    """(tag, step, value) of every scalar event in a TFRecord event file
    (the first record, the file version, is skipped); each record's length
    and payload checked against their masked CRC32C."""
    import struct
    from video2music_tpu_torch.obs.tensorboard import masked_crc32c

    def varint(b, i):
        n = shift = 0
        while True:
            n |= (b[i] & 0x7F) << shift
            shift += 7
            i += 1
            if not b[i - 1] & 0x80:
                return n, i

    def fields(b):
        out, i = {}, 0
        while i < len(b):
            key, i = varint(b, i)
            wire = key & 7
            if wire == 0:
                v, i = varint(b, i)
            elif wire == 1:
                v, i = struct.unpack_from("<d", b, i)[0], i + 8
            elif wire == 5:
                v, i = struct.unpack_from("<f", b, i)[0], i + 4
            else:
                n, i = varint(b, i)
                v, i = b[i:i + n], i + n
            out[key >> 3] = v
        return out

    with open(path, "rb") as f:
        data = f.read()
    events, off = [], 0
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        payload = data[off + 12:off + 12 + n]
        fail_unless(struct.unpack_from("<I", data, off + 8)[0]
                    == masked_crc32c(data[off:off + 8])
                    and struct.unpack_from("<I", data, off + 12 + n)[0]
                    == masked_crc32c(payload), f"{path}: a bad CRC")
        ev = fields(payload)
        if 5 in ev:
            value = fields(fields(ev[5])[1])
            events.append((value[1].decode(), ev[2], value[2]))
        off += 16 + n
    return events


def trace_kernel_names(path):
    """The names of the device kernels in a torch.profiler Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    return {e["name"] for e in trace["traceEvents"]
            if e.get("cat") == "kernel"}


def trace_device_share(path, names):
    """(share, us, total us): the device time of the kernels whose names
    hold one of ``names`` over the device time of every kernel in a
    torch.profiler Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    kern = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    total = sum(e.get("dur", 0) for e in kern)
    ours = sum(e.get("dur", 0) for e in kern
               if any(n in e["name"] for n in names))
    return ours / max(total, 1e-9), ours, total


def http_call(port, method, path, body=None, timeout=600):
    """(status, decoded JSON, or the NDJSON lines of a stream)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body).encode())
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    if resp.getheader("Content-Type") == "application/x-ndjson":
        return resp.status, [json.loads(x) for x in raw.splitlines() if x]
    return resp.status, json.loads(raw)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_train_phase(root, tmp, cfg, card, report):
    """train_amt (with the step profiler and the default TensorBoard) and
    train_regression through their CLIs; returns the two checkpoints."""
    import csv

    import torch
    from video2music_tpu_torch.cli import train_amt as train_amt_cli
    from video2music_tpu_torch.cli import train_regression as train_reg_cli
    from video2music_tpu_torch.train import CSV_HEADER, REG_CSV_HEADER

    out, prof = os.path.join(tmp, "amt"), os.path.join(tmp, "profile")
    n_attn = 3 * len(cfg.decoder_layers)
    steps = -(-CLI_CLIPS // 16)
    eval_batches = steps + -(-(CLI_CLIPS // 2) // 16)
    zero_launches()
    t0 = time.perf_counter()
    state = train_amt_cli.main([
        "-dataset_dir", root, "-output_dir", out, "-music_gen_version",
        "2.2", "-motion_type", "1", "-epochs", "1", "-batch_size", "16",
        "-profile", "3", "-profile_dir", prof, "-device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fail_unless(state.step == steps, f"train_amt CLI: {state.step} steps")
    check_path_launches("train_amt CLI", dict(
        flash_attention=n_attn * eval_batches,
        flash_attention_dropout_fwd=n_attn * steps,
        flash_attention_dropout_bwd=n_attn * steps), report)
    with open(os.path.join(out, "results.csv")) as f:
        rows = list(csv.reader(f))
    fail_unless(rows[0] == CSV_HEADER and len(rows) == 2
                and all(torch.isfinite(torch.tensor(float(v)))
                        for v in rows[1][2:]), f"results.csv {rows}")
    ckpt = os.path.join(out, "weights", "best_loss_weights")
    fail_unless(os.path.isfile(ckpt), "no weights/best_loss_weights")
    tb_dir = os.path.join(out, "tensorboard")
    (name,) = os.listdir(tb_dir)
    events = read_scalar_events(os.path.join(tb_dir, name))
    tags = ["Avg_CE_loss/eval", "Avg_CE_loss_chord/eval",
            "Avg_CE_loss_emotion/eval", "Learn_rate/train"]
    fail_unless([(t, s) for t, s, _ in events] == [(t, 1) for t in tags],
                f"TensorBoard events {events}")
    want = [float(rows[1][i]) for i in (8, 9, 10, 1)]
    fail_unless(all(abs(v - w) <= 1e-6 * max(1.0, abs(w))
                    for (_, _, v), w in zip(events, want)),
                f"TensorBoard values {events} against results.csv {want}")
    (trace,) = os.listdir(prof)
    names = trace_kernel_names(os.path.join(prof, trace))
    found = {k: sorted(n for n in names if k in n)
             for k in ROW11_TRACE_NAMES}
    fail_unless(all(found.values()), f"the trace lacks row 11's kernels: "
                f"{sorted(names)[:40]}")
    share, us, total = trace_device_share(os.path.join(prof, trace),
                                          ROW11_TRACE_NAMES)
    report["train"]["cli_f32_row11_share"] = [share, us, total]
    print(f"train_amt CLI trace (f32, B=16, 3 steps): row 11's kernels "
          f"{us / 1e3:.3f} ms of {total / 1e3:.3f} ms device kernel time, "
          f"share {share:.4f} [{card}]")
    print(f"train_amt CLI (2.2, motion_type 1, f32, B=16, {steps} steps, "
          f"-profile 3): {wall:.2f} s with the eval passes; results.csv, "
          f"weights/best_loss_weights; TensorBoard {name}: "
          f"{[(t, s) for t, s, _ in events]}; trace {trace}, "
          f"{os.path.getsize(os.path.join(prof, trace))} bytes, row 11's "
          f"kernels in it: {sorted(sum(found.values(), []))} [{card}]")

    reg_out = os.path.join(tmp, "reg")
    zero_launches()
    t0 = time.perf_counter()
    reg_state = train_reg_cli.main([
        "-dataset_dir", root, "-output_dir", reg_out, "-regModel",
        "bimamba+", "-epochs", "1", "-batch_size", "16", "-device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scans = 2 * reg_state.model.cfg.n_layers
    check_path_launches("train_regression CLI", dict(
        selective_scan=scans * (steps + -(-(CLI_CLIPS // 2) // 16))), report)
    with open(os.path.join(reg_out, "results.csv")) as f:
        rows = list(csv.reader(f))
    fail_unless(rows[0] == REG_CSV_HEADER and len(rows) == 2
                and all(torch.isfinite(torch.tensor(float(v)))
                        for v in rows[1][1:]), f"results.csv {rows}")
    reg_ckpt = os.path.join(reg_out, "weights", "best_rmse_weights")
    fail_unless(os.path.isfile(reg_ckpt), "no weights/best_rmse_weights")
    print(f"train_regression CLI (bimamba+, f32, B=16, {steps} steps): "
          f"{wall:.2f} s; results.csv {dict(zip(rows[0], rows[1]))} [{card}]")
    return ckpt, reg_ckpt


def cli_eval_phase(root, tmp, cfg, ckpt, reg_ckpt, has_mpl, card, report):
    """evaluate (with -confusion and the expert-emotion counts) and
    evaluate_regression through their CLIs on the checkpoints."""
    import numpy as np
    from video2music_tpu_torch.cli import evaluate as eval_cli
    from video2music_tpu_torch.cli import evaluate_regression as eval_reg_cli
    from video2music_tpu_torch.core import constants as C
    from video2music_tpu_torch.data import create_vevo_datasets

    _, _, test_ds = create_vevo_datasets(root, motion_type=1)
    B, n_attn = 8, 3 * len(cfg.decoder_layers)
    batches = -(-len(test_ds) // B)
    out = os.path.join(tmp, "eval")
    flags = ["-dataset_dir", root, "-model_weights", ckpt,
             "-music_gen_version", "2.2", "-motion_type", "1",
             "-batch_size", str(B), "-output_dir", out, "-confusion",
             "-device", "cuda"]
    zero_launches()
    t0 = time.perf_counter()
    metrics = eval_cli.main(flags + (["-expert_plots"] if has_mpl else []))
    if not has_mpl:
        # the CLI's -expert_plots renders with matplotlib: count through
        # the same function and write the JSON alone
        from video2music_tpu_torch.obs import save_expert_emotion
        model = eval_cli.load_model(cfg, ckpt, "VideoMusicTransformer",
                                    "cuda")
        save_expert_emotion(eval_cli.expert_emotion_counts(
            model, test_ds, B), out_dir=out)
        print("  matplotlib is not installed on this machine: no "
              "-expert_plots; the counts' JSON written through "
              "obs.save_expert_emotion, no heatmaps")
    wall = time.perf_counter() - t0
    # the eval pass, the counting pass and the confusion pass
    check_path_launches("evaluate CLI", dict(
        flash_attention=3 * n_attn * batches), report)
    fail_unless(all(np.isfinite(v) for k, v in metrics.items()
                    if k != "correspondence"), f"eval metrics {metrics}")
    tgt = np.stack([test_ds[i]["tgt"] for i in range(len(test_ds))])
    emo = np.stack([test_ds[i]["emotion"] for i in range(len(test_ds))])
    labelled = emo.any(-1)
    n_tgt = int((tgt != C.CHORD_PAD).sum())
    for name, n in (("chord", C.CHORD_SIZE), ("root", 15), ("quality", 16)):
        cm = np.load(os.path.join(out, f"confusion_{name}.npy"))
        fail_unless(cm.shape == (n, n) and int(cm.sum()) == n_tgt,
                    f"confusion_{name}: {cm.shape}, {cm.sum()} != {n_tgt}")
    k = cfg.moe.n_experts_per_token
    deep = [i for i, s in enumerate(cfg.encoder_layers) if s.ffn == "moe"]
    deep_dec = [i for i, s in enumerate(cfg.decoder_layers)
                if s.ffn == "moe"]
    want = sorted([(f"enc_{i}/ffn", k * int(labelled.sum())) for i in deep]
                  + [(f"dec_{i}/ffn", k * int(labelled[:, :tgt.shape[1]]
                                                   .sum()))
                     for i in deep_dec])
    got = []
    for i in range(len(want)):
        with open(os.path.join(out, f"experts_emotion_count{i}.json")) as f:
            data = json.load(f)
        counts = np.asarray(data["counts"])
        fail_unless(counts.shape == (6, cfg.moe.n_experts),
                    f"{data['layer']}: counts {counts.shape}")
        got.append((data["layer"], int(counts.sum())))
    fail_unless(not os.path.exists(os.path.join(
        out, f"experts_emotion_count{len(want)}.json")),
        "more expert-emotion files than MoE layers")
    fail_unless(got == want, f"expert-emotion counts {got}, k_top x the "
                f"labelled positions implies {want}")
    pngs = [n for n in os.listdir(out) if n.endswith(".png")]
    fail_unless(len(pngs) == (len(want) if has_mpl else 0),
                f"heatmaps {pngs}")
    print(f"evaluate CLI (f32, B={B}, {len(test_ds)} clips): {wall:.2f} s; "
          f"loss {metrics['loss']:.4f}, hits@1 {metrics['hits@1']:.4f}; "
          f"confusion matrices over {n_tgt} targets; expert-emotion counts "
          f"(layer, sum = k_top x labelled positions): {got}; "
          f"{len(pngs)} heatmaps [{card}]")

    zero_launches()
    t0 = time.perf_counter()
    reg_metrics = eval_reg_cli.main([
        "-dataset_dir", root, "-model_weights", reg_ckpt, "-regModel",
        "bimamba+", "-batch_size", str(B), "-output_dir",
        os.path.join(tmp, "eval_reg"), "-device", "cuda"])
    wall = time.perf_counter() - t0
    check_path_launches("evaluate_regression CLI",
                        dict(selective_scan=4 * batches), report)
    fail_unless(all(np.isfinite(v) for v in reg_metrics.values()),
                f"regression eval metrics {reg_metrics}")
    print(f"evaluate_regression CLI (bimamba+, f32, B={B}): {wall:.2f} s; "
          f"{reg_metrics} [{card}]")


def cli_generate_phase(root, tmp, ckpt, reg_ckpt, card, report):
    """The generate CLI on the checkpoints against Video2music of the same
    checkpoints on the same sample, seed and primer; returns its chords."""
    from video2music_tpu_torch.cli import generate as generate_cli
    from video2music_tpu_torch.data import create_vevo_datasets
    from video2music_tpu_torch.pipeline.api import Video2music

    test_id, out = "clip003", os.path.join(tmp, "generate")
    zero_launches()
    t0 = time.perf_counter()
    res = generate_cli.main([
        "-dataset_dir", root, "-test_id", test_id, "-primer", CLI_PRIMER,
        "-music_gen_version", "2.2", "-regModel", "bimamba+",
        "-motion_type", "1", "-amt_weights", ckpt, "-reg_weights",
        reg_ckpt, "-output_dir", out, "-seed", "0", "-device", "cuda"])
    wall = time.perf_counter() - t0
    ref = Video2music(amt_checkpoint=ckpt, reg_checkpoint=reg_ckpt,
                      motion_type=1, device="cuda")
    want = path_launches(ref, 1)
    print(f"  generate CLI: row 2 (decode_layer) {wrappers()['decode_layer'].launches}"
          f" launches, row 12 (selective_scan) "
          f"{wrappers()['selective_scan'].launches}; path_launches implies "
          f"{want['decode_layer']} and {want['selective_scan']}")
    check_path_launches("generate CLI", want, report)
    with open(os.path.join(out, "output.lab")) as f:
        lab = [line.split(" ", 1)[1].strip() for line in f]
    _, _, test_ds = create_vevo_datasets(root, motion_type=1)
    sample = test_ds[test_ds.ids.index(test_id)]
    expect = ref.generate(primer=CLI_PRIMER, features={
        k: sample[k] for k in ("semantic", "emotion", "scene_offset",
                               "motion")},
        output_dir=os.path.join(tmp, "generate_ref"), seed=0)
    check_clip("generate CLI", res, CLI_PRIMER, 300)
    fail_unless(lab == res.chords == expect.chords,
                "the generate CLI's output.lab differs from Video2music's")
    print(f"generate CLI ({test_id}, bf16, B=1 'ends'): {wall:.2f} s; "
          f"output.lab's {len(lab)} chords equal Video2music(amt_checkpoint"
          f"=..., reg_checkpoint=...).generate's token for token [{card}]")
    del ref
    return test_id, lab


def cli_serve_phase(root, tmp, ckpt, reg_ckpt, test_id, chords, card):
    """python -m video2music_tpu_torch.cli.serve in a subprocess: eight
    concurrent requests (one answer at least batch_width > 1), a stream, a
    reload of the trained checkpoints (then the generate CLI's request
    answers its chords), an unknown test_id (404), a bad payload (400)."""
    import signal
    import threading

    port = free_port()
    cmd = [sys.executable, "-m", "video2music_tpu_torch.cli.serve",
           "-dataset_dir", root, "-output_dir", os.path.join(tmp, "serve"),
           "-port", str(port), "-motion_type", "1", "-max_batch", "16",
           "-max_wait_ms", "50", "-device", "cuda"]
    log = os.path.join(tmp, "serve.log")
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=err, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on"):
            with open(log) as f:
                fail_unless(False, f"the server did not start: {line!r} "
                            f"{f.read()[-2000:]}")
        start = time.perf_counter() - t0
        ids = [f"clip{i:03d}" for i in range(8)]
        code, warm = http_call(port, "POST", "/generate",
                               dict(test_id=ids[0]))
        fail_unless(code == 200 and len(warm["chords"]) == 300,
                    f"warm-up request: {code} {warm}")
        answers = [None] * 8

        def ask(i):
            answers[i] = http_call(port, "POST", "/generate", dict(
                test_id=ids[i], primer=SERVE_PRIMERS[i % 5],
                temperature=0.8 + 0.05 * i))

        t1 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst = time.perf_counter() - t1
        widths = [a[1].get("batch_width") for a in answers]
        fail_unless(all(a[0] == 200 and len(a[1]["chords"]) == 300
                        for a in answers), f"burst answers {answers}")
        fail_unless(max(widths) > 1, f"no request batched: {widths}")
        code, lines = http_call(port, "POST", "/generate",
                                dict(test_id=ids[1], stream=True))
        stages = [x["stage"] for x in lines]
        fail_unless(code == 200 and stages == ["decoded", "done"]
                    and lines[0]["chords"] == lines[1]["chords"],
                    f"stream: {code} {stages}")
        code, body = http_call(port, "POST", "/reload", dict(
            amt_checkpoint=ckpt, reg_checkpoint=reg_ckpt))
        fail_unless(code == 200 and body["ok"], f"reload: {code} {body}")
        code, body = http_call(port, "POST", "/generate", dict(
            test_id=test_id, primer=CLI_PRIMER))
        fail_unless(code == 200 and body["chords"] == chords,
                    "after /reload the server's chords differ from the "
                    "generate CLI's on the same checkpoints")
        code, body = http_call(port, "POST", "/generate",
                               dict(test_id="no_such_clip"))
        fail_unless(code == 404, f"unknown test_id: {code} {body}")
        code, body = http_call(port, "POST", "/generate",
                               dict(features={"semantic": [[0.0]]}))
        fail_unless(code == 400, f"bad payload: {code} {body}")
        code, health = http_call(port, "GET", "/healthz")
        fail_unless(code == 200 and health["ok"], f"healthz {code}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    print(f"serve CLI (a subprocess, bf16, max_batch 16): up in {start:.1f} "
          f"s; 8 concurrent requests in {burst:.2f} s, batch widths "
          f"{widths}; stream stages {stages}; /reload, then the generate "
          f"CLI's chords token for token; 404 and 400 as the API says; "
          f"batcher stats {health['stats']}; {wall:.1f} s in all [{card}]")


def cli_demo_phase(root, tmp, ckpt, reg_ckpt, test_id, chords, card):
    """One POST to the demo's form, in this process: the page carries the
    chords the generate CLI wrote for the same clip, primer and seed."""
    import html
    import threading
    import urllib.parse
    import urllib.request
    from video2music_tpu_torch.cli import demo

    app = demo.DemoApp(dataset_dir=root, output_dir=os.path.join(tmp, "demo"),
                       motion_type=1, amt_checkpoint=ckpt,
                       reg_checkpoint=reg_ckpt, device="cuda")
    server = demo.make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    t0 = time.perf_counter()
    try:
        form = urllib.parse.urlencode(dict(test_id=test_id,
                                           primer=CLI_PRIMER)).encode()
        with urllib.request.urlopen(url + "/generate", form,
                                    timeout=600) as r:
            status, page = r.status, r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    fail_unless(status == 200 and html.escape(" ".join(chords[:64])) in page,
                "the demo page does not carry the generate CLI's chords")
    print(f"demo CLI: one form POST in {time.perf_counter() - t0:.2f} s, "
          f"the page carries the {len(chords)} chords' first 64 [{card}]")


def cli_extract_phase(tmp, card, report):
    """extract_features semantic, emotion, scene and motion -motion_type 1
    on a cv2 clip, with the seeded CLIP-L / MaxViT-T state dicts saved as
    the CLI's weight files, against Video2music.extract_features of the
    same clip (float32 extractors, the PIL resize the CLI uses)."""
    import numpy as np
    import torch
    from video2music_tpu_torch.cli import extract_features as extract_cli
    from video2music_tpu_torch.pipeline.api import Video2music

    vids = os.path.join(tmp, "videos")
    os.makedirs(vids)
    seconds = RAW_CLIPS[1][0]
    clip = write_clip(os.path.join(vids, "clip.mp4"), *RAW_CLIPS[1])
    clip_sd, mv_sd, text = seeded_extractors(torch.device("cuda"))
    paths = {n: os.path.join(tmp, n) for n in ("clip.pt", "maxvit.pt",
                                               "text.npy")}
    t0 = time.perf_counter()
    torch.save(clip_sd, paths["clip.pt"])
    torch.save(mv_sd, paths["maxvit.pt"])
    np.save(paths["text.npy"], text)
    saved = time.perf_counter() - t0
    out = {k: os.path.join(tmp, "feat", k) for k in
           ("semantic", "emotion", "scene", "offset", "motion")}
    v = ["-video_dir", vids]
    dev = ["-device", "cuda"]
    zero_launches()
    t0 = time.perf_counter()
    extract_cli.main(["semantic"] + v + ["-out_dir", out["semantic"],
                                         "-clip_params", paths["clip.pt"]]
                     + dev)
    extract_cli.main(["emotion"] + v + ["-out_dir", out["emotion"],
                                        "-clip_params", paths["clip.pt"],
                                        "-text_embeds", paths["text.npy"]]
                     + dev)
    extract_cli.main(["scene"] + v + ["-out_dir", out["scene"],
                                      "-offset_dir", out["offset"]])
    extract_cli.main(["motion"] + v + ["-out_dir", out["motion"],
                                       "-motion_type", "1",
                                       "-maxvit_params", paths["maxvit.pt"]]
                     + dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one forward a video each: CLIP-L's 24 layers twice, MaxViT-T's 22
    check_path_launches("extract_features CLI",
                        dict(flash_attention=24 + 24 + 22), report)
    ref = Video2music(clip_params=clip_sd, emotion_text_embeds=text,
                      maxvit_params=mv_sd, motion_type=1,
                      extractor_dtype="float32", resize_backend="pil",
                      device="cuda")
    want = ref.extract_features(clip)
    zero_launches()  # the comparison's launches are not the CLI's path
    semantic = np.load(os.path.join(out["semantic"], "clip.npy"))
    motion = np.load(os.path.join(out["motion"], "clip.npy"))
    with open(os.path.join(out["emotion"], "clip.lab")) as f:
        emotion = np.asarray([[float(x) for x in line.split()[1:]]
                              for line in f.read().splitlines()[1:]])
    with open(os.path.join(out["offset"], "clip.lab")) as f:
        offsets = [int(line.split()[1]) for line in f]
    n = want["semantic"].shape[0]
    fail_unless(n == seconds and semantic.shape == (n, 768)
                and semantic.dtype == want["semantic"].dtype
                and motion.shape == want["motion"].shape == (n, 512)
                and motion.dtype == want["motion"].dtype
                and emotion.shape == (n, 6),
                f"shapes {semantic.shape} {motion.shape} {emotion.shape}")
    rels = {}
    for name, got, ref_v in (("semantic", semantic, want["semantic"]),
                             ("motion", motion, want["motion"])):
        _, rels[name] = errors(torch.from_numpy(got),
                               torch.from_numpy(ref_v))
        fail_unless(rels[name] <= EXTRACT_F32_REL,
                    f"extract_features {name}: rel {rels[name]:.3e} "
                    f"over {EXTRACT_F32_REL}")
    # four decimals in the .lab: one unit of the last besides the tolerance
    emo_err = float(np.abs(emotion - want["emotion"]).max())
    fail_unless(emo_err <= 1e-4 + EXTRACT_F32_REL,
                f"extract_features emotion: {emo_err:.3e}")
    fail_unless(offsets == (want["scene_offset"] - 1).astype(int).tolist(),
                f"scene offsets {offsets} != {want['scene_offset'] - 1}")
    print(f"extract_features CLI on a {seconds} s clip (f32, CLIP-L and "
          f"MaxViT-T state dicts saved in {saved:.1f} s): semantic, "
          f"emotion, scene and motion -motion_type 1 in {wall:.2f} s; "
          f"against Video2music.extract_features: semantic rel "
          f"{rels['semantic']:.2e}, motion rel {rels['motion']:.2e} (rel "
          f"{EXTRACT_F32_REL}), emotion .lab max abs {emo_err:.1e}, scene "
          f"offsets equal [{card}]")


def cli_phase(card, report):
    """The port's command line at full width on the card, on a feature
    tree of CLI_CLIPS clips of 300 s (motion_type 1) from a seed and
    random weights from seeds: train_amt (with -profile 3 and the default
    TensorBoard), train_regression, evaluate (-confusion and the
    expert-emotion counts), evaluate_regression, generate (token for token
    with Video2music on the checkpoints), the serve CLI in a subprocess,
    one demo request, and extract_features on a cv2 clip. Every step's
    kernel launches must equal what its path implies."""
    import importlib.util
    from video2music_tpu_torch.core.config import amt_config

    has = {m: importlib.util.find_spec(m) is not None
           for m in ("matplotlib", "sklearn")}
    print(f"optional libraries on this machine: {has} (key_detection and "
          f"the plots are held on the CPU by the tests)")
    cfg = amt_config("2.2", total_vf_dim=768 + 1 + 512 + 6, dropout=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "vevo")
        t0 = time.perf_counter()
        write_feature_tree(root, CLI_CLIPS, 300, seed=5)
        # the regression CLIs read the tree at motion_type 0 (as the JAX
        # CLIs do): scalar motion labs beside the 512-d ones
        motion0 = os.path.join(root, "vevo_motion", "origin")
        os.makedirs(motion0)
        for i in range(CLI_CLIPS):
            with open(os.path.join(motion0, f"clip{i:03d}.lab"), "w") as f:
                f.write("".join(f"{t} {(t * 7 + i) % 50 / 10:.4f}\n"
                                for t in range(300)))
        print(f"wrote a feature tree of {CLI_CLIPS} clips of 300 s in "
              f"{time.perf_counter() - t0:.1f} s")
        ckpt, reg_ckpt = cli_train_phase(root, tmp, cfg, card, report)
        cli_eval_phase(root, tmp, cfg, ckpt, reg_ckpt, has["matplotlib"],
                       card, report)
        test_id, chords = cli_generate_phase(root, tmp, ckpt, reg_ckpt,
                                             card, report)
        cli_serve_phase(root, tmp, ckpt, reg_ckpt, test_id, chords, card)
        cli_demo_phase(root, tmp, ckpt, reg_ckpt, test_id, chords, card)
        cli_extract_phase(tmp, card, report)
        cli_mesh_phase(root, tmp, card, report)


# ---------------------------------------------------------------------------
# phase 13: multi-GPU training, as ranks sharing this card over gloo
# ---------------------------------------------------------------------------

# (strategy, mesh, the forms each world checks): f32 at dropout 0, f32 at
# dropout 0.1 (the masks global), bf16 mixed at dropout 0.1
MULTI_GPU_WORLDS = (("dp", (2, 1), ("f32", "f32_drop", "bf16")),
                    ("tp", (1, 2), ("f32", "f32_drop", "bf16")),
                    ("sp", (1, 2), ("f32", "bf16")),
                    ("tp", (1, 4), ("f32",)),
                    ("tp", (2, 2), ("f32",)),
                    ("pp", (1, 3), ("f32",)))
MULTI_GPU_FORMS = {"f32": (0.0, False), "f32_drop": (0.1, False),
                   "bf16": (0.1, True)}
MULTI_GPU_STEPS, MULTI_GPU_LR, MULTI_GPU_MICROBATCHES = 3, 1e-4, 4
# decoder (and encoder) layers of the worlds' model: cut from 6 to 2 (a
# SwiGLU layer and a SharedMoE one a stack, each kind kept) to keep the run
# within its time limit, but for pp, whose 3 stages must divide each
# segment of identical layers (3 SwiGLU, 3 SharedMoE)
MULTI_GPU_DEPTH = {"pp": 6}
MULTI_GPU_DEPTH_DEFAULT = 2
# worlds started together (their ranks' start-up, ~8 s a process, is most
# of a world's wall): pairs, seven ranks at most on the card machine's
# eight cores; their ms/step read the transport under that contention
MULTI_GPU_CONCURRENT = 2
# Parameters are held entry by entry to rtol 1e-3 / atol 1e-5, at most
# MULTI_GPU_OUTLIER_SHARE of them within the Adam step bound instead (the
# CPU tests' bound: an Adam step follows the last digits of a near-zero
# gradient). A router's near-tie that one summation order puts on the other
# side moves a token to another expert; from that MoE layer on the token's
# hidden state differs, and the experts it reaches there and in the later
# MoE layers take another update wherever their gradient is small beside
# one token's part (PERF.md §6). So where the two runs' global expert counts
# differ at some step, the expert stacks of the first MoE layer that differs
# (in forward order) and of every later one are held to the Adam step bound
# alone; with equal counts nothing is exempt.
MULTI_GPU_OUTLIER_SHARE = 1e-4
EXPERT_STACKS = ("w1g", "b1g", "w2", "b2")


def moe_layer_names(cfg):
    """The MoE layers' state-dict prefixes in ``moe_metrics`` order (the
    forward order: the encoder's, then the decoder's)."""
    return [f"{stack}.{i}.ffn" for stack in ("encoder_layers",
                                            "decoder_layers")
            for i, spec in enumerate(getattr(cfg, stack))
            if spec.ffn == "moe"]


def flipped_layers(cfg, got_counts, want_counts):
    """{step: [MoE layer prefixes]} where two runs' global token counts
    differ, steps from 1."""
    import torch
    names, out = moe_layer_names(cfg), {}
    for step, (g, w) in enumerate(zip(got_counts, want_counts), 1):
        rows = sorted({r for r, _ in torch.nonzero(g != w).tolist()})
        if rows:
            out[step] = [names[r] for r in rows]
    return out


def exempt_layers(cfg, flipped):
    """The MoE layers from the first one in ``flipped`` on, in forward
    order."""
    names = moe_layer_names(cfg)
    hit = {n for layers in flipped.values() for n in layers}
    return [] if not hit else names[min(names.index(n) for n in hit):]


def params_close(tag, got, want, lr, steps, exempt=()):
    """Every entry within rtol 1e-3 / atol 1e-5 but at most
    MULTI_GPU_OUTLIER_SHARE of them within 2 lr a step (the CPU tests'
    bound, tests/test_torch_parallel.py), the key projection's bias (zero
    gradient but for rounding) within the step bound, the expert stacks of
    the ``exempt`` MoE layers within the step bound. Returns {worst,
    outliers (held to the share), out of rtol in the exempt stacks, in the
    other expert stacks and elsewhere, and the five leaves with the most}."""
    import torch
    step_bound = 2 * lr * steps
    diffs, bounds, leaves = [], [], {}
    split = {"exempt_stacks": 0, "other_stacks": 0, "elsewhere": 0}
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            fail_unless(torch.equal(g, w), f"{tag}: {k} differs")
            continue
        bound = 1e-5 + 1e-3 * w.abs()
        if k.endswith("in_proj.bias"):
            n = w.numel() // 3
            bound[n:2 * n] = step_bound
        d = (g - w).abs()
        n_out = int((d > bound).sum())
        prefix, _, leaf = k.rpartition(".")
        where = ("elsewhere" if leaf not in EXPERT_STACKS else
                 "exempt_stacks" if prefix in exempt else "other_stacks")
        split[where] += n_out
        if n_out:
            leaves[k] = n_out
        if where == "exempt_stacks":
            bound.fill_(step_bound)
        diffs.append(d.flatten())
        bounds.append(bound.flatten())
    d, bound = torch.cat(diffs), torch.cat(bounds)
    outliers = int((d > bound).sum())
    top = dict(sorted(leaves.items(), key=lambda kv: -kv[1])[:5])
    fail_unless(outliers <= MULTI_GPU_OUTLIER_SHARE * d.numel() and
                d.max().item() <= step_bound,
                f"{tag}: {outliers} of {d.numel()} parameters off (the "
                f"expert stacks of {list(exempt)} exempt), worst "
                f"{d.max().item():.3g}; out of rtol: {split}, most in {top}")
    return dict(worst=d.max().item(), outliers=outliers,
                out_of_rtol=split, most=top)


def updates_agree(tag, got, want, start, lr, steps):
    """bf16: each entry's update within the step bound and of the same
    sign as the single-process step's in >= 95% of the entries (bf16
    gradients may flip the sign of the smallest). Returns the share."""
    import torch
    agree = total = 0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        dg, dw = got[k] - start[k], w - start[k]
        fail_unless((dg - dw).abs().max().item() <= 2 * lr * steps * 1.01,
                    f"{tag}: {k} moved beyond the Adam step bound")
        agree += int(((dg > 0) == (dw > 0)).sum())
        total += dg.numel()
    share = agree / total
    fail_unless(share >= 0.95, f"{tag}: updates agree in sign on "
                f"{share:.4f} of the entries")
    return share


def multi_gpu_batches(B, L, n):
    """n full-width AMT batches (numpy, for the ranks to split)."""
    return [{k: v.cpu().numpy() for k, v in zoo_batch("amt", B, L,
                                                      40 + i).items()}
            for i in range(n)]


def single_process_steps(cfg, tcfg, batches):
    """The single-process step on the card from the seeded init: (losses,
    the initial and final state dicts on the CPU, each step's ms and its
    global MoE expert counts, the state dict after the first step)."""
    import torch
    from video2music_tpu_torch.data.loader import to_device
    from video2music_tpu_torch.train import (create_train_state,
                                             make_amt_train_step)
    state = create_train_state(cfg, tcfg, device="cuda")
    start = {k: v.cpu() for k, v in state.model.state_dict().items()}
    step = make_amt_train_step(tcfg)
    losses, ms, counts = [], [], []
    for b in batches:
        b = to_device(b, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(m["expert_counts"].cpu())
        if len(counts) == 1:
            first = {k: v.to("cpu", copy=True)
                     for k, v in state.model.state_dict().items()}
    final = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    return losses, start, final, ms, counts, first


def world_launches_want(strategy, shape, cfg, form):
    """Rows 1 and 11's launches on a rank over MULTI_GPU_STEPS steps: one
    attention call a self- or cross-attention of a layer the rank runs
    (every layer, or its stage's), microbatch and step; row 11 when the
    call drops (forward and backward), else row 1's forward."""
    n_enc, n_dec = len(cfg.encoder_layers), len(cfg.decoder_layers)
    calls = n_enc + 2 * n_dec
    if strategy == "pp":
        calls = MULTI_GPU_MICROBATCHES * calls // shape[1]
    calls *= MULTI_GPU_STEPS
    if MULTI_GPU_FORMS[form][0] > 0:
        return {"flash_attention": 0, "flash_attention_dropout_fwd": calls,
                "flash_attention_dropout_bwd": calls}
    return {"flash_attention": calls, "flash_attention_dropout_fwd": 0,
            "flash_attention_dropout_bwd": 0}


def multi_gpu_phase(card, report):
    """Every strategy of train_amt's mesh at full width (AMT 2.2: d_model
    512, 8 heads, d_ff 1024, 6 experts top-2; depth cut to 2+2 layers, one
    SharedMoE a stack, but for pp's 6+6 (MULTI_GPU_DEPTH); B=16, L=300,
    AdamW lr 1e-4, seeded weights, synthetic batches)
    as worlds of ranks sharing this card over gloo (NCCL takes one GPU a
    rank), two worlds started at a time (MULTI_GPU_CONCURRENT): 2x1 dp,
    1x2 tp (EP 6/2), 1x2 sp, 1x4 tp (6 experts on 4 ranks: the inner-d_ff
    fallback), 2x2 tp and 1x3 pp (4 microbatches, the 3+3
    segments). Each runs three steps against the single-process step on
    this card from the same seed: f32 at dropout 0 (losses rtol 1e-4,
    parameters rtol 1e-3 / atol 1e-5 but for MULTI_GPU_OUTLIER_SHARE of
    them; where the global expert counts differ at some step, a router's
    near-tie, the expert stacks from that MoE layer on within the Adam
    step bound; the state after the first step too); dp and tp again at
    dropout 0.1 (the same bounds: every mask is the unsharded step's), and
    bf16 mixed (losses within 1e-2, updates agreeing in sign). Each rank's row 1 /
    row 11 launches must be what its path implies. The kernels are built
    here first, so no rank builds them. The phase runs torch's
    deterministic kernels, here and in the ranks: CUDA's embedding
    backward adds with atomics, so the single-process step alone differs
    from run to run (by whole experts' updates once a router's near-tie
    flips), and the ranks are held to one run of it."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        multi_gpu_worlds(card, report)
    finally:
        torch.use_deterministic_algorithms(False)


def multi_gpu_worlds(card, report):
    """The body of :func:`multi_gpu_phase`."""
    import dataclasses

    import numpy as np
    from video2music_tpu_torch.core.config import TrainConfig, amt_config
    from video2music_tpu_torch.parallel.launch import join
    from video2music_tpu_torch.parallel.launch import start as start_world

    B, L = 16, 300
    batches = multi_gpu_batches(B, L, MULTI_GPU_STEPS)
    tcfgs = {form: TrainConfig(optimizer="adamw", lr=MULTI_GPU_LR,
                               mixed_precision=mp)
             for form, (_, mp) in MULTI_GPU_FORMS.items()}
    # (form, depth) -> config, and the single-process run of each that a
    # world checks
    cfgs, refs = {}, {}
    for strategy, _, forms in MULTI_GPU_WORLDS:
        depth = MULTI_GPU_DEPTH.get(strategy, MULTI_GPU_DEPTH_DEFAULT)
        for form in forms:
            cfgs[form, depth] = dataclasses.replace(
                amt_config("2.2", total_vf_dim=768 + 1 + 512 + 6,
                           n_layers=depth),
                dropout=MULTI_GPU_FORMS[form][0])
    for (form, depth), cfg in cfgs.items():
        t0 = time.perf_counter()
        refs[form, depth] = single_process_steps(cfg, tcfgs[form], batches)
        print(f"single-process step, {form}, {depth}+{depth} layers: losses "
              f"{[round(v, 6) for v in refs[form, depth][0]]}, "
              f"{np.mean(refs[form, depth][3][1:]):.1f} ms/step (steps 2-3; "
              f"{time.perf_counter() - t0:.1f} s with the set-up) [{card}]")
    summary = {"single_process_ms_step": {
        f"{form} {depth}+{depth}": float(np.mean(r[3][1:]))
        for (form, depth), r in refs.items()}}
    launches = {"flash_attention": 0, "flash_attention_dropout_fwd": 0,
                "flash_attention_dropout_bwd": 0}

    def world_cases(strategy, forms, depth):
        return [dict(name=form, tcfg=tcfgs[form], strategy=strategy,
                     cfg=dataclasses.replace(
                         cfgs[form, depth],
                         sequence_parallel=strategy == "sp"), weights=None,
                     batches=batches, microbatches=MULTI_GPU_MICROBATCHES,
                     first_state=form.startswith("f32")) for form in forms]

    def run_group(group):
        """The group's worlds started together; (their ranks' results in
        world order, the group's wall). Every rank is stopped on the way
        out, whatever happened."""
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            started = []
            for strategy, shape, forms in group:
                work = stack.enter_context(tempfile.TemporaryDirectory())
                depth = MULTI_GPU_DEPTH.get(strategy, MULTI_GPU_DEPTH_DEFAULT)
                started.append((start_world(
                    "video2music_tpu_torch.parallel.worlds:run_world",
                    shape[0] * shape[1], dict(
                        mesh=shape, backend="gloo", device="cuda",
                        deterministic=True,
                        cases=world_cases(strategy, forms, depth)),
                    workdir=work), work))
            stack.callback(lambda: [(p.kill(), p.wait()) for procs, _ in
                                    started for p in procs
                                    if p.poll() is None])
            results = [join(procs, work, timeout=600)
                       for procs, work in started]
        return results, time.perf_counter() - t0

    def check_world(world, results, wall):
        """One world's results against the single-process runs."""
        strategy, shape, forms = world
        tag = f"{shape[0]}x{shape[1]} {strategy}"
        depth = MULTI_GPU_DEPTH.get(strategy, MULTI_GPU_DEPTH_DEFAULT)
        for form in forms:
            got = results[0][form]
            fcfg = cfgs[form, depth]
            losses, start, final, _, counts, first = refs[form, depth]
            flips = flipped_layers(fcfg, got["expert_counts"], counts)
            if form.startswith("f32"):
                np.testing.assert_allclose(got["losses"], losses, rtol=1e-4,
                                           err_msg=f"{tag} {form} losses")
                held1 = params_close(
                    f"{tag} {form} after step 1", got["first_state"], first,
                    MULTI_GPU_LR, 1, exempt_layers(fcfg,
                                                   {1: flips.get(1, [])}))
                exempt = exempt_layers(fcfg, flips)
                held = params_close(f"{tag} {form}", got["state"], final,
                                    MULTI_GPU_LR, MULTI_GPU_STEPS, exempt)
                held.update(step1=held1, exempt=exempt)
                counted = ("not reported" if not got["expert_counts"] else
                           f"differ at steps {flips}" if flips else "equal")
                check = (f"parameters worst {held['worst']:.3g} (step 1: "
                         f"{held1['worst']:.3g}, {held1['outliers']} "
                         f"outliers), {held['outliers']} outliers of "
                         f"{sum(v.numel() for v in final.values())}; expert "
                         f"counts {counted}, the expert stacks of {exempt} "
                         f"exempt; out of rtol {held['out_of_rtol']}, most "
                         f"in {held['most']}")
            else:
                rel = max(abs(g - w) / abs(w)
                          for g, w in zip(got["losses"], losses))
                fail_unless(rel <= 1e-2, f"{tag} bf16 losses {got['losses']}"
                            f" against {losses}")
                share = updates_agree(f"{tag} bf16", got["state"], final,
                                      start, MULTI_GPU_LR, MULTI_GPU_STEPS)
                held = dict(loss_rel=rel, sign_agreement=share)
                check = (f"loss within {rel:.2e}, updates agree in sign on "
                         f"{share:.4f}")
            want = world_launches_want(strategy, shape, fcfg, form)
            for rank, res in enumerate(results):
                fail_unless(res[form]["launches"] == want,
                            f"{tag} {form} rank {rank}: launches "
                            f"{res[form]['launches']}, the path implies "
                            f"{want}")
                for name, n in res[form]["launches"].items():
                    launches[name] += n
            ms = float(np.mean(got["ms"][1:]))
            summary[f"{tag} {form}"] = dict(
                ms_step=ms, heads=got["heads"],
                launches_per_rank=got["launches"],
                flipped_layers=flips, **held)
            print(f"  {tag} {form}: losses {[round(v, 6) for v in got['losses']]}"
                  f" (single process {[round(v, 6) for v in losses]}), "
                  f"{check}; rank 0 {ms:.1f} ms/step (ranks sharing one "
                  f"card over gloo: functional, not scaling); per rank "
                  f"launches {got['launches']} at {got['heads']} heads a "
                  "call [" + card + "]")
        print(f"world {tag}: {shape[0] * shape[1]} ranks, {wall:.1f} s "
              f"with their start and set-up (started with "
              f"{MULTI_GPU_CONCURRENT - 1} other world)")

    worlds = list(MULTI_GPU_WORLDS)
    for i in range(0, len(worlds), MULTI_GPU_CONCURRENT):
        group = worlds[i:i + MULTI_GPU_CONCURRENT]
        group_results, wall = run_group(group)
        for world, results in zip(group, group_results):
            check_world(world, results, wall)
    for name, n in launches.items():
        report[name]["launches_multi_gpu"] = n
    report["multi_gpu"] = summary
    print("multi-GPU summary: " + json.dumps(summary))


def cli_mesh_phase(root, tmp, card, report):
    """NCCL at world size 1: the train_amt CLI with -mesh 1x1 -parallel tp
    -device cuda, joining a world of this process (as under torchrun), on
    the CLIs phase's tree; the checkpoint it writes (gathered whole)
    served by Video2music(amt_checkpoint=...)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from video2music_tpu_torch.cli import train_amt as train_amt_cli
    from video2music_tpu_torch.core.config import amt_config
    from video2music_tpu_torch.parallel.mesh import INIT_METHOD_ENV
    from video2music_tpu_torch.pipeline.api import Video2music

    cfg = amt_config("2.2", total_vf_dim=768 + 1 + 512 + 6)
    out = os.path.join(tmp, "amt_mesh")
    n_attn = 3 * len(cfg.decoder_layers)
    steps = -(-CLI_CLIPS // 16)
    eval_batches = steps + -(-(CLI_CLIPS // 2) // 16)
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    env[INIT_METHOD_ENV] = "file://" + os.path.join(tmp, "nccl_rdv")
    os.environ.update(env)
    zero_launches()
    t0 = time.perf_counter()
    try:
        state = train_amt_cli.main([
            "-dataset_dir", root, "-output_dir", out, "-music_gen_version",
            "2.2", "-motion_type", "1", "-epochs", "1", "-batch_size", "16",
            "-mesh", "1x1", "-parallel", "tp", "-device", "cuda",
            "-no_tensorboard"])
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    wall = time.perf_counter() - t0
    fail_unless(backend == "nccl" and state.step == steps,
                f"-mesh 1x1: backend {backend}, {state.step} steps")
    check_path_launches("train_amt CLI -mesh 1x1 -parallel tp (nccl)", dict(
        flash_attention=n_attn * eval_batches,
        flash_attention_dropout_fwd=n_attn * steps,
        flash_attention_dropout_bwd=n_attn * steps))
    for name, n in (("flash_attention", n_attn * eval_batches),
                    ("flash_attention_dropout_fwd", n_attn * steps),
                    ("flash_attention_dropout_bwd", n_attn * steps)):
        report[name]["launches_multi_gpu"] = \
            report[name].get("launches_multi_gpu", 0) + n
    ckpt = os.path.join(out, "weights", "best_loss_weights")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    served = Video2music(amt_checkpoint=ckpt, seed=1, device="cuda")
    fail_unless(all(torch.equal(v.float().cpu(), saved[k].float())
                    for k, v in served.model.state_dict().items()),
                "the served model's weights are not the checkpoint's")
    res = served.generate(features=synthetic_features(60, seed=9),
                          output_dir=os.path.join(tmp, "mesh_gen"))
    check_ids("served -mesh checkpoint", res.chord_ids, [], 60)
    print(f"train_amt CLI -mesh 1x1 -parallel tp -device cuda (nccl, world "
          f"of 1; f32, B=16, {steps} steps): {wall:.2f} s with the eval "
          f"passes; its checkpoint served: {len(res.chord_ids)} chords "
          f"{np.asarray(res.chord_ids)[:8].tolist()}... [{card}]")


# ---------------------------------------------------------------------------
# phase 14: the published layouts (HF CLIP, torchvision MaxViT, the
# reference's checkpoints through the converter CLI)
# ---------------------------------------------------------------------------

# (version, d_model, heads, d_ff) the decode kernels refuse: head size 12,
# and head size 18 beside d_model 36 (not a multiple of 8)
REFUSED_SHAPES = (("2.2", 36, 2, 72),)
# head size 12, refused until the decode kernels took any even head size
TAKEN_SHAPES = (("2.2", 96, 8, 64),)
PUBLISHED_B = 16


def add_launches(report, counts):
    """Add ``counts`` (name -> launches on the published-layouts paths) to
    each kernel's ``launches_published``."""
    for name, n in counts.items():
        if n:
            report[name]["launches_published"] = \
                report[name].get("launches_published", 0) + n


def seeded_(module, gen):
    """Every float parameter of ``module`` from ``gen`` (on its device):
    matrices and kernels N(0, 1 / fan_in), vectors their own init plus
    N(0, 0.02); BatchNorm statistics N(0, 0.1) means, U(0.5, 1.5)
    variances. Returns the module."""
    import torch
    with torch.no_grad():
        for p in module.parameters():
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if p.dim() >= 2:
                p.copy_(noise * p[0].numel() ** -0.5)
            else:
                p.add_(noise * 0.02)
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen,
                                    device=b.device) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen,
                                   device=b.device) + 0.5)
    return module


def reference_state_dict(kind, seed, d=512, ff=1024, heads=8, n=6, E=6,
                         vf=768 + 1 + 512 + 6, S=300):
    """An AMT state dict in the reference's torch module names, random from
    a seeded torch.Generator (full width by default; the port's tests
    build theirs here too, at small widths): "amt" the base AMT (the
    nn.Transformer core with the decoder's RPR ``Er`` tables), "amt_v2"
    2.2 and "amt_v3" 3.1 (min(3, n - 1) SwiGLU layers, then SharedMoE
    layers of E experts; 3.1 with RMSNorm, bias-free differential
    attention and the experts' balancing biases). Matrices N(0, 1 /
    fan_in), vectors N(0, 0.02), norm scales 1 + N(0, 0.02)."""
    import torch
    from video2music_tpu_torch.core import constants as C
    if kind not in ("amt", "amt_v2", "amt_v3"):
        raise ValueError(f"kind must be amt, amt_v2 or amt_v3, got {kind!r}")
    gen = torch.Generator().manual_seed(seed)
    W = lambda o, i: torch.randn(o, i, generator=gen) * i ** -0.5
    vec = lambda *m: torch.randn(*m, generator=gen) * 0.02
    v3, hd = kind == "amt_v3", d // heads
    sd = {}

    def lin(p, o, i):
        sd[p + ".weight"], sd[p + ".bias"] = W(o, i), vec(o)

    def norm(p, m=d):
        sd[p + ".weight"] = 1 + vec(m)
        if not v3:
            sd[p + ".bias"] = vec(m)

    def mha(p):
        if v3:  # differential: bias-free, 2x q / k heads
            for name, rows in (("q_proj", 2 * d), ("k_proj", 2 * d),
                               ("v_proj", d), ("out_proj", d)):
                sd[f"{p}.{name}.weight"] = W(rows, d)
            for lam in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
                sd[f"{p}.{lam}"] = vec(hd)
            norm(p + ".subln", hd)
            return
        sd[p + ".in_proj_weight"], sd[p + ".in_proj_bias"] = (W(3 * d, d),
                                                              vec(3 * d))
        lin(p + ".out_proj", d, d)

    def glu(p):
        lin(p + ".linear1", ff, d)
        lin(p + ".gate", ff, d)
        lin(p + ".linear2", d, ff)

    def moe(p):
        lin(p + ".gate", E, d)
        for e in range(E):
            glu(f"{p}.experts.{e}")
        glu(p + ".shared_expert")
        if v3:
            sd[p + ".bias"] = vec(E, 1)  # the balancing buffer

    sd["embedding_root.weight"] = W(C.CHORD_ROOT_SIZE, d)
    sd["embedding_attr.weight"] = W(C.CHORD_ATTR_SIZE, d)
    lin("Linear_chord", d, d + 1)
    lin("Linear_vis", d, vf)
    lin("Wout", C.CHORD_SIZE, d)
    norm("transformer.encoder.norm")
    norm("transformer.decoder.norm")
    rate = min(3, max(0, n - 1))
    for i in range(n):
        e, dd = f"transformer.encoder.layers.{i}", \
            f"transformer.decoder.layers.{i}"
        mha(e + ".self_attn")
        mha(dd + ".self_attn")
        for name in ("norm1", "norm2"):
            norm(f"{e}.{name}")
        for name in ("norm1", "norm2", "norm3"):
            norm(f"{dd}.{name}")
        if kind == "amt":
            sd[dd + ".self_attn.Er"] = W(S, hd)
            mha(dd + ".multihead_attn")
            for p in (e, dd):
                lin(p + ".linear1", ff, d)
                lin(p + ".linear2", d, ff)
        else:
            mha(dd + ".cross_attn")
            (glu if i < rate else moe)(e + ".ff")
            (glu if i < rate else moe)(dd + ".ff")
    return sd


def refused_shapes_phase(card, report):
    """Step 0 on the card: generate_chords on AMT 2.2 at the shapes the
    decode kernels refuse (widths) decodes on the plain step (no decode
    kernel launches), fused="on" warning; at head size 12 (TAKEN_SHAPES)
    it decodes on the kernels ("auto": the ends chain, "on": a layer
    kernel a layer) with no warning; int8 KV caches at head size 8 and
    B=2 stay int8 on the batched kernels, with no warning. (Rows 1 and
    11 above head size 256 and the scan above d_state 1024 are held to
    their plain versions by the "wide heads" and "wide states" phases.)"""
    import warnings

    import torch
    from video2music_tpu_torch.core.config import amt_config
    from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                      generate_chords)
    from video2music_tpu_torch.models import VideoMusicTransformer
    from video2music_tpu_torch.weights import init_weights_
    dev = torch.device("cuda")
    T = 300
    for version, D, H, F in REFUSED_SHAPES + TAKEN_SHAPES:
        taken = (version, D, H, F) in TAKEN_SHAPES
        cfg = amt_config(version, n_layers=2, num_heads=H, d_model=D,
                         d_ff=F, total_vf_dim=11, dropout=0.0)
        model = init_weights_(VideoMusicTransformer(cfg),
                              torch.Generator().manual_seed(3)).to(dev)
        model.eval()
        r = torch.Generator(device=dev).manual_seed(1)
        feats = dict(semantic=torch.randn(1, T, 7, generator=r, device=dev),
                     key=torch.ones(1, 1, device=dev),
                     scene_offset=torch.zeros(1, T, device=dev),
                     motion=torch.randn(1, T, generator=r, device=dev),
                     emotion=torch.rand(1, T, 2, generator=r, device=dev))
        p = torch.tensor([[5, 122]], dtype=torch.int32, device=dev)
        kw = dict(primer=p, primer_root=p % 12 + 1, primer_attr=p % 14,
                  num_primer=2, gcfg=GenerateConfig(target_seq_length=T),
                  **feats)
        outs = {}
        for fused in ("auto", "on"):
            zero_launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = generate_chords(model, fused=fused, generator=torch
                                      .Generator(device=dev).manual_seed(2),
                                      **kw)
            warned = any("CUDA shape limits" in str(w.message)
                         for w in caught)
            fail_unless(warned == (fused == "on" and not taken),
                        f"d_model {D} / {H} heads, fused={fused!r}: "
                        f"warned {warned}")
            check_ids(f"{'taken' if taken else 'refused'} shape d_model "
                      f"{D} / {H} heads {fused}",
                      out["gen_seq"][0].cpu().numpy(), "", T)
            want = {"flash_attention": len(cfg.encoder_layers)}
            L = len(cfg.decoder_layers)
            if taken and fused == "auto":  # the ends chain
                want.update(decode_ends=2 * (T - 1))
                if L > 2:
                    want["decode_layer"] = (L - 2) * (T - 1)
            elif taken:  # a layer kernel a layer
                want["decode_layer"] = L * (T - 1)
            check_path_launches(f"d_model {D} / {H} heads fused={fused!r} "
                                f"({'kernels' if taken else 'plain step'})",
                                want)
            add_launches(report, want)
            outs[fused] = out["gen_seq"].cpu()
        if not taken:  # one plain step: the same tokens
            fail_unless(torch.equal(outs["auto"], outs["on"]),
                        f"d_model {D} / {H} heads: auto and on differ")
        how = ("kernels, no warning" if taken
               else "plain step, fused='on' warned")
        print(f"  d_model {D}, {H} heads (head size {D // H}), d_ff {F}: "
              f"300 tokens on the {how}, decode "
              f"{out['timings_ms']['decode'] / (T - 1):.4f} ms/token "
              f"[{card}]")
    # int8 KV caches at head size 8 and B=2: the batched kernels keep the
    # config and its int8 caches (8-value loads), with no warning; the
    # tokens are checked as the repo's checks hold any clip (the
    # full-width "head size 8 int8 KV" phase holds the steps to the plain
    # int8-KV step)
    cfg = amt_config("2.2", n_layers=2, num_heads=8, d_model=64, d_ff=128,
                     total_vf_dim=11, dropout=0.0)
    model = init_weights_(VideoMusicTransformer(cfg),
                          torch.Generator().manual_seed(3)).to(dev).eval()
    kw2 = {k: v.expand(2, *v.shape[1:]).contiguous() for k, v in kw.items()
           if torch.is_tensor(v)}
    kw2.update(num_primer=2, gcfg=GenerateConfig(target_seq_length=T))
    zero_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = generate_chords(model, kv_quant="int8", generator=torch
                              .Generator(device=dev).manual_seed(2), **kw2)
    fail_unless(not caught, f"head size 8, B=2, kv_quant='int8' warned: "
                f"{[str(w.message)[:80] for w in caught]}")
    counts = {n: fn.launches for n, fn in wrappers().items()}
    fail_unless(counts["batched_layer_step"] == 2 * (T - 1)
                and counts["batched_moe_ffn"] == T - 1,
                f"head size 8, B=2, kv_quant='int8': the batched kernels "
                f"launched {counts}")
    add_launches(report, counts)
    for b in range(2):
        check_ids(f"head size 8 B=2 kv_quant='int8' clip {b}",
                  out["gen_seq"][b].cpu().numpy(), "", T)
    print(f"  d_model 64, 8 heads (head size 8), B=2, kv_quant='int8': no "
          f"warning, batched kernels on int8 caches (batched_layer_step "
          f"{counts['batched_layer_step']}, batched_moe_ffn "
          f"{counts['batched_moe_ffn']} launches) [{card}]")


def hf_clip_vit_l14_336(dev, gen):
    """A transformers CLIPModel at the ViT-L/14@336 config on ``dev``,
    float32, seeded from ``gen``."""
    import torch
    from transformers import CLIPConfig, CLIPModel
    cfg = CLIPConfig(
        text_config=dict(hidden_size=768, intermediate_size=3072,
                         num_hidden_layers=12, num_attention_heads=12,
                         max_position_embeddings=77, vocab_size=49408,
                         hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=1024, intermediate_size=4096,
                           num_hidden_layers=24, num_attention_heads=16,
                           patch_size=14, image_size=336,
                           hidden_act="quick_gelu"),
        projection_dim=768)
    with torch.device(dev):
        hf = CLIPModel(cfg)
    return seeded_(hf, gen).float().eval()


def image_features(out):
    """HF's get_image_features, a tensor (or the output object holding
    it, in transformers versions that return one)."""
    import torch
    return out if torch.is_tensor(out) else out.pooler_output


def extractor_layout_phase(card, report):
    """CLIP-L/14@336 from a transformers CLIPModel (convert_hf_clip) and
    MaxViT-T from tools/torch_maxvit_mirror.py (convert_torchvision_
    maxvit), on seeded weights: the port's forward through row 1 against
    the source module's on 30 frames, f32 and bf16 (bf16 against the
    source's f32; the source's own bf16 distance printed beside), row 1's
    launches, the forwards' ms and row 1's ms in the forms they give it
    (CLIP's; MaxViT's stages 0 and 3), on their own activations."""
    import copy

    import torch
    from tools.torch_maxvit_mirror import feature_extractor, maxvit_t_mirror
    from video2music_tpu_torch.features import clip as clip_mod
    from video2music_tpu_torch.features import maxvit as maxvit_mod
    from video2music_tpu_torch.features.clip import (
        CLIP, clip_vit_l14_336_config, convert_hf_clip)
    from video2music_tpu_torch.features.maxvit import (
        MaxViT, convert_torchvision_maxvit, maxvit_t_config)
    from video2music_tpu_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    out = report.setdefault("published", {})
    for name, per_call in (("CLIP ViT-L/14@336", 24), ("MaxViT-T", 22)):
        t0 = time.perf_counter()
        if per_call == 24:
            src = hf_clip_vit_l14_336(dev, gen)
            t1 = time.perf_counter()
            cfg = clip_vit_l14_336_config()
            state = convert_hf_clip(src.state_dict(), cfg)
            with torch.device(dev):
                port = CLIP(cfg)
            size = cfg.vision.image_size
            src_fwd = lambda m, x: image_features(
                m.get_image_features(pixel_values=x.permute(0, 3, 1, 2)))
            port_fwd = lambda m, x: m.encode_image(x)
        else:
            with torch.device(dev):
                src = feature_extractor(maxvit_t_mirror())
            src = seeded_(src, gen).eval()
            t1 = time.perf_counter()
            cfg = maxvit_t_config()
            state = convert_torchvision_maxvit(src.state_dict(), cfg)
            with torch.device(dev):
                port = MaxViT(cfg)
            size = cfg.image_size
            src_fwd = lambda m, x: m(x.permute(0, 3, 1, 2))
            port_fwd = lambda m, x: m(x)
        port.load_state_dict(state)
        port.eval()
        print(f"  {name}: the source built and seeded in {t1 - t0:.1f} s, "
              f"converted and loaded in {time.perf_counter() - t1:.1f} s")
        x = torch.randn(30, size, size, 3, generator=gen, device=dev)
        row = out[name] = {}
        with torch.no_grad():
            want = src_fwd(src, x)
            n0 = flash_attention.launches
            got = port_fwd(port, x)
            abs_err, rel = errors(got, want)
            verdict = "ok" if rel <= EXTRACT_F32_REL else "FAIL"
            print(f"  {name} f32, 30 frames, against the source module: "
                  f"max_abs {abs_err:.3e} max_rel {rel:.3e} (rel "
                  f"{EXTRACT_F32_REL}) {verdict}")
            fail_unless(rel <= EXTRACT_F32_REL,
                        f"{name}: f32 differs from the source module")
            src_bf, port_bf = (copy.deepcopy(m).to(torch.bfloat16)
                               for m in (src, port))
            xb = x.to(torch.bfloat16)
            got = port_fwd(port_bf, xb).float()
            n = flash_attention.launches - n0
            fail_unless(n == 2 * per_call, f"{name}: {n} row-1 launches in "
                        f"two forwards, {2 * per_call} implied")
            add_launches(report, {"flash_attention": n})
            abs_err, rel = errors(got, want)
            _, src_rel = errors(src_fwd(src_bf, xb).float(), want)
            print(f"  {name} bf16 against the source's f32: max_abs "
                  f"{abs_err:.3e} max_rel {rel:.3e} (rel {EXTRACT_BF16_REL};"
                  f" the source's own bf16: {src_rel:.3e}) "
                  f"{'ok' if rel <= EXTRACT_BF16_REL else 'FAIL'}")
            fail_unless(bool(torch.isfinite(got).all())
                        and rel <= EXTRACT_BF16_REL,
                        f"{name}: bf16 differs from the source's f32")
            for dt, m, s, xx in (("float32", port, src, x),
                                 ("bfloat16", port_bf, src_bf, xb)):
                row[f"ms_30_frames_{dt}"] = eager_ms(
                    lambda: port_fwd(m, xx), iters=3)
                row[f"source_ms_30_frames_{dt}"] = eager_ms(
                    lambda: src_fwd(s, xx), iters=3)
            # row 1 in the forms this forward gives it (CLIP: its one
            # form; MaxViT: stages 0 and 3), timed on these activations
            mod = clip_mod if per_call == 24 else maxvit_mod
            seen = []

            def record(q, k, v, **kw):
                seen.append((q, k, v, kw))
                return flash_attention(q, k, v, **kw)

            mod.flash_attention = record
            try:
                port_fwd(port_bf, xb)
            finally:
                mod.flash_attention = flash_attention
            forms = row["row1_ms"] = {}
            for q, k, v, kw in (seen[:1] if per_call == 24
                                else [seen[0], seen[-1]]):
                form = forms[str(list(q.shape))] = {}
                form["bfloat16"] = time_ms(
                    lambda: flash_attention(q, k, v, **kw))[0]
                q, k, v = (t.float() for t in (q, k, v))
                form["float32"] = time_ms(
                    lambda: flash_attention(q, k, v, **kw))[0]
        print(f"  {name} forward, 30 frames: port "
              f"{row['ms_30_frames_bfloat16']:.2f} ms bf16 / "
              f"{row['ms_30_frames_float32']:.2f} ms f32, source module "
              f"{row['source_ms_30_frames_bfloat16']:.2f} / "
              f"{row['source_ms_30_frames_float32']:.2f} (CUDA events); "
              f"row 1 (B, H, L, D) bf16 / f32 device ms: "
              + ", ".join(f"{shape} {t['bfloat16']:.4f} / {t['float32']:.4f}"
                          for shape, t in forms.items()) + f" [{card}]")
        del src, port, src_bf, port_bf, state
        torch.cuda.empty_cache()


def convert_cli(tmp, kind, sd):
    """Write ``sd`` as a pickle and start the converter CLI on it (a
    subprocess on the card); returns (process, output path)."""
    import torch
    pickle = os.path.join(tmp, f"{kind}.pickle")
    torch.save(sd, pickle)
    ckpt = os.path.join(tmp, f"{kind}_weights")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "video2music_tpu_torch.cli.convert_reference_checkpoint",
         "--weights", pickle, "--kind", kind, "--out", ckpt],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, ckpt


def checkpoint_serving_phase(card, report):
    """A full-width 2.2 (--kind amt_v2) and base-AMT (--kind amt)
    reference state dict, seeded, through the converter CLI (two
    subprocesses at once), served by Video2music(amt_checkpoint=...): one
    300 s request through generate (2.2: "ends"; the base AMT: row 8), the
    same request through generate_chords under "monolith" (2.2), and
    generate_batch at B=16; every clip checked, the launches equal to the
    path's, then the same calls on the in-memory conversion
    (amt_from_jax(convert_reference_*(sd))): the same tokens."""
    import numpy as np
    import torch
    from video2music_tpu_torch.decode.sampler import generate_chords
    from video2music_tpu_torch.pipeline.api import Video2music
    from video2music_tpu_torch.train import convert
    from video2music_tpu_torch.weights import amt_from_jax
    T, B = 300, PUBLISHED_B
    out = report.setdefault("published", {})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sds = {kind: reference_state_dict(kind, seed)
               for kind, seed in (("amt_v2", 22), ("amt", 10))}
        procs = {kind: convert_cli(tmp, kind, sd) for kind, sd in sds.items()}
        for kind, (proc, _) in procs.items():
            text, _ = proc.communicate(timeout=600)
            print("  " + text.strip().replace("\n", "\n  "))
            fail_unless(proc.returncode == 0,
                        f"convert_reference_checkpoint --kind {kind}: "
                        f"rc {proc.returncode}")
        print(f"  two reference pickles written and converted in "
              f"{time.perf_counter() - t0:.1f} s")
        for kind, version in (("amt_v2", "2.2"), ("amt", None)):
            sd, (_, ckpt) = sds[kind], procs[kind]
            row = out[kind] = {}
            v2m = Video2music(music_gen_version=version, seed=0,
                              device="cuda", amt_checkpoint=ckpt)
            label = f"converted {kind} ({version or 'base AMT'})"
            v2m.generate(features=synthetic_features(30, 99),  # warm-up
                         output_dir=os.path.join(tmp, "warm_up"))
            req = REQUESTS[0]
            reqs, temps = serving_requests(B, 5000)
            runs = {}
            for source in ("checkpoint", "in memory"):
                if source == "in memory":
                    params = (convert.convert_reference_amt_v2(sd)
                              if kind == "amt_v2"
                              else convert.convert_reference_amt(sd))
                    v2m.load_state_dicts(amt_from_jax(
                        params, convert.convert_reference_moe_state(sd)))
                zero_launches()
                t0 = time.perf_counter()
                res = v2m.generate(
                    primer=req["primer"], key=req["key"],
                    temperature=req["temperature"],
                    features=synthetic_features(T, 7), seed=7,
                    output_dir=os.path.join(tmp, kind, source, "b1"))
                wall = time.perf_counter() - t0
                check_clip(f"{label} request", res, req["primer"], T,
                           v2m.last_regression["instrument"],
                           v2m.last_regression["ln_nd"])
                row.setdefault("ms_token", []).append(
                    v2m.last_timings["decode"] / (T - 1))
                print(f"  {label} from the {source}: 300 s request, wall "
                      f"{wall:.3f} s, {row['ms_token'][-1]:.4f} ms/token "
                      f"[{card}]")
                runs[source] = [res.chord_ids]
                if version is not None:  # one launch a step
                    model, _ = v2m._models("bfloat16")
                    inputs = request_inputs(v2m, synthetic_features(T, 7),
                                            req["primer"], torch.bfloat16)
                    mono = generate_chords(
                        model, fused="monolith", generator=torch.Generator(
                            device=v2m.device).manual_seed(7), **inputs)
                    ids = mono["gen_seq"][0].cpu().numpy()
                    check_ids(f"{label} monolith", ids, req["primer"], T)
                    row.setdefault("ms_token_monolith", []).append(
                        mono["timings_ms"]["decode"] / (T - 1))
                    print(f"  {label} from the {source}, monolith: "
                          f"{row['ms_token_monolith'][-1]:.4f} ms/token "
                          f"[{card}]")
                    runs[source].append(ids)
                t0 = time.perf_counter()
                results = v2m.generate_batch(
                    reqs, temperature=temps, seed=B,
                    output_dir=os.path.join(tmp, kind, source, "b16"))
                wall = time.perf_counter() - t0
                check_batch(f"{label} B={B}", v2m, reqs, results)
                row.setdefault("clips_s_b16", []).append(B / wall)
                print(f"  {label} from the {source}: generate_batch B={B}, "
                      f"wall {wall:.3f} s = {B / wall:.2f} clips/s, "
                      f"{v2m.last_timings['decode'] / (T - 1):.4f} ms/step "
                      f"[{card}]")
                runs[source] += [r.chord_ids for r in results]
                counts = {n: fn.launches for n, fn in wrappers().items()}
                want = {n: sum(path_launches(v2m, w)[n] for w in (1, B))
                        for n in KERNELS}
                if version is not None:  # the monolith request's
                    want["decode_monolith"] = T - 1
                    want["flash_attention"] += len(v2m.amt_cfg
                                                   .encoder_layers)
                for n in KERNELS:
                    fail_unless(counts[n] == want[n],
                                f"{label} from the {source}: {n} launched "
                                f"{counts[n]} times, the path implies "
                                f"{want[n]}")
                add_launches(report, counts)
                print(f"  {label} from the {source} launches: " + ", ".join(
                    f"{n} {counts[n]}" for n in KERNELS if counts[n])
                    + " (each as the path implies; every other kernel 0)")
            for a, b in zip(runs["checkpoint"], runs["in memory"]):
                fail_unless(np.array_equal(a, b),
                            f"{label}: the checkpoint's tokens differ from "
                            f"the in-memory conversion's")
            print(f"  {label}: {len(runs['checkpoint'])} clips, the "
                  f"checkpoint's tokens equal the in-memory conversion's")
            del v2m
            torch.cuda.empty_cache()


def published_layouts_phase(card, report):
    """The published layouts: Step 0's routing on the card, the
    extractors from HF / torchvision layouts, and the reference's
    checkpoints through the converter CLI, served."""
    refused_shapes_phase(card, report)
    extractor_layout_phase(card, report)
    checkpoint_serving_phase(card, report)


def register_report(log: str) -> str:
    """One line per compiled kernel from ptxas -v: its (mangled) name, its
    registers, shared memory and spills."""
    import re
    out, name, spill = [], "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"  {name[:72]}: {used}; {spill}")
    return "\n".join(out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from video2music_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s "
          f"({kernels.BUILD_DIR})")
    print(register_report(kernels.build_log))
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from video2music_tpu_torch.pipeline.api import Video2music
    t0 = time.perf_counter()
    v2m = Video2music(seed=0, device="cuda")
    print(f"built full-width Video2music (AMT 2.2 + bimamba+) in "
          f"{time.perf_counter() - t0:.1f} s")
    report = {name: {} for name in KERNELS}
    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {seconds[name]} s")
        return out

    phase("kernels", kernel_phase, report, v2m)
    phase("scan shapes", scan_shapes_phase, report, v2m)
    phase("stack kernels", stack_kernel_phase, report, v2m)
    phase("stack positions", stack_positions_phase, report, v2m)
    phase("stack breakdown", stack_breakdown_phase, report, v2m, card)
    phase("batched kernels", batched_kernel_phase, report, v2m)
    phase("int8 KV kernels", int8_kv_kernel_phase, report, v2m)
    phase("dropout kernels", dropout_kernel_phase, report, v2m.amt_cfg)
    phase("dropout forms", dropout_forms_phase, report, v2m.amt_cfg)
    phase("variant kernels", variant_kernel_phase, report, v2m)
    phase("decode breakdown", decode_breakdown_phase, report, v2m, card)
    phase("gemv yardstick", gemv_yardstick_phase, report, card)
    phase("d_ff 2048", wide_ffn_phase, report, v2m)
    phase("head sizes", head_size_phase, report, card)
    phase("wide heads", wide_head_phase, report, card)
    phase("wide states", wide_state_phase, report, card)
    phase("decode head sizes", decode_head_sizes_phase, report, card)
    phase("probes", probes_phase, report, card)
    phase("40 experts", many_experts_phase, report, v2m)
    phase("expert cut", expert_cut_phase, report, v2m, card)
    phase("slice", slice_phase, v2m, card, report)
    phase("teacher-forced", teacher_forced_phase, v2m)
    phase("B=1 backends", backends_phase, v2m, card, report)
    phase("teacher-forced backends", teacher_forced_backends_phase, v2m)
    phase("serving", serving_phase, v2m, card, report)
    phase("int8 KV", int8_kv_phase, v2m, card, report)
    phase("teacher-forced batch", teacher_forced_batch_phase, v2m)
    phase("teacher-forced int8 KV", teacher_forced_batch_phase, v2m, 8,
          "int8")
    del v2m
    torch.cuda.empty_cache()
    models = phase("V3 slice", v3_slice_phase, card, report)
    phase("V3 int8", v3_int8_phase, models["3.1"], card, report)
    phase("V3 teacher-forced", v3_teacher_forced_phase, models,
          ((1, None), (8, None), (1, "int8")))
    del models
    torch.cuda.empty_cache()
    phase("wirings", wirings_phase, card, report)
    phase("regression zoo", regression_zoo_phase, card, report)
    torch.cuda.empty_cache()
    phase("raw video kernels", raw_video_kernel_phase, report, card)
    phase("extractors", extractor_phase, card, report)
    phase("raw video", raw_video_phase, card, report)
    phase("new backbones", new_backbones_phase, card, report)
    torch.cuda.empty_cache()
    phase("deep model", deep_model_phase, card)
    torch.cuda.empty_cache()
    phase("train", train_phase, card, report)
    phase("teacher-forced train", teacher_forced_train_phase, card)
    torch.cuda.empty_cache()
    phase("train zoo", train_zoo_phase, card, report)
    torch.cuda.empty_cache()
    phase("multi-GPU", multi_gpu_phase, card, report)
    torch.cuda.empty_cache()
    phase("CLIs", cli_phase, card, report)
    torch.cuda.empty_cache()
    phase("published layouts", published_layouts_phase, card, report)
    torch.cuda.empty_cache()
    phase("head size 512 path", wide_head_path_phase, card, report)
    torch.cuda.empty_cache()
    phase("head size 8 int8 KV", int8_kv_hd8_phase, card, report)
    torch.cuda.empty_cache()
    phase("head size 4 path", narrow_head_path_phase, card, report)
    print(f"phase seconds: {json.dumps(seconds)}")

    rows = []
    for name, meta in KERNELS.items():
        r = report[name]
        # the kv probe has bf16 forms only
        no_f32 = (None,) * 4
        bf, f32 = r["ms"][torch.bfloat16], r["ms"].get(torch.float32, no_f32)
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=r["launches"],
                   max_abs_err=r["err"][torch.bfloat16], ms=bf[0],
                   plain_ms=bf[2], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], library_ms=r["library_ms"],
                   dtype="bfloat16",
                   ms_eager=bf[1], plain_ms_eager=bf[3],
                   max_abs_err_f32=r["err"].get(torch.float32),
                   ms_f32=f32[0], plain_ms_f32=f32[2])
        for key in ("ms_b16", "ms_b64", "ms_causal", "ms_2h", "ms_int8",
                    "ms_int8_b16", "ms_int8_b64", "ms_d128", "ms_rpr",
                    "ms_mlp", "ms_moemamba", "ms_d320", "ms_d512", "ms_d1024",
                    "ms_int8_hd8",
                    "ms_int8_hd8_b64", "ms_n2048", "ms_floor", "ms_floor_b16",
                    "ms_floor_b64", "ms_noattn", "ms_noattn_b16",
                    "ms_noattn_b64", "ms_tn", "ms_diag") + (
                        HEAD_FORM_KEYS + tuple(f[0]
                                               for f in RAW_VIDEO_FORMS)):
            # other shapes; int8 weights or caches; head sizes 128 and 512,
            # and 8 with int8 caches; the RPR / MLP-expert layer forms, the
            # scan inside moemamba and at d_state 2048, row 1 in the
            # extractors' forms, the probes' modes and forms, each with
            # its own bound
            if key in r:
                t = r[key][torch.bfloat16]
                row[key], row["plain_" + key] = t[0], t[2]
                row[key + "_f32"] = r[key].get(torch.float32, no_f32)[0]
            if "err_" + key in r:
                row["max_abs_err_" + key] = r["err_" + key][torch.bfloat16]
                row["max_abs_err_" + key + "_f32"] = \
                    r["err_" + key].get(torch.float32)
            if "library_" + key in r:
                row["library_" + key] = r["library_" + key]
            if "form_bound_" + key in r:  # (ms, "bytes" / "operations")
                row["bound_" + key], row["bound_by_" + key] = \
                    r["form_bound_" + key]
        # the probes' cold times, TF32 yardsticks and bounds, and the
        # no-cache form's library call (rows 13 and 14)
        for key in r:
            if key.startswith(("cold_", "library_tf32_", "library_ms_noattn")
                              ) or (key.startswith("form_bound_")
                                    and key.endswith("_f32")):
                row[key] = r[key]
            if key.startswith("library_") and key.endswith("_f32"):
                row[key] = r[key]
        # flash attention at the V3 encoder's 2H; the launches of the
        # wirings' and the regression zoo's paths
        for key in ("launches_2h", "launches_wirings", "launches_zoo",
                    "launches_raw_video", "launches_train_zoo",
                    "launches_clis", "launches_multi_gpu",
                    "launches_published", "launches_wide",
                    "launches_probe", "launches_hd512", "launches_hd4"):
            if key in r:
                row[key] = r[key]
        if "err_int8_hd8" in r:  # int8 KV caches at head size 8
            row.update(max_abs_err_int8_hd8=r["err_int8_hd8"][torch.bfloat16],
                       max_abs_err_int8_hd8_f32=r["err_int8_hd8"][
                           torch.float32])
        if "err_int8" in r:  # int8 weights (decode layers), int8 KV caches
            row.update(max_abs_err_int8=r["err_int8"][torch.bfloat16],
                       max_abs_err_int8_f32=r["err_int8"][torch.float32],
                       bound_ms_int8=r["bound_ms_int8"],
                       launches_int8=r["launches_int8"])
        rows.append(row)
    print(f"before the redesign (an earlier run's times, PERF.md; not "
          f"measured by this run): {json.dumps(PREV_MS)}")
    for row in rows:  # the redesigned kernels: this run's times
        for key in PREV_MS.get(row["name"], {}):
            lib = row.get("library_" + key if key != "ms" else "library_ms")
            lib = "none" if lib is None else f"{lib:.4f} ms"
            print(f"redesigned {row['name']} {key}: {row[key]:.4f} ms, "
                  f"library {lib} [{card}]; earlier design "
                  f"{PREV_MS[row['name']][key]:.4f} ms (not this run)")
    print(f"breakdown before the redesign (an earlier run's, PERF.md; not "
          f"measured by this run): {json.dumps(PREV_BREAKDOWN)}")
    print(f"breakdown after (this run): {json.dumps(report['breakdown'])}")
    print(f"gemv yardstick (this run): {json.dumps(report['gemv_qkv'])}")
    print(f"expert cut (this run): {json.dumps(report['expert_cut'])}")
    print(f"scan shapes (this run, device ms): "
          f"{json.dumps(report['scan_shapes'])}")
    print(f"train: {json.dumps(report['train'])}")
    print(f"train zoo (this run): {json.dumps(report['train_zoo'])}")
    print(f"multi-GPU, ranks sharing one card over gloo (functional, not "
          f"scaling; this run): {json.dumps(report['multi_gpu'])}")
    print(f"wide heads and states, head size 8 with int8 caches (this "
          f"run): {json.dumps(report['wide'])} [{card}]")
    print(f"probes (this run, device ms): {json.dumps(report['probes'])}")
    print(f"published layouts (this run; ms from CUDA events, ms/token "
          f"and clips/s from the checkpoint and the in-memory conversion): "
          f"{json.dumps(report['published'])} [{card}]")
    print(f"V3 decode step: {json.dumps(report['v3_step'])}")
    print(f"B=1 backends, ms/token: {json.dumps(report['backends'])}")
    print(f"int8 KV at B=16: {json.dumps(report['int8_kv_b16'])}")
    print(f"V3.1 int8 weights: {json.dumps(report['v3_int8'])}")
    print(f"B=1 decode step: {json.dumps(report['b1_step'])}")
    print(f"wirings (this run): {json.dumps(report['wirings'])}")
    print(f"regression zoo, forward ms (this run): "
          f"{json.dumps(report['zoo'])}")
    print(f"extractors, forward ms of 30 frames (this run): "
          f"{json.dumps(report['extractors'])}")
    print(f"raw video (this run; host seconds): "
          f"{json.dumps(report['raw_video'])}")
    print(f"new backbones, regression forward ms (this run): "
          f"{json.dumps(report['new_backbones'])}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
