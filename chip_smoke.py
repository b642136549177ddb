"""Smoke run of inferflow_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from ``inferflow_tpu_torch/kernels/csrc`` (one nvcc
per source, all at once, into ``build/inferflow_tpu_torch/``), then:

1. prints the card (torch's name; nvidia-smi's name and power limit);
2. holds each kernel against its plain PyTorch version at the shapes the
   serving paths give it and times kernel, plain version and one PyTorch
   library call where there is one (timed here only, never used by the
   package), with the L2 cache flushed before every timed launch; one
   JSON line each:
   - B1 dequant-matmul: M in {1, 4, 256} for the five tinyllama-1.1b
     projections (library: cuBLAS on the pre-dequantized weight);
   - B2 decode attention: 4 slots, 1024-row context, layer 21; B3 chunk
     attention: a 256-row chunk at row 256 (library:
     scaled_dot_product_attention on pre-dequantized K/V);
   - B4 the whole-model fused decode step at full tinyllama-1.1b width and
     depth (i8mm weights from seed-0 Q4_B64T1, a 1024-row Q8 cache) at
     B = 4 (lengths 1023, 700, 301, 17) and B = 1; and its int8 GEMV alone
     at the four layer shapes and the lm_head, M in {1, 4} (library:
     torch._int_mm on the same int8 rows, padded to the 24 rows it takes);
   - B7 paged decode attention at B = 16 (lengths B7_LENGTHS, 0 to 32767,
     on shuffled pages of a 1024-page one-layer pool) at llama2-7b width
     (H = 32, g = 1, D = 128, 128-token pages) and tinyllama-1.1b width
     (H = 4, g = 8, D = 64, 256-token pages), Q8 and bf16 pools (library:
     scaled_dot_product_attention over the same rows already gathered into
     a dense bf16 tensor; the gather is not timed);
   - B4's paged mode (f) at tinyllama-1.1b width and depth, B = 4 and 1,
     the cache rows of the B4 phase copied into shuffled pages: against its
     plain version and against dense B4 on the same rows;
3. serves four greedy queries (prompts of 7, 60, 200 and 300 tokens, 16
   new tokens each in (a), ENGINE_CUT_CPU_NEW in (b) and (d); the
   300-token prompt takes the chunked path, kernel B3) with the engine at
   full tinyllama-1.1b width, a Q8 KV cache, 4 slots and a 1024-token
   context, three times:
   (a) the default layout, which resolves to i8mm on the card: every
       decode step runs B4 (and the lm_head the int8 GEMV); B1 and B2
       must not launch;
   (b) slice 1's packed Q4_B64T1 wire layout at ENGINE_B_LAYERS layers
       (per-layer decode, kernels B1 and B2);
   (d) (a) with paging on (default pool), cut to ENGINE_D_LAYERS layers:
       the 300-token prompt is prefilled whole; every decode step runs
       B4's paged mode; B7 and B3 must not launch;
   each run counts the kernels' launches (reset just before it), reads the
   device memory, profiles three decode steps of one more query (device
   busy and idle share, device time by kernel), and holds every served
   logits row against the same engine on the CPU (plain versions), run in
   the same interleaving and fed the tokens the card served;
4. serves configs/inferflow_service.paged.ini, read with the package's own
   load_engine_config: llama2-7b at full width (make_spec; the model dir
   has no config.json) from seed-0 Q4_B64T1, resolved to i8mm on the card,
   16 slots, a 32768-token context and a 131072-token Q8 page pool:
   (c) at full depth, 24 greedy queries (ENGINE_C_PROMPTS, 7 to 1024
       tokens, 16 new tokens each; more queries than slots, so 8 reuse a
       slot and released pages): every decode step takes the per-layer
       loop (B = 16) with B7 in each layer; B4, B2 and B3 must not launch;
       every sampled row is held against a dense-cache engine on the card
       (same weights, 16 slots, a 2048-token context, whole-prompt
       prefill), served first and freed before the paged one is built,
       whose tokens the paged engine is fed;
   (c-cpu) the same configuration at ENGINE_CCPU_LAYERS layers,
       prompts of at most 300 tokens and ENGINE_CUT_CPU_NEW new tokens,
       held against the CPU engine;
5. reads configs/inferflow_service.i4.ini the same way: llama2-7b from
   seed-0 Q4_B64T1 in the i4 layout (the ini's device_layout), 8 slots, a
   4096-token context, and
   - holds B5 (i4_matmul) at the five products' shapes (w2 also stored
     K-padded to 11264), M in {1, 8, 12, 256}, and B4 mode (b)'s i4x8 GEMV
     alone (M in {1, 8}) against their plain versions; times them (B5's
     library: torch.matmul on the pre-dequantized bf16 weight);
   - holds B4 mode (b) at 32 layers, B = 8 (I4_FUSED_LENGTHS) and B = 1,
     against its plain version (one layer and the stack; B4 (a) on (c)'s
     i8mm weights as a control) and times it beside B4 (a);
   (e) serves ENGINE_E_PROMPTS (7 to 2000 tokens) at full depth: every
       decode step B4 (b), B5 and B3 launch, B1, B2, B7, B4 (a) and the
       int8 GEMV do not; every sampled row is held against a packed engine
       on the card (B1/B2) built from the same Q4_B64T1 values and fed (e)'s
       tokens; reports the resident weight bytes against (c)'s i8mm ones;
   (e-cpu) the same at ENGINE_ECPU_LAYERS layers, against the CPU engine;
   (f) ENGINE_F_LAYERS layers at ENGINE_F_SLOTS slots (B > 8: the per-layer
       loop, B5 and B2), against the CPU engine;
6. reads configs/inferflow_service.q3h.ini the same way: llama2-13b from
   seed-0 Q3H_B64T1 kept as pair8 (the ini's device_layout = packed; the
   auto rule would pick i8mm), 8 slots, a 4096-token context, and
   - holds B6 (q3h_matmul) at the five products' shapes, M in {1, 8, 12,
     256}, against its plain version and times it (library: torch.matmul
     on the pre-dequantized bf16 weight);
   - holds B2 and B3 at llama2-13b width (H = 40, D = 128) against their
     plain versions: B2 at (g)'s 8 slots (G_ATTN_LENGTHS) over a
     4096-row cache, B3 a 256-row chunk at row G_CHUNK_START;
   (g) serves ENGINE_G_PROMPTS (7 to 2000 tokens) at full depth: every
       product B6, every decode step the per-layer loop with B2, chunks
       B3; no fused step, B1, B5 or int8 GEMV; every sampled row is held
       against a dense twin on the card (the same values dequantized to
       bf16, linear's dense branch) fed (g)'s tokens, built after (g)'s
       engine and cache are freed; reports the model's bytes against the
       i8mm bytes the auto rule would have placed;
   (g-cpu) the same at ENGINE_GCPU_LAYERS layers (a 300-token prompt: B3
       at this width too), against the CPU engine;
7. reads configs/inferflow_service.q8.ini the same way: llama2-7b from
   seed-0 Q8_B32T2 (the ini's `Q8`; no device_layout: the auto rule keeps
   byte formats as they are), 8 slots, a 4096-token context, and
   - holds B1's Q8 case (q8_matmul) at the five products' shapes (w2 also
     stored K-padded to 11264), M in {1, 8, 12, 256}, in Q8_B32T2 and
     Q8_B32T1, against its plain version, the same bits twice, and times
     it (library: torch.matmul on the pre-dequantized bf16 weight);
   - holds B4 mode (c) (fused_decode_step_byte) at 32 layers, B = 8
     (Q8_FUSED_LENGTHS) and B = 1, against its plain version (one layer in
     both Q8 formats, and the stack), the same bits twice, and times it;
   (h) serves ENGINE_H_PROMPTS (7 to 2000 tokens) at full depth: every
       decode step B4 (c), prefill and the lm_head B1-Q8, chunks B3; no
       B1-Q4, B2, B5, B6, B7, B4 (a) or (b) or int8 GEMV; every sampled
       row is held against a dense bf16 twin on the card (the codec's
       weights, linear's dense branch) fed (h)'s tokens, built after (h)'s
       engine is freed; reports the weight bytes against run (c)'s i8mm
       ones;
   (h-cpu) the same at ENGINE_HCPU_LAYERS layers (a 300-token prompt: B3),
       against the CPU engine;
   then, at tinyllama-1.1b width with PROMPT_LENS and 4 slots, each against
   the CPU engine:
   (i) device_layout = q8c from seed-0 Q4_B64T1 at ENGINE_I_LAYERS
       layers: every weight re-encoded as Q8_B32T2, every decode step B4
       (c); ENGINE_CUT_CPU_NEW new tokens per query;
   (j) device_layout = mixed at ENGINE_J_LAYERS layers: q8c FFN weights
       (B1-Q8), Q4 wire attention and lm_head (B1-Q4), the per-layer
       decode with B2, chunks B3;
8. reads configs/inferflow_service.moe.ini the same way: mixtral-8x7b at
   full width (8 experts, top-2) from seed-0 Q4_B64T1, resolved to i8mm on
   the card (about 47 GB), 8 slots, a 4096-token context; prints the
   weights' bytes against the count and the KV cache's, and
   - holds B4's routed-expert mode (g) (fused_decode_step_moe) at 32
     layers, B = 8 (MOE_FUSED_LENGTHS) and B = 1, against its plain
     version: each layer alone on the plain stack's input to it (routes
     and outputs), then the stack, the same bits twice, with the share of
     routing decisions that agree; times it against the bytes of the
     experts its routing chose; the same for one layer with Q8_B32T2
     experts (mode (c) products);
   (k) serves ENGINE_K_PROMPTS (7 to 2000 tokens) at full depth: every
       decode step B4 (g), chunks B3, the decode lm_head the int8 GEMV; no
       B1, B2, B5, B6, B7 or other B4 mode; every sampled row is held
       against a twin on the card (the same weights and engine fed (k)'s
       tokens, its decode steps B4 (g)'s plain version);
   (k-cpu) the same at ENGINE_KCPU_LAYERS layers with short prompts,
       against the CPU engine;
9. reads configs/inferflow_service.q6.ini the same way: llama2-7b from
   seed-0 Q6_B64T1 kept in its wire planes (the ini's device_layout =
   packed; the auto rule would pick i8mm), 8 slots, a 4096-token context,
   and
   - holds B1's sub-byte case (subbyte_matmul) against its plain version,
     the same bits twice, M in {1, 8, 12, 256}: Q6_B64T1 at the five
     products' shapes (w2 also stored K-padded to 11264), and each other
     sub-byte format (Q5_B64T1, Q5_B32T1, Q4_B32T1A/B, Q4_B32T2, Q4_B16,
     Q3_B32T1A/B, Q2_B32T1A/B; the Q6 weights' values quantized again) at
     w1n3 and the K-padded w2; times it (library: torch.matmul on the
     pre-dequantized bf16 weight, a yardstick only);
   (l) serves ENGINE_L_PROMPTS (7 to 2000 tokens) at full depth: every
       product B1's sub-byte case, every decode step the per-layer loop
       with B2, chunks B3; no fused step, other B1 case, B5, B6, B7 or
       int8 GEMV; every sampled row is held against a dense bf16 twin on
       the card (the codec's weights, linear's dense branch) fed (l)'s
       tokens, built after (l)'s engine is freed; reports the model's
       bytes against the i8mm bytes the auto rule would have placed;
   (l-cpu) the same at ENGINE_LCPU_LAYERS layers (a 300-token prompt:
       B3), against the CPU engine;
   (m) tinyllama-1.1b from seed-0 Q3_B32T1A (a 2-bit and a 1-bit plane,
       32-row blocks), packed, at ENGINE_M_LAYERS layers with PROMPT_LENS
       and 4 slots, against the CPU engine;
10. writes a llama2-7b checkpoint under CKPT_ROOT (gitignored; deleted at
   the end) at full width and depth: seed-0 bf16 weights under the
   Hugging Face names in safetensors shards of at most ~2 GB with their
   index, Llama-2-7b's published config.json, a generated 32000-entry
   byte-level BPE tokenizer.json and a copy of the model dir's
   model_spec.json (it prints the free disk space first and fails when it
   is short), and reads configs/inferflow_service.q4b32.ini with that tree
   as its data root: llama2-7b in Q4_B32T1A (32-row blocks) under the i4
   layout, 8 slots, a 4096-token context;
   (n) builds the engine with make_engine (reading and quantizing timed)
       and serves ENGINE_N_PROMPTS (7 to 2000 tokens) made from text
       through the loaded tokenizer, 16 greedy tokens each: every decode
       step B4 (b) in its 32-row instantiation, prefill B5's 32-row entry
       and B3; no B1, B2, B4 (a), int8 GEMV or other i4 geometry; prints
       the resident weight bytes beside run (e)'s, a three-step decode
       profile and one output decoded to text;
   - holds B5 and the i4x8 GEMV alone on Q4_B32T1A, Q4_B32T1B, Q4_B32T2
     and Q4_B16 (the loaded weights' values quantized again for the other
     three) at the five products' shapes, M in {1, 8, 12, 256} (the GEMV
     {1, 8}), and B4 (b) at 32 layers on Q4_B32T1A, Q4_B32T2 and Q4_B16,
     B = 8 (I4_FUSED_LENGTHS) and B = 1, each layer alone on the plain
     stack's input and then the stack, against their plain versions, and
     times them;
   - holds every row (n) sampled against a twin: the same checkpoint and
     ini with the packed layout (Q4_B32T1A wire planes: B1's sub-byte case
     and B2), built after (n)'s engine is freed and fed (n)'s tokens;
   - holds B4's mode (b') (the i4 layout with exact bf16 activations,
     INFERFLOW_I4_DOT=bf16 for these phases only) against its plain
     versions: its GEMV alone on Q4_B64T1, Q4_B32T1A, Q4_B32T2 and Q4_B16
     at the five products, M in {1, 8}, timed beside mode (b)'s GEMV
     (library: torch.matmul on the pre-dequantized bf16 weight); the
     step at 32 layers on the loaded Q4_B32T1A weights, B = 8 and B = 1,
     each layer alone and then the stack, timed beside mode (b);
11. (o) serves the same checkpoint and ini over HTTP in mode (b'): the
   engine from make_engine, warmed up, behind InferFlowService on
   127.0.0.1 (an ephemeral port), driven with InferFlowClient and raw
   requests under a socket timeout (O_TIMEOUT_S): health; one prompt of
   text blocking and streamed (SSE), the two texts equal and equal to the
   same engine's generate on that prompt alone; OpenAI
   /v1/chat/completions blocking and streamed (ending in data: [DONE]);
   12 concurrent greedy requests of (e)'s lengths made from text, each
   ending with its MAX_NEW tokens (8 slots: a request answered 429 is
   sent again); every decode step B4 (b') in its 32-row instantiation, no
   mode (b) step, the loop thread alive until stopped and without an
   error; prints time to first token and ms per token from the client's
   clock, tokens per second over the 12 requests and the decode idle
   share under torch.profiler while 8 requests decode; then its rows,
   fed (n)'s tokens, against (n)'s packed twin at (n)'s gates;
   (n-cpu) a one-layer checkpoint of the same width, the card engine
       against the CPU engine, both from make_engine; (n-t2) and (n-b16)
       the same checkpoint in Q4_B32T2 and Q4_B16, the i4 engine on the
       card against its twin on the card whose decode steps run B4 (b)'s
       plain version.

Exits non-zero if any check fails.  The last line is the device record
``{"ok": true, "device": {...}}``; the line before it holds the kernel
summary ``{"kernels": [...]}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor cores, H100 SXM data sheet
KERNEL_REL_TOL = 8e-3  # |kernel - plain| <= tol * max|plain|: ~2 bf16 ulps
TIMED_ITERS = 20
MODEL = "tinyllama-1.1b"
PROMPT_LENS = (7, 60, 200, 300)
MAX_NEW = 16
SLOTS, CONTEXT = 4, 1024
# every served logits row on the card against the CPU engine fed the same
# tokens: kernel and plain version differ only in summation order, and the
# bf16 roundings this moves grow through 22 layers (first rows measured
# 0.022-0.035 on an H100); the gate is about twice that, under 4% of the
# largest logit (~2.2)
ENGINE_LOGIT_TOL = 0.08
# the i8mm engine (a) against the CPU engine: the card's fused step walks
# the cache in another order than the plain version and can move a bf16
# rounding, and with it a row's int8 activation scale, that the plain
# version does not
ENGINE_I8MM_LOGIT_TOL = 0.12  # measured 0.053-0.062 (H100, 700 W)
# depth of the packed run (b): 2 layers, to keep the whole script near
# half its time limit on a slow host; its CPU reference dominates
ENGINE_B_LAYERS = 2
FUSED_LENGTHS = (1023, 700, 301, 17)
# B4 against its plain version.  One layer (the same inputs on both
# sides): ONE_LAYER_TOL x max|plain|; at B = 1 (float32 throughout) the
# two agree exactly, at B > 1 both round p * vscale to bf16 but relative
# to other running maxima (the kernel's split walk, the plain version's
# TPU walk), which can move an int8 code of the wo product: measured 0 and
# 1.4%.  All 22 layers: FUSED_TOL x max|plain|; the
# random-weight stack amplifies each moved bf16 rounding (and with it an
# int8 activation code of the next product) layer by layer: measured 4.2%
# at B = 1 and 6.3% at B = 4 (H100, 700 W), and the JAX package's own two
# attention modes disagree the same way (tests/test_torch_decode_step.py)
FUSED_TOL = 0.12
ONE_LAYER_TOL = 0.03

# B7 against its plain version: both compute in float32 and round once to
# bf16; they differ in summation order only
B7_LENGTHS = (32767, 16384, 8191, 4097, 2048, 1023, 700, 301, 128, 127, 64,
              17, 5, 1, 1, 0)
B7_POOL_PAGES = 1024
ENGINE_D_LAYERS = 6  # depth of the paged tinyllama run (d)
PAGED_INI = "configs/inferflow_service.paged.ini"
PAGED_MODEL = "llama2-7b"
I4_MODEL_NAME = "llama2-7b"
ENGINE_C_PROMPTS = (7, 1024, 13, 600, 33, 300, 64, 900, 100, 17, 256, 512,
                    129, 700, 45, 1000, 8, 384, 200, 77, 1023, 150, 60, 450)
ENGINE_C_DENSE_CONTEXT = 2048
# the runs against the CPU engine at llama2-7b and llama2-13b width, (c-cpu),
# (e-cpu), (f), (g-cpu) and (h-cpu), take one layer (two before the MoE
# runs were added): their CPU references are most of the script's time,
# and with the MoE runs a slow host would otherwise pass 900 s
ENGINE_CCPU_LAYERS = 1
ENGINE_CCPU_PROMPTS = (7, 300, 13, 150, 33, 250, 64, 100, 17, 200, 129, 45,
                       8, 77, 60, 290, 21, 128)
# the paged engine (c) against the dense engine on the card: the same
# prefill; decode differs in the attention kernel (B7 against B2), whose
# float32 sums run in another order, and each moved bf16 rounding grows
# through 32 random-weight layers
ENGINE_C_TOL = 0.12

# the i4 layout: configs/inferflow_service.i4.ini, llama2-7b
I4_INI = "configs/inferflow_service.i4.ini"
I4_CONTEXT = 4096
# B4 (b) at B = 8 (lengths spread up to the last cache row) and B = 1
I4_FUSED_LENGTHS = (4095, 3000, 2048, 1500, 1023, 700, 301, 17)
# B4 (b) against its plain version: one layer ONE_LAYER_TOL x max|plain|;
# all 32 layers I4_FUSED_TOL x max|plain|.  The i4x8 products sum their
# block terms in float32 in another order than the plain version (whose
# order is the TPU kernel's), so unlike B4 (a) the two differ by float
# ulps even at B = 1, and each moved bf16 rounding moves an int8
# activation code of the next product; 32 random-weight layers amplify
# it: measured 1.3% (B = 1) and 2.1% (B = 8) for one layer, 15.3% and
# 10.6% for the stack (H100, 700 W), against B4 (a)'s 4.2% and 6.9% over
# tinyllama's 22 layers
I4_FUSED_TOL = 0.25
# the plain step takes about a second at this size: timed over fewer calls
# (one for the formats beside Q4_B64T1, whose plain stacks take 1.3-2.2 s)
I4_PLAIN_ITERS = 3
I4_FORMATS_PLAIN_ITERS = 1
# run (e): 12 queries of 7 to 2000 tokens; those over 256 take the chunked
# prefill (B3)
ENGINE_E_PROMPTS = (7, 2000, 13, 600, 33, 300, 64, 1200, 100, 17, 256, 900)
# run (e) against the packed engine on the card (B1/B2, bf16 activations)
# fed (e)'s tokens: prefill rows differ by B5's fold rounding (n*sc +
# (8*sc + base) against q*sc + base: an ulp of some bf16 weights) and sum
# orders; decode rows also by i4x8's int8 activations
# (measured: every prefill row 0.0, decode rows at most 0.0547, 184 of 192
# argmax equal; H100, 700 W): the gates are about two bf16 ulps of a logit
# below 4 for the prefill rows and twice the measured worst for decode
ENGINE_E_PREFILL_TOL = 0.04
ENGINE_E_DECODE_TOL = 0.12
# the runs against the CPU engine at llama2-7b, llama2-13b and mixtral
# width ((c-cpu), (e-cpu), (f), (g-cpu), (h-cpu), (k-cpu), (l-cpu),
# (n-cpu)), whose plain versions dequantize every weight on each call (a
# decode step takes seconds on the host), and the tinyllama runs (b),
# (d), (i), (j), (m): ENGINE_CUT_CPU_NEW tokens per query (8 before the
# checkpoint runs (n) were added, 16 for (c-cpu) and the tinyllama runs
# but (i))
ENGINE_CUT_CPU_NEW = 4
ENGINE_ECPU_LAYERS = 1
ENGINE_ECPU_PROMPTS = (7, 300, 13)
# run (f): B > 8, the per-layer loop with B5 and B2
ENGINE_F_LAYERS, ENGINE_F_SLOTS, ENGINE_F_CONTEXT = 1, 12, 1024
ENGINE_F_PROMPTS = (7, 13, 33, 64, 100)
# measured 0.0703 for (e-cpu) (H100, 700 W)
ENGINE_CUT_CPU_TOL = 0.12

# Q3H: configs/inferflow_service.q3h.ini, llama2-13b, pair8 weights
Q3H_INI = "configs/inferflow_service.q3h.ini"
Q3H_MODEL_NAME = "llama2-13b"
# run (g): 12 queries of 7 to 2000 tokens at full depth; those over 256
# take the chunked prefill (B3)
ENGINE_G_PROMPTS = (7, 2000, 13, 600, 33, 300, 64, 1200, 100, 17, 256, 900)
# run (g) against a dense twin on the card (the same bf16 weights, the
# float32 matmul of linear's dense branch) fed (g)'s tokens: B6 multiplies
# the same bf16 weights and differs in float32 summation order only, which
# 40 random-weight layers amplify as they did for run (c)'s 32 (measured
# 0.057 there): about twice that
ENGINE_G_TOL = 0.12
# B2 and B3 at (g)'s width: its 8 slots at the lengths its eight longest
# queries reach (prompt + MAX_NEW), and a whole chunk deep in its
# 2000-token prompt
G_ATTN_LENGTHS = (2016, 1216, 916, 616, 316, 272, 116, 80)
G_CHUNK_START = 1536
# (g-cpu): the 300-token prompt takes a chunk (B3) at llama2-13b width
ENGINE_GCPU_LAYERS = 1
ENGINE_GCPU_PROMPTS = (7, 300, 13)

# Q8 block weights: configs/inferflow_service.q8.ini, llama2-7b in Q8_B32T2
Q8_INI = "configs/inferflow_service.q8.ini"
Q8_MODEL_NAME = "llama2-7b"
Q8_CONTEXT = 4096
# B4 (c) at B = 8 (lengths spread up to the last cache row) and B = 1
Q8_FUSED_LENGTHS = (4095, 3000, 2048, 1500, 1023, 700, 301, 17)
# B4 (c) against its plain version: one layer ONE_LAYER_TOL x max|plain|;
# all 32 layers Q8_FUSED_TOL x max|plain|.  Both take the same bf16
# weights and bf16 activations and differ in float32 summation order
# (and, at B > 1, in the batched attention's bf16 roundings relative to
# other running maxima); 32 random-weight layers amplify each moved bf16
# rounding of the residual, xn and hglu, but no int8 activation code
# moves with it, as in B4 (a) and (b): measured 0-0.7% for one layer and
# 2.6% (B = 1) and 1.9% (B = 8) for the stack (H100, 700 W), against B4
# (b)'s 10.6-15.3%: about three times the measured stack
Q8_FUSED_TOL = 0.08
# run (h): 12 queries of 7 to 2000 tokens; those over 256 take the chunked
# prefill (B3)
ENGINE_H_PROMPTS = (7, 2000, 13, 600, 33, 300, 64, 1200, 100, 17, 256, 900)
# run (h) against a dense bf16 twin on the card (the codec's weights under
# linear's dense branch; the per-layer loop with B2) fed (h)'s tokens.
# Prefill rows: B1-Q8 multiplies the twin's weights bit for bit and
# differs in float32 summation order only, which 32 random layers amplify
# (run (g) measured 0.043 over 40 layers, (h) 0.039): four bf16 steps of
# a logit between 2 and 4.  Decode rows also differ by B4 (c)'s weights,
# bf16(q * bf16(sc)) where the twin has bf16(q * sc) (the TPU kernel's
# rounded scale): the gate of earlier decode rows (measured 0.043; H100,
# 700 W)
ENGINE_H_PREFILL_TOL = 0.0625
ENGINE_H_DECODE_TOL = 0.12
# (h-cpu): the 300-token prompt takes a chunk (B3); measured 0.0156
# against the CPU engine at 2 layers, and (i) 0.039 at 22, (j) 0.0195 at 4
# (H100, 700 W)
ENGINE_HCPU_LAYERS = 1
ENGINE_HCPU_PROMPTS = (7, 300, 13)
# runs (i) and (j) at tinyllama-1.1b width against the CPU engine, cut in
# depth (from 22 and 4 layers) so that the whole script, with the MoE
# runs and the checkpoint runs (n), stays near 900 s on a slow host: (i)
# the q8c layout, (j) the mixed layout (q8c FFN, Q4 wire attention and
# lm_head), per-layer decode
ENGINE_I_LAYERS = 2
ENGINE_J_LAYERS = 1

# routed MoE: configs/inferflow_service.moe.ini, mixtral-8x7b (8 experts,
# top-2) from seed-0 Q4_B64T1, resolved to i8mm on the card
MOE_INI = "configs/inferflow_service.moe.ini"
MOE_MODEL_NAME = "mixtral-8x7b"
MOE_CONTEXT = 4096
# B4 (g) at B = 8 (lengths spread up to the last cache row) and B = 1
MOE_FUSED_LENGTHS = (4095, 3000, 2048, 1500, 1023, 700, 301, 17)
# B4 (g) against its plain version, first layer by layer, each layer fed
# the plain stack's input to it.  A route is held only where the plain
# version's k-th and (k+1)-th probabilities differ by more than
# MOE_GAP_EPS: the kernel's gate dot sums the same float32 products in
# another order (~1e-7 of a probability), and its xn can differ from the
# plain rmsnorm by one bf16 step, which moves a probability by ~1e-3 at
# most (gate columns of norm ~0.5); where routes agree, one layer is held
# to ONE_LAYER_TOL x max|plain| as B4's other modes are.  The whole stack
# routes each layer on its own drifting input, so a route can flip where
# two probabilities are within that drift, and the slot's later layers
# then see another hidden state: its rows are held to MOE_FUSED_TOL x
# max|plain| over the slots whose routes agree in every layer (the
# drift of B4's other modes over 32 random layers, up to 15%: I4_FUSED_TOL),
# and the share of routing decisions that agree is reported.  Measured
# (H100 80GB HBM3, 700 W): one layer 1.25% (B = 8) and 0.82% (B = 1) with
# 99.6% and 100% of routes equal, every clear one; the stack 56% and 88%
# of routes equal, 3.1% over the one slot routed alike throughout
MOE_GAP_EPS = 2e-3
MOE_FUSED_TOL = 0.25
# run (k): 12 queries of 7 to 2000 tokens at full depth; those over 256
# take the chunked prefill (B3)
ENGINE_K_PROMPTS = (7, 2000, 13, 600, 33, 300, 64, 1200, 100, 17, 256, 900)
# run (k) against its twin on the card (the same weights and engine, fed
# (k)'s tokens, its decode steps B4 (g)'s plain version): the prefill runs
# the same kernels on both (measured 0.0); decode rows differ as the stack
# does, where a route that flips in one of 32 layers moves a row further
# (measured 0.198 at most, 187 of 192 argmax equal, largest |logit| 2.45;
# H100 80GB HBM3, 700 W): the gate is one and a half times that
ENGINE_K_PREFILL_TOL = 1e-6
ENGINE_K_DECODE_TOL = 0.3
# (k-cpu): one layer against the CPU engine (its dense combine runs all 8
# experts on every prompt row on the host): short prompts
ENGINE_KCPU_LAYERS = 1
ENGINE_KCPU_PROMPTS = (7, 128, 13)

# the sub-byte wire formats: configs/inferflow_service.q6.ini, llama2-7b in
# Q6_B64T1 under the packed layout
Q6_INI = "configs/inferflow_service.q6.ini"
Q6_MODEL_NAME = "llama2-7b"
# B1's sub-byte case beside Q6_B64T1: each format at w1n3 (the widest
# product of a layer) and w2 stored K-padded (K 11008 as 11264)
SUBBYTE_FORMATS = ("Q5_B64T1", "Q5_B32T1", "Q4_B32T1A", "Q4_B32T1B",
                   "Q4_B32T2", "Q4_B16", "Q3_B32T1A", "Q3_B32T1B",
                   "Q2_B32T1A", "Q2_B32T1B")
# run (l): 12 queries of 7 to 2000 tokens; those over 256 take the chunked
# prefill (B3)
ENGINE_L_PROMPTS = (7, 2000, 13, 600, 33, 300, 64, 1200, 100, 17, 256, 900)
# run (l) against a dense bf16 twin on the card (the codec's weights under
# linear's dense branch) fed (l)'s tokens: B1 multiplies the twin's
# weights bit for bit and differs in float32 summation order only, which
# 32 random-weight layers amplify as in runs (c), (g) and (h) (measured
# 0.057, 0.043 and 0.039 there): the gate of run (g), about twice that
# (measured 0.040 for (l); H100 80GB HBM3, 700 W)
ENGINE_L_TOL = 0.12
# (l-cpu): the 300-token prompt takes a chunk (B3) at llama2-7b width;
# measured 0.0156 against the CPU engine, and (m) 0.0156 (H100, 700 W)
ENGINE_LCPU_LAYERS = 1
ENGINE_LCPU_PROMPTS = (7, 300, 13)
# run (m): tinyllama-1.1b in Q3_B32T1A, packed, one layer (cut from run
# (b)'s two for the checkpoint runs (n))
ENGINE_M_LAYERS = 1

# checkpoints from disk: configs/inferflow_service.q4b32.ini, llama2-7b in
# Q4_B32T1A under the i4 layout, loaded through make_engine from a
# checkpoint this script writes under CKPT_ROOT (gitignored) and deletes
Q4B32_INI = "configs/inferflow_service.q4b32.ini"
Q4B32_MODEL = "llama2_7b"  # the ini's model: its dir under models/
CKPT_ROOT = "build/checkpoints"
CKPT_SHARD_BYTES = 2 * 10 ** 9  # safetensors shards of at most ~2 GB
# Llama-2-7b's published hyperparameters (its config.json)
LLAMA2_7B_CONFIG = dict(hidden_size=4096, intermediate_size=11008,
                        layers=32, heads=32, kv_heads=32, vocab_size=32000,
                        context=4096, eps=1e-5)
# the four 4-bit formats of the i4 layout beside Q4_B64T1: (B5's launch
# count, the i4x8 GEMV's alone, the fused step's with such products)
I4_FORMATS = {
    "Q4_B32T1A": ("i4_matmul_b32", "i4x8_gemv_b32", "fused_decode_step_i4_b32"),
    "Q4_B32T1B": ("i4_matmul_b32", "i4x8_gemv_b32", "fused_decode_step_i4_b32"),
    "Q4_B32T2": ("i4_matmul_b32f", "i4x8_gemv_b32f",
                 "fused_decode_step_i4_b32f"),
    "Q4_B16": ("i4_matmul_b16f", "i4x8_gemv_b16f", "fused_decode_step_i4_b16f")}
# B4 (b) at 32 layers on these (Q4_B32T1B shares Q4_B32T1A's instantiation)
I4_STEP_FORMATS = ("Q4_B32T1A", "Q4_B32T2", "Q4_B16")
# run (n): run (e)'s 12 queries, made from text through the loaded
# tokenizer; against a packed twin of the same checkpoint and ini on the
# card (B1's sub-byte case and B2, bf16 activations, the codec's weights)
# fed (n)'s tokens, at run (e)'s gates: the prefill rows differ by B5's
# fold rounding and summation order, decode rows also by i4x8's int8
# activations, as in (e)
ENGINE_N_PROMPTS = ENGINE_E_PROMPTS
ENGINE_N_PREFILL_TOL = ENGINE_E_PREFILL_TOL
ENGINE_N_DECODE_TOL = ENGINE_E_DECODE_TOL
# (n-cpu): a one-layer checkpoint written the same way, the card engine
# against the CPU engine, both built by make_engine (each quantizes on its
# own device); then the same checkpoint with Q4_B32T2 and Q4_B16 ((n-t2),
# (n-b16)), the i4 engine on the card against its twin on the card whose
# decode steps run B4 (b)'s plain version, at ENGINE_CUT_CPU_TOL: against
# a packed twin their rows would also carry the i4x8 mode's int8
# activations (ROADMAP C4), which the plain-step twin shares
ENGINE_NCPU_PROMPTS = (7, 300, 13)
# B4 mode (b'), the i4 layout's bf16-unpack mode (INFERFLOW_I4_DOT set to
# anything but i8; csrc WeightMode 7-10): per block geometry its GEMV's
# launch count, mode (b)'s GEMV timed beside it, and its step's count.
# The GEMV alone on the four geometries at llama2-7b's five products (run
# (n)'s loaded Q4_B32T1A weights, their values quantized again for the
# others); the step at 32 layers on the loaded weights, held at mode (b)'s
# tolerances (ONE_LAYER_TOL per layer, I4_FUSED_TOL for the stack)
I4BF16_FORMATS = {
    "Q4_B64T1": ("i4bf16_gemv", "i4x8_gemv", "fused_decode_step_i4bf16"),
    "Q4_B32T1A": ("i4bf16_gemv_b32", "i4x8_gemv_b32",
                  "fused_decode_step_i4bf16_b32"),
    "Q4_B32T2": ("i4bf16_gemv_b32f", "i4x8_gemv_b32f",
                 "fused_decode_step_i4bf16_b32f"),
    "Q4_B16": ("i4bf16_gemv_b16f", "i4x8_gemv_b16f",
               "fused_decode_step_i4bf16_b16f")}
# run (o): the HTTP/OpenAI service (serving/http_server.InferFlowService
# on 127.0.0.1, an ephemeral port) over make_engine on run (n)'s
# checkpoint and ini, with INFERFLOW_I4_DOT=bf16 for this run only, warmed
# up before it binds; driven by serving/client.InferFlowClient under a
# socket timeout of O_TIMEOUT_S: health, one prompt blocking and streamed
# (O_PROMPT_WORDS words of text), OpenAI blocking and streamed, then run
# (e)'s 12 prompt lengths made from text as 12 concurrent greedy requests
# of MAX_NEW tokens (8 slots: the service answers 429 while every slot is
# taken, and a request is sent again O_RETRY_S later), then O_PROFILE_Q
# short requests of O_PROFILE_NEW tokens decoding together, O_PROFILE_STEPS
# engine steps of them under torch.profiler.  Its rows, fed (n)'s tokens,
# are held against (n)'s packed twin at (n)'s gates; with bf16 activations
# in every product they are expected nearer the twin than (n)'s i4x8 rows
O_TIMEOUT_S = 300.0
O_RETRY_S = 0.05
O_PROMPT_WORDS = 40
O_PROFILE_Q = 8
O_PROFILE_NEW = 64
O_PROFILE_STEPS = 24
ENGINE_O_PROMPTS = ENGINE_N_PROMPTS
ENGINE_O_MUST = ("fused_decode_step_i4bf16_b32", "i4_matmul_b32",
                 "chunk_attention")

KERNEL_SOURCES = {
    "dequant_matmul": ("inferflow_tpu_torch/kernels/csrc/dequant_matmul.cu",
                       "inferflow_tpu/kernels/dequant_matmul.py:146"),
    "decode_attention": ("inferflow_tpu_torch/kernels/csrc/attention.cu",
                         "inferflow_tpu/kernels/attention.py:68"),
    "chunk_attention": ("inferflow_tpu_torch/kernels/csrc/attention.cu",
                        "inferflow_tpu/kernels/attention.py:507"),
    "fused_decode_step": ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
                          "inferflow_tpu/kernels/decode_step.py:255"),
    # B4's int8 GEMV (the TPU kernel's percol tile, stream_mm), also the
    # i8mm lm_head at decode
    "i8mm_gemv": ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
                  "inferflow_tpu/kernels/decode_step.py:502"),
    "paged_decode_attention": ("inferflow_tpu_torch/kernels/csrc/attention.cu",
                               "inferflow_tpu/kernels/attention.py:283"),
    "i4_matmul": ("inferflow_tpu_torch/kernels/csrc/dequant_matmul.cu",
                  "inferflow_tpu/kernels/dequant_matmul.py:313"),
    # B4 in its mode (b), i4x8 (the TPU kernel's i4x8 tile at :537)
    "fused_decode_step_i4": ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
                             "inferflow_tpu/kernels/decode_step.py:255"),
    # mode (b)'s GEMV alone (timed alone; on the path inside B4 (b))
    "i4x8_gemv": ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
                  "inferflow_tpu/kernels/decode_step.py:537"),
    # B6 in its pair8 mode (Q3H weights)
    "q3h_matmul": ("inferflow_tpu_torch/kernels/csrc/dequant_matmul.cu",
                   "inferflow_tpu/kernels/dequant_matmul.py:244"),
    # B1 for the Q8 block formats (Q8_B32T2, Q8_B32T1)
    "q8_matmul": ("inferflow_tpu_torch/kernels/csrc/dequant_matmul.cu",
                  "inferflow_tpu/kernels/dequant_matmul.py:146"),
    # B4 in its byte mode (c) (the TPU kernel's single-plane tile, pk = 1,
    # stream_mm :583-606)
    "fused_decode_step_byte": (
        "inferflow_tpu_torch/kernels/csrc/decode_step.cu",
        "inferflow_tpu/kernels/decode_step.py:255"),
    # B4 in its routed-expert mode (g) (moe_slot :1124: in-kernel gate,
    # softmax, top-k and per-expert weight streaming)
    "fused_decode_step_moe": (
        "inferflow_tpu_torch/kernels/csrc/decode_step.cu",
        "inferflow_tpu/kernels/decode_step.py:1124"),
    # B1 for the sub-byte wire formats (Q6 to Q2, one or two planes)
    "subbyte_matmul": ("inferflow_tpu_torch/kernels/csrc/subbyte_matmul.cu",
                       "inferflow_tpu/kernels/dequant_matmul.py:146"),
    # B5 and B4 (b) on the other 4-bit formats: Q4_B32T1A/B (32-row
    # blocks, f16 metadata), Q4_B32T2 (32, f32) and Q4_B16 (16, f32), each
    # its own instantiation, the GEMV alone beside the fused step
    **{name: ("inferflow_tpu_torch/kernels/csrc/dequant_matmul.cu",
              "inferflow_tpu/kernels/dequant_matmul.py:313")
       for name in ("i4_matmul_b32", "i4_matmul_b32f", "i4_matmul_b16f")},
    **{name: ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
              "inferflow_tpu/kernels/decode_step.py:255")
       for name in ("fused_decode_step_i4_b32", "fused_decode_step_i4_b32f",
                    "fused_decode_step_i4_b16f")},
    **{name: ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
              "inferflow_tpu/kernels/decode_step.py:537")
       for name in ("i4x8_gemv_b32", "i4x8_gemv_b32f", "i4x8_gemv_b16f")},
    # B4 in its mode (b') (the TPU kernel's bf16-unpack i4 tile,
    # stream_mm :573-583), one instantiation per geometry, and its GEMV
    # alone
    **{step: ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
              "inferflow_tpu/kernels/decode_step.py:255")
       for _, _, step in I4BF16_FORMATS.values()},
    **{gemv: ("inferflow_tpu_torch/kernels/csrc/decode_step.cu",
              "inferflow_tpu/kernels/decode_step.py:573")
       for gemv, _, _ in I4BF16_FORMATS.values()},
}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps(dict(obj, elapsed_s=time.perf_counter() - T0)),
          flush=True)


class Timer:
    """Median device time of a callable over TIMED_ITERS calls, each after
    an L2 flush, measured with CUDA events.

    The flush READS 128 MiB (a write would leave 50 MB of dirty lines whose
    write-back the timed call would pay for).  Each call is queued behind a
    device sleep, so the host enqueues all of the call's launches before
    the device reaches them: the events then time the device work, not the
    host's Python between launches.  An event behind the sleep proves it:
    if the device has passed it by the time the call is queued, the host
    fell behind and the call is timed again behind a four times longer
    sleep.  One call per sleep keeps the queued launches (the fused step
    issues about 115) far below the launch queue's depth, past which the
    host would block.  A callable that waits on the device itself (a
    device-to-host read) can never be queued ahead: it is timed alone, and
    its events then include its host gaps (a "timer" line names it)."""

    SLEEP_CYCLES = 10_000_000  # ~5 ms at the H100's ~2 GHz clock

    def __init__(self, device):
        self.flush_buf = torch.ones(32 * 1024 * 1024, dtype=torch.int32,
                                    device=device)

    def _once(self, fn, sleep_cycles: int):
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        gate = torch.cuda.Event()
        gate.record()
        self.flush_buf.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        host_ahead = not gate.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end), host_ahead

    def __call__(self, fn, label: str = "", iters: int = TIMED_ITERS) -> float:
        fn()  # warm up
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            for attempt in range(3):
                ms, ahead = self._once(fn, self.SLEEP_CYCLES * 4 ** attempt)
                if ahead:
                    times.append(ms)
                    break
            else:
                break
        if len(times) == iters:
            return float(np.median(times))
        emit({"phase": "timer", "ungated": label})
        return float(np.median([self._once(fn, 0)[0]
                                for _ in range(iters)]))


def bound(bytes_moved: float, flops: float,
          peak: float = H100_BF16_FLOPS) -> tuple:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, ref: torch.Tensor,
            rel_tol: float = KERNEL_REL_TOL) -> dict:
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = bool(np.isfinite(err) and err <= rel_tol * scale + 1e-6)
    return {"max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "tolerance": f"max_abs_err <= {rel_tol} * max|plain|",
            "ok": ok}


def phase_b1(timer, dev, spec) -> list:
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul, quantized_matmul_plain)
    from inferflow_tpu_torch.quant.codec_torch import dequantize, quantize
    hp = spec.hyper_params
    e, inter = hp.embd_dims, hp.decoder_intermediate_size
    q_dim = hp.decoder_heads * hp.head_dim
    kv_dim = hp.kv_heads * hp.head_dim
    shapes = {"qkv": (e, q_dim + 2 * kv_dim), "wo": (q_dim, e),
              "w1n3": (e, 2 * inter), "w2": (inter, e),
              "lm_head": (e, hp.vocab_size)}
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, (k, n) in shapes.items():
        w = torch.randn((k, n), generator=gen, device=dev) * (0.5 / k ** 0.5)
        qt = quantize(w, "Q4_B64T1")
        w_bf16 = dequantize(qt, torch.bfloat16)
        for m in (1, 4, 256):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = quantized_matmul(x, qt)
            ref = quantized_matmul_plain(x, qt)
            torch.cuda.synchronize()
            res = compare(got, ref)
            bytes_moved = 2 * m * k + k * n // 2 + 4 * (k // 64) * n \
                + 2 * m * n
            b_ms, b_by = bound(bytes_moved, 2 * m * k * n)
            row = {"phase": "kernel", "kernel": "dequant_matmul",
                   "shape": f"{name} M={m} K={k} N={n}", **res,
                   "ms": timer(lambda: quantized_matmul(x, qt)),
                   "plain_ms": timer(lambda: quantized_matmul_plain(x, qt)),
                   "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def _filled_cache(dev, spec, batch, rows, seed, context=CONTEXT):
    from inferflow_tpu_torch.runtime.kv_cache import KVCache
    hp = spec.hyper_params
    cache = KVCache.create(hp.decoder_layers, batch, context, hp.kv_heads,
                           hp.head_dim, quantized=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for layer in range(hp.decoder_layers):
        k = torch.randn((batch, rows, hp.kv_heads, hp.head_dim),
                        generator=gen, device=dev)
        v = torch.randn((batch, rows, hp.kv_heads, hp.head_dim),
                        generator=gen, device=dev)
        cache.update_layer(layer, k, v, torch.zeros(batch, dtype=torch.int32,
                                                    device=dev))
    return cache, gen


def _twin(cache):
    """A copy of a dense cache: its codes, scales and lengths."""
    import dataclasses
    return dataclasses.replace(
        cache, k=cache.k.clone(), v=cache.v.clone(),
        k_scale=cache.k_scale.clone(), v_scale=cache.v_scale.clone(),
        length=cache.length.clone())


def _kv_bytes(rows: int, spec) -> int:
    """Q8 K and V rows with their f16 scales (one per 32 elements)."""
    hp = spec.hyper_params
    per_row = hp.kv_heads * (hp.head_dim + 2 * (hp.head_dim // 32))
    return 2 * rows * per_row


def _expand_heads(t, g):
    return t.repeat_interleave(g, dim=1)


def phase_b2(timer, dev, spec, lengths=(CONTEXT, 700, 301, 17),
             context=CONTEXT) -> list:
    """B2 on one slot per length, over a `context`-row Q8 cache whose rows
    are filled up to the longest length (the spec's last layer)."""
    import torch.nn.functional as F
    from inferflow_tpu_torch.kernels.attention import (
        decode_attention, decode_attention_plain)
    hp = spec.hyper_params
    b, layer, d = len(lengths), hp.decoder_layers - 1, hp.head_dim
    g = hp.decoder_heads // hp.kv_heads
    cache, gen = _filled_cache(dev, spec, b, max(lengths), seed=2,
                               context=context)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = (torch.randn((b, 1, hp.decoder_heads, d), generator=gen, device=dev)
         * 0.3).to(torch.bfloat16)
    got, _ = decode_attention(q, cache, layer, lengths)
    ref = decode_attention_plain(q[:, 0], cache, layer, lengths)
    torch.cuda.synchronize()
    res = compare(got[:, 0], ref)
    k, v = cache.read_layer(layer, torch.bfloat16)  # (B, S, H, D)
    k = _expand_heads(k.transpose(1, 2), g)
    v = _expand_heads(v.transpose(1, 2), g)
    mask = (torch.arange(context, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)  # (B, Hq, 1, D)
    live = int(lengths.sum().item())
    bytes_moved = _kv_bytes(live, spec) + 2 * 2 * q.numel() + 4 * b
    flops = 4 * live * hp.decoder_heads * d
    b_ms, b_by = bound(bytes_moved, flops)
    row = {"phase": "kernel", "kernel": "decode_attention",
           "shape": f"B={b} Hq={hp.decoder_heads} H={hp.kv_heads} D={d} "
                    f"S={context} lengths={lengths.tolist()} layer={layer}",
           **res,
           "ms": timer(lambda: decode_attention(q, cache, layer, lengths)),
           "plain_ms": timer(lambda: decode_attention_plain(
               q[:, 0], cache, layer, lengths)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qs, k, v, attn_mask=mask)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    return [row]


def phase_b3(timer, dev, spec, start=256) -> list:
    """B3: a 256-row chunk of slot 1 at row `start` (the spec's last
    layer)."""
    import torch.nn.functional as F
    from inferflow_tpu_torch.kernels.attention import (
        chunk_attention, chunk_attention_plain)
    hp = spec.hyper_params
    c, slot, layer, d = 256, 1, hp.decoder_layers - 1, hp.head_dim
    g = hp.decoder_heads // hp.kv_heads
    cache, gen = _filled_cache(dev, spec, 2, start + c, seed=3,
                               context=max(CONTEXT, start + c))
    q = (torch.randn((1, c, hp.decoder_heads, d), generator=gen, device=dev)
         * 0.3).to(torch.bfloat16)
    got, _ = chunk_attention(q, cache, layer, slot, start)
    ref = chunk_attention_plain(q[0], cache, layer, slot, start)
    torch.cuda.synchronize()
    res = compare(got[0], ref)
    n_keys = start + c
    k, v = cache.read_layer(layer, torch.bfloat16)
    k = _expand_heads(k[slot:slot + 1, :n_keys].transpose(1, 2), g)
    v = _expand_heads(v[slot:slot + 1, :n_keys].transpose(1, 2), g)
    mask = (torch.arange(n_keys, device=dev)[None, :]
            <= start + torch.arange(c, device=dev)[:, None])
    qs = q.transpose(1, 2)  # (1, Hq, C, D)
    visible = sum(start + i + 1 for i in range(c))
    bytes_moved = _kv_bytes(n_keys, spec) + 2 * 2 * q.numel()
    flops = 4 * visible * hp.decoder_heads * d
    b_ms, b_by = bound(bytes_moved, flops)
    row = {"phase": "kernel", "kernel": "chunk_attention",
           "shape": f"C={c} start={start} Hq={hp.decoder_heads} "
                    f"H={hp.kv_heads} D={d} layer={layer}",
           **res,
           "ms": timer(lambda: chunk_attention(q, cache, layer, slot,
                                               start)),
           "plain_ms": timer(lambda: chunk_attention_plain(
               q[0], cache, layer, slot, start)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qs, k, v, attn_mask=mask)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    return [row]


def phase_i8mm_gemv(timer, dev, params) -> list:
    """B4's int8 GEMV alone at the four layer shapes and the lm_head."""
    import torch.nn.functional as F
    from inferflow_tpu_torch.kernels.decode_step import (i8mm_gemv_cuda,
                                                         i8mm_matmul_plain)
    from inferflow_tpu_torch.quant.codec_torch import int8_rowwise_activations
    lp = params["layers"][0]
    weights = {"qkv": lp["attn"]["qkv"], "wo": lp["attn"]["wo"],
               "w1n3": lp["ffn"]["w1n3"], "w2": lp["ffn"]["w2"],
               "lm_head": params["lm_head"]}
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for name, w in weights.items():
        k, n = w.shape
        for m in (1, 4):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            got = i8mm_gemv_cuda(x, w)
            ref = i8mm_matmul_plain(x, w).float()
            xq, _ = int8_rowwise_activations(x)
            xq = F.pad(xq, (0, 0, 0, 24 - m))  # _int_mm takes > 16 rows
            torch.cuda.synchronize()
            res = compare(got.to(torch.bfloat16), ref)
            bytes_moved = k * n + 4 * n + 2 * m * k + 4 * m * n
            b_ms, b_by = bound(bytes_moved, 2 * m * k * n, H100_INT8_OPS)
            row = {"phase": "kernel", "kernel": "i8mm_gemv",
                   "shape": f"{name} M={m} K={k} N={n}", **res,
                   "ms": timer(lambda: i8mm_gemv_cuda(x, w)),
                   "plain_ms": timer(lambda: i8mm_matmul_plain(x, w),
                                     f"i8mm_matmul_plain {name} M={m}"),
                   "library_ms": timer(lambda: torch._int_mm(xq, w.data)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def _weight_bytes(params) -> int:
    """The bytes of every layer's weights and norms (tensors and both
    quantized containers report nbytes), a MoE layer's gate and expert
    stacks included."""
    def groups(lp):
        if "moe" not in lp:
            return (lp["attn"], lp["ffn"])
        moe = dict(lp["moe"])
        return (lp["attn"], moe.pop("experts_stacked"), moe)
    return sum(t.nbytes for lp in params["layers"] for grp in groups(lp)
               for t in grp.values())


def phase_b4(timer, dev, spec, params) -> list:
    """The whole-model fused decode step against its plain version, both on
    the card, on twin caches; the hidden state and every layer's appended
    K/V row (in Q8 steps of the plain row's scale)."""
    import dataclasses
    from inferflow_tpu_torch.kernels import decode_step
    hp = spec.hyper_params
    n_layers = hp.decoder_layers
    rows = []
    for lengths in (FUSED_LENGTHS, (700,)):
        b = len(lengths)
        cache, gen = _filled_cache(dev, spec, b, CONTEXT, seed=5)
        cache.with_length(torch.tensor(lengths, device=dev))
        twin = _twin(cache)
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = params["dec_embeddings"][tokens]
        pos = cache.length[:, None].clone()
        # one layer, the same inputs on both sides
        one = [dataclasses.replace(c, k=c.k[:1], v=c.v[:1],
                                   k_scale=c.k_scale[:1],
                                   v_scale=c.v_scale[:1])
               for c in (cache, twin)]
        got1, _ = decode_step.fused_decode_step(spec, params["layers"][:1],
                                                x, pos, one[0])
        ref1, _ = decode_step.fused_decode_step_plain(
            spec, params["layers"][:1], x, pos, one[1])
        one_layer = compare(got1, ref1, ONE_LAYER_TOL)
        got, _ = decode_step.fused_decode_step(spec, params["layers"], x,
                                               pos, cache)
        ref, _ = decode_step.fused_decode_step_plain(spec, params["layers"],
                                                     x, pos, twin)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        steps = []
        for layer in range(n_layers):
            worst = 0.0
            for a, r in zip(cache.read_layer(layer, torch.float32),
                            twin.read_layer(layer, torch.float32)):
                for slot, n in enumerate(lengths):
                    row = min(n, CONTEXT - 1)
                    q8 = r[slot, row].abs().amax(dim=-1) / 127.0
                    diff = (a[slot, row] - r[slot, row]).abs().amax(dim=-1)
                    worst = max(worst, (diff / q8.clamp(min=1e-12)).max()
                                .item())
            steps.append(worst)
        live = sum(min(n, CONTEXT) for n in lengths)
        nblk = hp.head_dim // 32
        kv_bytes = 2 * n_layers * live * hp.kv_heads * (hp.head_dim
                                                        + 2 * nblk)
        new_rows = 2 * n_layers * b * hp.kv_heads * (hp.head_dim + 2 * nblk)
        w_bytes = _weight_bytes(params)
        bytes_moved = w_bytes + kv_bytes + new_rows + 2 * 2 * b * hp.embd_dims
        ops = 2 * b * sum(lp[g][w].data.numel() for lp in params["layers"]
                          for g, w in (("attn", "qkv"), ("attn", "wo"),
                                       ("ffn", "w1n3"), ("ffn", "w2")))
        b_ms, b_by = bound(bytes_moved, ops, H100_INT8_OPS)
        ok = bool(np.isfinite(err) and err <= FUSED_TOL * scale
                  and steps[0] <= 1.0 + 1e-3 and one_layer["ok"])
        row = {"phase": "kernel", "kernel": "fused_decode_step",
               "shape": f"{MODEL} L={n_layers} B={b} lengths={list(lengths)} "
                        f"S={CONTEXT}",
               "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
               "tolerance": f"max_abs_err <= {FUSED_TOL} * max|plain|; "
                            f"layer-0 rows within one Q8 step; one layer "
                            f"alone: {one_layer['tolerance']}",
               "one_layer": one_layer,
               "appended_row_q8_steps_by_layer": steps, "ok": ok,
               "ms": timer(lambda: decode_step.fused_decode_step(
                   spec, params["layers"], x, pos, cache),
                   f"fused_decode_step B={b}"),
               "plain_ms": timer(lambda: decode_step.fused_decode_step_plain(
                   spec, params["layers"], x, pos, twin),
                   f"fused_decode_step_plain B={b}"),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes_bound": bytes_moved}
        emit(row)
        rows.append(row)
    return rows


def _shuffled_tables(lengths, pt, maxp, pages, seed) -> list:
    """Page-table rows for slots of `lengths` over pool pages 1..pages-1 in
    a seeded random order (page 0 stays the sentinel)."""
    order = [int(p) + 1 for p in np.random.default_rng(seed).permutation(
        pages - 1)]
    rows = []
    for n in lengths:
        need = -(-n // pt)
        rows.append(order[:need] + [0] * (maxp - need))
        order = order[need:]
    return rows


def phase_b7(timer, dev) -> list:
    """Kernel B7 against its plain version at B = 16 on a one-layer pool,
    at llama2-7b and tinyllama-1.1b widths, Q8 and bf16.  The plain
    version runs slot by slot (all 16 slots at once would gather 32k rows
    of every slot in float32, about 35 GB at llama2-7b width)."""
    import dataclasses
    import torch.nn.functional as F
    from inferflow_tpu_torch.kernels.attention import (
        decode_attention, paged_decode_attention_plain)
    from inferflow_tpu_torch.models.zoo import make_spec
    from inferflow_tpu_torch.runtime.paged_kv import (PagedKVCache,
                                                      page_tokens_for)
    b = len(B7_LENGTHS)
    lengths = torch.tensor(B7_LENGTHS, dtype=torch.int32, device=dev)
    live = sum(B7_LENGTHS)
    rows = []
    for model in (PAGED_MODEL, MODEL):
        hp = make_spec(model).hyper_params
        h, d, hq = hp.kv_heads, hp.head_dim, hp.decoder_heads
        pt = page_tokens_for(d)
        for quantized in (True, False):
            cache = PagedKVCache.create(1, b, 32768, h, d,
                                        pool_tokens=B7_POOL_PAGES * pt,
                                        quantized=quantized, device=dev)
            gen = torch.Generator(device=dev).manual_seed(7)
            if quantized:
                for t in (cache.k, cache.v):
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                          device=dev, dtype=torch.int8))
                for t in (cache.k_scale, cache.v_scale):
                    t.copy_(torch.rand(t.shape, generator=gen, device=dev)
                            * 0.05 + 1e-3)
            else:
                for t in (cache.k, cache.v):
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev))
            tables = _shuffled_tables(B7_LENGTHS, pt,
                                      cache.max_pages_per_slot,
                                      cache.num_pages, seed=8)
            for slot, row in enumerate(tables):
                cache.with_page_row(slot, row)
            q = (torch.randn((b, 1, hq, d), generator=gen, device=dev)
                 * 0.3).to(torch.bfloat16)
            one = [dataclasses.replace(cache,
                                       page_table=cache.page_table[i:i + 1])
                   for i in range(b)]

            def plain():
                return torch.cat([paged_decode_attention_plain(
                    q[i:i + 1, 0], one[i], 0, lengths[i:i + 1])
                    for i in range(b)])

            got, _ = decode_attention(q, cache, 0, lengths)
            ref = plain()
            torch.cuda.synchronize()
            res = compare(got[:, 0], ref)
            res["empty_slot_zero"] = not got[B7_LENGTHS.index(0)].any().item()
            res["ok"] = res["ok"] and res["empty_slot_zero"]
            # the yardstick: the same rows, gathered once into a dense bf16
            # (B, Hq, S, D) tensor (not timed), under a length mask
            s_max = max(B7_LENGTHS)
            kd = torch.zeros((b, hq, s_max, d), dtype=torch.bfloat16,
                             device=dev)
            vd = torch.zeros_like(kd)
            for i, n in enumerate(B7_LENGTHS):
                if n:
                    k1, v1 = one[i].read_layer(0, torch.bfloat16,
                                               -(-n // pt))
                    kd[i, :, :n] = _expand_heads(k1[:, :n].transpose(1, 2),
                                                 hq // h)[0]
                    vd[i, :, :n] = _expand_heads(v1[:, :n].transpose(1, 2),
                                                 hq // h)[0]
            mask = (torch.arange(s_max, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            qs = q.transpose(1, 2)  # (B, Hq, 1, D)
            row_bytes = d + 2 * (d // 32) if quantized else 2 * d
            bytes_moved = 2 * live * h * row_bytes + 2 * 2 * q.numel() \
                + 4 * b + 4 * cache.page_table.numel()
            b_ms, b_by = bound(bytes_moved, 4 * live * hq * d)
            row = {"phase": "kernel", "kernel": "paged_decode_attention",
                   "shape": f"{model} B={b} Hq={hq} H={h} D={d} PT={pt} "
                            f"pages={cache.num_pages} "
                            f"{'Q8' if quantized else 'bf16'} "
                            f"lengths={list(B7_LENGTHS)}",
                   **res,
                   "ms": timer(lambda: decode_attention(q, cache, 0,
                                                        lengths)),
                   "plain_ms": timer(plain, "paged_decode_attention_plain "
                                     "(slot by slot)"),
                   "library_ms": timer(lambda: F.scaled_dot_product_attention(
                       qs, kd, vd, attn_mask=mask)),
                   "library": "scaled_dot_product_attention on the rows "
                              "pre-gathered into dense bf16 (gather not "
                              "timed)",
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bytes_bound": bytes_moved}
            emit(row)
            rows.append(row)
            del cache, one, kd, vd
            torch.cuda.empty_cache()
    return rows


def _paged_twin(dense, pool_tokens, seed):
    """A page pool holding the rows of a dense cache, slot by slot on
    shuffled pages, with the same lengths."""
    from inferflow_tpu_torch.runtime.paged_kv import PagedKVCache
    num_layers, b, h, s, d = dense.k.shape
    pc = PagedKVCache.create(num_layers, b, s, h, d,
                             pool_tokens=pool_tokens, quantized=True,
                             device=dense.k.device)
    pt, maxp = pc.page_tokens, pc.max_pages_per_slot
    tables = _shuffled_tables([s] * b, pt, maxp, pc.num_pages, seed)
    for slot, row in enumerate(tables):
        pc.with_page_row(slot, row)
        for j, pid in enumerate(row):
            for src, dst in ((dense.k, pc.k), (dense.v, pc.v),
                             (dense.k_scale, pc.k_scale),
                             (dense.v_scale, pc.v_scale)):
                dst[:, pid] = src[:, slot, :, j * pt:(j + 1) * pt]
    pc.with_length(dense.length.clone())
    return pc


def phase_b4_paged(timer, dev, spec, params) -> list:
    """B4's paged mode (f) against its plain version (both on the card, on
    twin pools) and against dense B4 on the same cache rows: the hidden
    state and every layer's appended row."""
    import dataclasses
    from inferflow_tpu_torch.kernels import decode_step
    hp = spec.hyper_params
    n_layers = hp.decoder_layers
    rows = []
    for lengths in (FUSED_LENGTHS, (700,)):
        b = len(lengths)
        dense, gen = _filled_cache(dev, spec, b, CONTEXT, seed=5)
        dense.with_length(torch.tensor(lengths, device=dev))
        paged = _paged_twin(dense, (4 * b + 3) * 256, seed=9)
        pt = paged.page_tokens
        twin = dataclasses.replace(
            paged, k=paged.k.clone(), v=paged.v.clone(),
            k_scale=paged.k_scale.clone(), v_scale=paged.v_scale.clone(),
            length=paged.length.clone())
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = params["dec_embeddings"][tokens]
        pos = dense.length[:, None].clone()
        layers = params["layers"]
        got, _ = decode_step.fused_decode_step(spec, layers, x, pos, paged)
        got_d, _ = decode_step.fused_decode_step(spec, layers, x, pos, dense)
        ref, _ = decode_step.fused_decode_step_plain(spec, layers, x, pos,
                                                     twin)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        vs_dense = (got.float() - got_d.float()).abs().max().item()
        rows_vs_dense = 0.0
        for layer in range(n_layers):
            for a, r in zip(paged.read_layer(layer, torch.float32),
                            dense.read_layer(layer, torch.float32)):
                for slot, n in enumerate(lengths):
                    rows_vs_dense = max(rows_vs_dense, (
                        a[slot, n] - r[slot, n]).abs().max().item())
        ok = bool(np.isfinite(err) and err <= FUSED_TOL * scale)
        timed = {"ms": timer(lambda: decode_step.fused_decode_step(
                     spec, layers, x, pos, paged), f"fused_decode_step paged "
                     f"B={b}"),
                 "dense_ms": timer(lambda: decode_step.fused_decode_step(
                     spec, layers, x, pos, dense), f"fused_decode_step B={b}"),
                 "plain_ms": timer(lambda: decode_step.fused_decode_step_plain(
                     spec, layers, x, pos, twin),
                     f"fused_decode_step_plain paged B={b}")}
        live = sum(min(n, CONTEXT) for n in lengths)
        nblk = hp.head_dim // 32
        kv_bytes = 2 * n_layers * live * hp.kv_heads * (hp.head_dim
                                                        + 2 * nblk)
        new_rows = 2 * n_layers * b * hp.kv_heads * (hp.head_dim + 2 * nblk)
        bytes_moved = _weight_bytes(params) + kv_bytes + new_rows \
            + 2 * 2 * b * hp.embd_dims + 4 * paged.page_table.numel()
        ops = 2 * b * sum(lp[g][w].data.numel() for lp in layers
                          for g, w in (("attn", "qkv"), ("attn", "wo"),
                                       ("ffn", "w1n3"), ("ffn", "w2")))
        b_ms, b_by = bound(bytes_moved, ops, H100_INT8_OPS)
        row = {"phase": "kernel", "kernel": "fused_decode_step_paged",
               "shape": f"{MODEL} L={n_layers} B={b} lengths={list(lengths)} "
                        f"PT={pt} MAXP={paged.max_pages_per_slot} "
                        f"pages={paged.num_pages} (shuffled)",
               "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
               "tolerance": f"max_abs_err <= {FUSED_TOL} * max|plain|",
               "max_abs_diff_vs_dense_b4": vs_dense,
               "appended_rows_max_abs_diff_vs_dense_b4": rows_vs_dense,
               "ok": ok, **timed, "library_ms": None, "bound_ms": b_ms,
               "bound_by": b_by, "bytes_bound": bytes_moved}
        emit(row)
        rows.append(row)
    return rows


def _record_rows(eng, forced=None) -> dict:
    """Keep every logits row the engine samples from, per query id.  With
    `forced` ({query id: tokens}) the i-th sample of a query returns
    forced[qid][i] in place of the sampler's choice: a reference engine fed
    the tokens another engine served (queries not in `forced` sample)."""
    rows = {}
    choose = eng.strategies.choose_token

    def recording(qid, logits, prev=()):
        seen = rows.setdefault(qid, [])
        seen.append(np.asarray(logits, np.float32).copy())
        tok = choose(qid, logits, prev)
        if forced is None or qid not in forced:
            return tok
        return forced[qid][len(seen) - 1]

    eng.strategies.choose_token = recording
    return rows


def _serve(eng, prompts, max_new) -> tuple:
    """Serve `prompts` in order, each admitted as soon as a slot is free
    (more queries than slots: later ones reuse finished slots)."""
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    queue, qids = list(prompts), []
    prefill_ms, decode_ms, steps = [], [], 0
    while queue or eng.has_work():
        while queue:
            qid = eng.add_query(queue[0], SamplingOptions(strategy="greedy"),
                                max_new)
            if qid == -1:
                break
            assert qid > 0, qid
            qids.append(qid)
            queue.pop(0)
        eng.perf_stat.clear()
        eng.commit_inference_result(eng.infer())
        steps += 1
        if "prefill_ms" in eng.perf_stat:
            prefill_ms.append(eng.perf_stat["prefill_ms"])
        if "decode_ms" in eng.perf_stat:
            decode_ms.append(eng.perf_stat["decode_ms"])
        assert steps < 400, "engine did not finish"
    return qids, prefill_ms, decode_ms, steps


def _device_us(event) -> float:
    return float(event.self_device_time_total)


def profile_decode(eng, prompt, label: str, steps: int = 3) -> None:
    """Where a decode step's time goes: torch.profiler over `steps` decode
    steps of one query (after its prefill and one warm step); the device's
    busy time is the sum of its kernels' times (one stream: they do not
    overlap), the rest of the wall time it idles.  Only device events
    count: a host op's "self device time" is its kernels' time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    eng.add_query(prompt, SamplingOptions(strategy="greedy"), steps + 2)
    for _ in range(2):
        eng.commit_inference_result(eng.infer())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.commit_inference_result(eng.infer())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert not eng.has_work()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:12]
    emit({"phase": f"decode_profile_{label}", "decode_steps": steps,
          "device_launches_per_step": sum(e.count for e in events) / steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_busy_ms_per_step": (busy_ms / steps) if busy_ms
          else "not measured",
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
          else "not measured",
          "device_kernels": [{"name": e.key[:80], "count": e.count // steps,
                              "ms_per_step": _device_us(e) / 1e3 / steps}
                             for e in top]})


def build_params(dev, spec, weight_format="Q4_B64T1") -> tuple:
    """Seed-0 synthetic params on the card in the spec's layout ('' resolves
    on the card), with the device memory they take: resident weights and
    the peak while building them (float32 draws, quantizer temporaries),
    above what was allocated before."""
    from inferflow_tpu_torch.models.zoo import make_synthetic_params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = make_synthetic_params(spec, weight_format, seed=0, device=dev)
    torch.cuda.synchronize()
    memory = {"before": mem_before,
              "weights": torch.cuda.memory_allocated(dev) - mem_before,
              "build_peak": torch.cuda.max_memory_allocated(dev) - mem_before,
              "build_s": time.perf_counter() - t0}
    return params, memory


def phase_engine(dev, spec, params, memory, label, must_launch,
                 must_not_launch, tol, engine_kw=None,
                 max_new=MAX_NEW) -> dict:
    """Serve the four queries, `max_new` new tokens each; the kernels'
    launches counted from 0 for this run only.  engine_kw: extra
    InferenceEngine arguments (paging), for the card's engine and the
    CPU's alike."""
    engine_kw = engine_kw or {}
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.runtime.engine import InferenceEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, spec.hyper_params.vocab_size,
                                             n)] for n in PROMPT_LENS]
    eng = InferenceEngine(spec, params, max_concurrent_queries=SLOTS,
                          max_context_len=CONTEXT, kv_cache_quantized=True,
                          device=dev, **engine_kw)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    memory = dict(memory, serving_peak=torch.cuda.max_memory_allocated(dev)
                  - memory["before"])
    outputs = [eng.query_tokens(q) for q in qids]
    served = sum(len(o) for o in outputs)
    vocab = spec.hyper_params.vocab_size
    for o in outputs:
        assert len(o) == max_new and all(0 <= t < vocab for t in o), o
    for q in qids:
        assert all(np.isfinite(r).all() and r.shape == (vocab,)
                   for r in rows[q])
    emit({"phase": f"engine_{label}", "model": MODEL,
          "layers": spec.hyper_params.decoder_layers,
          "device_layout": spec.device_layout or "auto",
          "layout_type": type(params["lm_head"]).__name__,
          "slots": SLOTS, "context": CONTEXT, **engine_kw,
          "prompt_lens": list(PROMPT_LENS),
          "tokens_served": served, "engine_steps": steps,
          "decode_steps": len(decode_ms), "wall_s": wall_s,
          "device_bytes": memory,
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "first_tokens": [o[:4] for o in outputs],
          "kernel_launches": {k: launches.get(k, 0) for k in KERNEL_SOURCES}})
    for k in must_launch:
        assert launches.get(k, 0) > 0, f"{k} never launched in run {label}"
    for k in must_not_launch:
        assert launches.get(k, 0) == 0, f"{k} launched in run {label}"
    for k in must_launch:
        if k.startswith("fused_decode_step"):
            assert launches[k] == len(decode_ms), \
                f"a decode step did not take the fused step {k}"
    profile_decode(eng, prompts[1], label)

    check_against_cpu(spec, params, prompts, qids, rows, outputs, label, tol,
                      dict(max_concurrent_queries=SLOTS,
                           max_context_len=CONTEXT, kv_cache_quantized=True,
                           **engine_kw), max_new)
    return launches


def check_against_cpu(spec, params, prompts, qids, rows, outputs, label,
                      tol, engine_kw, max_new=MAX_NEW) -> None:
    """The same model and queries served on the CPU (the plain versions),
    in the same interleaving and fed the tokens the card served: every
    sampled row (each prefill and each decode step of every query) is held
    against the card's within `tol`."""
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    t0 = time.perf_counter()
    cpu = InferenceEngine(spec, params, device="cpu", **engine_kw)
    cpu_rows = _record_rows(cpu, forced=dict(zip(qids, outputs)))
    ref_qids, _, _, _ = _serve(cpu, prompts, max_new)
    assert ref_qids == qids, (ref_qids, qids)
    report = {"phase": f"engine_{label}_vs_cpu",
              "cpu_reference_s": time.perf_counter() - t0,
              "tolerance": f"every sampled row: max_abs_err <= {tol}"}
    report.update(_row_errors(qids, prompts, outputs, rows, cpu_rows, tol,
                              max_new))
    emit(report)
    assert report["ok"], \
        f"run {label}: served logits disagree with the CPU reference"


def _row_errors(qids, prompts, outputs, rows, ref_rows, tol,
                max_new=MAX_NEW) -> dict:
    """Per query: the worst |card - reference| over its sampled rows, how
    many argmaxes agree, and the scale the errors compare with: the
    largest |logit| and the gap between the two largest logits of each
    reference row (median and least); ok when every row is within `tol`."""
    report, ok, gaps = {}, True, []
    for q, prompt, served in zip(qids, prompts, outputs):
        n = len(prompt)
        card, ref = rows[q], ref_rows[q]
        assert len(card) == len(ref) == len(served) == max_new, q
        assert [int(r.argmax()) for r in card] == served, "not greedy"
        errs = [float(np.abs(a - b).max()) for a, b in zip(card, ref)]
        top2 = [np.partition(b, -2)[-2:] for b in ref]
        q_gaps = [float(t[1] - t[0]) for t in top2]
        gaps += q_gaps
        report[f"q{q}_prompt_{n}"] = {
            "rows": len(errs), "max_abs_err": max(errs),
            "worst_row": int(np.argmax(errs)), "first_row_err": errs[0],
            "row_errs": errs,
            "max_abs_logit": float(max(np.abs(b).max() for b in ref)),
            "top2_gap_median": float(np.median(q_gaps)),
            "argmax_equal": sum(int(a.argmax()) == int(b.argmax())
                                for a, b in zip(card, ref))}
        ok &= max(errs) <= tol
    per_q = list(report.values())
    report["max_abs_err"] = max(v["max_abs_err"] for v in per_q)
    report["max_abs_logit"] = max(v["max_abs_logit"] for v in per_q)
    report["top2_gap_median"] = float(np.median(gaps))
    report["top2_gap_min"] = float(min(gaps))
    report["ok"] = bool(ok)
    return report


def ini_config(ini: str, model_name: str, **overrides) -> tuple:
    """One of the repo's inis through the package's own loader: (engine
    config, spec with the ini's context, KV type, weight type and device
    layout, weight format name).  The model dirs hold no config.json, so
    the hyper-parameters come from make_spec (`overrides`: a cut depth)."""
    from inferflow_tpu_torch.config import load_engine_config
    from inferflow_tpu_torch.models.zoo import make_spec
    from inferflow_tpu_torch.quant.formats import get_format
    cfg = load_engine_config(str(Path(__file__).resolve().parent / ini))
    model = cfg.model
    spec = make_spec(model_name, **overrides)
    spec.max_context_len = model.max_context_len
    spec.device_kv_cache_data_type = model.device_kv_cache_data_type
    spec.device_weight_data_type = model.device_weight_data_type
    spec.device_layout = model.device_layout
    return cfg, spec, get_format(model.device_weight_data_type).name


def _paged_engine(spec, params, cfg, device):
    """InferenceEngine built from the ini as the JAX package's from_config
    builds it."""
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    return InferenceEngine(spec, params,
                           max_concurrent_queries=cfg.max_concurrent_queries,
                           max_context_len=spec.max_context_len,
                           device=device,
                           kv_cache_paging=cfg.kv_cache_paging,
                           kv_pool_tokens=cfg.kv_pool_tokens)


def _pool_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in
               (cache.k, cache.v, cache.k_scale, cache.v_scale)
               if t is not None)


def phase_engine_c(dev, cfg, spec, params, memory) -> dict:
    """Run (c): the dense reference engine on the card first (freed after),
    then the paged engine of the ini, fed the reference's tokens; every
    sampled row held against the reference's."""
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    vocab = spec.hyper_params.vocab_size
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)]
               for n in ENGINE_C_PROMPTS]
    t0 = time.perf_counter()
    ref = InferenceEngine(spec, params,
                          max_concurrent_queries=cfg.max_concurrent_queries,
                          max_context_len=ENGINE_C_DENSE_CONTEXT, device=dev)
    ref.prefill_chunk = ENGINE_C_DENSE_CONTEXT  # whole prompts, as paged
    dense_cache_bytes = _pool_bytes(ref.cache)
    ref_rows = _record_rows(ref)
    ref_qids, _, ref_decode_ms, _ = _serve(ref, prompts, MAX_NEW)
    ref_out = [ref.query_tokens(q) for q in ref_qids]
    dense_s = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = _paged_engine(spec, params, cfg, dev)
    assert eng.cache.num_pages * eng.cache.page_tokens == cfg.kv_pool_tokens
    rows = _record_rows(eng, forced=dict(zip(ref_qids, ref_out)))
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    assert qids == ref_qids, (qids, ref_qids)
    assert eng._slot_pages == {} and \
        len(eng._free_pages) == eng.cache.num_pages - 1
    reused = len(prompts) - cfg.max_concurrent_queries
    memory = dict(memory, pool=_pool_bytes(eng.cache),
                  dense_reference_cache=dense_cache_bytes,
                  serving_peak=torch.cuda.max_memory_allocated(dev)
                  - memory["before"])
    hp = spec.hyper_params
    emit({"phase": "engine_c", "config": PAGED_INI, "model": PAGED_MODEL,
          "layers": hp.decoder_layers, "embd": hp.embd_dims,
          "heads": hp.decoder_heads, "kv_heads": hp.kv_heads,
          "layout_type": type(params["lm_head"]).__name__,
          "slots": cfg.max_concurrent_queries,
          "context": spec.max_context_len,
          "pool_tokens": cfg.kv_pool_tokens, "pages": eng.cache.num_pages,
          "page_tokens": eng.cache.page_tokens, "queries": len(prompts),
          "queries_reusing_a_slot": reused,
          "prompt_lens": list(ENGINE_C_PROMPTS),
          "tokens_served": sum(len(eng.query_tokens(q)) for q in qids),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "wall_s": wall_s, "device_bytes": memory,
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "dense_reference_s": dense_s,
          "dense_reference_decode_ms_median": float(np.median(
              ref_decode_ms)),
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    assert launches.get("paged_decode_attention", 0) \
        == hp.decoder_layers * len(decode_ms), "a decode step missed B7"
    for k in ("fused_decode_step", "decode_attention", "chunk_attention"):
        assert launches.get(k, 0) == 0, f"{k} launched in run c"
    report = {"phase": "engine_c_vs_dense_card",
              "tolerance": f"every sampled row: max_abs_err <= "
                           f"{ENGINE_C_TOL}"}
    report.update(_row_errors(qids, prompts, ref_out, ref_rows, rows,
                              ENGINE_C_TOL))
    emit(report)
    assert report["ok"], "run c: paged rows disagree with the dense engine"
    profile_decode(eng, prompts[0], "c")
    return launches


def phase_engine_ccpu(dev, cfg, spec, params) -> dict:
    """Run (c-cpu): the ini's paged engine at ENGINE_CCPU_LAYERS layers on
    the card, held against the same engine on the CPU."""
    from inferflow_tpu_torch.kernels import _build
    vocab = spec.hyper_params.vocab_size
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)]
               for n in ENGINE_CCPU_PROMPTS]
    eng = _paged_engine(spec, params, cfg, dev)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    qids, _, decode_ms, steps = _serve(eng, prompts, ENGINE_CUT_CPU_NEW)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    emit({"phase": "engine_c_cpu", "config": PAGED_INI, "model": PAGED_MODEL,
          "layers": spec.hyper_params.decoder_layers,
          "slots": cfg.max_concurrent_queries,
          "context": spec.max_context_len, "pool_tokens": cfg.kv_pool_tokens,
          "prompt_lens": list(ENGINE_CCPU_PROMPTS), "engine_steps": steps,
          "decode_steps": len(decode_ms),
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    assert launches.get("paged_decode_attention", 0) > 0
    assert launches.get("fused_decode_step", 0) == 0
    del eng
    torch.cuda.empty_cache()
    check_against_cpu(spec, params, prompts, qids, rows, outputs, "c_cpu",
                      ENGINE_C_TOL,
                      dict(max_concurrent_queries=cfg.max_concurrent_queries,
                           max_context_len=spec.max_context_len,
                           kv_cache_paging=cfg.kv_cache_paging,
                           kv_pool_tokens=cfg.kv_pool_tokens),
                      ENGINE_CUT_CPU_NEW)
    return launches


# ------------------------------------------------------------ the i4 layout
def _pad_k(qt, k_s):
    """qt stored with K = k_s: zero-scale, zero-base blocks whose nibbles
    are -8 (the wire code 0), as the JAX zoo pads llama2-7b's w2 (K
    11008 stored as 11264) before it repacks."""
    import torch.nn.functional as F
    from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor
    pad = k_s - qt.storage_k
    plane = F.pad(qt.planes["data_i4p"], (0, 0, 0, pad // 2), value=0x88)
    meta = [F.pad(t, (0, 0, 0, pad // 64)) for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, {"data_i4p": plane}, *meta)


def _i4_weights(params) -> dict:
    """The five products of llama2-7b in the i4 layout (layer 0 and the
    lm_head) and w2 stored K-padded to 11264."""
    lp = params["layers"][0]
    w2 = lp["ffn"]["w2"]
    return {"qkv": lp["attn"]["qkv"], "wo": lp["attn"]["wo"],
            "w1n3": lp["ffn"]["w1n3"], "w2": w2,
            "w2_ks11264": _pad_k(w2, -(-w2.storage_k // 512) * 512),
            "lm_head": params["lm_head"]}


def _matmul_rows(timer, kernel, label, qt, w_bf16, gen, plain) -> list:
    """One product's kernel rows, M in {1, 8, 12, 256} (decode at B <= 8
    and B > 8, prefill chunks): quantized_matmul against `plain` on the
    same inputs, the same bits on a second launch; timed beside the plain
    version and torch.matmul on the pre-dequantized bf16 weight `w_bf16`
    (a yardstick only)."""
    from inferflow_tpu_torch.kernels.dequant_matmul import quantized_matmul
    k, n = (int(v) for v in qt.shape)
    k_s = qt.storage_k
    rows = []
    for m in (1, 8, 12, 256):
        x = torch.randn((m, k), generator=gen, device=w_bf16.device).to(
            torch.bfloat16)
        got = quantized_matmul(x, qt)
        ref = plain(x, qt)
        again = quantized_matmul(x, qt)
        torch.cuda.synchronize()
        res = compare(got, ref)
        res["same_bits_twice"] = bool(torch.equal(got, again))
        res["ok"] = res["ok"] and res["same_bits_twice"]
        bytes_moved = 2 * m * k_s + qt.nbytes + 2 * m * n
        b_ms, b_by = bound(bytes_moved, 2 * m * k_s * n)
        row = {"phase": "kernel", "kernel": kernel,
               "shape": f"{label} M={m} K={k} K_s={k_s} N={n}", **res,
               "ms": timer(lambda: quantized_matmul(x, qt)),
               "plain_ms": timer(lambda: plain(x, qt)),
               "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
               "library": "torch.matmul on the pre-dequantized bf16 weight",
               "bound_ms": b_ms, "bound_by": b_by, "bytes_bound": bytes_moved}
        emit(row)
        rows.append(row)
    return rows


def phase_b5(timer, dev, params) -> list:
    """Kernel B5 at llama2-7b's product shapes (w2 also K-padded) against
    its plain version (_matmul_rows)."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (i4_matmul_plain,
                                                            i4_weight)
    gen = torch.Generator(device=dev).manual_seed(31)
    return [row for name, qt in _i4_weights(params).items()
            for row in _matmul_rows(timer, "i4_matmul", name, qt,
                                    i4_weight(qt), gen, i4_matmul_plain)]


def phase_i4x8_gemv(timer, dev, params) -> list:
    """B4 mode (b)'s i4x8 GEMV alone at the four layer shapes (w2 also
    stored K-padded), M in {1, 8}, against its plain version.  No PyTorch
    call computes the i4x8 product; the yardstick is torch.matmul on the
    pre-dequantized bf16 weight (another function, same bytes to read if
    the weight were 4-bit)."""
    from inferflow_tpu_torch.kernels.decode_step import (i4x8_gemv_cuda,
                                                         i4x8_matmul_plain)
    from inferflow_tpu_torch.kernels.dequant_matmul import i4_weight
    gen = torch.Generator(device=dev).manual_seed(32)
    rows = []
    weights = _i4_weights(params)
    weights.pop("lm_head")
    for name, qt in weights.items():
        k, n = (int(v) for v in qt.shape)
        k_s = qt.storage_k
        w_bf16 = torch.nn.functional.pad(i4_weight(qt), (0, 0, 0, k_s - k))
        for m in (1, 8):
            x = torch.randn((m, k_s), generator=gen, device=dev).to(
                torch.bfloat16)
            x[:, k:] = 0
            got = i4x8_gemv_cuda(x, qt)
            ref = i4x8_matmul_plain(x, qt)
            again = i4x8_gemv_cuda(x, qt)
            torch.cuda.synchronize()
            res = compare(got.to(torch.bfloat16), ref)
            res["same_bits_twice"] = bool(torch.equal(got, again))
            res["ok"] = res["ok"] and res["same_bits_twice"]
            bytes_moved = 2 * m * k_s + qt.nbytes + 4 * m * n
            b_ms, b_by = bound(bytes_moved, 2 * m * k_s * n, H100_INT8_OPS)
            row = {"phase": "kernel", "kernel": "i4x8_gemv",
                   "shape": f"{name} M={m} K={k} K_s={k_s} N={n}", **res,
                   "ms": timer(lambda: i4x8_gemv_cuda(x, qt)),
                   "plain_ms": timer(lambda: i4x8_matmul_plain(x, qt),
                                     f"i4x8_matmul_plain {name} M={m}"),
                   "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                   "library": "torch.matmul on the pre-dequantized bf16 "
                              "weight (not the i4x8 function)",
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bytes_bound": bytes_moved}
            emit(row)
            rows.append(row)
    return rows


def phase_b4_i4(timer, dev, spec, params, spec_i8, params_i8) -> list:
    """B4 mode (b) at full llama2-7b width and depth against its plain
    version (both on the card, on twin caches of I4_CONTEXT rows): one
    layer alone and the whole stack, at B = 8 and B = 1; B4 (a) on
    llama2-7b i8mm weights (run (c)'s) timed on the same cache rows."""
    import dataclasses
    from inferflow_tpu_torch.kernels import decode_step
    hp = spec.hyper_params
    n_layers = hp.decoder_layers
    rows = []
    for lengths in (I4_FUSED_LENGTHS, (I4_CONTEXT // 2,)):
        b = len(lengths)
        cache, gen = _filled_cache(dev, spec, b, I4_CONTEXT, seed=33,
                                   context=I4_CONTEXT)
        cache.with_length(torch.tensor(lengths, device=dev))
        twin = _twin(cache)
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = params["dec_embeddings"][tokens]
        pos = cache.length[:, None].clone()
        one = [dataclasses.replace(c, k=c.k[:1], v=c.v[:1],
                                   k_scale=c.k_scale[:1],
                                   v_scale=c.v_scale[:1])
               for c in (cache, twin)]
        got1, _ = decode_step.fused_decode_step(spec, params["layers"][:1],
                                                x, pos, one[0])
        ref1, _ = decode_step.fused_decode_step_plain(
            spec, params["layers"][:1], x, pos, one[1])
        one_layer = compare(got1, ref1, ONE_LAYER_TOL)
        got, _ = decode_step.fused_decode_step(spec, params["layers"], x,
                                               pos, cache)
        again, _ = decode_step.fused_decode_step(spec, params["layers"], x,
                                                 pos, cache)
        ref, _ = decode_step.fused_decode_step_plain(spec, params["layers"],
                                                     x, pos, twin)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        steps = []
        for layer in range(n_layers):
            worst = 0.0
            for a, r in zip(cache.read_layer(layer, torch.float32),
                            twin.read_layer(layer, torch.float32)):
                for slot, n in enumerate(lengths):
                    row = min(n, I4_CONTEXT - 1)
                    q8 = r[slot, row].abs().amax(dim=-1) / 127.0
                    diff = (a[slot, row] - r[slot, row]).abs().amax(dim=-1)
                    worst = max(worst, (diff / q8.clamp(min=1e-12)).max()
                                .item())
            steps.append(worst)
        live = sum(min(n, I4_CONTEXT) for n in lengths)
        nblk = hp.head_dim // 32
        kv_bytes = 2 * n_layers * live * hp.kv_heads * (hp.head_dim
                                                        + 2 * nblk)
        new_rows = 2 * n_layers * b * hp.kv_heads * (hp.head_dim + 2 * nblk)
        bytes_moved = _weight_bytes(params) + kv_bytes + new_rows \
            + 2 * 2 * b * hp.embd_dims
        ops = 2 * b * sum(lp[g][w].storage_k * lp[g][w].shape[-1]
                          for lp in params["layers"]
                          for g, w in (("attn", "qkv"), ("attn", "wo"),
                                       ("ffn", "w1n3"), ("ffn", "w2")))
        b_ms, b_by = bound(bytes_moved, ops, H100_INT8_OPS)
        ok = bool(np.isfinite(err) and err <= I4_FUSED_TOL * scale
                  and steps[0] <= 1.0 + 1e-3 and one_layer["ok"]
                  and torch.equal(got, again))
        # the control: B4 (a) on i8mm weights against its plain version on
        # the same inputs (the new rows the steps write are never read)
        got_i8, _ = decode_step.fused_decode_step(
            spec_i8, params_i8["layers"], x, pos, cache)
        ref_i8, _ = decode_step.fused_decode_step_plain(
            spec_i8, params_i8["layers"], x, pos, twin)
        torch.cuda.synchronize()
        i8_rel = ((got_i8.float() - ref_i8.float()).abs().max().item()
                  / max(ref_i8.float().abs().max().item(), 1e-30))
        row = {"phase": "kernel", "kernel": "fused_decode_step_i4",
               "shape": f"{I4_MODEL_NAME} i4 L={n_layers} B={b} "
                        f"lengths={list(lengths)} S={I4_CONTEXT}",
               "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
               "tolerance": f"max_abs_err <= {I4_FUSED_TOL} * max|plain|; "
                            f"layer-0 rows within one Q8 step; one layer "
                            f"alone: {one_layer['tolerance']}; the same "
                            f"bits on a second run",
               "one_layer": one_layer,
               "i8mm_b4_rel_err_vs_plain": i8_rel,
               "same_bits_twice": bool(torch.equal(got, again)),
               "appended_row_q8_steps_by_layer": steps, "ok": ok,
               "ms": timer(lambda: decode_step.fused_decode_step(
                   spec, params["layers"], x, pos, cache),
                   f"fused_decode_step i4 B={b}"),
               "plain_ms": timer(lambda: decode_step.fused_decode_step_plain(
                   spec, params["layers"], x, pos, twin),
                   f"fused_decode_step_plain i4 B={b}", I4_PLAIN_ITERS),
               "i8mm_ms": timer(lambda: decode_step.fused_decode_step(
                   spec_i8, params_i8["layers"], x, pos, cache),
                   f"fused_decode_step i8mm B={b}"),
               "i8mm_weight_bytes": _weight_bytes(params_i8),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes_bound": bytes_moved}
        emit(row)
        rows.append(row)
        del cache, twin, one
        torch.cuda.empty_cache()
    return rows


def _packed_twin(params):
    """The same Q4_B64T1 values in the packed wire layout: data_i4p is
    the wire plane XOR 0x88 (codec_torch.repack_i4)."""
    from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor

    def conv(node):
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(node.format, node.shape,
                                   {"data": node.planes["data_i4p"] ^ 0x88},
                                   node.scale, node.base)
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node
    return conv(params)


def _split_row_errors(report: dict) -> dict:
    """The worst prefill row (each query's first sampled row) and the
    worst decode row over the queries of a _row_errors report."""
    per_q = [v for k, v in report.items() if k.startswith("q")]
    return {"prefill_max_abs_err": max(v["row_errs"][0] for v in per_q),
            "decode_max_abs_err": max(max(v["row_errs"][1:]) for v in per_q),
            "argmax_equal": sum(v["argmax_equal"] for v in per_q),
            "rows": sum(v["rows"] for v in per_q)}


def phase_engine_e(dev, cfg, spec, params, memory, i8mm_weight_bytes) -> dict:
    """Run (e): the ini's engine at full depth on the card, then a packed
    engine on the card (B1/B2, per-layer) built from the same Q4_B64T1
    values, fed (e)'s tokens; every sampled row held against it."""
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.models.zoo import make_spec
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    hp = spec.hyper_params
    vocab = hp.vocab_size
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)]
               for n in ENGINE_E_PROMPTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = InferenceEngine(spec, params,
                          max_concurrent_queries=cfg.max_concurrent_queries,
                          max_context_len=spec.max_context_len, device=dev)
    cache_bytes = _pool_bytes(eng.cache)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    memory = dict(memory, cache=cache_bytes,
                  serving_peak=torch.cuda.max_memory_allocated(dev)
                  - memory["before"])
    emit({"phase": "engine_e", "config": I4_INI, "model": I4_MODEL_NAME,
          "layers": hp.decoder_layers, "device_layout": spec.device_layout,
          "layout_type": type(params["lm_head"]).__name__,
          "lm_head_planes": sorted(params["lm_head"].planes),
          "slots": cfg.max_concurrent_queries,
          "context": spec.max_context_len, "queries": len(prompts),
          "prompt_lens": list(ENGINE_E_PROMPTS),
          "tokens_served": sum(len(o) for o in outputs),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "wall_s": wall_s, "device_bytes": memory,
          "i8mm_weight_bytes_run_c": i8mm_weight_bytes,
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "first_tokens": [o[:4] for o in outputs],
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    assert launches.get("fused_decode_step_i4", 0) == len(decode_ms), \
        "a decode step did not take B4 (b)"
    for k in ("i4_matmul", "chunk_attention"):
        assert launches.get(k, 0) > 0, f"{k} never launched in run e"
    for k in ("fused_decode_step", "i8mm_gemv", "dequant_matmul",
              "decode_attention", "paged_decode_attention"):
        assert launches.get(k, 0) == 0, f"{k} launched in run e"
    profile_decode(eng, prompts[0], "e")
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec_p = make_spec(I4_MODEL_NAME, layers=hp.decoder_layers,
                       device_layout="packed")
    spec_p.qkv_format = spec.qkv_format
    ref = InferenceEngine(spec_p, _packed_twin(params),
                          max_concurrent_queries=cfg.max_concurrent_queries,
                          max_context_len=spec.max_context_len, device=dev)
    ref_rows = _record_rows(ref, forced=dict(zip(qids, outputs)))
    _build.launch_counts.clear()
    ref_qids, _, ref_decode_ms, _ = _serve(ref, prompts, MAX_NEW)
    ref_launches = dict(_build.launch_counts)
    assert ref_qids == qids, (ref_qids, qids)
    assert ref_launches.get("dequant_matmul", 0) > 0
    assert ref_launches.get("i4_matmul", 0) == 0
    del ref
    torch.cuda.empty_cache()
    report = {"phase": "engine_e_vs_packed_card",
              "reference_s": time.perf_counter() - t0,
              "reference_decode_ms_median": float(np.median(ref_decode_ms)),
              "tolerance": f"prefill rows max_abs_err <= "
                           f"{ENGINE_E_PREFILL_TOL}, decode rows <= "
                           f"{ENGINE_E_DECODE_TOL}"}
    report.update(_row_errors(qids, prompts, outputs, rows, ref_rows,
                              ENGINE_E_DECODE_TOL))
    report.update(_split_row_errors(report))
    report["ok"] = bool(report["ok"] and report["prefill_max_abs_err"]
                        <= ENGINE_E_PREFILL_TOL)
    emit(report)
    assert report["ok"], "run e: rows disagree with the packed engine"
    return launches


def phase_engine_cut_cpu(dev, cfg, spec, params, label, ini, model,
                         prompts_lens, slots, context, must_launch,
                         must_not_launch) -> dict:
    """Runs (e-cpu), (f) and (g-cpu): an ini's engine at a cut depth on the
    card, held against the same engine on the CPU (plain versions)."""
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    vocab = spec.hyper_params.vocab_size
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)]
               for n in prompts_lens]
    eng = InferenceEngine(spec, params, max_concurrent_queries=slots,
                          max_context_len=context, device=dev)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    qids, _, decode_ms, steps = _serve(eng, prompts, ENGINE_CUT_CPU_NEW)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    emit({"phase": f"engine_{label}", "config": ini,
          "model": model, "layers": spec.hyper_params.decoder_layers,
          "device_layout": spec.device_layout, "slots": slots,
          "context": context, "prompt_lens": list(prompts_lens),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    for k in must_launch:
        assert launches.get(k, 0) > 0, f"{k} never launched in run {label}"
    for k in must_not_launch:
        assert launches.get(k, 0) == 0, f"{k} launched in run {label}"
    del eng
    torch.cuda.empty_cache()
    check_against_cpu(spec, params, prompts, qids, rows, outputs, label,
                      ENGINE_CUT_CPU_TOL,
                      dict(max_concurrent_queries=slots,
                           max_context_len=context), ENGINE_CUT_CPU_NEW)
    return launches


# ------------------------------------------------------------- Q3H (pair8)
def _q3h_weights(params) -> dict:
    """The five products of llama2-13b in Q3H pair8 (layer 0, the
    lm_head)."""
    lp = params["layers"][0]
    return {"qkv": lp["attn"]["qkv"], "wo": lp["attn"]["wo"],
            "w1n3": lp["ffn"]["w1n3"], "w2": lp["ffn"]["w2"],
            "lm_head": params["lm_head"]}


def _i8mm_bytes(params) -> int:
    """The device bytes the same model takes under i8mm, the layout the
    auto rule picks on this card: each quantized (K, N) weight as K*N int8
    codes and N float32 column scales (Int8MXUTensor.nbytes), everything
    else as it is."""
    from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor

    def size(t):
        if isinstance(t, QuantizedTensor):
            k, n = (int(v) for v in t.shape)
            return k * n + 4 * n
        return t.nbytes
    return sum(size(t) for lp in params["layers"]
               for grp in (lp["attn"], lp["ffn"]) for t in grp.values()) \
        + size(params["lm_head"]) + params["dec_embeddings"].nbytes


def _model_bytes(params) -> int:
    return _weight_bytes(params) + params["lm_head"].nbytes \
        + params["dec_embeddings"].nbytes


def phase_b6(timer, dev, params) -> list:
    """Kernel B6 (pair8) at llama2-13b's product shapes against its plain
    version (_matmul_rows)."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul_plain)
    from inferflow_tpu_torch.quant.codec_torch import dequantize
    gen = torch.Generator(device=dev).manual_seed(51)
    return [row for name, qt in _q3h_weights(params).items()
            for row in _matmul_rows(timer, "q3h_matmul", name, qt,
                                    dequantize(qt, torch.bfloat16), gen,
                                    quantized_matmul_plain)]


def _dense_twin(params):
    """The same quantized values dequantized to bf16
    (codec_torch.dequantize, the weights B6 and B1 multiply by): linear's
    dense branch serves them."""
    from inferflow_tpu_torch.quant.codec_torch import (QuantizedTensor,
                                                       dequantize)

    def conv(node):
        if isinstance(node, QuantizedTensor):
            return dequantize(node, torch.bfloat16)
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node
    return conv(params)


def phase_engine_twin(dev, cfg, spec, params, memory, label, ini, model,
                      kernel, prompt_lens, seed, tol) -> dict:
    """Runs (g) and (l): the ini's engine at full depth on the card (every
    product `kernel`, decode the per-layer loop with B2, chunks B3; no other
    kernel), then, with its engine and cache freed, a dense twin on the
    card fed its tokens; every sampled row held against the twin's."""
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    hp = spec.hyper_params
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, hp.vocab_size, n)]
               for n in prompt_lens]
    engine_kw = dict(max_concurrent_queries=cfg.max_concurrent_queries,
                     max_context_len=spec.max_context_len, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = InferenceEngine(spec, params, **engine_kw)
    cache_bytes = _pool_bytes(eng.cache)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    memory = dict(memory, cache=cache_bytes,
                  serving_peak=torch.cuda.max_memory_allocated(dev)
                  - memory["before"])
    emit({"phase": f"engine_{label}", "config": ini, "model": model,
          "layers": hp.decoder_layers, "embd": hp.embd_dims,
          "heads": hp.decoder_heads, "kv_heads": hp.kv_heads,
          "device_layout": spec.device_layout,
          "weight_format": params["lm_head"].format,
          "lm_head_planes": sorted(params["lm_head"].planes),
          "slots": cfg.max_concurrent_queries,
          "context": spec.max_context_len, "queries": len(prompts),
          "prompt_lens": list(prompt_lens),
          "tokens_served": sum(len(o) for o in outputs),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "wall_s": wall_s, "device_bytes": memory,
          "model_bytes": _model_bytes(params),
          "i8mm_model_bytes_auto_rule": _i8mm_bytes(params),
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "first_tokens": [o[:4] for o in outputs],
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    path = (kernel, "decode_attention", "chunk_attention")
    for k in KERNEL_SOURCES:
        if k in path:
            assert launches.get(k, 0) > 0, f"{k} never launched in run {label}"
        else:
            assert launches.get(k, 0) == 0, f"{k} launched in run {label}"
    assert launches["decode_attention"] \
        == hp.decoder_layers * len(decode_ms), "a decode step missed B2"
    profile_decode(eng, prompts[0], label)
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    twin = _dense_twin(params)
    ref = InferenceEngine(spec, twin, **engine_kw)
    ref_rows = _record_rows(ref, forced=dict(zip(qids, outputs)))
    _build.launch_counts.clear()
    ref_qids, _, ref_decode_ms, _ = _serve(ref, prompts, MAX_NEW)
    torch.cuda.synchronize()
    ref_launches = dict(_build.launch_counts)
    assert ref_qids == qids, (ref_qids, qids)
    assert ref_launches.get(kernel, 0) == 0
    assert ref_launches.get("decode_attention", 0) > 0
    twin_peak = torch.cuda.max_memory_allocated(dev) - memory["before"]
    del ref, twin
    torch.cuda.empty_cache()
    report = {"phase": f"engine_{label}_vs_dense_twin_card",
              "reference_s": time.perf_counter() - t0,
              "reference_decode_ms_median": float(np.median(ref_decode_ms)),
              "reference_peak_bytes": twin_peak,
              "tolerance": f"every sampled row: max_abs_err <= {tol}"}
    report.update(_row_errors(qids, prompts, outputs, rows, ref_rows, tol))
    report.update(_split_row_errors(report))
    emit(report)
    assert report["ok"], f"run {label}: rows disagree with the dense twin"
    return launches


# ------------------------------------------------------- Q8 block weights
def _pad_wire(qt, k_s):
    """A wire-plane tensor stored with K = k_s: zero-scale, zero-base pad
    blocks of code 0, as the JAX zoo pads llama2-7b's w2 (K 11008 stored as
    11264)."""
    import torch.nn.functional as F
    from inferflow_tpu_torch.quant.codec_torch import QuantizedTensor
    from inferflow_tpu_torch.quant.formats import get_format
    fmt = get_format(qt.format)
    pad = k_s - qt.storage_k
    planes = {p.name: F.pad(qt.planes[p.name], (0, 0, 0, pad * p.bits // 8))
              for p in fmt.planes}
    meta = [None if t is None else F.pad(t, (0, 0, 0, pad // fmt.block))
            for t in (qt.scale, qt.base)]
    return QuantizedTensor(qt.format, qt.shape, planes, *meta)


def _wire_weights(params) -> dict:
    """The five products of llama2-7b in their wire planes (layer 0, the
    lm_head) and w2 stored K-padded to 11264."""
    lp = params["layers"][0]
    w2 = lp["ffn"]["w2"]
    return {"qkv": lp["attn"]["qkv"], "wo": lp["attn"]["wo"],
            "w1n3": lp["ffn"]["w1n3"], "w2": w2,
            "w2_ks11264": _pad_wire(w2, -(-w2.storage_k // 512) * 512),
            "lm_head": params["lm_head"]}


def _as_format(qt, fmt):
    """qt's values quantized again in `fmt` (the Q8_B32T1 twin of a
    Q8_B32T2 weight; K-pad blocks stay zero)."""
    from inferflow_tpu_torch.quant.codec_torch import (QuantizedTensor,
                                                       dequantize, quantize)
    full = QuantizedTensor(qt.format, (qt.storage_k, int(qt.shape[-1])),
                           qt.planes, qt.scale, qt.base)
    out = quantize(dequantize(full, torch.float32), fmt)
    return QuantizedTensor(fmt, qt.shape, out.planes, out.scale, out.base)


def phase_b1_q8(timer, dev, params) -> list:
    """Kernel B1's Q8 case at llama2-7b's product shapes (w2 also
    K-padded), in Q8_B32T2 and Q8_B32T1, against its plain version
    (_matmul_rows)."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul_plain)
    from inferflow_tpu_torch.quant.codec_torch import dequantize
    gen = torch.Generator(device=dev).manual_seed(71)
    rows = []
    for name, qt2 in _wire_weights(params).items():
        for fmt in ("Q8_B32T2", "Q8_B32T1"):
            qt = qt2 if fmt == qt2.format else _as_format(qt2, fmt)
            rows += _matmul_rows(timer, "q8_matmul", f"{name} {fmt}", qt,
                                 dequantize(qt, torch.bfloat16), gen,
                                 quantized_matmul_plain)
    return rows


def _step_vs_plain(spec, layers, x, pos, cache, twin):
    """One fused step on the card against its plain version on a twin
    cache (the same rows): (kernel out, plain out, the kernel's out of a
    second step on a third twin)."""
    from inferflow_tpu_torch.kernels import decode_step
    third = _twin(cache)
    got, _ = decode_step.fused_decode_step(spec, layers, x, pos, cache)
    again, _ = decode_step.fused_decode_step(spec, layers, x, pos, third)
    ref, _ = decode_step.fused_decode_step_plain(spec, layers, x, pos, twin)
    torch.cuda.synchronize()
    return got, ref, again


def phase_b4_byte(timer, dev, spec, params) -> list:
    """B4 mode (c) at full llama2-7b width and depth against its plain
    version (both on the card, on twin caches of Q8_CONTEXT rows): one
    layer alone (in Q8_B32T2 and in Q8_B32T1, whose base the step adds
    through the blocks' activation sums) and the whole stack, at B = 8 and
    B = 1, the same bits on a second run; timed beside its byte bound."""
    import dataclasses
    from inferflow_tpu_torch.kernels import decode_step
    hp = spec.hyper_params
    n_layers = hp.decoder_layers
    lp0 = params["layers"][0]
    t1_layer = [{"attn": dict(lp0["attn"], qkv=_as_format(lp0["attn"]["qkv"],
                                                          "Q8_B32T1"),
                              wo=_as_format(lp0["attn"]["wo"], "Q8_B32T1")),
                 "ffn": dict(lp0["ffn"],
                             w1n3=_as_format(lp0["ffn"]["w1n3"], "Q8_B32T1"),
                             w2=_as_format(lp0["ffn"]["w2"], "Q8_B32T1"))}]
    rows = []
    for lengths in (Q8_FUSED_LENGTHS, (Q8_CONTEXT // 2,)):
        b = len(lengths)
        cache, gen = _filled_cache(dev, spec, b, Q8_CONTEXT, seed=73,
                                   context=Q8_CONTEXT)
        cache.with_length(torch.tensor(lengths, device=dev))
        twin = _twin(cache)
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = params["dec_embeddings"][tokens]
        pos = cache.length[:, None].clone()
        one = [dataclasses.replace(c, k=c.k[:1], v=c.v[:1],
                                   k_scale=c.k_scale[:1],
                                   v_scale=c.v_scale[:1])
               for c in (cache, twin)]
        one_layer = {}
        for fmt, layer in (("Q8_B32T2", params["layers"][:1]),
                           ("Q8_B32T1", t1_layer)):
            got1, ref1, again1 = _step_vs_plain(
                spec, layer, x, pos,
                *(dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                                      k_scale=c.k_scale.clone(),
                                      v_scale=c.v_scale.clone())
                  for c in one))
            one_layer[fmt] = compare(got1, ref1, ONE_LAYER_TOL)
            one_layer[fmt]["same_bits_twice"] = bool(torch.equal(got1,
                                                                 again1))
        got, ref, again = _step_vs_plain(spec, params["layers"], x, pos,
                                         cache, twin)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        steps = []
        for layer in range(n_layers):
            worst = 0.0
            for a, r in zip(cache.read_layer(layer, torch.float32),
                            twin.read_layer(layer, torch.float32)):
                for slot, n in enumerate(lengths):
                    row = min(n, Q8_CONTEXT - 1)
                    q8 = r[slot, row].abs().amax(dim=-1) / 127.0
                    diff = (a[slot, row] - r[slot, row]).abs().amax(dim=-1)
                    worst = max(worst, (diff / q8.clamp(min=1e-12)).max()
                                .item())
            steps.append(worst)
        live = sum(min(n, Q8_CONTEXT) for n in lengths)
        nblk = hp.head_dim // 32
        kv_bytes = 2 * n_layers * live * hp.kv_heads * (hp.head_dim
                                                        + 2 * nblk)
        new_rows = 2 * n_layers * b * hp.kv_heads * (hp.head_dim + 2 * nblk)
        bytes_moved = _weight_bytes(params) + kv_bytes + new_rows \
            + 2 * 2 * b * hp.embd_dims
        ops = 2 * b * sum(lp[g][w].storage_k * lp[g][w].shape[-1]
                          for lp in params["layers"]
                          for g, w in (("attn", "qkv"), ("attn", "wo"),
                                       ("ffn", "w1n3"), ("ffn", "w2")))
        b_ms, b_by = bound(bytes_moved, ops)
        ok = bool(np.isfinite(err) and err <= Q8_FUSED_TOL * scale
                  and steps[0] <= 1.0 + 1e-3 and torch.equal(got, again)
                  and all(r["ok"] and r["same_bits_twice"]
                          for r in one_layer.values()))
        row = {"phase": "kernel", "kernel": "fused_decode_step_byte",
               "shape": f"{Q8_MODEL_NAME} Q8_B32T2 L={n_layers} B={b} "
                        f"lengths={list(lengths)} S={Q8_CONTEXT}",
               "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
               "tolerance": f"max_abs_err <= {Q8_FUSED_TOL} * max|plain|; "
                            f"layer-0 rows within one Q8 step; one layer "
                            f"alone (Q8_B32T2 and Q8_B32T1): max_abs_err <= "
                            f"{ONE_LAYER_TOL} * max|plain|; the same bits "
                            f"on a second run",
               "one_layer": one_layer,
               "same_bits_twice": bool(torch.equal(got, again)),
               "appended_row_q8_steps_by_layer": steps, "ok": ok,
               "ms": timer(lambda: decode_step.fused_decode_step(
                   spec, params["layers"], x, pos, cache),
                   f"fused_decode_step byte B={b}"),
               "plain_ms": timer(lambda: decode_step.fused_decode_step_plain(
                   spec, params["layers"], x, pos, twin),
                   f"fused_decode_step_plain byte B={b}", I4_PLAIN_ITERS),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes_bound": bytes_moved}
        emit(row)
        rows.append(row)
        del cache, twin, one
        torch.cuda.empty_cache()
    return rows


def phase_engine_h(dev, cfg, spec, params, memory, i8mm_weight_bytes) -> dict:
    """Run (h): the q8 ini's engine at full depth on the card (every decode
    step B4 (c), prefill and the lm_head B1-Q8, chunks B3), then, with
    (h)'s engine and cache freed, a dense bf16 twin on the card fed (h)'s
    tokens; every sampled row held against the twin's."""
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    hp = spec.hyper_params
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(1, hp.vocab_size, n)]
               for n in ENGINE_H_PROMPTS]
    engine_kw = dict(max_concurrent_queries=cfg.max_concurrent_queries,
                     max_context_len=spec.max_context_len, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = InferenceEngine(spec, params, **engine_kw)
    cache_bytes = _pool_bytes(eng.cache)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    memory = dict(memory, cache=cache_bytes,
                  serving_peak=torch.cuda.max_memory_allocated(dev)
                  - memory["before"])
    emit({"phase": "engine_h", "config": Q8_INI, "model": Q8_MODEL_NAME,
          "layers": hp.decoder_layers, "embd": hp.embd_dims,
          "device_layout": spec.device_layout or "auto",
          "weight_format": params["lm_head"].format,
          "slots": cfg.max_concurrent_queries,
          "context": spec.max_context_len, "queries": len(prompts),
          "prompt_lens": list(ENGINE_H_PROMPTS),
          "tokens_served": sum(len(o) for o in outputs),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "wall_s": wall_s, "device_bytes": memory,
          "q8_model_bytes": _model_bytes(params),
          "q8_weight_bytes": _weight_bytes(params)
          + params["lm_head"].nbytes,
          "i8mm_weight_bytes_run_c": i8mm_weight_bytes,
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "first_tokens": [o[:4] for o in outputs],
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    assert launches.get("fused_decode_step_byte", 0) == len(decode_ms), \
        "a decode step did not take B4 (c)"
    for k in ("q8_matmul", "chunk_attention"):
        assert launches.get(k, 0) > 0, f"{k} never launched in run h"
    for k in ("dequant_matmul", "decode_attention", "i4_matmul",
              "q3h_matmul", "paged_decode_attention", "fused_decode_step",
              "fused_decode_step_i4", "i8mm_gemv", "i4x8_gemv"):
        assert launches.get(k, 0) == 0, f"{k} launched in run h"
    profile_decode(eng, prompts[0], "h")
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    twin = _dense_twin(params)
    ref = InferenceEngine(spec, twin, **engine_kw)
    ref_rows = _record_rows(ref, forced=dict(zip(qids, outputs)))
    _build.launch_counts.clear()
    ref_qids, _, ref_decode_ms, _ = _serve(ref, prompts, MAX_NEW)
    torch.cuda.synchronize()
    ref_launches = dict(_build.launch_counts)
    assert ref_qids == qids, (ref_qids, qids)
    assert ref_launches.get("q8_matmul", 0) == 0
    assert ref_launches.get("fused_decode_step_byte", 0) == 0
    assert ref_launches.get("decode_attention", 0) > 0
    twin_peak = torch.cuda.max_memory_allocated(dev) - memory["before"]
    del ref, twin
    torch.cuda.empty_cache()
    report = {"phase": "engine_h_vs_dense_twin_card",
              "reference_s": time.perf_counter() - t0,
              "reference_decode_ms_median": float(np.median(ref_decode_ms)),
              "reference_peak_bytes": twin_peak,
              "tolerance": f"prefill rows max_abs_err <= "
                           f"{ENGINE_H_PREFILL_TOL}, decode rows <= "
                           f"{ENGINE_H_DECODE_TOL}"}
    report.update(_row_errors(qids, prompts, outputs, rows, ref_rows,
                              ENGINE_H_DECODE_TOL))
    report.update(_split_row_errors(report))
    report["ok"] = bool(report["ok"] and report["prefill_max_abs_err"]
                        <= ENGINE_H_PREFILL_TOL)
    emit(report)
    assert report["ok"], "run h: rows disagree with the dense twin"
    return launches


# ------------------------------------------------- sub-byte wire formats
def phase_b1_subbyte(timer, dev, params) -> list:
    """Kernel B1's sub-byte case against its plain version (_matmul_rows):
    Q6_B64T1 at llama2-7b's product shapes (w2 also K-padded), every other
    sub-byte format at w1n3 and the K-padded w2 (the Q6 weights' values
    quantized again)."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (
        quantized_matmul_plain)
    from inferflow_tpu_torch.quant.codec_torch import dequantize
    gen = torch.Generator(device=dev).manual_seed(91)
    weights = _wire_weights(params)
    cases = list(weights.items()) + [
        (name, _as_format(weights[name], fmt)) for fmt in SUBBYTE_FORMATS
        for name in ("w1n3", "w2_ks11264")]
    return [row for name, qt in cases
            for row in _matmul_rows(timer, "subbyte_matmul",
                                    f"{name} {qt.format}", qt,
                                    dequantize(qt, torch.bfloat16), gen,
                                    quantized_matmul_plain)]


# ------------------------------------------------------------ routed MoE
def _layer_view(cache, layer):
    import dataclasses
    return dataclasses.replace(
        cache, k=cache.k[layer:layer + 1], v=cache.v[layer:layer + 1],
        k_scale=cache.k_scale[layer:layer + 1],
        v_scale=cache.v_scale[layer:layer + 1])


def _clear_gaps(probs, top_k):
    """Whether each of the top_k choices of a row is separated from the
    next probability by more than MOE_GAP_EPS."""
    s = torch.sort(probs, dim=-1, descending=True).values
    return ((s[..., :top_k] - s[..., 1:top_k + 1]) > MOE_GAP_EPS).all(dim=-1)


def _moe_step_row(timer, spec, layers, x, pos, cache, label, lengths,
                  plain_iters=I4_PLAIN_ITERS) -> dict:
    """B4 (g) over `layers` against its plain version on a twin cache:
    every layer alone, fed the plain stack's input to it (routes held where
    the plain gap is clear, the output where the routes agree), then the
    whole stack (the same bits on a second run); times both and bounds the
    kernel by the bytes of the experts its routing chose."""
    from inferflow_tpu_torch.kernels import decode_step
    hp = spec.hyper_params
    top_k = hp.moe_top_k
    twin, third = _twin(cache), _twin(cache)
    routes_k, routes_p, routes_again = [], [], []
    got, _ = decode_step.fused_decode_step(spec, layers, x, pos, cache,
                                           routes=routes_k)
    again, _ = decode_step.fused_decode_step(spec, layers, x, pos, third,
                                             routes=routes_again)
    ref, _ = decode_step.fused_decode_step_plain(spec, layers, x, pos, twin,
                                                 routes=routes_p)
    torch.cuda.synchronize()
    del third
    sel_k, sel_p = routes_k[0]["experts"], routes_p[0]["experts"]
    # each layer alone on the plain stack's input to it
    one_worst, one_agree, clear_ok, clear_n = 0.0, 0, True, 0
    for layer in range(len(layers)):
        xin = routes_p[0]["inputs"][layer][:, None]
        r1 = []
        g1, _ = decode_step.fused_decode_step(
            spec, layers[layer:layer + 1], xin, pos,
            _layer_view(cache, layer), routes=r1)
        p1, _ = decode_step.fused_decode_step_plain(
            spec, layers[layer:layer + 1], xin, pos,
            _layer_view(twin, layer))
        s1 = r1[0]["experts"][0]
        agree = (s1 == sel_p[layer]).all(dim=-1)
        clear = _clear_gaps(routes_p[0]["probs"][layer], top_k)
        clear_n += int(clear.sum())
        clear_ok &= bool(torch.equal(s1[clear], sel_p[layer][clear]))
        one_agree += int(agree.sum())
        if agree.any():
            err = (g1[agree].float() - p1[agree].float()).abs().max().item()
            one_worst = max(one_worst,
                            err / p1[agree].float().abs().max().item())
    n_dec = sel_p.shape[0] * sel_p.shape[1]
    stack_agree = (sel_k == sel_p).all(dim=-1)  # (L, B)
    slots_ok = stack_agree.all(dim=0)
    err = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    err_all = err.max().item()
    err_ok = err[slots_ok].max().item() if slots_ok.any() else 0.0
    # the bound: every weight the step must read once (attention, gates,
    # norms, each chosen expert once), the live KV rows and the new ones
    distinct = [len(set(sel_k[layer].flatten().tolist()))
                for layer in range(len(layers))]
    stack = layers[0]["moe"]["experts_stacked"]
    n_exp = int(layers[0]["moe"]["gate"].shape[-1])
    expert_bytes = sum(w.nbytes for w in stack.values()) // n_exp
    shared_bytes = sum(t.nbytes for lp in layers for grp in (
        lp["attn"], {k: v for k, v in lp["moe"].items()
                     if k != "experts_stacked"}) for t in grp.values())
    b = x.shape[0]
    live = sum(min(n, cache.max_len) for n in lengths)
    nblk = hp.head_dim // 32
    kv_bytes = 2 * len(layers) * (live + b) * hp.kv_heads * (hp.head_dim
                                                            + 2 * nblk)
    bytes_moved = shared_bytes + sum(distinct) * expert_bytes + kv_bytes \
        + 2 * 2 * b * hp.embd_dims
    kn = {k: int(w.shape[-2]) * int(w.shape[-1]) for k, w in stack.items()}
    attn_kn = sum(int(lp["attn"][k].shape[-2]) * int(lp["attn"][k].shape[-1])
                  for lp in layers for k in ("qkv", "wo"))
    ops = 2 * b * attn_kn + 2 * b * top_k * len(layers) * sum(kn.values())
    b_ms, b_by = bound(bytes_moved, ops, H100_INT8_OPS)
    same = bool(torch.equal(got, again)) and bool(torch.equal(
        routes_again[0]["experts"], sel_k))
    ok = bool(np.isfinite(err_all) and one_worst <= ONE_LAYER_TOL and clear_ok
              and err_ok <= MOE_FUSED_TOL * scale and same)
    row = {"phase": "kernel", "kernel": "fused_decode_step_moe",
           "shape": f"{label} L={len(layers)} B={b} lengths={list(lengths)} "
                    f"S={cache.max_len}",
           "max_abs_err": err_all, "rel_err": err_all / max(scale, 1e-30),
           "rel_err_slots_routed_alike": err_ok / max(scale, 1e-30),
           "tolerance": f"one layer on the plain input: routes equal where "
                        f"the plain gap > {MOE_GAP_EPS}, max_abs_err <= "
                        f"{ONE_LAYER_TOL} * max|plain| where they agree; the "
                        f"stack: max_abs_err <= {MOE_FUSED_TOL} * max|plain| "
                        f"over the slots routed alike in every layer; the "
                        f"same bits on a second run",
           "one_layer_rel_err": one_worst,
           "one_layer_route_agreement": one_agree / n_dec,
           "one_layer_clear_routes": clear_n,
           "stack_route_agreement": float(stack_agree.float().mean()),
           "slots_routed_alike": int(slots_ok.sum()),
           "same_bits_twice": same, "ok": ok,
           "distinct_experts_per_layer": distinct,
           "distinct_experts": sum(distinct),
           "ms": timer(lambda: decode_step.fused_decode_step(
               spec, layers, x, pos, cache), f"fused_decode_step_moe {label}"),
           "plain_ms": timer(lambda: decode_step.fused_decode_step_plain(
               spec, layers, x, pos, twin), f"plain moe {label}",
               plain_iters),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bytes_bound": bytes_moved}
    emit(row)
    return row


def phase_b4_moe(timer, dev, spec, params) -> list:
    """B4 (g) at full mixtral-8x7b width and depth (i8mm experts) at B = 8
    and B = 1, then one layer with Q8_B32T2 experts (mode (c) products)."""
    from inferflow_tpu_torch.models.zoo import make_spec, make_synthetic_params
    hp = spec.hyper_params
    rows = []
    for lengths in (MOE_FUSED_LENGTHS, (MOE_CONTEXT // 2,)):
        b = len(lengths)
        cache, gen = _filled_cache(dev, spec, b, MOE_CONTEXT, seed=83,
                                   context=MOE_CONTEXT)
        cache.with_length(torch.tensor(lengths, device=dev))
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = params["dec_embeddings"][tokens]
        pos = cache.length[:, None].clone()
        rows.append(_moe_step_row(timer, spec, params["layers"], x, pos,
                                  cache, f"{MOE_MODEL_NAME} i8mm", lengths))
        del cache
        torch.cuda.empty_cache()
    spec1 = make_spec(MOE_MODEL_NAME, layers=1)
    q8 = make_synthetic_params(spec1, "Q8_B32T2", seed=0, device=dev)
    assert q8["layers"][0]["moe"]["experts_stacked"]["w1n3"].format \
        == "Q8_B32T2"
    for lengths in (MOE_FUSED_LENGTHS, (MOE_CONTEXT // 2,)):
        b = len(lengths)
        cache, gen = _filled_cache(dev, spec1, b, MOE_CONTEXT, seed=89,
                                   context=MOE_CONTEXT)
        cache.with_length(torch.tensor(lengths, device=dev))
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = q8["dec_embeddings"][tokens]
        pos = cache.length[:, None].clone()
        rows.append(_moe_step_row(timer, spec1, q8["layers"], x, pos, cache,
                                  f"{MOE_MODEL_NAME} Q8_B32T2", lengths))
        del cache
    del q8
    torch.cuda.empty_cache()
    return rows


def phase_engine_k(dev, cfg, spec, params, memory) -> dict:
    """Run (k): the moe ini's engine at full depth on the card (every decode
    step B4 (g), prefill chunks B3, the decode lm_head the int8 GEMV), then
    a twin on the card, the same weights and engine fed (k)'s tokens, whose
    decode steps run B4 (g)'s plain version (set here for the twin only);
    every sampled row held against the twin's."""
    from inferflow_tpu_torch.kernels import _build, decode_step
    from inferflow_tpu_torch.models import decoder as decoder_mod
    from inferflow_tpu_torch.runtime.engine import InferenceEngine
    hp = spec.hyper_params
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(1, hp.vocab_size, n)]
               for n in ENGINE_K_PROMPTS]
    engine_kw = dict(max_concurrent_queries=cfg.max_concurrent_queries,
                     max_context_len=spec.max_context_len, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = InferenceEngine(spec, params, **engine_kw)
    cache_bytes = _pool_bytes(eng.cache)
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    memory = dict(memory, cache=cache_bytes,
                  serving_peak=torch.cuda.max_memory_allocated(dev)
                  - memory["before"])
    emit({"phase": "engine_k", "config": MOE_INI, "model": MOE_MODEL_NAME,
          "layers": hp.decoder_layers, "embd": hp.embd_dims,
          "experts": hp.experts, "top_k": hp.moe_top_k,
          "device_layout": spec.device_layout or "auto",
          "slots": cfg.max_concurrent_queries,
          "context": spec.max_context_len, "queries": len(prompts),
          "prompt_lens": list(ENGINE_K_PROMPTS),
          "tokens_served": sum(len(o) for o in outputs),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "wall_s": wall_s, "device_bytes": memory,
          "prefill_ms_per_step": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step": decode_ms,
          "first_tokens": [o[:4] for o in outputs],
          "kernel_launches": {k: launches.get(k, 0)
                              for k in KERNEL_SOURCES}})
    assert launches.get("fused_decode_step_moe", 0) == len(decode_ms), \
        "a decode step did not take B4 (g)"
    for k in ("chunk_attention", "i8mm_gemv"):
        assert launches.get(k, 0) > 0, f"{k} never launched in run k"
    for k in ("dequant_matmul", "q8_matmul", "decode_attention", "i4_matmul",
              "q3h_matmul", "paged_decode_attention", "fused_decode_step",
              "fused_decode_step_i4", "fused_decode_step_byte", "i4x8_gemv"):
        assert launches.get(k, 0) == 0, f"{k} launched in run k"
    profile_decode(eng, prompts[0], "k")
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    real = decoder_mod.fused_decode_step
    decoder_mod.fused_decode_step = decode_step.fused_decode_step_plain
    try:
        ref = InferenceEngine(spec, params, **engine_kw)
        ref_rows = _record_rows(ref, forced=dict(zip(qids, outputs)))
        _build.launch_counts.clear()
        ref_qids, _, ref_decode_ms, _ = _serve(ref, prompts, MAX_NEW)
        torch.cuda.synchronize()
    finally:
        decoder_mod.fused_decode_step = real
    ref_launches = dict(_build.launch_counts)
    assert ref_qids == qids, (ref_qids, qids)
    assert ref_launches.get("fused_decode_step_moe", 0) == 0
    del ref
    torch.cuda.empty_cache()
    report = {"phase": "engine_k_vs_plain_step_twin_card",
              "reference_s": time.perf_counter() - t0,
              "reference_decode_ms_median": float(np.median(ref_decode_ms)),
              "tolerance": f"prefill rows max_abs_err <= "
                           f"{ENGINE_K_PREFILL_TOL}, decode rows <= "
                           f"{ENGINE_K_DECODE_TOL}"}
    report.update(_row_errors(qids, prompts, outputs, rows, ref_rows,
                              ENGINE_K_DECODE_TOL))
    report.update(_split_row_errors(report))
    report["ok"] = bool(report["ok"] and report["prefill_max_abs_err"]
                        <= ENGINE_K_PREFILL_TOL)
    emit(report)
    assert report["ok"], "run k: rows disagree with the plain-step twin"
    return launches


# ------------------------------------------- checkpoints from disk (n)
def write_checkpoint_tree(dev, root: str, layers: int) -> dict:
    """A llama2-7b checkpoint tree under root/models/<Q4B32_MODEL>/ at full
    width and `layers` layers: seed-0 bf16 weights under the Hugging Face
    names in shards of at most CKPT_SHARD_BYTES with their index, the
    published config.json, a generated 32000-entry byte-level BPE
    tokenizer.json and a copy of the model dir's model_spec.json.  Fails
    before writing when the disk has less room than the checkpoint."""
    import shutil
    from inferflow_tpu_torch.loaders.synthetic import (llama_config,
                                                       llama_tensor_shapes,
                                                       write_llama_checkpoint,
                                                       write_tokenizer_json)
    c = dict(LLAMA2_7B_CONFIG, layers=layers)
    cfg = llama_config(c["hidden_size"], c["intermediate_size"], c["layers"],
                       c["heads"], c["kv_heads"], c["vocab_size"],
                       c["context"], c["eps"])
    mdir = Path(root) / "models" / Q4B32_MODEL
    mdir.mkdir(parents=True, exist_ok=True)
    need = sum(2 * int(np.prod(shape))
               for _, shape, _ in llama_tensor_shapes(cfg))
    free = shutil.disk_usage(mdir).free
    emit({"phase": "checkpoint_disk", "path": str(mdir), "free_bytes": free,
          "checkpoint_bytes": need})
    if free < need + 2 ** 30:
        raise RuntimeError(f"{mdir}: {free} bytes free, the checkpoint "
                           f"needs {need}")
    t0 = time.perf_counter()
    out = write_llama_checkpoint(str(mdir), cfg, seed=0,
                                 shard_bytes=CKPT_SHARD_BYTES, device=dev)
    write_tokenizer_json(str(mdir / "tokenizer.json"), c["vocab_size"],
                         seed=0)
    shutil.copy(Path(__file__).resolve().parent / "configs" / "models"
                / Q4B32_MODEL / "model_spec.json", mdir)
    stats = {"files": len(out["files"]), "bytes": out["bytes"],
             "write_s": time.perf_counter() - t0,
             "weights_write_s": out["seconds"]}
    emit({"phase": "checkpoint_written", "layers": layers, **stats})
    return stats


def _ini_from_tree(root: str, **model_fields):
    """The q4b32 ini through the package's loader with root as its data
    root; `model_fields` override the model section's keys."""
    from inferflow_tpu_torch.config import load_engine_config
    cfg = load_engine_config(str(Path(__file__).resolve().parent
                                 / Q4B32_INI), data_root_dir=root + "/")
    for k, v in model_fields.items():
        setattr(cfg.model, k, v)
    return cfg


def _text_prompts(tokenizer, lens, seed) -> list:
    """Prompts of the given token counts, each the start of its own text
    through the loaded tokenizer (begin-of-sequence first)."""
    from inferflow_tpu_torch.loaders.synthetic import sample_text
    prompts = []
    for i, n in enumerate(lens):
        ids = tokenizer.tokenize(sample_text(2 * n + 8, seed=seed + i),
                                 add_bos=True)
        assert len(ids) >= n, (len(ids), n)
        prompts.append(ids[:n])
    return prompts


def _serve_and_count(eng, prompts, max_new):
    """Serve `prompts` with every kernel count set to 0 just before and
    read just after: (qids, rows, outputs, launches, prefill_ms,
    decode_ms, steps, wall_s)."""
    from inferflow_tpu_torch.kernels import _build
    rows = _record_rows(eng)
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    qids, prefill_ms, decode_ms, steps = _serve(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    outputs = [eng.query_tokens(q) for q in qids]
    vocab = eng.spec.hyper_params.vocab_size
    for q, o in zip(qids, outputs):
        assert len(o) == max_new and all(0 <= t < vocab for t in o), o
        assert all(np.isfinite(r).all() and r.shape == (vocab,)
                   for r in rows[q])
    return (qids, rows, outputs, launches, prefill_ms, decode_ms, steps,
            wall_s)


# run (n)'s launch set: the i4x8 step in its 32-row instantiation on every
# decode step, B5's 32-row entry and B3; no B1, B2, B4 (a) or int8 GEMV,
# and none of the other i4 geometries
ENGINE_N_MUST = ("fused_decode_step_i4_b32", "i4_matmul_b32",
                 "chunk_attention")


def phase_engine_n(dev, root: str, ckpt: dict, i4_b64_bytes, ctx) -> dict:
    """Run (n): make_engine on the q4b32 ini and the checkpoint under root
    (load timed: reading and quantizing), ENGINE_N_PROMPTS from text, 16
    greedy tokens each; the launch set; a three-step decode profile; one
    output decoded to text.  Leaves the engine in ctx["eng"]."""
    from inferflow_tpu_torch.runtime.factory import make_engine
    cfg = _ini_from_tree(root)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = make_engine(cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev) - before - _pool_bytes(
        eng.cache)
    ctx["eng"] = eng
    spec = eng.spec
    hp = spec.hyper_params
    assert (hp.embd_dims, hp.decoder_layers, hp.vocab_size) == (
        LLAMA2_7B_CONFIG["hidden_size"], LLAMA2_7B_CONFIG["layers"],
        LLAMA2_7B_CONFIG["vocab_size"])
    prompts = _text_prompts(eng.tokenizer, ENGINE_N_PROMPTS, seed=40)
    (qids, rows, outputs, launches, prefill_ms, decode_ms, steps,
     wall_s) = _serve_and_count(eng, prompts, MAX_NEW)
    qkv = eng.params["layers"][0]["attn"]["qkv"]
    report = {
        "phase": "engine_n", "config": Q4B32_INI, "model": Q4B32_MODEL,
        "checkpoint": ckpt, "load_s": load_s, "load_stats": eng.load_stats,
        "layers": hp.decoder_layers, "device_layout": spec.device_layout,
        "weight_format": qkv.format, "planes": sorted(qkv.planes),
        "scale_dtype": str(qkv.scale.dtype),
        "slots": eng.max_slots, "context": eng.max_context_len,
        "queries": len(prompts), "prompt_lens": [len(p) for p in prompts],
        "tokens_served": sum(len(o) for o in outputs),
        "engine_steps": steps, "decode_steps": len(decode_ms),
        "wall_s": wall_s,
        "device_bytes": {"weights": weights, "model_bytes":
                         _model_bytes(eng.params),
                         "cache": _pool_bytes(eng.cache),
                         "serving_peak": torch.cuda.max_memory_allocated(dev)
                         - before},
        "i4_q4_b64t1_device_bytes_run_e": i4_b64_bytes,
        "prefill_ms_per_step": prefill_ms,
        "decode_ms_per_step_median": float(np.median(decode_ms)),
        "decode_ms_per_step": decode_ms,
        "first_tokens": [o[:4] for o in outputs],
        "q1_output_text": eng.tokenizer.decode(outputs[0]),
        "kernel_launches": {k: launches.get(k, 0) for k in KERNEL_SOURCES}}
    emit(report)
    assert qkv.format == "Q4_B32T1A" and set(qkv.planes) == {"data_i4p"}
    assert launches.get("fused_decode_step_i4_b32", 0) == len(decode_ms), \
        "a decode step did not take B4 (b) in its 32-row instantiation"
    for k in ENGINE_N_MUST:
        assert launches.get(k, 0) > 0, f"{k} never launched in run n"
    for k, v in launches.items():
        assert k in ENGINE_N_MUST or v == 0, f"{k} launched in run n"
    profile_decode(eng, prompts[0], "n")
    ctx.update(qids=qids, rows=rows, outputs=outputs, prompts=prompts)
    return launches


def phase_engine_n_twin(dev, root: str, ctx) -> dict:
    """(n)'s rows against the same checkpoint and ini with the packed
    layout (Q4_B32T1A wire planes: B1's sub-byte case, B2), built after
    (n)'s engine is freed and fed (n)'s tokens."""
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.runtime.factory import make_engine
    t0 = time.perf_counter()
    ref = make_engine(_ini_from_tree(root, device_layout="packed"))
    load_s = time.perf_counter() - t0
    assert set(ref.params["lm_head"].planes) == {"data"}
    qids, prompts, outputs = ctx["qids"], ctx["prompts"], ctx["outputs"]
    ref_rows = _record_rows(ref, forced=dict(zip(qids, outputs)))
    _build.launch_counts.clear()
    ref_qids, _, ref_decode_ms, _ = _serve(ref, prompts, MAX_NEW)
    ref_launches = dict(_build.launch_counts)
    assert ref_qids == qids, (ref_qids, qids)
    assert ref_launches.get("subbyte_matmul", 0) > 0
    assert ref_launches.get("decode_attention", 0) > 0
    assert ref_launches.get("i4_matmul_b32", 0) == 0
    del ref
    torch.cuda.empty_cache()
    report = {"phase": "engine_n_vs_packed_card", "reference_load_s": load_s,
              "reference_s": time.perf_counter() - t0,
              "reference_decode_ms_median": float(np.median(ref_decode_ms)),
              "tolerance": f"prefill rows max_abs_err <= "
                           f"{ENGINE_N_PREFILL_TOL}, decode rows <= "
                           f"{ENGINE_N_DECODE_TOL}"}
    report.update(_row_errors(qids, prompts, outputs, ctx["rows"], ref_rows,
                              ENGINE_N_DECODE_TOL))
    report.update(_split_row_errors(report))
    report["ok"] = bool(report["ok"] and report["prefill_max_abs_err"]
                        <= ENGINE_N_PREFILL_TOL)
    emit(report)
    ctx.update(twin_rows=ref_rows, twin_report=report)
    assert report["ok"], "run n: rows disagree with the packed engine"
    return ref_launches


def _i4_format_weights(params, fmt) -> dict:
    """llama2-7b's five products (layer 0 and the lm_head) in `fmt` under
    the i4 layout: the loaded Q4_B32T1A weights themselves, or their values
    quantized again."""
    from inferflow_tpu_torch.quant.codec_torch import repack_i4
    lp = params["layers"][0]
    weights = {"qkv": lp["attn"]["qkv"], "wo": lp["attn"]["wo"],
               "w1n3": lp["ffn"]["w1n3"], "w2": lp["ffn"]["w2"],
               "lm_head": params["lm_head"]}
    if fmt == "Q4_B32T1A":
        return weights
    return {k: repack_i4(_as_format(qt, fmt)) for k, qt in weights.items()}


def phase_b5_formats(timer, dev, params) -> list:
    """Kernel B5 on the four formats at llama2-7b's five products, M in {1,
    8, 12, 256}, against its plain version (_matmul_rows)."""
    from inferflow_tpu_torch.kernels.dequant_matmul import (i4_matmul_plain,
                                                            i4_weight)
    gen = torch.Generator(device=dev).manual_seed(91)
    rows = []
    for fmt, (kernel, _, _) in I4_FORMATS.items():
        for name, qt in _i4_format_weights(params, fmt).items():
            rows += _matmul_rows(timer, kernel, f"{name} {fmt}", qt,
                                 i4_weight(qt), gen, i4_matmul_plain)
    return rows


def phase_i4x8_formats(timer, dev, params) -> list:
    """B4 (b)'s i4x8 GEMV alone on the four formats at the five products
    (the lm_head too, which the engines give B5), M in {1, 8}, against its
    plain version (library: torch.matmul on the pre-dequantized bf16
    weight, another function)."""
    from inferflow_tpu_torch.kernels.decode_step import (i4x8_gemv_cuda,
                                                         i4x8_matmul_plain)
    from inferflow_tpu_torch.kernels.dequant_matmul import i4_weight
    gen = torch.Generator(device=dev).manual_seed(92)
    rows = []
    for fmt, (_, kernel, _) in I4_FORMATS.items():
        for name, qt in _i4_format_weights(params, fmt).items():
            k, n = (int(v) for v in qt.shape)
            w_bf16 = i4_weight(qt)
            for m in (1, 8):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                got = i4x8_gemv_cuda(x, qt)
                ref = i4x8_matmul_plain(x, qt)
                again = i4x8_gemv_cuda(x, qt)
                torch.cuda.synchronize()
                res = compare(got.to(torch.bfloat16), ref)
                res["same_bits_twice"] = bool(torch.equal(got, again))
                res["ok"] = res["ok"] and res["same_bits_twice"]
                bytes_moved = 2 * m * k + qt.nbytes + 4 * m * n
                b_ms, b_by = bound(bytes_moved, 2 * m * k * n, H100_INT8_OPS)
                row = {"phase": "kernel", "kernel": kernel,
                       "shape": f"{name} {fmt} M={m} K={k} N={n}", **res,
                       "ms": timer(lambda: i4x8_gemv_cuda(x, qt)),
                       "plain_ms": timer(lambda: i4x8_matmul_plain(x, qt),
                                         f"i4x8_matmul_plain {name} {fmt}"),
                       "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                       "library": "torch.matmul on the pre-dequantized bf16 "
                                  "weight (not the i4x8 function)",
                       "bound_ms": b_ms, "bound_by": b_by,
                       "bytes_bound": bytes_moved}
                emit(row)
                rows.append(row)
    return rows


def _i4_layers_as(layers, fmt):
    """The fused step's layers with every i4 product in `fmt` (values
    quantized again), norms shared."""
    from inferflow_tpu_torch.quant.codec_torch import repack_i4
    if fmt == "Q4_B32T1A":
        return layers
    out = []
    for lp in layers:
        attn = dict(lp["attn"], **{k: repack_i4(_as_format(lp["attn"][k],
                                                           fmt))
                                   for k in ("qkv", "wo")})
        ffn = dict(lp["ffn"], **{k: repack_i4(_as_format(lp["ffn"][k], fmt))
                                 for k in ("w1n3", "w2")})
        out.append(dict(lp, attn=attn, ffn=ffn))
    return out


@contextlib.contextmanager
def _with_i4_dot(value):
    """INFERFLOW_I4_DOT set to `value` inside, restored after."""
    old = os.environ.get("INFERFLOW_I4_DOT")
    os.environ["INFERFLOW_I4_DOT"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("INFERFLOW_I4_DOT", None)
        else:
            os.environ["INFERFLOW_I4_DOT"] = old


def _b4_stack_rows(timer, dev, spec, layers, embeddings, kernel, label,
                   peak, beside=None) -> list:
    """B4 at full depth on i4 `layers` in the mode INFERFLOW_I4_DOT selects
    now (launch count `kernel`), B = 8 (I4_FUSED_LENGTHS) and B = 1,
    against its plain version on twin caches: first each layer alone on the
    plain stack's input to it (ONE_LAYER_TOL x max|plain| each), then the
    whole stack (I4_FUSED_TOL x max|plain|, the same bits on a second run);
    times the step, its plain version (I4_FORMATS_PLAIN_ITERS calls) and,
    with `beside` = (name, INFERFLOW_I4_DOT value), the step in that other
    mode on the same inputs ("<name>_ms").  Bound: the bytes, or the
    operations at `peak`."""
    from inferflow_tpu_torch.kernels import _build, decode_step
    hp = spec.hyper_params
    n_layers = hp.decoder_layers
    rows = []
    for lengths in (I4_FUSED_LENGTHS, (I4_CONTEXT // 2,)):
        b = len(lengths)
        cache, gen = _filled_cache(dev, spec, b, I4_CONTEXT, seed=93,
                                   context=I4_CONTEXT)
        cache.with_length(torch.tensor(lengths, device=dev))
        twin = _twin(cache)
        tokens = torch.randint(1, hp.vocab_size, (b, 1), generator=gen,
                               device=dev)
        x = embeddings[tokens]
        pos = cache.length[:, None].clone()
        # layer by layer, each on the plain stack's input to it
        layer_rel, h = [], x
        for i in range(n_layers):
            views = [_twin(_layer_view(cache, i)) for _ in range(2)]
            got1, _ = decode_step.fused_decode_step(
                spec, layers[i:i + 1], h, pos, views[0])
            ref1, _ = decode_step.fused_decode_step_plain(
                spec, layers[i:i + 1], h, pos, views[1])
            layer_rel.append(compare(got1, ref1, ONE_LAYER_TOL))
            h = ref1
            del views
        _build.launch_counts.clear()
        got, _ = decode_step.fused_decode_step(spec, layers, x, pos, cache)
        again, _ = decode_step.fused_decode_step(spec, layers, x, pos, cache)
        launched = dict(_build.launch_counts)
        ref, _ = decode_step.fused_decode_step_plain(spec, layers, x, pos,
                                                     twin)
        torch.cuda.synchronize()
        stack = compare(got, ref, I4_FUSED_TOL)
        live = sum(min(n, I4_CONTEXT) for n in lengths)
        nblk = hp.head_dim // 32
        kv_bytes = 2 * n_layers * live * hp.kv_heads * (hp.head_dim
                                                        + 2 * nblk)
        new_rows = 2 * n_layers * b * hp.kv_heads * (hp.head_dim
                                                     + 2 * nblk)
        wbytes = sum(lp[g][w].nbytes for lp in layers
                     for g, w in (("attn", "qkv"), ("attn", "wo"),
                                  ("ffn", "w1n3"), ("ffn", "w2")))
        wbytes += sum(lp[g]["pre_norm"].nbytes for lp in layers
                      for g in ("attn", "ffn"))
        bytes_moved = wbytes + kv_bytes + new_rows + 2 * 2 * b * hp.embd_dims
        ops = 2 * b * sum(lp[g][w].storage_k * lp[g][w].shape[-1]
                          for lp in layers
                          for g, w in (("attn", "qkv"), ("attn", "wo"),
                                       ("ffn", "w1n3"), ("ffn", "w2")))
        b_ms, b_by = bound(bytes_moved, ops, peak)
        same = bool(torch.equal(got, again))
        ok = bool(stack["ok"] and same and launched == {kernel: 2}
                  and all(r["ok"] for r in layer_rel))
        row = {"phase": "kernel", "kernel": kernel,
               "shape": f"{I4_MODEL_NAME} i4 {label} L={n_layers} B={b} "
                        f"lengths={list(lengths)} S={I4_CONTEXT}",
               "max_abs_err": stack["max_abs_err"],
               "rel_err": stack["rel_err"],
               "tolerance": f"stack: {stack['tolerance']}; each layer "
                            f"alone on the plain stack's input: "
                            f"max_abs_err <= {ONE_LAYER_TOL} * "
                            f"max|plain|; the same bits on a second run",
               "layer_rel_errs": [r["rel_err"] for r in layer_rel],
               "worst_layer_rel_err": max(r["rel_err"] for r in layer_rel),
               "same_bits_twice": same, "launched": launched, "ok": ok,
               "ms": timer(lambda: decode_step.fused_decode_step(
                   spec, layers, x, pos, cache),
                   f"fused_decode_step {kernel} B={b}"),
               "plain_ms": timer(
                   lambda: decode_step.fused_decode_step_plain(
                       spec, layers, x, pos, twin),
                   f"fused_decode_step_plain {kernel} B={b}",
                   I4_FORMATS_PLAIN_ITERS),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes_bound": bytes_moved, "weight_bytes": wbytes}
        if beside is not None:
            with _with_i4_dot(beside[1]):
                row[f"{beside[0]}_ms"] = timer(
                    lambda: decode_step.fused_decode_step(
                        spec, layers, x, pos, cache),
                    f"fused_decode_step {beside[0]} B={b}")
        emit(row)
        rows.append(row)
        del cache, twin
        torch.cuda.empty_cache()
    return rows


def phase_b4_i4_formats(timer, dev, spec, params) -> list:
    """B4 mode (b) at full llama2-7b width and depth on I4_STEP_FORMATS,
    B = 8 and B = 1, against its plain version (_b4_stack_rows), as the
    Q4_B64T1 phase holds it."""
    rows = []
    with _with_i4_dot("i8"):
        for fmt in I4_STEP_FORMATS:
            layers = _i4_layers_as(params["layers"], fmt)
            rows += _b4_stack_rows(timer, dev, spec, layers,
                                   params["dec_embeddings"],
                                   I4_FORMATS[fmt][2], fmt, H100_INT8_OPS)
            del layers
    return rows


def phase_i4bf16_gemv(timer, dev, params) -> list:
    """B4 (b')'s GEMV alone on the four block geometries at the five
    products (the lm_head too, which the engines give B5), M in {1, 8},
    against its plain version, the same bits twice; mode (b)'s GEMV timed
    on the same inputs (library: torch.matmul on the pre-dequantized bf16
    weight, the same function but for summation order)."""
    from inferflow_tpu_torch.kernels.decode_step import (
        i4_bf16_matmul_plain, i4bf16_gemv_cuda, i4x8_gemv_cuda)
    from inferflow_tpu_torch.kernels.dequant_matmul import i4_weight
    gen = torch.Generator(device=dev).manual_seed(94)
    rows = []
    for fmt, (kernel, i4x8, _) in I4BF16_FORMATS.items():
        for name, qt in _i4_format_weights(params, fmt).items():
            k, n = (int(v) for v in qt.shape)
            w_bf16 = i4_weight(qt)
            for m in (1, 8):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                got = i4bf16_gemv_cuda(x, qt)
                ref = i4_bf16_matmul_plain(x, qt)
                again = i4bf16_gemv_cuda(x, qt)
                torch.cuda.synchronize()
                res = compare(got.to(torch.bfloat16), ref)
                res["same_bits_twice"] = bool(torch.equal(got, again))
                res["ok"] = res["ok"] and res["same_bits_twice"]
                bytes_moved = 2 * m * k + qt.nbytes + 4 * m * n
                b_ms, b_by = bound(bytes_moved, 2 * m * k * n)
                row = {"phase": "kernel", "kernel": kernel,
                       "shape": f"{name} {fmt} M={m} K={k} N={n}", **res,
                       "ms": timer(lambda: i4bf16_gemv_cuda(x, qt)),
                       "i4x8_ms": timer(lambda: i4x8_gemv_cuda(x, qt)),
                       "i4x8_kernel": i4x8,
                       "plain_ms": timer(lambda: i4_bf16_matmul_plain(x, qt),
                                         f"i4_bf16_matmul_plain {name} "
                                         f"{fmt}"),
                       "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                       "library": "torch.matmul on the pre-dequantized bf16 "
                                  "weight",
                       "bound_ms": b_ms, "bound_by": b_by,
                       "bytes_bound": bytes_moved}
                emit(row)
                rows.append(row)
    return rows


def phase_b4_i4bf16(timer, dev, spec, params) -> list:
    """B4 mode (b') at full llama2-7b width and depth on the loaded
    Q4_B32T1A weights, B = 8 and B = 1, against its plain version
    (_b4_stack_rows), with mode (b) timed beside it."""
    with _with_i4_dot("bf16"):
        return _b4_stack_rows(timer, dev, spec, params["layers"],
                              params["dec_embeddings"],
                              I4BF16_FORMATS["Q4_B32T1A"][2], "Q4_B32T1A",
                              H100_BF16_FLOPS, beside=("i4x8", "i8"))


def phase_engine_n_cut(dev, root: str, label: str, fmt: str,
                       against: str) -> dict:
    """(n-cpu), (n-t2), (n-b16): the one-layer checkpoint under root
    through make_engine with the ini's layout and weight type `fmt`,
    ENGINE_NCPU_PROMPTS from text, ENGINE_CUT_CPU_NEW tokens each, held
    against make_engine's engine on the CPU (`against` "cpu") or against
    its twin on the card whose decode steps run B4 (b)'s plain version
    ("plain_step": the same prefill kernels, so the decode rows show the
    kernel against its plain version, as run (k)'s twin does)."""
    from inferflow_tpu_torch.kernels import decode_step
    from inferflow_tpu_torch.models import decoder as decoder_mod
    from inferflow_tpu_torch.runtime.factory import make_engine
    fields = {"device_weight_data_type": fmt}
    eng = make_engine(_ini_from_tree(root, **fields))
    kernels = I4_FORMATS[fmt]
    prompts = _text_prompts(eng.tokenizer, ENGINE_NCPU_PROMPTS, seed=60)
    (qids, rows, outputs, launches, _, decode_ms, steps,
     _) = _serve_and_count(eng, prompts, ENGINE_CUT_CPU_NEW)
    emit({"phase": f"engine_{label}", "config": Q4B32_INI,
          "weight_format": fmt, "layers": eng.spec.hyper_params.decoder_layers,
          "load_stats": eng.load_stats, "prompt_lens": list(ENGINE_NCPU_PROMPTS),
          "engine_steps": steps, "decode_steps": len(decode_ms),
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "kernel_launches": {k: launches.get(k, 0) for k in KERNEL_SOURCES}})
    assert launches.get(kernels[2], 0) == len(decode_ms), \
        f"a decode step of run {label} did not take {kernels[2]}"
    must = (kernels[0], kernels[2], "chunk_attention")
    for k in must:
        assert launches.get(k, 0) > 0, f"{k} never launched in run {label}"
    for k, v in launches.items():
        assert k in must or v == 0, f"{k} launched in run {label}"
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = make_engine(_ini_from_tree(root, **fields),
                      device="cpu" if against == "cpu" else dev)
    ref_rows = _record_rows(ref, forced=dict(zip(qids, outputs)))
    real = decoder_mod.fused_decode_step
    if against == "plain_step":
        decoder_mod.fused_decode_step = decode_step.fused_decode_step_plain
    try:
        ref_qids, _, _, _ = _serve(ref, prompts, ENGINE_CUT_CPU_NEW)
    finally:
        decoder_mod.fused_decode_step = real
    assert ref_qids == qids, (ref_qids, qids)
    del ref
    torch.cuda.empty_cache()
    report = {"phase": f"engine_{label}_vs_{against}",
              "reference_s": time.perf_counter() - t0,
              "tolerance": f"every sampled row: max_abs_err <= "
                           f"{ENGINE_CUT_CPU_TOL}"}
    report.update(_row_errors(qids, prompts, outputs, rows, ref_rows,
                              ENGINE_CUT_CPU_TOL, ENGINE_CUT_CPU_NEW))
    emit(report)
    assert report["ok"], f"run {label}: rows disagree with the reference"
    return launches


def _o_request(base: str, body: dict, path: str = "/",
               stream: bool = False):
    """One request to the service under O_TIMEOUT_S, sent again after
    O_RETRY_S while the service answers 429 (every slot taken).  Returns
    (response JSON or the SSE payloads, seconds to the first SSE payload,
    seconds in all, attempts)."""
    import urllib.error
    import urllib.request
    attempts = 0
    while True:
        attempts += 1
        t0 = time.perf_counter()
        req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=O_TIMEOUT_S) as resp:
                if not stream:
                    out = json.loads(resp.read().decode("utf-8"))
                    return out, None, time.perf_counter() - t0, attempts
                payloads, first = [], None
                for raw in resp:
                    line = raw.decode("utf-8").rstrip("\n")
                    if line.startswith("data: "):
                        first = first or time.perf_counter() - t0
                        payloads.append(line[len("data: "):])
                    else:
                        assert not line, line
                return payloads, first, time.perf_counter() - t0, attempts
        except urllib.error.HTTPError as err:
            if err.code != 429:
                raise
        time.sleep(O_RETRY_S)


def _detok(tokenizer, ids) -> str:
    """Tokens as the service turns them into text: each token's bytes, the
    visible space U+2581 as a space, decoded as utf-8."""
    return b"".join(tokenizer.vocab.id_to_bytes(t) for t in ids).replace(
        b"\xe2\x96\x81", b" ").decode("utf-8", "replace")


def phase_engine_o(dev, root: str, ctx) -> dict:
    """Run (o): the HTTP/OpenAI service on run (n)'s checkpoint and ini in
    mode (b') (INFERFLOW_I4_DOT=bf16 for this run only), warmed up, then
    driven over HTTP (see O_TIMEOUT_S); its engine's rows held against
    (n)'s packed twin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.loaders.synthetic import sample_text
    from inferflow_tpu_torch.runtime.factory import make_engine
    from inferflow_tpu_torch.sampling.strategies import SamplingOptions
    from inferflow_tpu_torch.serving import InferFlowClient, InferFlowService
    with _with_i4_dot("bf16"):
        cfg = _ini_from_tree(root)
        t0 = time.perf_counter()
        eng = make_engine(cfg)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        spec = eng.spec
        template = spec.decoder_input_template or cfg.default_prompt_template
        tok = eng.tokenizer
        decode_steps = [0]
        real_decode = eng._decode_step

        def counting(*a):
            decode_steps[0] += 1
            return real_decode(*a)

        eng._decode_step = counting
        svc = InferFlowService(eng, port=0, prompt_template=template,
                               model_name=Q4B32_MODEL, host="127.0.0.1")
        base = f"http://127.0.0.1:{svc.port}"
        client = InferFlowClient(base)
        _build.launch_counts.clear()
        svc.start(block=False)
        try:
            t_serve = time.perf_counter()
            health = client.health(timeout=O_TIMEOUT_S)
            prompt = sample_text(O_PROMPT_WORDS, seed=70)
            greedy = {"text": prompt, "decoding_alg": "greedy"}
            _, _, ttft_s, _ = _o_request(base, dict(greedy,
                                                    max_output_len=1))
            blocking, _, blocking_s, _ = _o_request(
                base, dict(greedy, max_output_len=MAX_NEW))
            streamed, first_s, stream_s, _ = _o_request(
                base, dict(greedy, max_output_len=MAX_NEW,
                           is_streaming_mode=True), stream=True)
            chat = {"messages": [{"role": "user", "content": prompt}],
                    "max_tokens": MAX_NEW}
            oa, _, _, _ = _o_request(base, chat, "/v1/chat/completions")
            oa_stream, _, _, _ = _o_request(base, dict(chat, stream=True),
                                            "/v1/chat/completions",
                                            stream=True)
            # 12 concurrent greedy requests from text
            ids = _text_prompts(tok, ENGINE_O_PROMPTS, seed=71)
            texts = [tok.decode(p[1:]) for p in ids]
            answers = [None] * len(texts)

            def one_request(i):
                answers[i] = _o_request(base, {"text": texts[i],
                                               "max_output_len": MAX_NEW,
                                               "decoding_alg": "greedy"})

            threads = [threading.Thread(target=one_request, args=(i,))
                       for i in range(len(texts))]
            t_conc = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(O_TIMEOUT_S)
            conc_s = time.perf_counter() - t_conc
            served_s = time.perf_counter() - t_serve
            launches = dict(_build.launch_counts)
            steps_served = decode_steps[0]
            alive = svc.core.is_alive() and svc.error is None
            # the decode idle share while serving: O_PROFILE_Q requests
            # decoding together; once every one has its first tokens, the
            # loop thread itself profiles its next O_PROFILE_STEPS engine
            # steps (a profiler started on another thread sees none of
            # the loop's kernels)
            prof_threads = [threading.Thread(target=_o_request, args=(
                base, {"text": sample_text(6, seed=80 + i),
                       "max_output_len": O_PROFILE_NEW,
                       "decoding_alg": "greedy"})) for i in range(
                O_PROFILE_Q)]
            for t in prof_threads:
                t.start()
            deadline = time.perf_counter() + O_TIMEOUT_S
            while time.perf_counter() < deadline:
                with eng._lock:
                    act = eng.table.active
                    ready = len(act) == O_PROFILE_Q and all(
                        len(q.generated) >= 2 for q in act)
                if ready:
                    break
                time.sleep(0.002)
            window = {"prof": profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])}
            real_infer = eng.infer

            def profiled_infer():
                if "t0" not in window:
                    window["prof"].__enter__()
                    window.update(t0=time.perf_counter(), s0=decode_steps[0])
                out = real_infer()
                if decode_steps[0] - window["s0"] >= O_PROFILE_STEPS:
                    torch.cuda.synchronize()
                    window["wall_ms"] = (time.perf_counter()
                                         - window["t0"]) * 1e3
                    window["prof"].__exit__(None, None, None)
                    with eng._lock:
                        window["decoding"] = len(eng.table.active)
                    eng.infer = real_infer
                return out

            eng.infer = profiled_infer
            for t in prof_threads:
                t.join(O_TIMEOUT_S)
            assert "wall_ms" in window, "the profiled window did not end"
            prof, wall_ms = window["prof"], window["wall_ms"]
            prof_steps, still = O_PROFILE_STEPS, window["decoding"]
            alive = alive and svc.core.is_alive() and svc.error is None
        finally:
            svc.stop()
        svc.raise_if_failed()
        events = [e for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU and _device_us(e) > 0]
        busy_ms = sum(_device_us(e) for e in events) / 1e3
        # what the same engine's generate gives on the prompt alone
        eng._decode_step = real_decode
        want = eng.generate(
            tok.tokenize(template.replace("{query}", prompt), add_bos=True),
            SamplingOptions(strategy="greedy"), MAX_NEW)
        stream_chunks = [json.loads(p) for p in streamed]
        stream_text = "".join(c["text"] for c in stream_chunks)
        oa_chunks = [json.loads(p) for p in oa_stream if p != "[DONE]"]
        conc = []
        for ans, _, secs, attempts in answers:
            qs = eng.table.get(ans["query_id"])
            conc.append({"prompt_tokens": len(qs.prompt_tokens),
                         "new_tokens": len(qs.generated),
                         "finish": qs.finish_reason, "seconds": secs,
                         "attempts": attempts,
                         "text_is_tokens": ans["text"] == _detok(
                             tok, qs.generated)})
        tokens = sum(c["new_tokens"] for c in conc)
        report = {
            "phase": "engine_o", "config": Q4B32_INI, "i4_dot": "bf16",
            "load_s": load_s, "warmup_s": warmup_s, "health": health,
            "slots": eng.max_slots, "template": template,
            "ttft_ms_one_token_request": ttft_s * 1e3,
            "blocking_ms_16_tokens": blocking_s * 1e3,
            "ms_per_token": (blocking_s - ttft_s) / (MAX_NEW - 1) * 1e3,
            "stream_first_chunk_ms": first_s * 1e3,
            "stream_ms": stream_s * 1e3, "stream_chunks": len(stream_chunks),
            "concurrent": conc, "concurrent_s": conc_s,
            "concurrent_tokens_per_s": tokens / conc_s,
            "concurrent_prompt_tokens_per_s": sum(
                c["prompt_tokens"] for c in conc) / conc_s,
            "served_s": served_s, "decode_steps": steps_served,
            "text": blocking["text"],
            "openai_content": oa["choices"][0]["message"]["content"],
            "decode_profile": {
                "steps": prof_steps, "queries_decoding_at_its_end": still,
                "wall_ms_per_step": wall_ms / max(
                    prof_steps, 1),
                "device_busy_ms_per_step": busy_ms / max(prof_steps, 1)
                if busy_ms else "not measured",
                "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
                else "not measured"},
            "kernel_launches": {k: launches.get(k, 0)
                                for k in KERNEL_SOURCES}}
        checks = {
            "health": health.get("status") == "ok",
            "stream_equals_blocking": stream_text == blocking["text"]
            and stream_chunks[-1]["is_end"] is True,
            "text_equals_generate": blocking["text"] == _detok(tok, want)
            and len(want) == MAX_NEW,
            "openai": oa["object"] == "chat.completion"
            and bool(oa["choices"][0]["message"]["content"])
            and oa_stream[-1] == "[DONE]"
            and all(c["object"] == "chat.completion.chunk"
                    for c in oa_chunks)
            and oa_chunks[-1]["choices"][0]["finish_reason"] == "stop",
            "concurrent_complete": all(
                c["text_is_tokens"] and (c["new_tokens"] == MAX_NEW
                                         or c["finish"] == "eos")
                for c in conc) and len(conc) == 12,
            "every_decode_step_b_prime": launches.get(
                ENGINE_O_MUST[0], 0) == steps_served > 0
            and launches.get("fused_decode_step_i4_b32", 0) == 0,
            "launch_set": all(launches.get(k, 0) > 0 for k in ENGINE_O_MUST)
            and all(k in ENGINE_O_MUST or v == 0
                    for k, v in launches.items()),
            "loop_alive_until_stopped": alive and not svc.core.is_alive()}
        report["checks"] = checks
        emit(report)
        assert all(checks.values()), {k: v for k, v in checks.items()
                                      if not v}
        # the rows of the same engine fed (n)'s tokens, against (n)'s twin
        base_qid = len(eng.table) + 1
        qids, outputs, prompts = ctx["qids"], ctx["outputs"], ctx["prompts"]
        rows = _record_rows(eng, forced={base_qid + i: o
                                         for i, o in enumerate(outputs)})
        o_qids, _, _, _ = _serve(eng, prompts, MAX_NEW)
        assert o_qids == [base_qid + i for i in range(len(prompts))]
        twin = ctx["twin_rows"]
        prefill, decode, agree, n_rows = 0.0, 0.0, 0, 0
        for q_o, q_n in zip(o_qids, qids):
            for j, (a, r) in enumerate(zip(rows[q_o], twin[q_n])):
                err = float(np.abs(a - r).max())
                if j == 0:
                    prefill = max(prefill, err)
                else:
                    decode = max(decode, err)
                agree += int(a.argmax() == r.argmax())
                n_rows += 1
            assert len(rows[q_o]) == len(twin[q_n]) == MAX_NEW
        n_report = ctx["twin_report"]
        rep = {"phase": "engine_o_vs_packed_card",
               "prefill_max_abs_err": prefill, "decode_max_abs_err": decode,
               "argmax_equal": agree, "rows": n_rows,
               "run_n_i4x8_decode_max_abs_err": n_report["decode_max_abs_err"],
               "run_n_argmax_equal": n_report["argmax_equal"],
               "tolerance": f"prefill rows max_abs_err <= "
                            f"{ENGINE_N_PREFILL_TOL}, decode rows <= "
                            f"{ENGINE_N_DECODE_TOL} (run n's gates)",
               "ok": prefill <= ENGINE_N_PREFILL_TOL
               and decode <= ENGINE_N_DECODE_TOL}
        emit(rep)
        assert rep["ok"], "run o: rows disagree with (n)'s packed twin"
        del eng
        torch.cuda.empty_cache()
    return launches


def _run(results, failed, pname, fn) -> None:
    try:
        results[pname] = fn()
    except Exception:  # noqa: BLE001 - report every phase, then fail
        traceback.print_exc()
        failed.append(pname)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "inferflow_tpu_torch"
            / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout: "
              "inferflow_tpu_torch/ is not beside it", file=sys.stderr)
        return 2
    from inferflow_tpu_torch.kernels import _build
    from inferflow_tpu_torch.models.zoo import make_spec
    from inferflow_tpu_torch.quant.codec_torch import resolve_auto_layout

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {name}")
    print(smi.splitlines()[0])
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}))

    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_build.SOURCES)})

    packed = make_spec(MODEL, device_layout="packed")
    timer = Timer(dev)
    results, failed = {}, []
    _run(results, failed, "dequant_matmul",
         lambda: phase_b1(timer, dev, packed))
    _run(results, failed, "decode_attention",
         lambda: phase_b2(timer, dev, packed))
    _run(results, failed, "chunk_attention",
         lambda: phase_b3(timer, dev, packed))
    _run(results, failed, "paged_decode_attention",
         lambda: phase_b7(timer, dev))

    # (a) the default layout: resolves to i8mm on the card
    spec_a = make_spec(MODEL)
    layout = resolve_auto_layout(spec_a, "Q4_B64T1", dev)
    emit({"phase": "layout", "model": MODEL, "weight_format": "Q4_B64T1",
          "resolved": layout,
          "device_memory": torch.cuda.get_device_properties(0).total_memory})
    if layout != "i8mm":
        failed.append("layout")
    params_a, memory_a = build_params(dev, spec_a)
    _run(results, failed, "i8mm_gemv",
         lambda: phase_i8mm_gemv(timer, dev, params_a))
    _run(results, failed, "fused_decode_step",
         lambda: phase_b4(timer, dev, spec_a, params_a))
    _run(results, failed, "fused_decode_step_paged",
         lambda: phase_b4_paged(timer, dev, spec_a, params_a))
    _run(results, failed, "engine_a", lambda: phase_engine(
        dev, spec_a, params_a, memory_a, "a",
        ("fused_decode_step", "chunk_attention", "i8mm_gemv"),
        ("decode_attention", "dequant_matmul"), ENGINE_I8MM_LOGIT_TOL))
    # (d) paging on, the first ENGINE_D_LAYERS layers of (a)'s weights
    spec_d = make_spec(MODEL, layers=ENGINE_D_LAYERS)
    spec_d.qkv_format = spec_a.qkv_format  # the weights' fused qkv
    params_d = dict(params_a, layers=params_a["layers"][:ENGINE_D_LAYERS])
    _run(results, failed, "engine_d", lambda: phase_engine(
        dev, spec_d, params_d, dict(memory_a), "d",
        ("fused_decode_step", "i8mm_gemv"),
        ("paged_decode_attention", "chunk_attention", "decode_attention",
         "dequant_matmul"), ENGINE_I8MM_LOGIT_TOL,
        engine_kw={"kv_cache_paging": True}, max_new=ENGINE_CUT_CPU_NEW))
    del params_a, params_d
    torch.cuda.empty_cache()

    # (b) slice 1's packed wire layout, per-layer decode
    spec_b = make_spec(MODEL, device_layout="packed", layers=ENGINE_B_LAYERS)
    params_b, memory_b = build_params(dev, spec_b)
    _run(results, failed, "engine_b", lambda: phase_engine(
        dev, spec_b, params_b, memory_b, "b",
        ("dequant_matmul", "decode_attention", "chunk_attention"),
        ("fused_decode_step",), ENGINE_LOGIT_TOL, max_new=ENGINE_CUT_CPU_NEW))
    del params_b
    torch.cuda.empty_cache()

    # (c) the paged configuration the repo ships, llama2-7b
    cfg, spec_c, fmt_c = ini_config(PAGED_INI, PAGED_MODEL)
    layout_c = resolve_auto_layout(spec_c, fmt_c, dev)
    emit({"phase": "layout", "model": PAGED_MODEL, "weight_format": fmt_c,
          "resolved": layout_c})
    if layout_c != "i8mm":
        failed.append("layout_c")
    params_c, memory_c = build_params(dev, spec_c, fmt_c)
    _run(results, failed, "engine_c", lambda: phase_engine_c(
        dev, cfg, spec_c, params_c, memory_c))
    spec_cc = ini_config(PAGED_INI, PAGED_MODEL,
                         layers=ENGINE_CCPU_LAYERS)[1]
    spec_cc.qkv_format = spec_c.qkv_format  # the weights' fused qkv
    params_cc = dict(params_c, layers=params_c["layers"][:ENGINE_CCPU_LAYERS])
    _run(results, failed, "engine_c_cpu", lambda: phase_engine_ccpu(
        dev, cfg, spec_cc, params_cc))
    del params_cc

    # the i4 layout: configs/inferflow_service.i4.ini, llama2-7b
    cfg_e, spec_e, fmt_e = ini_config(I4_INI, I4_MODEL_NAME)
    layout_e = resolve_auto_layout(spec_e, fmt_e, dev)
    emit({"phase": "layout", "model": I4_MODEL_NAME, "config": I4_INI,
          "weight_format": fmt_e, "resolved": layout_e})
    if layout_e != "i4":
        failed.append("layout_e")
    params_e, memory_e = build_params(dev, spec_e, fmt_e)
    emit({"phase": "weights", "model": I4_MODEL_NAME,
          "i4_device_bytes": memory_e, "i4_weight_bytes": sum(
              t.nbytes for t in (params_e["lm_head"],
                                 params_e["dec_embeddings"]))
          + _weight_bytes(params_e),
          "i8mm_device_bytes_run_c": memory_c})
    _run(results, failed, "i4_matmul", lambda: phase_b5(timer, dev, params_e))
    _run(results, failed, "i4x8_gemv",
         lambda: phase_i4x8_gemv(timer, dev, params_e))
    _run(results, failed, "fused_decode_step_i4", lambda: phase_b4_i4(
        timer, dev, spec_e, params_e, spec_c, params_c))
    i8mm_bytes = memory_c["weights"]
    del params_c
    torch.cuda.empty_cache()
    _run(results, failed, "engine_e", lambda: phase_engine_e(
        dev, cfg_e, spec_e, params_e, memory_e, i8mm_bytes))
    for label, layers, slots, context, prompts, must, must_not in (
            ("e_cpu", ENGINE_ECPU_LAYERS, cfg_e.max_concurrent_queries,
             spec_e.max_context_len, ENGINE_ECPU_PROMPTS,
             ("fused_decode_step_i4", "i4_matmul", "chunk_attention"),
             ("fused_decode_step", "dequant_matmul", "decode_attention",
              "i8mm_gemv")),
            ("f", ENGINE_F_LAYERS, ENGINE_F_SLOTS, ENGINE_F_CONTEXT,
             ENGINE_F_PROMPTS, ("i4_matmul", "decode_attention"),
             ("fused_decode_step_i4", "fused_decode_step", "dequant_matmul",
              "i8mm_gemv"))):
        spec_cut = ini_config(I4_INI, I4_MODEL_NAME, layers=layers)[1]
        spec_cut.qkv_format = spec_e.qkv_format  # the weights' fused qkv
        params_cut = dict(params_e, layers=params_e["layers"][:layers])
        _run(results, failed, f"engine_{label}",
             lambda: phase_engine_cut_cpu(
                 dev, cfg_e, spec_cut, params_cut, label, I4_INI,
                 I4_MODEL_NAME, prompts, slots, context, must, must_not))
    del params_e, params_cut
    torch.cuda.empty_cache()

    # Q3H pair8: configs/inferflow_service.q3h.ini, llama2-13b
    cfg_g, spec_g, fmt_g = ini_config(Q3H_INI, Q3H_MODEL_NAME)
    layout_g = resolve_auto_layout(spec_g, fmt_g, dev)
    auto_g = resolve_auto_layout(make_spec(Q3H_MODEL_NAME), fmt_g, dev)
    emit({"phase": "layout", "model": Q3H_MODEL_NAME, "config": Q3H_INI,
          "weight_format": fmt_g, "resolved": layout_g,
          "auto_rule_would_pick": auto_g})
    if layout_g != "packed" or auto_g != "i8mm":
        failed.append("layout_g")
    params_g, memory_g = build_params(dev, spec_g, fmt_g)
    emit({"phase": "weights", "model": Q3H_MODEL_NAME,
          "q3h_device_bytes": memory_g,
          "q3h_model_bytes": _model_bytes(params_g),
          "i8mm_model_bytes_auto_rule": _i8mm_bytes(params_g)})
    _run(results, failed, "q3h_matmul", lambda: phase_b6(timer, dev, params_g))
    spec_g1 = ini_config(Q3H_INI, Q3H_MODEL_NAME, layers=1)[1]
    _run(results, failed, "decode_attention_g", lambda: phase_b2(
        timer, dev, spec_g1, G_ATTN_LENGTHS, spec_g.max_context_len))
    _run(results, failed, "chunk_attention_g",
         lambda: phase_b3(timer, dev, spec_g1, G_CHUNK_START))
    _run(results, failed, "engine_g", lambda: phase_engine_twin(
        dev, cfg_g, spec_g, params_g, memory_g, "g", Q3H_INI, Q3H_MODEL_NAME,
        "q3h_matmul", ENGINE_G_PROMPTS, 6, ENGINE_G_TOL))
    spec_cut = ini_config(Q3H_INI, Q3H_MODEL_NAME,
                          layers=ENGINE_GCPU_LAYERS)[1]
    spec_cut.qkv_format = spec_g.qkv_format  # the weights' fused qkv
    params_cut = dict(params_g, layers=params_g["layers"][:ENGINE_GCPU_LAYERS])
    _run(results, failed, "engine_g_cpu", lambda: phase_engine_cut_cpu(
        dev, cfg_g, spec_cut, params_cut, "g_cpu", Q3H_INI, Q3H_MODEL_NAME,
        ENGINE_GCPU_PROMPTS, cfg_g.max_concurrent_queries,
        spec_g.max_context_len,
        ("q3h_matmul", "decode_attention", "chunk_attention"),
        ("fused_decode_step", "fused_decode_step_i4", "dequant_matmul",
         "i4_matmul", "i8mm_gemv")))
    del params_g, params_cut
    torch.cuda.empty_cache()

    # Q8 block weights: configs/inferflow_service.q8.ini, llama2-7b
    cfg_h, spec_h, fmt_h = ini_config(Q8_INI, Q8_MODEL_NAME)
    layout_h = resolve_auto_layout(spec_h, fmt_h, dev)
    emit({"phase": "layout", "model": Q8_MODEL_NAME, "config": Q8_INI,
          "weight_format": fmt_h, "resolved": layout_h})
    if fmt_h != "Q8_B32T2" or layout_h != "":
        failed.append("layout_h")
    params_h, memory_h = build_params(dev, spec_h, fmt_h)
    emit({"phase": "weights", "model": Q8_MODEL_NAME,
          "q8_device_bytes": memory_h,
          "q8_model_bytes": _model_bytes(params_h),
          "i8mm_device_bytes_run_c": memory_c})
    _run(results, failed, "q8_matmul",
         lambda: phase_b1_q8(timer, dev, params_h))
    _run(results, failed, "fused_decode_step_byte",
         lambda: phase_b4_byte(timer, dev, spec_h, params_h))
    _run(results, failed, "engine_h", lambda: phase_engine_h(
        dev, cfg_h, spec_h, params_h, memory_h, memory_c["weights"]))
    spec_cut = ini_config(Q8_INI, Q8_MODEL_NAME,
                          layers=ENGINE_HCPU_LAYERS)[1]
    spec_cut.qkv_format = spec_h.qkv_format  # the weights' fused qkv
    params_cut = dict(params_h, layers=params_h["layers"][:ENGINE_HCPU_LAYERS])
    _run(results, failed, "engine_h_cpu", lambda: phase_engine_cut_cpu(
        dev, cfg_h, spec_cut, params_cut, "h_cpu", Q8_INI, Q8_MODEL_NAME,
        ENGINE_HCPU_PROMPTS, cfg_h.max_concurrent_queries,
        spec_h.max_context_len,
        ("fused_decode_step_byte", "q8_matmul", "chunk_attention"),
        ("fused_decode_step", "fused_decode_step_i4", "dequant_matmul",
         "decode_attention", "i4_matmul", "q3h_matmul", "i8mm_gemv")))
    del params_h, params_cut
    torch.cuda.empty_cache()

    # (i) the q8c layout: every weight of tinyllama-1.1b's seed-0 Q4_B64T1
    # re-encoded as Q8_B32T2
    spec_i = make_spec(MODEL, device_layout="q8c", layers=ENGINE_I_LAYERS)
    params_i, memory_i = build_params(dev, spec_i)
    # the plain byte step takes about a second per decode step on the
    # host: ENGINE_CUT_CPU_NEW new tokens per query
    _run(results, failed, "engine_i", lambda: phase_engine(
        dev, spec_i, params_i, memory_i, "i",
        ("fused_decode_step_byte", "q8_matmul", "chunk_attention"),
        ("fused_decode_step", "fused_decode_step_i4", "dequant_matmul",
         "decode_attention", "i8mm_gemv"), ENGINE_CUT_CPU_TOL,
        max_new=ENGINE_CUT_CPU_NEW))
    del params_i
    torch.cuda.empty_cache()
    # (j) the mixed layout: q8c FFN weights, Q4 wire attention and lm_head
    spec_j = make_spec(MODEL, device_layout="mixed", layers=ENGINE_J_LAYERS)
    params_j, memory_j = build_params(dev, spec_j)
    _run(results, failed, "engine_j", lambda: phase_engine(
        dev, spec_j, params_j, memory_j, "j",
        ("dequant_matmul", "q8_matmul", "decode_attention",
         "chunk_attention"),
        ("fused_decode_step", "fused_decode_step_i4",
         "fused_decode_step_byte", "i8mm_gemv", "i4_matmul"),
        ENGINE_LOGIT_TOL, max_new=ENGINE_CUT_CPU_NEW))
    del params_j
    torch.cuda.empty_cache()

    # routed MoE: configs/inferflow_service.moe.ini, mixtral-8x7b
    cfg_k, spec_k, fmt_k = ini_config(MOE_INI, MOE_MODEL_NAME)
    layout_k = resolve_auto_layout(spec_k, fmt_k, dev)
    emit({"phase": "layout", "model": MOE_MODEL_NAME, "config": MOE_INI,
          "weight_format": fmt_k, "resolved": layout_k})
    if layout_k != "i8mm":
        failed.append("layout_k")
    params_k, memory_k = build_params(dev, spec_k, fmt_k)
    hp_k = spec_k.hyper_params
    emit({"phase": "weights", "model": MOE_MODEL_NAME,
          "moe_device_bytes": memory_k,
          "layer_and_head_weight_bytes": _weight_bytes(params_k)
          + params_k["lm_head"].nbytes,
          "embedding_bytes": params_k["dec_embeddings"].nbytes,
          "kv_cache_bytes": 2 * hp_k.decoder_layers
          * cfg_k.max_concurrent_queries * spec_k.max_context_len
          * hp_k.kv_heads * (hp_k.head_dim + 2 * hp_k.head_dim // 32)})
    _run(results, failed, "fused_decode_step_moe",
         lambda: phase_b4_moe(timer, dev, spec_k, params_k))
    _run(results, failed, "engine_k", lambda: phase_engine_k(
        dev, cfg_k, spec_k, params_k, memory_k))
    spec_cut = ini_config(MOE_INI, MOE_MODEL_NAME,
                          layers=ENGINE_KCPU_LAYERS)[1]
    spec_cut.qkv_format = spec_k.qkv_format  # the weights' fused qkv
    params_cut = dict(params_k, layers=params_k["layers"][:ENGINE_KCPU_LAYERS])
    _run(results, failed, "engine_k_cpu", lambda: phase_engine_cut_cpu(
        dev, cfg_k, spec_cut, params_cut, "k_cpu", MOE_INI, MOE_MODEL_NAME,
        ENGINE_KCPU_PROMPTS, cfg_k.max_concurrent_queries,
        spec_k.max_context_len, ("fused_decode_step_moe", "i8mm_gemv"),
        ("fused_decode_step", "fused_decode_step_i4", "fused_decode_step_byte",
         "dequant_matmul", "q8_matmul", "decode_attention", "i4_matmul",
         "q3h_matmul")))
    del params_k, params_cut
    torch.cuda.empty_cache()

    # the sub-byte wire formats: configs/inferflow_service.q6.ini, llama2-7b
    cfg_l, spec_l, fmt_l = ini_config(Q6_INI, Q6_MODEL_NAME)
    layout_l = resolve_auto_layout(spec_l, fmt_l, dev)
    auto_l = resolve_auto_layout(make_spec(Q6_MODEL_NAME), fmt_l, dev)
    emit({"phase": "layout", "model": Q6_MODEL_NAME, "config": Q6_INI,
          "weight_format": fmt_l, "resolved": layout_l,
          "auto_rule_would_pick": auto_l})
    if fmt_l != "Q6_B64T1" or layout_l != "packed" or auto_l != "i8mm":
        failed.append("layout_l")
    params_l, memory_l = build_params(dev, spec_l, fmt_l)
    emit({"phase": "weights", "model": Q6_MODEL_NAME,
          "q6_device_bytes": memory_l,
          "q6_model_bytes": _model_bytes(params_l),
          "i8mm_model_bytes_auto_rule": _i8mm_bytes(params_l)})
    _run(results, failed, "subbyte_matmul",
         lambda: phase_b1_subbyte(timer, dev, params_l))
    _run(results, failed, "engine_l", lambda: phase_engine_twin(
        dev, cfg_l, spec_l, params_l, memory_l, "l", Q6_INI, Q6_MODEL_NAME,
        "subbyte_matmul", ENGINE_L_PROMPTS, 10, ENGINE_L_TOL))
    spec_cut = ini_config(Q6_INI, Q6_MODEL_NAME,
                          layers=ENGINE_LCPU_LAYERS)[1]
    spec_cut.qkv_format = spec_l.qkv_format  # the weights' fused qkv
    params_cut = dict(params_l, layers=params_l["layers"][:ENGINE_LCPU_LAYERS])
    _run(results, failed, "engine_l_cpu", lambda: phase_engine_cut_cpu(
        dev, cfg_l, spec_cut, params_cut, "l_cpu", Q6_INI, Q6_MODEL_NAME,
        ENGINE_LCPU_PROMPTS, cfg_l.max_concurrent_queries,
        spec_l.max_context_len,
        ("subbyte_matmul", "decode_attention", "chunk_attention"),
        [k for k in KERNEL_SOURCES if k not in (
            "subbyte_matmul", "decode_attention", "chunk_attention")]))
    del params_l, params_cut
    torch.cuda.empty_cache()
    # (m) tinyllama-1.1b in Q3_B32T1A: a 2-bit and a 1-bit plane, 32-row
    # blocks
    spec_m = make_spec(MODEL, device_layout="packed", layers=ENGINE_M_LAYERS)
    params_m, memory_m = build_params(dev, spec_m, "Q3_B32T1A")
    _run(results, failed, "engine_m", lambda: phase_engine(
        dev, spec_m, params_m, memory_m, "m",
        ("subbyte_matmul", "decode_attention", "chunk_attention"),
        [k for k in KERNEL_SOURCES if k not in (
            "subbyte_matmul", "decode_attention", "chunk_attention")],
        ENGINE_LOGIT_TOL, max_new=ENGINE_CUT_CPU_NEW))
    del params_m
    torch.cuda.empty_cache()

    # checkpoints from disk: configs/inferflow_service.q4b32.ini, llama2-7b
    # in Q4_B32T1A under the i4 layout, through make_engine
    import shutil
    ckpt_root = Path(__file__).resolve().parent / CKPT_ROOT
    shutil.rmtree(ckpt_root, ignore_errors=True)
    root_n, ctx = str(ckpt_root / "q4b32"), {}
    _run(results, failed, "checkpoint_n", lambda: write_checkpoint_tree(
        dev, root_n, LLAMA2_7B_CONFIG["layers"]))
    if "checkpoint_n" in results:
        _run(results, failed, "engine_n", lambda: phase_engine_n(
            dev, root_n, results["checkpoint_n"], memory_e["weights"], ctx))
    eng_n = ctx.pop("eng", None)
    if eng_n is not None:
        spec_n, params_n = eng_n.spec, eng_n.params
        del eng_n  # and its KV cache
        torch.cuda.empty_cache()
        _run(results, failed, "i4_matmul_formats",
             lambda: phase_b5_formats(timer, dev, params_n))
        _run(results, failed, "i4x8_gemv_formats",
             lambda: phase_i4x8_formats(timer, dev, params_n))
        _run(results, failed, "fused_decode_step_i4_formats",
             lambda: phase_b4_i4_formats(timer, dev, spec_n, params_n))
        _run(results, failed, "i4bf16_gemv",
             lambda: phase_i4bf16_gemv(timer, dev, params_n))
        _run(results, failed, "fused_decode_step_i4bf16",
             lambda: phase_b4_i4bf16(timer, dev, spec_n, params_n))
        del params_n
        torch.cuda.empty_cache()
    if "outputs" in ctx:
        _run(results, failed, "engine_n_twin",
             lambda: phase_engine_n_twin(dev, root_n, ctx))
    # (o): the service over the same checkpoint, in mode (b')
    if "twin_rows" in ctx:
        _run(results, failed, "engine_o",
             lambda: phase_engine_o(dev, root_n, ctx))
    else:
        failed.append("engine_o")
    shutil.rmtree(root_n, ignore_errors=True)
    # (n-cpu), (n-t2), (n-b16): a one-layer checkpoint of the same shape
    root_1 = str(ckpt_root / "q4b32_one_layer")
    _run(results, failed, "checkpoint_n_one_layer",
         lambda: write_checkpoint_tree(dev, root_1, 1))
    if "checkpoint_n_one_layer" in results:
        for label, fmt, against in (("n_cpu", "Q4_B32T1A", "cpu"),
                                    ("n_t2", "Q4_B32T2", "plain_step"),
                                    ("n_b16", "Q4_B16", "plain_step")):
            _run(results, failed, f"engine_{label}",
                 lambda: phase_engine_n_cut(dev, root_1, label, fmt, against))
    shutil.rmtree(ckpt_root, ignore_errors=True)

    for pname in ("dequant_matmul", "decode_attention", "chunk_attention",
                  "i8mm_gemv", "fused_decode_step", "fused_decode_step_paged",
                  "paged_decode_attention", "i4_matmul", "i4x8_gemv",
                  "fused_decode_step_i4", "q3h_matmul", "decode_attention_g",
                  "chunk_attention_g", "q8_matmul",
                  "fused_decode_step_byte", "fused_decode_step_moe",
                  "subbyte_matmul", "i4_matmul_formats", "i4x8_gemv_formats",
                  "fused_decode_step_i4_formats", "i4bf16_gemv",
                  "fused_decode_step_i4bf16"):
        if any(not r["ok"] for r in results.get(pname, [])):
            failed.append(pname)
    if failed:
        print(f"chip_smoke: failed phases: {sorted(set(failed))}",
              file=sys.stderr)
        return 1

    # each kernel's launches from the engine run whose path it is on
    launches = {"dequant_matmul": results["engine_b"]["dequant_matmul"],
                "decode_attention": results["engine_b"]["decode_attention"],
                "chunk_attention": results["engine_a"]["chunk_attention"],
                "fused_decode_step": results["engine_a"]["fused_decode_step"],
                "i8mm_gemv": results["engine_a"]["i8mm_gemv"],
                "paged_decode_attention":
                    results["engine_c"]["paged_decode_attention"],
                "i4_matmul": results["engine_e"]["i4_matmul"],
                "fused_decode_step_i4":
                    results["engine_e"]["fused_decode_step_i4"],
                "q3h_matmul": results["engine_g"]["q3h_matmul"],
                "q8_matmul": results["engine_h"]["q8_matmul"],
                "fused_decode_step_byte":
                    results["engine_h"]["fused_decode_step_byte"],
                "fused_decode_step_moe":
                    results["engine_k"]["fused_decode_step_moe"],
                "subbyte_matmul": results["engine_l"]["subbyte_matmul"]}
    for run, fmt in (("engine_n", "Q4_B32T1A"), ("engine_n_t2", "Q4_B32T2"),
                     ("engine_n_b16", "Q4_B16")):
        for kname in (I4_FORMATS[fmt][0], I4_FORMATS[fmt][2]):
            launches[kname] = results[run][kname]
    o_step = I4BF16_FORMATS["Q4_B32T1A"][2]
    launches[o_step] = results["engine_o"][o_step]
    picks = {"dequant_matmul": next(r for r in results["dequant_matmul"]
                                    if r["shape"].startswith("w1n3 M=4 ")),
             "decode_attention": results["decode_attention"][0],
             "chunk_attention": results["chunk_attention"][0],
             "fused_decode_step": results["fused_decode_step"][0],
             "i8mm_gemv": next(r for r in results["i8mm_gemv"]
                               if r["shape"].startswith("lm_head M=4 ")),
             "paged_decode_attention": results["paged_decode_attention"][0],
             "i4_matmul": next(r for r in results["i4_matmul"]
                               if r["shape"].startswith("lm_head M=8 ")),
             "fused_decode_step_i4": results["fused_decode_step_i4"][0],
             "q3h_matmul": next(r for r in results["q3h_matmul"]
                                if r["shape"].startswith("w1n3 M=8 ")),
             "q8_matmul": next(r for r in results["q8_matmul"]
                               if r["shape"].startswith(
                                   "w1n3 Q8_B32T2 M=8 ")),
             "fused_decode_step_byte": results["fused_decode_step_byte"][0],
             "fused_decode_step_moe": results["fused_decode_step_moe"][0],
             "subbyte_matmul": next(r for r in results["subbyte_matmul"]
                                    if r["shape"].startswith(
                                        "w1n3 Q6_B64T1 M=8 "))}
    for fmt in I4_STEP_FORMATS:
        b5, _, step = I4_FORMATS[fmt]
        picks[b5] = next(r for r in results["i4_matmul_formats"]
                         if r["shape"].startswith(f"lm_head {fmt} M=8 "))
        picks[step] = next(r for r in results["fused_decode_step_i4_formats"]
                           if r["kernel"] == step and " B=8 " in r["shape"])
    picks[o_step] = next(r for r in results["fused_decode_step_i4bf16"]
                         if " B=8 " in r["shape"])
    summary = []
    for kname, row in picks.items():
        source, replaces = KERNEL_SOURCES[kname]
        summary.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "shape": row["shape"],
                        "launches": launches[kname],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
