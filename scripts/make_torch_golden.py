"""Write the full-size golden values of the reference package for the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --lm-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --q-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --stream-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --unfused-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --mesh-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --moe-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --ssm-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --vlm-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --dense-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --audio-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --train-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --train-families-only
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_golden.py --train-mesh

Builds the launcher's graph at the size the port's chip smoke serves
(``powerlaw_cluster(65536, 6.0, prob=0.25, seed=7)``, deduped, reversed),
samples batches 0-3 (master_seed 0, 64 colours) with the reference's dense
CSR backend, and records for each batch the sha256 of its visited mask as
little-endian uint32 plus its edge-visit counters, and the top-16 greedy
seeds over the 4-batch pool (``use_kernel=False``: the same function as the
Pallas coverage kernel, without interpret mode at 65,536 rows).  The same
under the LT diffusion (``SamplerSpec(diffusion="lt")``, which normalises
the reversed graph's in-weights) goes under ``"lt"``.  Output:
``tests/data/torch_port_golden.json``, which ``chip_smoke.py`` reads — the
one full-size check of the port on the GPU against the reference.

The ``"lm"`` entry is llama3.2-3b at full width and vocabulary with its
depth cut to 2 layers, in float32, on the weights of the port's
``models/init.py::numpy_params(cfg, seed=0)`` (numpy, no JAX) handed to the
reference in its own tree layout: a prefill of 2 prompts of 64 tokens, then
8 decode steps, each fed the reference's greedy token of the step before.
For the last prefill position and each step it records the logits at 32
seeded vocabulary ids, the max logit, the log-sum-exp, the argmax and the
top-2 gap.  ``--lm-only`` recomputes that entry alone and keeps every other
entry of the file as it is.

The ``"q"`` entry is the quantised-tile traversal at a small size:
``powerlaw_cluster(4096, 6.0, prob=0.25, seed=7)``, deduped, reordered with
``reorder.apply(g, "cluster")``, reversed, its 128×128 tiles quantised
(``fused_expand_q.quantize_probs``), and for batches 0-1 (64 colours,
roots ``rrr.batch_starts``, seeds ``rrr.batch_seeds``, master_seed 0) the
level loop of ``launch/dryrun.py``'s ``graph_q`` cell at one shard,
composed from ``fused_expand_q_ref`` as that cell composes it.  Per batch
it records the level count, the visited popcount and the sha256 of the
visited words.  ``--q-only`` recomputes that entry alone.

The ``"stream"`` entry replays the launcher's ``--stream-smoke`` draws on
the main graph: from ``default_rng(seed + 1)`` the 4 query triples, then
``stream.random_delta(g, rng, 64, 64)``.  For IC and for LT it applies the
delta to the pool's reversed graph as ``stream.plan_refresh`` does (the
reversed delta, LT renormalisation confined to the mutated destinations),
rebinds the dense CSR sampler to the mutated pair as a store does, and
records the mutated reversed graph (edge counts, sha256 of ``src``,
``dst``, ``prob``), the touched rows and row blocks (128 rows), and for
batches 0-3 the sha256, popcount, level count and edge visits.  Under LT
the reference's sampler normalises the mutated graph once more, which is
not a no-op in float32: ``renormalised_edges`` counts the weights it
moves (the port samples the mutated graph as it is, `lt.normalized`).
``--stream-only`` recomputes that entry alone.

The ``"unfused"`` entry is the unfused baseline on the main graph's
batch 0: for each of its 64 colours, ``traversal.run_single_color`` on the
reversed graph from the batch's root with the batch's counter seed, and
its ``levels_run``, the popcount of its mask and its edge visits summed;
the assembled ``(V, W)`` mask's sha256 and the total visits (which must
equal batch 0's fused mask and ``unfused_edge_visits``).  Under
``"sigma"``: ``imm.simulate_influence`` of the first 8 top-16 seeds on the
forward graph, 512 trials, master_seed 77.  ``--unfused-only`` recomputes
that entry alone (reading the seeds from the file).

The ``"mesh"`` entry is the reference's ``graph_parallel`` sampler on a
reduced graph, ``powerlaw_cluster(4096, 6.0, prob=0.25, seed=7)``
deduped, 64 colours, master_seed 0, batches 0-7: IC and LT, meshes
``(data, model)`` = (2, 2) and (1, 3), frontier dense and sparse (auto
capacity).  Per batch it records the sha256 of the visited mask and the
packed words each level moved over the model axis (``last_gather_words``,
trailing zeros dropped).  The reference runs in a subprocess of this
script (``--mesh-worker``) with 4 forced host devices, on meshes whose
axes are ``AxisType.Auto`` (``repro.launch.mesh`` makes ``Explicit``
ones, which its shard_map programs refuse).  ``--mesh-only`` recomputes
that entry alone.  ``mesh_reference_subprocess`` is the same run at any
size and case list (the port's CPU tests call it).

The ``"moe"`` entry holds two Mixture-of-Experts models, each run as the
``"lm"`` entry is (float32, weights of ``numpy_params(cfg, seed=0)``, a
prefill of 2 × 64 tokens and 8 greedy decode steps), at full width and
full vocabulary with these cuts (``MOE_CUTS``), so that the float32 model
fits this host twice over (the reference's tree and its working set):

- ``"deepseek"``: deepseek-v3-671b (d 7,168, 128 heads, MLA ranks
  1,536 / 512, rope 64, d_ff 18,432, moe_d_ff 2,048, top-8, 1 shared
  expert, vocabulary 129,280), depth cut from 61 layers to 2 with
  ``first_dense_layers`` cut from 3 to 1 (one dense layer, one MoE
  layer), routed experts cut from 256 to 16 (256 float32 experts take
  45 GB a layer); about 13.5 GB.
- ``"maverick"``: llama4-maverick-400b-a17b (d 5,120, 40 heads over 8 KV
  heads, d_ff and moe_d_ff 8,192, top-1, 1 shared expert, vocabulary
  202,048), depth cut from 48 layers to 2 (one dense, one MoE), routed
  experts cut from 128 to 8; about 13.8 GB.

Each also records, for every MoE layer call in order (``moe_calls``:
the prefill's, then each decode step's), the experts the reference's
router picked for each token (``routes``: ``lax.top_k`` indices), and
``router_margin``, the smallest gap between the k-th and the (k+1)-th
router probability over all of them, so a check can hold the port's expert
choices to the reference's and say how near a tie came.  The ``"moe_a2a"`` entry is the reference's
``_moe_forward_a2a`` on a 2×2 (data, model) mesh of 4 forced host devices
(``moe_reference`` in a subprocess, ``--moe-worker``), at deepseek-v3's
widths with 16 experts (the same cut), on ``numpy_moe(cfg, seed=11)`` and
2 × 64 tokens of ``numpy_moe_input``: aux, the router margin, every
token's experts (``routes``, tokens in (batch, position) order), 256
output values at seeded flat indices and the sum of the output's
magnitudes.
``--moe-only`` recomputes both entries and keeps the others byte for byte.

The ``"ssm"`` entry holds the two SSD models, each run as the ``"lm"``
entry is (float32, 32 seeded vocabulary ids, 8 teacher-forced greedy
steps) but with a prefill of 2 × 512 tokens, two of the configs' 256-token
chunks, so that the inter-chunk scan and the state it carries are held at
full width; full width and full vocabulary, depth cut (``SSM_CUTS``):

- ``"mamba2"``: mamba2-1.3b (d 2,048, 64 SSD heads of 64, state 128,
  vocabulary 50,280), 48 layers cut to 2;
- ``"zamba2"``: zamba2-2.7b (d 2,560, 80 SSD heads of 64, state 64; the
  shared block's 32 heads of 80, d_ff 10,240; vocabulary 32,000), 54
  layers cut to 12, two groups of five ``mamba`` layers and a
  ``mamba_attn``, so that the tied block runs twice with two KV caches.

Weights: ``numpy_params(cfg, seed=0)``, then ``numpy_ssm_heads(tree, cfg,
seed=0)`` (``models/init.py``), which redraws every mamba block's
``a_log`` (log A, A uniform in [1, 16]), ``dt_bias`` (softplus⁻¹ of a
log-uniform dt in [1e-3, 1e-1]) and ``d_skip`` (uniform in [0.5, 1.5])
per head and its ``norm`` per channel — the reference's init gives every
head the same value, which would hide a head-order mistake.  With A up to
16 the masked upper triangle of a chunk's decay overflows float32 (the
reference's ``jnp.where`` hides it).  ``--ssm-only`` recomputes this entry
alone and keeps the others byte for byte.

The ``"vlm"`` entry holds ``"phi3v"``, phi-3-vision-4.2b (d 3,072, 32
heads of 96, d_ff 8,192, vocabulary 32,064, 64 patches of 1,024) at full
width and vocabulary, its depth cut from 32 layers to 2 (``VLM_CUTS``),
run as the ``"lm"`` entry is (float32, ``numpy_params(cfg, seed=0)``, 32
seeded vocabulary ids, 8 teacher-forced greedy steps), but each of the 2
prompts is 64 patch embeddings (``numpy_patch_embeds(cfg,
VLM_PATCH_SEED, 2)``: normal, σ 0.3, as the reference's data pipeline
draws them) before 64 tokens, prefilled through the reference's
``serve/engine.prefill``: 128 positions, so the decode steps write at
``cur_len`` 128 to 135.  About 1.7 GB of float32 weights.
``--vlm-only`` recomputes this entry alone and keeps the others byte for
byte.

The ``"dense"`` entry holds the registry's other dense archs, each run as
the ``"lm"`` entry is (float32, ``numpy_params(cfg, seed=0)``, 2 × 64
tokens, 8 teacher-forced greedy steps), at full width, 2 layers, the
vocabulary cut to 32,768 as the MoE entries' (``DENSE_CUTS``):

- ``"qwen"``: qwen1.5-110b (d 8,192, 64 heads over 8 of 128 with QKV
  bias, gated d_ff 49,152; vocabulary 152,064), 80 layers cut to 2; about
  13.0 GB;
- ``"command_r"``: command-r-35b (d 8,192, 64 over 8 of 128, gated d_ff
  22,528; vocabulary 256,000), 40 layers cut to 2; about 7.8 GB;
- ``"nemotron"``: nemotron-4-340b's attention (96 heads over 8 of 192)
  and squared-ReLU MLP at the width the card trains it (d 18,432 cut to
  4,608, d_ff 73,728 to 18,432, ``chip_smoke.py``'s
  ``TRAIN_FAMILY_CUTS``), 96 layers cut to 2; about 4.0 GB.  At full
  width a layer alone is 3.45 B parameters (13.8 GB in float32): one
  layer's tree, held by the reference and by the port's check, would
  pass half of this host's memory, which other work shares.

The ``"audio"`` entry holds ``"musicgen"``, musicgen-medium (d 1,536, 24
heads of 64, gelu d_ff 6,144, 4 codebooks of 2,048) at full width and
vocabulary, 48 layers cut to 2 (``AUDIO_CUTS``), run as the ``"lm"``
entry is but with prompts of (2, 4, 64) tokens (one row a codebook) and
steps fed the reference's greedy token of every codebook; the logit
summaries' rows are (batch, codebook) pairs, 8 a step.  Each model of
both entries runs in a process of its own (``--lm-worker``), one at a
time.  ``--dense-only`` and ``--audio-only`` recompute that entry alone
(~2 min and ~20 s).

The ``"train"`` entry is two steps of the reference's ``make_train_step``
(M 1, constant lr 1e-3, AdamW with float32 moments) on llama3.2-3b at
full width and vocabulary, cut to 2 layers, float32, on the weights of
``numpy_params(cfg, seed=0)`` (the ``"lm"`` entry's), with
``SyntheticLM(cfg, 2, 256, seed=1)``'s batches 0 and 1.  It records each
step's loss and grad norm, the L2 norm of every leaf of step 0's gradient
and of the parameters after the two steps (under the port's parameter
names, a stacked leaf's groups as its layers), and 64 seeded values of
three leaves of each.  ``--train-only`` recomputes this entry alone
(~1 min, ~20 GB of host memory).

The ``"train_families"`` entry holds the same two steps (float32, M 1,
lr 1e-3, float32 moments, ``SyntheticLM(cfg, 2, 256, seed=1)``) and the
same summary (three leaves of each family's own) for one model of each
family that `make_train_step` newly trains, and for the two archs whose
training the card runs through paths of their own (nemotron's head dim
192, musicgen's codebooks), each cut as ``TRAIN_FAMILY_CUTS`` records:

- ``"mamba2"``: mamba2-1.3b, the ``"ssm"`` entry's cut (2 layers), its
  per-head mixer parameters redrawn by ``numpy_ssm_heads`` as there;
- ``"zamba2"``: zamba2-2.7b, the ``"ssm"`` entry's cut (12 layers: the
  shared block twice, its gradient summed over both), heads redrawn.

Both SSD models run chunks of 16 tokens, not 256 (the chunked SSD is
exact at any chunk length; 256 tokens are then 16 chunks and the
inter-chunk scan carries the state 15 times).  At 256 the reference's
gradient is NaN: its intra-chunk decay exponentiates the upper triangle
(cumulative A · dt of up to 255 steps, past float32's 88 at these
weights) to inf before ``jnp.where`` zeroes it, and the where's gradient
multiplies that inf by 0.  The port masks before ``exp`` and has no NaN;
the reference's forward (the ``"ssm"`` entry) is finite either way.
- ``"deepseek"``: deepseek-v3-671b at full width with MLA, one MoE layer
  of 16 experts (the ``"moe"`` cut's count, without its dense layer);
- ``"maverick"``: llama4-maverick-400b-a17b at full width, its dense
  layer and one MoE layer of 4 experts.

- ``"nemotron"``: nemotron-4-340b's attention (96 heads over 8 of 192:
  the ``simt`` backward's head dim 192 on the card) and squared-ReLU MLP
  at d 4,608, d_ff 18,432 (the card's training cut, ``chip_smoke.py``'s
  ``TRAIN_FAMILY_CUTS``), 2 layers, vocabulary 32,768;
- ``"musicgen"``: musicgen-medium at full width and vocabulary (4
  codebooks of 2,048, one loss a codebook), 2 layers; its batches are
  (2, 4, 256) tokens.

The MoE models and nemotron cut the vocabulary to 32,768: at full vocabulary
their embedding and unembedding alone are 1.85 B (deepseek) and 2.07 B
(maverick) parameters, whose float32 weights, gradient and two moments
(16 bytes a parameter) would take 30-33 GB before the layers, past what
this script may hold beside the reference's activations.  Each model runs
in a process of its own (``--train-families-worker``), so the host holds
one at a time (~25 GB at most).  ``--train-families-only`` recomputes this
entry alone (~12 min).

The ``"train_mesh"`` entry is the reference's sharded training step
(``make_train_step`` jitted on parameters placed by
``sharding_rules.param_shardings`` under ``set_mesh``, so GSPMD gathers,
reduce-scatters and, with a ``model`` axis, runs the MoE's a2a form) on
4 forced host devices (``--train-mesh-worker``), on meshes of ``Auto``
axes (``repro.launch.mesh`` makes ``Explicit`` ones, which jax 0.9's
GSPMD step and shard_map refuse), for the models of ``TRAIN_MESH_CASES``:
llama3.2-3b, deepseek-v3 (MLA and the a2a MoE) and zamba2 on a 2×2
(data, model) mesh, maverick on a data-only mesh of 4 (the scatter's
global dispatch).  Each is the registry's smoke config in float32 (the
full widths of the card's phases need more host memory than four
reference devices may hold), weights ``numpy_params(cfg, 0)`` (SSD
heads redrawn by ``numpy_ssm_heads``), ``SyntheticLM(cfg, 8, 256,
seed=1)``'s batches 0 and 1 in 2 microbatches, constant lr 1e-3, AdamW
with float32 moments.  It records each step's loss and grad norm, the
parameters after the steps (`_leaf_summary` of ``TRAIN_MESH_LEAVES``),
and every MoE call's expert picks: the reference's forward replayed
layer by layer, eagerly, under the same mesh, on the parameters before
each step (the picks of the jitted step cannot leave its scan), with the
smallest gap between a token's k-th and (k+1)-th router probability; the
entry keeps the picks as their count and sha256 (`routes_digest`).
``--train-mesh`` recomputes this entry alone (~2 min).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro import stream
from repro.configs import registry
from repro.core import bitmask, imm, lt, rrr, tiles, traversal
from repro.graph import csr, generators, reorder
from repro.kernels import fused_expand_q as feq
from repro.models import decode
from repro.sampling import SamplerSpec, make_sampler
from repro.serve import engine
from repro_torch.configs import registry as port_registry
from repro_torch.models import init as port_init

N, DEGREE, PROB, GRAPH_SEED = 65536, 6.0, 0.25, 7
COLORS, MASTER_SEED, BATCHES, K = 64, 0, 4, 16
LM_ARCH, LM_LAYERS, LM_PARAM_SEED, LM_PROMPT_SEED = "llama3.2-3b", 2, 0, 1
LM_BATCH, LM_PROMPT_LEN, LM_STEPS, LM_IDS = 2, 64, 8, 32
Q_N, Q_ORDER, Q_BATCHES, Q_MAX_LEVELS = 4096, "cluster", 2, 64
STREAM_OPS, STREAM_QUERIES, STREAM_TILE_ROWS = 64, 4, 128
SIGMA_SEEDS, SIGMA_TRIALS, SIGMA_MASTER_SEED = 8, 512, 77
MESH_N, MESH_BATCHES, MESH_DEVICES = 4096, 8, 4
# The "moe" entry's configurations: full width and vocabulary, cut in depth
# and experts (module docstring).
MOE_CUTS = {
    "deepseek": dict(arch="deepseek-v3-671b", num_layers=2,
                     first_dense_layers=1, num_experts=16),
    "maverick": dict(arch="llama4-maverick-400b-a17b", num_layers=2,
                     num_experts=8),
}
# The "ssm" entry's configurations (module docstring): full width and
# vocabulary, cut in depth; the per-head draws' seed and the prompt length.
SSM_CUTS = {"mamba2": dict(arch="mamba2-1.3b", num_layers=2),
            "zamba2": dict(arch="zamba2-2.7b", num_layers=12)}
SSM_HEADS_SEED, SSM_PROMPT_LEN = 0, 512
# The "vlm" entry's configuration (module docstring) and its patches' seed.
VLM_CUTS = {"phi3v": dict(arch="phi-3-vision-4.2b", num_layers=2)}
VLM_PATCH_SEED = 2
# The "dense" and "audio" entries' configurations (module docstring).
DENSE_CUTS = {
    "qwen": dict(arch="qwen1.5-110b", num_layers=2, vocab_size=32768),
    "command_r": dict(arch="command-r-35b", num_layers=2, vocab_size=32768),
    "nemotron": dict(arch="nemotron-4-340b", d_model=4608, d_ff=18432,
                     num_layers=2, vocab_size=32768),
}
AUDIO_CUTS = {"musicgen": dict(arch="musicgen-medium", num_layers=2)}
LM_WORKER_CUTS = {"dense": DENSE_CUTS, "audio": AUDIO_CUTS}
# The "train" entry (module docstring): depth, batches, steps, lr and the
# leaves whose values it records (64 each, at indices drawn from the seed).
TRAIN_LAYERS, TRAIN_DATA_SEED, TRAIN_BATCH, TRAIN_SEQ = 2, 1, 2, 256
TRAIN_STEPS, TRAIN_LR, TRAIN_VALUE_SEED, TRAIN_VALUES = 2, 1e-3, 5, 64
TRAIN_LEAVES = ("embedding", "layers.0.attn.wq", "layers.1.mlp.w2")
# The "train_families" entry (module docstring): each model's cuts and the
# three leaves whose values it records.
TRAIN_FAMILY_CUTS = {
    "mamba2": dict(arch="mamba2-1.3b", num_layers=2, ssm_chunk=16),
    "zamba2": dict(arch="zamba2-2.7b", num_layers=12, ssm_chunk=16),
    "deepseek": dict(arch="deepseek-v3-671b", num_layers=1,
                     first_dense_layers=0, num_experts=16,
                     vocab_size=32768),
    "maverick": dict(arch="llama4-maverick-400b-a17b", num_layers=2,
                     num_experts=4, vocab_size=32768),
    "nemotron": dict(arch="nemotron-4-340b", d_model=4608, d_ff=18432,
                     num_layers=2, vocab_size=32768),
    "musicgen": dict(arch="musicgen-medium", num_layers=2),
}
TRAIN_FAMILY_LEAVES = {
    "mamba2": ("embedding", "layers.0.mamba.in_proj",
               "layers.1.mamba.a_log"),
    "zamba2": ("layers.5.mamba.out_proj", "shared_attn.attn.wq",
               "shared_attn.mlp.w2"),
    "deepseek": ("layers.0.attn.w_uq", "layers.0.moe.router",
                 "layers.0.moe.experts_w2"),
    "maverick": ("layers.0.attn.wq", "layers.1.moe.router",
                 "layers.1.moe.experts_w1"),
    "nemotron": ("layers.0.attn.wq", "layers.1.attn.wk", "layers.1.mlp.w1"),
    "musicgen": ("embedding", "layers.0.attn.wv", "unembed"),
}
# The "train_mesh" entry (module docstring): each model's mesh, the
# batch, steps and microbatches, and the three leaves it summarises.
TRAIN_MESH_CASES = {
    "llama": dict(arch="llama3.2-3b", shape=[2, 2]),
    "deepseek": dict(arch="deepseek-v3-671b", shape=[2, 2]),
    "zamba2": dict(arch="zamba2-2.7b", shape=[2, 2]),
    "maverick": dict(arch="llama4-maverick-400b-a17b", shape=[4]),
}
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_MICRO = 8, 256, 2
TRAIN_MESH_LEAVES = {
    "llama": TRAIN_LEAVES,
    "deepseek": ("layers.0.attn.w_uq", "layers.1.moe.router",
                 "layers.2.moe.experts_w2"),
    "zamba2": ("layers.0.mamba.in_proj", "shared_attn.attn.wq",
               "shared_attn.mlp.w2"),
    "maverick": ("layers.0.attn.wq", "layers.1.moe.router",
                 "layers.1.moe.experts_w1"),
}
MOE_A2A_JOB = dict(arch="deepseek-v3-671b", overrides={"num_experts": 16},
                   seed=11, batch=2, seq=64, shape=[2, 2], n_idx=256)
MESH_CASES = [dict(diffusion=d, frontier=f, shape=list(sh))
              for sh in ((2, 2), (1, 3)) for d in ("ic", "lt")
              for f in ("dense", "sparse")]
OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests", "data",
                   "torch_port_golden.json")


def mask_sha256(visited) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(visited), "<u4").tobytes()).hexdigest()


def _logit_summary(logits: np.ndarray, ids: np.ndarray) -> dict:
    """(B, V) float32 logits → the values the port is checked against."""
    lg = logits.astype(np.float64)
    top2 = np.sort(lg, axis=-1)[:, -2:]
    mx = lg.max(-1)
    lse = mx + np.log(np.exp(lg - mx[:, None]).sum(-1))
    return {"logits_at_ids": lg[:, ids].tolist(), "max": mx.tolist(),
            "lse": lse.tolist(), "argmax": lg.argmax(-1).tolist(),
            "top2_gap": (top2[:, 1] - top2[:, 0]).tolist()}


def _tree_to_jax(tree):
    """The numpy tree as jax arrays, each numpy leaf dropped as soon as it
    is converted (a full-width float32 tree is held once, not twice)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, leaf in list(items):
        tree[key] = (_tree_to_jax(leaf) if isinstance(leaf, (dict, list))
                     else jnp.asarray(leaf))
    return tree


def _router_margin(probs, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th router probability over
    the rows of ``probs``."""
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


def _lm_entry(cfg, port_cfg, prompt_len: int = LM_PROMPT_LEN,
              ssm_heads_seed: int | None = None,
              patch_seed: int | None = None) -> dict:
    """Prefill of ``prompt_len`` tokens and teacher-forced greedy decode of
    ``cfg`` on `numpy_params(port_cfg, LM_PARAM_SEED)` (module docstring;
    the mixers' per-head parameters redrawn by `numpy_ssm_heads` when
    ``ssm_heads_seed`` is given; `numpy_patch_embeds` of ``patch_seed``
    prepended to the prompts when it is given), with the smallest router
    margin over every MoE layer call when it has MoE."""
    from repro.models import mlp as ref_mlp

    tree = port_init.numpy_params(port_cfg, LM_PARAM_SEED)
    if ssm_heads_seed is not None:
        port_init.numpy_ssm_heads(tree, port_cfg, ssm_heads_seed)
    params = _tree_to_jax(tree)
    rng = np.random.default_rng(LM_PROMPT_SEED)
    codebooks = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = rng.integers(0, cfg.vocab_size,
                          (LM_BATCH, *codebooks, prompt_len))
    ids = np.sort(rng.choice(cfg.vocab_size, LM_IDS, replace=False))
    batch = {"tokens": jnp.asarray(prompt)}
    start = prompt_len               # the first decode step's cur_len
    if patch_seed is not None:
        batch["patch_embeds"] = jnp.asarray(port_init.numpy_patch_embeds(
            port_cfg, patch_seed, LM_BATCH))
        start += cfg.num_patches
    margins, routes = [], []
    moe_forward = ref_mlp.moe_forward

    def record(probs, idx, k):
        margins.append(_router_margin(probs, k))
        routes.append(np.asarray(idx).tolist())

    def recording(p, x, c):
        probs = jax.nn.softmax(
            x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"], -1)
        jax.debug.callback(functools.partial(record, k=c.top_k), probs,
                           jax.lax.top_k(probs, c.top_k)[1])
        return moe_forward(p, x, c)

    ref_mlp.moe_forward = recording
    try:
        last, caches, _ = engine.prefill(params, cfg, batch,
                                         start + LM_STEPS)
        # (B, V), or audio's (B, K, V) as (B·K, V): a row a codebook.
        logits = np.asarray(last[:, -1], np.float32).reshape(
            -1, cfg.vocab_size)
        out = {"arch": cfg.name, "num_layers": cfg.num_layers,
               "dtype": "float32", "param_seed": LM_PARAM_SEED,
               "prompt_seed": LM_PROMPT_SEED, "prompt": prompt.tolist(),
               "vocab_ids": ids.tolist(),
               "prefill": _logit_summary(logits, ids), "decode": []}
        step = jax.jit(lambda p, c, t, n: decode.decode_step(p, cfg, c, t,
                                                             n))
        for i in range(LM_STEPS):
            tok = logits.argmax(-1).reshape(LM_BATCH, *codebooks, 1)
            lg, caches = step(params, caches, jnp.asarray(tok),
                              jnp.int32(start + i))
            logits = np.asarray(lg[:, -1], np.float32).reshape(
                -1, cfg.vocab_size)
            out["decode"].append({"cur_len": start + i,
                                  "tokens": tok[..., 0].tolist(),
                                  **_logit_summary(logits, ids)})
        jax.effects_barrier()
    finally:
        ref_mlp.moe_forward = moe_forward
    if patch_seed is not None:
        out["patch_seed"] = patch_seed
        out["num_patches"] = cfg.num_patches
    if margins:
        out["router_margin"] = min(margins)
        out["moe_calls"] = len(margins)
        out["routes"] = routes
    return out


def lm_golden() -> dict:
    """The ``"lm"`` entry (module docstring)."""
    cfg = dataclasses.replace(registry.get(LM_ARCH), num_layers=LM_LAYERS,
                              dtype="float32")
    port_cfg = dataclasses.replace(port_registry.get(LM_ARCH),
                                   num_layers=LM_LAYERS, dtype="float32")
    out = _lm_entry(cfg, port_cfg)
    out["arch"] = LM_ARCH
    return out


def moe_golden() -> dict:
    """The ``"moe"`` entry: one `_lm_entry` per `MOE_CUTS` configuration,
    with its cuts."""
    out = {}
    for name, cut in MOE_CUTS.items():
        cut = dict(cut, dtype="float32")
        cfg = dataclasses.replace(registry.get(cut["arch"]),
                                  **{k: v for k, v in cut.items()
                                     if k != "arch"})
        port_cfg = dataclasses.replace(port_registry.get(cut["arch"]),
                                       **{k: v for k, v in cut.items()
                                          if k != "arch"})
        out[name] = dict(_lm_entry(cfg, port_cfg), arch=cut["arch"],
                         cuts=cut)
    return out


def ssm_golden() -> dict:
    """The ``"ssm"`` entry: one `_lm_entry` per `SSM_CUTS` configuration,
    with its cuts, one model in memory at a time."""
    out = {}
    for name, cut in SSM_CUTS.items():
        cut = dict(cut, dtype="float32")
        over = {k: v for k, v in cut.items() if k != "arch"}
        cfg = dataclasses.replace(registry.get(cut["arch"]), **over)
        port_cfg = dataclasses.replace(port_registry.get(cut["arch"]),
                                       **over)
        out[name] = dict(_lm_entry(cfg, port_cfg, SSM_PROMPT_LEN,
                                   SSM_HEADS_SEED),
                         arch=cut["arch"], cuts=cut,
                         ssm_heads_seed=SSM_HEADS_SEED)
    return out


def vlm_golden() -> dict:
    """The ``"vlm"`` entry: one `_lm_entry` per `VLM_CUTS` configuration,
    its prompts after `VLM_PATCH_SEED`'s patch embeddings, with its
    cuts."""
    out = {}
    for name, cut in VLM_CUTS.items():
        cut = dict(cut, dtype="float32")
        over = {k: v for k, v in cut.items() if k != "arch"}
        cfg = dataclasses.replace(registry.get(cut["arch"]), **over)
        port_cfg = dataclasses.replace(port_registry.get(cut["arch"]),
                                       **over)
        out[name] = dict(_lm_entry(cfg, port_cfg,
                                   patch_seed=VLM_PATCH_SEED),
                         arch=cut["arch"], cuts=cut)
    return out


def lm_worker_entry(entry: str, name: str) -> dict:
    """One model of the ``"dense"`` or ``"audio"`` entry (``entry``):
    `_lm_entry` of its cut, with its cuts."""
    cut = dict(LM_WORKER_CUTS[entry][name], dtype="float32")
    over = {k: v for k, v in cut.items() if k != "arch"}
    cfg = dataclasses.replace(registry.get(cut["arch"]), **over)
    port_cfg = dataclasses.replace(port_registry.get(cut["arch"]), **over)
    return dict(_lm_entry(cfg, port_cfg), arch=cut["arch"], cuts=cut)


def lm_worker_golden(entry: str) -> dict:
    """The ``"dense"`` or ``"audio"`` entry: `lm_worker_entry` of each
    model in a process of its own, one at a time."""
    return {name: _worker_subprocess("--lm-worker",
                                     {"entry": entry, "name": name}, 1,
                                     3600.0)
            for name in LM_WORKER_CUTS[entry]}


def _leaf_summary(tree, cfg, rng_seed: int, leaves=TRAIN_LEAVES) -> dict:
    """L2 norm (float64) of every leaf of ``tree`` under the port's names,
    and TRAIN_VALUES seeded values of each of ``leaves``."""
    from repro_torch import convert

    named = convert.lm_named_leaves(tree, cfg)
    rng = np.random.default_rng(rng_seed)
    values = {}
    for name in leaves:
        flat = np.asarray(named[name], np.float32).ravel()
        idx = np.sort(rng.choice(flat.size, TRAIN_VALUES, replace=False))
        values[name] = {"index": idx.tolist(),
                        "value": flat[idx].astype(np.float64).tolist()}
    norms = {name: float(np.sqrt(np.square(
        np.asarray(a, np.float32), dtype=np.float64).sum()))
        for name, a in named.items()}
    return {"norms": norms, "values": values}


def train_golden() -> dict:
    """The ``"train"`` entry (module docstring)."""
    cfg = dataclasses.replace(registry.get(LM_ARCH), num_layers=TRAIN_LAYERS,
                              dtype="float32")
    port_cfg = dataclasses.replace(port_registry.get(LM_ARCH),
                                   num_layers=TRAIN_LAYERS, dtype="float32")
    tree = port_init.numpy_params(port_cfg, LM_PARAM_SEED)
    out = {"arch": LM_ARCH, "num_layers": TRAIN_LAYERS}
    out.update(_train_steps(cfg, port_cfg, tree, TRAIN_LEAVES))
    return out


def train_family_golden(name: str) -> dict:
    """One model of the ``"train_families"`` entry (module docstring)."""
    cut = dict(TRAIN_FAMILY_CUTS[name], dtype="float32")
    over = {k: v for k, v in cut.items() if k != "arch"}
    cfg = dataclasses.replace(registry.get(cut["arch"]), **over)
    port_cfg = dataclasses.replace(port_registry.get(cut["arch"]), **over)
    tree = port_init.numpy_params(port_cfg, LM_PARAM_SEED)
    out = {"arch": cut["arch"], "cuts": cut}
    if port_cfg.family in ("ssm", "hybrid"):
        port_init.numpy_ssm_heads(tree, port_cfg, SSM_HEADS_SEED)
        out["ssm_heads_seed"] = SSM_HEADS_SEED
    out.update(_train_steps(cfg, port_cfg, tree, TRAIN_FAMILY_LEAVES[name]))
    return out


def train_families_golden() -> dict:
    """The ``"train_families"`` entry: `train_family_golden` of each model
    in a process of its own, one at a time."""
    return {name: _worker_subprocess("--train-families-worker",
                                     {"name": name}, 1, 3600.0)
            for name in TRAIN_FAMILY_CUTS}


def _train_steps(cfg, port_cfg, tree, leaves) -> dict:
    """Step 0's gradient and TRAIN_STEPS steps of the reference's jitted
    ``make_train_step`` from the numpy ``tree`` (consumed), summarised by
    `_leaf_summary` over ``leaves``."""
    from repro.data.pipeline import SyntheticLM
    from repro.models import model
    from repro.optim import adamw
    from repro.train.step import make_train_step

    params = _tree_to_jax(tree)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_DATA_SEED)
    batches = [{k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
               for s in range(TRAIN_STEPS)]
    grads = jax.jit(jax.grad(lambda p, b: model.loss_fn(p, cfg, b)[0]))(
        params, batches[0])
    out = {"dtype": "float32",
           "param_seed": LM_PARAM_SEED, "data_seed": TRAIN_DATA_SEED,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "lr": TRAIN_LR,
           "microbatches": 1, "optimizer_state_dtype": "float32",
           "grad0": _leaf_summary(grads, port_cfg, TRAIN_VALUE_SEED,
                                  leaves)}
    del grads
    step = jax.jit(make_train_step(cfg, lambda s: TRAIN_LR),
                   donate_argnums=(0, 1))
    opt = adamw.init(params, jnp.float32)
    out["steps"] = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        out["steps"].append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"])})
    del opt
    out["params"] = _leaf_summary(params, port_cfg, TRAIN_VALUE_SEED,
                                  leaves)
    if not all(np.isfinite([v for s in out["steps"] for v in s.values()])):
        raise RuntimeError(f"{cfg.name}: the reference's steps are not "
                           f"finite: {out['steps']}")
    return out


def train_mesh_job(name: str, full: bool = False, **over) -> dict:
    """A `train_mesh_reference` job of ``TRAIN_MESH_CASES[name]`` (or of
    ``over``'s arch and shape), with the golden's batch, steps and
    microbatches unless ``over`` says otherwise; ``full`` asks for every
    leaf after the steps."""
    return dict(dict(TRAIN_MESH_CASES.get(name, {}), name=name,
                     batch=TRAIN_MESH_BATCH, seq=TRAIN_MESH_SEQ,
                     microbatches=TRAIN_MESH_MICRO, num_steps=TRAIN_STEPS,
                     lr=TRAIN_LR, param_seed=LM_PARAM_SEED,
                     data_seed=TRAIN_DATA_SEED, ssm_heads_seed=SSM_HEADS_SEED,
                     leaves=list(TRAIN_MESH_LEAVES.get(name, TRAIN_LEAVES)),
                     full=full), **over)


def train_mesh_tree(job: dict):
    """(the port's smoke config of a job, its numpy weights in the
    reference's layout): `numpy_params` of the seed, SSD heads redrawn."""
    cfg = dataclasses.replace(port_registry.smoke(job["arch"]),
                              dtype="float32")
    tree = port_init.numpy_params(cfg, job["param_seed"])
    if cfg.family in ("ssm", "hybrid"):
        port_init.numpy_ssm_heads(tree, cfg, job["ssm_heads_seed"])
    return cfg, tree


def train_mesh_reference(jobs: list) -> list:
    """`_train_mesh_reference` of each job."""
    return [_train_mesh_reference(job) for job in jobs]


def _replay_routes(params, cfg, batch) -> tuple[list, float]:
    """The expert picks of every MoE call of the reference's forward on
    ``batch`` under the installed mesh, the forward replayed layer by
    layer (each layer jitted alone, its picks an output of its own;
    module docstring), and the smallest router margin among them."""
    from repro.distributed import sharding_rules as rules
    from repro.models import mlp as ref_mlp
    from repro.models import model

    traced: list = []
    orig = ref_mlp.moe_forward

    def recording(p, x, c):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
            jnp.float32) @ p["router"], -1)
        top = jax.lax.top_k(probs, c.top_k + 1)[0]
        traced.append((jax.lax.top_k(probs, c.top_k)[1],
                       jnp.min(top[:, -2] - top[:, -1])))
        return orig(p, x, c)

    @functools.partial(jax.jit, static_argnums=(0,))
    def layer(kind, p, h, positions, shared):
        traced.clear()
        h = rules.shard(h, rules.batch_axes(), "model", None)
        h, _, _ = model._apply_block(kind, p, h, positions, cfg, shared)
        return h, list(traced)

    picks, margins = [], []
    ref_mlp.moe_forward = recording
    try:
        h, positions = model.embed_inputs(params, cfg, batch)
        shared = params.get("shared_attn")
        for (pattern, groups), stack in zip(model.stacks_of(cfg),
                                            params["stacks"]):
            for g in range(groups):
                gp = jax.tree.map(lambda a: a[g], stack)
                for i, kind in enumerate(pattern):
                    h, rec = layer(kind, gp[f"block{i}"], h, positions,
                                   shared)
                    for idx, margin in rec:
                        picks.append(np.asarray(idx).tolist())
                        margins.append(float(margin))
    finally:
        ref_mlp.moe_forward = orig
    return picks, min(margins, default=float("inf"))


def _train_mesh_reference(job: dict) -> dict:
    """The reference's sharded step (module docstring) for one job, in a
    process with enough forced host devices."""
    from jax.sharding import AxisType

    from repro.data.pipeline import SyntheticLM
    from repro.distributed import sharding_rules as rules
    from repro.optim import adamw
    from repro.train.step import make_train_step

    port_cfg, tree = train_mesh_tree(job)
    cfg = dataclasses.replace(registry.smoke(job["arch"]), dtype="float32")
    shape = tuple(job["shape"])
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))
    rules.set_mesh(mesh)
    try:
        params = _tree_to_jax(tree)
        params = jax.device_put(params, rules.param_shardings(mesh, params))
        opt = adamw.init(params, jnp.float32)
        m = job["microbatches"]
        step = jax.jit(make_train_step(cfg, lambda s: job["lr"], m))
        data = SyntheticLM(cfg, job["batch"], job["seq"],
                           seed=job["data_seed"])
        out = {"steps": [], "routes": [], "router_margin": float("inf")}
        for s in range(job["num_steps"]):
            b = {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
            if cfg.family == "moe":
                rows = job["batch"] // m
                for i in range(m):
                    picks, margin = _replay_routes(
                        params, cfg, {k: v[i * rows:(i + 1) * rows]
                                      for k, v in b.items()})
                    out["routes"].append(picks)
                    out["router_margin"] = min(out["router_margin"], margin)
            params, opt, met = step(params, opt, b)
            out["steps"].append({"loss": float(met["loss"]),
                                 "grad_norm": float(met["grad_norm"])})
        params = jax.tree.map(np.asarray, params)
    finally:
        rules.set_mesh(None)
    out["params"] = _leaf_summary(params, port_cfg, TRAIN_VALUE_SEED,
                                  job["leaves"])
    if job.get("full"):
        from repro_torch import convert
        out["leaves"] = {k: np.asarray(a, np.float32).tolist() for k, a in
                         convert.lm_named_leaves(params, port_cfg).items()}
    if not out["routes"]:
        out["router_margin"] = None
    if not all(np.isfinite([v for s in out["steps"] for v in s.values()])):
        raise RuntimeError(f"{job['arch']}: the reference's sharded steps "
                           f"are not finite: {out['steps']}")
    return out


def train_mesh_reference_subprocess(jobs: list, timeout: float = 900.0
                                    ) -> list:
    """`train_mesh_reference` of ``jobs`` in a fresh process with 4
    forced host devices."""
    return _worker_subprocess("--train-mesh-worker", jobs, MESH_DEVICES,
                              timeout)


def routes_digest(routes: list) -> str:
    """sha256 of a job's expert picks (calls in order, each (tokens, k)
    as little-endian int32)."""
    h = hashlib.sha256()
    for mb in routes:
        for call in mb:
            h.update(np.ascontiguousarray(call, "<i4").tobytes())
    return h.hexdigest()


def train_mesh_golden() -> dict:
    """The ``"train_mesh"`` entry (module docstring); the expert picks are
    kept as their count and `routes_digest`."""
    jobs = [train_mesh_job(name) for name in TRAIN_MESH_CASES]
    out = {}
    for job, res in zip(jobs, train_mesh_reference_subprocess(jobs)):
        routes = res.pop("routes")
        res.update(route_calls=sum(len(mb) for mb in routes),
                   routes_sha256=routes_digest(routes))
        out[job["name"]] = dict({k: v for k, v in job.items()
                                 if k not in ("full", "name")}, **res)
    return out


def _moe_cfgs(job: dict):
    """(reference, port) configs of a `moe_reference` job, float32."""
    over = dict(job.get("overrides", {}), dtype="float32")
    get = "smoke" if job.get("smoke") else "get"
    return (dataclasses.replace(getattr(registry, get)(job["arch"]), **over),
            dataclasses.replace(getattr(port_registry, get)(job["arch"]),
                                **over))


def moe_reference(jobs: list) -> list:
    """`_moe_reference` of each job."""
    return [_moe_reference(job) for job in jobs]


def _moe_reference(job: dict) -> dict:
    """The reference's ``_moe_forward_a2a`` on `numpy_moe(cfg, seed)` and
    `numpy_moe_input(cfg, seed, batch, seq)` over a ``shape`` (data,
    model) mesh of ``Auto`` axes, in a process with enough forced host
    devices: aux, the router margin and the output (all of it with
    ``full``, else ``n_idx`` values at seeded flat indices and the sum of
    its magnitudes)."""
    from jax.sharding import AxisType
    from repro.models import mlp as ref_mlp

    cfg, port_cfg = _moe_cfgs(job)
    p = _tree_to_jax(port_init.numpy_moe(port_cfg, job["seed"]))
    x = port_init.numpy_moe_input(port_cfg, job["seed"], job["batch"],
                                  job["seq"])
    mesh = jax.make_mesh(tuple(job["shape"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out, aux = ref_mlp._moe_forward_a2a(p, jnp.asarray(x), cfg, mesh)
    out = np.asarray(out, np.float32)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model))
                           @ p["router"], -1)
    res = {"aux": float(aux),
           "router_margin": _router_margin(probs, cfg.top_k),
           "routes": np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).tolist()}
    if job.get("full"):
        res["out"] = out.tolist()
    else:
        flat = np.sort(np.random.default_rng((job["seed"], 2)).choice(
            out.size, job["n_idx"], replace=False))
        res.update(flat_ids=flat.tolist(),
                   values=out.reshape(-1)[flat].astype(np.float64).tolist(),
                   abs_sum=float(np.abs(out.astype(np.float64)).sum()))
    return res


def moe_reference_subprocess(jobs: list, devices: int = MESH_DEVICES,
                             timeout: float = 900.0) -> list:
    """`moe_reference` of ``jobs`` in a fresh process with ``devices``
    forced host devices."""
    return _worker_subprocess("--moe-worker", jobs, devices, timeout)


def moe_a2a_golden() -> dict:
    """The ``"moe_a2a"`` entry (module docstring)."""
    (res,) = moe_reference_subprocess([MOE_A2A_JOB])
    return dict(MOE_A2A_JOB, **res)


def q_golden() -> dict:
    """The ``"q"`` entry (module docstring)."""
    g = csr.dedupe(generators.powerlaw_cluster(Q_N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(reorder.apply(g, Q_ORDER)[0])
    tg = tiles.from_graph(g_rev)
    q8 = feq.quantize_probs(tg.prob)

    @jax.jit
    def graph_q(starts, seed):
        # launch/dryrun.py:260-281 at one shard (all_gather is the identity)
        fr0 = tiles.pad_mask_rows(
            traversal.init_frontier(Q_N, COLORS, starts), tg.padded_vertices)

        def cond(c):
            fr, _, lvl = c
            return jnp.logical_and(bitmask.any_set(fr), lvl < Q_MAX_LEVELS)

        def step(c):
            fr, vis, lvl = c
            vis = vis | fr
            nf = feq.fused_expand_q_ref(q8, tg.tile_src, tg.tile_dst, fr, vis,
                                        seed, lvl.astype(jnp.uint32))
            return nf, vis, lvl + 1

        fr, vis, lvl = jax.lax.while_loop(
            cond, step, (fr0, jnp.zeros_like(fr0), jnp.int32(0)))
        return vis | fr, lvl

    batches = []
    for b in range(Q_BATCHES):
        starts = rrr.batch_starts(Q_N, COLORS, MASTER_SEED, b)
        seed = jnp.uint32(rrr.batch_seeds(MASTER_SEED, [b])[0])
        vis, levels = graph_q(jnp.asarray(starts), seed)
        words = np.asarray(vis)[:Q_N]
        batches.append({"batch_index": b, "levels": int(levels),
                        "visited_bits": int(np.unpackbits(
                            words.view(np.uint8)).sum()),
                        "visited_sha256": mask_sha256(words)})
    return {"graph": {"generator": "powerlaw_cluster", "n": Q_N,
                      "avg_deg": DEGREE, "prob": PROB, "seed": GRAPH_SEED,
                      "dedupe": True, "order": Q_ORDER,
                      "num_edges": g_rev.num_edges, "tile_size": tiles.TILE,
                      "num_tiles": tg.num_tiles},
            "num_colors": COLORS, "master_seed": MASTER_SEED,
            "max_levels": Q_MAX_LEVELS, "batches": batches}


def _graph_digest(g) -> dict:
    """Edge counts and the sha256 of the padded edge arrays."""
    out = {"num_edges": int(g.num_edges), "padded_edges": int(g.padded_edges)}
    for name, dtype in (("src", "<i4"), ("dst", "<i4"), ("prob", "<f4")):
        out[f"{name}_sha256"] = hashlib.sha256(np.ascontiguousarray(
            np.asarray(getattr(g, name)), dtype).tobytes()).hexdigest()
    return out


@jax.jit
def _lt_levels(g_rev, cb, starts, seed):
    """Levels of ``lt.lt_traversal_program``'s loop (the same loop, with
    the level count returned)."""
    sel = lt.selection_mask_from_cb(g_rev, cb, COLORS, seed)
    fr0 = traversal.init_frontier(g_rev.num_vertices, COLORS, starts)

    def cond(c):
        fr, _, lvl = c
        return jnp.logical_and(bitmask.any_set(fr), lvl < 64)

    def body(c):
        fr, vis, lvl = c
        vis = vis | fr
        contrib = fr[g_rev.src] & sel & ~vis[g_rev.dst]
        nf = traversal._scatter_or(jnp.zeros_like(vis), g_rev.dst,
                                   contrib) & ~vis
        return nf, vis, lvl + 1

    return jax.lax.while_loop(cond, body,
                              (fr0, jnp.zeros_like(fr0), jnp.int32(0)))[2]


def stream_golden() -> dict:
    """The ``"stream"`` entry (module docstring)."""
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    rng = np.random.default_rng(GRAPH_SEED + 1)
    queries = [rng.integers(0, N, 3).tolist() for _ in range(STREAM_QUERIES)]
    delta = stream.random_delta(g, rng, num_deletes=STREAM_OPS,
                                num_inserts=STREAM_OPS)
    g2, _ = stream.apply_delta(g, delta)
    out = {"ops": STREAM_OPS, "queries": queries,
           "delta_sha256": hashlib.sha256(b"".join(
               np.ascontiguousarray(a).tobytes() for a in
               (delta.src, delta.dst, delta.weight, delta.insert))
           ).hexdigest(),
           "num_inserts": delta.num_inserts,
           "num_deletes": delta.num_deletes,
           "tile_rows": STREAM_TILE_ROWS}
    for diffusion in ("ic", "lt"):
        spec = SamplerSpec(diffusion=diffusion, backend="dense",
                           num_colors=COLORS, master_seed=MASTER_SEED,
                           tile_size=STREAM_TILE_ROWS)
        sampler = make_sampler(g, spec)
        g_rev2, applied = stream.apply_delta(
            sampler.g_rev, delta.reversed(), lt_normalized=diffusion == "lt")
        blocks = stream.touched_row_blocks(applied.touched_rows,
                                           STREAM_TILE_ROWS)
        rebound = sampler.rebind(g2, g_rev2, blocks)
        cb = jnp.asarray(lt.selection_cum_before(rebound.g_rev))
        batches = []
        for b in rebound.sample_many(range(BATCHES)):
            starts = jnp.asarray(b.roots)
            seed = jnp.uint32(rrr.batch_seed(MASTER_SEED, b.batch_index))
            levels = (_lt_levels(rebound.g_rev, cb, starts, seed)
                      if diffusion == "lt" else traversal.run_fused(
                          rebound.g_rev, starts, COLORS,
                          seed).stats.levels_run)
            batches.append({
                "batch_index": b.batch_index,
                "visited_sha256": mask_sha256(b.visited),
                "visited_bits": int(np.unpackbits(
                    np.asarray(b.visited).view(np.uint8)).sum()),
                "levels": int(levels),
                "fused_edge_visits": b.fused_edge_visits,
                "unfused_edge_visits": b.unfused_edge_visits})
        out[diffusion] = {
            "g_rev": _graph_digest(g_rev2),
            "renormalised_edges": int(np.count_nonzero(
                np.asarray(rebound.g_rev.prob) != np.asarray(g_rev2.prob))),
            "touched_rows": int(len(applied.touched_rows)),
            "touched_row_blocks": blocks.tolist(),
            "batches": batches}
    return out


def unfused_golden(top_seeds) -> dict:
    """The ``"unfused"`` entry (module docstring)."""
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(g)
    starts = np.asarray(rrr.batch_starts(N, COLORS, MASTER_SEED, 0))
    seed = rrr.batch_seed(MASTER_SEED, 0)
    visited = np.zeros((N, bitmask.num_words(COLORS)), np.uint32)
    colors = []
    for c in range(COLORS):
        res = traversal.run_single_color(g_rev, int(starts[c]), c, seed)
        words = np.asarray(res.visited[:, 0])
        visited[:, c // 32] |= words
        colors.append({
            "color": c, "levels_run": int(res.stats.levels_run),
            "popcount": int(np.unpackbits(words.view(np.uint8)).sum()),
            "edge_visits": int(np.asarray(res.stats.fused_edge_visits,
                                          np.int64).sum())})
    seeds = [int(s) for s in top_seeds[:SIGMA_SEEDS]]
    sigma = imm.simulate_influence(g, np.asarray(seeds),
                                   num_trials=SIGMA_TRIALS,
                                   master_seed=SIGMA_MASTER_SEED)
    return {"batch_index": 0, "visited_sha256": mask_sha256(visited),
            "total_edge_visits": sum(c["edge_visits"] for c in colors),
            "colors": colors,
            "sigma": {"seeds": seeds, "num_trials": SIGMA_TRIALS,
                      "master_seed": SIGMA_MASTER_SEED, "value": sigma}}


def mesh_reference(job: dict) -> list:
    """The reference's ``graph_parallel`` batches of ``job`` (graph size
    and knobs, ``cases`` of diffusion, frontier, mesh shape and capacity)
    in a process with enough forced host devices: per case and batch, the
    mask's sha256 and the per-level exchange words."""
    from jax.sharding import AxisType

    g = csr.dedupe(generators.powerlaw_cluster(
        job["n"], job.get("degree", DEGREE), prob=job.get("prob", PROB),
        seed=job.get("seed", GRAPH_SEED)))
    out = []
    for case in job["cases"]:
        shape = tuple(case["shape"])
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        spec = SamplerSpec(diffusion=case["diffusion"],
                           backend="graph_parallel",
                           num_colors=job.get("colors", COLORS),
                           master_seed=job.get("master_seed", MASTER_SEED),
                           frontier=case["frontier"],
                           frontier_capacity=case.get("capacity", 0),
                           tile_size=job.get("tile_size", tiles.TILE))
        sampler = make_sampler(g, spec, mesh=mesh)
        batches = sampler.sample_many(range(job["batches"]))
        words = np.asarray(sampler.last_gather_words)
        out.append(dict(case, batches=[
            {"batch_index": b.batch_index,
             "visited_sha256": mask_sha256(b.visited),
             "gather_words": [int(x) for x in np.trim_zeros(words[i], "b")]}
            for i, b in enumerate(batches)]))
    return out


def _worker_subprocess(flag: str, job: dict, devices: int,
                       timeout: float):
    """This script with ``flag JOB_JSON`` in a fresh process with
    ``devices`` forced host devices (this process's device count cannot
    change); returns the JSON of its last line."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                          json.dumps(job)], env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"reference run {flag} failed:\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def dp_grads(job: dict, rank: int) -> dict:
    """Rank ``rank``'s float32 gradient leaves of a ``--dp-worker`` job
    (normal from ``(seed, rank)``, scaled by rank + 1 so the ranks' scales
    differ); the port's test ranks draw the same."""
    rng = np.random.default_rng((job["seed"], rank))
    return {name: (rng.standard_normal(shape) * (rank + 1)).astype(
        np.float32) for name, shape in job["shapes"].items()}


def dp_reference(job: dict) -> dict:
    """The reference's ``compressed_psum`` over a ``("data",)`` mesh of
    ``job["devices"]`` forced host devices, each holding `dp_grads` of its
    position: the mean (replicated) and each position's residual."""
    from jax.sharding import AxisType, PartitionSpec as P

    from repro.distributed.compat import shard_map
    from repro.optim import compress

    n = job["devices"]
    mesh = jax.make_mesh((n,), ("data",), axis_types=(AxisType.Auto,))
    per = [dp_grads(job, r) for r in range(n)]
    stacked = {k: jnp.asarray(np.stack([g[k] for g in per]))
               for k in job["shapes"]}

    def body(g):
        mean, res = compress.compressed_psum(
            {k: v[0] for k, v in g.items()}, "data")
        return mean, {k: v[None] for k, v in res.items()}

    mean, res = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("data"),),
        out_specs=(P(), P("data")), check=False))(stacked)
    return {"mean": {k: np.asarray(v).tolist() for k, v in mean.items()},
            "residual": {k: np.asarray(v).tolist() for k, v in res.items()}}


def dp_reference_subprocess(job: dict, timeout: float = 300.0) -> dict:
    """`dp_reference` of ``job`` in a fresh process with its forced host
    devices."""
    return _worker_subprocess("--dp-worker", job, job["devices"], timeout)


def mesh_reference_subprocess(job: dict, devices: int = MESH_DEVICES,
                              timeout: float = 900.0) -> list:
    """`mesh_reference` of ``job`` in a fresh process with ``devices``
    forced host devices."""
    return _worker_subprocess("--mesh-worker", job, devices, timeout)


def mesh_golden() -> dict:
    job = dict(n=MESH_N, batches=MESH_BATCHES, cases=MESH_CASES)
    return {"graph": {"generator": "powerlaw_cluster", "n": MESH_N,
                      "avg_deg": DEGREE, "prob": PROB, "seed": GRAPH_SEED,
                      "dedupe": True},
            "num_colors": COLORS, "master_seed": MASTER_SEED,
            "tile_size": tiles.TILE, "devices": MESH_DEVICES,
            "cases": mesh_reference_subprocess(job)}


def main() -> None:
    ap = argparse.ArgumentParser()
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--lm-only", action="store_true",
                      help="recompute the \"lm\" entry alone")
    only.add_argument("--q-only", action="store_true",
                      help="recompute the \"q\" entry alone")
    only.add_argument("--stream-only", action="store_true",
                      help="recompute the \"stream\" entry alone")
    only.add_argument("--unfused-only", action="store_true",
                      help="recompute the \"unfused\" entry alone")
    only.add_argument("--mesh-only", action="store_true",
                      help="recompute the \"mesh\" entry alone")
    only.add_argument("--moe-only", action="store_true",
                      help="recompute the \"moe\" and \"moe_a2a\" "
                           "entries alone")
    only.add_argument("--ssm-only", action="store_true",
                      help="recompute the \"ssm\" entry alone")
    only.add_argument("--vlm-only", action="store_true",
                      help="recompute the \"vlm\" entry alone")
    only.add_argument("--dense-only", action="store_true",
                      help="recompute the \"dense\" entry alone")
    only.add_argument("--audio-only", action="store_true",
                      help="recompute the \"audio\" entry alone")
    only.add_argument("--train-only", action="store_true",
                      help="recompute the \"train\" entry alone")
    only.add_argument("--train-families-only", action="store_true",
                      help="recompute the \"train_families\" entry alone")
    only.add_argument("--train-mesh", action="store_true",
                      help="recompute the \"train_mesh\" entry alone")
    only.add_argument("--train-mesh-worker", metavar="JOBS_JSON",
                      help="print train_mesh_reference(JOBS) as JSON (run "
                           "by train_mesh_reference_subprocess)")
    only.add_argument("--train-families-worker", metavar="JOB_JSON",
                      help="print train_family_golden(JOB['name']) as JSON "
                           "(run by train_families_golden)")
    only.add_argument("--lm-worker", metavar="JOB_JSON",
                      help="print lm_worker_entry(JOB['entry'], "
                           "JOB['name']) as JSON (run by lm_worker_golden)")
    only.add_argument("--mesh-worker", metavar="JOB_JSON",
                      help="print mesh_reference(JOB) as JSON (run by "
                           "mesh_reference_subprocess)")
    only.add_argument("--moe-worker", metavar="JOBS_JSON",
                      help="print moe_reference(JOBS) as JSON (run by "
                           "moe_reference_subprocess)")
    only.add_argument("--dp-worker", metavar="JOB_JSON",
                      help="print dp_reference(JOB) as JSON (run by "
                           "dp_reference_subprocess)")
    args = ap.parse_args()
    if args.dp_worker:
        print(json.dumps(dp_reference(json.loads(args.dp_worker))))
        return
    if args.mesh_worker:
        print(json.dumps(mesh_reference(json.loads(args.mesh_worker))))
        return
    if args.moe_worker:
        print(json.dumps(moe_reference(json.loads(args.moe_worker))))
        return
    if args.train_mesh_worker:
        print(json.dumps(train_mesh_reference(
            json.loads(args.train_mesh_worker))))
        return
    if args.train_families_worker:
        job = json.loads(args.train_families_worker)
        print(json.dumps(train_family_golden(job["name"])))
        return
    if args.lm_worker:
        job = json.loads(args.lm_worker)
        print(json.dumps(lm_worker_entry(job["entry"], job["name"])))
        return
    t0 = time.time()
    entries = {"lm": lm_golden, "q": q_golden, "stream": stream_golden,
               "unfused": lambda: unfused_golden(golden["top_k"]["seeds"]),
               "mesh": mesh_golden, "moe": moe_golden,
               "moe_a2a": moe_a2a_golden, "ssm": ssm_golden,
               "vlm": vlm_golden, "dense": lambda: lm_worker_golden("dense"),
               "audio": lambda: lm_worker_golden("audio"),
               "train": train_golden,
               "train_families": train_families_golden,
               "train_mesh": train_mesh_golden}
    flags = {"lm": "lm", "q": "q", "stream": "stream", "unfused": "unfused",
             "mesh": "mesh", "moe": "moe", "moe_a2a": "moe", "ssm": "ssm",
             "vlm": "vlm", "dense": "dense", "audio": "audio",
             "train": "train",
             "train_families": "train_families", "train_mesh": "train_mesh"}
    keys = [k for k in entries if getattr(args, f"{flags[k]}_only", False)
            or (k == "train_mesh" and args.train_mesh)]
    if keys:
        with open(OUT) as f:
            golden = json.load(f)
        for key in keys:
            golden[key] = entries[key]()
        _write(golden)
        print(f"wrote the {', '.join(keys)} entries of "
              f"{os.path.normpath(OUT)} in {time.time() - t0:.1f}s")
        return
    g = csr.dedupe(generators.powerlaw_cluster(N, DEGREE, prob=PROB,
                                               seed=GRAPH_SEED))
    g_rev = csr.transpose(g)
    _, num_tiles = tiles.edge_slot_map(g_rev)
    pools = {}
    for diffusion in ("ic", "lt"):
        sampler = make_sampler(g, SamplerSpec(
            diffusion=diffusion, backend="dense", num_colors=COLORS,
            master_seed=MASTER_SEED), g_rev=g_rev)
        batches = sampler.sample_many(range(BATCHES))
        stack = np.stack([np.asarray(b.visited) for b in batches])
        pools[diffusion] = (batches, *imm.greedy_max_cover(
            stack, K, COLORS, use_kernel=False))
    batches, seeds, cov = pools["ic"]
    lt_batches, lt_seeds, lt_cov = pools["lt"]
    golden = {
        "graph": {"generator": "powerlaw_cluster", "n": N, "avg_deg": DEGREE,
                  "prob": PROB, "seed": GRAPH_SEED, "dedupe": True,
                  "num_edges": g.num_edges, "tile_size": tiles.TILE,
                  "num_tiles": int(num_tiles)},
        "num_colors": COLORS,
        "master_seed": MASTER_SEED,
        "batches": [
            {"batch_index": b.batch_index,
             "visited_sha256": mask_sha256(b.visited),
             "roots_sha256": hashlib.sha256(
                 np.ascontiguousarray(b.roots, "<i4").tobytes()).hexdigest(),
             "visited_bits": int(np.unpackbits(
                 np.asarray(b.visited).view(np.uint8)).sum()),
             "fused_edge_visits": b.fused_edge_visits,
             "unfused_edge_visits": b.unfused_edge_visits}
            for b in batches],
        "top_k": {"k": K, "batches": BATCHES, "seeds": seeds.tolist(),
                  "coverage": cov},
        "lt": {
            "batches": [
                {"batch_index": b.batch_index,
                 "visited_sha256": mask_sha256(b.visited),
                 "visited_bits": int(np.unpackbits(
                     np.asarray(b.visited).view(np.uint8)).sum())}
                for b in lt_batches],
            "top_k": {"k": K, "batches": BATCHES,
                      "seeds": lt_seeds.tolist(), "coverage": lt_cov},
        },
    }
    golden["lm"] = lm_golden()
    golden["q"] = q_golden()
    golden["stream"] = stream_golden()
    golden["unfused"] = unfused_golden(seeds.tolist())
    golden["mesh"] = mesh_golden()
    golden["moe"] = moe_golden()
    golden["moe_a2a"] = moe_a2a_golden()
    golden["ssm"] = ssm_golden()
    golden["vlm"] = vlm_golden()
    golden["dense"] = lm_worker_golden("dense")
    golden["audio"] = lm_worker_golden("audio")
    golden["train"] = train_golden()
    golden["train_families"] = train_families_golden()
    golden["train_mesh"] = train_mesh_golden()
    _write(golden)
    print(f"wrote {os.path.normpath(OUT)} in {time.time() - t0:.1f}s")


def _write(golden: dict) -> None:
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
